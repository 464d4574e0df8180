// Kernel W1: the GF(2) wide tail of the large-lambda hybrid,
//
//   y[32:] = const ^ XOR over j < n1 of (t_j ? W[j] : 0)
//
// for every (key, point), with t the n1 = n+1-bit trajectory that kernel
// B4 or B5b wrote.  Replaces the wide part of
// dcf_tpu/backends/large_lambda.py::_wide_tail, an XLA int8 dot_general
// with parity extraction on the TPU's matrix unit; a GF(2) product is an
// XOR of the selected rows, so no multiply is needed.  The result goes
// straight into bytes 32..lam-1 of the rows of y [K, M, lam].
//
// Bound on the H100: bytes (the trajectories in, the wide rows out).  The
// first design walked each point's set trajectory bits, one shared word
// per set bit and column word (about 59 dependent iterations an output
// word at n = 128), and reached 3.5% of that bound.  This design, the
// method of four Russians (narrow_walk.cuh, wide_table_entry and
// wide_chunk):
//
//   - the trajectory's bits fall into groups of five; a shared table
//     holds, for each group and each value of its bits, the XOR of the rows
//     of W the value selects (const folded into group 0), so a 16-byte
//     output chunk is one 16-byte table read a group: 26 at n = 128, no bit
//     scan, no data-dependent loop;
//   - a column tile of up to 16 chunks (256 bytes of a row) is covered by
//     a group of `lanes` threads, a power of two, one chunk each, so a
//     quarter warp's 16-byte reads fall on one table row, consecutive
//     chunks: no bank conflicts.  At lam = 256 a point's 14 chunks take 16
//     lanes, two points a warp; the table is 26 x 32 x 224 bytes, 186 KB;
//   - a persistent grid: each block takes a contiguous share of the
//     (key, column tile, pass of points) units, building the table of a
//     (key, tile) once when it reaches it (once in all at lam = 256, one
//     tile; at most a few times at lam = 16384, whose 1022 chunks tile the
//     columns 16 at a time); a pass is blockDim / lanes points;
//   - each thread loads its point's trajectory words before the lookups,
//     and the 16-byte stores stream (st.global.cs): a point's chunks are
//     written once and read by the caller only.
//
// Its own floor is the table reads: 16 bytes a (point, group, chunk), at
// 128 bytes a clock and SM (chip_smoke.py, phase 6, prints it).

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kMaxCols = 16;  // chunks of 16 bytes in a column tile
constexpr size_t kSmemMax = 227 * 1024;

__global__ void __launch_bounds__(kBlock, 1)
    wide_xor_kernel(const uint32_t* __restrict__ traj,
                    const uint8_t* __restrict__ w,
                    const uint8_t* __restrict__ cst, uint8_t* __restrict__ y,
                    int n1, int tw, int chunks, int m, int lam, int cols,
                    int lanes, int tiles, long long passes,
                    long long units) {
  extern __shared__ __align__(16) uint32_t tab[];  // [groups][32][cols] x 4
  const int groups = dcf::wide_groups(n1);
  const size_t wd = (size_t)chunks * 16;
  const int per_pass = kBlock / lanes;
  const int c = threadIdx.x % lanes;
  const int slot = threadIdx.x / lanes;
  const long long lo = units * blockIdx.x / gridDim.x;
  const long long hi = units * (blockIdx.x + 1) / gridDim.x;
  long long held = -1;  // the (key, tile) whose table is in shared memory
  int key = 0, chunk0 = 0;
  for (long long u = lo; u < hi; ++u) {
    const long long kt = u / passes;
    if (kt != held) {  // the same for every thread of the block
      __syncthreads();
      held = kt;
      key = (int)(kt / tiles);
      chunk0 = (int)(kt % tiles) * cols;
      const uint8_t* wk = w + (size_t)key * n1 * wd;
      const uint8_t* ck = cst + (size_t)key * wd;
      for (int e = threadIdx.x; e < groups * dcf::kWideVals * cols;
           e += kBlock) {
        const int col = e % cols, gn = e / cols;
        uint32_t out[4] = {0u, 0u, 0u, 0u};
        if (chunk0 + col < chunks)
          dcf::wide_table_entry(wk + 16 * (chunk0 + col),
                                ck + 16 * (chunk0 + col), wd, n1,
                                gn / dcf::kWideVals, gn % dcf::kWideVals,
                                out);
        reinterpret_cast<uint4*>(tab)[e] =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
      __syncthreads();
    }
    const long long pt = (u - kt * passes) * per_pass + slot;
    if (c < cols && chunk0 + c < chunks && pt < m) {
      const size_t row = (size_t)key * m + pt;
      uint32_t out[4];
      dcf::wide_chunk(traj + row * tw, n1, tab + 4 * c, cols, out);
      __stcs(reinterpret_cast<uint4*>(y + row * lam + 32) + chunk0 + c,
             make_uint4(out[0], out[1], out[2], out[3]));
    }
  }
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  traj [K, m, tw] words; w [K, n1, 4 wd_words] and
// cst [K, 4 wd_words] bytes, 16-byte aligned; y [K, m, lam] bytes,
// lam = 32 + 4 * wd_words, wd_words a multiple of 4.
extern "C" int dcf_wide_xor(const void* traj, const void* w, const void* cst,
                            void* y, int k_num, int n1, int tw, int wd_words,
                            int m, int lam, void* stream) {
  const int chunks = wd_words / 4;
  if (k_num < 1 || m < 1 || chunks < 1 || wd_words % 4 ||
      tw * 32 < n1 || n1 < 1)
    return (int)cudaErrorInvalidValue;
  const size_t per_col = (size_t)dcf::wide_groups(n1) * dcf::kWideVals * 16;
  int cols = chunks < kMaxCols ? chunks : kMaxCols;
  if ((size_t)cols * per_col > kSmemMax) cols = (int)(kSmemMax / per_col);
  if (cols < 1) return (int)cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes < cols) lanes *= 2;
  const size_t smem = (size_t)cols * per_col;
  cudaError_t e = cudaFuncSetAttribute(
      wide_xor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wide_xor_kernel,
                                                    kBlock, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (chunks + cols - 1) / cols;
  const long long passes = (m + kBlock / lanes - 1) / (kBlock / lanes);
  const long long units = (long long)k_num * tiles * passes;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  wide_xor_kernel<<<(unsigned)(units < most ? units : most), kBlock, smem,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)traj, (const uint8_t*)w, (const uint8_t*)cst,
      (uint8_t*)y, n1, tw, chunks, m, lam, cols, lanes, tiles, passes, units);
  return (int)cudaGetLastError();
}
