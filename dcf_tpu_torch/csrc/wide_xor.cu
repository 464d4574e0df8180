// Kernel W1: the GF(2) wide tail of the large-lambda hybrid,
//
//   y[32:] = const ^ XOR over k of (t_k ? W[k] : 0)
//
// for every (key, point), with t the n+1-bit trajectory that kernel B4 or
// B5b wrote.  Replaces the wide part of
// dcf_tpu/backends/large_lambda.py::_wide_tail, an XLA int8 dot_general
// with parity extraction on the TPU's matrix unit; a GF(2) product is an
// XOR of the selected rows, so no multiply is needed.  The result goes
// straight into bytes 32..lam-1 of the rows of y [K, M, lam].
//
// Layout: a block owns one tile of 32 column words (128 bytes) of one key
// and kPoints points.  It loads its tile of W ([n+1, 32] words) into shared
// memory once; then each warp takes one point at a time, lane c computing
// column word c, and walks the set bits of the point's trajectory (the same
// bits for the whole warp, so no lane diverges), XOR-ing one shared word
// per set bit.  Wide payloads (lam = 16384: W is 2 MB per key) tile the
// columns over the grid's x axis.
//
// Bound on the H100: operations for these shapes, the shared-memory reads
// (one word per set trajectory bit per column word); the bytes are the
// trajectories in, the wide rows out.

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

constexpr int kCols = 32;     // column words per tile: one per lane
constexpr int kWarps = 8;     // points in flight per block
constexpr int kPoints = 512;  // points per block

__global__ void __launch_bounds__(kCols * kWarps)
    wide_xor_kernel(const uint32_t* __restrict__ traj,
                    const uint32_t* __restrict__ w,
                    const uint32_t* __restrict__ cst, uint8_t* __restrict__ y,
                    int n1, int tw, int wd_words, int m, int lam) {
  extern __shared__ uint32_t tile[];  // [n1][kCols]
  const int key = blockIdx.z;
  const int col0 = blockIdx.x * kCols;
  const int cols = min(kCols, wd_words - col0);
  const uint32_t* wk = w + (size_t)key * n1 * wd_words + col0;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  for (int i = tid; i < n1 * kCols; i += kCols * kWarps) {
    const int c = i % kCols;
    tile[i] = c < cols ? wk[(size_t)(i / kCols) * wd_words + c] : 0u;
  }
  __syncthreads();

  const int c = threadIdx.x;
  if (c >= cols) return;
  const uint32_t c0 = cst[(size_t)key * wd_words + col0 + c];
  const int end = min(m, (int)(blockIdx.y + 1) * kPoints);
  for (int pt = blockIdx.y * kPoints + threadIdx.y; pt < end; pt += kWarps) {
    const size_t row = (size_t)key * m + pt;
    const uint32_t out = dcf::wide_word(traj + row * tw, n1, tile + c, kCols,
                                        c0);
    reinterpret_cast<uint32_t*>(y + row * lam + 32)[col0 + c] = out;
  }
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  traj [K, m, tw] words; w [K, n1, wd_words];
// cst [K, wd_words]; y [K, m, lam] bytes, lam = 32 + 4 * wd_words.
extern "C" int dcf_wide_xor(const void* traj, const void* w, const void* cst,
                            void* y, int k_num, int n1, int tw, int wd_words,
                            int m, int lam, void* stream) {
  const size_t smem = sizeof(uint32_t) * kCols * (size_t)n1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wide_xor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((wd_words + kCols - 1) / kCols, (m + kPoints - 1) / kPoints,
            k_num);
  dim3 block(kCols, kWarps);
  wide_xor_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)traj, (const uint32_t*)w, (const uint32_t*)cst,
      (uint8_t*)y, n1, tw, wd_words, m, lam);
  return (int)cudaGetLastError();
}
