// Kernel P1: the GF(2) inner product of K selection-vector shares with the
// PIR database, answer[k] = XOR over rows p with bit p of t[k] set of db[p].
//
// Replaces the jitted XLA popcount of
// dcf_tpu/workloads/pir.py::_pir_answer_device, which takes
// popcount(t_word & db_plane) mod 2 per bit plane of a database packed 32
// records per lane word.  Here the database stays as record bytes in
// bitreverse order, db [N, R] (R a multiple of 4), and the XOR of the
// selected rows is the per-plane parity.  The selection is packed as the
// reference packs it, t_words [K, ceil(N / 32)] (pir_answer.cuh), as
// kernel B6's t-only launch writes it.
//
// Bound on the H100: bytes, the database read once (N x R) plus the
// K x N / 8 bytes of selection words; one shift, AND and XOR a word and
// key are below it.  The first design (one thread a 4-byte word of a row,
// one selection byte a key and row, read by every thread of the row)
// reached 17% of that bound (NVIDIA H100 80GB HBM3, 700 W power limit,
// chip_smoke.py).  This design:
//
//   - 16-byte record loads where R % 16 == 0 (VEC = 16; at R = 32 two lanes
//     a row), else 4-byte ones, TPR lanes a row (pir_answer.cuh);
//   - a warp takes U tiles of 32 rows a step and keeps their L = U x TPR
//     chunk loads in flight (up to 8 a batch), streaming (evict first):
//     the database is read once a call;
//   - one selection word a key and tile, a load every lane of the warp
//     makes at the same address; a row's bit is a shift of it;
//   - KK XOR accumulators a lane (KK = 4 or 8 keys a pass over the
//     database; more keys are further grid rows), folded over the lanes
//     that share a column with __shfl_xor_sync, then over the block's
//     warps through shared memory, and one atomicXor a block, key and
//     4-byte word of the column lands in the zeroed answer;
//   - a persistent grid sized from the occupancy.  Columns past 32 chunks
//     (R > 512, or R > 128 at VEC = 4) are further column groups
//     (gridDim.z).
//
// XOR is exact in any order, so the result does not depend on the
// schedule.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pir_answer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int VEC>
__device__ __forceinline__ void load_chunk(const uint8_t* p, uint32_t* x) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
}

template <int VEC, int TPR, int KK>
__global__ void __launch_bounds__(kThreads)
    pir_answer_kernel(const uint32_t* __restrict__ t_words,
                      const uint8_t* __restrict__ db,
                      uint32_t* __restrict__ out, int k_num, long long n_rows,
                      long long n_words, int cols) {
  constexpr int W = VEC / 4;               // 4-byte words of a chunk
  constexpr int U = TPR >= 8 ? 1 : 8 / TPR;  // tiles a step
  constexpr int L = U * TPR;               // chunk loads a lane a step
  constexpr int B = L < 8 ? L : 8;         // loads in flight at once
  __shared__ uint32_t part[kWarps][KK][TPR][W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane % TPR;
  const int col = blockIdx.z * TPR + cl;
  const bool live = col < cols;
  const int key0 = blockIdx.y * KK;
  const size_t row_bytes = (size_t)cols * VEC;

  uint32_t acc[KK][W];
#pragma unroll
  for (int k = 0; k < KK; ++k)
#pragma unroll
    for (int q = 0; q < W; ++q) acc[k][q] = 0u;
  const long long steps = (n_words + U - 1) / U;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long st = (long long)blockIdx.x * kWarps + warp; st < steps;
       st += stride) {
    const long long tile0 = st * U;
    uint32_t w[U][KK];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < KK; ++k)
        w[u][k] = key0 + k < k_num && tile0 + u < n_words
                      ? t_words[(size_t)(key0 + k) * n_words + tile0 + u]
                      : 0u;
#pragma unroll
    for (int i0 = 0; i0 < L; i0 += B) {
      uint32_t x[B][W];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const int u = (i0 + i) / TPR, p = (i0 + i) % TPR;
        const long long row =
            (tile0 + u) * 32 + dcf::pir_row_in_tile<TPR>(lane, p);
        if (live && row < n_rows) {
          load_chunk<VEC>(db + row * row_bytes + (size_t)col * VEC, x[i]);
        } else {
#pragma unroll
          for (int q = 0; q < W; ++q) x[i][q] = 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const int u = (i0 + i) / TPR, p = (i0 + i) % TPR;
        dcf::pir_fold<KK, W>(acc, w[u], dcf::pir_row_in_tile<TPR>(lane, p),
                             x[i]);
      }
    }
  }
  // The lanes of a column (same lane % TPR), then the block's warps.
#pragma unroll
  for (int off = 16; off >= TPR; off >>= 1)
#pragma unroll
    for (int k = 0; k < KK; ++k)
#pragma unroll
      for (int q = 0; q < W; ++q)
        acc[k][q] ^= __shfl_xor_sync(0xFFFFFFFFu, acc[k][q], off);
  if (lane < TPR)
#pragma unroll
    for (int k = 0; k < KK; ++k)
#pragma unroll
      for (int q = 0; q < W; ++q) part[warp][k][lane][q] = acc[k][q];
  __syncthreads();
  for (int i = threadIdx.x; i < KK * TPR * W; i += kThreads) {
    const int k = i / (TPR * W), c = (i / W) % TPR, q = i % W;
    uint32_t v = 0u;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) v ^= part[wp][k][c][q];
    const int oc = blockIdx.z * TPR + c;
    if (v && key0 + k < k_num && oc < cols)
      atomicXor(out + (size_t)(key0 + k) * cols * W + (size_t)oc * W + q, v);
  }
}

template <int VEC, int TPR, int KK>
cudaError_t launch(const uint32_t* t_words, const uint8_t* db, uint32_t* out,
                   int k_num, long long n_rows, int cols,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pir_answer_kernel<VEC, TPR, KK>, kThreads, 0);
  if (e != cudaSuccess) return e;
  constexpr int U = TPR >= 8 ? 1 : 8 / TPR;
  const long long n_words = (n_rows + 31) / 32;
  const int key_groups = (k_num + KK - 1) / KK;
  const int col_groups = (cols + TPR - 1) / TPR;
  const long long need = ((n_words + U - 1) / U + kWarps - 1) / kWarps;
  long long most = (long long)sms * (per_sm > 0 ? per_sm : 1) /
                   ((long long)key_groups * col_groups);
  if (most < 1) most = 1;
  dim3 grid((unsigned)(need < most ? need : most), key_groups, col_groups);
  pir_answer_kernel<VEC, TPR, KK><<<grid, kThreads, 0, stream>>>(
      t_words, db, out, k_num, n_rows, n_words, cols);
  return cudaGetLastError();
}

// TPR lanes a row: the chunks of a column group, rounded up to a power of
// two.
template <int VEC, int KK>
cudaError_t launch_cols(const uint32_t* t_words, const uint8_t* db,
                        uint32_t* out, int k_num, long long n_rows, int cols,
                        cudaStream_t stream) {
#define DCF_ARGS t_words, db, out, k_num, n_rows, cols, stream
  if (cols <= 1) return launch<VEC, 1, KK>(DCF_ARGS);
  if (cols <= 2) return launch<VEC, 2, KK>(DCF_ARGS);
  if (cols <= 4) return launch<VEC, 4, KK>(DCF_ARGS);
  if (cols <= 8) return launch<VEC, 8, KK>(DCF_ARGS);
  if (cols <= 16) return launch<VEC, 16, KK>(DCF_ARGS);
  return launch<VEC, 32, KK>(DCF_ARGS);
#undef DCF_ARGS
}

}  // namespace

// C entry point, bound through ctypes.  t_words [K, ceil(N / 32)] packed
// selection bits, db [N, R] bytes (R a multiple of 4; 16-byte aligned when
// R % 16 == 0), out [K, R] zeroed by the caller.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int dcf_pir_answer(const void* t_words, const void* db, void* out,
                              int k_num, long long n_rows, int r,
                              void* stream) {
  if (k_num < 1 || n_rows < 1 || r < 4 || r % 4)
    return (int)cudaErrorInvalidValue;
  const uint32_t* tw = (const uint32_t*)t_words;
  const uint8_t* d = (const uint8_t*)db;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (r % 16 == 0)
    return k_num <= 4 ? (int)launch_cols<16, 4>(tw, d, o, k_num, n_rows,
                                                 r / 16, s)
                      : (int)launch_cols<16, 8>(tw, d, o, k_num, n_rows,
                                                 r / 16, s);
  return k_num <= 4
             ? (int)launch_cols<4, 4>(tw, d, o, k_num, n_rows, r / 4, s)
             : (int)launch_cols<4, 8>(tw, d, o, k_num, n_rows, r / 4, s);
}
