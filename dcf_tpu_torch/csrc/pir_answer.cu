// Kernel P1: the GF(2) inner product of K selection-vector shares with the
// PIR database, answer[k] = XOR over positions p with t[k, p] = 1 of db[p].
//
// Replaces the jitted XLA popcount of
// dcf_tpu/workloads/pir.py::_pir_answer_device, which takes
// popcount(t_word & db_plane) mod 2 per bit plane of a database packed 32
// records per lane word.  Here the database stays as record bytes in
// bitreverse order, db [N, R] (R a multiple of 4), and the XOR of the
// selected rows is the per-plane parity.  t is one byte (0/1) per (key,
// position), [K, N], as kernel B6 writes it.
//
// Bound on the H100: bytes, the database read once (N x R) plus the K x N
// selection bytes; one AND and one XOR per word and key are far below it.
// Design: a block covers rows_per_pass = 256 / (R / 4) rows at a time, one
// thread per 4-byte column word of a row, so a warp reads consecutive
// words; it strides over the rows of its share of the database and keeps
// one XOR accumulator per key (at most kKeys keys a pass over the
// database; more keys run as further grid rows).  The accumulators of the
// threads that share a column are combined through shared memory, and one
// atomicXor per block, key and column word lands in the zeroed answer.
// XOR is exact in any order, so the result does not depend on the
// schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 8;  // keys per pass over the database

__global__ void __launch_bounds__(kThreads)
    pir_answer_kernel(const uint8_t* __restrict__ t,
                      const uint32_t* __restrict__ db,
                      uint32_t* __restrict__ out, int k_num, long long n_rows,
                      int rw) {
  __shared__ uint32_t part[kKeys][kThreads];
  const int rows_per_pass = kThreads / rw;
  const int r = threadIdx.x / rw;
  const int c = threadIdx.x % rw;
  const int key0 = blockIdx.y * kKeys;
  const int kn = min(kKeys, k_num - key0);

  uint32_t acc[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) acc[k] = 0u;
  if (r < rows_per_pass) {
    const long long step = (long long)gridDim.x * rows_per_pass;
#pragma unroll 4
    for (long long row = (long long)blockIdx.x * rows_per_pass + r;
         row < n_rows; row += step) {
      const uint32_t word = db[row * rw + c];
#pragma unroll
      for (int k = 0; k < kKeys; ++k)
        if (k < kn)
          acc[k] ^= word & (0u - (uint32_t)(t[(key0 + k) * n_rows + row] & 1u));
    }
  }
#pragma unroll
  for (int k = 0; k < kKeys; ++k) part[k][threadIdx.x] = acc[k];
  __syncthreads();
  // Thread (k, c) folds column c of key k over the block's rows.
  for (int i = threadIdx.x; i < kn * rw; i += kThreads) {
    const int k = i / rw, col = i % rw;
    uint32_t x = 0u;
    for (int q = 0; q < rows_per_pass; ++q) x ^= part[k][q * rw + col];
    if (x) atomicXor(out + (size_t)(key0 + k) * rw + col, x);
  }
}

}  // namespace

// C entry point, bound through ctypes.  t [K, N] bytes (0/1), db [N, R]
// bytes with R = 4 * rw, out [K, R] zeroed by the caller.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dcf_pir_answer(const void* t, const void* db, void* out,
                              int k_num, long long n_rows, int rw,
                              int blocks, void* stream) {
  if (rw < 1 || rw > kThreads) return (int)cudaErrorInvalidValue;
  dim3 grid(blocks, (k_num + kKeys - 1) / kKeys);
  pir_answer_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)t, (const uint32_t*)db, (uint32_t*)out, k_num, n_rows,
      rw);
  return (int)cudaGetLastError();
}
