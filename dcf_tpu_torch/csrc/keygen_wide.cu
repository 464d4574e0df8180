// Kernel W2: the wide tail of kernel B7a's keys, bytes 32..lam-1 of every
// correction word of a lam >= 48 DCF key.
//
// Replaces the XLA lax.scan of dcf_tpu/ops/pallas_keygen.py::_keygen_wide_tail.
// Beyond byte 32 the Hirose PRG of lam >= 48 copies its input, so the wide
// part is a GF(2) recursion over alpha's walk bits and the two parties'
// trajectories that B7a writes, independent per byte column
// (keygen_walk.cuh::wide_tail_column).
//
// Bound on the H100: bytes.  Per key it reads n/8 bytes of alpha, 2n of
// trajectories and 3 (lam - 32) of beta and root seeds, and writes
// 2 n (lam - 32) bytes of cw_s and cw_v and lam - 32 of cw_np1: 3.76 GB of
// writes at lam = 256, K = 2^16, n = 128, about 1.15 ms at 3.35 TB/s.  The
// work is a few integer operations a byte.  One thread carries one (key,
// 16-byte column) through all n levels in registers; the threads of a warp
// take consecutive columns of consecutive keys, so a level's two stores
// are 16-byte stores into the contiguous lam - 32 bytes of a key's row,
// and the key's trajectories and alpha are read 16 bytes and one byte each
// 8 levels, one address for all of a key's lanes.  The stores are
// streaming stores (st.global.cs): against plain stores they took W2 from
// 1.76 to 1.51 ms at lam = 256, K = 2^16, and left lam = 16384, K = 64 at
// 0.11 ms (NVIDIA H100 80GB HBM3, 700 W power limit, chip_ab.py in
// turns); loading the next 8 levels' trajectories ahead gained 2% with
// plain stores and nothing with streaming ones, and is not done.

#include <cuda_runtime.h>

#include "keygen_walk.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kNarrowBytes = 32;  // B7a's part of each row

__global__ void __launch_bounds__(kBlock)
    keygen_wide_kernel(const uint8_t* __restrict__ alphas,
                       const uint8_t* __restrict__ betas,
                       const uint8_t* __restrict__ s0s,
                       const uint8_t* __restrict__ traj,
                       uint8_t* __restrict__ cw_s, uint8_t* __restrict__ cw_v,
                       uint8_t* __restrict__ cw_np1, long long k_num, int n,
                       int lam, int lt) {
  const size_t cols = (size_t)(lam - kNarrowBytes) / 16;
  const size_t g = (size_t)blockIdx.x * kBlock + threadIdx.x;
  if (g >= (size_t)k_num * cols) return;
  const size_t key = g / cols;
  const size_t at = kNarrowBytes + 16 * (g - key * cols);  // column's byte
  const size_t rows = key * n;  // this key's first level row
  const uint8_t* s0 = s0s + key * 2 * lam;
  dcf::wide_tail_column(n, lt != 0, at + 16 == (size_t)lam, lam,
                        alphas + key * (n / 8), traj + rows * 2,
                        betas + key * lam + at, s0 + at, s0 + lam + at,
                        cw_s + rows * lam + at, cw_v + rows * lam + at,
                        cw_np1 + key * lam + at);
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  alphas [K, n/8], betas [K, lam], s0s [K, 2, lam],
// traj [K, n, 2] (B7a's); writes bytes 32..lam-1 of cw_s / cw_v
// [K, n, lam] and cw_np1 [K, lam].  lam >= 48 a multiple of 16; every
// array but alphas 16-byte aligned.
extern "C" int dcf_keygen_wide(const void* alphas, const void* betas,
                               const void* s0s, const void* traj, void* cw_s,
                               void* cw_v, void* cw_np1, long long k_num,
                               int n, int lam, int lt, void* stream) {
  if (k_num < 1) return (int)cudaSuccess;
  if (lam < kNarrowBytes + 16 || lam % 16 || n < 8 || n % 8)
    return (int)cudaErrorInvalidValue;
  const long long threads = k_num * ((lam - kNarrowBytes) / 16);
  keygen_wide_kernel<<<(unsigned)((threads + kBlock - 1) / kBlock), kBlock, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)alphas, (const uint8_t*)betas, (const uint8_t*)s0s,
      (const uint8_t*)traj, (uint8_t*)cw_s, (uint8_t*)cw_v,
      (uint8_t*)cw_np1, k_num, n, lam, lt);
  return (int)cudaGetLastError();
}
