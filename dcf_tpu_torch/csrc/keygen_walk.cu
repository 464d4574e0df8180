// Kernels G1, B7a and B7b: DCF and DPF key generation, one thread per key.
//
// G1   replaces the XLA level scan dcf_tpu/backends/device_gen.py::_gen_core
//      (lam = 16), which the JAX package runs over keys packed 32 to a
//      lane word;
// B7a  replaces dcf_tpu/ops/pallas_keygen.py::dcf_keygen_walk_pallas, the
//      narrow 32 bytes of a lam >= 48 key and both parties' trajectories;
// B7b  replaces dcf_tpu/ops/pallas_keygen.py::dpf_keygen_walk_pallas, the
//      lam = 32 DPF key.
//
// Bound on the H100: operations, the shared-memory table lookups of
// AES-256, 14 rounds x 16 lookups a block: per key and level 2 parties x 2
// blocks (G1), x 4 (B7a), x 3 (B7b).  The bytes are the inputs (alpha, beta,
// two seeds) and the correction words written once, 34 bytes a level at
// lam = 16 (4.35 GB for 10^6 keys at n = 128, about a tenth of G1's lookup
// time at 3.35 TB/s).  Design: one thread walks one key's n levels with both
// parties' state in registers (keygen_walk.cuh), the T-tables and both
// ciphers' round keys in shared memory once a block; keys lie on the grid's
// x axis (no 65,535 limit) and every offset is 64-bit.  Each level's
// correction words go out as 16-byte stores, one row per thread.

#include <cuda_runtime.h>

#include "keygen_walk.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(dcf::kThreads)
    keygen_walk_kernel(const uint8_t* __restrict__ sbox,
                       const uint8_t* __restrict__ rk0,
                       const uint8_t* __restrict__ rk17,
                       const uint8_t* __restrict__ alphas,
                       const uint8_t* __restrict__ betas,
                       const uint8_t* __restrict__ s0s,
                       uint8_t* __restrict__ cw_s, uint8_t* __restrict__ cw_v,
                       uint8_t* __restrict__ cw_t,
                       uint8_t* __restrict__ cw_np1,
                       uint8_t* __restrict__ traj, long long k_num, int n,
                       int lam, int lt) {
  __shared__ dcf::NarrowTables tab;
  dcf::fill_narrow_tables(tab, sbox, rk0, rk17);
  __syncthreads();

  const size_t key = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (key >= (size_t)k_num) return;
  const size_t rows = key * n;  // this key's first level row
  dcf::keygen_key<MODE>(
      tab, n, lt != 0, alphas + key * (n / 8), betas + key * lam,
      s0s + key * 2 * lam, s0s + key * 2 * lam + lam, lam,
      cw_s + rows * lam, cw_v ? cw_v + rows * lam : nullptr,
      cw_t + rows * 2, cw_np1 + key * lam, traj ? traj + rows * 2 : nullptr);
}

template <int MODE>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk0,
                   const uint8_t* rk17, const uint8_t* alphas,
                   const uint8_t* betas, const uint8_t* s0s, uint8_t* cw_s,
                   uint8_t* cw_v, uint8_t* cw_t, uint8_t* cw_np1,
                   uint8_t* traj, long long k_num, int n, int lam, int lt,
                   cudaStream_t stream) {
  const long long blocks = (k_num + dcf::kThreads - 1) / dcf::kThreads;
  keygen_walk_kernel<MODE><<<(unsigned)blocks, dcf::kThreads, 0, stream>>>(
      sbox, rk0, rk17, alphas, betas, s0s, cw_s, cw_v, cw_t, cw_np1, traj,
      k_num, n, lam, lt);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  mode: 0 = G1 (lam = 16; rk17 unused), 1 = B7a
// (writes the narrow 32 bytes of each lam-byte row and traj), 2 = B7b (no
// cw_v).  alphas [K, n/8], betas [K, lam], s0s [K, 2, lam]; cw_s / cw_v
// [K, n, lam], cw_t [K, n, 2], cw_np1 [K, lam], traj [K, n, 2] bytes.
extern "C" int dcf_keygen_walk(const void* sbox, const void* rk0,
                               const void* rk17, const void* alphas,
                               const void* betas, const void* s0s, void* cw_s,
                               void* cw_v, void* cw_t, void* cw_np1,
                               void* traj, long long k_num, int n, int lam,
                               int lt, int mode, void* stream) {
#define DCF_ARGS                                                             \
  (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,           \
      (const uint8_t*)alphas, (const uint8_t*)betas, (const uint8_t*)s0s,    \
      (uint8_t*)cw_s, (uint8_t*)cw_v, (uint8_t*)cw_t, (uint8_t*)cw_np1,      \
      (uint8_t*)traj, k_num, n, lam, lt, (cudaStream_t)stream
  if (k_num < 1) return (int)cudaSuccess;
  switch (mode) {
    case dcf::kKgDcf16: return (int)launch<dcf::kKgDcf16>(DCF_ARGS);
    case dcf::kKgNarrow: return (int)launch<dcf::kKgNarrow>(DCF_ARGS);
    case dcf::kKgDpf32: return (int)launch<dcf::kKgDpf32>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}
