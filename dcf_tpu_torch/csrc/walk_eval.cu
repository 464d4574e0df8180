// Kernel B1: party-b DCF evaluation at lam = 16, the from-root walk.
//
// Replaces dcf_tpu/ops/pallas_eval.py::dcf_eval_pallas (its _kernel and
// walk_levels), which walks 32 points per int32 lane word through a
// bitsliced AES held in VMEM.
//
// Bound on the H100: operations, namely the shared-memory table lookups of
// AES-256.  Each point costs 2 blocks x 14 rounds x 16 lookups per level;
// the bytes moved (points in, shares out, 4.6 KB of correction words per
// key) are negligible beside that.  Design: one thread per (key, point);
// the seed, the value accumulator and t stay in registers for all n
// levels; the T-tables, the round keys and the key's n correction words are
// loaded into shared memory once per block, where every thread of the
// block reads the same correction word at the same level (a broadcast).
// Only the table lookups themselves are data dependent.
//
// Grid: (ceil(m / 256), K).  Points are shared by all keys or given per
// key.  Shares are written as uint8 [K, m, 16].

#include <cuda_runtime.h>

#include "dcf_walk.cuh"

namespace {

template <int GW>
__global__ void __launch_bounds__(dcf::kThreads)
    walk_eval_kernel(const uint8_t* __restrict__ sbox,
                     const uint8_t* __restrict__ rk,
                     const uint8_t* __restrict__ s0,
                     const uint8_t* __restrict__ cw_s,
                     const uint8_t* __restrict__ cw_v,
                     const uint8_t* __restrict__ cw_t,
                     const uint8_t* __restrict__ cw_np1,
                     const uint8_t* __restrict__ xs, uint8_t* __restrict__ y,
                     int n, int m, int x_per_key, uint32_t t0, int negate) {
  __shared__ dcf::AesTables aes;
  __shared__ uint32_t key_words[8];  // s0 | cw_np1
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  dcf::LevelCw* cw = reinterpret_cast<dcf::LevelCw*>(dyn_smem);

  const int key = blockIdx.y;
  dcf::fill_aes_tables(aes, sbox, rk);
  dcf::fill_level_cws(cw, cw_s + (size_t)key * n * 16,
                      cw_v + (size_t)key * n * 16, cw_t + (size_t)key * n * 2,
                      n);
  if (threadIdx.x < 4) {
    key_words[threadIdx.x] = dcf::le32(s0 + key * 16 + 4 * threadIdx.x);
    key_words[4 + threadIdx.x] =
        dcf::le32(cw_np1 + key * 16 + 4 * threadIdx.x);
  }
  __syncthreads();

  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= m) return;
  const int nb = n / 8;
  const uint8_t* x =
      xs + ((x_per_key ? (size_t)key * m : 0) + (size_t)pt) * nb;
  uint32_t out[4];
  dcf::walk_point<GW>(aes, cw, n, key_words, key_words + 4, x, t0,
                      negate != 0, out);
  reinterpret_cast<uint4*>(y)[(size_t)key * m + pt] =
      make_uint4(out[0], out[1], out[2], out[3]);
}

template <int GW>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk, const uint8_t* s0,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, const uint8_t* cw_np1,
                   const uint8_t* xs, uint8_t* y, int k_num, int n, int m,
                   int x_per_key, int b, int negate, cudaStream_t stream) {
  const size_t smem = sizeof(dcf::LevelCw) * (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        walk_eval_kernel<GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((m + dcf::kThreads - 1) / dcf::kThreads, k_num);
  walk_eval_kernel<GW><<<grid, dcf::kThreads, smem, stream>>>(
      sbox, rk, s0, cw_s, cw_v, cw_t, cw_np1, xs, y, n, m, x_per_key,
      (uint32_t)b, negate);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  gw: 0 = xor, 8/16/32 = additive lane width.
extern "C" int dcf_walk_eval(const void* sbox, const void* rk, const void* s0,
                             const void* cw_s, const void* cw_v,
                             const void* cw_t, const void* cw_np1,
                             const void* xs, void* y, int k_num, int n, int m,
                             int x_per_key, int b, int negate, int gw,
                             void* stream) {
#define DCF_ARGS                                                             \
  (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)s0,              \
      (const uint8_t*)cw_s, (const uint8_t*)cw_v, (const uint8_t*)cw_t,      \
      (const uint8_t*)cw_np1, (const uint8_t*)xs, (uint8_t*)y, k_num, n, m,  \
      x_per_key, b, negate, (cudaStream_t)stream
  switch (gw) {
    case 0: return (int)launch<0>(DCF_ARGS);
    case 8: return (int)launch<8>(DCF_ARGS);
    case 16: return (int)launch<16>(DCF_ARGS);
    case 32: return (int)launch<32>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}
