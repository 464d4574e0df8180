// Kernel B8: party-b DCF evaluation at lam = 16 in the XOR group, many
// keys at few shared points (the secure-ReLU shape, BASELINE.json config 5:
// 10^6 keys x 1024 points).
//
// Replaces dcf_tpu/ops/pallas_keylanes.py::dcf_eval_keylanes_pallas, which
// packs 32 keys per lane word, keeps a (point tile x key tile) carry in VMEM
// across chunks of 8 levels and round-trips it through HBM between chunks.
// Here nothing of that layout is kept: one thread walks one (key, point)
// from the root with walk_point (dcf_walk.cuh), as kernel B1 does.
//
// Bound on the H100: operations, the shared-memory table lookups of
// AES-256 (a left turn needs E(s) and E(~s), a right turn E(~s) only;
// 14 rounds x 16 lookups a block).  The bytes are the shares written, 16 a
// (key, point), and 4.6 KB of correction words a key at n = 128.  Design:
// the key axis is not a grid axis.  A persistent grid of as many blocks as
// fit on the card at once fills the T-tables and round keys in shared
// memory once, then takes keys in a grid-stride loop; for each key it
// stages the key's n correction words, its party-b seed and cw_np1 in
// shared memory once and walks all M points, blockDim points at a time
// (every thread of the block reads the same correction word at the same
// level: a broadcast).  It reads the key image in the byte layout kernel G1
// writes, both parties' seeds in one [K, 2, 16] array, in place.  Offsets
// are 64-bit: one chunk of 2^17 keys x 1024 points is 2^31 share bytes.

#include <cuda_runtime.h>

#include "dcf_walk.cuh"

namespace {

__global__ void __launch_bounds__(dcf::kThreads)
    keylanes_eval_kernel(const uint8_t* __restrict__ sbox,
                         const uint8_t* __restrict__ rk,
                         const uint8_t* __restrict__ s0s,
                         const uint8_t* __restrict__ cw_s,
                         const uint8_t* __restrict__ cw_v,
                         const uint8_t* __restrict__ cw_t,
                         const uint8_t* __restrict__ cw_np1,
                         const uint8_t* __restrict__ xs,
                         uint8_t* __restrict__ y, long long k_num, int n,
                         int m, int b) {
  __shared__ dcf::AesTables aes;
  __shared__ uint32_t key_words[8];  // party-b seed | cw_np1
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  dcf::LevelCw* cw = reinterpret_cast<dcf::LevelCw*>(dyn_smem);

  dcf::fill_aes_tables(aes, sbox, rk);
  const int nb = n / 8;
  for (long long key = blockIdx.x; key < k_num; key += gridDim.x) {
    __syncthreads();  // the tables are in; the last key's words are done
    const size_t k = (size_t)key;
    dcf::fill_level_cws(cw, cw_s + k * n * 16, cw_v + k * n * 16,
                        cw_t + k * n * 2, n);
    if (threadIdx.x < 4) {
      key_words[threadIdx.x] =
          dcf::le32(s0s + k * 32 + b * 16 + 4 * threadIdx.x);
      key_words[4 + threadIdx.x] =
          dcf::le32(cw_np1 + k * 16 + 4 * threadIdx.x);
    }
    __syncthreads();
    for (int pt = threadIdx.x; pt < m; pt += blockDim.x) {
      uint32_t out[4];
      dcf::walk_point<0>(aes, cw, n, key_words, key_words + 4,
                         xs + (size_t)pt * nb, (uint32_t)b, false, out);
      reinterpret_cast<uint4*>(y)[k * m + pt] =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  s0s [K, 2, 16] (both parties), cw_s / cw_v
// [K, n, 16], cw_t [K, n, 2], cw_np1 [K, 16], xs [m, n/8] shared by all
// keys; y [K, m, 16].
extern "C" int dcf_keylanes_eval(const void* sbox, const void* rk,
                                 const void* s0s, const void* cw_s,
                                 const void* cw_v, const void* cw_t,
                                 const void* cw_np1, const void* xs, void* y,
                                 long long k_num, int n, int m, int b,
                                 void* stream) {
  if (k_num < 1 || m < 1) return (int)cudaSuccess;
  const size_t smem = sizeof(dcf::LevelCw) * (size_t)n;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(keylanes_eval_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, keylanes_eval_kernel, dcf::kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > k_num) blocks = k_num;
  keylanes_eval_kernel<<<(unsigned)blocks, dcf::kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)s0s,
      (const uint8_t*)cw_s, (const uint8_t*)cw_v, (const uint8_t*)cw_t,
      (const uint8_t*)cw_np1, (const uint8_t*)xs, (uint8_t*)y, k_num, n, m,
      b);
  return (int)cudaGetLastError();
}
