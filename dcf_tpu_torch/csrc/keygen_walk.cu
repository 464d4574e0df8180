// Kernels G1, B7a, B7b and G2: DCF and DPF key generation, one thread per key.
//
// G1   replaces the XLA level scan dcf_tpu/backends/device_gen.py::_gen_core
//      (lam = 16), which the JAX package runs over keys packed 32 to a
//      lane word;
// B7a  replaces dcf_tpu/ops/pallas_keygen.py::dcf_keygen_walk_pallas, the
//      narrow 32 bytes of a lam >= 48 key and both parties' trajectories;
// B7b  replaces dcf_tpu/ops/pallas_keygen.py::dpf_keygen_walk_pallas, the
//      lam = 32 DPF key;
// G2   replaces the XLA level scan dcf_tpu/backends/device_gen.py::_gen_core
//      at lam = 32, the lam = 32 DCF key (XOR group).
//
// Bound on the H100: operations, the shared-memory table lookups of
// AES-256, 14 rounds x 16 lookups a block: per key and level 2 parties x 2
// blocks (G1), x 4 (B7a and G2), x 2 blocks and a t bit (B7b: 224 + 224 +
// 197 lookups, the bit needing 12 full rounds and 5 lookups).  The bytes are
// the inputs (alpha, beta, two seeds) and the correction words written
// once, 34 bytes a level at lam = 16 (4.35 GB for 10^6 keys at n = 128,
// about a tenth of G1's lookup time at 3.35 TB/s).  One thread walks one key's n levels with both
// parties' state in registers (keygen_walk.cuh); keys lie on the grid's x
// axis (no 65,535 limit) and every offset is 64-bit.  Each level's
// correction words go out as 16-byte stores, one row per thread.
//
// The three run on the banked AES of aes_banked.cuh (64 KB in dynamic
// shared memory, one wavefront a warp's lookups), every lane doing the
// same work, as in kernel B8: G1 both parties' four blocks of a level in
// lockstep (KgBanked16), B7a a party's four, one party after the other
// (KgBankedNarrow), B7b B6's masked step (KgBankedDpf), both parties'
// four blocks and two t bits in lockstep, G2 B7a's expansion with the
// lam = 32 mask (KgBankedDcf32).  On the four 1 KB
// T-tables of dcf_walk.cuh, where about 3.3 lanes' lookups fall into one
// bank, G1 reached 29% of its bound, B7a 26% and B7b 28%; on the banked
// AES G1 76% (18.1 ms for 10^6 keys at n = 128), B7a 71% (2.51 ms at
// lam = 256, K = 2^16) and B7b 71-72% (0.34 ms at n = 24, K = 2^16,
// 0.84-0.86 ms on the T-tables; NVIDIA H100 80GB HBM3, 700 W power limit,
// chip_smoke.py and chip_ab.py).  In turns (chip_ab.py): for B7b both
// parties' blocks in lockstep beat one party after the other by 1-2%,
// and 512-thread blocks beat 256 (0.341 against 0.355 ms: with one
// thread a key, 2^16 keys leave 512 threads on the busiest SM either
// way); for G1 four blocks in lockstep beat two and two, also at
// 768 threads a block, and a key's alpha read a byte each 8 levels with a
// level's t bits in one store beat a byte load and two stores a level
// (B7a stores a level's two trajectory bytes in one store too); for B7a
// both parties' eight blocks in lockstep (128 registers) ran 2% slower
// than four and four (127) at lam = 256, K = 2^16, and 3-5% faster at
// lam = 16384, K = 64, where 64 threads wait on latency; streaming stores
// of the correction words changed neither.  Their grid is persistent: as
// many 512-thread blocks as fit on the card, never more than the keys
// need, fill the table once and take keys in a stride loop.

#include <cuda_runtime.h>

#include "keygen_walk.cuh"

namespace {

constexpr int kBlock = 512;

// The shared layout: the banked table, then cipher 0's round keys and,
// for B7a, B7b and G2, cipher 17's.
template <int MODE>
constexpr size_t kSmem =
    sizeof(uint32_t) * dcf::kBankedWords +
    sizeof(dcf::RoundKey) * (MODE == dcf::kKgDcf16 ? 16 : 32);

// One key's rows: its keygen by `expand`.
template <int MODE, typename Expand>
__device__ __forceinline__ void key_rows(
    const Expand& expand, size_t key, const uint8_t* alphas,
    const uint8_t* betas, const uint8_t* s0s, uint8_t* cw_s, uint8_t* cw_v,
    uint8_t* cw_t, uint8_t* cw_np1, uint8_t* traj, int n, int lam, int lt) {
  const size_t rows = key * n;  // this key's first level row
  dcf::keygen_key<MODE>(
      expand, n, lt != 0, alphas + key * (n / 8), betas + key * lam,
      s0s + key * 2 * lam, s0s + key * 2 * lam + lam, lam,
      cw_s + rows * lam, cw_v ? cw_v + rows * lam : nullptr,
      cw_t + rows * 2, cw_np1 + key * lam, traj ? traj + rows * 2 : nullptr);
}

// G1 (MODE kKgDcf16, lam = 16, no traj), B7a (kKgNarrow), B7b
// (kKgDpf32, lam = 32, no cw_v, no traj) and G2 (kKgDcf32, lam = 32, no
// traj).
template <int MODE>
__global__ void __launch_bounds__(kBlock, 1)
    keygen_banked_kernel(const uint8_t* __restrict__ sbox,
                         const uint8_t* __restrict__ rk0,
                         const uint8_t* __restrict__ rk17,
                         const uint8_t* __restrict__ alphas,
                         const uint8_t* __restrict__ betas,
                         const uint8_t* __restrict__ s0s,
                         uint8_t* __restrict__ cw_s,
                         uint8_t* __restrict__ cw_v,
                         uint8_t* __restrict__ cw_t,
                         uint8_t* __restrict__ cw_np1,
                         uint8_t* __restrict__ traj, long long k_num, int n,
                         int lam, int lt) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks, rk0);
  if constexpr (MODE != dcf::kKgDcf16) dcf::fill_round_keys(rks + 16, rk17);
  __syncthreads();

  const dcf::BkLane lane = dcf::bk_lane(te, threadIdx.x & 31);
  const size_t stride = (size_t)gridDim.x * kBlock;
  for (size_t key = (size_t)blockIdx.x * kBlock + threadIdx.x;
       key < (size_t)k_num; key += stride) {
    if constexpr (MODE == dcf::kKgDcf16)
      key_rows<MODE>(dcf::KgBanked16{lane, rks}, key, alphas, betas, s0s,
                     cw_s, cw_v, cw_t, cw_np1, nullptr, n, 16, lt);
    else if constexpr (MODE == dcf::kKgNarrow)
      key_rows<MODE>(dcf::KgBankedNarrow{lane, rks, rks + 16}, key, alphas,
                     betas, s0s, cw_s, cw_v, cw_t, cw_np1, traj, n, lam, lt);
    else if constexpr (MODE == dcf::kKgDpf32)
      key_rows<MODE>(dcf::KgBankedDpf{lane, rks, rks + 16}, key, alphas,
                     betas, s0s, cw_s, nullptr, cw_t, cw_np1, nullptr, n, 32,
                     lt);
    else
      key_rows<MODE>(dcf::KgBankedDcf32{{lane, rks, rks + 16}}, key, alphas,
                     betas, s0s, cw_s, cw_v, cw_t, cw_np1, nullptr, n, 32,
                     lt);
  }
}

template <int MODE>
cudaError_t launch_banked(const uint8_t* sbox, const uint8_t* rk0,
                          const uint8_t* rk17, const uint8_t* alphas,
                          const uint8_t* betas, const uint8_t* s0s,
                          uint8_t* cw_s, uint8_t* cw_v, uint8_t* cw_t,
                          uint8_t* cw_np1, uint8_t* traj, long long k_num,
                          int n, int lam, int lt, cudaStream_t stream) {
  constexpr size_t smem = kSmem<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      keygen_banked_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, keygen_banked_kernel<MODE>, kBlock, smem);
  if (e != cudaSuccess) return e;
  const long long need = (k_num + kBlock - 1) / kBlock;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  keygen_banked_kernel<MODE><<<(unsigned)(need < most ? need : most), kBlock,
                               smem, stream>>>(
      sbox, rk0, rk17, alphas, betas, s0s, cw_s, cw_v, cw_t, cw_np1, traj,
      k_num, n, lam, lt);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  mode: 0 = G1 (lam = 16; rk17 unused), 1 = B7a
// (writes the narrow 32 bytes of each lam-byte row and traj), 2 = B7b
// (lam = 32; no cw_v, no traj, lt unused), 3 = G2 (lam = 32; no traj).  alphas [K, n/8], betas
// [K, lam], s0s [K, 2, lam]; cw_s / cw_v [K, n, lam], cw_t [K, n, 2],
// cw_np1 [K, lam], traj [K, n, 2] bytes.
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
    case dcf::kKgDcf16: return (int)launch_banked<dcf::kKgDcf16>(DCF_ARGS);
    case dcf::kKgNarrow: return (int)launch_banked<dcf::kKgNarrow>(DCF_ARGS);
    case dcf::kKgDpf32: return (int)launch_banked<dcf::kKgDpf32>(DCF_ARGS);
    case dcf::kKgDcf32: return (int)launch_banked<dcf::kKgDcf32>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}
