// Kernel E1: party-b DCF evaluation at lam = 32, the from-root walk.
//
// Replaces the XLA lax.scan of
// dcf_tpu/backends/jax_bitsliced.py::eval_core_bitsliced at lam = 32 (the
// BitslicedBackend that dcf_tpu's facade picks for 16 < lam < 48), which
// walks 256 bit planes per (key, 32 points) through a bitsliced AES of the
// level's prg_planes.  No pallas_call computes it; as for the XLA
// computations W1, P1, G1 and W2, this kernel is written for the card.
//
// The lam = 32 Hirose PRG encrypts both of its blocks (cipher 0 on block
// 0, cipher 17 on block 1), as the narrow walk of kernel B4 does, and
// masks its output bit 8*lam-1 (bit 0 of byte 31) in all four children,
// the copied halves included, before the level's correction enters.  So a
// level here is B4's three-slot level (narrow_level_banked of
// narrow_walk.cuh) with that mask, v accumulated in the output group, and
// no trajectory: one thread owns one (key, point), its 32-byte s and v as
// eight uint32 words each.
//
// Bound on the H100: operations, the shared-memory table lookups a walk
// needs (14 rounds x 16 a block): two blocks on a left turn (E0(s_b0),
// E0(~s_b0)); on a right turn two blocks and bit 0 of a third (E17(s_b1),
// E17(~s_b1), and E0(~s_b0) for t_r: 197 lookups), B4's count.  The bytes
// are small beside them: the points in, 32 bytes of shares out per point.
// Design, B4's: the banked AES of aes_banked.cuh (one wavefront a warp's
// lookups), slot C (E17(~s_b1)) run where some lane of the warp turns
// right (a warp vote), so a mixed warp computes three blocks a level and an
// all-left warp two; cipher 0's and cipher 17's round keys in different
// banks, the 68-byte CWs of every level in shared memory.  Grid: point
// blocks of 512 threads x keys (two blocks an SM with the 64 KB table).
// Points are shared by all keys or given per key; a thread past the last
// point walks the last point, so that the warp's votes see every lane, and
// stores nothing.  Shares are written as uint8 [K, m, 32], party 1 of an
// additive group negated.

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

// 512 threads a block: with a 64 KB table, two blocks (32 warps) an SM.
constexpr int kBlock = 512;

// Shared layout (B4's): the banked table, cipher 0's round keys, cipher
// 17's 80 words on (bank 16: slot B reads both in one instruction), the
// CWs.
constexpr int kRk17 = 20;  // RoundKey rows from rk0 to rk17
constexpr size_t kCwOffset =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * (kRk17 + 16);

template <int GW>
__global__ void __launch_bounds__(kBlock, 2)
    walk32_eval_kernel(const uint8_t* __restrict__ sbox,
                       const uint8_t* __restrict__ rk0,
                       const uint8_t* __restrict__ rk17,
                       const uint8_t* __restrict__ s0,
                       const uint8_t* __restrict__ cw_s,
                       const uint8_t* __restrict__ cw_v,
                       const uint8_t* __restrict__ cw_t,
                       const uint8_t* __restrict__ cw_np1,
                       const uint8_t* __restrict__ xs,
                       uint8_t* __restrict__ y, int n, int m, int x_per_key,
                       int b) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks0 =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  dcf::RoundKey* rks17 = rks0 + kRk17;
  dcf::NarrowCw* cw = reinterpret_cast<dcf::NarrowCw*>(dyn_smem + kCwOffset);
  __shared__ uint32_t seed[8], np1[8];

  const int key = blockIdx.y;
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks0, rk0);
  dcf::fill_round_keys(rks17, rk17);
  dcf::fill_narrow_cws(cw, cw_s + (size_t)key * n * 32,
                       cw_v + (size_t)key * n * 32,
                       cw_t + (size_t)key * n * 2, n);
  if (threadIdx.x < 8) {
    seed[threadIdx.x] = dcf::le32(s0 + key * 32 + 4 * threadIdx.x);
    np1[threadIdx.x] = dcf::le32(cw_np1 + key * 32 + 4 * threadIdx.x);
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int pt = p < m ? p : m - 1;
  const size_t xrow = (x_per_key ? (size_t)key * m : 0) + pt;
  uint32_t out[8];
  dcf::walk32_point_banked<GW>(dcf::bk_lane(te, threadIdx.x & 31), rks0,
                               rks17, cw, n, seed, (uint32_t)b, np1,
                               xs + xrow * (n / 8), dcf::WarpVote(), out);
  if (p < m) dcf::store32(y + ((size_t)key * m + p) * 32, out);
}

template <int GW>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk0,
                   const uint8_t* rk17, const uint8_t* s0,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, const uint8_t* cw_np1,
                   const uint8_t* xs, uint8_t* y, int k_num, int n, int m,
                   int x_per_key, int b, cudaStream_t stream) {
  if (k_num < 1 || m < 1) return cudaSuccess;
  const size_t smem = kCwOffset + sizeof(dcf::NarrowCw) * (size_t)n;
  cudaError_t e = cudaFuncSetAttribute(
      walk32_eval_kernel<GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((m + kBlock - 1) / kBlock, k_num);
  walk32_eval_kernel<GW><<<grid, kBlock, smem, stream>>>(
      sbox, rk0, rk17, s0, cw_s, cw_v, cw_t, cw_np1, xs, y, n, m, x_per_key,
      b);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  gw: 0 = xor, 8/16/32 = additive lane width.
// k_num <= 65,535 (the grid's y axis); y is 16-byte aligned.
extern "C" int dcf_walk32_eval(const void* sbox, const void* rk0,
                               const void* rk17, const void* s0,
                               const void* cw_s, const void* cw_v,
                               const void* cw_t, const void* cw_np1,
                               const void* xs, void* y, int k_num, int n,
                               int m, int x_per_key, int b, int gw,
                               void* stream) {
#define DCF_ARGS                                                             \
  (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,           \
      (const uint8_t*)s0, (const uint8_t*)cw_s, (const uint8_t*)cw_v,        \
      (const uint8_t*)cw_t, (const uint8_t*)cw_np1, (const uint8_t*)xs,      \
      (uint8_t*)y, k_num, n, m, x_per_key, b, (cudaStream_t)stream
  switch (gw) {
    case 0: return (int)launch<0>(DCF_ARGS);
    case 8: return (int)launch<8>(DCF_ARGS);
    case 16: return (int)launch<16>(DCF_ARGS);
    case 32: return (int)launch<32>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}
