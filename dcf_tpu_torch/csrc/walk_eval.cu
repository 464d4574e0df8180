// Kernel B1: party-b DCF evaluation at lam = 16, the from-root walk.
//
// Replaces dcf_tpu/ops/pallas_eval.py::dcf_eval_pallas (its _kernel and
// walk_levels), which walks 32 points per int32 lane word through a
// bitsliced AES held in VMEM.
//
// Bound on the H100: operations, the shared-memory table lookups of
// AES-256 the walk needs: a left turn E(s) and E(~s), 14 rounds x 16
// lookups a block; a right turn only t_r, bit 0 of E(~s) (197 lookups),
// since its s and v are copies of s and ~s.  The bytes moved (points in,
// shares out, 34 bytes of correction words a level and key) are small
// beside that.  The first design (one thread a (key, point) on the four
// 1 KB T-tables of dcf_walk.cuh, both blocks in full at every level)
// reached 23% of that bound (NVIDIA H100 80GB HBM3, 700 W power limit,
// chip_smoke.py): the tables put about 3.3 lanes' lookups into one bank.
// This design (aes_banked.cuh):
//
//   - the banked AES, a 64 KB table with T0 and T2 once for each lane, so
//     a warp's 32 lookups are one wavefront, with the round loop rolled;
//   - two points a lane, their blocks in lockstep (walk_pair_levels): per
//     level and point a warp vote; where some lane turns left with that
//     point, its E(s) and E(~s) run in full, else bit 0 of E(~s) alone.
//     Random points run 4 chains a lane, 448 lookups a point and level
//     (the bound counts 322.5 on average); points in order, whose warp
//     turns the same way at the top levels, compute what those turns need;
//   - a persistent grid: one 512-thread block an SM fills the table once,
//     and its warps take units of (key, 64 points) in a grid-stride
//     order, so that few points still spread over the SMs.  The key's
//     correction words are read from device memory at each level, one
//     broadcast load for the warp.
//
// Why the left turns' E(s) are not dealt out across the warp: a ballot
// and a job list in shared memory (3.45 blocks a lane on random points)
// compute 14% fewer lookups, but the exchange sits on every level's
// critical path, and that design ran 2% slower on an H100 (PERF.md).
//
// Points are shared by all keys or given per key; a lane past the last
// point walks the last point, so that the warp's votes see every lane,
// and stores nothing.  Shares are written as uint8 [K, m, 16].

#include <cuda_runtime.h>

#include "aes_banked.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kBlock = dcf::kLanes * kWarps;
constexpr int kTile = 2 * dcf::kLanes;  // points of a warp's unit
// Shared layout: the banked table, then the round keys.
constexpr size_t kSmem =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * 16;

template <int GW>
__global__ void __launch_bounds__(kBlock, 1)
    walk_eval_kernel(const uint8_t* __restrict__ sbox,
                     const uint8_t* __restrict__ rk,
                     const uint8_t* __restrict__ s0,
                     const uint8_t* __restrict__ cw_s,
                     const uint8_t* __restrict__ cw_v,
                     const uint8_t* __restrict__ cw_t,
                     const uint8_t* __restrict__ cw_np1,
                     const uint8_t* __restrict__ xs, uint8_t* __restrict__ y,
                     int n, int m, int x_per_key, uint32_t t0, int negate,
                     long long tiles, long long units) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks, rk);
  __syncthreads();

  const dcf::BkLane tl = dcf::bk_lane(te, lane);
  const int nb = n / 8;
  for (long long u = (long long)warp * gridDim.x + blockIdx.x; u < units;
       u += (long long)kWarps * gridDim.x) {
    const size_t key = (size_t)(u / tiles);
    const int p0 = (int)(u % tiles) * kTile + lane;
    const int p1 = p0 + dcf::kLanes;
    const uint8_t* xk = xs + (x_per_key ? key * m : 0) * nb;
    const uint8_t* x0 = xk + (size_t)(p0 < m ? p0 : m - 1) * nb;
    const uint8_t* x1 = xk + (size_t)(p1 < m ? p1 : m - 1) * nb;
    uint32_t seed[4], np1[4];
    dcf::load16(s0 + key * 16, seed);
    dcf::load16(cw_np1 + key * 16, np1);
    dcf::KlState p[2];
    dcf::walk_root(p[0], seed, t0);
    dcf::walk_root(p[1], seed, t0);
    dcf::walk_pair_levels<GW>(tl, rks, cw_s + key * n * 16,
                              cw_v + key * n * 16, cw_t + key * n * 2, 0, n,
                              x0, x1, p[0], p[1]);
    uint4* yk = reinterpret_cast<uint4*>(y) + key * m;
    uint32_t out[4];
    if (p0 < m) {
      dcf::finalize<GW>(p[0].s, p[0].t, p[0].v, np1, negate != 0, out);
      yk[p0] = make_uint4(out[0], out[1], out[2], out[3]);
    }
    if (p1 < m) {
      dcf::finalize<GW>(p[1].s, p[1].t, p[1].v, np1, negate != 0, out);
      yk[p1] = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <int GW>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk, const uint8_t* s0,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, const uint8_t* cw_np1,
                   const uint8_t* xs, uint8_t* y, int k_num, int n, int m,
                   int x_per_key, int b, int negate, cudaStream_t stream) {
  if (k_num < 1 || m < 1) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      walk_eval_kernel<GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, walk_eval_kernel<GW>, kBlock, kSmem);
  if (e != cudaSuccess) return e;
  const long long tiles = (m + kTile - 1) / kTile;
  const long long units = tiles * k_num;
  const long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = units < blocks ? units : blocks;
  walk_eval_kernel<GW><<<(unsigned)grid, kBlock, kSmem, stream>>>(
      sbox, rk, s0, cw_s, cw_v, cw_t, cw_np1, xs, y, n, m, x_per_key,
      (uint32_t)b, negate, tiles, units);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  gw: 0 = xor, 8/16/32 = additive lane width.
// s0, cw_s, cw_v, cw_np1 and y are 16-byte aligned.
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
