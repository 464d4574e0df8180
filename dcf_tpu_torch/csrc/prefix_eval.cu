// Kernel B3: DCF evaluation from a prefix frontier, lam = 16.
//
// Replaces dcf_tpu/ops/pallas_prefix.py::dcf_eval_prefix_pallas (its
// _kernel, _transpose32_raw and rows_to_state_planes) together with the
// XLA row gather that feeds it (dcf_tpu/backends/pallas_prefix.py,
// gather_and_walk).  On the TPU the gather runs outside the kernel and the
// gathered rows are bit-transposed into planes inside it.  Here the gather
// runs inside the kernel: each point's frontier index is the first k bits
// of the point (bit-reversed, the tree's [lefts ; rights] order), its
// 32-byte row holds s with t stashed in the masked bit 0 of byte 15, then
// v, and the walk goes on through the remaining n - k levels.  No
// transpose is needed, because the state is bytes, not bit planes.
//
// Bound on the H100: operations, the shared-memory AES lookups the n - k
// walked levels need (a left turn E(s) and E(~s), a right turn bit 0 of
// E(~s), 197 lookups; 322.5 a point and level on random points).  The one
// random 32-byte row load a point is small beside them, though at k = 21
// the table (64 MB a key) does not fit in L2.  The first design (one
// thread a point on the four 1 KB T-tables of dcf_walk.cuh) reached 22% of
// that bound; the second, B1's two points a lane with a warp vote a level
// and point, 63%: on random points some lane turns left with each point at
// every level, so every lane ran E(s) and E(~s) of both points, 448
// lookups a point and level, 1.389x the bound's (NVIDIA H100 80GB HBM3,
// 700 W power limit, chip_smoke.py).
//
// This design is the slot-per-point schedule of aes_banked.cuh
// (prefix_slot_walk): a lane holds kPrefixSlots points in flight and each
// step runs one block a slot in lockstep on the banked AES, the block that
// slot's point needs at its own level (a right turn E(~s), a left turn
// E(~s) then E(s)).  Random points so issue 336 lookups a point and level,
// 1.042x the bound's, with no vote and no exchange between lanes; the
// lanes' last steps leave about 4% of the slot-steps idle.  Each slot reads
// its own level's correction words (34 bytes through L1), its walk bits
// from a window register, and a finished point's slot stores its share
// and gathers the lane's next point's row.  A persistent grid deals units
// of (key, 32 kPrefixSlots points) to warps, kPrefixSlots of each unit to
// a lane, so that a warp's lanes finish together.  The slots read the
// table through BkWin (aes_banked.cuh), at a 64 KB boundary of shared
// memory and with T1 and T3 stored, since their lanes leave one another's
// step.
//
// A unit whose points turn alike (sorted points), and every unit of a walk
// shorter than dcf::kSlotMinLevels levels, is walked as B1 walks, two
// points a lane with the vote, before the slots start
// (dcf::pair_walks_unit): there the vote computes no more than the turns
// need, where the slots would compute each right turn's E(~s) in full, and
// a short walk's slots would take a new point every few steps.  Points are
// shared by all keys; key j reads frontier rows [j * 2^k, (j + 1) * 2^k)
// of the stacked table.

#include <cuda_runtime.h>

#include "aes_banked.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kBlock = dcf::kLanes * kWarps;
constexpr int kTile = dcf::kLanes * dcf::kPrefixSlots;  // a unit's points
// Shared layout: the round keys, then the banked table and its rotated
// copy (BkWin) from the next 64 KB boundary of the shared window.
constexpr size_t kTableBytes = sizeof(uint32_t) * dcf::kBankedWords;
constexpr size_t kKeysBytes = sizeof(dcf::RoundKey) * 16;
constexpr size_t kSmem = kKeysBytes + (kTableBytes - 16) + 2 * kTableBytes;

// The warp's units that dcf::pair_walks_unit gives the pair walk, walked
// as B1 walks its points: 64 points at a time, two a lane in lockstep
// with a warp vote a level and point (walk_pair_levels), a point past the
// unit's last walking the last one and not stored.  All lanes take the
// same units, so the warp is whole at every vote.  Every lane finds the
// same answer for a unit; the vote on it once a unit only lets the
// compiler see that, and so keep the warp's branches, and the table's
// base, uniform.
template <int GW>
__device__ void walk_paired_units(const dcf::BkLane& tl,
                                  const dcf::RoundKey* rks,
                                  const dcf::SlotWalk& a, int lane,
                                  dcf::SlotUnits u) {
  for (; u.key < a.keys; dcf::slot_units_next(a, u)) {
    if (!__all_sync(0xFFFFFFFFu,
                    dcf::pair_walks_unit<dcf::kPrefixSlots>(a, u.tile)))
      continue;
    const int lim = min((u.tile + 1) * kTile, a.m);
    const uint8_t* rows = a.table + ((size_t)u.key << a.k) * 32;
    const size_t cw = (size_t)u.key * a.n;
    uint32_t np1[4];
    dcf::load16(a.cw_np1 + 16 * (size_t)u.key, np1);
    for (int base = u.tile * kTile; base < lim; base += 2 * dcf::kLanes) {
      const int p0 = base + lane, p1 = p0 + dcf::kLanes;
      const uint8_t* x0 = a.xs + (size_t)min(p0, lim - 1) * a.nb;
      const uint8_t* x1 = a.xs + (size_t)min(p1, lim - 1) * a.nb;
      dcf::KlState p[2];
      dcf::walk_row(p[0], rows + (size_t)dcf::frontier_index(x0, a.k) * 32);
      dcf::walk_row(p[1], rows + (size_t)dcf::frontier_index(x1, a.k) * 32);
      dcf::walk_pair_levels<GW>(tl, rks, a.cw_s + cw * 16, a.cw_v + cw * 16,
                                a.cw_t + cw * 2, a.k, a.n, x0, x1, p[0],
                                p[1]);
      uint8_t* yk = a.y + (size_t)u.key * a.m * 16;
      uint32_t out[4];
      if (p0 < lim) {
        dcf::finalize<GW>(p[0].s, p[0].t, p[0].v, np1, a.negate, out);
        dcf::store16(yk + 16 * (size_t)p0, out);
      }
      if (p1 < lim) {
        dcf::finalize<GW>(p[1].s, p[1].t, p[1].v, np1, a.negate, out);
        dcf::store16(yk + 16 * (size_t)p1, out);
      }
    }
  }
}

template <int GW>
__global__ void __launch_bounds__(kBlock, 1)
    prefix_eval_kernel(const uint8_t* __restrict__ sbox,
                       const uint8_t* __restrict__ rk,
                       const uint8_t* __restrict__ table,
                       const uint8_t* __restrict__ cw_s,
                       const uint8_t* __restrict__ cw_v,
                       const uint8_t* __restrict__ cw_t,
                       const uint8_t* __restrict__ cw_np1,
                       const uint8_t* __restrict__ xs,
                       uint8_t* __restrict__ y, int n, int k, int m,
                       int negate, int tiles, int keys) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  dcf::RoundKey* rks = reinterpret_cast<dcf::RoundKey*>(dyn_smem);
  // The pad to the boundary, a multiple of 16 (dyn_smem is 16-byte
  // aligned).  Every lane finds the same; the warp's OR of it puts it in a
  // uniform register, which keeps the pair walk's table base there too.
  const uint32_t at =
      (uint32_t)__cvta_generic_to_shared(dyn_smem) + (uint32_t)kKeysBytes;
  const uint32_t pad = __reduce_or_sync(
      0xFFFFFFFFu, (0u - at) & (uint32_t)(kTableBytes - 16));
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem + kKeysBytes + pad);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  dcf::fill_banked_table(te, sbox);
  dcf::fill_banked_table_rot8(te + dcf::kBankedWords, sbox);
  dcf::fill_round_keys(rks, rk);
  __syncthreads();

  const dcf::SlotWalk a{table, cw_s, cw_v,  cw_t, cw_np1,      xs,
                        y,     n,    n / 8, k,    m,           negate != 0,
                        tiles, keys};
  const int first = warp * gridDim.x + blockIdx.x;
  const int stride = kWarps * gridDim.x;
  walk_paired_units<GW>(dcf::bk_lane(te, lane), rks, a, lane,
                        {first / tiles, first % tiles, stride});
  dcf::prefix_slot_walk<GW, dcf::kPrefixSlots>(dcf::bk_win(te, lane), rks, a,
                                               lane, first, stride);
}

template <int GW>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk,
                   const uint8_t* table, const uint8_t* cw_s,
                   const uint8_t* cw_v, const uint8_t* cw_t,
                   const uint8_t* cw_np1, const uint8_t* xs, uint8_t* y,
                   int k_num, int n, int k, int m, int negate,
                   cudaStream_t stream) {
  if (k_num < 1 || m < 1) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      prefix_eval_kernel<GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prefix_eval_kernel<GW>, kBlock, kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = (m + kTile - 1) / kTile;
  const long long units = (long long)tiles * k_num;
  const long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = units < blocks ? units : blocks;
  prefix_eval_kernel<GW><<<(unsigned)grid, kBlock, kSmem, stream>>>(
      sbox, rk, table, cw_s, cw_v, cw_t, cw_np1, xs, y, n, k, m, negate,
      tiles, k_num);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  gw: 0 = xor, 8/16/32 = additive lane width.
// table, cw_s, cw_v, cw_np1 and y are 16-byte aligned.
extern "C" int dcf_prefix_eval(const void* sbox, const void* rk,
                               const void* table, const void* cw_s,
                               const void* cw_v, const void* cw_t,
                               const void* cw_np1, const void* xs, void* y,
                               int k_num, int n, int k, int m, int negate,
                               int gw, void* stream) {
#define DCF_ARGS                                                             \
  (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)table,           \
      (const uint8_t*)cw_s, (const uint8_t*)cw_v, (const uint8_t*)cw_t,      \
      (const uint8_t*)cw_np1, (const uint8_t*)xs, (uint8_t*)y, k_num, n, k,  \
      m, negate, (cudaStream_t)stream
  switch (gw) {
    case 0: return (int)launch<0>(DCF_ARGS);
    case 8: return (int)launch<8>(DCF_ARGS);
    case 16: return (int)launch<16>(DCF_ARGS);
    case 32: return (int)launch<32>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}
