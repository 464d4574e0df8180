// Kernel B8: party-b DCF evaluation at lam = 16 in the XOR group, many
// keys at few shared points (the secure-ReLU shape, BASELINE.json config 5:
// 10^6 keys x 1024 points).
//
// Replaces dcf_tpu/ops/pallas_keylanes.py::dcf_eval_keylanes_pallas, which
// packs 32 keys per lane word, keeps a (point tile x key tile) carry in VMEM
// across chunks of 8 levels and round-trips it through HBM between chunks.
// The keys-in-lanes idea carries over; the carry does not.
//
// Bound on the H100: operations, the shared-memory table lookups of
// AES-256 (a left turn needs E(s) and E(~s), 14 rounds x 16 lookups a
// block; a right turn only bit 0 of E(~s), 197 lookups).  The bytes are
// the shares written, 16 a (key, point), and 4.6 KB of correction words a
// key at n = 128.  The first design (one thread a (key, point), B1's
// walk_point) reached 23% of that bound (NVIDIA H100 80GB HBM3, 700 W
// power limit, chip_smoke.py):
// its four 1 KB T-tables put about 3.3 lanes' lookups into one bank, and
// it encrypted both blocks at every level.  This design:
//
//   - the banked AES of aes_banked.cuh (a 64 KB table, T0 and T2 once for
//     each lane), so a warp's 32 lookups are one wavefront and a lookup
//     costs two integer operations;
//   - keys in lanes: a warp walks 32 consecutive keys at points that all
//     its lanes share, so every lane turns the same way at every level: a
//     right turn computes one block, and only to its t bit, a left turn
//     two (keylanes_lane_pair);
//   - two points at a time a warp, their blocks in lockstep (4, 3 or 2
//     lookup chains a level), each level's correction words read once for
//     both; the round loop is not unrolled, which keeps the four lockstep
//     forms in the instruction cache (unrolled, the kernel ran 3.9x
//     slower: chip_ab.py on the same card);
//   - a block of 16 warps holds one group of 32 keys; its correction words
//     are staged in shared memory once, transposed so that lane l's words
//     sit in bank l (128 KB at n = 128), with the 32 keys' t bits packed
//     into two words a level by a ballot; its warps take the M points in a
//     stride loop.  With the table that is one block an SM.  Levels beyond
//     kMaxStaged are read from the keys' rows in device memory;
//   - a persistent grid, as many blocks as fit on the card, takes work
//     units in a grid-stride loop: whole groups, and when the groups do
//     not fill the last wave, the remaining groups split by points so that
//     every block has a share of it (at 2^17 keys, 4 groups past 31 waves:
//     732.9-739.5 ms a chunk, against 759.7-776.7 ms with those groups
//     whole; chip_ab.py, in turns on an NVIDIA H100 80GB HBM3 at 700 W).
//
// It reads the key image in the byte layout kernel G1 writes, both
// parties' seeds in one [K, 2, 16] array, in place.  Lanes past the last
// key walk a copy of it and store nothing; an odd last point is walked
// twice and stored once.  Offsets are 64-bit: one chunk of 2^17 keys x
// 1024 points is 2^31 share bytes.

#include <cuda_runtime.h>

#include "aes_banked.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kBlock = dcf::kLanes * kWarps;
constexpr int kMaxStaged = 160;  // levels staged in shared memory

__global__ void __launch_bounds__(kBlock, 1)
    keylanes_eval_kernel(const uint8_t* __restrict__ sbox,
                         const uint8_t* __restrict__ rk,
                         const uint8_t* __restrict__ s0s,
                         const uint8_t* __restrict__ cw_s,
                         const uint8_t* __restrict__ cw_v,
                         const uint8_t* __restrict__ cw_t,
                         const uint8_t* __restrict__ cw_np1,
                         const uint8_t* __restrict__ xs,
                         uint8_t* __restrict__ y, long long k_num, int n,
                         int m, int b, int staged, long long full,
                         int slices, long long units) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  uint32_t* st_s = reinterpret_cast<uint32_t*>(rks + 16);
  uint32_t* st_v = st_s + (size_t)staged * 4 * dcf::kLanes;
  uint32_t* st_t = st_v + (size_t)staged * 4 * dcf::kLanes;

  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks, rk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const dcf::BkLane tl = dcf::bk_lane(te, lane);
  const int nb = n / 8;
  const size_t rows = (size_t)n * 16;  // bytes of one key's cw_s / cw_v
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    long long group = u;
    int lo = 0, hi = m;
    if (u >= full) {  // a point slice of one of the last wave's groups
      const long long j = u - full;
      const int sl = (int)(j % slices);
      group = full + j / slices;
      lo = (int)((long long)m * sl / slices);
      hi = (int)((long long)m * (sl + 1) / slices);
    }
    const long long key = group * dcf::kLanes + lane;
    const size_t kc = (size_t)(key < k_num ? key : k_num - 1);
    __syncthreads();  // the tables are in; the last unit's words are done
    for (int e = threadIdx.x; e < staged * dcf::kLanes; e += blockDim.x) {
      const int l = e & 31;
      const long long kl = group * dcf::kLanes + l;
      const size_t kk = (size_t)(kl < k_num ? kl : k_num - 1);
      dcf::kl_stage_entry(st_s, st_v, cw_s + kk * rows, cw_v + kk * rows,
                          e >> 5, l);
    }
    for (int i = warp; i < staged; i += kWarps) {
      const uint32_t bits = dcf::kl_t_bits(cw_t + kc * n * 2, i);
      const uint32_t tl = __ballot_sync(0xFFFFFFFFu, bits & 1u);
      const uint32_t tr = __ballot_sync(0xFFFFFFFFu, bits & 2u);
      if (lane == 0) {
        st_t[2 * i] = tl;
        st_t[2 * i + 1] = tr;
      }
    }
    __syncthreads();
    uint32_t seed[4], np1[4];
    dcf::load16(s0s + kc * 32 + b * 16, seed);
    dcf::load16(cw_np1 + kc * 16, np1);
    const dcf::KlCw cw = {st_s, st_v, st_t, staged, cw_s + kc * rows,
                          cw_v + kc * rows, cw_t + kc * n * 2};
    for (int pt = lo + 2 * warp; pt < hi; pt += 2 * kWarps) {
      const int p1 = pt + 1 < hi ? pt + 1 : pt;  // an odd last point twice
      uint32_t y0[4], y1[4];
      dcf::keylanes_lane_pair(tl, rks, cw, n, lane, seed, np1,
                              xs + (size_t)pt * nb, xs + (size_t)p1 * nb,
                              (uint32_t)b, y0, y1);
      if (key >= k_num) continue;
      uint4* yk = reinterpret_cast<uint4*>(y) + kc * m;
      yk[pt] = make_uint4(y0[0], y0[1], y0[2], y0[3]);
      if (p1 != pt) yk[p1] = make_uint4(y1[0], y1[1], y1[2], y1[3]);
    }
  }
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  s0s [K, 2, 16] (both parties), cw_s / cw_v
// [K, n, 16], cw_t [K, n, 2], cw_np1 [K, 16], xs [m, n/8] shared by all
// keys; y [K, m, 16].  s0s, cw_s, cw_v, cw_np1 and y are 16-byte aligned.
extern "C" int dcf_keylanes_eval(const void* sbox, const void* rk,
                                 const void* s0s, const void* cw_s,
                                 const void* cw_v, const void* cw_t,
                                 const void* cw_np1, const void* xs, void* y,
                                 long long k_num, int n, int m, int b,
                                 void* stream) {
  if (k_num < 1 || m < 1) return (int)cudaSuccess;
  const int staged = n < kMaxStaged ? n : kMaxStaged;
  const size_t smem = sizeof(uint32_t) * dcf::kBankedWords +
                      sizeof(dcf::RoundKey) * 16 +
                      (size_t)staged * (2 * 4 * dcf::kLanes + 2) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      keylanes_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, keylanes_eval_kernel, kBlock, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // Work units: whole groups of 32 keys while they fill whole waves of the
  // grid, then each remaining group cut into `slices` point ranges so that
  // the last wave spreads over the grid.
  const long long groups = (k_num + dcf::kLanes - 1) / dcf::kLanes;
  const long long rest = groups % blocks;
  const long long full = groups - rest;
  long long slices = rest ? blocks / rest : 1;
  if (slices > m) slices = m;
  const long long units = full + rest * slices;
  const long long grid = units < blocks ? units : blocks;
  keylanes_eval_kernel<<<(unsigned)grid, kBlock, smem,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)s0s,
      (const uint8_t*)cw_s, (const uint8_t*)cw_v, (const uint8_t*)cw_t,
      (const uint8_t*)cw_np1, (const uint8_t*)xs, (uint8_t*)y, k_num, n, m,
      b, staged, full, (int)slices, units);
  return (int)cudaGetLastError();
}
