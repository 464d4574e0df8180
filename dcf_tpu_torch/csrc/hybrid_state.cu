// Kernel B5a: the narrow frontier build of the prefix-shared hybrid.
//
// Replaces dcf_tpu/ops/pallas_hybrid_prefix.py::narrow_state_walk_pallas
// (its _state_kernel).  The TPU kernel walks the bit planes of all 2^k node
// prefixes k levels and emits the raw carry planes plus a (k+1)-plane
// trajectory, which the host then transposes into 64-byte rows and packs
// into one word per node.  Here the frontier is built level by level, in
// place, in its final layout: rows [K * 2^k, 64] (s then v, 32 bytes each)
// and words [K * 2^k] (gate bits 0..k-1, the depth-k carry t at bit k).
// Each parent is expanded once, into both children
// (narrow_walk.cuh::frontier_subtree).
//
// Bound on the H100: operations, the shared-memory table lookups of the
// 2^k - 1 parents a key's build expands, each into both children: E0 and
// E17 on (s, ~s), four blocks of 14 rounds x 16 lookups.  The rows written
// are the bytes (68 a node).  It runs once per (key image, party), off the
// eval clock.  The first design (one thread a node, each walking its k
// levels from the root on the four 1 KB T-tables of dcf_walk.cuh)
// computed k x 2^k narrow steps where 2^k - 1 expansions suffice, with
// about 3.3 lanes' lookups in one bank: 1.8% of the bound at k = 20
// (NVIDIA H100 80GB HBM3, 700 W power limit, chip_smoke.py).  This design:
//
//   - each parent's four blocks in lockstep on the banked AES of
//     aes_banked.cuh (one wavefront a warp's lookups), every lane alike;
//   - the top levels, whose few parents leave a launch waiting on one
//     expansion's latency, in one launch, a level per __syncthreads, each
//     block a range of keys (the top kernel); the rest by launches of one
//     or two levels, the second kept in registers and the last level's
//     nodes written straight to their rows (a third level in registers
//     spilled and ran slower);
//   - a launch's blocks fill the 64 KB table and both ciphers' round keys
//     once and take its K x 2^level parents in a stride loop; where they
//     are fewer than the card's threads, blocks shrink so that every SM
//     takes a share; a thread reads its key's correction words from device
//     memory (one address for all of a key's lanes);
//   - one call launches the whole build, so the host pays one call.
//
// At k = 20 it builds a key's frontier in 0.34 ms, 33% of its bound
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): the levels above 17 or so
// wait on one expansion's latency each.

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

constexpr int kBlock = 512;
// Shared layout: the banked table, then cipher 0's and cipher 17's round
// keys (16 rows each; every lane reads the same row, a broadcast).
constexpr size_t kSmem =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * 32;

struct Tables {
  dcf::BkLane lane;
  const dcf::RoundKey* rk0;
  const dcf::RoundKey* rk17;
};

__device__ __forceinline__ Tables fill_tables(const uint8_t* sbox,
                                              const uint8_t* rk0,
                                              const uint8_t* rk17) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks0 =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks0, rk0);
  dcf::fill_round_keys(rks0 + 16, rk17);
  __syncthreads();
  return {dcf::bk_lane(te, threadIdx.x & 31), rks0, rks0 + 16};
}

// Levels 0 .. top - 1 from the root (the party's seed, t = b), a level at
// a time: block x takes keys [x * per, (x + 1) * per) and its threads
// their parents of a level in a stride loop.
__global__ void __launch_bounds__(kBlock, 1)
    hybrid_state_top_kernel(const uint8_t* __restrict__ sbox,
                            const uint8_t* __restrict__ rk0,
                            const uint8_t* __restrict__ rk17,
                            const uint8_t* __restrict__ s0,
                            const uint8_t* __restrict__ cw_s,
                            const uint8_t* __restrict__ cw_v,
                            const uint8_t* __restrict__ cw_t, uint8_t* rows,
                            uint32_t* words, int n, int k, int top, int b,
                            long long k_num, long long per) {
  const Tables tab = fill_tables(sbox, rk0, rk17);
  const long long first = blockIdx.x * per;
  const long long keys = k_num - first < per ? k_num - first : per;
  for (int i = 0; i < top; ++i) {
    for (long long g = threadIdx.x; g < (keys << i); g += kBlock) {
      const size_t key = (size_t)(first + (g >> i));
      const size_t j = (size_t)(g & ((1LL << i) - 1));
      uint8_t* kr = rows + (key << k) * 64;
      uint32_t* kw = words + (key << k);
      dcf::FrontierNode p;
      if (i == 0) {
        dcf::load16(s0 + key * 32, p.s);
        dcf::load16(s0 + key * 32 + 16, p.s + 4);
        for (int q = 0; q < 8; ++q) p.v[q] = 0u;
        p.word = (uint32_t)b;
      } else {
        dcf::frontier_load(p, kr, kw, j);
      }
      dcf::frontier_subtree<1>(tab.lane, tab.rk0, tab.rk17,
                               cw_s + key * n * 32, cw_v + key * n * 32,
                               cw_t + key * n * 2, i, p, kr, kw, j,
                               (size_t)1 << i);
    }
    __syncthreads();  // level i + 1 reads what level i wrote
  }
}

// Levels level .. level + D - 1 (level >= 1) of every key, one thread a
// parent.
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
    hybrid_state_kernel(const uint8_t* __restrict__ sbox,
                        const uint8_t* __restrict__ rk0,
                        const uint8_t* __restrict__ rk17,
                        const uint8_t* __restrict__ cw_s,
                        const uint8_t* __restrict__ cw_v,
                        const uint8_t* __restrict__ cw_t, uint8_t* rows,
                        uint32_t* words, int n, int k, int level,
                        long long total) {
  const Tables tab = fill_tables(sbox, rk0, rk17);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n_par = 1LL << level;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < total; g += stride) {
    const size_t key = (size_t)(g >> level), j = (size_t)(g & (n_par - 1));
    uint8_t* kr = rows + (key << k) * 64;
    uint32_t* kw = words + (key << k);
    dcf::FrontierNode p;
    dcf::frontier_load(p, kr, kw, j);
    dcf::frontier_subtree<D>(tab.lane, tab.rk0, tab.rk17, cw_s + key * n * 32,
                             cw_v + key * n * 32, cw_t + key * n * 2, level,
                             p, kr, kw, j, (size_t)n_par);
  }
}

// Sets the kernel's shared-memory size and returns the card's SM count.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int& sms) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int D>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk0,
                   const uint8_t* rk17, const uint8_t* cw_s,
                   const uint8_t* cw_v, const uint8_t* cw_t, uint8_t* rows,
                   uint32_t* words, long long k_num, int n, int k, int level,
                   cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaError_t e = prepare(hybrid_state_kernel<D>, sms);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hybrid_state_kernel<D>, kBlock, kSmem);
  if (e != cudaSuccess) return e;
  // Fewer parents than full blocks on every SM: smaller blocks (whole
  // warps), one an SM.
  const long long total = k_num << level;
  long long bs = ((total + sms - 1) / sms + 31) / 32 * 32;
  if (bs > kBlock) bs = kBlock;
  const long long need = (total + bs - 1) / bs;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  hybrid_state_kernel<D>
      <<<(unsigned)(need < most ? need : most), (unsigned)bs, kSmem, stream>>>(
          sbox, rk0, rk17, cw_s, cw_v, cw_t, rows, words, n, k, level, total);
  return cudaGetLastError();
}

cudaError_t launch_top(const uint8_t* sbox, const uint8_t* rk0,
                       const uint8_t* rk17, const uint8_t* s0,
                       const uint8_t* cw_s, const uint8_t* cw_v,
                       const uint8_t* cw_t, uint8_t* rows, uint32_t* words,
                       long long k_num, int n, int k, int top, int b,
                       cudaStream_t stream) {
  int sms = 0;
  cudaError_t e = prepare(hybrid_state_top_kernel, sms);
  if (e != cudaSuccess) return e;
  const long long per = (k_num + sms - 1) / sms;  // keys a block
  hybrid_state_top_kernel<<<(unsigned)((k_num + per - 1) / per), kBlock,
                            kSmem, stream>>>(sbox, rk0, rk17, s0, cw_s, cw_v,
                                             cw_t, rows, words, n, k, top, b,
                                             k_num, per);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes: party b's frontier of K keys at
// depth k, in place: levels 0 .. top - 1 (top >= 1) by the top kernel,
// then n_launch launches of depths[i] levels each (1 or 2; top plus their
// sum is k).  s0 [K, 32]; cw_s / cw_v [K, n, 32], cw_t [K, n, 2]; rows
// [K * 2^k, 64], words [K * 2^k] (uint32), key j's nodes from row j * 2^k.
// s0, cw_s, cw_v and rows are 16-byte aligned.  Returns the cudaError_t of
// the first launch that fails (0 on success).
extern "C" int dcf_hybrid_state(const void* sbox, const void* rk0,
                                const void* rk17, const void* s0,
                                const void* cw_s, const void* cw_v,
                                const void* cw_t, void* rows, void* words,
                                long long k_num, int n, int k, int top,
                                const int* depths, int n_launch, int b,
                                void* stream) {
  if (k_num < 1) return (int)cudaSuccess;
  int level = top;
  for (int i = 0; i < n_launch; ++i) level += depths[i];
  if (top < 1 || level != k) return (int)cudaErrorInvalidValue;
  const uint8_t* sb = (const uint8_t*)sbox;
  const uint8_t* k0 = (const uint8_t*)rk0;
  const uint8_t* k17 = (const uint8_t*)rk17;
  const uint8_t* cs = (const uint8_t*)cw_s;
  const uint8_t* cv = (const uint8_t*)cw_v;
  const uint8_t* ct = (const uint8_t*)cw_t;
  uint8_t* r = (uint8_t*)rows;
  uint32_t* w = (uint32_t*)words;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_top(sb, k0, k17, (const uint8_t*)s0, cs, cv, ct, r,
                             w, k_num, n, k, top, b, st);
  level = top;
  for (int i = 0; i < n_launch && e == cudaSuccess; ++i) {
    if (depths[i] == 1)
      e = launch<1>(sb, k0, k17, cs, cv, ct, r, w, k_num, n, k, level, st);
    else if (depths[i] == 2)
      e = launch<2>(sb, k0, k17, cs, cv, ct, r, w, k_num, n, k, level, st);
    else
      e = cudaErrorInvalidValue;
    level += depths[i];
  }
  return (int)e;
}
