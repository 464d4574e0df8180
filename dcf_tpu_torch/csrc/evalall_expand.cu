// Kernel B6: breadth-first levels of the DPF tree at lam = 32, K keys.
//
// Replaces dcf_tpu/ops/pallas_evalall.py::_expand_level (its
// _expand_kernel) and, on the last level, the leaf finalize of
// dpf_tree_expand_device.  The TPU kernel expands tiles of parent nodes
// packed 32 per int32 lane word in bit-major planes and computes all four
// encryptions of the narrow Hirose step.  Here one thread owns one parent
// node of one key as eight uint32 words (narrow_walk.cuh::dpf_subtree).
//
// Layout: parents s [K, N, 32], t [K, N]; children s [K, 2N, 32],
// t [K, 2N], per key the lefts in [0, N) and the rights in [N, 2N), so the
// leaves of a multi-level expansion come out in bitreverse order, as from
// kernel B2 (a launch of D levels leaves [K, 2^D N] in that order).  The FINAL instantiation writes the leaf shares
// y = s ^ t * cw_np1 instead of the children's seeds, which saves writing
// and reading back 2N x 32 bytes per key.
//
// Bound on the H100: operations, the shared-memory table lookups a parent
// needs: E0(s_b0) and E17(s_b1) in full and E0(~s_b0) to its t bit (224 +
// 224 + 197), ahead of the bytes (33 in, 66 out per parent).  The first
// design (three full blocks on the four 1 KB T-tables of dcf_walk.cuh, a
// 256-thread block per 256 parents) reached 35% of that bound (NVIDIA H100
// 80GB HBM3, 700 W power limit, chip_smoke.py): the tables put about 3.3
// lanes' lookups into one bank.  This design:
//
//   - the banked AES of aes_banked.cuh (one wavefront a warp's lookups),
//     the parent's two full blocks and the t bit in lockstep
//     (dpf_node_banked); a full-domain level turns every lane the same
//     way, so every lane of every warp does the same work and no vote is
//     needed;
//   - a persistent grid: 512-thread blocks (one an SM at up to 128
//     registers, two at up to 64) fill the 64 KB table and both ciphers'
//     round keys once, then stride over the launch's K x N parents; a
//     thread keeps its key's correction words (and leaf correction) in
//     registers and reloads them only when the key changes;
//   - up to three levels a launch (dpf_subtree<D>): a thread expands its
//     parent D levels deep in registers and writes the 2^D nodes of the
//     last straight to their rows, so the levels between are neither
//     written nor read back.  One level a launch wrote and read back
//     every level: 6.6 GB at n = 24, K = 4 from level 6, against 2.8 GB
//     at three (chip_smoke.py, phase 12).  The ops wrapper cuts a tree
//     into such launches, the deepest last (launch_depths);
//   - the last launch may store the leaves' t bits alone (Y false, a PIR
//     selection), packed 32 a word as kernel P1 reads them: a thread keeps
//     its parent's 2^D leaf bits in a register, then a warp's 32
//     consecutive parents give one word a direction through a ballot,
//     which lane r stores (an atomicOr a set bit where a key's parents are
//     not a multiple of 32).  A ballot and a store at each leaf inside the
//     recursion instead cost the launch 10% (NVIDIA H100 80GB HBM3, 700 W,
//     PERF.md).  Nothing then reads block 1 of a node
//     inside the launch, and the compiler drops cipher 17: a parent costs
//     E0(s_b0) and the t bit of E0(~s_b0), and one on the last level the
//     two t bits (at n = 24, K = 4, the last launch 3.3 ms against 5.4
//     with y, NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// Offsets are 64-bit (K * 2N * 32 reaches 2^31 at n = 24, K = 4).

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

constexpr int kBlock = 512;
// Shared layout: the banked table, then cipher 0's and cipher 17's round
// keys (16 rows each; every lane reads the same row, a broadcast).
constexpr size_t kSmem =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * 32;

// D levels a launch (D = 1: one level), FINAL: the last one of the tree,
// Y: s_out is written (else only t_out, on a FINAL launch, as packed
// words: WW where the parents of a key are a multiple of 32, a ballot a
// word; else an atomicOr a set bit).
template <int D, bool FINAL, bool Y, bool WW = false>
__global__ void __launch_bounds__(kBlock, 1)
    evalall_expand_kernel(const uint8_t* __restrict__ sbox,
                          const uint8_t* __restrict__ rk0,
                          const uint8_t* __restrict__ rk17,
                          const uint8_t* __restrict__ cw_s,
                          const uint8_t* __restrict__ cw_t,
                          const uint8_t* __restrict__ cw_np1,
                          const uint8_t* __restrict__ s_in,
                          const uint8_t* __restrict__ t_in,
                          uint8_t* __restrict__ s_out,
                          uint8_t* __restrict__ t_out, long long n_par,
                          int n, int level, long long total) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks0 =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  dcf::RoundKey* rks17 = rks0 + 16;
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks0, rk0);
  dcf::fill_round_keys(rks17, rk17);
  __syncthreads();

  const dcf::BkLane lane = dcf::bk_lane(te, threadIdx.x & 31);
  const long long stride = (long long)gridDim.x * kBlock;
  long long g = (long long)blockIdx.x * kBlock + threadIdx.x;
  long long key = g / n_par, j = g - key * n_par, cur = -1;
  dcf::DpfCw w[D];
  uint32_t np1[8];
  for (; g < total; g += stride, j += stride) {
    if (j >= n_par) {  // past the key's last parent
      key += j / n_par;
      j %= n_par;
    }
    if (key != cur) {
      cur = key;
      for (int l = 0; l < D; ++l) {
        const size_t row = (size_t)key * n + level + l;
        dcf::dpf_cw_entry(w[l], cw_s + row * 32, cw_t + row * 2);
      }
      if (FINAL)
        for (int q = 0; q < 8; ++q)
          np1[q] = dcf::le32(cw_np1 + key * 32 + 4 * q);
    }
    const uint4* si = reinterpret_cast<const uint4*>(s_in) + 2 * g;
    const uint4 lo = si[0], hi = si[1];
    const uint32_t s[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t out = (size_t)key * ((size_t)n_par << D);
    if constexpr (Y) {
      dcf::dpf_subtree<D, Y>(lane, rks0, rks17, w, FINAL ? np1 : nullptr, s,
                             t_in[g] & 1u, s_out + out * 32, t_out + out,
                             (size_t)j, (size_t)n_par);
    } else {
      // Bit r of tb: the leaf of directions r, at row j + N r of the key.
      uint32_t tb = 0u;
      dcf::dpf_subtree<D, Y>(lane, rks0, rks17, w, nullptr, s, t_in[g] & 1u,
                             nullptr, nullptr, 0, 1, &tb);
      uint32_t* const kw = reinterpret_cast<uint32_t*>(t_out) +
                           (size_t)key * ((((size_t)n_par << D) + 31) >> 5);
      if constexpr (WW) {
        // The grid stride and a key's parents are multiples of 32, so the
        // warp's lanes hold 32 consecutive parents of one key from a
        // 32-aligned one: direction r's word is a ballot; lane r stores it.
        const int l = threadIdx.x & 31;
        uint32_t mine = 0u;
#pragma unroll
        for (int r = 0; r < (1 << D); ++r) {
          const uint32_t word = __ballot_sync(0xFFFFFFFFu, (tb >> r) & 1u);
          mine = l == r ? word : mine;
        }
        if (l < (1 << D))
          kw[((size_t)j - l + (size_t)n_par * l) >> 5] = mine;
      } else {
#pragma unroll
        for (int r = 0; r < (1 << D); ++r) {
          const size_t at = (size_t)j + (size_t)n_par * r;
          if ((tb >> r) & 1u) atomicOr(kw + (at >> 5), 1u << (at & 31));
        }
      }
    }
  }
}

template <int D, bool FINAL, bool Y, bool WW = false>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk0,
                   const uint8_t* rk17, const uint8_t* cw_s,
                   const uint8_t* cw_t, const uint8_t* cw_np1,
                   const uint8_t* s_in, const uint8_t* t_in, uint8_t* s_out,
                   uint8_t* t_out, int k_num, int n_par, int n, int level,
                   cudaStream_t stream) {
  if (k_num < 1 || n_par < 1) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      evalall_expand_kernel<D, FINAL, Y, WW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, evalall_expand_kernel<D, FINAL, Y, WW>, kBlock, kSmem);
  if (e != cudaSuccess) return e;
  const long long total = (long long)k_num * n_par;
  const long long need = (total + kBlock - 1) / kBlock;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  evalall_expand_kernel<D, FINAL, Y, WW>
      <<<(unsigned)(need < most ? need : most), kBlock, kSmem, stream>>>(
          sbox, rk0, rk17, cw_s, cw_t, cw_np1, s_in, t_in, s_out, t_out,
          n_par, n, level, total);
  return cudaGetLastError();
}

// The instantiation for a launch: one level a launch and the levels
// between in registers; the last level's leaf shares, or its t alone.
template <int D>
cudaError_t launch_depth(bool final, bool y, const uint8_t* sbox,
                         const uint8_t* rk0, const uint8_t* rk17,
                         const uint8_t* cw_s, const uint8_t* cw_t,
                         const uint8_t* cw_np1, const uint8_t* s_in,
                         const uint8_t* t_in, uint8_t* s_out, uint8_t* t_out,
                         int k_num, int n_par, int n, int level,
                         cudaStream_t stream) {
#define DCF_ARGS                                                             \
  sbox, rk0, rk17, cw_s, cw_t, cw_np1, s_in, t_in, s_out, t_out, k_num,      \
      n_par, n, level, stream
  if (!final) return launch<D, false, true>(DCF_ARGS);
  if (y) return launch<D, true, true>(DCF_ARGS);
  if (n_par % 32 == 0) return launch<D, true, false, true>(DCF_ARGS);
  return launch<D, true, false, false>(DCF_ARGS);
#undef DCF_ARGS
}

}  // namespace

// C entry points, bound through ctypes.  cw_s [K, n, 32] and cw_t
// [K, n, 2] are the keys' whole correction-word arrays; final != 0 writes
// leaf shares (cw_np1 [K, 32] applied) into s_out, or, with s_out null,
// only the leaves' t bits (a PIR selection share) as packed words, t_out
// uint32 [K, ceil(2^depth N / 32)], zeroed by the caller unless N is a
// multiple of 32.  Levels level .. level+depth-1 (depth 1-3) in one
// launch: s_out [K, 2^depth N, 32], t_out [K, 2^depth N] as depth
// launches of one level would leave them.
// Each returns the cudaError_t of the launch (0 on success).
extern "C" int dcf_evalall_expand_levels(const void* sbox, const void* rk0,
                                         const void* rk17, const void* cw_s,
                                         const void* cw_t, const void* cw_np1,
                                         const void* s_in, const void* t_in,
                                         void* s_out, void* t_out, int k_num,
                                         int n_par, int n, int level,
                                         int depth, int final, void* stream) {
  const bool y = s_out != nullptr;
  if (!y && !final) return (int)cudaErrorInvalidValue;
#define DCF_ARGS                                                             \
  final != 0, y, (const uint8_t*)sbox, (const uint8_t*)rk0,                  \
      (const uint8_t*)rk17, (const uint8_t*)cw_s, (const uint8_t*)cw_t,      \
      (const uint8_t*)cw_np1, (const uint8_t*)s_in, (const uint8_t*)t_in,    \
      (uint8_t*)s_out, (uint8_t*)t_out, k_num, n_par, n, level,              \
      (cudaStream_t)stream
  switch (depth) {
    case 1: return (int)launch_depth<1>(DCF_ARGS);
    case 2: return (int)launch_depth<2>(DCF_ARGS);
    case 3: return (int)launch_depth<3>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}

// One level, `level`.
extern "C" int dcf_evalall_expand_level(const void* sbox, const void* rk0,
                                        const void* rk17, const void* cw_s,
                                        const void* cw_t, const void* cw_np1,
                                        const void* s_in, const void* t_in,
                                        void* s_out, void* t_out, int k_num,
                                        int n_par, int n, int level,
                                        int final, void* stream) {
  return dcf_evalall_expand_levels(sbox, rk0, rk17, cw_s, cw_t, cw_np1, s_in,
                                   t_in, s_out, t_out, k_num, n_par, n, level,
                                   1, final, stream);
}
