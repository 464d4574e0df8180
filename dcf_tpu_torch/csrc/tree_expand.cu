// Kernel B2: breadth-first levels of the GGM tree, lam = 16, one to three
// levels a launch; and B2f, the last level with the leaf finalize.
//
// B2 replaces dcf_tpu/ops/pallas_tree.py::_expand_level (its
// _expand_kernel), which expands a tile of parent nodes packed 32 per int32
// lane word, one level a call (tree_expand_raw repeats it).  The prefix
// backend runs it over levels k0..k-1 to build the frontier that kernel B3
// gathers from, and the full-domain evaluator over levels k0..n-2.  A
// launch of D levels turns N parents (s, v, t) into the 2^D N nodes of
// level + D, stored as D one-level launches would leave them: per level
// the left children in [0, N) and the right in [N, 2N), so the node of
// parent j reached by the directions r (LSB first) lands at j + N r, and
// the leaves of a multi-level expansion come out in bitreverse order.
//
// Bound on the H100: operations, the AES lookups a parent needs (E(s) and
// E(~s), 2 x 14 rounds x 16); its bytes (33 in, 66 out) are small beside
// 448 lookups.  The first design (one thread a parent on the 1 KB T-tables
// of dcf_walk.cuh, one level a launch) reached 11-19% of that bound: the
// tables put about 3.3 lanes' lookups into one bank, every level was
// written and read back, and the prefix path's 15 small launches cost more
// host time than the card took.  This design is kernel B6's
// (evalall_expand.cu) carried to the lam = 16 node:
//
//   - the banked AES of aes_banked.cuh (one wavefront a warp's lookups),
//     E(s) and E(~s) in lockstep (tree_node_banked); every lane expands
//     its parent fully, so a warp's lanes do the same work;
//   - a persistent grid: 512-thread blocks fill the 64 KB table, the 15
//     round keys and the launch's D correction words once, then stride over
//     the launch's parents;
//   - up to three levels a launch in registers (tree_subtree<GW, D>): the
//     levels between are neither written nor read back.  The ops wrapper
//     cuts a tree's levels into such launches, the deepest last
//     (ops._launch.launch_depths): the prefix path's levels 6..20
//     in five launches, and so the full domain's above B2f's launch.
//
// B2f replaces the leaf finalize of tree_expand_device in the same file,
// y = v ^ s ^ t * cw_np1 (XOR group), and writes only the 16-byte leaf
// shares, so the leaf level's s, v and t (33 bytes a leaf) are never
// written and read back.  Its first design ran one thread a parent on the
// T-tables of dcf_walk.cuh (tree_leaves) at 31% of its bound (NVIDIA H100
// 80GB HBM3, 700 W power limit, chip_smoke.py).  It is now this kernel's
// FINAL instantiation: the same banked node, persistent grid and
// correction words in shared memory, with cw_np1 there too, and the leaf
// finalize as the terminal case of tree_subtree, which stores y alone.  A
// FINAL launch may also take the levels above the leaves (up to three in
// all), so that the last parents of the tree stay in registers: the full
// domain's takes three (ops.tree_expand.FINAL_LEVELS; at n = 24 levels
// 21-23 from 2^21 parents), so the 2^23 parents of the last level, 33
// bytes each, are neither written nor read back.

#include <cuda_runtime.h>

#include "aes_banked.cuh"

namespace {

constexpr int kBlock = 512;
// Shared layout: the banked table, then the round keys (16 rows; every
// lane reads the same row, a broadcast).
constexpr size_t kSmem =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * 16;

// Levels level .. level + D - 1 of one key: cw_s / cw_v / cw_t point at
// level's correction words.  FINAL: the last of them is the tree's, and
// s_out gets the leaf shares (cw_np1 applied; v_out, t_out unused).
template <int GW, int D, bool FINAL = false>
__global__ void __launch_bounds__(kBlock, 1)
    tree_expand_kernel(const uint8_t* __restrict__ sbox,
                       const uint8_t* __restrict__ rk,
                       const uint8_t* __restrict__ cw_s,
                       const uint8_t* __restrict__ cw_v,
                       const uint8_t* __restrict__ cw_t,
                       const uint8_t* __restrict__ cw_np1,
                       const uint8_t* __restrict__ s_in,
                       const uint8_t* __restrict__ v_in,
                       const uint8_t* __restrict__ t_in,
                       uint8_t* __restrict__ s_out,
                       uint8_t* __restrict__ v_out,
                       uint8_t* __restrict__ t_out, long long n_par) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ dcf::LevelCw cw[D];
  __shared__ uint32_t np1[4];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks, rk);
  if (threadIdx.x < D)
    dcf::level_cw_entry(cw, cw_s, cw_v, cw_t, (int)threadIdx.x);
  if (FINAL && threadIdx.x < 4)
    np1[threadIdx.x] = dcf::le32(cw_np1 + 4 * threadIdx.x);
  __syncthreads();

  const dcf::BkLane lane = dcf::bk_lane(te, threadIdx.x & 31);
  const long long stride = (long long)gridDim.x * kBlock;
  for (long long j = (long long)blockIdx.x * kBlock + threadIdx.x; j < n_par;
       j += stride) {
    dcf::TreeNode p;
    dcf::load16(s_in + 16 * j, p.s);
    dcf::load16(v_in + 16 * j, p.v);
    p.t = t_in[j] & 1u;
    dcf::tree_subtree<GW, D, FINAL>(lane, rks, cw, p, s_out, v_out, t_out,
                                    (size_t)j, (size_t)n_par, np1);
  }
}

template <int GW, int D, bool FINAL>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, const uint8_t* cw_np1,
                   const uint8_t* s_in, const uint8_t* v_in,
                   const uint8_t* t_in, uint8_t* s_out, uint8_t* v_out,
                   uint8_t* t_out, int n_par, cudaStream_t stream) {
  auto kernel = tree_expand_kernel<GW, D, FINAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                    kSmem);
  if (e != cudaSuccess) return e;
  const long long need = ((long long)n_par + kBlock - 1) / kBlock;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(need < most ? need : most), kBlock, kSmem, stream>>>(
      sbox, rk, cw_s, cw_v, cw_t, cw_np1, s_in, v_in, t_in, s_out, v_out,
      t_out, n_par);
  return cudaGetLastError();
}

template <int GW, bool FINAL>
cudaError_t launch_depth(int depth, const uint8_t* sbox, const uint8_t* rk,
                         const uint8_t* cw_s, const uint8_t* cw_v,
                         const uint8_t* cw_t, const uint8_t* cw_np1,
                         const uint8_t* s_in, const uint8_t* v_in,
                         const uint8_t* t_in, uint8_t* s_out, uint8_t* v_out,
                         uint8_t* t_out, int n_par, cudaStream_t stream) {
#define DCF_ARGS                                                             \
  sbox, rk, cw_s, cw_v, cw_t, cw_np1, s_in, v_in, t_in, s_out, v_out, t_out, \
      n_par, stream
  switch (depth) {
    case 1: return launch<GW, 1, FINAL>(DCF_ARGS);
    case 2: return launch<GW, 2, FINAL>(DCF_ARGS);
    case 3: return launch<GW, 3, FINAL>(DCF_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}

}  // namespace

// C entry point of B2, bound through ctypes: levels level .. level +
// depth - 1 (depth 1-3) of one key from n_par parents.  cw_s/cw_v point at
// the first level's 16-byte correction words, the next levels' following
// (rows of 16), cw_t at its two t bits (rows of 2); s_out/v_out
// [2^depth n_par, 16], t_out [2^depth n_par].  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int dcf_tree_expand_levels(const void* sbox, const void* rk,
                                      const void* cw_s, const void* cw_v,
                                      const void* cw_t, const void* s_in,
                                      const void* v_in, const void* t_in,
                                      void* s_out, void* v_out, void* t_out,
                                      int n_par, int gw, int depth,
                                      void* stream) {
  if (n_par < 1) return (int)cudaErrorInvalidValue;
#define DCF_ARGS                                                             \
  depth, (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)cw_s,     \
      (const uint8_t*)cw_v, (const uint8_t*)cw_t, nullptr,                   \
      (const uint8_t*)s_in, (const uint8_t*)v_in, (const uint8_t*)t_in,      \
      (uint8_t*)s_out, (uint8_t*)v_out, (uint8_t*)t_out, n_par,              \
      (cudaStream_t)stream
  switch (gw) {
    case 0: return (int)launch_depth<0, false>(DCF_ARGS);
    case 8: return (int)launch_depth<8, false>(DCF_ARGS);
    case 16: return (int)launch_depth<16, false>(DCF_ARGS);
    case 32: return (int)launch_depth<32, false>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}

// C entry point of B2f, XOR group: levels level .. level + depth - 1
// (depth 1-3), the last of them the tree's, from n_par parents.  cw_s /
// cw_v / cw_t as for B2, cw_np1 the 16-byte leaf correction; y_out
// [2^depth n_par, 16] gets the leaf shares, in the rows B2's launches
// and a last level would leave them (lefts then rights a level).
extern "C" int dcf_tree_expand_final_levels(
    const void* sbox, const void* rk, const void* cw_s, const void* cw_v,
    const void* cw_t, const void* cw_np1, const void* s_in, const void* v_in,
    const void* t_in, void* y_out, int n_par, int depth, void* stream) {
  if (n_par < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_depth<0, true>(
      depth, (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)cw_s,
      (const uint8_t*)cw_v, (const uint8_t*)cw_t, (const uint8_t*)cw_np1,
      (const uint8_t*)s_in, (const uint8_t*)v_in, (const uint8_t*)t_in,
      (uint8_t*)y_out, nullptr, nullptr, n_par, (cudaStream_t)stream);
}
