// Kernel B2: one breadth-first level of the GGM tree, lam = 16.
//
// Replaces dcf_tpu/ops/pallas_tree.py::_expand_level (its _expand_kernel),
// which expands a tile of parent nodes packed 32 per int32 lane word.  The
// prefix backend launches it once per level, k0..k-1, to build the
// frontier that kernel B3 gathers from, and the full-domain evaluator once
// per level k0..n-2.  Its last level, n-1, is the second kernel here (B2f):
// it replaces the leaf finalize of tree_expand_device in the same file,
// y = v ^ s ^ t * cw_np1 (XOR group), and writes only the 16-byte leaf
// shares, so the leaf level's s, v and t (33 bytes a leaf) are never
// written and read back.
//
// Bound on the H100: operations, the shared-memory AES lookups (2 blocks x
// 14 rounds x 16 per parent).  The bytes per parent (33 in, 66 out) are
// small beside 448 lookups.  Design: one thread per parent node, its
// (s, v, t) in registers; the level's correction word is read once per
// block into shared memory.  The outputs keep the TPU kernel's order: the
// left children fill positions [0, N) and the right children [N, 2N), so
// the leaves of a multi-level expansion come out in bitreverse order.

#include <cuda_runtime.h>

#include "dcf_walk.cuh"

namespace {

template <int GW>
__global__ void __launch_bounds__(dcf::kThreads)
    tree_expand_kernel(const uint8_t* __restrict__ sbox,
                       const uint8_t* __restrict__ rk,
                       const uint8_t* __restrict__ cw_s,
                       const uint8_t* __restrict__ cw_v,
                       const uint8_t* __restrict__ cw_t,
                       const uint8_t* __restrict__ s_in,
                       const uint8_t* __restrict__ v_in,
                       const uint8_t* __restrict__ t_in,
                       uint8_t* __restrict__ s_out,
                       uint8_t* __restrict__ v_out,
                       uint8_t* __restrict__ t_out, int n_par) {
  __shared__ dcf::AesTables aes;
  __shared__ dcf::LevelCw cw[1];
  dcf::fill_aes_tables(aes, sbox, rk);
  if (threadIdx.x == 0) dcf::level_cw_entry(cw, cw_s, cw_v, cw_t, 0);
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_par) return;
  const uint4 si = reinterpret_cast<const uint4*>(s_in)[j];
  const uint4 vi = reinterpret_cast<const uint4*>(v_in)[j];
  const uint32_t s[4] = {si.x, si.y, si.z, si.w};
  const uint32_t v[4] = {vi.x, vi.y, vi.z, vi.w};
  uint32_t sl[4], vl[4], sr[4], vr[4], tl, tr;
  dcf::tree_node<GW>(aes, cw[0], s, v, t_in[j] & 1u, sl, vl, tl, sr, vr, tr);
  uint4* so = reinterpret_cast<uint4*>(s_out);
  uint4* vo = reinterpret_cast<uint4*>(v_out);
  so[j] = make_uint4(sl[0], sl[1], sl[2], sl[3]);
  so[n_par + j] = make_uint4(sr[0], sr[1], sr[2], sr[3]);
  vo[j] = make_uint4(vl[0], vl[1], vl[2], vl[3]);
  vo[n_par + j] = make_uint4(vr[0], vr[1], vr[2], vr[3]);
  t_out[j] = (uint8_t)tl;
  t_out[n_par + j] = (uint8_t)tr;
}

__global__ void __launch_bounds__(dcf::kThreads)
    tree_expand_final_kernel(const uint8_t* __restrict__ sbox,
                             const uint8_t* __restrict__ rk,
                             const uint8_t* __restrict__ cw_s,
                             const uint8_t* __restrict__ cw_v,
                             const uint8_t* __restrict__ cw_t,
                             const uint8_t* __restrict__ cw_np1,
                             const uint8_t* __restrict__ s_in,
                             const uint8_t* __restrict__ v_in,
                             const uint8_t* __restrict__ t_in,
                             uint8_t* __restrict__ y_out, int n_par) {
  __shared__ dcf::AesTables aes;
  __shared__ dcf::LevelCw cw[1];
  __shared__ uint32_t np1[4];
  dcf::fill_aes_tables(aes, sbox, rk);
  if (threadIdx.x == 0) dcf::level_cw_entry(cw, cw_s, cw_v, cw_t, 0);
  if (threadIdx.x < 4) np1[threadIdx.x] = dcf::le32(cw_np1 + 4 * threadIdx.x);
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_par) return;
  const uint4 si = reinterpret_cast<const uint4*>(s_in)[j];
  const uint4 vi = reinterpret_cast<const uint4*>(v_in)[j];
  const uint32_t s[4] = {si.x, si.y, si.z, si.w};
  const uint32_t v[4] = {vi.x, vi.y, vi.z, vi.w};
  uint32_t yl[4], yr[4];
  dcf::tree_leaves(aes, cw[0], np1, s, v, t_in[j] & 1u, yl, yr);
  uint4* yo = reinterpret_cast<uint4*>(y_out);
  yo[j] = make_uint4(yl[0], yl[1], yl[2], yl[3]);
  yo[(size_t)n_par + j] = make_uint4(yr[0], yr[1], yr[2], yr[3]);
}

template <int GW>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, const uint8_t* s_in,
                   const uint8_t* v_in, const uint8_t* t_in, uint8_t* s_out,
                   uint8_t* v_out, uint8_t* t_out, int n_par,
                   cudaStream_t stream) {
  const int blocks = (n_par + dcf::kThreads - 1) / dcf::kThreads;
  tree_expand_kernel<GW><<<blocks, dcf::kThreads, 0, stream>>>(
      sbox, rk, cw_s, cw_v, cw_t, s_in, v_in, t_in, s_out, v_out, t_out,
      n_par);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  cw_s/cw_v point at this level's
// 16-byte correction words, cw_t at its two t bits.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dcf_tree_expand_level(const void* sbox, const void* rk,
                                     const void* cw_s, const void* cw_v,
                                     const void* cw_t, const void* s_in,
                                     const void* v_in, const void* t_in,
                                     void* s_out, void* v_out, void* t_out,
                                     int n_par, int gw, void* stream) {
#define DCF_ARGS                                                             \
  (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)cw_s,            \
      (const uint8_t*)cw_v, (const uint8_t*)cw_t, (const uint8_t*)s_in,      \
      (const uint8_t*)v_in, (const uint8_t*)t_in, (uint8_t*)s_out,           \
      (uint8_t*)v_out, (uint8_t*)t_out, n_par, (cudaStream_t)stream
  switch (gw) {
    case 0: return (int)launch<0>(DCF_ARGS);
    case 8: return (int)launch<8>(DCF_ARGS);
    case 16: return (int)launch<16>(DCF_ARGS);
    case 32: return (int)launch<32>(DCF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCF_ARGS
}

// C entry point of the last level (B2f), XOR group: cw_s/cw_v/cw_t point
// at level n-1's correction words, cw_np1 at the 16-byte leaf correction;
// y_out [2 * n_par, 16] gets the leaf shares, lefts then rights.
extern "C" int dcf_tree_expand_final(const void* sbox, const void* rk,
                                     const void* cw_s, const void* cw_v,
                                     const void* cw_t, const void* cw_np1,
                                     const void* s_in, const void* v_in,
                                     const void* t_in, void* y_out,
                                     int n_par, void* stream) {
  const int blocks = (n_par + dcf::kThreads - 1) / dcf::kThreads;
  tree_expand_final_kernel<<<blocks, dcf::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk, (const uint8_t*)cw_s,
      (const uint8_t*)cw_v, (const uint8_t*)cw_t, (const uint8_t*)cw_np1,
      (const uint8_t*)s_in, (const uint8_t*)v_in, (const uint8_t*)t_in,
      (uint8_t*)y_out, n_par);
  return (int)cudaGetLastError();
}
