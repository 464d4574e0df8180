// Kernel B6: one breadth-first level of the DPF tree at lam = 32, K keys.
//
// Replaces dcf_tpu/ops/pallas_evalall.py::_expand_level (its
// _expand_kernel) and, on the last level, the leaf finalize of
// dpf_tree_expand_device.  The TPU kernel expands tiles of parent nodes
// packed 32 per int32 lane word in bit-major planes and computes all four
// encryptions of the narrow Hirose step.  Here one thread owns one parent
// node of one key as eight uint32 words and runs the three T-table AES
// blocks a DPF needs in lockstep (narrow_walk.cuh::dpf_node).
//
// Layout: parents s [K, N, 32], t [K, N]; children s [K, 2N, 32],
// t [K, 2N], per key the lefts in [0, N) and the rights in [N, 2N), so the
// leaves of a multi-level expansion come out in bitreverse order, as from
// kernel B2.  The FINAL instantiation writes the leaf shares
// y = s ^ t * cw_np1 instead of the children's seeds, which saves writing
// and reading back 2N x 32 bytes per key.
//
// Bound on the H100: operations, the shared-memory table lookups (3 blocks
// x 14 rounds x 16 per parent) ahead of the bytes (33 in, 66 out per
// parent).  Design: as B2; the level's per-key correction word is read once
// per block into shared memory (grid: parent blocks x keys), and offsets
// are 64-bit (K * 2N * 32 reaches 2^31 at n = 24, K = 4).

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

template <bool FINAL>
__global__ void __launch_bounds__(dcf::kThreads)
    evalall_expand_kernel(const uint8_t* __restrict__ sbox,
                          const uint8_t* __restrict__ rk0,
                          const uint8_t* __restrict__ rk17,
                          const uint8_t* __restrict__ cw_s,
                          const uint8_t* __restrict__ cw_t,
                          const uint8_t* __restrict__ cw_np1,
                          const uint8_t* __restrict__ s_in,
                          const uint8_t* __restrict__ t_in,
                          uint8_t* __restrict__ s_out,
                          uint8_t* __restrict__ t_out, int n_par, int n,
                          int level) {
  __shared__ dcf::NarrowTables tab;
  __shared__ dcf::DpfCw cw;
  __shared__ uint32_t np1[8];

  const size_t key = blockIdx.y;
  dcf::fill_narrow_tables(tab, sbox, rk0, rk17);
  if (threadIdx.x == 0)
    dcf::dpf_cw_entry(cw, cw_s + (key * n + level) * 32,
                      cw_t + (key * n + level) * 2);
  if (FINAL && threadIdx.x < 8)
    np1[threadIdx.x] = dcf::le32(cw_np1 + key * 32 + 4 * threadIdx.x);
  __syncthreads();

  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (size_t)n_par) return;
  const size_t in = key * n_par + j;
  const uint4* si = reinterpret_cast<const uint4*>(s_in) + 2 * in;
  const uint4 lo = si[0], hi = si[1];
  const uint32_t s[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t sl[8], sr[8], tl, tr;
  dcf::dpf_node(tab, cw, s, t_in[in] & 1u, sl, tl, sr, tr);
  if (FINAL) {
    dcf::dpf_leaf(sl, tl, np1);
    dcf::dpf_leaf(sr, tr, np1);
  }
  const size_t left = key * 2 * n_par + j;
  const size_t right = left + n_par;
  uint4* so = reinterpret_cast<uint4*>(s_out);
  so[2 * left] = make_uint4(sl[0], sl[1], sl[2], sl[3]);
  so[2 * left + 1] = make_uint4(sl[4], sl[5], sl[6], sl[7]);
  so[2 * right] = make_uint4(sr[0], sr[1], sr[2], sr[3]);
  so[2 * right + 1] = make_uint4(sr[4], sr[5], sr[6], sr[7]);
  t_out[left] = (uint8_t)tl;
  t_out[right] = (uint8_t)tr;
}

}  // namespace

// C entry point, bound through ctypes.  cw_s [K, n, 32] and cw_t [K, n, 2]
// are the keys' whole correction-word arrays, `level` the level to expand;
// final != 0 writes leaf shares (cw_np1 [K, 32] applied) into s_out.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcf_evalall_expand_level(const void* sbox, const void* rk0,
                                        const void* rk17, const void* cw_s,
                                        const void* cw_t, const void* cw_np1,
                                        const void* s_in, const void* t_in,
                                        void* s_out, void* t_out, int k_num,
                                        int n_par, int n, int level,
                                        int final, void* stream) {
  dim3 grid((n_par + dcf::kThreads - 1) / dcf::kThreads, k_num);
#define DCF_ARGS                                                             \
  (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,           \
      (const uint8_t*)cw_s, (const uint8_t*)cw_t, (const uint8_t*)cw_np1,    \
      (const uint8_t*)s_in, (const uint8_t*)t_in, (uint8_t*)s_out,           \
      (uint8_t*)t_out, n_par, n, level
  if (final)
    evalall_expand_kernel<true>
        <<<grid, dcf::kThreads, 0, (cudaStream_t)stream>>>(DCF_ARGS);
  else
    evalall_expand_kernel<false>
        <<<grid, dcf::kThreads, 0, (cudaStream_t)stream>>>(DCF_ARGS);
#undef DCF_ARGS
  return (int)cudaGetLastError();
}
