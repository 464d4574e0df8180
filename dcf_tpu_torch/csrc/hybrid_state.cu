// Kernel B5a: the narrow frontier build of the prefix-shared hybrid.
//
// Replaces dcf_tpu/ops/pallas_hybrid_prefix.py::narrow_state_walk_pallas
// (its _state_kernel).  The TPU kernel walks the bit planes of all 2^k node
// prefixes k levels and emits the raw carry planes plus a (k+1)-plane
// trajectory, which the host then transposes into 64-byte rows and packs
// into one word per node.  Here one thread owns one node r < 2^k of one
// key: it derives its walk bits from r (frontier_index order), walks k
// narrow levels from the party's root and writes the frontier row itself:
// rows [K * 2^k, 64] (s then v, 32 bytes each) and words [K * 2^k] (gate
// bits 0..k-1, the depth-k carry t at bit k).
//
// Bound on the H100: operations, 4 blocks x 14 rounds x 16 lookups per
// node and level (k * 2^k narrow steps per key); the rows written are the
// bytes.  It runs once per (key image, party), off the eval clock.  Design:
// as B4, with levels 0..k-1 of the CWs in shared memory.

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

__global__ void __launch_bounds__(dcf::kThreads)
    hybrid_state_kernel(const uint8_t* __restrict__ sbox,
                        const uint8_t* __restrict__ rk0,
                        const uint8_t* __restrict__ rk17,
                        const uint8_t* __restrict__ s0,
                        const uint8_t* __restrict__ cw_s,
                        const uint8_t* __restrict__ cw_v,
                        const uint8_t* __restrict__ cw_t,
                        uint8_t* __restrict__ rows,
                        uint32_t* __restrict__ words, int n, int k, int b) {
  __shared__ dcf::NarrowTables tab;
  __shared__ uint32_t seed[8];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  dcf::NarrowCw* cw = reinterpret_cast<dcf::NarrowCw*>(dyn_smem);

  const int key = blockIdx.y;
  dcf::fill_narrow_tables(tab, sbox, rk0, rk17);
  dcf::fill_narrow_cws(cw, cw_s + (size_t)key * n * 32,
                       cw_v + (size_t)key * n * 32,
                       cw_t + (size_t)key * n * 2, k);
  if (threadIdx.x < 8)
    seed[threadIdx.x] = dcf::le32(s0 + key * 32 + 4 * threadIdx.x);
  __syncthreads();

  const uint32_t r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (1u << k)) return;
  dcf::NarrowState st;
  uint32_t word = 0u;
  dcf::narrow_node(tab, cw, k, seed, r, (uint32_t)b, st, word);
  const size_t node = ((size_t)key << k) + r;
  uint4* ro = reinterpret_cast<uint4*>(rows + node * 64);
  ro[0] = make_uint4(st.s[0], st.s[1], st.s[2], st.s[3]);
  ro[1] = make_uint4(st.s[4], st.s[5], st.s[6], st.s[7]);
  ro[2] = make_uint4(st.v[0], st.v[1], st.v[2], st.v[3]);
  ro[3] = make_uint4(st.v[4], st.v[5], st.v[6], st.v[7]);
  words[node] = word;
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dcf_hybrid_state(const void* sbox, const void* rk0,
                                const void* rk17, const void* s0,
                                const void* cw_s, const void* cw_v,
                                const void* cw_t, void* rows, void* words,
                                int k_num, int n, int k, int b,
                                void* stream) {
  const size_t smem = sizeof(dcf::NarrowCw) * (size_t)k;
  dim3 grid(((1u << k) + dcf::kThreads - 1) / dcf::kThreads, k_num);
  hybrid_state_kernel<<<grid, dcf::kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,
      (const uint8_t*)s0, (const uint8_t*)cw_s, (const uint8_t*)cw_v,
      (const uint8_t*)cw_t, (uint8_t*)rows, (uint32_t*)words, n, k, b);
  return (int)cudaGetLastError();
}
