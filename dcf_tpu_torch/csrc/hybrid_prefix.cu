// Kernel B5b: the prefix-shared narrow walk of the large-lambda hybrid.
//
// Replaces dcf_tpu/ops/pallas_hybrid_prefix.py::dcf_hybrid_prefix_pallas
// (its _eval_kernel) together with what feeds it and what follows it in
// dcf_tpu/backends/large_lambda.py::hybrid_prefix_gather_walk: the XLA row
// and word gathers, the 32x32 butterfly transposes of the rows into bit
// planes (rows_to_state_planes), and the concatenation of the gathered
// top-k gates with the walked trajectory.  Here each thread computes its
// frontier index from the first k bits of its point (bit-reversed, as B3),
// loads its 64-byte row (s then v) and its trajectory word from the tables
// that kernel B5a built, and walks levels k..n-1.  The state is bytes, so
// no transpose is needed, and the top-k gates go into the trajectory in
// registers.  Output as B4: y[:32] into each lam-byte row of y, the whole
// n+1-bit trajectory into traj [K, M, tw], so kernel W1 serves both paths.
//
// Bound on the H100: operations, the table lookups of the n - k walked
// levels (4 blocks x 14 rounds x 16 lookups per level); one random 68-byte
// load per point is small beside them.  Design: as B4, with the CWs of
// levels k..n-1 in shared memory; key j reads rows [j * 2^k, (j + 1) * 2^k).

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

__global__ void __launch_bounds__(dcf::kThreads)
    hybrid_prefix_kernel(const uint8_t* __restrict__ sbox,
                         const uint8_t* __restrict__ rk0,
                         const uint8_t* __restrict__ rk17,
                         const uint8_t* __restrict__ rows,
                         const uint32_t* __restrict__ words,
                         const uint8_t* __restrict__ cw_s,
                         const uint8_t* __restrict__ cw_v,
                         const uint8_t* __restrict__ cw_t,
                         const uint8_t* __restrict__ cw_np1,
                         const uint8_t* __restrict__ xs,
                         uint8_t* __restrict__ y, uint32_t* __restrict__ traj,
                         int n, int k, int m, int lam, int tw) {
  __shared__ dcf::NarrowTables tab;
  __shared__ uint32_t np1[8];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  dcf::NarrowCw* cw = reinterpret_cast<dcf::NarrowCw*>(dyn_smem);

  const int key = blockIdx.y;
  const size_t first = (size_t)key * n + k;  // level k of this key
  dcf::fill_narrow_tables(tab, sbox, rk0, rk17);
  dcf::fill_narrow_cws(cw, cw_s + first * 32, cw_v + first * 32,
                       cw_t + first * 2, n - k);
  if (threadIdx.x < 8)
    np1[threadIdx.x] = dcf::le32(cw_np1 + key * 32 + 4 * threadIdx.x);
  __syncthreads();

  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= m) return;
  const uint8_t* x = xs + (size_t)pt * (n / 8);
  const size_t node = ((size_t)key << k) + dcf::frontier_index(x, k);
  const uint4* ri = reinterpret_cast<const uint4*>(rows + node * 64);
  const uint4 r0 = ri[0], r1 = ri[1], r2 = ri[2], r3 = ri[3];
  const uint32_t row[16] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w,
                            r2.x, r2.y, r2.z, r2.w, r3.x, r3.y, r3.z, r3.w};
  const size_t out_row = (size_t)key * m + pt;
  uint32_t out[8];
  dcf::hybrid_prefix_point(tab, cw, n, k, row, words[node], np1, x, out,
                           traj + out_row * tw);
  uint4* yo = reinterpret_cast<uint4*>(y + out_row * lam);
  yo[0] = make_uint4(out[0], out[1], out[2], out[3]);
  yo[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dcf_hybrid_prefix(const void* sbox, const void* rk0,
                                 const void* rk17, const void* rows,
                                 const void* words, const void* cw_s,
                                 const void* cw_v, const void* cw_t,
                                 const void* cw_np1, const void* xs, void* y,
                                 void* traj, int k_num, int n, int k, int m,
                                 int lam, int tw, void* stream) {
  const size_t smem = sizeof(dcf::NarrowCw) * (size_t)(n - k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hybrid_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((m + dcf::kThreads - 1) / dcf::kThreads, k_num);
  hybrid_prefix_kernel<<<grid, dcf::kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,
      (const uint8_t*)rows, (const uint32_t*)words, (const uint8_t*)cw_s,
      (const uint8_t*)cw_v, (const uint8_t*)cw_t, (const uint8_t*)cw_np1,
      (const uint8_t*)xs, (uint8_t*)y, (uint32_t*)traj, n, k, m, lam, tw);
  return (int)cudaGetLastError();
}
