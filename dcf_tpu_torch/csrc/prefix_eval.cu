// Kernel B3: DCF evaluation from a prefix frontier, lam = 16.
//
// Replaces dcf_tpu/ops/pallas_prefix.py::dcf_eval_prefix_pallas (its
// _kernel, _transpose32_raw and rows_to_state_planes) together with the
// XLA row gather that feeds it (dcf_tpu/backends/pallas_prefix.py,
// gather_and_walk).  On the TPU the gather runs outside the kernel and the
// gathered rows are bit-transposed into planes inside it.  Here the gather
// runs inside the kernel: each thread computes its frontier index from the
// first k bits of its point (bit-reversed, the tree's [lefts ; rights]
// order), loads its 32-byte row (s with t stashed in the masked bit 0 of
// byte 15, then v) and walks the remaining n - k levels.  No transpose is
// needed, because the state is bytes, not bit planes.
//
// Bound on the H100: operations, the shared-memory AES lookups of the
// n - k walked levels (2 blocks x 14 rounds x 16 lookups per level).  The
// one random 32-byte row load per point is small beside them.  Design: as
// B1 (dcf_walk.cuh), with the correction words of levels k..n-1 in shared
// memory.  Points are shared by all keys; key j reads frontier rows
// [j * 2^k, (j + 1) * 2^k) of the stacked table.

#include <cuda_runtime.h>

#include "dcf_walk.cuh"

namespace {

template <int GW>
__global__ void __launch_bounds__(dcf::kThreads)
    prefix_eval_kernel(const uint8_t* __restrict__ sbox,
                       const uint8_t* __restrict__ rk,
                       const uint8_t* __restrict__ table,
                       const uint8_t* __restrict__ cw_s,
                       const uint8_t* __restrict__ cw_v,
                       const uint8_t* __restrict__ cw_t,
                       const uint8_t* __restrict__ cw_np1,
                       const uint8_t* __restrict__ xs,
                       uint8_t* __restrict__ y, int n, int k, int m,
                       int negate) {
  __shared__ dcf::AesTables aes;
  __shared__ uint32_t np1[4];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  dcf::LevelCw* cw = reinterpret_cast<dcf::LevelCw*>(dyn_smem);

  const int key = blockIdx.y;
  const size_t first = (size_t)key * n + k;  // level k of this key
  dcf::fill_aes_tables(aes, sbox, rk);
  dcf::fill_level_cws(cw, cw_s + first * 16, cw_v + first * 16,
                      cw_t + first * 2, n - k);
  if (threadIdx.x < 4)
    np1[threadIdx.x] = dcf::le32(cw_np1 + key * 16 + 4 * threadIdx.x);
  __syncthreads();

  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= m) return;
  const uint8_t* x = xs + (size_t)pt * (n / 8);
  const uint32_t idx = dcf::frontier_index(x, k);
  const uint4* row = reinterpret_cast<const uint4*>(
      table + (((size_t)key << k) + idx) * 32);
  const uint4 rs = row[0], rv = row[1];
  const uint32_t row_s[4] = {rs.x, rs.y, rs.z, rs.w};
  const uint32_t row_v[4] = {rv.x, rv.y, rv.z, rv.w};
  uint32_t out[4];
  dcf::prefix_point<GW>(aes, cw, n, k, row_s, row_v, np1, x, negate != 0,
                        out);
  reinterpret_cast<uint4*>(y)[(size_t)key * m + pt] =
      make_uint4(out[0], out[1], out[2], out[3]);
}

template <int GW>
cudaError_t launch(const uint8_t* sbox, const uint8_t* rk,
                   const uint8_t* table, const uint8_t* cw_s,
                   const uint8_t* cw_v, const uint8_t* cw_t,
                   const uint8_t* cw_np1, const uint8_t* xs, uint8_t* y,
                   int k_num, int n, int k, int m, int negate,
                   cudaStream_t stream) {
  const size_t smem = sizeof(dcf::LevelCw) * (size_t)(n - k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prefix_eval_kernel<GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((m + dcf::kThreads - 1) / dcf::kThreads, k_num);
  prefix_eval_kernel<GW><<<grid, dcf::kThreads, smem, stream>>>(
      sbox, rk, table, cw_s, cw_v, cw_t, cw_np1, xs, y, n, k, m, negate);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).  gw: 0 = xor, 8/16/32 = additive lane width.
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
