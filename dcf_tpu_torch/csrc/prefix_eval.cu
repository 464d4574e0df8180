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
// E(~s), 197 lookups).  The one random 32-byte row load a point is small
// beside them, though at k = 21 the table (64 MB a key) does not fit in
// L2.  The first design (one thread a point on the four 1 KB T-tables of
// dcf_walk.cuh) reached 22% of that bound (NVIDIA H100 80GB HBM3, 700 W
// power limit, chip_smoke.py).  This design is B1's (walk_eval.cu): the
// banked AES, two points a lane in lockstep with a warp vote a level and
// point (walk_pair_levels in aes_banked.cuh), a persistent grid over
// (key, 64 points), the correction words of levels k..n-1 read at each
// level as one broadcast load.  Points are shared by all keys; key j
// reads frontier rows [j * 2^k, (j + 1) * 2^k) of the stacked table.

#include <cuda_runtime.h>

#include "aes_banked.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kBlock = dcf::kLanes * kWarps;
constexpr int kTile = 2 * dcf::kLanes;  // points of a warp's unit
// Shared layout: the banked table, then the round keys.
constexpr size_t kSmem =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * 16;

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
                       int negate, long long tiles, long long units) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks, rk);
  __syncthreads();

  const dcf::BkLane tl = dcf::bk_lane(te, lane);
  const int nb = n / 8;
  for (long long u = (long long)warp * gridDim.x + blockIdx.x; u < units;
       u += (long long)kWarps * gridDim.x) {
    const size_t key = (size_t)(u / tiles);
    const int p0 = (int)(u % tiles) * kTile + lane;
    const int p1 = p0 + dcf::kLanes;
    const uint8_t* x0 = xs + (size_t)(p0 < m ? p0 : m - 1) * nb;
    const uint8_t* x1 = xs + (size_t)(p1 < m ? p1 : m - 1) * nb;
    const uint8_t* rows = table + (key << k) * 32;
    dcf::KlState p[2];
    dcf::walk_row(p[0], rows + (size_t)dcf::frontier_index(x0, k) * 32);
    dcf::walk_row(p[1], rows + (size_t)dcf::frontier_index(x1, k) * 32);
    uint32_t np1[4];
    dcf::load16(cw_np1 + key * 16, np1);
    dcf::walk_pair_levels<GW>(tl, rks, cw_s + key * n * 16,
                              cw_v + key * n * 16, cw_t + key * n * 2, k, n,
                              x0, x1, p[0], p[1]);
    uint4* yk = reinterpret_cast<uint4*>(y) + key * m;
    uint32_t out[4];
    if (p0 < m) {
      dcf::finalize<GW>(p[0].s, p[0].t, p[0].v, np1, negate != 0, out);
      yk[p0] = make_uint4(out[0], out[1], out[2], out[3]);
    }
    if (p1 < m) {
      dcf::finalize<GW>(p[1].s, p[1].t, p[1].v, np1, negate != 0, out);
      yk[p1] = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
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
  const long long tiles = (m + kTile - 1) / kTile;
  const long long units = tiles * k_num;
  const long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = units < blocks ? units : blocks;
  prefix_eval_kernel<GW><<<(unsigned)grid, kBlock, kSmem, stream>>>(
      sbox, rk, table, cw_s, cw_v, cw_t, cw_np1, xs, y, n, k, m, negate,
      tiles, units);
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
