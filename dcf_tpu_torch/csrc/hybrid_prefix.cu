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
// Bound on the H100: operations, the shared-memory table lookups of the
// n - k walked levels, as B4's: two blocks on a left turn; on a right turn
// two blocks and bit 0 of a third.  One random 68-byte load per point is
// small beside them.  The first design (the four 1 KB T-tables of
// dcf_walk.cuh, all four blocks every level, 256-thread blocks) reached
// 18% of that bound (NVIDIA H100 80GB HBM3, 700 W power limit,
// chip_smoke.py).  This design runs B4's level from the frontier row:
// narrow_point_banked from level k, on the banked AES of aes_banked.cuh,
// three slots with slot C only where the warp's vote says some lane turns
// right.  Launch geometry as B4's: 512-thread blocks, two an SM, the
// 64 KB table, both ciphers' round keys and the CWs of levels k..n-1 in
// shared memory; key j reads rows [j * 2^k, (j + 1) * 2^k).  A thread past
// the last point walks the last point, so that the warp's votes see every
// lane, and stores nothing.

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

// 512 threads a block: with a 64 KB table, two blocks (32 warps) an SM.
constexpr int kBlock = 512;

// Shared layout as B4's: the banked table, cipher 0's round keys, cipher
// 17's 80 words on (bank 16: slot B reads both in one instruction), the
// CWs.
constexpr int kRk17 = 20;  // RoundKey rows from rk0 to rk17
constexpr size_t kCwOffset =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * (kRk17 + 16);

__global__ void __launch_bounds__(kBlock, 2)
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
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks0 =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  dcf::RoundKey* rks17 = rks0 + kRk17;
  dcf::NarrowCw* cw = reinterpret_cast<dcf::NarrowCw*>(dyn_smem + kCwOffset);
  __shared__ uint32_t np1[8];

  const int key = blockIdx.y;
  const size_t first = (size_t)key * n + k;  // level k of this key
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks0, rk0);
  dcf::fill_round_keys(rks17, rk17);
  dcf::fill_narrow_cws(cw, cw_s + first * 32, cw_v + first * 32,
                       cw_t + first * 2, n - k);
  if (threadIdx.x < 8)
    np1[threadIdx.x] = dcf::le32(cw_np1 + key * 32 + 4 * threadIdx.x);
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < m;
  const int pt = live ? p : m - 1;
  const uint8_t* x = xs + (size_t)pt * (n / 8);
  const size_t node = ((size_t)key << k) + dcf::frontier_index(x, k);
  const uint4* ri = reinterpret_cast<const uint4*>(rows + node * 64);
  const uint4 r0 = ri[0], r1 = ri[1], r2 = ri[2], r3 = ri[3];
  const uint32_t row[16] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w,
                            r2.x, r2.y, r2.z, r2.w, r3.x, r3.y, r3.z, r3.w};
  const size_t out_row = (size_t)key * m + pt;
  dcf::NarrowState st;
  const uint32_t word = dcf::narrow_row(st, row, words[node], k);
  uint32_t out[8];
  dcf::narrow_point_banked(dcf::bk_lane(te, threadIdx.x & 31), rks0, rks17,
                           cw, k, n, st, word, np1, x, dcf::WarpVote(), out,
                           live ? traj + out_row * tw : nullptr);
  if (!live) return;
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
  const size_t smem = kCwOffset + sizeof(dcf::NarrowCw) * (size_t)(n - k);
  cudaError_t e = cudaFuncSetAttribute(
      hybrid_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((m + kBlock - 1) / kBlock, k_num);
  hybrid_prefix_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,
      (const uint8_t*)rows, (const uint32_t*)words, (const uint8_t*)cw_s,
      (const uint8_t*)cw_v, (const uint8_t*)cw_t, (const uint8_t*)cw_np1,
      (const uint8_t*)xs, (uint8_t*)y, (uint32_t*)traj, n, k, m, lam, tw);
  return (int)cudaGetLastError();
}
