// Kernel B4: the narrow walk of the large-lambda hybrid (lam >= 48).
//
// Replaces dcf_tpu/ops/pallas_narrow.py::dcf_narrow_walk_pallas (its
// _kernel and that file's Pallas level loop narrow_walk_levels).  The TPU
// kernel walks 128 bit planes per 16-byte block with 32 points per lane
// word, and runs the level's four encryptions as one bitsliced cipher over
// lane-dependent round keys.  Here one thread owns one (key, point): its
// 32-byte state is eight uint32 words (narrow_walk.cuh).
//
// Output: y[:32] straight into the first 32 bytes of each lam-byte row of
// y [K, M, lam] (kernel W1 fills the rest), and the n+1-bit trajectory as
// packed words into traj [K, M, tw].
//
// Bound on the H100: operations, the shared-memory table lookups a walk
// needs (14 rounds x 16 a block): two blocks on a left turn; on a right
// turn two blocks and bit 0 of a third (197 lookups).  The bytes are small
// beside them: the points in, 32 bytes of y and tw words of trajectory out
// per point.  The first design (two calls of two blocks a level on the
// four 1 KB T-tables of dcf_walk.cuh) reached 19% of that bound (NVIDIA
// H100 80GB HBM3, 700 W power limit, chip_smoke.py): the tables put about
// 3.3 lanes' lookups into one bank, and it encrypted all four blocks at
// every level.  This design runs narrow_level_banked: the banked AES of
// aes_banked.cuh (one wavefront a warp's lookups, two integer operations
// a lookup), and the level as three slots with per-lane inputs and round
// keys, so a warp whose lanes turn both ways computes three blocks, not
// four (an all-left warp two).  Cipher 0's and cipher 17's round keys sit
// in different banks, and the 68-byte narrow CWs of every level in shared
// memory;
// points are shared by all keys (grid: point blocks of 512 threads x
// keys; with the 64 KB table two blocks an SM).  A thread past the last
// point walks the last point, so that the warp's votes see every lane,
// and stores nothing.

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

// 512 threads a block: with a 64 KB table, two blocks (32 warps) an SM.
constexpr int kBlock = 512;

// Shared layout: the banked table, cipher 0's round keys, cipher 17's 80
// words on (bank 16: slot B reads both in one instruction), the CWs.
constexpr int kRk17 = 20;  // RoundKey rows from rk0 to rk17
constexpr size_t kCwOffset =
    sizeof(uint32_t) * dcf::kBankedWords + sizeof(dcf::RoundKey) * (kRk17 + 16);

__global__ void __launch_bounds__(kBlock, 2)
    narrow_walk_kernel(const uint8_t* __restrict__ sbox,
                       const uint8_t* __restrict__ rk0,
                       const uint8_t* __restrict__ rk17,
                       const uint8_t* __restrict__ s0,
                       const uint8_t* __restrict__ cw_s,
                       const uint8_t* __restrict__ cw_v,
                       const uint8_t* __restrict__ cw_t,
                       const uint8_t* __restrict__ cw_np1,
                       const uint8_t* __restrict__ xs,
                       uint8_t* __restrict__ y, uint32_t* __restrict__ traj,
                       int n, int m, int lam, int tw, int b) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint32_t* te = reinterpret_cast<uint32_t*>(dyn_smem);
  dcf::RoundKey* rks0 =
      reinterpret_cast<dcf::RoundKey*>(te + dcf::kBankedWords);
  dcf::RoundKey* rks17 = rks0 + kRk17;
  dcf::NarrowCw* cw = reinterpret_cast<dcf::NarrowCw*>(dyn_smem + kCwOffset);
  __shared__ uint32_t seed[8], np1[8];

  const int key = blockIdx.y;
  dcf::fill_banked_table(te, sbox);
  dcf::fill_round_keys(rks0, rk0);
  dcf::fill_round_keys(rks17, rk17);
  dcf::fill_narrow_cws(cw, cw_s + (size_t)key * n * 32,
                       cw_v + (size_t)key * n * 32,
                       cw_t + (size_t)key * n * 2, n);
  if (threadIdx.x < 8) {
    seed[threadIdx.x] = dcf::le32(s0 + key * 32 + 4 * threadIdx.x);
    np1[threadIdx.x] = dcf::le32(cw_np1 + key * 32 + 4 * threadIdx.x);
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < m;
  const int pt = live ? p : m - 1;
  const size_t row = (size_t)key * m + pt;
  dcf::NarrowState st;
  dcf::narrow_root(st, seed, (uint32_t)b);
  uint32_t out[8];
  dcf::narrow_point_banked(dcf::bk_lane(te, threadIdx.x & 31), rks0, rks17,
                           cw, 0, n, st, 0u, np1, xs + (size_t)pt * (n / 8),
                           dcf::WarpVote(), out,
                           live ? traj + row * tw : nullptr);
  if (!live) return;
  uint4* yo = reinterpret_cast<uint4*>(y + row * lam);
  yo[0] = make_uint4(out[0], out[1], out[2], out[3]);
  yo[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

}  // namespace

// C entry point, bound through ctypes.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dcf_narrow_walk(const void* sbox, const void* rk0,
                               const void* rk17, const void* s0,
                               const void* cw_s, const void* cw_v,
                               const void* cw_t, const void* cw_np1,
                               const void* xs, void* y, void* traj, int k_num,
                               int n, int m, int lam, int tw, int b,
                               void* stream) {
  const size_t smem = kCwOffset + sizeof(dcf::NarrowCw) * (size_t)n;
  cudaError_t e = cudaFuncSetAttribute(
      narrow_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((m + kBlock - 1) / kBlock, k_num);
  narrow_walk_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,
      (const uint8_t*)s0, (const uint8_t*)cw_s, (const uint8_t*)cw_v,
      (const uint8_t*)cw_t, (const uint8_t*)cw_np1, (const uint8_t*)xs,
      (uint8_t*)y, (uint32_t*)traj, n, m, lam, tw, b);
  return (int)cudaGetLastError();
}
