// Kernel B4: the narrow walk of the large-lambda hybrid (lam >= 48).
//
// Replaces dcf_tpu/ops/pallas_narrow.py::dcf_narrow_walk_pallas (its
// _kernel and narrow_walk_levels).  The TPU kernel walks 128 bit planes per
// 16-byte block with 32 points per lane word, and runs the level's four
// encryptions as one bitsliced cipher over lane-dependent round keys.  Here
// one thread owns one (key, point): its 32-byte state is eight uint32
// words, and each level runs two T-table AES-256 calls of two blocks in
// lockstep, cipher 0 and then cipher 17 (narrow_walk.cuh).
//
// Output: y[:32] straight into the first 32 bytes of each lam-byte row of
// y [K, M, lam] (kernel W1 fills the rest), and the n+1-bit trajectory as
// packed words into traj [K, M, tw].
//
// Bound on the H100: operations, the shared-memory table lookups (4 blocks
// x 14 rounds x 16 lookups per point and level), as for B1.  The bytes are
// small beside them: the points in, 32 bytes of y and tw words of
// trajectory out per point.  Design: as B1, with cipher 17's round keys and
// the 68-byte narrow CWs of every level in shared memory; points are shared
// by all keys (grid: point blocks x keys).

#include <cuda_runtime.h>

#include "narrow_walk.cuh"

namespace {

__global__ void __launch_bounds__(dcf::kThreads)
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
  __shared__ dcf::NarrowTables tab;
  __shared__ uint32_t seed[8], np1[8];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  dcf::NarrowCw* cw = reinterpret_cast<dcf::NarrowCw*>(dyn_smem);

  const int key = blockIdx.y;
  dcf::fill_narrow_tables(tab, sbox, rk0, rk17);
  dcf::fill_narrow_cws(cw, cw_s + (size_t)key * n * 32,
                       cw_v + (size_t)key * n * 32,
                       cw_t + (size_t)key * n * 2, n);
  if (threadIdx.x < 8) {
    seed[threadIdx.x] = dcf::le32(s0 + key * 32 + 4 * threadIdx.x);
    np1[threadIdx.x] = dcf::le32(cw_np1 + key * 32 + 4 * threadIdx.x);
  }
  __syncthreads();

  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= m) return;
  const size_t row = (size_t)key * m + pt;
  uint32_t out[8];
  dcf::narrow_point(tab, cw, n, seed, np1, xs + (size_t)pt * (n / 8),
                    (uint32_t)b, out, traj + row * tw);
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
  const size_t smem = sizeof(dcf::NarrowCw) * (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        narrow_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((m + dcf::kThreads - 1) / dcf::kThreads, k_num);
  narrow_walk_kernel<<<grid, dcf::kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sbox, (const uint8_t*)rk0, (const uint8_t*)rk17,
      (const uint8_t*)s0, (const uint8_t*)cw_s, (const uint8_t*)cw_v,
      (const uint8_t*)cw_t, (const uint8_t*)cw_np1, (const uint8_t*)xs,
      (uint8_t*)y, (uint32_t*)traj, n, m, lam, tw, b);
  return (int)cudaGetLastError();
}
