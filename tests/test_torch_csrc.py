"""The CUDA kernels' per-thread arithmetic, checked on the CPU.

``dcf_tpu_torch/csrc/dcf_walk.cuh`` holds the T-table bodies of kernels
B1, B3 and B2f as plain C++ over uint32_t (T-table AES-256, the Hirose
step, the SWAR group adds, the walk, the frontier gather index, the tree
node and ``tree_leaves``), and ``csrc/narrow_walk.cuh`` that of the
large-lambda kernel W1 (its table of XORs of W's rows and the lookups).
``csrc/aes_banked.cuh`` holds the bank-conflict-free
AES core (T0 and T2 replicated over 32 lanes) with kernel B8's
keys-in-lanes body, the two-points-a-lane walk of kernel B1, kernel
B3's slot-per-point walk and the tree node of kernel B2, up to three
levels a thread;
``narrow_walk.cuh`` the bodies on it of kernels B4 and B5b (the
three-slot narrow level, from the root or from a frontier row), B5a (a
frontier node into both children, up to three levels a thread, in place)
and B6 (the masked lam = 32 DPF node, up to three levels a thread, and
its leaf correction, and the masked step it shares with kernel B7b);
``keygen_walk.cuh`` the keygen of kernels G1, B7a and B7b on the banked
AES, and W2's wide-tail column.  The banked bodies' tests run the lanes of
a warp in a loop, the warp's votes taken over all lanes first.  This test
compiles the headers with the host C++ compiler into a small library
that runs each body over every (key, point) or node in a loop, and holds
the results byte for byte against the port's numpy oracles (the full-width
``eval_batch_np``, the narrow ``narrow_walk_np`` and
``wide_affine_batch_np``), its host tree expansion and its plain frontier
build: both bounds, both parties, x = alpha and alpha +- 1 planted.  The
launch code (grids, shared-memory fills) runs only on the card and is
covered by ``chip_smoke.py``."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

import torch

from dcf_tpu_torch.backends.fulldomain import tree_expand_np
from dcf_tpu_torch.backends.large_lambda import (
    narrow_walk_np,
    wide_affine_batch_np,
)
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.aes import SBOX_NP, aes256_encrypt_np, expand_key_np
from dcf_tpu_torch.ops.hybrid_prefix import (
    frontier_launches,
    narrow_frontier_plain,
)
from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
from dcf_tpu_torch.ops.prefix_eval import frontier_index_plain
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.ops.walk_eval import walk_bits_plain, walk_levels_plain
from dcf_tpu_torch.spec import GROUP_WIDTH, Bound
from tests.torch_threads import one_torch_thread  # noqa: F401

CSRC = pathlib.Path(__file__).resolve().parent.parent / "dcf_tpu_torch" / "csrc"
GROUPS = ("xor", "add8", "add16", "add32")

_HARNESS = r"""
#include <string.h>
#include <vector>
#include "dcf_walk.cuh"
using namespace dcf;

static void tables(AesTables& a, const uint8_t* sbox, const uint8_t* rk) {
  for (int i = 0; i < 256; ++i) aes_table_entry(a, sbox, i);
  for (int i = 0; i < 60; ++i) a.rk[i] = le32(rk + 4 * i);
}

template <int GW>
static void walk(const uint8_t* sbox, const uint8_t* rk, const uint8_t* s0,
                 const uint8_t* cw_s, const uint8_t* cw_v, const uint8_t* cw_t,
                 const uint8_t* cw_np1, const uint8_t* xs, uint8_t* y, int K,
                 int n, int m, int per_key, int b) {
  AesTables a;
  tables(a, sbox, rk);
  std::vector<LevelCw> cw(n);
  for (int key = 0; key < K; ++key) {
    for (int i = 0; i < n; ++i)
      level_cw_entry(cw.data(), cw_s + (size_t)key * n * 16,
                     cw_v + (size_t)key * n * 16, cw_t + (size_t)key * n * 2, i);
    uint32_t kw[8];
    for (int q = 0; q < 4; ++q) {
      kw[q] = le32(s0 + key * 16 + 4 * q);
      kw[4 + q] = le32(cw_np1 + key * 16 + 4 * q);
    }
    for (int pt = 0; pt < m; ++pt) {
      const uint8_t* x = xs + ((per_key ? (size_t)key * m : 0) + pt) * (n / 8);
      uint32_t out[4];
      walk_point<GW>(a, cw.data(), n, kw, kw + 4, x, (uint32_t)b,
                     b && GW > 0, out);
      memcpy(y + ((size_t)key * m + pt) * 16, out, 16);
    }
  }
}

template <int GW>
static void prefix(const uint8_t* sbox, const uint8_t* rk,
                   const uint8_t* table, const uint8_t* cw_s,
                   const uint8_t* cw_v, const uint8_t* cw_t,
                   const uint8_t* cw_np1, const uint8_t* xs, uint8_t* y, int K,
                   int n, int k, int m, int negate) {
  AesTables a;
  tables(a, sbox, rk);
  std::vector<LevelCw> cw(n);
  for (int key = 0; key < K; ++key) {
    const size_t first = (size_t)key * n + k;
    for (int i = 0; i < n - k; ++i)
      level_cw_entry(cw.data(), cw_s + first * 16, cw_v + first * 16,
                     cw_t + first * 2, i);
    uint32_t np1[4];
    for (int q = 0; q < 4; ++q) np1[q] = le32(cw_np1 + key * 16 + 4 * q);
    for (int pt = 0; pt < m; ++pt) {
      const uint8_t* x = xs + (size_t)pt * (n / 8);
      const uint8_t* row = table + (((size_t)key << k) + frontier_index(x, k)) * 32;
      uint32_t rs[4], rv[4], out[4];
      memcpy(rs, row, 16);
      memcpy(rv, row + 16, 16);
      prefix_point<GW>(a, cw.data(), n, k, rs, rv, np1, x, negate != 0, out);
      memcpy(y + ((size_t)key * m + pt) * 16, out, 16);
    }
  }
}

#define DISPATCH(f, ...)                      \
  switch (gw) {                               \
    case 0: f<0>(__VA_ARGS__); break;         \
    case 8: f<8>(__VA_ARGS__); break;         \
    case 16: f<16>(__VA_ARGS__); break;       \
    default: f<32>(__VA_ARGS__); break;       \
  }

extern "C" {
void host_walk(const uint8_t* sbox, const uint8_t* rk, const uint8_t* s0,
               const uint8_t* cw_s, const uint8_t* cw_v, const uint8_t* cw_t,
               const uint8_t* cw_np1, const uint8_t* xs, uint8_t* y, int K,
               int n, int m, int per_key, int b, int gw) {
  DISPATCH(walk, sbox, rk, s0, cw_s, cw_v, cw_t, cw_np1, xs, y, K, n, m,
           per_key, b)
}
void host_prefix(const uint8_t* sbox, const uint8_t* rk, const uint8_t* table,
                 const uint8_t* cw_s, const uint8_t* cw_v, const uint8_t* cw_t,
                 const uint8_t* cw_np1, const uint8_t* xs, uint8_t* y, int K,
                 int n, int k, int m, int negate, int gw) {
  DISPATCH(prefix, sbox, rk, table, cw_s, cw_v, cw_t, cw_np1, xs, y, K, n, k,
           m, negate)
}
}
"""


_NARROW_HARNESS = r"""
#include "narrow_walk.cuh"

static void narrow_tables(NarrowTables& t, const uint8_t* sbox,
                          const uint8_t* rk0, const uint8_t* rk17) {
  tables(t.a, sbox, rk0);
  for (int i = 0; i < 60; ++i) t.rk17[i] = le32(rk17 + 4 * i);
}

static void words8(const uint8_t* p, uint32_t w[8]) {
  for (int q = 0; q < 8; ++q) w[q] = le32(p + 4 * q);
}

extern "C" {
void host_tree_final(const uint8_t* sbox, const uint8_t* rk,
                     const uint8_t* cw_s, const uint8_t* cw_v,
                     const uint8_t* cw_t, const uint8_t* cw_np1,
                     const uint8_t* s_in, const uint8_t* v_in,
                     const uint8_t* t_in, uint8_t* y_out, int n_par) {
  AesTables a;
  tables(a, sbox, rk);
  LevelCw cw[1];
  level_cw_entry(cw, cw_s, cw_v, cw_t, 0);
  uint32_t np1[4];
  for (int q = 0; q < 4; ++q) np1[q] = le32(cw_np1 + 4 * q);
  for (int j = 0; j < n_par; ++j) {
    uint32_t s[4], v[4], yl[4], yr[4];
    memcpy(s, s_in + 16 * j, 16);
    memcpy(v, v_in + 16 * j, 16);
    tree_leaves(a, cw[0], np1, s, v, t_in[j] & 1u, yl, yr);
    memcpy(y_out + 16 * j, yl, 16);
    memcpy(y_out + 16 * ((size_t)n_par + j), yr, 16);
  }
}

// Kernel W1 over K keys and m points as its blocks run it: for each key
// and column tile of `cols` 16-byte chunks among tiles [t0, t1), the
// tile's table built entry by entry, then every (point, chunk) of the tile
// looked up.  y [K, m, 16 chunks] holds the wide part alone.
void host_wide_tiles(const uint32_t* traj, const uint8_t* w,
                     const uint8_t* cst, uint8_t* y, int K, int n1, int tw,
                     int chunks, int m, int cols, int t0, int t1) {
  const int groups = wide_groups(n1);
  const size_t wd = 16 * (size_t)chunks;
  std::vector<uint32_t> tab((size_t)groups * kWideVals * cols * 4);
  for (int key = 0; key < K; ++key)
    for (int tile = t0; tile < t1; ++tile) {
      const int c0 = tile * cols;
      for (int e = 0; e < groups * kWideVals * cols; ++e) {
        const int col = e % cols, gn = e / cols;
        uint32_t out[4] = {0u, 0u, 0u, 0u};
        if (c0 + col < chunks)
          wide_table_entry(w + (size_t)key * n1 * wd + 16 * (c0 + col),
                           cst + (size_t)key * wd + 16 * (c0 + col), wd, n1,
                           gn / kWideVals, gn % kWideVals, out);
        memcpy(&tab[4 * (size_t)e], out, 16);
      }
      for (int pt = 0; pt < m; ++pt)
        for (int c = 0; c < cols && c0 + c < chunks; ++c) {
          const size_t row = (size_t)key * m + pt;
          uint32_t out[4];
          wide_chunk(traj + row * tw, n1, tab.data() + 4 * c, cols, out);
          memcpy(y + row * wd + 16 * (c0 + c), out, 16);
        }
    }
}

// ... over every column tile, 16 chunks a tile, as the kernel cuts them.
void host_wide(const uint32_t* traj, const uint8_t* w, const uint8_t* cst,
               uint8_t* y, int K, int n1, int tw, int wdw, int m) {
  const int chunks = wdw / 4, cols = chunks < 16 ? chunks : 16;
  host_wide_tiles(traj, w, cst, y, K, n1, tw, chunks, m, cols, 0,
                  (chunks + cols - 1) / cols);
}
}
"""

_KEYGEN_HARNESS = r"""
#include "keygen_walk.cuh"

extern "C" {
// Kernels G1 (mode 0), B7a (1), B7b (2) and G2 (3), key j on lane j % 32
// of the banked AES.
void host_keygen(const uint8_t* sbox, const uint8_t* rk0, const uint8_t* rk17,
                 const uint8_t* alphas, const uint8_t* betas,
                 const uint8_t* s0s, uint8_t* cw_s, uint8_t* cw_v,
                 uint8_t* cw_t, uint8_t* cw_np1, uint8_t* traj, int K, int n,
                 int lam, int lt, int mode) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey rks[15], rks17[15];
  round_keys(rks, rk0);
  round_keys(rks17, rk17);
  for (int key = 0; key < K; ++key) {
    const size_t rows = (size_t)key * n;
    const uint8_t* s0 = s0s + (size_t)key * 2 * lam;
    uint8_t* v = cw_v ? cw_v + rows * lam : nullptr;
    uint8_t* tr = traj ? traj + rows * 2 : nullptr;
    const BkLane lane = bk_lane(te.data(), key % kLanes);
#define KG_ARGS n, lt != 0, alphas + (size_t)key * (n / 8),                 \
      betas + (size_t)key * lam, s0, s0 + lam, lam, cw_s + rows * lam, v,   \
      cw_t + rows * 2, cw_np1 + (size_t)key * lam, tr
    if (mode == 0)
      keygen_key<kKgDcf16>(KgBanked16{lane, rks}, KG_ARGS);
    else if (mode == 1)
      keygen_key<kKgNarrow>(KgBankedNarrow{lane, rks, rks17}, KG_ARGS);
    else if (mode == 2)
      keygen_key<kKgDpf32>(KgBankedDpf{lane, rks, rks17}, KG_ARGS);
    else
      keygen_key<kKgDcf32>(KgBankedDcf32{{lane, rks, rks17}}, KG_ARGS);
#undef KG_ARGS
  }
}

// The masked lam = 32 DPF step of N seeds, seed j on lane j % 32, three
// ways: dpf_step_banked (the step B6 and B7b share, uncorrected) into
// step_s / step_t, dpf_node_banked under the one CW (cw_s [32], cw_t [2])
// and the seed's t_in into node_s / node_t, and the three blocks on the
// T-tables (aes256_encrypt3_rk, E0(~s_b0) in full) into tab_s / tab_t.
// Children [N, 2, 32] (left, right) and their t bits [N, 2].
void host_dpf_step(const uint8_t* sbox, const uint8_t* rk0,
                   const uint8_t* rk17, const uint8_t* cw_s,
                   const uint8_t* cw_t, const uint8_t* seeds,
                   const uint8_t* t_in, uint8_t* step_s, uint8_t* step_t,
                   uint8_t* node_s, uint8_t* node_t, uint8_t* tab_s,
                   uint8_t* tab_t, int N) {
  NarrowTables tab;
  narrow_tables(tab, sbox, rk0, rk17);
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey k0[15], k17[15];
  round_keys(k0, rk0);
  round_keys(k17, rk17);
  DpfCw w;
  dpf_cw_entry(w, cw_s, cw_t);
  for (int j = 0; j < N; ++j) {
    uint32_t s[8], c[2][8], ct[2];
    words8(seeds + 32 * (size_t)j, s);
    const BkLane lane = bk_lane(te.data(), j % kLanes);
    dpf_step_banked(lane, k0, k17, s, c[0], ct[0], c[1], ct[1]);
    memcpy(step_s + 64 * (size_t)j, c, 64);
    step_t[2 * j] = (uint8_t)ct[0];
    step_t[2 * j + 1] = (uint8_t)ct[1];
    dpf_node_banked(lane, k0, k17, w, s, t_in[j] & 1u, c[0], ct[0], c[1],
                    ct[1]);
    memcpy(node_s + 64 * (size_t)j, c, 64);
    node_t[2 * j] = (uint8_t)ct[0];
    node_t[2 * j + 1] = (uint8_t)ct[1];
    uint32_t sp[4], e0[4], e0p[4], e1[4];
    for (int q = 0; q < 4; ++q) sp[q] = ~s[q];
    aes256_encrypt3_rk(tab.a, tab.a.rk, tab.rk17, s, sp, s + 4, e0, e0p, e1);
    for (int q = 0; q < 4; ++q) {
      const uint32_t m = q == 3 ? kMaskBit : 0xFFFFFFFFu;
      c[0][q] = e0[q] ^ s[q];
      c[1][q] = s[q];
      c[0][4 + q] = s[4 + q] & m;
      c[1][4 + q] = (e1[q] ^ s[4 + q]) & m;
    }
    memcpy(tab_s + 64 * (size_t)j, c, 64);
    tab_t[2 * j] = (uint8_t)((e0[0] ^ s[0]) & 1u);
    tab_t[2 * j + 1] = (uint8_t)((e0p[0] ^ sp[0]) & 1u);
  }
}

// Kernel W2: every (key, 16-byte column) of the wide part, as a thread of
// keygen_wide.cu takes it.
void host_wide_tail(const uint8_t* alphas, const uint8_t* betas,
                    const uint8_t* s0s, const uint8_t* traj, uint8_t* cw_s,
                    uint8_t* cw_v, uint8_t* cw_np1, int K, int n, int lam,
                    int lt) {
  const int cols = (lam - 32) / 16;
  for (int key = 0; key < K; ++key) {
    const size_t rows = (size_t)key * n;
    const uint8_t* s0 = s0s + (size_t)key * 2 * lam;
    for (int c = 0; c < cols; ++c) {
      const size_t at = 32 + 16 * (size_t)c;
      wide_tail_column(n, lt != 0, c == cols - 1, lam,
                       alphas + (size_t)key * (n / 8), traj + rows * 2,
                       betas + (size_t)key * lam + at, s0 + at,
                       s0 + lam + at, cw_s + rows * lam + at,
                       cw_v + rows * lam + at, cw_np1 + (size_t)key * lam + at);
    }
  }
}
}
"""


_BANKED_HARNESS = r"""
#include <algorithm>

// The banked AES core and the bodies of kernels B8 and B4 on it, run over
// the lanes of a warp in a loop.
static void banked_table(std::vector<uint32_t>& te, const uint8_t* sbox) {
  te.resize(kBankedWords);
  for (int e = 0; e < kBankedWords; ++e) te[e] = banked_table_word(sbox, e);
}

static void round_keys(RoundKey rk[15], const uint8_t* bytes) {
  for (int i = 0; i < 60; ++i) rk[i >> 2].w[i & 3] = le32(bytes + 4 * i);
}

// Slot C of the three-slot level at level i: where any lane of the warp
// turns right there.
struct LevelVote {
  const uint8_t* any_right;
  bool operator()(int i, uint32_t) const { return any_right[i] != 0; }
};

extern "C" {
// Call c encrypts the blocks from j = step * c on lane c % 32: mode 0 two
// in lockstep (j, j + 1) under ciphers rk_a and rk_b, mode 1 three (j,
// j + 1, j + 2) under rk_a, rk_b, rk_a; mode 2 blocks j and j + 1 in full
// and bit 0 of byte 0 of block j + 2 (into out[16 (j + 2)]), all under
// rk_a.
void host_banked_aes(const uint8_t* sbox, const uint8_t* rk_a,
                     const uint8_t* rk_b, const uint8_t* in, uint8_t* out,
                     int n_blocks, int mode) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey ka[15], kb[15];
  round_keys(ka, rk_a);
  round_keys(kb, rk_b);
  const int step = mode == 0 ? 2 : 3;
  for (int j = 0; j + step <= n_blocks; j += step) {
    const BkLane t = bk_lane(te.data(), (j / step) % kLanes);
    uint32_t x[3][4];
    for (int c = 0; c < step; ++c) memcpy(x[c], in + 16 * (j + c), 16);
    if (mode == 2) {
      uint32_t bit[1];
      const RoundKey* const rk1[3] = {ka, ka, ka};
      bk_encrypt<2, 1>(t, rk1, x, bit);
      memcpy(out + 16 * j, x[0], 32);
      memset(out + 16 * (j + 2), 0, 16);
      out[16 * (j + 2)] = (uint8_t)bit[0];
      continue;
    }
    const RoundKey* const rk[3] = {ka, kb, ka};
    if (mode == 0)
      bk_encrypt<2>(t, rk, x);
    else
      bk_encrypt<3>(t, rk, x);
    for (int c = 0; c < step; ++c) memcpy(out + 16 * (j + c), x[c], 16);
  }
}

// Kernel B8 as a block runs it: groups of 32 keys, each staged transposed
// (the first `staged` levels; the rest read from the key rows), the t bits
// of a level gathered from the 32 lanes as the ballot does, then every
// pair of points walked by the 32 lanes.
void host_keylanes(const uint8_t* sbox, const uint8_t* rk, const uint8_t* s0s,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, const uint8_t* cw_np1,
                   const uint8_t* xs, uint8_t* y, int K, int n, int m, int b,
                   int staged) {
  std::vector<uint32_t> te, st_s(staged * 4 * kLanes), st_v(staged * 4 * kLanes),
      st_t(2 * staged);
  banked_table(te, sbox);
  RoundKey rks[15];
  round_keys(rks, rk);
  for (int g0 = 0; g0 < K; g0 += kLanes) {
    for (int i = 0; i < staged; ++i) {
      st_t[2 * i] = st_t[2 * i + 1] = 0u;
      for (int l = 0; l < kLanes; ++l) {
        const size_t kk = (size_t)std::min(g0 + l, K - 1);
        kl_stage_entry(st_s.data(), st_v.data(), cw_s + kk * n * 16,
                       cw_v + kk * n * 16, i, l);
        const uint32_t bits = kl_t_bits(cw_t + kk * n * 2, i);
        st_t[2 * i] |= (bits & 1u) << l;
        st_t[2 * i + 1] |= (bits >> 1) << l;
      }
    }
    for (int pt = 0; pt < m; pt += 2) {
      const int p1 = pt + 1 < m ? pt + 1 : pt;  // an odd last point twice
      for (int l = 0; l < kLanes; ++l) {
        const size_t kc = (size_t)std::min(g0 + l, K - 1);
        const KlCw cw = {st_s.data(), st_v.data(), st_t.data(), staged,
                         cw_s + kc * n * 16, cw_v + kc * n * 16,
                         cw_t + kc * n * 2};
        uint32_t seed[4], np1[4], y0[4], y1[4];
        load16(s0s + kc * 32 + b * 16, seed);
        load16(cw_np1 + kc * 16, np1);
        keylanes_lane_pair(bk_lane(te.data(), l), rks, cw, n, l, seed, np1,
                           xs + (size_t)pt * (n / 8),
                           xs + (size_t)p1 * (n / 8), (uint32_t)b, y0, y1);
        if (g0 + l >= K) continue;
        memcpy(y + (kc * m + pt) * 16, y0, 16);
        if (p1 != pt) memcpy(y + (kc * m + p1) * 16, y1, 16);
      }
    }
  }
}

// Kernel B4: points pt of one key on lane pt % 32 of warp pt / 32, slot C
// run at a level where any point of the warp turns right; all3 runs it at
// every level.
void host_narrow(const uint8_t* sbox, const uint8_t* rk0,
                        const uint8_t* rk17, const uint8_t* s0,
                        const uint8_t* cw_s, const uint8_t* cw_v,
                        const uint8_t* cw_t, const uint8_t* np1,
                        const uint8_t* xs, uint8_t* y, uint32_t* traj, int K,
                        int n, int m, int tw, int b, int all3) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey k0[15], k17[15];
  round_keys(k0, rk0);
  round_keys(k17, rk17);
  std::vector<uint8_t> any((size_t)(m / kLanes + 1) * n, (uint8_t)all3);
  for (int pt = 0; pt < m; ++pt)
    for (int i = 0; i < n; ++i)
      any[(size_t)(pt / kLanes) * n + i] |=
          walk_bit(xs + (size_t)pt * (n / 8), i);
  std::vector<NarrowCw> cw(n);
  for (int key = 0; key < K; ++key) {
    for (int i = 0; i < n; ++i)
      narrow_cw_entry(cw.data(), cw_s + (size_t)key * n * 32,
                      cw_v + (size_t)key * n * 32, cw_t + (size_t)key * n * 2,
                      i);
    uint32_t sw[8], fw[8], out[8];
    words8(s0 + key * 32, sw);
    words8(np1 + key * 32, fw);
    for (int pt = 0; pt < m; ++pt) {
      const size_t row = (size_t)key * m + pt;
      NarrowState st;
      narrow_root(st, sw, (uint32_t)b);
      narrow_point_banked(bk_lane(te.data(), pt % kLanes), k0, k17,
                          cw.data(), 0, n, st, 0u, fw,
                          xs + (size_t)pt * (n / 8),
                          LevelVote{any.data() + (size_t)(pt / kLanes) * n},
                          out, traj + row * tw);
      memcpy(y + row * 32, out, 32);
    }
  }
}
}
"""


_TREE_HARNESS = r"""
// Kernel B2: levels level .. level + depth - 1 of one key (its rows cw_s /
// cw_v [n, 16], cw_t [n, 2]) from n_par parents, parent j on lane j % 32
// of the banked AES, as a launch of that depth runs them.
template <int GW>
static void tree_levels(const uint8_t* sbox, const uint8_t* rk,
                        const uint8_t* cw_s, const uint8_t* cw_v,
                        const uint8_t* cw_t, const uint8_t* s_in,
                        const uint8_t* v_in, const uint8_t* t_in,
                        uint8_t* s_out, uint8_t* v_out, uint8_t* t_out,
                        int n_par, int level, int depth) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey rks[15];
  round_keys(rks, rk);
  LevelCw cw[3];
  for (int l = 0; l < depth; ++l)
    level_cw_entry(cw, cw_s + 16 * level, cw_v + 16 * level,
                   cw_t + 2 * level, l);
  for (int j = 0; j < n_par; ++j) {
    TreeNode p;
    load16(s_in + 16 * (size_t)j, p.s);
    load16(v_in + 16 * (size_t)j, p.v);
    p.t = t_in[j] & 1u;
    const BkLane lane = bk_lane(te.data(), j % kLanes);
#define TREE_ARGS lane, rks, cw, p, s_out, v_out, t_out, (size_t)j, (size_t)n_par
    if (depth == 1) tree_subtree<GW, 1>(TREE_ARGS);
    else if (depth == 2) tree_subtree<GW, 2>(TREE_ARGS);
    else tree_subtree<GW, 3>(TREE_ARGS);
#undef TREE_ARGS
  }
}

extern "C" {
void host_tree_levels(const uint8_t* sbox, const uint8_t* rk,
                      const uint8_t* cw_s, const uint8_t* cw_v,
                      const uint8_t* cw_t, const uint8_t* s_in,
                      const uint8_t* v_in, const uint8_t* t_in,
                      uint8_t* s_out, uint8_t* v_out, uint8_t* t_out,
                      int n_par, int level, int depth, int gw) {
  DISPATCH(tree_levels, sbox, rk, cw_s, cw_v, cw_t, s_in, v_in, t_in, s_out,
           v_out, t_out, n_par, level, depth)
}

// Kernel B2f: the tree's last `depth` levels (1-3; rows cw_s / cw_v
// [depth, 16], cw_t [depth, 2]) from n_par parents, parent j on lane
// j % 32, as its launch runs them: y_out [2^depth n_par, 16] the leaf
// shares (XOR group) in the rows of depth one-level launches.
void host_tree_final_levels(const uint8_t* sbox, const uint8_t* rk,
                            const uint8_t* cw_s, const uint8_t* cw_v,
                            const uint8_t* cw_t, const uint8_t* cw_np1,
                            const uint8_t* s_in, const uint8_t* v_in,
                            const uint8_t* t_in, uint8_t* y_out, int n_par,
                            int depth) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey rks[15];
  round_keys(rks, rk);
  LevelCw cw[3];
  for (int l = 0; l < depth; ++l) level_cw_entry(cw, cw_s, cw_v, cw_t, l);
  uint32_t np1[4];
  for (int q = 0; q < 4; ++q) np1[q] = le32(cw_np1 + 4 * q);
  for (int j = 0; j < n_par; ++j) {
    TreeNode p;
    load16(s_in + 16 * (size_t)j, p.s);
    load16(v_in + 16 * (size_t)j, p.v);
    p.t = t_in[j] & 1u;
    const BkLane lane = bk_lane(te.data(), j % kLanes);
#define LEAF_ARGS lane, rks, cw, p, y_out, nullptr, nullptr, (size_t)j, \
      (size_t)n_par, np1
    if (depth == 1) tree_subtree<0, 1, true>(LEAF_ARGS);
    else if (depth == 2) tree_subtree<0, 2, true>(LEAF_ARGS);
    else tree_subtree<0, 3, true>(LEAF_ARGS);
#undef LEAF_ARGS
  }
}

// One level: cw_s / cw_v / cw_t point at that level's correction words.
void host_tree(const uint8_t* sbox, const uint8_t* rk, const uint8_t* cw_s,
               const uint8_t* cw_v, const uint8_t* cw_t, const uint8_t* s_in,
               const uint8_t* v_in, const uint8_t* t_in, uint8_t* s_out,
               uint8_t* v_out, uint8_t* t_out, int n_par, int gw) {
  host_tree_levels(sbox, rk, cw_s, cw_v, cw_t, s_in, v_in, t_in, s_out,
                   v_out, t_out, n_par, 0, 1, gw);
}
}
"""


_BANKED_NARROW_HARNESS = r"""
// Kernels B5a, B5b and B6 on the banked AES.
extern "C" {
// Kernel B5a: levels 0 .. top - 1 of K keys' frontiers at depth k from
// the root, a level at a time (its top launch), or (top = 0) one later
// launch, levels level .. level + depth - 1 in place; the parent j of key
// `key` at level i on lane (key * 2^i + j) % 32.
void host_frontier(const uint8_t* sbox, const uint8_t* rk0,
                   const uint8_t* rk17, const uint8_t* s0,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, uint8_t* rows, uint32_t* words, int K,
                   int n, int k, int top, int level, int depth, int b) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey k0[15], k17[15];
  round_keys(k0, rk0);
  round_keys(k17, rk17);
  const int lo = top ? 0 : level, hi = top ? top : level + 1;
  for (int i = lo; i < hi; ++i) {
    for (int key = 0; key < K; ++key) {
      uint8_t* kr = rows + ((size_t)key << k) * 64;
      uint32_t* kw = words + ((size_t)key << k);
      const size_t first = (size_t)key * n;
      for (size_t j = 0; j < ((size_t)1 << i); ++j) {
        FrontierNode p;
        if (top && i == 0) {
          words8(s0 + (size_t)key * 32, p.s);
          for (int q = 0; q < 8; ++q) p.v[q] = 0u;
          p.word = (uint32_t)b;
        } else {
          frontier_load(p, kr, kw, j);
        }
        const BkLane lane =
            bk_lane(te.data(), (int)((((size_t)key << i) + j) % kLanes));
#define B5A_ARGS lane, k0, k17, cw_s + first * 32, cw_v + first * 32,       \
      cw_t + first * 2, i, p, kr, kw, j, (size_t)1 << i
        if (top || depth == 1) frontier_subtree<1>(B5A_ARGS);
        else frontier_subtree<2>(B5A_ARGS);
#undef B5A_ARGS
      }
    }
  }
}

// Kernel B5b: points pt of one key on lane pt % 32 of warp pt / 32, each
// from its frontier row and word (levels k..n-1 walked), slot C run at a
// level where any point of the warp turns right.
void host_hybrid_prefix(const uint8_t* sbox, const uint8_t* rk0,
                        const uint8_t* rk17, const uint8_t* rows,
                        const uint32_t* words, const uint8_t* cw_s,
                        const uint8_t* cw_v, const uint8_t* cw_t,
                        const uint8_t* np1, const uint8_t* xs, uint8_t* y,
                        uint32_t* traj, int K, int n, int k, int m, int tw) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey k0[15], k17[15];
  round_keys(k0, rk0);
  round_keys(k17, rk17);
  std::vector<uint8_t> any((size_t)(m / kLanes + 1) * n, 0);
  for (int pt = 0; pt < m; ++pt)
    for (int i = 0; i < n; ++i)
      any[(size_t)(pt / kLanes) * n + i] |=
          walk_bit(xs + (size_t)pt * (n / 8), i);
  std::vector<NarrowCw> cw(n - k);
  for (int key = 0; key < K; ++key) {
    const size_t first = (size_t)key * n + k;
    for (int i = 0; i < n - k; ++i)
      narrow_cw_entry(cw.data(), cw_s + first * 32, cw_v + first * 32,
                      cw_t + first * 2, i);
    uint32_t fw[8], out[8], row[16];
    words8(np1 + key * 32, fw);
    for (int pt = 0; pt < m; ++pt) {
      const uint8_t* x = xs + (size_t)pt * (n / 8);
      const size_t node = ((size_t)key << k) + frontier_index(x, k);
      memcpy(row, rows + node * 64, 64);
      const size_t o = (size_t)key * m + pt;
      NarrowState st;
      const uint32_t word = narrow_row(st, row, words[node], k);
      narrow_point_banked(bk_lane(te.data(), pt % kLanes), k0, k17,
                          cw.data(), k, n, st, word, fw, x,
                          LevelVote{any.data() + (size_t)(pt / kLanes) * n},
                          out, traj + o * tw);
      memcpy(y + o * 32, out, 32);
    }
  }
}

// Kernel B6 over K keys: [K, N, 32] parents at level `level` ->
// [K, 2^depth N, 32] nodes of level level + depth (depth 1-3), parent j on
// lane j % 32, leaf correction applied when np1 is not null; the t bits
// alone when s_out is null, a parent's 2^depth leaf bits in one word
// (pos 0, stride 1) that the kernel then packs, here set into t_out as
// zeroed uint32 words [K, ceil(2^depth N / 32)] one bit at a time.
void host_dpf_levels(const uint8_t* sbox, const uint8_t* rk0,
                     const uint8_t* rk17, const uint8_t* cw_s,
                     const uint8_t* cw_t, const uint8_t* np1,
                     const uint8_t* s_in, const uint8_t* t_in, uint8_t* s_out,
                     uint8_t* t_out, int K, int n_par, int n, int level,
                     int depth) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey k0[15], k17[15];
  round_keys(k0, rk0);
  round_keys(k17, rk17);
  for (int key = 0; key < K; ++key) {
    DpfCw w[3];
    for (int l = 0; l < depth; ++l) {
      const size_t row = (size_t)key * n + level + l;
      dpf_cw_entry(w[l], cw_s + row * 32, cw_t + row * 2);
    }
    uint32_t fw[8];
    if (np1) words8(np1 + key * 32, fw);
    const size_t out = (size_t)key * ((size_t)n_par << depth);
    uint32_t* const kw = reinterpret_cast<uint32_t*>(t_out) +
                         (size_t)key * ((((size_t)n_par << depth) + 31) / 32);
    for (int j = 0; j < n_par; ++j) {
      const size_t in = (size_t)key * n_par + j;
      uint32_t s[8];
      memcpy(s, s_in + in * 32, 32);
#define DPF_ARGS bk_lane(te.data(), j % kLanes), k0, k17, w,                \
      np1 ? fw : nullptr, s, t_in[in] & 1u,                                \
      s_out ? s_out + out * 32 : nullptr, t_out + out, (size_t)j,          \
      (size_t)n_par
#define DPF_T_ARGS bk_lane(te.data(), j % kLanes), k0, k17, w, nullptr, s, \
      t_in[in] & 1u, nullptr, nullptr, 0, 1, &tb
      if (s_out) {
        if (depth == 1) dpf_subtree<1>(DPF_ARGS);
        else if (depth == 2) dpf_subtree<2>(DPF_ARGS);
        else dpf_subtree<3>(DPF_ARGS);
      } else {
        uint32_t tb = 0u;
        if (depth == 1) dpf_subtree<1, false>(DPF_T_ARGS);
        else if (depth == 2) dpf_subtree<2, false>(DPF_T_ARGS);
        else dpf_subtree<3, false>(DPF_T_ARGS);
        for (int r = 0; r < (1 << depth); ++r) {
          const size_t at = (size_t)j + (size_t)n_par * r;
          kw[at / 32] |= ((tb >> r) & 1u) << (at % 32);
        }
      }
#undef DPF_T_ARGS
#undef DPF_ARGS
    }
  }
}
}
"""


_PAIR_HARNESS = r"""
// Kernels B1 and B3 as a warp runs them: a unit of 64 points of one key on
// lanes 0-31 (lane l: points l and 32 + l; a point past the last walks the
// last one and is not stored), each level's two warp votes (some lane
// turns left with its point 0, with its point 1) taken over all lanes
// first, then each lane's level.  *computed counts the AES table lookups
// the lanes' blocks compute (a bit-0 block at 197).
template <int GW>
static void pair_unit(const BkLane* lanes, const RoundKey* rks,
                      const uint8_t* cw_s, const uint8_t* cw_v,
                      const uint8_t* cw_t, int lo, int n,
                      const uint8_t* const* x, KlState (*P)[2],
                      long long* computed) {
  const long long full = 224, bit = 12 * 16 + 4 + 1;
  for (int i = lo; i < n; ++i) {
    LevelCw w;
    walk_cw(cw_s, cw_v, cw_t, i, w);
    bool any0 = false, any1 = false;
    for (int l = 0; l < kLanes; ++l) {
      any0 |= walk_bit(x[l], i) == 0u;
      any1 |= walk_bit(x[kLanes + l], i) == 0u;
    }
    *computed += kLanes * ((any0 ? 2 * full : bit) + (any1 ? 2 * full : bit));
    for (int l = 0; l < kLanes; ++l)
      walk_level_pair<GW>(lanes[l], rks, w, walk_bit(x[l], i),
                          walk_bit(x[kLanes + l], i), any0, any1, P[l][0],
                          P[l][1]);
  }
}

template <int GW>
static void pair_walk(const uint8_t* sbox, const uint8_t* rk,
                      const uint8_t* s0, const uint8_t* cw_s,
                      const uint8_t* cw_v, const uint8_t* cw_t,
                      const uint8_t* cw_np1, const uint8_t* xs,
                      const uint8_t* table, uint8_t* y, int K, int n, int k,
                      int m, int per_key, int b, long long* computed) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey rks[15];
  round_keys(rks, rk);
  BkLane lanes[kLanes];
  for (int l = 0; l < kLanes; ++l) lanes[l] = bk_lane(te.data(), l);
  const int nb = n / 8;
  for (int key = 0; key < K; ++key) {
    uint32_t seed[4], np1[4];
    load16(s0 + key * 16, seed);
    load16(cw_np1 + key * 16, np1);
    const uint8_t* xk = xs + (per_key ? (size_t)key * m : 0) * nb;
    for (int base = 0; base < m; base += 2 * kLanes) {
      const uint8_t* x[2 * kLanes];
      KlState P[kLanes][2];
      for (int j = 0; j < 2 * kLanes; ++j) {
        x[j] = xk + (size_t)std::min(base + j, m - 1) * nb;
        KlState& p = P[j % kLanes][j / kLanes];
        if (table)
          walk_row(p, table + (((size_t)key << k) + frontier_index(x[j], k)) * 32);
        else
          walk_root(p, seed, (uint32_t)b);
      }
      pair_unit<GW>(lanes, rks, cw_s + (size_t)key * n * 16,
                    cw_v + (size_t)key * n * 16, cw_t + (size_t)key * n * 2,
                    table ? k : 0, n, x, P, computed);
      for (int j = 0; j < 2 * kLanes && base + j < m; ++j) {
        const KlState& p = P[j % kLanes][j / kLanes];
        uint32_t out[4];
        finalize<GW>(p.s, p.t, p.v, np1, b && GW > 0, out);
        memcpy(y + ((size_t)key * m + base + j) * 16, out, 16);
      }
    }
  }
}

extern "C" {
// B1 (table null: from the root, party b) or B3 (from the stacked frontier
// table at depth k; b is 1 where party 1 of an additive group negates).
void host_pair_walk(const uint8_t* sbox, const uint8_t* rk, const uint8_t* s0,
                    const uint8_t* cw_s, const uint8_t* cw_v,
                    const uint8_t* cw_t, const uint8_t* cw_np1,
                    const uint8_t* xs, const uint8_t* table, uint8_t* y, int K,
                    int n, int k, int m, int per_key, int b, int gw,
                    long long* computed) {
#define PAIR_ARGS sbox, rk, s0, cw_s, cw_v, cw_t, cw_np1, xs, table, y, K, n, \
      k, m, per_key, b, computed
  if (gw == 0) pair_walk<0>(PAIR_ARGS);
  else if (gw == 8) pair_walk<8>(PAIR_ARGS);
  else if (gw == 16) pair_walk<16>(PAIR_ARGS);
  else pair_walk<32>(PAIR_ARGS);
#undef PAIR_ARGS
}
}
"""


_SLOT_HARNESS = r"""
#include <algorithm>

// Kernel B3 as its warps run it on a grid of `warps` warps, warp g taking
// units g, g + warps, ...: first the units that pair_walks_unit gives the
// pair walk, 64 points at a time through pair_unit (the warp's votes over
// all lanes first; *paired counts their lookups), then its lanes one after
// another (no lane reads another's state), each with its kPrefixSlots
// slots.
// *carried counts the slots' live steps, each a needed block;
// *slot_steps the slot-steps the warps ran, kPrefixSlots x 32 a step of
// the warp's longest lane.
template <int GW>
static void paired_units(const BkLane* lanes, const RoundKey* rks,
                        const SlotWalk& a, SlotUnits u, long long* paired) {
  const int tile = kLanes * kPrefixSlots;
  for (; u.key < a.keys; slot_units_next(a, u)) {
    if (!pair_walks_unit<kPrefixSlots>(a, u.tile)) continue;
    const int lim = std::min((u.tile + 1) * tile, a.m);
    const size_t cw = (size_t)u.key * a.n;
    uint32_t np1[4];
    load16(a.cw_np1 + 16 * (size_t)u.key, np1);
    for (int base = u.tile * tile; base < lim; base += 2 * kLanes) {
      const uint8_t* x[2 * kLanes];
      KlState P[kLanes][2];
      for (int j = 0; j < 2 * kLanes; ++j) {
        x[j] = a.xs + (size_t)std::min(base + j, lim - 1) * a.nb;
        walk_row(P[j % kLanes][j / kLanes],
                 a.table + (((size_t)u.key << a.k) +
                            frontier_index(x[j], a.k)) * 32);
      }
      pair_unit<GW>(lanes, rks, a.cw_s + cw * 16, a.cw_v + cw * 16,
                    a.cw_t + cw * 2, a.k, a.n, x, P, paired);
      for (int j = 0; j < 2 * kLanes && base + j < lim; ++j) {
        const KlState& p = P[j % kLanes][j / kLanes];
        uint32_t out[4];
        finalize<GW>(p.s, p.t, p.v, np1, a.negate, out);
        store16(a.y + ((size_t)u.key * a.m + base + j) * 16, out);
      }
    }
  }
}

template <int GW>
static void slot_grid(const uint8_t* sbox, const uint8_t* rk,
                      const SlotWalk& a, int warps, long long* paired,
                      long long* carried, long long* slot_steps) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey rks[15];
  round_keys(rks, rk);
  BkLane lanes[kLanes];
  for (int l = 0; l < kLanes; ++l) lanes[l] = bk_lane(te.data(), l);
  for (int g = 0; g < warps; ++g) {
    paired_units<GW>(lanes, rks, a, {g / a.tiles, g % a.tiles, warps}, paired);
    long long longest = 0;
    for (int l = 0; l < kLanes; ++l)
      longest = std::max(longest, prefix_slot_walk<GW, kPrefixSlots>(
                                      bk_win(te.data(), l), rks, a, l, g,
                                      warps, carried));
    *slot_steps += (long long)kPrefixSlots * kLanes * longest;
  }
}

extern "C" {
int host_prefix_slots() { return kPrefixSlots; }

// B3 over K keys' stacked frontier tables at depth k, m shared points, on
// a grid of `warps` warps; negate is party 1 of an additive group.
void host_slot_walk(const uint8_t* sbox, const uint8_t* rk,
                    const uint8_t* table, const uint8_t* cw_s,
                    const uint8_t* cw_v, const uint8_t* cw_t,
                    const uint8_t* cw_np1, const uint8_t* xs, uint8_t* y,
                    int K, int n, int k, int m, int negate, int gw, int warps,
                    long long* paired, long long* carried,
                    long long* slot_steps) {
  const int tile = kLanes * kPrefixSlots, tiles = (m + tile - 1) / tile;
  const SlotWalk a{table, cw_s, cw_v,  cw_t, cw_np1,      xs,   y,
                   n,     n / 8, k,    m,    negate != 0, tiles, K};
#define SLOT_ARGS sbox, rk, a, warps, paired, carried, slot_steps
  if (gw == 0) slot_grid<0>(SLOT_ARGS);
  else if (gw == 8) slot_grid<8>(SLOT_ARGS);
  else if (gw == 16) slot_grid<16>(SLOT_ARGS);
  else slot_grid<32>(SLOT_ARGS);
#undef SLOT_ARGS
}
}
"""


_WALK32_HARNESS = r"""
// Kernel E1: the points of one key on lane pt % 32 of warp pt / 32 (shared
// by all keys, or the key's own with per_key), slot C run at a level where
// any point of the warp turns right; all3 runs it at every level.
template <int GW>
static void walk32(const uint8_t* sbox, const uint8_t* rk0,
                   const uint8_t* rk17, const uint8_t* s0,
                   const uint8_t* cw_s, const uint8_t* cw_v,
                   const uint8_t* cw_t, const uint8_t* np1, const uint8_t* xs,
                   uint8_t* y, int K, int n, int m, int per_key, int b,
                   int all3) {
  std::vector<uint32_t> te;
  banked_table(te, sbox);
  RoundKey k0[15], k17[15];
  round_keys(k0, rk0);
  round_keys(k17, rk17);
  std::vector<NarrowCw> cw(n);
  for (int key = 0; key < K; ++key) {
    const uint8_t* xk = xs + (per_key ? (size_t)key * m : 0) * (n / 8);
    std::vector<uint8_t> any((size_t)(m / kLanes + 1) * n, (uint8_t)all3);
    for (int pt = 0; pt < m; ++pt)
      for (int i = 0; i < n; ++i)
        any[(size_t)(pt / kLanes) * n + i] |=
            walk_bit(xk + (size_t)pt * (n / 8), i);
    for (int i = 0; i < n; ++i)
      narrow_cw_entry(cw.data(), cw_s + (size_t)key * n * 32,
                      cw_v + (size_t)key * n * 32, cw_t + (size_t)key * n * 2,
                      i);
    uint32_t sw[8], fw[8], out[8];
    words8(s0 + key * 32, sw);
    words8(np1 + key * 32, fw);
    for (int pt = 0; pt < m; ++pt) {
      walk32_point_banked<GW>(
          bk_lane(te.data(), pt % kLanes), k0, k17, cw.data(), n, sw,
          (uint32_t)b, fw, xk + (size_t)pt * (n / 8),
          LevelVote{any.data() + (size_t)(pt / kLanes) * n}, out);
      memcpy(y + ((size_t)key * m + pt) * 32, out, 32);
    }
  }
}

extern "C" {
void host_walk32(const uint8_t* sbox, const uint8_t* rk0, const uint8_t* rk17,
                 const uint8_t* s0, const uint8_t* cw_s, const uint8_t* cw_v,
                 const uint8_t* cw_t, const uint8_t* np1, const uint8_t* xs,
                 uint8_t* y, int K, int n, int m, int per_key, int b, int gw,
                 int all3) {
  DISPATCH(walk32, sbox, rk0, rk17, s0, cw_s, cw_v, cw_t, np1, xs, y, K, n,
           m, per_key, b, all3)
}
}
"""


_PIR_HARNESS = r"""
#include "pir_answer.cuh"

// Kernel P1 as its warps run it: for each column group of TPR lanes and
// each tile of 32 rows, the K selection words of the tile, then every
// lane's passes folded into that lane's accumulators (pir_row_in_tile,
// pir_fold); the lanes of a column XORed together last, as the shuffles
// and the block fold do.  out [K, R] zeroed; KK keys a pass.
template <int VEC, int TPR, int KK>
static void pir_lanes(const uint32_t* t_words, const uint8_t* db,
                      uint8_t* out, int k_num, long long n_rows, int cols) {
  constexpr int W = VEC / 4;
  const long long n_words = (n_rows + 31) / 32;
  for (int key0 = 0; key0 < k_num; key0 += KK)
    for (int g = 0; g * TPR < cols; ++g) {
      std::vector<uint32_t> acc(32 * KK * W, 0u);
      for (long long tile = 0; tile < n_words; ++tile) {
        uint32_t w[KK];
        for (int k = 0; k < KK; ++k)
          w[k] = key0 + k < k_num ? t_words[(key0 + k) * n_words + tile] : 0u;
        for (int lane = 0; lane < 32; ++lane) {
          const int col = g * TPR + lane % TPR;
          for (int p = 0; p < TPR; ++p) {
            const int pos = pir_row_in_tile<TPR>(lane, p);
            const long long row = tile * 32 + pos;
            if (col >= cols || row >= n_rows) continue;
            uint32_t x[W];
            memcpy(x, db + row * cols * VEC + (size_t)col * VEC, VEC);
            pir_fold<KK, W>(
                reinterpret_cast<uint32_t(*)[W]>(&acc[(size_t)lane * KK * W]),
                w, pos, x);
          }
        }
      }
      for (int lane = 0; lane < 32; ++lane) {
        const int col = g * TPR + lane % TPR;
        for (int k = 0; k < KK && key0 + k < k_num && col < cols; ++k)
          for (int q = 0; q < W; ++q) {
            const uint32_t v = acc[((size_t)lane * KK + k) * W + q];
            uint8_t* o = out + (size_t)(key0 + k) * cols * VEC + col * VEC + 4 * q;
            for (int j = 0; j < 4; ++j) o[j] ^= (uint8_t)(v >> (8 * j));
          }
      }
    }
}

template <int VEC, int KK>
static void pir_cols(const uint32_t* t_words, const uint8_t* db, uint8_t* out,
                     int k_num, long long n_rows, int cols) {
  if (cols <= 1) pir_lanes<VEC, 1, KK>(t_words, db, out, k_num, n_rows, cols);
  else if (cols <= 2) pir_lanes<VEC, 2, KK>(t_words, db, out, k_num, n_rows, cols);
  else if (cols <= 4) pir_lanes<VEC, 4, KK>(t_words, db, out, k_num, n_rows, cols);
  else if (cols <= 8) pir_lanes<VEC, 8, KK>(t_words, db, out, k_num, n_rows, cols);
  else if (cols <= 16) pir_lanes<VEC, 16, KK>(t_words, db, out, k_num, n_rows, cols);
  else pir_lanes<VEC, 32, KK>(t_words, db, out, k_num, n_rows, cols);
}

extern "C" {
// P1's lanes as its C entry point dispatches them: 16-byte chunks where
// r % 16 == 0, else 4-byte ones; 4 keys a pass up to K = 4, else 8.
void host_pir_answer(const uint32_t* t_words, const uint8_t* db,
                     uint8_t* out, int k_num, long long n_rows, int r) {
  if (r % 16 == 0) {
    if (k_num <= 4) pir_cols<16, 4>(t_words, db, out, k_num, n_rows, r / 16);
    else pir_cols<16, 8>(t_words, db, out, k_num, n_rows, r / 16);
  } else {
    if (k_num <= 4) pir_cols<4, 4>(t_words, db, out, k_num, n_rows, r / 4);
    else pir_cols<4, 8>(t_words, db, out, k_num, n_rows, r / 4);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel arithmetic")
    d = tmp_path_factory.mktemp("csrc")
    src = d / "harness.cpp"
    src.write_text(_HARNESS + _NARROW_HARNESS + _BANKED_HARNESS
                   + _KEYGEN_HARNESS + _TREE_HARNESS + _BANKED_NARROW_HARNESS
                   + _PAIR_HARNESS + _SLOT_HARNESS + _PIR_HARNESS
                   + _WALK32_HARNESS)
    out = d / "libharness.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(out), str(src)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


def _setup(seed, k_num, n_bytes, group, bound):
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    bundle = gen_batch(prg, alphas,
                       rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
                       random_s0s(k_num, 16, rng), bound, group=group)
    return rng, prg, expand_key_np(ck[0]), alphas, bundle


@pytest.mark.parametrize("n_bytes", [2, 16])
@pytest.mark.parametrize("group", GROUPS)
def test_walk_body_matches_oracle(lib, group, n_bytes):
    gw = GROUP_WIDTH.get(group, 0)
    k_num, m = 2, 24
    # Both bounds on the short domain; one on the 128-level one, where the
    # numpy oracle is slow.
    for bound in (Bound if n_bytes == 2 else (Bound.GT_BETA,)):
        rng, prg, rk, alphas, bundle = _setup(
            200 + n_bytes + GROUPS.index(group), k_num, n_bytes, group, bound)
        shared = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
        shared[:k_num] = alphas
        per_key = rng.integers(0, 256, (k_num, m, n_bytes), dtype=np.uint8)
        per_key[:, 0] = alphas
        for xs in (shared, per_key):
            for b in (0, 1):
                kb = bundle.for_party(b)
                y = np.zeros((k_num, m, 16), np.uint8)
                lib.host_walk(_p(SBOX_NP), _p(rk),
                              _p(np.ascontiguousarray(kb.s0s[:, 0])),
                              _p(kb.cw_s), _p(kb.cw_v), _p(kb.cw_t),
                              _p(kb.cw_np1), _p(xs), _p(y), k_num,
                              8 * n_bytes, m, int(xs.ndim == 3), b, gw)
                assert np.array_equal(y, eval_batch_np(prg, b, kb, xs)), \
                    (bound, b, xs.ndim)


@pytest.mark.parametrize("group", GROUPS)
def test_tree_and_prefix_bodies_match_oracle(lib, group):
    gw = GROUP_WIDTH.get(group, 0)
    k_num, n_bytes, k0, k, m = 2, 2, 5, 8, 24
    for bound in Bound:
        rng, prg, rk, alphas, bundle = _setup(
            220 + GROUPS.index(group), k_num, n_bytes, group, bound)
        xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
        xs[:k_num] = alphas
        for b in (0, 1):
            kb = bundle.for_party(b)
            rows = []
            for key in range(k_num):
                one = KeyBundle(kb.s0s[key:key + 1], kb.cw_s[key:key + 1],
                                kb.cw_v[key:key + 1], kb.cw_t[key:key + 1],
                                kb.cw_np1[key:key + 1], group=group)
                s, v, t = tree_expand_np(prg, one, b, k0)
                for lvl in range(k0, k):
                    n_par = s.shape[0]
                    so = np.zeros((2 * n_par, 16), np.uint8)
                    vo = np.zeros((2 * n_par, 16), np.uint8)
                    to = np.zeros(2 * n_par, np.uint8)
                    lib.host_tree(
                        _p(SBOX_NP), _p(rk),
                        _p(np.ascontiguousarray(one.cw_s[0, lvl])),
                        _p(np.ascontiguousarray(one.cw_v[0, lvl])),
                        _p(np.ascontiguousarray(one.cw_t[0, lvl])),
                        _p(np.ascontiguousarray(s)),
                        _p(np.ascontiguousarray(v)),
                        _p(np.ascontiguousarray(t)), _p(so), _p(vo), _p(to),
                        n_par, gw)
                    s, v, t = so, vo, to
                for got, want in zip((s, v, t),
                                     tree_expand_np(prg, one, b, k)):
                    assert np.array_equal(got, want), (bound, b, key)
                stashed = s.copy()
                stashed[:, 15] |= t
                rows.append(np.concatenate([stashed, v], axis=1))
            table = np.ascontiguousarray(np.concatenate(rows))
            y = np.zeros((k_num, m, 16), np.uint8)
            lib.host_prefix(_p(SBOX_NP), _p(rk), _p(table), _p(kb.cw_s),
                            _p(kb.cw_v), _p(kb.cw_t), _p(kb.cw_np1), _p(xs),
                            _p(y), k_num, 8 * n_bytes, k, m,
                            int(b and gw > 0), gw)
            assert np.array_equal(y, eval_batch_np(prg, b, kb, xs)), \
                (bound, b)



@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("group", GROUPS)
def test_tree_subtree_body_matches_oracle(lib, group, depth):
    """B2's banked body expanding ``depth`` levels in registers (parent j
    on lane j % 32), from the host expansion at every level L with
    L + depth <= n = 8: the 2^depth N nodes land at rows j + N r (r the
    directions, LSB first), equal to tree_expand_np at depth L + depth and
    to ``depth`` levels of tree_expand_level_plain; both bounds, both
    parties."""
    from dcf_tpu_torch.ops.tree_expand import tree_expand_level_plain
    from dcf_tpu_torch.ops.walk_eval import aes_image

    gw = GROUP_WIDTH.get(group, 0)
    n = 8
    for bound in Bound:
        seed = (240 + 8 * depth + 2 * GROUPS.index(group)
                + (bound == Bound.GT_BETA))
        _, prg, rk, _, bundle = _setup(seed, 1, n // 8, group, bound)
        aes = torch.from_numpy(aes_image(
            np.random.default_rng(seed).bytes(32)))  # _setup's cipher 0
        for b in (0, 1):
            kb = bundle.for_party(b)
            cws = [np.ascontiguousarray(a[0]) for a in (kb.cw_s, kb.cw_v,
                                                        kb.cw_t)]
            for lvl in range(0, n - depth + 1):
                s, v, t = tree_expand_np(prg, kb, b, lvl)
                n_out = s.shape[0] << depth
                so = np.zeros((n_out, 16), np.uint8)
                vo = np.zeros((n_out, 16), np.uint8)
                to = np.full(n_out, 7, np.uint8)
                lib.host_tree_levels(
                    _p(SBOX_NP), _p(rk), *(_p(a) for a in cws),
                    _p(np.ascontiguousarray(s)), _p(np.ascontiguousarray(v)),
                    _p(np.ascontiguousarray(t)), _p(so), _p(vo), _p(to),
                    s.shape[0], lvl, depth, gw)
                for got, want in zip((so, vo, to),
                                     tree_expand_np(prg, kb, b, lvl + depth)):
                    assert np.array_equal(got, want), (bound, b, lvl)
                st = tuple(torch.from_numpy(np.ascontiguousarray(a))
                           for a in (s, v, t))
                for i in range(lvl, lvl + depth):
                    st = tree_expand_level_plain(
                        aes, *(torch.from_numpy(a[i]) for a in cws), *st,
                        group=group)
                for got, want in zip((so, vo, to), st):
                    assert np.array_equal(got, want.numpy()), (bound, b, lvl)


def _large_setup(seed, lam, k_num, n_bytes, bound):
    """A lam >= 48 bundle from the port's keygen, with x = alpha and
    alpha +- 1 planted among the points (per key)."""
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]
    prg = HirosePrgNp(lam, ck)
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    bundle = gen_batch(prg, alphas,
                       rng.integers(0, 256, (k_num, lam), dtype=np.uint8),
                       random_s0s(k_num, lam, rng), bound)
    xs = rng.integers(0, 256, (24, n_bytes), dtype=np.uint8)
    top = 1 << (8 * n_bytes)
    for j, a in enumerate(alphas):
        a = int.from_bytes(a.tobytes(), "big")
        for d in (-1, 0, 1):
            xs[3 * j + d + 1] = np.frombuffer(
                ((a + d) % top).to_bytes(n_bytes, "big"), np.uint8)
    return ck, prg, bundle, xs, narrow_aes_image(ck[0], ck[17])


def _narrow_arrays(kb):
    return [np.ascontiguousarray(a) for a in (
        kb.s0s[:, 0, :32], kb.cw_s[..., :32], kb.cw_v[..., :32], kb.cw_t,
        kb.cw_np1[:, :32])]


def _traj_bits(words: np.ndarray, n1: int) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :n1]


def _wide(lib, kb, traj, m):
    const, w = wide_affine_batch_np(kb)
    k_num, n1, wd = w.shape
    y = np.zeros((k_num, m, wd), np.uint8)
    lib.host_wide(_p(traj), _p(np.ascontiguousarray(w)),
                  _p(np.ascontiguousarray(const)), _p(y), k_num, n1,
                  traj.shape[-1], wd // 4, m)
    return y


@pytest.mark.parametrize("lam,n_bytes", [(48, 2), (144, 4), (144, 16)])
def test_narrow_walk_and_wide_bodies_match_oracle(lib, lam, n_bytes):
    """B4's body (the unmasked two-cipher step, its n+1-bit trajectory)
    against narrow_walk_np, and W1's body over that trajectory against
    wide_affine_batch_np: together the full-width oracle.  n = 16, 32, 128
    put the final bit inside a word, at bit 0 of a fresh word and after
    four full words."""
    k_num, n = 2, 8 * n_bytes
    rk = expand_key_np
    for bound in (Bound if n_bytes < 16 else (Bound.LT_BETA,)):
        ck, prg, bundle, xs, aes = _large_setup(
            300 + lam + n_bytes, lam, k_num, n_bytes, bound)
        m, tw = xs.shape[0], -(-(n + 1) // 32)
        for b in (0, 1):
            kb = bundle.for_party(b)
            s0, cs, cv, ct, np1 = _narrow_arrays(kb)
            y32 = np.zeros((k_num, m, 32), np.uint8)
            traj = np.zeros((k_num, m, tw), np.uint32)
            lib.host_narrow(_p(SBOX_NP), _p(rk(ck[0])), _p(rk(ck[17])),
                            _p(s0), _p(cs), _p(cv), _p(ct), _p(np1), _p(xs),
                            _p(y32), _p(traj), k_num, n, m, tw, b, 0)
            for key in range(k_num):
                one = KeyBundle(*(a[key:key + 1] for a in (
                    kb.s0s, kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)))
                want_y, want_t = narrow_walk_np(ck, one, b, xs)
                assert np.array_equal(y32[key], want_y), (bound, b, key)
                assert np.array_equal(_traj_bits(traj[key], n + 1),
                                      want_t), (bound, b, key)
            got = np.concatenate([y32, _wide(lib, kb, traj, m)], axis=-1)
            assert np.array_equal(got, eval_batch_np(prg, b, kb, xs)), \
                (bound, b)


def _random_traj(rng, k_num, m, n1):
    """Random packed trajectories uint8 [K, m, traj_bytes(n1)], the bits
    past n1 random too: the table body must not read them."""
    from dcf_tpu_torch.ops.narrow_walk import traj_bytes

    return rng.integers(0, 256, (k_num, m, traj_bytes(n1)), dtype=np.uint8)


def _wide_want(traj, const, w):
    """y[32:] = const ^ XOR of the rows of w whose trajectory bit is set
    (numpy), and the same through ``wide_tail_plain``."""
    from dcf_tpu_torch.ops.wide_tail import wide_tail_plain

    k_num, n1, wd = w.shape
    bits = _traj_bits(traj.view(np.uint32), n1)
    want = np.broadcast_to(const[:, None, :],
                           (k_num, traj.shape[1], wd)).copy()
    for j in range(n1):
        want ^= w[:, j, None, :] * bits[:, :, j, None]
    y = torch.zeros((k_num, traj.shape[1], 32 + wd), dtype=torch.uint8)
    plain = wide_tail_plain(y, *(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (traj, const, w)))
    assert np.array_equal(plain[..., 32:].numpy(), want)
    return want


@pytest.mark.parametrize("k_num", [1, 3])
@pytest.mark.parametrize("n_bytes", [2, 4, 5, 16])
@pytest.mark.parametrize("lam", [48, 144, 256])
def test_wide_table_body_matches_oracle(lib, lam, n_bytes, k_num):
    """W1's table build and lookup (``wide_table_entry``, ``wide_chunk``)
    over every column tile, on the const and W of real keys
    (``wide_affine_batch_np``) and random trajectories with random bits
    past n + 1, against the XOR of the selected rows and
    ``wide_tail_plain``.  n + 1 = 17, 33, 41, 129: the last group of five
    holds two, three, one and four bits, and the trajectory crosses one,
    one and four word boundaries, groups straddling them."""
    n1 = 8 * n_bytes + 1
    ck, _, bundle, _, _ = _large_setup(400 + lam + n_bytes + k_num, lam,
                                       k_num, n_bytes, Bound.LT_BETA)
    const, w = wide_affine_batch_np(bundle.for_party(1))
    rng = np.random.default_rng(lam + n_bytes)
    m = 37
    traj = _random_traj(rng, k_num, m, n1)
    y = np.zeros((k_num, m, lam - 32), np.uint8)
    lib.host_wide(_p(traj), _p(np.ascontiguousarray(w)),
                  _p(np.ascontiguousarray(const)), _p(y), k_num, n1,
                  traj.shape[-1] // 4, (lam - 32) // 4, m)
    assert np.array_equal(y, _wide_want(traj, const, w))


@pytest.mark.parametrize("tile", [0, 63])
def test_wide_table_body_crate_tile(lib, tile):
    """W1's body at the reference crate's lam = 16384 (1022 chunks of 16
    bytes, tiles of 16): the first column tile and the last, partial one
    (14 chunks), K = 2, n + 1 = 129, random const and W, against
    ``wide_tail_plain`` on those columns."""
    lam, n1, k_num, m, cols = 16384, 129, 2, 9, 16
    wd = lam - 32
    rng = np.random.default_rng(410 + tile)
    const = rng.integers(0, 256, (k_num, wd), dtype=np.uint8)
    w = rng.integers(0, 256, (k_num, n1, wd), dtype=np.uint8)
    traj = _random_traj(rng, k_num, m, n1)
    y = np.zeros((k_num, m, wd), np.uint8)
    lib.host_wide_tiles(_p(traj), _p(w), _p(const), _p(y), k_num, n1,
                        traj.shape[-1] // 4, wd // 16, m, cols, tile,
                        tile + 1)
    cut = slice(16 * cols * tile, min(wd, 16 * cols * (tile + 1)))
    want = _wide_want(traj, const, w)
    assert np.array_equal(y[..., cut], want[..., cut])
    assert not y[..., :cut.start].any() and not y[..., cut.stop:].any()


def _host_frontier(lib, ck, s0, cs, cv, ct, k, b):
    """Party b's frontier at depth k built by B5a's body, one host call per
    launch of ``frontier_launches(k)`` as the wrapper launches the kernel;
    rows and words start as garbage, so a node left unwritten shows."""
    k_num, n = cs.shape[:2]
    rows = np.full((k_num << k, 64), 0xA5, np.uint8)
    words = np.full(k_num << k, 0xA5A5A5A5, np.uint32)
    top, depths = frontier_launches(k)
    args = (_p(SBOX_NP), _p(expand_key_np(ck[0])), _p(expand_key_np(ck[17])),
            _p(s0), _p(cs), _p(cv), _p(ct), _p(rows), _p(words), k_num, n, k)
    lib.host_frontier(*args, top, 0, 0, b)
    level = top
    for depth in depths:
        lib.host_frontier(*args, 0, level, depth, b)
        level += depth
    return rows, words


def test_frontier_and_hybrid_prefix_bodies_match_oracle(lib):
    """B5a's body against the plain frontier build, and B5b's (gather,
    levels k..n-1, top-k gates from the word) + W1's against the
    full-width oracle."""
    lam, k_num, n_bytes, k = 144, 2, 2, 6
    n = 8 * n_bytes
    rk = expand_key_np
    for bound in Bound:
        ck, prg, bundle, xs, aes = _large_setup(320, lam, k_num, n_bytes,
                                                bound)
        m, tw = xs.shape[0], -(-(n + 1) // 32)
        for b in (0, 1):
            kb = bundle.for_party(b)
            s0, cs, cv, ct, np1 = _narrow_arrays(kb)
            rows, words = _host_frontier(lib, ck, s0, cs, cv, ct, k, b)
            want_rows, want_words = narrow_frontier_plain(
                *(torch.from_numpy(a) for a in (aes, s0, cs, cv, ct)),
                k=k, b=b)
            assert np.array_equal(rows, want_rows.numpy()), (bound, b)
            assert np.array_equal(words.view(np.uint8).reshape(-1, 4),
                                  want_words.numpy()), (bound, b)
            y32 = np.zeros((k_num, m, 32), np.uint8)
            traj = np.zeros((k_num, m, tw), np.uint32)
            lib.host_hybrid_prefix(_p(SBOX_NP), _p(rk(ck[0])),
                                   _p(rk(ck[17])), _p(rows), _p(words),
                                   _p(cs), _p(cv), _p(ct), _p(np1), _p(xs),
                                   _p(y32), _p(traj), k_num, n, k, m, tw)
            got = np.concatenate([y32, _wide(lib, kb, traj, m)], axis=-1)
            assert np.array_equal(got, eval_batch_np(prg, b, kb, xs)), \
                (bound, b)


@pytest.mark.parametrize("k", [1, 5, 6, 9, 11, 12, 13])
def test_frontier_body_level_by_level(lib, k):
    """B5a's body as its launches run it (frontier_launches): the top
    launch alone (k <= 10), then one level (k = 11), two in registers
    (12), and one then two (13), each in place over the rows of the last.
    K = 3 keys, both bounds, both parties: rows and words equal the plain
    frontier build's."""
    lam, k_num, n_bytes = 48, 3, 2
    for bound in Bound:
        ck, _, bundle, _, aes = _large_setup(330 + k, lam, k_num, n_bytes,
                                             bound)
        for b in (0, 1):
            s0, cs, cv, ct, _ = _narrow_arrays(bundle.for_party(b))
            rows, words = _host_frontier(lib, ck, s0, cs, cv, ct, k, b)
            want_rows, want_words = narrow_frontier_plain(
                *(torch.from_numpy(a) for a in (aes, s0, cs, cv, ct)),
                k=k, b=b)
            assert np.array_equal(rows, want_rows.numpy()), (bound, b)
            assert np.array_equal(words.view(np.uint8).reshape(-1, 4),
                                  want_words.numpy()), (bound, b)


@pytest.mark.parametrize("k_num", [1, 3])
def test_dpf_node_body_matches_oracle(lib, k_num):
    """B6's body, level by level from the host frontier at k0 = 3 to the
    leaves of an n = 8 key and to a prefix depth 6, against the numpy
    expansion under the masked lam = 32 PRG: seeds and t bits of every
    level, and the leaf shares of the last."""
    from dcf_tpu_torch.backends.evalall import (
        dpf_finalize_np, dpf_tree_expand_np)
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch

    rng = np.random.default_rng(340 + k_num)
    ck = [rng.bytes(32) for _ in range(18)]
    prg = HirosePrgNp(32, ck, warn=False)
    n, k0 = 8, 3
    bundle = dpf_gen_batch(
        prg, rng.integers(0, 256, (k_num, 1), dtype=np.uint8),
        rng.integers(0, 256, (k_num, 32), dtype=np.uint8),
        random_s0s(k_num, 32, rng))
    rk = expand_key_np
    for b in (0, 1):
        kb = bundle.for_party(b)
        for depth in (n, 6):
            s, t = dpf_tree_expand_np(prg, kb, b, k0)
            for lvl in range(k0, depth):
                n_par = s.shape[1]
                last = lvl == depth - 1
                so = np.zeros((k_num, 2 * n_par, 32), np.uint8)
                to = np.zeros((k_num, 2 * n_par), np.uint8)
                lib.host_dpf_levels(
                    _p(SBOX_NP), _p(rk(ck[0])), _p(rk(ck[17])), _p(kb.cw_s),
                    _p(kb.cw_t), _p(kb.cw_np1) if last else None,
                    _p(np.ascontiguousarray(s)), _p(np.ascontiguousarray(t)),
                    _p(so), _p(to), k_num, n_par, n, lvl, 1)
                want_s, want_t = dpf_tree_expand_np(prg, kb, b, lvl + 1)
                if last:
                    want_s = dpf_finalize_np(kb, want_s, want_t)
                assert np.array_equal(so, want_s), (b, depth, lvl)
                assert np.array_equal(to, want_t), (b, depth, lvl)
                s, t = so, to


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """uint8 0/1 [K, N] -> uint32 [K, ceil(N / 32)], bit i of word w the
    entry 32 w + i (the reference's pack_lanes, N padded with zeros)."""
    k_num, n = bits.shape
    padded = np.zeros((k_num, -(-n // 32) * 32), np.uint32)
    padded[:, :n] = bits & 1
    return np.bitwise_or.reduce(
        padded.reshape(k_num, -1, 32) << np.arange(32, dtype=np.uint32), -1)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_dpf_subtree_body_matches_oracle(lib, depth):
    """B6's banked body expanding ``depth`` levels in registers (parent j
    on lane j % 32): from the host frontier at k0 = 2 of n = 8 keys,
    every launch start L with L + depth <= 8, K = 3, both parties, against
    the numpy expansion at depth L + depth: the nodes land at rows
    j + 2^L * r (r the directions, LSB first), seeds and t bits, and the
    leaf shares where L + depth = n."""
    from dcf_tpu_torch.backends.evalall import (
        dpf_finalize_np, dpf_tree_expand_np)
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch

    k_num, n, k0 = 3, 8, 2
    rng = np.random.default_rng(350 + depth)
    ck = [rng.bytes(32) for _ in range(18)]
    prg = HirosePrgNp(32, ck, warn=False)
    bundle = dpf_gen_batch(
        prg, rng.integers(0, 256, (k_num, 1), dtype=np.uint8),
        rng.integers(0, 256, (k_num, 32), dtype=np.uint8),
        random_s0s(k_num, 32, rng))
    rk = expand_key_np
    for b in (0, 1):
        kb = bundle.for_party(b)
        for lvl in range(k0, n - depth + 1):
            s, t = dpf_tree_expand_np(prg, kb, b, lvl)
            n_par = s.shape[1]
            last = lvl + depth == n
            so = np.zeros((k_num, n_par << depth, 32), np.uint8)
            to = np.zeros((k_num, n_par << depth), np.uint8)
            lib.host_dpf_levels(
                _p(SBOX_NP), _p(rk(ck[0])), _p(rk(ck[17])), _p(kb.cw_s),
                _p(kb.cw_t), _p(kb.cw_np1) if last else None,
                _p(np.ascontiguousarray(s)), _p(np.ascontiguousarray(t)),
                _p(so), _p(to), k_num, n_par, n, lvl, depth)
            want_s, want_t = dpf_tree_expand_np(prg, kb, b, lvl + depth)
            if last:
                want_s = dpf_finalize_np(kb, want_s, want_t)
            assert np.array_equal(so, want_s), (b, lvl)
            assert np.array_equal(to, want_t), (b, lvl)
            if last:  # the PIR selection: the leaves' t bits alone, packed
                words = np.zeros((k_num, -(-(n_par << depth) // 32)),
                                 np.uint32)
                lib.host_dpf_levels(
                    _p(SBOX_NP), _p(rk(ck[0])), _p(rk(ck[17])),
                    _p(kb.cw_s), _p(kb.cw_t), _p(kb.cw_np1),
                    _p(np.ascontiguousarray(s)),
                    _p(np.ascontiguousarray(t)), None, _p(words), k_num,
                    n_par, n, lvl, depth)
                assert np.array_equal(words, _pack_bits(want_t)), (b, lvl)


@pytest.mark.parametrize("bound", list(Bound))
def test_tree_leaves_body_matches_oracle(lib, bound):
    """B2f's body: the last level of an n = 16 XOR key from the host
    expansion at depth 15, against the numpy oracle's shares over the
    whole domain (leaf p holds domain value bitreverse_16(p))."""
    rng, prg, rk, alphas, bundle = _setup(360, 1, 2, "xor", bound)
    n = 16
    pos = np.arange(1 << n)
    value = np.zeros_like(pos)
    for k in range(n):
        value |= ((pos >> k) & 1) << (n - 1 - k)
    xs = np.stack([value >> 8, value & 0xFF], axis=1).astype(np.uint8)
    for b in (0, 1):
        kb = bundle.for_party(b)
        s, v, t = tree_expand_np(prg, kb, b, n - 1)
        y = np.zeros((1 << n, 16), np.uint8)
        lib.host_tree_final(
            _p(SBOX_NP), _p(rk), _p(np.ascontiguousarray(kb.cw_s[0, n - 1])),
            _p(np.ascontiguousarray(kb.cw_v[0, n - 1])),
            _p(np.ascontiguousarray(kb.cw_t[0, n - 1])),
            _p(np.ascontiguousarray(kb.cw_np1[0])),
            _p(np.ascontiguousarray(s)), _p(np.ascontiguousarray(v)),
            _p(np.ascontiguousarray(t)), _p(y), s.shape[0])
        assert np.array_equal(y, eval_batch_np(prg, b, kb, xs)[0]), b


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("bound", list(Bound))
def test_banked_tree_leaves_body_matches_oracle(lib, bound, depth):
    """B2f's banked body (tree_subtree's FINAL case, parent j on lane
    j % 32): the last ``depth`` levels of an n = 16 XOR key from the host
    expansion at depth 16 - depth, both parties, against the leaf shares
    of the numpy tree expansion to depth 16 (which
    ``test_tree_leaves_body_matches_oracle`` ties to the per-point
    oracle), and at depth 1 against the T-table body
    (``host_tree_final``)."""
    rng, prg, rk, alphas, bundle = _setup(360, 1, 2, "xor", bound)
    n, top = 16, 16 - depth
    cw = [np.ascontiguousarray(a[0, top:n])
          for a in (bundle.cw_s, bundle.cw_v, bundle.cw_t)]
    for b in (0, 1):
        kb = bundle.for_party(b)
        s, v, t = (np.ascontiguousarray(a)
                   for a in tree_expand_np(prg, kb, b, top))
        np1 = np.ascontiguousarray(kb.cw_np1[0])
        y = np.zeros((1 << n, 16), np.uint8)
        lib.host_tree_final_levels(
            _p(SBOX_NP), _p(rk), *(_p(a) for a in cw), _p(np1), _p(s),
            _p(v), _p(t), _p(y), s.shape[0], depth)
        ls, lv, lt = tree_expand_np(prg, kb, b, n)
        assert np.array_equal(y, lv ^ ls ^ (np1 & (lt[:, None] * 0xFF))), b
        if depth == 1:
            y1 = np.zeros_like(y)
            lib.host_tree_final(
                _p(SBOX_NP), _p(rk), *(_p(a) for a in cw), _p(np1), _p(s),
                _p(v), _p(t), _p(y1), s.shape[0])
            assert np.array_equal(y, y1), b


@pytest.mark.parametrize("r,k_num,n_rows", [
    (4, 1, 1), (4, 3, 100), (8, 4, 64), (32, 4, 1024), (36, 9, 512),
    (48, 5, 96), (528, 2, 40), (1024, 1, 33)])
def test_pir_fold_body_matches_numpy(lib, r, k_num, n_rows):
    """P1's lanes (pir_answer.cuh: a lane's rows of a 32-row tile, the
    fold under one selection word a key and tile) as the kernel's warps
    and its dispatch run them, 16-byte chunks where R % 16 == 0, column
    groups past 32 chunks (R = 528, 1024), a tile past the last row,
    K past a pass of 4 or 8 keys: the XOR of the selected rows."""
    rng = np.random.default_rng(380 + r + k_num)
    db = rng.integers(0, 256, (n_rows, r), dtype=np.uint8)
    sel = rng.integers(0, 2, (k_num, n_rows), dtype=np.uint8)
    out = np.zeros((k_num, r), np.uint8)
    lib.host_pir_answer(_p(_pack_bits(sel)), _p(db), _p(out), k_num,
                        ctypes.c_longlong(n_rows), r)
    want = np.zeros((k_num, r), np.uint8)
    for k in range(k_num):
        for row in np.flatnonzero(sel[k]):
            want[k] ^= db[row]
    assert np.array_equal(out, want)


def _keygen_body(lib, mode, ck, alphas, betas, s0s, lt=True):
    """Run kernel G1's (mode 0), B7a's (1), B7b's (2) or G2's (3) body over
    K keys."""
    k_num, n, lam = alphas.shape[0], 8 * alphas.shape[1], betas.shape[1]
    cw_s = np.zeros((k_num, n, lam), np.uint8)
    cw_v = np.zeros((k_num, n, lam), np.uint8) if mode != 2 else None
    cw_t = np.zeros((k_num, n, 2), np.uint8)
    cw_np1 = np.zeros((k_num, lam), np.uint8)
    traj = np.zeros((k_num, n, 2), np.uint8) if mode == 1 else None
    rk0 = expand_key_np(ck[0])
    lib.host_keygen(
        _p(SBOX_NP), _p(rk0), _p(expand_key_np(ck[17]) if mode else rk0),
        _p(alphas), _p(betas), _p(s0s), _p(cw_s),
        _p(cw_v) if cw_v is not None else None, _p(cw_t), _p(cw_np1),
        _p(traj) if traj is not None else None, k_num, n, lam, int(lt), mode)
    return cw_s, cw_v, cw_t, cw_np1, traj


@pytest.mark.parametrize("k_num", [1, 33])
@pytest.mark.parametrize("lam", [16, 48, 256])
def test_keygen_body_matches_gen_batch(lib, lam, k_num):
    """G1's and B7a's banked bodies, at lam = 16 and lam >= 48 (B7a's
    trajectories completed by the wide tail), give gen_batch's keys byte
    for byte, both bounds, n = 16."""
    from dcf_tpu_torch.ops.keygen_walk import keygen_wide_tail

    rng = np.random.default_rng(380 + lam + k_num)
    ck = [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]
    prg = HirosePrgNp(lam, ck, warn=False)
    alphas = rng.integers(0, 256, (k_num, 2), dtype=np.uint8)
    alphas[0] = (0, 0) if k_num > 1 else alphas[0]
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    s0s = random_s0s(k_num, lam, rng)
    mode = 0 if lam == 16 else 1
    for bound in Bound:
        lt = bound is Bound.LT_BETA
        cw_s, cw_v, cw_t, cw_np1, traj = _keygen_body(lib, mode, ck, alphas,
                                                      betas, s0s, lt)
        if mode == 1:
            t = [torch.from_numpy(a) for a in (cw_s, cw_v, cw_np1, traj,
                                               alphas, betas, s0s)]
            keygen_wide_tail(*t, lt=lt)
        want = gen_batch(prg, alphas, betas, s0s, bound)
        for name, got in (("cw_s", cw_s), ("cw_v", cw_v), ("cw_t", cw_t),
                          ("cw_np1", cw_np1)):
            assert np.array_equal(got, getattr(want, name)), (bound, name)


def test_banked_keygen_body_at_full_depth(lib):
    """G1's banked body at the main path's depth, n = 128, over K = 33
    keys (lanes 0-31 and a partial warp of one): gen_batch's keys byte for
    byte, both bounds."""
    rng = np.random.default_rng(385)
    ck = [rng.bytes(32), rng.bytes(32)]
    k_num = 33
    alphas = rng.integers(0, 256, (k_num, 16), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, 16), dtype=np.uint8)
    s0s = random_s0s(k_num, 16, rng)
    for bound in Bound:
        cw_s, cw_v, cw_t, cw_np1, _ = _keygen_body(
            lib, 0, ck, alphas, betas, s0s, bound is Bound.LT_BETA)
        want = gen_batch(HirosePrgNp(16, ck), alphas, betas, s0s, bound)
        for name, got in (("cw_s", cw_s), ("cw_v", cw_v), ("cw_t", cw_t),
                          ("cw_np1", cw_np1)):
            assert np.array_equal(got, getattr(want, name)), (bound, name)


def _wide_tail_body(lib, cw_s, cw_v, cw_np1, traj, alphas, betas, s0s, lt):
    """Run kernel W2's body over every (key, column) of B7a's outputs, on
    copies; returns the completed (cw_s, cw_v, cw_np1)."""
    k_num, n, lam = cw_s.shape
    cw_s, cw_v, cw_np1 = cw_s.copy(), cw_v.copy(), cw_np1.copy()
    lib.host_wide_tail(_p(alphas), _p(betas), _p(s0s), _p(traj), _p(cw_s),
                       _p(cw_v), _p(cw_np1), k_num, n, lam, int(lt))
    return cw_s, cw_v, cw_np1


@pytest.mark.parametrize("lam,k_num,n", [
    (48, 1, 16), (48, 33, 16), (144, 1, 16), (144, 33, 16), (256, 1, 16),
    (256, 33, 16), (256, 33, 128)])
def test_wide_tail_body_matches_plain_and_gen_batch(lib, lam, k_num, n):
    """W2's body (one 16-byte column a thread: one, seven and fourteen
    columns, the last one masked) on the trajectories of B7a's body equals
    ``keygen_wide_tail_plain`` on the same inputs, and the completed keys
    equal gen_batch's byte for byte, both bounds."""
    from dcf_tpu_torch.ops.keygen_walk import keygen_wide_tail_plain

    rng = np.random.default_rng(1200 + lam + k_num + n)
    ck = [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]
    prg = HirosePrgNp(lam, ck, warn=False)
    alphas = rng.integers(0, 256, (k_num, n // 8), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    s0s = random_s0s(k_num, lam, rng)
    for bound in Bound:
        lt = bound is Bound.LT_BETA
        cw_s, cw_v, cw_t, cw_np1, traj = _keygen_body(lib, 1, ck, alphas,
                                                      betas, s0s, lt)
        got = _wide_tail_body(lib, cw_s, cw_v, cw_np1, traj, alphas, betas,
                              s0s, lt)
        plain = [torch.from_numpy(a.copy()) for a in (cw_s, cw_v, cw_np1)]
        keygen_wide_tail_plain(*plain, *(torch.from_numpy(a) for a in (
            traj, alphas, betas, s0s)), lt=lt)
        want = gen_batch(prg, alphas, betas, s0s, bound)
        for name, g_, p_ in zip(("cw_s", "cw_v", "cw_np1"), got, plain):
            assert np.array_equal(g_, p_.numpy()), (bound, name)
            assert np.array_equal(g_, getattr(want, name)), (bound, name)
        assert np.array_equal(cw_t, want.cw_t), bound


def test_banked_narrow_keygen_body_at_full_depth(lib):
    """B7a's banked body at the main path's depth and width, lam = 256,
    n = 128, over K = 33 keys (lanes 0-31 and a partial warp of one),
    completed by W2's body: gen_batch's keys byte for byte, both
    bounds."""
    rng = np.random.default_rng(1386)
    lam, k_num = 256, 33
    ck = [rng.bytes(32) for _ in range(2 * (lam // 16))]
    alphas = rng.integers(0, 256, (k_num, 16), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    s0s = random_s0s(k_num, lam, rng)
    for bound in Bound:
        lt = bound is Bound.LT_BETA
        cw_s, cw_v, cw_t, cw_np1, traj = _keygen_body(lib, 1, ck, alphas,
                                                      betas, s0s, lt)
        cw_s, cw_v, cw_np1 = _wide_tail_body(lib, cw_s, cw_v, cw_np1, traj,
                                             alphas, betas, s0s, lt)
        want = gen_batch(HirosePrgNp(lam, ck), alphas, betas, s0s, bound)
        for name, got in (("cw_s", cw_s), ("cw_v", cw_v), ("cw_t", cw_t),
                          ("cw_np1", cw_np1)):
            assert np.array_equal(got, getattr(want, name)), (bound, name)


@pytest.mark.parametrize("k_num", [1, 8])
def test_dpf_keygen_body_matches_dpf_gen_batch(lib, k_num):
    """B7b's banked body gives dpf_gen_batch's lam = 32 keys byte for
    byte."""
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch

    rng = np.random.default_rng(390 + k_num)
    ck = [rng.bytes(32) for _ in range(18)]
    alphas = rng.integers(0, 256, (k_num, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, 32), dtype=np.uint8)
    s0s = random_s0s(k_num, 32, rng)
    cw_s, _, cw_t, cw_np1, _ = _keygen_body(lib, 2, ck, alphas, betas, s0s)
    want = dpf_gen_batch(HirosePrgNp(32, ck, warn=False), alphas, betas, s0s)
    assert np.array_equal(cw_s, want.cw_s)
    assert np.array_equal(cw_t, want.cw_t)
    assert np.array_equal(cw_np1, want.cw_np1)


@pytest.mark.parametrize("n", [8, 24])
@pytest.mark.parametrize("k_num", [1, 33])
def test_banked_dpf_keygen_body_at_depths(lib, k_num, n):
    """B7b's banked body (KgBankedDpf, key j on lane j % 32) at n = 8 and
    at the PIR path's n = 24, over one key and over lanes 0-31 and a
    partial warp: dpf_gen_batch's keys byte for byte, alpha = 0 and the
    all-ones alpha among them."""
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch

    rng = np.random.default_rng(392 + k_num + n)
    ck = [rng.bytes(32) for _ in range(18)]
    alphas = rng.integers(0, 256, (k_num, n // 8), dtype=np.uint8)
    if k_num > 2:
        alphas[1], alphas[2] = 0, 0xFF
    betas = rng.integers(0, 256, (k_num, 32), dtype=np.uint8)
    s0s = random_s0s(k_num, 32, rng)
    cw_s, _, cw_t, cw_np1, _ = _keygen_body(lib, 2, ck, alphas, betas, s0s)
    want = dpf_gen_batch(HirosePrgNp(32, ck, warn=False), alphas, betas, s0s)
    assert np.array_equal(cw_s, want.cw_s)
    assert np.array_equal(cw_t, want.cw_t)
    assert np.array_equal(cw_np1, want.cw_np1)


@pytest.mark.parametrize("n,k_num", [(16, 1), (16, 33), (128, 33)])
def test_dcf32_keygen_body_matches_gen_batch(lib, n, k_num):
    """G2's banked body (KgBankedDcf32: B7a's expansion with the lam = 32
    mask, key j on lane j % 32) gives gen_batch's lam = 32 XOR keys byte
    for byte, both bounds, at n = 16 and at the main path's n = 128, over
    one key and over lanes 0-31 and a partial warp; alpha = 0 and the
    all-ones alpha among them, and root seeds with the mask bit (bit 0 of
    byte 31) set."""
    rng = np.random.default_rng(1400 + n + k_num)
    ck = [rng.bytes(32) for _ in range(18)]
    prg = HirosePrgNp(32, ck, warn=False)
    alphas = rng.integers(0, 256, (k_num, n // 8), dtype=np.uint8)
    if k_num > 2:
        alphas[1], alphas[2] = 0, 0xFF
    betas = rng.integers(0, 256, (k_num, 32), dtype=np.uint8)
    s0s = random_s0s(k_num, 32, rng)
    s0s[::2, :, 31] |= 1
    for bound in Bound:
        cw_s, cw_v, cw_t, cw_np1, _ = _keygen_body(
            lib, 3, ck, alphas, betas, s0s, bound is Bound.LT_BETA)
        want = gen_batch(prg, alphas, betas, s0s, bound)
        for name, got in (("cw_s", cw_s), ("cw_v", cw_v), ("cw_t", cw_t),
                          ("cw_np1", cw_np1)):
            assert np.array_equal(got, getattr(want, name)), (bound, name)


def _walk32_body(lib, ck, kb, xs, b, all3=0):
    """Run kernel E1's body for party b of bundle kb (party-restricted) at
    points xs uint8 [M, nb] (shared) or [K, M, nb] (per key)."""
    k_num, n = kb.cw_s.shape[:2]
    m = xs.shape[-2]
    y = np.zeros((k_num, m, 32), np.uint8)
    lib.host_walk32(
        _p(SBOX_NP), _p(expand_key_np(ck[0])), _p(expand_key_np(ck[17])),
        *(_p(np.ascontiguousarray(a)) for a in (
            kb.s0s[:, 0], kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)),
        _p(np.ascontiguousarray(xs)), _p(y), k_num, n, m, int(xs.ndim == 3),
        b, GROUP_WIDTH.get(kb.group, 0), all3)
    return y


@pytest.mark.parametrize("n_bytes", [2, 16])
@pytest.mark.parametrize("group", GROUPS)
def test_walk32_body_matches_oracle(lib, group, n_bytes):
    """E1's body (walk32_point_banked: B4's three-slot level masked, v in
    the group, point pt on lane pt % 32, slot C by its warp's vote) against
    the numpy oracle at lam = 32: both bounds, both parties, shared and
    per-key points, x = alpha and alpha +- 1 planted, root seeds with the
    mask bit (bit 0 of byte 31) set; at n = 16 bits slot C also forced at
    every level and a warp whose points share their first byte (levels
    where every lane turns left)."""
    k_num = 3
    rng = np.random.default_rng(1450 + 2 * GROUPS.index(group) + n_bytes)
    ck = [rng.bytes(32) for _ in range(18)]
    prg = HirosePrgNp(32, ck, warn=False)
    for bound in Bound:
        alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
        s0s = random_s0s(k_num, 32, rng)
        s0s[1:, :, 31] |= 1
        bundle = gen_batch(prg, alphas,
                           rng.integers(0, 256, (k_num, 32), dtype=np.uint8),
                           s0s, bound, group=group)
        xs = rng.integers(0, 256, (40, n_bytes), dtype=np.uint8)
        top = 1 << (8 * n_bytes)
        for j, a in enumerate(alphas):
            a = int.from_bytes(a.tobytes(), "big")
            for d in (-1, 0, 1):
                xs[3 * j + d + 1] = np.frombuffer(
                    ((a + d) % top).to_bytes(n_bytes, "big"), np.uint8)
        per_key = rng.integers(0, 256, (k_num, 33, n_bytes), dtype=np.uint8)
        per_key[:, 0] = alphas
        cases = [(xs, 0), (per_key, 0)]
        if n_bytes == 2:
            same_top = xs.copy()
            same_top[:32, 0] = 0x5A
            cases += [(xs, 1), (same_top, 0)]
        for b in (0, 1):
            kb = bundle.for_party(b)
            for pts, all3 in cases:
                got = _walk32_body(lib, ck, kb, pts, b, all3)
                want = eval_batch_np(prg, b, kb, pts)
                assert np.array_equal(got, want), (bound, b, pts.ndim, all3)


@pytest.mark.parametrize("n_seeds", [1, 37])
def test_dpf_step_body_matches_node_and_tables(lib, n_seeds):
    """The masked lam = 32 step that B6's node and B7b's level share
    (``dpf_step_banked``), seed j on lane j % 32: its children equal the
    numpy PRG's masked (s_l, t_l, s_r, t_r) and the same step on the
    T-tables (``aes256_encrypt3_rk``), and ``dpf_node_banked``'s children
    are exactly the step's with the CW XORed in where t is 1, byte for
    byte."""
    rng = np.random.default_rng(396 + n_seeds)
    ck = [rng.bytes(32) for _ in range(18)]
    seeds = rng.integers(0, 256, (n_seeds, 32), dtype=np.uint8)
    t_in = rng.integers(0, 2, n_seeds, dtype=np.uint8)
    t_in[0] = 1
    cw_s = rng.integers(0, 256, 32, dtype=np.uint8)
    cw_t = rng.integers(0, 2, 2, dtype=np.uint8)
    out = {name: np.zeros(shape, np.uint8) for name, shape in (
        ("step_s", (n_seeds, 2, 32)), ("step_t", (n_seeds, 2)),
        ("node_s", (n_seeds, 2, 32)), ("node_t", (n_seeds, 2)),
        ("tab_s", (n_seeds, 2, 32)), ("tab_t", (n_seeds, 2)))}
    lib.host_dpf_step(
        _p(SBOX_NP), _p(expand_key_np(ck[0])), _p(expand_key_np(ck[17])),
        _p(cw_s), _p(cw_t), _p(seeds), _p(t_in),
        *(_p(out[k]) for k in ("step_s", "step_t", "node_s", "node_t",
                               "tab_s", "tab_t")), n_seeds)
    prg = HirosePrgNp(32, ck, warn=False).gen(seeds)
    assert np.array_equal(out["step_s"], np.stack([prg.s_l, prg.s_r], 1))
    assert np.array_equal(out["step_t"], np.stack([prg.t_l, prg.t_r], 1))
    assert np.array_equal(out["tab_s"], out["step_s"])
    assert np.array_equal(out["tab_t"], out["step_t"])
    g = t_in[:, None].astype(bool)
    assert np.array_equal(out["node_s"], out["step_s"]
                          ^ np.where(g[..., None], cw_s, 0).astype(np.uint8))
    assert np.array_equal(out["node_t"], out["step_t"] ^ (g * cw_t))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_banked_aes_matches_numpy(lib, mode):
    """The banked AES core (aes_banked.cuh) over lanes 0-31, twice each:
    two and three blocks in lockstep under ciphers 0 and 17 (and 17 and
    0), and two blocks beside a third's t bit alone, against the numpy
    AES-256."""
    rng = np.random.default_rng(400 + mode)
    ck = [rng.bytes(32) for _ in range(18)]
    step = (2, 3, 3)[mode]
    blocks = rng.integers(0, 256, (64 * step, 16), dtype=np.uint8)
    for a, b in ((0, 17), (17, 0)):
        rk_a, rk_b = expand_key_np(ck[a]), expand_key_np(ck[b])
        out = np.zeros_like(blocks)
        lib.host_banked_aes(_p(SBOX_NP), _p(rk_a), _p(rk_b), _p(blocks),
                            _p(out), blocks.shape[0], mode)
        keys = [rk_a, rk_a, rk_a] if mode == 2 else [rk_a, rk_b, rk_a]
        want = np.stack([aes256_encrypt_np(keys[j % step], blocks[j])
                         for j in range(blocks.shape[0])])
        if mode == 2:  # every third block: its t bit alone
            want[2::3, 0] &= 1
            want[2::3, 1:] = 0
        assert np.array_equal(out, want), (a, b)


def _shared_points(rng, alphas, m):
    """m shared points with x = alpha and alpha +- 1 planted for the first
    and the last key."""
    n_bytes = alphas.shape[1]
    xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
    top = 1 << (8 * n_bytes)
    for j, a in enumerate((alphas[0], alphas[-1])):
        a = int.from_bytes(a.tobytes(), "big")
        for d in (-1, 0, 1):
            xs[3 * j + d + 1] = np.frombuffer(
                ((a + d) % top).to_bytes(n_bytes, "big"), np.uint8)
    return xs


@pytest.mark.parametrize("n_bytes,staged", [(2, 16), (16, 128), (16, 40)])
def test_keylanes_body_matches_oracle(lib, n_bytes, staged):
    """B8's keys-in-lanes body as a block runs it (the transposed CW
    staging, the t bits gathered across lanes, the walk that turns the
    same way on all 32 lanes) against eval_batch_np: K = 37 keys (a full
    group and a tail of 5) x M = 9 shared points, both bounds, both
    parties; at n = 128 with every level staged and with levels 40.. read
    from the key rows."""
    k_num, m, n = 37, 9, 8 * n_bytes
    for bound in Bound:
        rng, prg, rk, alphas, bundle = _setup(
            410 + n_bytes + staged, k_num, n_bytes, "xor", bound)
        xs = _shared_points(rng, alphas, m)
        for b in (0, 1):
            y = np.zeros((k_num, m, 16), np.uint8)
            lib.host_keylanes(_p(SBOX_NP), _p(rk), _p(bundle.s0s),
                              _p(bundle.cw_s), _p(bundle.cw_v),
                              _p(bundle.cw_t), _p(bundle.cw_np1), _p(xs),
                              _p(y), k_num, n, m, b, staged)
            want = eval_batch_np(prg, b, bundle.for_party(b), xs)
            assert np.array_equal(y, want), (bound, b)


@pytest.mark.parametrize("lam", [48, 256])
def test_narrow_banked_body_matches_oracle(lib, lam):
    """B4's three-slot level loop on the banked core against
    narrow_walk_np and, with W1's body, the full-width oracle: random points
    with alpha and alpha +- 1 planted (lanes turn both ways at the same
    level, slot C runs), and points sharing their first byte 0x5A (levels
    where every lane turns left run slots A and B alone); slot C also forced
    at every level."""
    k_num, n_bytes = 2, 4
    n = 8 * n_bytes
    rk = expand_key_np
    for bound in Bound:
        ck, prg, bundle, xs_mixed, aes = _large_setup(
            430 + lam, lam, k_num, n_bytes, bound)
        xs_prefix = xs_mixed.copy()
        xs_prefix[:, 0] = 0x5A
        m, tw = xs_mixed.shape[0], -(-(n + 1) // 32)
        for b in (0, 1):
            kb = bundle.for_party(b)
            s0, cs, cv, ct, np1 = _narrow_arrays(kb)
            for xs, all3 in ((xs_mixed, 0), (xs_prefix, 0), (xs_prefix, 1)):
                y32 = np.zeros((k_num, m, 32), np.uint8)
                traj = np.zeros((k_num, m, tw), np.uint32)
                lib.host_narrow(
                    _p(SBOX_NP), _p(rk(ck[0])), _p(rk(ck[17])), _p(s0),
                    _p(cs), _p(cv), _p(ct), _p(np1), _p(xs), _p(y32),
                    _p(traj), k_num, n, m, tw, b, all3)
                what = (bound, b, all3, int(xs[0, 0]))
                for key in range(k_num):
                    one = KeyBundle(*(a[key:key + 1] for a in (
                        kb.s0s, kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)))
                    want_y, want_t = narrow_walk_np(ck, one, b, xs)
                    assert np.array_equal(y32[key], want_y), what
                    assert np.array_equal(_traj_bits(traj[key], n + 1),
                                          want_t), what
                got = np.concatenate([y32, _wide(lib, kb, traj, m)], axis=-1)
                assert np.array_equal(got, eval_batch_np(prg, b, kb, xs)), \
                    what


def _warp_points(rng, alphas, n_bytes, k):
    """136 points in warps of 32 for a walk from depth k: random with
    x = alpha and alpha +- 1 planted for every key (lanes turn both ways);
    every walked bit 0 (all-left warp); every walked bit 1 (all-right);
    lanes alternating all-left and all-right (mixed at every level); and a
    last warp of 8 random points (lanes past the last point walk it).  The
    first k bits stay random, so the points gather many frontier rows."""
    n = 8 * n_bytes
    bits = rng.integers(0, 2, (136, n), dtype=np.uint8)
    bits[32:64, k:] = 0
    bits[64:96, k:] = 1
    bits[96:128, k:] = (np.arange(32) % 2)[:, None]
    xs = np.packbits(bits, axis=1)
    top = 1 << n
    for j, a in enumerate(alphas):
        a = int.from_bytes(a.tobytes(), "big")
        for d in (-1, 0, 1):
            xs[3 * j + d + 1] = np.frombuffer(
                ((a + d) % top).to_bytes(n_bytes, "big"), np.uint8)
    return xs


@pytest.mark.parametrize("lam", [80, 256])
def test_hybrid_prefix_banked_body_matches_oracle(lib, lam):
    """B5b's body, B4's banked level from a frontier row
    (``narrow_point_banked`` from level k, slot C by each warp's vote):
    K = 2 keys, n = 16, k = 6, random, all-left, all-right and mixed warps
    (``_warp_points``), both bounds, both parties; y[:32] and the
    trajectory against ``hybrid_prefix_eval_plain``, and with W1's body
    the full-width oracle."""
    from dcf_tpu_torch.ops.hybrid_prefix import hybrid_prefix_eval_plain

    k_num, n_bytes, k = 2, 2, 6
    n = 8 * n_bytes
    rk = expand_key_np
    for bound in Bound:
        ck, prg, bundle, planted, aes = _large_setup(500 + lam, lam, k_num,
                                                     n_bytes, bound)
        alphas = planted[1:3 * k_num:3]  # x = alpha of each key
        xs = _warp_points(np.random.default_rng(510 + lam), alphas, n_bytes,
                          k)
        m, tw = xs.shape[0], -(-(n + 1) // 32)
        for b in (0, 1):
            kb = bundle.for_party(b)
            s0, cs, cv, ct, np1 = _narrow_arrays(kb)
            tens = [torch.from_numpy(a) for a in (aes, s0, cs, cv, ct, np1)]
            rows, words = narrow_frontier_plain(*tens[:5], k=k, b=b)
            y32 = np.zeros((k_num, m, 32), np.uint8)
            traj = np.zeros((k_num, m, tw), np.uint32)
            lib.host_hybrid_prefix(
                _p(SBOX_NP), _p(rk(ck[0])), _p(rk(ck[17])),
                _p(rows.numpy()), _p(words.numpy().view(np.uint32)),
                _p(cs), _p(cv), _p(ct), _p(np1), _p(xs), _p(y32), _p(traj),
                k_num, n, k, m, tw)
            want_y, want_traj = hybrid_prefix_eval_plain(
                tens[0], rows, words, *tens[2:], torch.from_numpy(xs)[None],
                k=k, lam=lam)
            assert np.array_equal(y32, want_y[..., :32].numpy()), (bound, b)
            assert np.array_equal(traj.view(np.uint8), want_traj.numpy()), \
                (bound, b)
            got = np.concatenate([y32, _wide(lib, kb, traj, m)], axis=-1)
            assert np.array_equal(got, eval_batch_np(prg, b, kb, xs)), \
                (bound, b)


# ---------------------------------------------------------------------------
# Kernel B1 on the banked AES: two points a lane, a warp vote a level and
# point (aes_banked.cuh, walk_pair_levels), from the root and, as kernel
# B3 ran it before its slot schedule, from a frontier.
# ---------------------------------------------------------------------------

def _pair_points(rng, alphas, n_bytes):
    """134 points in three warp units of 64: random with x = alpha and
    alpha +- 1 planted for every key (lanes turn both ways at a level, and
    more than 32 of the 64 points turn left at some levels), then 64
    points whose first byte is 0xFF except for point 32 + 5's 0x7F (at
    levels 1-7 every point turns right: the t-bit blocks alone; at level 0
    one lane's point 1 turns left: three chains), then 6 points whose
    first byte is 0x00 but for the last one's 0x80 (the last unit, its
    lanes past the last point walking that point: at levels 1-7 every
    point turns left, four chains; at level 0 some lanes' point 0 turns
    left and every point 1 right, three chains)."""
    xs = rng.integers(0, 256, (134, n_bytes), dtype=np.uint8)
    top = 1 << (8 * n_bytes)
    for key, a in enumerate(alphas):
        a = int.from_bytes(a.tobytes(), "big")
        for d in (-1, 0, 1):
            xs[3 * key + d + 1] = np.frombuffer(
                ((a + d) % top).to_bytes(n_bytes, "big"), np.uint8)
    xs[64:128, 0] = 0xFF
    xs[64 + 32 + 5, 0] = 0x7F
    xs[128:, 0] = 0x00
    xs[133, 0] = 0x80
    return xs


def _host_pair(lib, rk, kb, xs, b, gw, table=None, k=0):
    """The pair walk from the root (table None: B1) or from a frontier
    through the lane harness: shares [K, M, 16] and the lookups its slots
    computed."""
    k_num, n = kb.cw_s.shape[:2]
    m = xs.shape[-2]
    y = np.zeros((k_num, m, 16), np.uint8)
    computed = ctypes.c_longlong(0)
    lib.host_pair_walk(
        _p(SBOX_NP), _p(rk), _p(np.ascontiguousarray(kb.s0s[:, 0])),
        _p(kb.cw_s), _p(kb.cw_v), _p(kb.cw_t), _p(kb.cw_np1), _p(xs),
        None if table is None else _p(table), _p(y), k_num, n, k, m,
        int(xs.ndim == 3), b, gw, ctypes.byref(computed))
    return y, computed.value


@pytest.mark.parametrize("n_bytes", [2, 16])
@pytest.mark.parametrize("group", GROUPS)
def test_pair_walk_body_matches_oracle(lib, group, n_bytes):
    """B1's body: K = 2 keys at 134 shared and per-key points
    (``_pair_points``), both parties, against eval_batch_np; both bounds,
    at n = 16 and n = 128."""
    gw = GROUP_WIDTH.get(group, 0)
    k_num = 2
    for bound in Bound:
        rng, prg, rk, alphas, bundle = _setup(
            440 + n_bytes + GROUPS.index(group), k_num, n_bytes, group, bound)
        shared = _pair_points(rng, alphas, n_bytes)
        per_key = np.stack([_pair_points(rng, alphas[key:key + 1], n_bytes)
                            for key in range(k_num)])
        for xs in (shared, per_key):
            for b in (0, 1):
                kb = bundle.for_party(b)
                y, _ = _host_pair(lib, rk, kb, xs, b, gw)
                assert np.array_equal(y, eval_batch_np(prg, b, kb, xs)), \
                    (bound, b, xs.ndim)


def _path_frontier(prg, rk, kb, b, k, xs, group):
    """The depth-k frontier table [K * 2^k, 32] of ``kb`` with only the
    rows of the points ``xs`` filled: each point's carry after its first
    k levels, from the plain walk (``walk_levels_plain``), t stashed in
    bit 0 of byte 15, at the bit-reversed index of its first k bits."""
    aes = torch.from_numpy(np.concatenate([SBOX_NP, rk.reshape(-1)]))
    k_num, m = kb.cw_s.shape[0], xs.shape[0]
    cw = [torch.from_numpy(np.ascontiguousarray(a[:, :k]))
          for a in (kb.cw_s, kb.cw_v, kb.cw_t)]
    s = torch.from_numpy(np.ascontiguousarray(kb.s0s[:, 0]))
    s, t, v = walk_levels_plain(
        aes, s[:, None].expand(k_num, m, 16).contiguous(),
        torch.full((k_num, m), b, dtype=torch.uint8),
        torch.zeros((k_num, m, 16), dtype=torch.uint8), *cw,
        walk_bits_plain(torch.from_numpy(xs))[None, :, :k],
        GROUP_WIDTH.get(group, 0))
    s = s.numpy().copy()
    s[..., 15] |= t.numpy()
    idx = frontier_index_plain(torch.from_numpy(xs), k).numpy()
    table = np.zeros((k_num << k, 32), np.uint8)
    for key in range(k_num):
        table[(key << k) + idx] = np.concatenate([s[key], v[key].numpy()], 1)
    return table


@pytest.mark.parametrize("group", GROUPS)
def test_pair_prefix_body_matches_oracle(lib, group):
    """The pair walk from tree_expand_np's depth-4 frontier (n = 16, K = 2,
    the 134 points of ``_pair_points``), both bounds, both parties,
    against eval_batch_np; the frontier rows the points gather, made by
    ``_path_frontier``, equal tree_expand_np's."""
    gw = GROUP_WIDTH.get(group, 0)
    k_num, n_bytes, k = 2, 2, 4
    for bound in Bound:
        rng, prg, rk, alphas, bundle = _setup(
            460 + GROUPS.index(group), k_num, n_bytes, group, bound)
        xs = _pair_points(rng, alphas, n_bytes)
        idx = frontier_index_plain(torch.from_numpy(xs), k).numpy()
        for b in (0, 1):
            kb = bundle.for_party(b)
            rows = []
            for key in range(k_num):
                one = KeyBundle(*(a[key:key + 1] for a in (
                    kb.s0s, kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)),
                    group=group)
                s, v, t = tree_expand_np(prg, one, b, k)
                s = s.copy()
                s[:, 15] |= t
                rows.append(np.concatenate([s, v], axis=1))
            table = np.ascontiguousarray(np.concatenate(rows))
            path = _path_frontier(prg, rk, kb, b, k, xs, group)
            for key in range(k_num):
                assert np.array_equal(path[(key << k) + idx],
                                      table[(key << k) + idx]), (bound, b)
            y, _ = _host_pair(lib, rk, kb, xs, b, gw, table, k)
            assert np.array_equal(y, eval_batch_np(prg, b, kb, xs)), \
                (bound, b)


@pytest.mark.parametrize("bound", list(Bound))
def test_pair_prefix_body_at_depth_21(lib, bound):
    """The pair walk at B3's frontier depth, k = 21, n = 24, from
    a frontier with the points' rows (``_path_frontier``; a full numpy
    expansion to depth 21 takes about 40 s a key and party), add16, K = 2,
    both parties, against eval_batch_np."""
    group, k_num, n_bytes, k = "add16", 2, 3, 21
    rng, prg, rk, alphas, bundle = _setup(
        470 + list(Bound).index(bound), k_num, n_bytes, group, bound)
    xs = _pair_points(rng, alphas, n_bytes)
    for b in (0, 1):
        kb = bundle.for_party(b)
        table = _path_frontier(prg, rk, kb, b, k, xs, group)
        y, _ = _host_pair(lib, rk, kb, xs, b, 16, table, k)
        assert np.array_equal(y, eval_batch_np(prg, b, kb, xs)), b


@pytest.mark.parametrize("n_bytes", [2, 16])
def test_pair_lookups_computed_counts_the_blocks(lib, n_bytes):
    """``chip_smoke.pair_lookups_computed``, the design figure the smoke
    prints for B1, equals the lookups the lane harness's slots
    compute, from the root and from depth 4."""
    from chip_smoke import pair_lookups_computed

    rng, prg, rk, alphas, bundle = _setup(480 + n_bytes, 1, n_bytes, "xor",
                                          Bound.LT_BETA)
    xs = _pair_points(rng, alphas, n_bytes)
    kb = bundle.for_party(0)
    bits = walk_bits_plain(torch.from_numpy(xs))
    _, got = _host_pair(lib, rk, kb, xs, 0, 0)
    assert got == pair_lookups_computed(bits)
    table = _path_frontier(prg, rk, kb, 0, 4, xs, "xor")
    _, got = _host_pair(lib, rk, kb, xs, 0, 0, table, 4)
    assert got == pair_lookups_computed(bits[:, 4:])


# ---------------------------------------------------------------------------
# Kernel B3 on the banked AES: the slot-per-point schedule
# (aes_banked.cuh, prefix_slot_walk).
# ---------------------------------------------------------------------------

def _slot_points(rng, alphas, n_bytes, m):
    """m shared points: x = alpha - 1, alpha and alpha + 1 of each key
    first (as many as fit), the rest random, and from m = 200 on a run of
    64 consecutive points at 32 (lanes whose points turn alike at all but
    the last levels) and a run of one point repeated from 128 to 383 (units
    that turn alike)."""
    xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
    top = 1 << (8 * n_bytes)
    vals = dict(enumerate(int.from_bytes(a.tobytes(), "big") + d
                          for a in alphas for d in (-1, 0, 1)))
    if m >= 200:
        start, same = (int(v) for v in rng.integers(0, top, 2))
        vals.update({32 + j: start + j for j in range(64)})
        vals.update({j: same for j in range(128, 384)})
    for j, x in vals.items():
        if j < m:
            xs[j] = np.frombuffer((x % top).to_bytes(n_bytes, "big"),
                                  np.uint8)
    return xs


def _host_slot(lib, rk, kb, xs, table, k, negate, gw, warps):
    """B3 through the slot harness on a grid of ``warps`` warps: shares
    [K, M, 16], the lookups of the units walked two points a lane, the
    slots' live steps and the slot-steps the warps ran."""
    k_num, n = kb.cw_s.shape[:2]
    m = xs.shape[0]
    y = np.zeros((k_num, m, 16), np.uint8)
    counts = [ctypes.c_longlong(0) for _ in range(3)]
    lib.host_slot_walk(
        _p(SBOX_NP), _p(rk), _p(table), _p(kb.cw_s), _p(kb.cw_v),
        _p(kb.cw_t), _p(kb.cw_np1), _p(xs), _p(y), k_num, n, k, m,
        int(negate), gw, warps, *map(ctypes.byref, counts))
    return (y, *(c.value for c in counts))


@pytest.mark.parametrize("k, n_bytes", [(4, 3), (21, 5), (8, 2)])
@pytest.mark.parametrize("group", GROUPS)
def test_slot_walk_body_matches_oracle(lib, group, k, n_bytes):
    """B3's body, its lanes run one after another on a grid of 3 warps:
    K = 2 keys at m = 1, 63, 65 and 200 shared points (``_slot_points``),
    from depth-k frontiers with the points' rows (``_path_frontier``), both
    bounds, both parties, against eval_batch_np; 20 and 19 walked levels
    (slots, and the pair walk on the units whose points turn alike) and 8
    (a short walk: the pair walk on every unit).  The host reads the table
    as BkLane, so BkWin's addressing is checked on the card alone
    (``test_torch_prefix_card.py``)."""
    gw = GROUP_WIDTH.get(group, 0)
    k_num = 2
    for bound in Bound:
        rng, prg, rk, alphas, bundle = _setup(
            490 + 2 * GROUPS.index(group) + list(Bound).index(bound) + k,
            k_num, n_bytes, group, bound)
        for m in (1, 63, 65, 200):
            xs = _slot_points(rng, alphas, n_bytes, m)
            for b in (0, 1):
                kb = bundle.for_party(b)
                table = _path_frontier(prg, rk, kb, b, k, xs, group)
                y, *_ = _host_slot(lib, rk, kb, xs, table, k,
                                   b and gw > 0, gw, 3)
                assert np.array_equal(y, eval_batch_np(prg, b, kb, xs)), \
                    (bound, m, b)


@pytest.mark.parametrize("warps", [1, 3, 7])
def test_slot_lookups_computed_counts_the_steps(lib, warps):
    """``chip_smoke.slot_lookups_computed``, the design figures the smoke
    prints for B3, equal what the slot harness counts: the lookups of the
    units walked two points a lane and of the slots' live steps, and the
    live steps' share of the slot-steps the warps ran, K = 2 keys at m =
    200 and 1000 points (``_slot_points``: units of both kinds) from depth
    4 at n = 24, on grids of 1, 3 and 7 warps; and its slots and warps are
    the kernel's."""
    from chip_smoke import (LOOKUPS_BLOCK, PREFIX_SLOTS, PREFIX_WARPS,
                            SLOT_MIN_LEVELS, slot_lookups_computed)

    assert lib.host_prefix_slots() == PREFIX_SLOTS
    assert f"constexpr int kWarps = {PREFIX_WARPS};" in (
        CSRC / "prefix_eval.cu").read_text()
    assert f"constexpr int kSlotMinLevels = {SLOT_MIN_LEVELS};" in (
        CSRC / "aes_banked.cuh").read_text()
    rng, prg, rk, alphas, bundle = _setup(500 + warps, 2, 3, "xor",
                                          Bound.LT_BETA)
    kb = bundle.for_party(0)
    for m in (200, 1000):
        xs = _slot_points(rng, alphas, 3, m)
        table = _path_frontier(prg, rk, kb, 0, 4, xs, "xor")
        _, paired, carried, slot_steps = _host_slot(lib, rk, kb, xs, table,
                                                    4, 0, 0, warps)
        assert paired > 0 and carried > 0, m
        bits = walk_bits_plain(torch.from_numpy(xs))[:, 4:]
        assert slot_lookups_computed(bits, keys=2, warps=warps) == (
            paired + LOOKUPS_BLOCK * carried, carried / slot_steps), m
