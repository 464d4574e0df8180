// A bank-conflict-free T-table AES-256 for Hopper, and the per-lane bodies
// that run on it: kernel B8's (keylanes_eval.cu), the walk of kernel B1
// (walk_eval.cu), two points a lane, and kernel B3's (prefix_eval.cu), a
// point a slot and several slots a lane.  The three-slot narrow level of
// kernels B4 and B5b (narrow_walk.cu, hybrid_prefix.cu) and the DPF node of
// kernel B6 (evalall_expand.cu) run on it too (narrow_walk.cuh), and so
// does the lam = 16 tree node of kernel B2 (tree_expand.cu), up to three
// levels a thread (tree_subtree), and with the leaf finalize on its last
// level, kernel B2f.
//
// Why: the T-tables of dcf_walk.cuh are uint32_t te[4][256] in shared
// memory, so entry x sits in bank x mod 32.  Each round does 16 lookups
// whose indices are random per lane; 32 random indices into 32 banks put
// about 3.3 distinct addresses into the fullest bank, so a lookup
// instruction takes about 3.3 shared-memory wavefronts instead of 1.
//
// Layout: te[x][64], 256 rows of 256 bytes (64 KB).  Words 0-31 of row x
// hold T0[x], the column (2S, S, S, 3S) of S-box byte x, once for each
// lane; words 32-63 hold T2[x] = T0[x] rotated by 16 bits, once for each
// lane.  Lane l reads only words l and 32 + l of a row, which are always
// bank l, so a warp's 32 lookups are one wavefront whatever their
// indices.  T1 and T3 are T0 and T2 rotated by 8 bits (a funnel shift on
// the card), and the last round's S-box byte is byte 0 or 3 of T2 and
// byte 1 or 2 of T0, so no other table is needed.
//
// The byte offset of lane l's entry of byte j of x is (x.byte[j] << 8) |
// (4 l) for T0 and | (128 + 4 l) for T2: ONE byte permute (__byte_perm,
// PRMT) builds it from x and the lane's column offset, and the load adds
// the table's base.  Per round that is 16 lookups and 32
// integer operations (16 byte permutes, 8 rotations, 8 three-input XORs),
// 2 a lookup: at 64 INT32 lanes against 32 shared-memory words per SM and
// clock, the integer pipe and the lookups bind together.
//
// The per-thread functions take the lane's view of the table, BkLane, so
// the host test can run them over lanes 0-31 in a loop.  Round keys are
// 16-byte RoundKey rows in shared memory, read by every lane at once (a
// broadcast).
//
// Plain C++ over uint32_t; it also compiles on the host.

#pragma once

#include "dcf_walk.cuh"

namespace dcf {

constexpr int kLanes = 32;
constexpr int kBankedWords = 256 * 2 * kLanes;  // te[256][64]: 64 KB

// One AES round key: four little-endian words, loaded as one 16-byte row.
struct alignas(16) RoundKey {
  uint32_t w[4];
};

// Word e of the banked table: T0 of byte e / 64 in words 0-31 of the row
// (as aes_table_entry in dcf_walk.cuh computes it), T2 in words 32-63.
DCF_HD uint32_t banked_table_word(const uint8_t* sbox, int e) {
  const uint32_t s = sbox[e >> 6];
  const uint32_t s2 = ((s << 1) ^ ((s >> 7) * 0x1Bu)) & 0xFFu;
  const uint32_t t0 = s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
  return (e & 32) ? rotl32(t0, 16) : t0;
}

DCF_HD uint32_t rotl_bytes(uint32_t x, int r) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, r);
#else
  return rotl32(x, r);
#endif
}

// 16 bytes at p (16-byte aligned on the card) as four little-endian words.
DCF_HD void load16(const uint8_t* p, uint32_t w[4]) {
#if defined(__CUDA_ARCH__)
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
#else
  for (int q = 0; q < 4; ++q) w[q] = le32(p + 4 * q);
#endif
}

// A lane's view of the banked table: its base and the byte offsets of the
// lane's T0 and T2 words within a row.
struct BkLane {
  const uint32_t* te;
  uint32_t c0, c2;
};

DCF_HD BkLane bk_lane(const uint32_t* te, int lane) {
  return {te, 4u * (uint32_t)lane, 128u + 4u * (uint32_t)lane};
}

// The lane's entry (column byte offset col) of byte j of x.
DCF_HD uint32_t bk_entry(const BkLane& t, uint32_t x, int j, uint32_t col) {
#if defined(__CUDA_ARCH__)
  const uint32_t off = __byte_perm(x, col, 0x5504u | ((uint32_t)j << 4));
#else
  const uint32_t off = (((x >> (8 * j)) & 0xFFu) << 8) | col;
#endif
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const unsigned char*>(t.te) + off);
}

// Kernel B3's view of the table, which it holds twice: te[x][64] as above,
// and at te + 64 KB the same rotated by 8 bits (T1 and T3), so that a
// middle round's column takes no rotation.  te sits at a 64 KB boundary of
// the shared window, whose address is folded into the lane's column
// offsets (bytes 2-3; byte 0 the column), so that one byte permute builds
// a lookup's whole address and the load adds nothing to it.  B3's lanes
// leave one another's step, and in such a loop the compiler keeps a table
// base in a per-lane register, adding it to every lookup; BkLane's
// kernels run their loops in step and keep the base in a uniform
// register, which the load adds for free.  On the host it is BkLane, so
// the host's slot harness does not check this addressing: the card tests
// (tests/test_torch_prefix_card.py) and the smoke do.
struct BkWin {
  const uint32_t* te;
  uint32_t c0, c2, c1, c3;
};

DCF_HD BkWin bk_win(const uint32_t* te, int lane) {
#if defined(__CUDA_ARCH__)
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(te);
#else
  const uint32_t at = 0u;
#endif
  const uint32_t at13 = at + 4u * kBankedWords;
  const uint32_t c = 4u * (uint32_t)lane;
  return {te, at | c, at | (128u + c), at13 | c, at13 | (128u + c)};
}

DCF_HD uint32_t bk_entry(const BkWin& t, uint32_t x, int j, uint32_t col) {
#if defined(__CUDA_ARCH__)
  const uint32_t at = __byte_perm(x, col, 0x7604u | ((uint32_t)j << 4));
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(at));
  return v;
#else
  return bk_entry(BkLane{t.te, t.c0, t.c2}, x, j, col);
#endif
}

// One output column of a middle round: SubBytes, ShiftRows and
// MixColumns of (byte 0 of a, byte 1 of b, byte 2 of c, byte 3 of d):
// T0[a] ^ T1[b] ^ T2[c] ^ T3[d] ^ k.  L is BkLane or BkWin.
template <class L>
DCF_HD uint32_t bk_col(const L& t, uint32_t a, uint32_t b, uint32_t c,
                       uint32_t d, uint32_t k) {
  return bk_entry(t, a, 0, t.c0) ^ rotl_bytes(bk_entry(t, b, 1, t.c0), 8) ^
         bk_entry(t, c, 2, t.c2) ^ rotl_bytes(bk_entry(t, d, 3, t.c2), 8) ^
         k;
}

// ... on BkWin: T1 and T3 from their own table.
DCF_HD uint32_t bk_col(const BkWin& t, uint32_t a, uint32_t b, uint32_t c,
                       uint32_t d, uint32_t k) {
#if defined(__CUDA_ARCH__)
  return bk_entry(t, a, 0, t.c0) ^ bk_entry(t, b, 1, t.c1) ^
         bk_entry(t, c, 2, t.c2) ^ bk_entry(t, d, 3, t.c3) ^ k;
#else
  return bk_col(BkLane{t.te, t.c0, t.c2}, a, b, c, d, k);
#endif
}

template <class L>
DCF_HD void bk_round(const L& t, const RoundKey& k, uint32_t x[4]) {
  const uint32_t y0 = bk_col(t, x[0], x[1], x[2], x[3], k.w[0]);
  const uint32_t y1 = bk_col(t, x[1], x[2], x[3], x[0], k.w[1]);
  const uint32_t y2 = bk_col(t, x[2], x[3], x[0], x[1], k.w[2]);
  const uint32_t y3 = bk_col(t, x[3], x[0], x[1], x[2], k.w[3]);
  x[0] = y0;
  x[1] = y1;
  x[2] = y2;
  x[3] = y3;
}

// One output column of the last round (SubBytes and ShiftRows): S[x] is
// byte 0 and 3 of T2[x], byte 1 and 2 of T0[x].
template <class L>
DCF_HD uint32_t bk_last_col(const L& t, uint32_t a, uint32_t b, uint32_t c,
                            uint32_t d, uint32_t k) {
  return ((bk_entry(t, a, 0, t.c2) & 0xFFu) |
          (bk_entry(t, b, 1, t.c0) & 0xFF00u) |
          (bk_entry(t, c, 2, t.c0) & 0xFF0000u) |
          (bk_entry(t, d, 3, t.c2) & 0xFF000000u)) ^
         k;
}

template <class L>
DCF_HD void bk_last(const L& t, const RoundKey& k, uint32_t x[4]) {
  const uint32_t y0 = bk_last_col(t, x[0], x[1], x[2], x[3], k.w[0]);
  const uint32_t y1 = bk_last_col(t, x[1], x[2], x[3], x[0], k.w[1]);
  const uint32_t y2 = bk_last_col(t, x[2], x[3], x[0], x[1], k.w[2]);
  const uint32_t y3 = bk_last_col(t, x[3], x[0], x[1], x[2], k.w[3]);
  x[0] = y0;
  x[1] = y1;
  x[2] = y2;
  x[3] = y3;
}

// AES-256 of NF + NB blocks in lockstep (independent lookup chains), block
// j under the round keys rk[j][0..14], which may differ per lane.  Blocks
// 0..NF-1 of x are encrypted in full, in place; of block NF + j only bit
// 0 of byte 0 is computed, into bit[j]: rounds 1-12 in full, then only
// the column of round 13 and the byte of the last round that feed it (197
// lookups instead of 224).  The round loop is not unrolled: unrolled, the
// lockstep forms a kernel uses overflow the instruction cache.
template <int NF, int NB = 0, class L>
DCF_HD void bk_encrypt(const L& t, const RoundKey* const rk[],
                       uint32_t (*x)[4], uint32_t* bit = nullptr) {
  constexpr int N = NF + NB;
  for (int j = 0; j < N; ++j)
    for (int c = 0; c < 4; ++c) x[j][c] ^= rk[j][0].w[c];
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int r = 1; r < 13; ++r)
    for (int j = 0; j < N; ++j) bk_round(t, rk[j][r], x[j]);
  for (int j = 0; j < NB; ++j) {
    const uint32_t* h = x[NF + j];
    const uint32_t c0 = bk_col(t, h[0], h[1], h[2], h[3], rk[NF + j][13].w[0]);
    bit[j] = (bk_entry(t, c0, 0, t.c2) ^ rk[NF + j][14].w[0]) & 1u;
  }
  for (int j = 0; j < NF; ++j) {
    bk_round(t, rk[j][13], x[j]);
    bk_last(t, rk[j][14], x[j]);
  }
}

// ---------------------------------------------------------------------------
// Kernel B8: keys in lanes.  A warp walks 32 consecutive keys (one a lane)
// at points that all its lanes share, two at a time, so every level turns
// the same way on every lane: a left turn needs E(s) and E(~s), a right
// turn only bit 0 of E(~s) (for t_r; its s and v are copies of s and ~s),
// and the two points' blocks run in lockstep.  A block stages its group's
// correction words in shared memory, transposed so that lane l's word q of
// level i sits at (4i + q) * 32 + l (bank l), and each level's 32 tl and
// 32 tr bits as two words.
// ---------------------------------------------------------------------------

// A group's correction words as lane `lane` reads them: levels below
// `staged` from the transposed arrays, the rest from its key's own rows
// (cw_s / cw_v [n, 16], cw_t [n, 2]) in device memory.
struct KlCw {
  const uint32_t* s;  // [staged][4][32]
  const uint32_t* v;  // [staged][4][32]
  const uint32_t* t;  // [staged][2]: the lanes' tl bits, then their tr bits
  int staged;
  const uint8_t* key_s;
  const uint8_t* key_v;
  const uint8_t* key_t;
};

// Stages level i of lane l's key (its rows key_s / key_v [n, 16]).
DCF_HD void kl_stage_entry(uint32_t* s, uint32_t* v, const uint8_t* key_s,
                           const uint8_t* key_v, int i, int l) {
  uint32_t ws[4], wv[4];
  load16(key_s + 16 * i, ws);
  load16(key_v + 16 * i, wv);
  for (int q = 0; q < 4; ++q) {
    s[(4 * i + q) * kLanes + l] = ws[q];
    v[(4 * i + q) * kLanes + l] = wv[q];
  }
}

// Level i's t bits of one key (key_t [n, 2]): tl in bit 0, tr in bit 1.
DCF_HD uint32_t kl_t_bits(const uint8_t* key_t, int i) {
  return (key_t[2 * i] & 1u) | ((key_t[2 * i + 1] & 1u) << 1);
}

DCF_HD void kl_level_cw(const KlCw& cw, int i, int lane, uint32_t s[4],
                        uint32_t v[4], uint32_t& tl, uint32_t& tr) {
  if (i < cw.staged) {
    for (int q = 0; q < 4; ++q) {
      s[q] = cw.s[(4 * i + q) * kLanes + lane];
      v[q] = cw.v[(4 * i + q) * kLanes + lane];
    }
    tl = (cw.t[2 * i] >> lane) & 1u;
    tr = (cw.t[2 * i + 1] >> lane) & 1u;
  } else {
    load16(cw.key_s + 16 * i, s);
    load16(cw.key_v + 16 * i, v);
    const uint32_t bits = kl_t_bits(cw.key_t, i);
    tl = bits & 1u;
    tr = bits >> 1;
  }
}

// The walk state of one (key, point).
struct KlState {
  uint32_t s[4], v[4], t;
};

// A level's update of a point that turns left, from es = E(s) and
// ev = E(~s) (overwritten): s_l = E(s) ^ s, v_l = E(~s) ^ ~s, masked, t_l
// from s_l; the s/t correction gated by t, v accumulated by XOR.
DCF_HD void kl_left(KlState& p, uint32_t es[4], uint32_t ev[4],
                    const uint32_t ws[4], const uint32_t wv[4],
                    uint32_t ctl) {
  const uint32_t g = 0u - p.t;
  for (int q = 0; q < 4; ++q) {
    es[q] ^= p.s[q];
    ev[q] ^= ~p.s[q];
  }
  const uint32_t tl = es[0] & 1u;
  es[3] &= kMaskBit;
  ev[3] &= kMaskBit;
  for (int q = 0; q < 4; ++q) {
    p.v[q] ^= ev[q] ^ (wv[q] & g);
    p.s[q] = es[q] ^ (ws[q] & g);
  }
  p.t = tl ^ (p.t & ctl);
}

// ... of a point that turns right, from e0 = bit 0 of E(~s): s_r = s and
// v_r = ~s, masked, t_r = bit 0 of E(~s) ^ ~s.
DCF_HD void kl_right(KlState& p, uint32_t e0, const uint32_t ws[4],
                     const uint32_t wv[4], uint32_t ctr) {
  const uint32_t g = 0u - p.t;
  const uint32_t tr = e0 ^ (~p.s[0] & 1u);
  for (int q = 0; q < 4; ++q) {
    const uint32_t m = q == 3 ? kMaskBit : 0xFFFFFFFFu;
    p.v[q] ^= (~p.s[q] & m) ^ (wv[q] & g);
    p.s[q] = (p.s[q] & m) ^ (ws[q] & g);
  }
  p.t = tr ^ (p.t & ctr);
}

// One level of two points, pl turning left and pr right: 3 chains.
DCF_HD void kl_level_mixed(const BkLane& t, const RoundKey* const rk[],
                           const uint32_t ws[4], const uint32_t wv[4],
                           uint32_t ctl, uint32_t ctr, KlState& pl,
                           KlState& pr) {
  uint32_t x[3][4], bit[1];
  for (int q = 0; q < 4; ++q) {
    x[0][q] = pl.s[q];
    x[1][q] = ~pl.s[q];
    x[2][q] = ~pr.s[q];
  }
  bk_encrypt<2, 1>(t, rk, x, bit);
  kl_left(pl, x[0], x[1], ws, wv, ctl);
  kl_right(pr, bit[0], ws, wv, ctr);
}

// One level of two points of the warp, p0 turning right if r0, p1 if r1:
// the blocks both turns need, in lockstep (4 chains if both turn left, 3
// if one does, 2 t bits if neither).
DCF_HD void kl_level_pair(const BkLane& t, const RoundKey* rk,
                          const uint32_t ws[4], const uint32_t wv[4],
                          uint32_t ctl, uint32_t ctr, uint32_t r0,
                          uint32_t r1, KlState& p0, KlState& p1) {
  const RoundKey* const rks[4] = {rk, rk, rk, rk};  // one cipher
  if (r0 && r1) {
    uint32_t x[2][4], bit[2];
    for (int q = 0; q < 4; ++q) {
      x[0][q] = ~p0.s[q];
      x[1][q] = ~p1.s[q];
    }
    bk_encrypt<0, 2>(t, rks, x, bit);
    kl_right(p0, bit[0], ws, wv, ctr);
    kl_right(p1, bit[1], ws, wv, ctr);
  } else if (r1) {
    kl_level_mixed(t, rks, ws, wv, ctl, ctr, p0, p1);
  } else if (r0) {
    kl_level_mixed(t, rks, ws, wv, ctl, ctr, p1, p0);
  } else {
    uint32_t x[4][4];
    for (int q = 0; q < 4; ++q) {
      x[0][q] = p0.s[q];
      x[1][q] = ~p0.s[q];
      x[2][q] = p1.s[q];
      x[3][q] = ~p1.s[q];
    }
    bk_encrypt<4>(t, rks, x);
    kl_left(p0, x[0], x[1], ws, wv, ctl);
    kl_left(p1, x[2], x[3], ws, wv, ctl);
  }
}

// B8's per-lane body: lane `lane`'s key (party-b seed s0, cw_np1 np1)
// walked from the root at two points x0 and x1, which every lane of the
// warp shares; y0 and y1 are the XOR shares.  The same algebra as
// walk_point<0> in dcf_walk.cuh, computing only the AES blocks each turn
// needs, with each level's correction word read once for both points.
DCF_HD void keylanes_lane_pair(const BkLane& t, const RoundKey* rk,
                               const KlCw& cw, int n, int lane,
                               const uint32_t s0[4], const uint32_t np1[4],
                               const uint8_t* x0, const uint8_t* x1,
                               uint32_t t0, uint32_t y0[4], uint32_t y1[4]) {
  KlState p0, p1;
  for (int q = 0; q < 4; ++q) {
    p0.s[q] = p1.s[q] = s0[q];
    p0.v[q] = p1.v[q] = 0u;
  }
  p0.t = p1.t = t0;
  for (int i = 0; i < n; ++i) {
    uint32_t ws[4], wv[4], ctl, ctr;
    kl_level_cw(cw, i, lane, ws, wv, ctl, ctr);
    kl_level_pair(t, rk, ws, wv, ctl, ctr, walk_bit(x0, i), walk_bit(x1, i),
                  p0, p1);
  }
  finalize<0>(p0.s, p0.t, p0.v, np1, false, y0);
  finalize<0>(p1.s, p1.t, p1.v, np1, false, y1);
}

// ---------------------------------------------------------------------------
// Kernel B1 (walk_eval.cu), and kernel B3 on the units it walks two points
// a lane (prefix_eval.cu): one key's lam = 16 walk at many points, any
// group.  The points of a warp are unrelated, so its lanes turn both ways
// at most levels; a left turn needs E(s) and E(~s), a right turn only bit
// 0 of E(~s).
// ---------------------------------------------------------------------------

// Level i's correction word from one key's rows (cw_s / cw_v [n, 16],
// 16-byte aligned, and cw_t [n, 2]).
DCF_HD void walk_cw(const uint8_t* cw_s, const uint8_t* cw_v,
                    const uint8_t* cw_t, int i, LevelCw& w) {
  load16(cw_s + 16 * i, w.s);
  load16(cw_v + 16 * i, w.v);
  w.t = kl_t_bits(cw_t, i);
}

// A level's update of one point in group GW, from es = E(s) (read on a
// left turn only) and en = E(~s) (only its bit 0 is read on a right
// turn): the Hirose children, masked, the child on the walk bit, the s/t
// correction gated by t, v accumulated unsigned (walk_levels in
// dcf_walk.cuh, without its two full blocks on a right turn).
template <int GW>
DCF_HD void walk_turn(KlState& p, uint32_t xbit, const uint32_t es[4],
                      const uint32_t en[4], const LevelCw& w) {
  const uint32_t lm = xbit - 1u;  // all ones on a left turn
  const uint32_t g = 0u - p.t;
  uint32_t sc[4], vc[4];
  for (int q = 0; q < 4; ++q) {
    sc[q] = p.s[q] ^ (es[q] & lm);   // left E(s) ^ s, right s
    vc[q] = ~p.s[q] ^ (en[q] & lm);  // left E(~s) ^ ~s, right ~s
  }
  const uint32_t tc = ((sc[0] & lm) | ((en[0] ^ ~p.s[0]) & ~lm)) & 1u;
  sc[3] &= kMaskBit;
  vc[3] &= kMaskBit;
  for (int q = 0; q < 4; ++q) {
    p.v[q] = gadd<GW>(p.v[q], gadd<GW>(vc[q], w.v[q] & g));
    p.s[q] = sc[q] ^ (w.s[q] & g);
  }
  p.t = tc ^ (p.t & (w.t >> xbit) & 1u);
}

// Two points a lane (points l and 32 + l of the warp's 64), their blocks
// in lockstep.  Per level and point the warp votes whether some lane turns
// left with it: if so, that point's E(s) and E(~s) run in full on every
// lane; if not, bit 0 of E(~s) alone.  So random points run 4 chains a
// lane (448 lookups a point, against the 322.5 a random walk needs on
// average), and where a warp's points turn the same way (points in order,
// as the per-point full domain walks them) 4, 3 or 2 chains compute what
// the turns need.
template <int GW>
DCF_HD void walk_level_mixed(const BkLane& t, const RoundKey* const rks[],
                             const LevelCw& w, uint32_t xl, uint32_t xr,
                             KlState& pl, KlState& pr) {
  uint32_t x[3][4], bit[1];
  for (int q = 0; q < 4; ++q) {
    x[0][q] = pl.s[q];
    x[1][q] = ~pl.s[q];
    x[2][q] = ~pr.s[q];
  }
  bk_encrypt<2, 1>(t, rks, x, bit);
  x[2][0] = bit[0];
  walk_turn<GW>(pl, xl, x[0], x[1], w);
  walk_turn<GW>(pr, xr, x[2], x[2], w);
}

// One level of a lane's two points p0 and p1 at walk bits x0 and x1; any0
// and any1 are the warp's votes (some lane turns left with point 0, 1).
template <int GW>
DCF_HD void walk_level_pair(const BkLane& t, const RoundKey* rk,
                            const LevelCw& w, uint32_t x0, uint32_t x1,
                            bool any0, bool any1, KlState& p0, KlState& p1) {
  const RoundKey* const rks[4] = {rk, rk, rk, rk};  // one cipher
  if (any0 && any1) {
    uint32_t x[4][4];
    for (int q = 0; q < 4; ++q) {
      x[0][q] = p0.s[q];
      x[1][q] = ~p0.s[q];
      x[2][q] = p1.s[q];
      x[3][q] = ~p1.s[q];
    }
    bk_encrypt<4>(t, rks, x);
    walk_turn<GW>(p0, x0, x[0], x[1], w);
    walk_turn<GW>(p1, x1, x[2], x[3], w);
  } else if (any0) {
    walk_level_mixed<GW>(t, rks, w, x0, x1, p0, p1);
  } else if (any1) {
    walk_level_mixed<GW>(t, rks, w, x1, x0, p1, p0);
  } else {
    uint32_t x[2][4], bit[2];
    for (int q = 0; q < 4; ++q) {
      x[0][q] = ~p0.s[q];
      x[1][q] = ~p1.s[q];
    }
    bk_encrypt<0, 2>(t, rks, x, bit);
    x[0][0] = bit[0];
    x[1][0] = bit[1];
    walk_turn<GW>(p0, x0, x[0], x[0], w);
    walk_turn<GW>(p1, x1, x[1], x[1], w);
  }
}

// A walk's start: from the root (seed s0, t = the party), or from the
// frontier row of a point (s with t in bit 0 of byte 15, then v).
DCF_HD void walk_root(KlState& p, const uint32_t s0[4], uint32_t t0) {
  for (int q = 0; q < 4; ++q) {
    p.s[q] = s0[q];
    p.v[q] = 0u;
  }
  p.t = t0;
}

DCF_HD void walk_row(KlState& p, const uint8_t* row) {
  load16(row, p.s);
  load16(row + 16, p.v);
  p.t = (p.s[3] >> 24) & 1u;
  p.s[3] &= kMaskBit;
}

// ---------------------------------------------------------------------------
// Kernel B2 (tree_expand.cu): breadth-first levels of one key's lam = 16
// tree, any group.  Every parent expands into both children, so every lane
// computes E(s) and E(~s) in full and no vote is needed.
// ---------------------------------------------------------------------------

// 16 bytes at p (16-byte aligned on the card) from four little-endian
// words.
DCF_HD void store16(uint8_t* p, const uint32_t w[4]) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
#else
  for (int q = 0; q < 4; ++q)
    for (int j = 0; j < 4; ++j) p[4 * q + j] = (uint8_t)(w[q] >> (8 * j));
#endif
}

struct TreeNode {
  uint32_t s[4], v[4], t;
};

// A parent into its two children (tree_node of dcf_walk.cuh on the banked
// AES): E(s) and E(~s) in lockstep under one cipher.
template <int GW>
DCF_HD void tree_node_banked(const BkLane& t, const RoundKey* rk,
                             const LevelCw& w, const TreeNode& p,
                             TreeNode c[2]) {
  uint32_t x[2][4];
  for (int q = 0; q < 4; ++q) {
    x[0][q] = p.s[q];
    x[1][q] = ~p.s[q];
  }
  const RoundKey* const rks[2] = {rk, rk};
  bk_encrypt<2>(t, rks, x);
  Children h;
  hirose_children(p.s, x[0], x[1], h);
  tree_children<GW>(h, w, p.v, p.t, c[0].s, c[0].v, c[0].t, c[1].s, c[1].v,
                    c[1].t);
}

// B2's per-thread body: the parent p expanded D levels in registers, w[0..D)
// the correction words of its level and the D - 1 below.  The 2^D nodes
// of the last go to rows pos + stride * r of s_out, v_out ([rows, 16]) and
// t_out ([rows]), r their walk directions LSB first: with pos the parent's
// index j and stride the level's N parents, the rows D launches of one
// level each would fill ([lefts ; rights] a level).  FINAL (B2f): the last
// level is the tree's, and only the leaf shares y = v + s + t * cw_np1 (np1,
// the group's finalize) go to s_out; v_out and t_out are not written.  One
// call site of tree_node_banked a level: the two children in a rolled
// loop.
template <int GW, int D, bool FINAL = false>
DCF_HD void tree_subtree(const BkLane& t, const RoundKey* rk,
                         const LevelCw* w, const TreeNode& p, uint8_t* s_out,
                         uint8_t* v_out, uint8_t* t_out, size_t pos,
                         size_t stride, const uint32_t* np1 = nullptr) {
  TreeNode c[2];
  tree_node_banked<GW>(t, rk, w[0], p, c);
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int d = 0; d < 2; ++d) {
    TreeNode cd;
    for (int q = 0; q < 4; ++q) {
      cd.s[q] = d ? c[1].s[q] : c[0].s[q];
      cd.v[q] = d ? c[1].v[q] : c[0].v[q];
    }
    cd.t = d ? c[1].t : c[0].t;
    const size_t at = pos + (size_t)d * stride;
    if constexpr (D == 1 && FINAL) {
      uint32_t y[4];
      finalize<GW>(cd.s, cd.t, cd.v, np1, false, y);
      store16(s_out + 16 * at, y);
    } else if constexpr (D == 1) {
      store16(s_out + 16 * at, cd.s);
      store16(v_out + 16 * at, cd.v);
      t_out[at] = (uint8_t)cd.t;
    } else {
      tree_subtree<GW, D - 1, FINAL>(t, rk, w + 1, cd, s_out, v_out, t_out,
                                     at, 2 * stride, np1);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel B3 (prefix_eval.cu): the slot-per-point schedule.  A lane holds
// kPrefixSlots points in flight, one a slot, and a step runs one block of
// every slot in lockstep (bk_encrypt<C>, one cipher): the block that the
// slot's own point needs at its own level.  A right turn is one step,
// E(~s); a left turn two, E(~s) then E(s).  v takes its level's update
// from E(~s) at the turn's first step, s and t theirs from the turn's last
// block, so nothing but the phase is carried between a left turn's two
// steps.  Every step of a live slot carries a needed block (a right turn's
// E(~s) in full: 224 lookups where the function needs 197), so random
// points issue 336 lookups a point and level, 1.042x the 322.5 they need,
// against 448 for the pair walk's vote.  The slots leave level lockstep:
// each reads its own level's correction words and walk bit, and a slot
// whose point has walked level n - 1 stores its share and takes the lane's
// next point.  No lane reads another lane's state, so a host test can run
// the lanes of a warp one after another.  Some units are left to the pair
// walk (pair_walks_unit).
// ---------------------------------------------------------------------------

#if defined(__CUDACC__)
#define DCF_UNROLL _Pragma("unroll")
#else
#define DCF_UNROLL
#endif

constexpr int kPrefixSlots = 4;  // points in flight a lane

// B3's arguments: K keys' stacked frontier tables (table [K * 2^k, 32]),
// correction words (cw_s / cw_v [K, n, 16], cw_t [K, n, 2], cw_np1
// [K, 16]), the points all keys share (xs [m, nb], nb = n / 8) and the
// shares (y [K, m, 16]).  A unit is (key, tile): tile j of a key holds its
// points j * 32 C .. (j + 1) * 32 C - 1, point l + 32 c of it lane l's
// c-th.
struct SlotWalk {
  const uint8_t* table;
  const uint8_t* cw_s;
  const uint8_t* cw_v;
  const uint8_t* cw_t;
  const uint8_t* cw_np1;
  const uint8_t* xs;
  uint8_t* y;
  int n, nb, k, m;
  bool negate;
  int tiles, keys;
};

// A slot: point pt of key `key` at level i (i == n: the slot is empty), in
// the first (ph 0, E(~s)) or second (ph 1, E(s)) step of its turn; win
// holds its walk bits of levels i.. from bit 31 down.
struct Slot {
  KlState p;
  uint32_t ph, win;
  int i, key, pt;
};

// A warp's units, in order: tile `tile` of key `key`, then `stride` units
// on (into the next keys past a key's last tile).
struct SlotUnits {
  int key, tile, stride;
};

DCF_HD void slot_units_next(const SlotWalk& a, SlotUnits& u) {
  u.tile += u.stride;
  u.key += u.tile / a.tiles;
  u.tile %= a.tiles;
}

constexpr int kSlotMinLevels = 16;  // shorter walks go to the pair walk

// Whether B3 walks a unit (tile `tile` of every key) two points a lane
// with the pair walk's vote (walk_pair_levels) rather than on its slots:
// where its points turn alike, its first and last points sharing their
// walk bits at levels k .. n - 1 - (n - k) / 4 (sorted points then share
// them all, and the vote computes no more than their turns need there,
// where the slots compute a right turn's E(~s) in full); and on walks of
// fewer than kSlotMinLevels levels, where a slot would store a share and
// take a point every few steps.  Every lane reads the same two points, so
// the lanes agree on a unit without a vote.
template <int C>
DCF_HD bool pair_walks_unit(const SlotWalk& a, int tile) {
  if (a.n - a.k < kSlotMinLevels) return true;
  const int first = tile * (kLanes * C);
  const int last = (first + kLanes * C < a.m ? first + kLanes * C : a.m) - 1;
  const uint8_t* x0 = a.xs + (size_t)first * a.nb;
  const uint8_t* x1 = a.xs + (size_t)last * a.nb;
  for (int i = a.k; i < a.n - (a.n - a.k) / 4; ++i)
    if (walk_bit(x0, i) != walk_bit(x1, i)) return false;
  return true;
}

// A lane's points, in order: C of each unit of its warp that the pair walk
// does not take, the c-th next.
struct SlotQueue {
  SlotUnits u;
  int c;
};

DCF_HD uint32_t brev32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __brev(x);
#else
  uint32_t r = 0;
  for (int j = 0; j < 32; ++j) r |= ((x >> j) & 1u) << (31 - j);
  return r;
#endif
}

// Walk bits i..i+31 of x (nb bytes) from bit 31 down, zeros past its end.
DCF_HD uint32_t walk_window(const uint8_t* x, int i, int nb) {
  uint64_t w = 0;
  for (int j = 0; j < 5; ++j) {
    const int b = (i >> 3) + j;
    w = (w << 8) | (b < nb ? x[b] : 0u);
  }
  return (uint32_t)(w >> (8 - (i & 7)));
}

// The lane's next point into slot s, its frontier row gathered (its index
// the first k <= 30 walk bits, reversed); empty if the lane has none
// left.  Points past m are skipped.
template <int C>
DCF_HD void slot_take(const SlotWalk& a, SlotQueue& q, int lane, Slot& s) {
  s.i = a.n;
  while (q.u.key < a.keys) {
    if (q.c == 0 && pair_walks_unit<C>(a, q.u.tile)) {
      slot_units_next(a, q.u);
      continue;
    }
    s.key = q.u.key;
    s.pt = q.u.tile * (kLanes * C) + lane + kLanes * q.c;
    if (++q.c == C) {
      q.c = 0;
      slot_units_next(a, q.u);
    }
    if (s.pt < a.m) {
      const uint8_t* x = a.xs + (size_t)s.pt * a.nb;
      const uint32_t idx =
          brev32(walk_window(x, 0, a.nb)) & ((1u << a.k) - 1u);
      walk_row(s.p, a.table + (((size_t)s.key << a.k) + idx) * 32);
      s.i = a.k;
      s.ph = 0u;
      s.win = walk_window(x, a.k, a.nb);
      return;
    }
  }
}

// One step of a live slot, from the block `out` that it computed (E(~s)
// at ph 0, E(s) at ph 1): walk_turn's algebra split over the turn's
// steps, its selects on the phase and the walk bit.
template <int GW>
DCF_HD void slot_step(const SlotWalk& a, Slot& s, const uint32_t out[4]) {
  const uint32_t xb = s.win >> 31;
  const uint32_t row = (uint32_t)(s.key * a.n + s.i);
  uint32_t ws[4], wv[4];
  load16(a.cw_s + 16 * (size_t)row, ws);
  load16(a.cw_v + 16 * (size_t)row, wv);
  const uint32_t ct = a.cw_t[2 * (size_t)row + xb] & 1u;
  const uint32_t first = s.ph - 1u;  // all ones at a turn's first step
  const uint32_t lm = xb - 1u;       // all ones on a left turn
  const uint32_t g = 0u - s.p.t;
  uint32_t sc[4], vc[4];
  for (int q = 0; q < 4; ++q) {
    sc[q] = s.p.s[q] ^ (out[q] & ~first);  // left E(s) ^ s, right s
    vc[q] = ~s.p.s[q] ^ (out[q] & lm);     // left E(~s) ^ ~s, right ~s
  }
  const uint32_t tc = (out[0] ^ s.p.s[0] ^ first) & 1u;
  sc[3] &= kMaskBit;
  vc[3] &= kMaskBit;
  for (int q = 0; q < 4; ++q)
    s.p.v[q] = gadd<GW>(s.p.v[q], gadd<GW>(vc[q], wv[q] & g) & first);
  if (s.ph | xb) {  // the turn's last block
    for (int q = 0; q < 4; ++q) s.p.s[q] = sc[q] ^ (ws[q] & g);
    s.p.t = tc ^ (s.p.t & ct);
    s.ph = 0u;
    s.win <<= 1;
    if (((++s.i - a.k) & 31) == 0 && s.i < a.n)
      s.win = walk_window(a.xs + (size_t)s.pt * a.nb, s.i, a.nb);
  } else {
    s.ph = 1u;
  }
}

// Lane `lane`'s part of B3 on a warp that takes units first, first +
// stride, ...: its C slots run until the lane has no point left in the
// units the pair walk does not take.  Returns the steps the lane ran;
// *carried (if given) counts its slots' live steps, each a needed block.
template <int GW, int C>
DCF_HD long long prefix_slot_walk(const BkWin& t, const RoundKey* rk,
                                  const SlotWalk& a, int lane, int first,
                                  int stride, long long* carried = nullptr) {
  SlotQueue q{{first / a.tiles, first % a.tiles, stride}, 0};
  Slot sl[C];
  const RoundKey* rks[C];
  DCF_UNROLL
  for (int c = 0; c < C; ++c) {
    rks[c] = rk;  // one cipher
    slot_take<C>(a, q, lane, sl[c]);
  }
  long long steps = 0;
  for (;;) {
    bool live = false;
    DCF_UNROLL
    for (int c = 0; c < C; ++c) live |= sl[c].i < a.n;
    if (!live) break;
    ++steps;
    uint32_t x[C][4];
    DCF_UNROLL
    for (int c = 0; c < C; ++c)
      for (int w = 0; w < 4; ++w) x[c][w] = sl[c].p.s[w] ^ (sl[c].ph - 1u);
    bk_encrypt<C>(t, rks, x);
    DCF_UNROLL
    for (int c = 0; c < C; ++c) {
      if (sl[c].i == a.n) continue;
      if (carried) ++*carried;
      slot_step<GW>(a, sl[c], x[c]);
      if (sl[c].i == a.n) {  // the point's share, then the next point
        uint32_t np1[4], y[4];
        load16(a.cw_np1 + 16 * (size_t)sl[c].key, np1);
        finalize<GW>(sl[c].p.s, sl[c].p.t, sl[c].p.v, np1, a.negate, y);
        store16(a.y + ((size_t)sl[c].key * a.m + sl[c].pt) * 16, y);
        slot_take<C>(a, q, lane, sl[c]);
      }
    }
  }
  return steps;
}

#if defined(__CUDACC__)
// Block-cooperative fills; the caller syncs.
__device__ __forceinline__ void fill_banked_table(uint32_t* te,
                                                  const uint8_t* sbox) {
  for (int e = threadIdx.x; e < kBankedWords; e += blockDim.x)
    te[e] = banked_table_word(sbox, e);
}

// BkWin's second table: each word of the first rotated by 8 bits.
__device__ __forceinline__ void fill_banked_table_rot8(uint32_t* te,
                                                       const uint8_t* sbox) {
  for (int e = threadIdx.x; e < kBankedWords; e += blockDim.x)
    te[e] = rotl32(banked_table_word(sbox, e), 8);
}

__device__ __forceinline__ void fill_round_keys(RoundKey* rk,
                                                const uint8_t* bytes) {
  for (int i = threadIdx.x; i < 60; i += blockDim.x)
    rk[i >> 2].w[i & 3] = le32(bytes + 4 * i);
}

// B1's level loop, and B3's on the units it walks two points a lane: a
// lane walks its two points (bytes at x0 and x1) through levels lo..n-1 of
// one key (rows cw_s, cw_v, cw_t).
template <int GW>
__device__ __forceinline__ void walk_pair_levels(
    const BkLane& t, const RoundKey* rk, const uint8_t* cw_s,
    const uint8_t* cw_v, const uint8_t* cw_t, int lo, int n,
    const uint8_t* x0, const uint8_t* x1, KlState& p0, KlState& p1) {
  for (int i = lo; i < n; ++i) {
    LevelCw w;
    walk_cw(cw_s, cw_v, cw_t, i, w);
    const uint32_t b0 = walk_bit(x0, i), b1 = walk_bit(x1, i);
    walk_level_pair<GW>(t, rk, w, b0, b1,
                        __any_sync(0xFFFFFFFFu, b0 == 0u) != 0,
                        __any_sync(0xFFFFFFFFu, b1 == 0u) != 0, p0, p1);
  }
}
#endif

}  // namespace dcf
