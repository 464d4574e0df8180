// Per-thread key generation shared by the Hopper keygen kernels: one
// level loop with three instantiations (keygen_walk.cu), and the wide tail
// of a lam >= 48 key (keygen_wide.cu):
//
//   G1   kKgDcf16   replaces the XLA level scan of
//                   dcf_tpu/backends/device_gen.py::_gen_core (lam = 16)
//   B7a  kKgNarrow  replaces dcf_tpu/ops/pallas_keygen.py::dcf_keygen_walk_pallas
//                   (the 32-byte narrow part of a lam >= 48 key)
//   B7b  kKgDpf32   replaces dcf_tpu/ops/pallas_keygen.py::dpf_keygen_walk_pallas
//                   (lam = 32 DPF keys)
//   G2   kKgDcf32   replaces the XLA level scan of
//                   dcf_tpu/backends/device_gen.py::_gen_core (lam = 32)
//   W2   wide_tail_column replaces the XLA lax.scan of
//                   dcf_tpu/ops/pallas_keygen.py::_keygen_wide_tail
//                   (bytes 32..lam-1 of a lam >= 48 key)
//
// Keygen walks the GGM tree once per key, along alpha's path: at each level
// both parties' seeds expand through the same Hirose PRG as evaluation, the
// lose-side children of the two expansions give the level's correction
// words, and the keep-side children, corrected, carry the walk (the
// reference's src/lib.rs:86-161; the port's numpy gen.gen_batch and
// protocols.dpf.dpf_gen_batch are the oracles).  The TPU kernels pack 32
// keys per lane word and walk bit planes; here one thread owns one key for
// all n levels, with both parties' seeds, t bits and v_alpha in registers,
// and writes the correction words as the byte rows of a KeyBundle.
//
// The level loop (keygen_key), the level's algebra (keygen_level) and the
// stores are one copy; the expansion of both parties' seeds at a level is
// keygen_key's policy argument, with the table it reads (four modes):
//
//   G1   KgBanked16: one Hirose block a party, E(s) and E(~s) under cipher
//        0, both parties' four blocks in lockstep on the banked AES of
//        aes_banked.cuh; the mask bit 8*lam-1 = bit 0 of byte 15 cleared
//        in all four children.
//   B7a  KgBankedNarrow: the narrow step of narrow_walk.cuh, unmasked (the
//        mask bit of a lam >= 48 PRG lies in the wide part): E0 and E17 on
//        (s, ~s), a party's four blocks in lockstep on the banked AES,
//        the block set-up and the children B5a's (narrow_step_in,
//        narrow_children).  It also writes both
//        parties' t at the entry of every level, the trajectories the wide
//        tail is computed from.
//   B7b  KgBankedDpf: the masked lam = 32 DPF step of B6's node
//        (dpf_step_in and dpf_children of narrow_walk.cuh), uncorrected:
//        E0(s_b0) and E17(s_b1) in full and E0(~s_b0) to its t bit
//        (E17(~s_b1) feeds only v, which a DPF has not), both parties'
//        blocks in lockstep on the banked AES; bit 0 of byte 31 cleared in
//        block 1 of both children.  No v column: cw_np1 = s_a ^ s_b ^
//        beta.
//   G2   KgBankedDcf32: B7a's expansion (E0 and E17 on (s, ~s), a party's
//        four blocks in lockstep), then the lam = 32 PRG's mask, bit 0 of
//        byte 31 cleared in all four children (block 1's word 3), after
//        the t bits are read.  No trajectory; cw_np1 = s_a ^ s_b ^ v_alpha
//        over the 32 bytes, as at lam = 16.
//
// Beyond byte 32 the Hirose PRG of lam >= 48 copies its input, so the wide
// part of B7a's keys is a GF(2) recursion over alpha's bits and the two
// trajectories, independent per byte: wide_tail_column carries one
// 16-byte column of one key through the n levels.
//
// Plain C++ over uint32_t; it also compiles on the host.

#pragma once

#include <string.h>

#include "narrow_walk.cuh"

namespace dcf {

enum KgMode { kKgDcf16 = 0, kKgNarrow = 1, kKgDpf32 = 2, kKgDcf32 = 3 };

// Words a party's seed has in each mode, and whether the key has a v column.
template <int MODE>
struct Kg {
  static constexpr int W = MODE == kKgDcf16 ? 4 : 8;
  static constexpr bool V = MODE != kKgDpf32;
};

// The carry of one key's keygen: both parties' seeds and t bits, v_alpha.
template <int W>
struct KgState {
  uint32_t sa[W], sb[W], va[W];
  uint32_t ta, tb;
};

// One party's Hirose children at lam = 16 from es = E(s) and ev = E(~s)
// under cipher 0 (hirose_expand in dcf_walk.cuh): t from the unmasked
// bit 0 of byte 0, then bit 0 of byte 15 cleared in all four children.
DCF_HD void kg_hirose(const uint32_t s[4], const uint32_t es[4],
                      const uint32_t ev[4], StepChildren<4>& c) {
  for (int q = 0; q < 4; ++q) {
    c.sl[q] = es[q] ^ s[q];
    c.vl[q] = ev[q] ^ ~s[q];
    c.sr[q] = s[q];
    c.vr[q] = ~s[q];
  }
  c.tl = c.sl[0] & 1u;
  c.tr = c.vl[0] & 1u;
  c.sl[3] &= kMaskBit;
  c.vl[3] &= kMaskBit;
  c.sr[3] &= kMaskBit;
  c.vr[3] &= kMaskBit;
}

// G1's expansion: the lane's view t of the banked AES and cipher 0's round
// keys rk.
struct KgBanked16 {
  BkLane t;
  const RoundKey* rk;
};

// Both parties' E(s) and E(~s), four full blocks in lockstep.  Every lane
// does the same work: no vote.
DCF_HD void kg_expand(const KgBanked16& e, const uint32_t sa[4],
                      const uint32_t sb[4], StepChildren<4>& ea,
                      StepChildren<4>& eb) {
  uint32_t x[4][4];
  for (int q = 0; q < 4; ++q) {
    x[0][q] = sa[q];
    x[1][q] = ~sa[q];
    x[2][q] = sb[q];
    x[3][q] = ~sb[q];
  }
  const RoundKey* const rks[4] = {e.rk, e.rk, e.rk, e.rk};
  bk_encrypt<4>(e.t, rks, x);
  kg_hirose(sa, x[0], x[1], ea);
  kg_hirose(sb, x[2], x[3], eb);
}

// B7a's expansion: the lane's view t of the banked AES, cipher 0's and
// cipher 17's round keys.
struct KgBankedNarrow {
  BkLane t;
  const RoundKey* rk0;
  const RoundKey* rk17;
};

// Both parties' unmasked narrow steps, a party's four full blocks in
// lockstep, one party after the other (all eight in lockstep ran 2%
// slower at lam = 256, K = 2^16).  Every lane does the same work: no
// vote.
DCF_HD void kg_expand(const KgBankedNarrow& e, const uint32_t sa[8],
                      const uint32_t sb[8], StepChildren<8>& ea,
                      StepChildren<8>& eb) {
  const RoundKey* const rks[4] = {e.rk0, e.rk0, e.rk17, e.rk17};
  uint32_t x[4][4];
  narrow_step_in(sa, x);
  bk_encrypt<4>(e.t, rks, x);
  narrow_children(sa, x, ea);
  narrow_step_in(sb, x);
  bk_encrypt<4>(e.t, rks, x);
  narrow_children(sb, x, eb);
}

// G2's expansion: B7a's, masked.
struct KgBankedDcf32 {
  KgBankedNarrow narrow;
};

// Both parties' lam = 32 Hirose steps, uncorrected: the narrow step of
// B7a, then bit 0 of byte 31 (word 7, kMaskBit) cleared in the four
// children of each party, as kg_hirose masks bit 0 of byte 15 at
// lam = 16; the t bits come from word 0, before the mask.
DCF_HD void kg_mask32(StepChildren<8>& c) {
  c.sl[7] &= kMaskBit;
  c.vl[7] &= kMaskBit;
  c.sr[7] &= kMaskBit;
  c.vr[7] &= kMaskBit;
}

DCF_HD void kg_expand(const KgBankedDcf32& e, const uint32_t sa[8],
                      const uint32_t sb[8], StepChildren<8>& ea,
                      StepChildren<8>& eb) {
  kg_expand(e.narrow, sa, sb, ea, eb);
  kg_mask32(ea);
  kg_mask32(eb);
}

// B7b's expansion: the lane's view t of the banked AES, cipher 0's and
// cipher 17's round keys.
struct KgBankedDpf {
  BkLane t;
  const RoundKey* rk0;
  const RoundKey* rk17;
};

// Both parties' masked lam = 32 DPF steps, uncorrected (B6's step:
// dpf_step_in and dpf_children of narrow_walk.cuh): both parties' four
// blocks and two t bits in lockstep (bk_encrypt<4, 2>; a party's two
// blocks and t bit, one party after the other, as B6's dpf_step_banked
// runs them, took 0.341-0.342 ms against 0.336-0.339 at n = 24, K = 2^16,
// both at 127 registers, in turns).  Every lane does the same work: no
// vote.
DCF_HD void kg_expand(const KgBankedDpf& e, const uint32_t sa[8],
                      const uint32_t sb[8], StepChildren<8>& ea,
                      StepChildren<8>& eb) {
  uint32_t xa[3][4], xb[3][4], x[6][4], bit[2];
  dpf_step_in(sa, xa);
  dpf_step_in(sb, xb);
  for (int q = 0; q < 4; ++q) {
    x[0][q] = xa[0][q];
    x[1][q] = xa[1][q];
    x[2][q] = xb[0][q];
    x[3][q] = xb[1][q];
    x[4][q] = xa[2][q];
    x[5][q] = xb[2][q];
  }
  const RoundKey* const rk[6] = {e.rk0, e.rk17, e.rk0, e.rk17, e.rk0, e.rk0};
  bk_encrypt<4, 2>(e.t, rk, x, bit);
  dpf_children(sa, x, bit[0], ea.sl, ea.tl, ea.sr, ea.tr);
  dpf_children(sb, x + 2, bit[1], eb.sl, eb.tl, eb.sr, eb.tr);
}

// One keygen level from both parties' expansions.  a is alpha's walk bit:
// 1 keeps the right child and loses the left (src/lib.rs:107-111).  Writes
// the level's seed (and value) correction and its t bits (tl in bit 0, tr
// in bit 1), and advances the carry.  beta folds into the value correction
// on the lose side under LT_BETA and on the keep side under GT_BETA.
template <int W, bool V>
DCF_HD void keygen_level(const StepChildren<W>& ea,
                         const StepChildren<W>& eb, uint32_t a, bool lt,
                         const uint32_t beta[W], KgState<W>& st,
                         uint32_t cs[W], uint32_t cv[W], uint32_t& ct) {
  const uint32_t am = 0u - a;  // all ones where the left child is lost
  const uint32_t bg = lt ? am : ~am;
  const uint32_t ga = 0u - st.ta;
  const uint32_t gb = 0u - st.tb;
  const uint32_t tl_cw = ea.tl ^ eb.tl ^ a ^ 1u;
  const uint32_t tr_cw = ea.tr ^ eb.tr ^ a;
  const uint32_t t_keep = a ? tr_cw : tl_cw;
  for (int q = 0; q < W; ++q) {
    cs[q] = ((ea.sl[q] ^ eb.sl[q]) & am) | ((ea.sr[q] ^ eb.sr[q]) & ~am);
    if constexpr (V) {
      const uint32_t dl = ea.vl[q] ^ eb.vl[q];
      const uint32_t dr = ea.vr[q] ^ eb.vr[q];
      cv[q] = ((dl & am) | (dr & ~am)) ^ st.va[q] ^ (beta[q] & bg);
      st.va[q] ^= ((dr & am) | (dl & ~am)) ^ cv[q];
    }
    st.sa[q] = ((ea.sr[q] & am) | (ea.sl[q] & ~am)) ^ (cs[q] & ga);
    st.sb[q] = ((eb.sr[q] & am) | (eb.sl[q] & ~am)) ^ (cs[q] & gb);
  }
  ct = tl_cw | (tr_cw << 1);
  st.ta = (a ? ea.tr : ea.tl) ^ (st.ta & t_keep);
  st.tb = (a ? eb.tr : eb.tl) ^ (st.tb & t_keep);
}

// nw little-endian words to p (16-byte aligned rows on the card).
DCF_HD void kg_store(uint8_t* p, const uint32_t* w, int nw) {
#if defined(__CUDA_ARCH__)
  uint4* o = reinterpret_cast<uint4*>(p);
  for (int j = 0; j < nw / 4; ++j)
    o[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
#else
  memcpy(p, w, 4 * (size_t)nw);
#endif
}

// 4 little-endian words to p (16-byte aligned on the card) that this
// kernel does not read back: a streaming store (st.global.cs, evict first)
// on the card.
DCF_HD void kg_store_stream(uint8_t* p, const uint32_t w[4]) {
#if defined(__CUDA_ARCH__)
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
#else
  memcpy(p, w, 16);
#endif
}

// Two bytes b0, b1 (0/1) to p: a level's cw_t or trajectory pair, one
// 2-byte store on the card.
DCF_HD void kg_store2(uint8_t* p, uint32_t b0, uint32_t b1) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)(b0 | (b1 << 8));
#else
  p[0] = (uint8_t)b0;
  p[1] = (uint8_t)b1;
#endif
}

// The whole keygen of one key, n levels, both parties' seeds expanded at
// each level by `expand` (KgBanked16, KgBankedNarrow, KgBankedDpf or
// KgBankedDcf32).  alpha:
// n/8 bytes, read a byte each 8 levels; beta: the key's beta row; s0a /
// s0b: the parties' root seeds.  Rows of lam bytes: cw_s (and cw_v) [n][lam],
// cw_np1 [lam], of which the first 4 * W bytes are written; cw_t [n][2]
// bytes (0/1); traj, when not null, [n][2] bytes: party 0's and party 1's
// t at the entry of each level.
template <int MODE, typename Expand>
DCF_HD void keygen_key(const Expand& expand, int n, bool lt,
                       const uint8_t* alpha, const uint8_t* beta,
                       const uint8_t* s0a, const uint8_t* s0b, int lam,
                       uint8_t* cw_s, uint8_t* cw_v, uint8_t* cw_t,
                       uint8_t* cw_np1, uint8_t* traj) {
  constexpr int W = Kg<MODE>::W;
  constexpr bool V = Kg<MODE>::V;
  KgState<W> st;
  uint32_t bw[W];
  for (int q = 0; q < W; ++q) {
    st.sa[q] = le32(s0a + 4 * q);
    st.sb[q] = le32(s0b + 4 * q);
    st.va[q] = 0u;
    bw[q] = le32(beta + 4 * q);
  }
  st.ta = 0u;  // party 0 starts at t = 0, party 1 at t = 1
  st.tb = 1u;
  uint32_t ab = 0u;  // the byte of alpha that holds walk bit i
  for (int i = 0; i < n; ++i) {
    if ((i & 7) == 0) ab = alpha[i >> 3];
    if (traj) kg_store2(traj + 2 * i, st.ta, st.tb);
    StepChildren<W> ea, eb;
    kg_expand(expand, st.sa, st.sb, ea, eb);
    uint32_t cs[W], cv[W], ct;
    keygen_level<W, V>(ea, eb, (ab >> (7 - (i & 7))) & 1u, lt, bw, st, cs, cv,
                       ct);
    kg_store(cw_s + (size_t)i * lam, cs, W);
    if constexpr (V) kg_store(cw_v + (size_t)i * lam, cv, W);
    kg_store2(cw_t + 2 * i, ct & 1u, ct >> 1);
  }
  uint32_t np1[W];
  for (int q = 0; q < W; ++q)
    np1[q] = st.sa[q] ^ st.sb[q] ^ (V ? st.va[q] : bw[q]);
  kg_store(cw_np1, np1, W);
}

// W2's body: one 16-byte column of the wide part (bytes 32..lam-1) of one
// key through its n levels, from the trajectories B7a wrote.  With mask
// clearing the PRG's bit 8*lam-1 (bit 0 of byte lam-1: the top byte of
// word 3 of the last column, `last`) and g alpha's walk bit i, inverted
// under GT_BETA, each level is
//
//   s_cw = mask(s_a ^ s_b)            (the lose and keep sides agree)
//   v_cw = s_cw ^ v ^ beta * g
//   v'   = v ^ s_cw ^ v_cw            (v_l == v_r)
//   s_p' = mask(s_p) ^ s_cw * t_p     (p in {a, b}, t_p from traj)
//
// and cw_np1 = s_a ^ s_b ^ v after the last.  alpha: the key's n/8 bytes;
// traj: its [n][2] trajectory bytes (16-byte aligned on the card), both
// read once each 8 levels; beta, s0a, s0b: the column's 16 bytes of the
// key's beta and root seeds; cw_s, cw_v: the column in level row 0 (rows
// lam bytes apart); np1: the column of cw_np1.
DCF_HD void wide_tail_column(int n, bool lt, bool last, int lam,
                             const uint8_t* alpha, const uint8_t* traj,
                             const uint8_t* beta, const uint8_t* s0a,
                             const uint8_t* s0b, uint8_t* cw_s,
                             uint8_t* cw_v, uint8_t* np1) {
  uint32_t sa[4], sb[4], v[4] = {0u, 0u, 0u, 0u}, bw[4], tw[4];
  load16(s0a, sa);
  load16(s0b, sb);
  load16(beta, bw);
  const uint32_t m3 = last ? kMaskBit : 0xFFFFFFFFu;
  const uint32_t flip = lt ? 0u : 1u;
  uint32_t ab = 0u;
  for (int i = 0; i < n; ++i) {
    if ((i & 7) == 0) {
      ab = alpha[i >> 3];
      load16(traj + 2 * i, tw);  // levels i..i+7, a 16-bit pair each
    }
    const uint32_t g = 0u - (((ab >> (7 - (i & 7))) & 1u) ^ flip);
    const uint32_t tp = tw[(i & 7) >> 1] >> (16 * (i & 1));
    const uint32_t ga = 0u - (tp & 1u);
    const uint32_t gb = 0u - ((tp >> 8) & 1u);
    uint32_t sx[4], vc[4];
    for (int q = 0; q < 4; ++q) {
      const uint32_t m = q == 3 ? m3 : 0xFFFFFFFFu;
      sx[q] = (sa[q] ^ sb[q]) & m;
      vc[q] = sx[q] ^ v[q] ^ (bw[q] & g);
      v[q] ^= sx[q] ^ vc[q];
      sa[q] = (sa[q] & m) ^ (sx[q] & ga);
      sb[q] = (sb[q] & m) ^ (sx[q] & gb);
    }
    kg_store_stream(cw_s + (size_t)i * lam, sx);
    kg_store_stream(cw_v + (size_t)i * lam, vc);
  }
  for (int q = 0; q < 4; ++q) sa[q] ^= sb[q] ^ v[q];
  kg_store(np1, sa, 4);
}

}  // namespace dcf
