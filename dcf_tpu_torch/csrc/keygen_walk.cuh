// Per-thread key generation shared by the three Hopper keygen kernels of
// keygen_walk.cu, one function with three instantiations:
//
//   G1   kKgDcf16   replaces the XLA level scan of
//                   dcf_tpu/backends/device_gen.py::_gen_core (lam = 16)
//   B7a  kKgNarrow  replaces dcf_tpu/ops/pallas_keygen.py::dcf_keygen_walk_pallas
//                   (the 32-byte narrow part of a lam >= 48 key)
//   B7b  kKgDpf32   replaces dcf_tpu/ops/pallas_keygen.py::dpf_keygen_walk_pallas
//                   (lam = 32 DPF keys)
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
// keygen_key's policy argument, with the table it reads:
//
//   G1   KgBanked16: one Hirose block a party, E(s) and E(~s) under cipher
//        0, both parties' four blocks in lockstep on the banked AES of
//        aes_banked.cuh; the mask bit 8*lam-1 = bit 0 of byte 15 cleared
//        in all four children.
//   B7a  KgTables<kKgNarrow>, on the T-tables of dcf_walk.cuh: the narrow
//        step of narrow_walk.cuh, unmasked (the mask bit of a lam >= 48 PRG
//        lies in the wide part): E0 and E17 on (s, ~s), four blocks a
//        party.  It also writes both parties' t at the entry of every
//        level, the trajectories the wide tail (bytes 32..lam-1,
//        ops.keygen_walk.keygen_wide_tail) is computed from.
//   B7b  KgTables<kKgDpf32>: the masked lam = 32 DPF step of B6's node:
//        E0(s_b0), E0(~s_b0), E17(s_b1), three blocks a party (E17(~s_b1)
//        feeds only v, which a DPF has not); bit 0 of byte 31 cleared in
//        block 1 of both children.  No v column: cw_np1 = s_a ^ s_b ^ beta.
//
// Plain C++ over uint32_t; it also compiles on the host.

#pragma once

#include <string.h>

#include "narrow_walk.cuh"

namespace dcf {

enum KgMode { kKgDcf16 = 0, kKgNarrow = 1, kKgDpf32 = 2 };

// Words a party's seed has in each mode, and whether the key has a v column.
template <int MODE>
struct Kg {
  static constexpr int W = MODE == kKgDcf16 ? 4 : 8;
  static constexpr bool V = MODE != kKgDpf32;
};

// One party's seed expanded at one level: both children's seeds and values
// as the level's PRG gives them (mask applied where the PRG masks), and the
// t bits from the unmasked outputs.
template <int W>
struct KgChildren {
  uint32_t sl[W], sr[W], vl[W], vr[W];
  uint32_t tl, tr;
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
                      const uint32_t ev[4], KgChildren<4>& c) {
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
                      const uint32_t sb[4], KgChildren<4>& ea,
                      KgChildren<4>& eb) {
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

// B7a's expansion: the unmasked narrow step (narrow_level's children).
DCF_HD void kg_expand_narrow(const NarrowTables& T, const uint32_t s[8],
                             KgChildren<8>& c) {
  uint32_t sp[8], es[8], ev[8];
  for (int q = 0; q < 8; ++q) sp[q] = ~s[q];
  aes256_encrypt2_rk(T.a, T.a.rk, s, sp, es, ev);
  aes256_encrypt2_rk(T.a, T.rk17, s + 4, sp + 4, es + 4, ev + 4);
  for (int q = 0; q < 8; ++q) {
    es[q] ^= s[q];
    ev[q] ^= sp[q];
  }
  c.tl = es[0] & 1u;
  c.tr = ev[0] & 1u;
  for (int q = 0; q < 8; ++q) {
    c.sl[q] = q < 4 ? es[q] : s[q];
    c.sr[q] = q < 4 ? s[q] : es[q];
    c.vl[q] = q < 4 ? ev[q] : sp[q];
    c.vr[q] = q < 4 ? sp[q] : ev[q];
  }
}

// B7b's expansion: dpf_node's masked lam = 32 step, seeds only.
DCF_HD void kg_expand_dpf(const NarrowTables& T, const uint32_t s[8],
                          KgChildren<8>& c) {
  uint32_t sp[4], e0[4], e0p[4], e1[4];
  for (int q = 0; q < 4; ++q) sp[q] = ~s[q];
  aes256_encrypt3_rk(T.a, T.a.rk, T.rk17, s, sp, s + 4, e0, e0p, e1);
  c.tl = (e0[0] ^ s[0]) & 1u;
  c.tr = (e0p[0] ^ sp[0]) & 1u;
  for (int q = 0; q < 4; ++q) {
    const uint32_t m = q == 3 ? kMaskBit : 0xFFFFFFFFu;
    c.sl[q] = e0[q] ^ s[q];
    c.sr[q] = s[q];
    c.sl[4 + q] = s[4 + q] & m;
    c.sr[4 + q] = (e1[q] ^ s[4 + q]) & m;
  }
}

// B7a's and B7b's expansion: the T-tables, one party after the other.
template <int MODE>
struct KgTables {
  const NarrowTables& T;
};

template <int MODE>
DCF_HD void kg_expand(const KgTables<MODE>& e, const uint32_t sa[8],
                      const uint32_t sb[8], KgChildren<8>& ea,
                      KgChildren<8>& eb) {
  if constexpr (MODE == kKgNarrow) {
    kg_expand_narrow(e.T, sa, ea);
    kg_expand_narrow(e.T, sb, eb);
  } else {
    kg_expand_dpf(e.T, sa, ea);
    kg_expand_dpf(e.T, sb, eb);
  }
}

// One keygen level from both parties' expansions.  a is alpha's walk bit:
// 1 keeps the right child and loses the left (src/lib.rs:107-111).  Writes
// the level's seed (and value) correction and its t bits (tl in bit 0, tr
// in bit 1), and advances the carry.  beta folds into the value correction
// on the lose side under LT_BETA and on the keep side under GT_BETA.
template <int W, bool V>
DCF_HD void keygen_level(const KgChildren<W>& ea, const KgChildren<W>& eb,
                         uint32_t a, bool lt, const uint32_t beta[W],
                         KgState<W>& st, uint32_t cs[W], uint32_t cv[W],
                         uint32_t& ct) {
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

// A level's t bits (tl in bit 0, tr in bit 1) as its two cw_t bytes, one
// 2-byte store on the card.
DCF_HD void kg_store_t(uint8_t* p, uint32_t ct) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)((ct & 1u) | ((ct >> 1) << 8));
#else
  p[0] = (uint8_t)(ct & 1u);
  p[1] = (uint8_t)(ct >> 1);
#endif
}

// The whole keygen of one key, n levels, both parties' seeds expanded at
// each level by `expand` (KgBanked16 or KgTables<MODE>).  alpha: n/8
// bytes, read a byte each 8 levels; beta: the key's beta row; s0a / s0b:
// the parties' root seeds.  Rows of lam bytes: cw_s (and cw_v) [n][lam],
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
    if (traj) {
      traj[2 * i] = (uint8_t)st.ta;
      traj[2 * i + 1] = (uint8_t)st.tb;
    }
    KgChildren<W> ea, eb;
    kg_expand(expand, st.sa, st.sb, ea, eb);
    uint32_t cs[W], cv[W], ct;
    keygen_level<W, V>(ea, eb, (ab >> (7 - (i & 7))) & 1u, lt, bw, st, cs, cv,
                       ct);
    kg_store(cw_s + (size_t)i * lam, cs, W);
    if constexpr (V) kg_store(cw_v + (size_t)i * lam, cv, W);
    kg_store_t(cw_t + 2 * i, ct);
  }
  uint32_t np1[W];
  for (int q = 0; q < W; ++q)
    np1[q] = st.sa[q] ^ st.sb[q] ^ (V ? st.va[q] : bw[q]);
  kg_store(cw_np1, np1, W);
}

}  // namespace dcf
