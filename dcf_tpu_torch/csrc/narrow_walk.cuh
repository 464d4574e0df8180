// Per-thread arithmetic of the two-cipher (32-byte) Hirose step, shared by
// the four Hopper kernels of the large-lambda hybrid (lam >= 48), by the
// full-domain DPF kernel (lam = 32) and by the lam = 32 DCF walk:
//
//   B4   narrow_walk.cu    replaces dcf_tpu/ops/pallas_narrow.py::dcf_narrow_walk_pallas
//   B5a  hybrid_state.cu   replaces dcf_tpu/ops/pallas_hybrid_prefix.py::narrow_state_walk_pallas
//   B5b  hybrid_prefix.cu  replaces dcf_tpu/ops/pallas_hybrid_prefix.py::dcf_hybrid_prefix_pallas
//   W1   wide_xor.cu       replaces the XLA int8 dot_general of
//                          dcf_tpu/backends/large_lambda.py::_wide_tail
//   B6   evalall_expand.cu replaces dcf_tpu/ops/pallas_evalall.py::_expand_level
//   E1   walk32_eval.cu    replaces the XLA lax.scan of
//                          dcf_tpu/backends/jax_bitsliced.py::eval_core_bitsliced
//                          at lam = 32
//
// For lam >= 48 the Hirose PRG encrypts only its first two 16-byte blocks
// (cipher 0 on block 0, cipher 17 on block 1); every other block is a
// feed-forward copy.  So a lam-byte evaluation splits into a 32-byte
// "narrow" walk, which yields y[:32] and the trajectory of gate bits t_0
// (the party) .. t_n (the bit that gates cw_np1), and a GF(2) affine wide
// part y[32:] = const ^ XOR_k t_k * W[k] over that trajectory.
//
// The narrow walk is the lam = 32 walk without the final-bit mask: the big
// PRG's masked bit 8*lam-1 lies in the wide part.  Per level, four AES-256
// encryptions: cipher 0 on (s_b0, ~s_b0), cipher 17 on (s_b1, ~s_b1),
//
//   left  s = (E0(s_b0) ^ s_b0, s_b1)     left  v = (E0(~s_b0) ^ ~s_b0, ~s_b1)
//   right s = (s_b0, E17(s_b1) ^ s_b1)    right v = (~s_b0, E17(~s_b1) ^ ~s_b1)
//
// and t_l / t_r are bit 0 of byte 0 of cipher 0's two outputs.  The state
// is eight little-endian uint32 words per 32 bytes (block 0 in words 0-3).
// The kernels run it on the banked AES of aes_banked.cuh: B4, B5b and E1
// (masked, with the group's v) as three slots a level
// (narrow_level_banked), B5a both children of a
// frontier node at once (frontier_expand), B6 its DPF node
// (dpf_node_banked: the masked lam = 32 step dpf_step_banked, then the
// level's correction; keygen_walk.cuh's B7b runs the same step's pieces
// on both parties' seeds at once).
//
// A trajectory is a bit string, bit i = t_i, packed into little-endian
// uint32 words (bit i is bit i % 32 of word i / 32, which is also bit i % 8
// of byte i / 8).
//
// Plain C++ over uint32_t; it also compiles on the host.

#pragma once

#include "aes_banked.cuh"
#include "dcf_walk.cuh"

namespace dcf {

// The T-tables, the S-box and cipher 0's round keys (a.rk), and cipher
// 17's round keys: no kernel reads them since every narrow kernel runs on
// the banked AES; with aes256_encrypt3_rk the host tests' second
// reference for the lam = 32 DPF step.
struct NarrowTables {
  AesTables a;
  uint32_t rk17[60];
};

// One level's correction word, narrow part: 32 bytes of s and of v, t bits
// (tl in bit 0, tr in bit 1).
struct NarrowCw {
  uint32_t s[8];
  uint32_t v[8];
  uint32_t t;
};

// The carry of a narrow walk.
struct NarrowState {
  uint32_t s[8];
  uint32_t v[8];
  uint32_t t;
};

// Level i's narrow CW from the [n, 32] / [n, 2] byte arrays of one key.
DCF_HD void narrow_cw_entry(NarrowCw* cw, const uint8_t* cw_s,
                            const uint8_t* cw_v, const uint8_t* cw_t, int i) {
  for (int q = 0; q < 8; ++q) {
    cw[i].s[q] = le32(cw_s + 32 * i + 4 * q);
    cw[i].v[q] = le32(cw_v + 32 * i + 4 * q);
  }
  cw[i].t = (cw_t[2 * i] & 1u) | ((cw_t[2 * i + 1] & 1u) << 1);
}

// y[:32] = v ^ s ^ t * cw_np1[:32].
DCF_HD void narrow_finalize(const NarrowState& st, const uint32_t np1[8],
                            uint32_t y[8]) {
  const uint32_t g = 0u - st.t;
  for (int q = 0; q < 8; ++q) y[q] = st.v[q] ^ st.s[q] ^ (np1[q] & g);
}

// The narrow level of kernel B4 on the banked AES (aes_banked.cuh), as
// three slots of one instruction stream with per-lane inputs and round
// keys.  A left turn needs E0(sa) and E0(~sa), a right turn E0(~sa),
// E17(sb) and E17(~sb):
//
//   slot A: E0(~sa) on every lane;
//   slot B: E0(sa) where the lane turns left, E17(sb) where it turns right
//           (a select of the input words and of the round-key pointer);
//   slot C: E17(~sb), needed by right-turning lanes only.
//
// A and B run in lockstep; C joins them when `any_right` (on the card: some
// lane of the warp turns right), so a mixed warp computes 3 blocks, not 4,
// and an all-left warp 2.  rk0 and rk17 sit in different banks, so slot B's
// two round keys are one broadcast wavefront.
//
// B4 and B5b run it unmasked in the XOR group (the defaults).  Kernel E1,
// the lam = 32 DCF walk, runs it with MASK, the lam = 32 PRG's output bit
// 8*lam-1 (bit 0 of byte 31: word 3 of block 1, kMaskBit) cleared in the
// child's s and v, the copied halves included, before the level's
// correction enters (t_l and t_r are read before it), and v accumulated
// in the group of lane width GW (gadd of dcf_walk.cuh, unsigned).
template <int GW = 0, bool MASK = false>
DCF_HD void narrow_level_banked(const BkLane& t, const RoundKey* rk0,
                                const RoundKey* rk17, const NarrowCw& w,
                                uint32_t xbit, bool any_right,
                                NarrowState& st) {
  const uint32_t xm = 0u - xbit;
  uint32_t na[4], nb[4], in_b[4], e[3][4];
  for (int q = 0; q < 4; ++q) {
    na[q] = ~st.s[q];
    nb[q] = ~st.s[4 + q];
    in_b[q] = (st.s[4 + q] & xm) | (st.s[q] & ~xm);
    e[0][q] = na[q];
    e[1][q] = in_b[q];
    e[2][q] = nb[q];
  }
  const RoundKey* const rk[3] = {rk0, xbit ? rk17 : rk0, rk17};
  if (any_right)
    bk_encrypt<3>(t, rk, e);
  else
    bk_encrypt<2>(t, rk, e);  // slot C idle: no lane of the warp needs it
  uint32_t fa[4], fb[4], fc[4];
  for (int q = 0; q < 4; ++q) {
    fa[q] = e[0][q] ^ na[q];
    fb[q] = e[1][q] ^ in_b[q];
    fc[q] = e[2][q] ^ nb[q];
  }
  const uint32_t g = 0u - st.t;
  const uint32_t tl = (fb[0] & 1u) ^ (st.t & w.t);
  const uint32_t tr = (fa[0] & 1u) ^ (st.t & (w.t >> 1));
  for (int q = 0; q < 4; ++q) {
    // Left child: s = (fb, sb), v = (fa, ~sb); right: s = (sa, fb),
    // v = (~sa, fc).
    const uint32_t m = MASK && q == 3 ? kMaskBit : 0xFFFFFFFFu;
    const uint32_t s0 = (st.s[q] & xm) | (fb[q] & ~xm);
    const uint32_t s1 = ((fb[q] & xm) | (st.s[4 + q] & ~xm)) & m;
    const uint32_t v0 = (na[q] & xm) | (fa[q] & ~xm);
    const uint32_t v1 = ((fc[q] & xm) | (nb[q] & ~xm)) & m;
    st.v[q] = gadd<GW>(st.v[q], gadd<GW>(v0, w.v[q] & g));
    st.v[4 + q] = gadd<GW>(st.v[4 + q], gadd<GW>(v1, w.v[4 + q] & g));
    st.s[q] = s0 ^ (w.s[q] & g);
    st.s[4 + q] = s1 ^ (w.s[4 + q] & g);
  }
  st.t = (tr & xm) | (tl & ~xm);
}

// Slot C of narrow_level_banked runs where any lane of the warp turns
// right (on the host, where the lane turns right: the tests vote over the
// lanes themselves).
struct WarpVote {
#if defined(__CUDACC__)
  __host__ __device__
#endif
  bool operator()(int, uint32_t xbit) const {
#if defined(__CUDA_ARCH__)
    return __any_sync(0xFFFFFFFFu, xbit) != 0;
#else
    return xbit != 0u;
#endif
  }
};

// The per-thread body of kernels B4 and B5b: the narrow walk of one point
// under one key from the carry st at level lo through levels lo..n-1 on
// narrow_level_banked (cw holds those levels: cw[i - lo] is level i's),
// then y[:32].  word holds the trajectory bits of the levels above lo
// (lo <= 31: they fit its first word); the n+1 bits (ceil((n+1)/32)
// words) go to traj unless it is null (a thread past the last point,
// which walks only to take part in the warp's votes).  vote(i, xbit) says
// whether slot C runs at level i.  B4 starts at the root (narrow_root), B5b
// from a frontier row (narrow_row).
template <typename Vote>
DCF_HD void narrow_point_banked(const BkLane& t, const RoundKey* rk0,
                                const RoundKey* rk17, const NarrowCw* cw,
                                int lo, int n, NarrowState& st, uint32_t word,
                                const uint32_t np1[8], const uint8_t* x,
                                Vote vote, uint32_t y[8], uint32_t* traj) {
  for (int i = lo; i < n; ++i) {
    word |= st.t << (i & 31);
    if ((i & 31) == 31) {
      if (traj) traj[i >> 5] = word;
      word = 0u;
    }
    const uint32_t xbit = walk_bit(x, i);
    narrow_level_banked(t, rk0, rk17, cw[i - lo], xbit, vote(i, xbit), st);
  }
  word |= st.t << (n & 31);
  if (traj) traj[n >> 5] = word;
  narrow_finalize(st, np1, y);
}

// The root carry of party t0's seed s0.
DCF_HD void narrow_root(NarrowState& st, const uint32_t s0[8], uint32_t t0) {
  for (int q = 0; q < 8; ++q) {
    st.s[q] = s0[q];
    st.v[q] = 0u;
  }
  st.t = t0;
}

// The depth-k carry of a frontier row (s then v, 16 words) and its word
// (gate bits 0..k-1, t at bit k); returns the trajectory's first k bits.
DCF_HD uint32_t narrow_row(NarrowState& st, const uint32_t row[16],
                           uint32_t word, int k) {
  for (int q = 0; q < 8; ++q) {
    st.s[q] = row[q];
    st.v[q] = row[8 + q];
  }
  st.t = (word >> k) & 1u;
  return word & ((1u << k) - 1u);
}

// Kernel E1's per-thread body: party b's lam = 32 DCF walk of one point x
// under one key (seed s0, the n levels' CWs cw, cw_np1 np1) from the root,
// each level narrow_level_banked masked and accumulating in the group of
// lane width GW, then y = v + s + t * cw_np1 over the 32 bytes, negated
// for party 1 of an additive group.  No trajectory: at lam = 32 the PRG
// has no wide part.  vote(i, xbit) says whether slot C runs at level i.
template <int GW, typename Vote>
DCF_HD void walk32_point_banked(const BkLane& t, const RoundKey* rk0,
                                const RoundKey* rk17, const NarrowCw* cw,
                                int n, const uint32_t s0[8], uint32_t b,
                                const uint32_t np1[8], const uint8_t* x,
                                Vote vote, uint32_t y[8]) {
  NarrowState st;
  narrow_root(st, s0, b);
  for (int i = 0; i < n; ++i) {
    const uint32_t xbit = walk_bit(x, i);
    narrow_level_banked<GW, true>(t, rk0, rk17, cw[i], xbit, vote(i, xbit),
                                  st);
  }
  finalize<GW, 8>(st.s, st.t, st.v, np1, b && GW > 0, y);
}

// AES-256 of three blocks in lockstep, three independent lookup chains:
// in0 and in1 under the round keys rk_a, in2 under rk_b.
DCF_HD void aes256_encrypt3_rk(const AesTables& a, const uint32_t* rk_a,
                               const uint32_t* rk_b, const uint32_t in0[4],
                               const uint32_t in1[4], const uint32_t in2[4],
                               uint32_t out0[4], uint32_t out1[4],
                               uint32_t out2[4]) {
  uint32_t a0 = in0[0] ^ rk_a[0], a1 = in0[1] ^ rk_a[1];
  uint32_t a2 = in0[2] ^ rk_a[2], a3 = in0[3] ^ rk_a[3];
  uint32_t b0 = in1[0] ^ rk_a[0], b1 = in1[1] ^ rk_a[1];
  uint32_t b2 = in1[2] ^ rk_a[2], b3 = in1[3] ^ rk_a[3];
  uint32_t c0 = in2[0] ^ rk_b[0], c1 = in2[1] ^ rk_b[1];
  uint32_t c2 = in2[2] ^ rk_b[2], c3 = in2[3] ^ rk_b[3];
  uint32_t d0, d1, d2, d3, e0, e1, e2, e3, f0, f1, f2, f3;
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int r = 1; r < 14; ++r) {
    const uint32_t* ka = rk_a + 4 * r;
    const uint32_t* kb = rk_b + 4 * r;
    DCF_AES_ROUND(a, ka, a0, a1, a2, a3, d0, d1, d2, d3)
    DCF_AES_ROUND(a, ka, b0, b1, b2, b3, e0, e1, e2, e3)
    DCF_AES_ROUND(a, kb, c0, c1, c2, c3, f0, f1, f2, f3)
    a0 = d0; a1 = d1; a2 = d2; a3 = d3;
    b0 = e0; b1 = e1; b2 = e2; b3 = e3;
    c0 = f0; c1 = f1; c2 = f2; c3 = f3;
  }
  DCF_AES_LAST(a, rk_a, a0, a1, a2, a3, out0)
  DCF_AES_LAST(a, rk_a, b0, b1, b2, b3, out1)
  DCF_AES_LAST(a, rk_b, c0, c1, c2, c3, out2)
}

// One level's DPF correction word at lam = 32: 32 bytes of s, t bits (tl
// in bit 0, tr in bit 1).  A DPF key has no value correction.
struct DpfCw {
  uint32_t s[8];
  uint32_t t;
};

// The CW of one level from its 32 seed bytes and its two t bytes.
DCF_HD void dpf_cw_entry(DpfCw& cw, const uint8_t* cw_s,
                         const uint8_t* cw_t) {
  for (int q = 0; q < 8; ++q) cw.s[q] = le32(cw_s + 4 * q);
  cw.t = (cw_t[0] & 1u) | ((cw_t[1] & 1u) << 1);
}

// The leaf share of a DPF node: y = s ^ t * cw_np1, in place.
DCF_HD void dpf_leaf(uint32_t s[8], uint32_t t, const uint32_t np1[8]) {
  const uint32_t g = 0u - t;
  for (int q = 0; q < 8; ++q) s[q] ^= np1[q] & g;
}

// The masked lam = 32 Hirose step of a DPF (no value half), uncorrected:
//
//   s_l = (E0(s_b0) ^ s_b0, s_b1)    s_r = (s_b0, E17(s_b1) ^ s_b1)
//
// with bit 8*lam-1 = bit 0 of byte 31 (word 7, kMaskBit) cleared in both
// children (block 0 is never masked), and t_l / t_r bit 0 of byte 0 of
// E0(s_b0) ^ s_b0 and E0(~s_b0) ^ ~s_b0.  E17(~s_b1) feeds only the value
// half, which a DPF has not, and of E0(~s_b0) only t_r is read: two full
// blocks and one t bit.  dpf_step_in lays out seed s's three blocks, to
// be encrypted under {rk0, rk17, rk0}, the third to its t bit alone;
// dpf_children makes the children from them (x[0] and x[1] encrypted,
// bit0 bit 0 of E0(~s_b0)).
DCF_HD void dpf_step_in(const uint32_t s[8], uint32_t (*x)[4]) {
  for (int q = 0; q < 4; ++q) {
    x[0][q] = s[q];
    x[1][q] = s[4 + q];
    x[2][q] = ~s[q];
  }
}

DCF_HD void dpf_children(const uint32_t s[8], const uint32_t (*x)[4],
                         uint32_t bit0, uint32_t sl[8], uint32_t& tl,
                         uint32_t sr[8], uint32_t& tr) {
  tl = (x[0][0] ^ s[0]) & 1u;
  tr = (bit0 ^ ~s[0]) & 1u;
  for (int q = 0; q < 4; ++q) {
    const uint32_t m = q == 3 ? kMaskBit : 0xFFFFFFFFu;
    sl[q] = x[0][q] ^ s[q];
    sr[q] = s[q];
    sl[4 + q] = s[4 + q] & m;
    sr[4 + q] = (x[1][q] ^ s[4 + q]) & m;
  }
}

// The step of one seed on the banked AES: its two blocks and one t bit in
// lockstep (bk_encrypt<2, 1>, 224 + 224 + 197 lookups).  Every lane does
// the same work, so a warp needs no vote.  Kernel B6's node runs it;
// kernel B7b's keygen level runs two seeds' dpf_step_in and dpf_children
// around one bk_encrypt<4, 2>.
DCF_HD void dpf_step_banked(const BkLane& t, const RoundKey* rk0,
                            const RoundKey* rk17, const uint32_t s[8],
                            uint32_t sl[8], uint32_t& tl, uint32_t sr[8],
                            uint32_t& tr) {
  uint32_t x[3][4], bit[1];
  dpf_step_in(s, x);
  const RoundKey* const rk[3] = {rk0, rk17, rk0};
  bk_encrypt<2, 1>(t, rk, x, bit);
  dpf_children(s, x, bit[0], sl, tl, sr, tr);
}

// One parent node (s, tt) of the lam = 32 DPF tree into its two children:
// the step, then the level's seed and t correction gated by tt.
DCF_HD void dpf_node_banked(const BkLane& t, const RoundKey* rk0,
                            const RoundKey* rk17, const DpfCw& w,
                            const uint32_t s[8], uint32_t tt, uint32_t sl[8],
                            uint32_t& tl, uint32_t sr[8], uint32_t& tr) {
  dpf_step_banked(t, rk0, rk17, s, sl, tl, sr, tr);
  const uint32_t g = 0u - tt;
  tl ^= tt & w.t;
  tr ^= tt & (w.t >> 1);
  for (int q = 0; q < 8; ++q) {
    sl[q] ^= w.s[q] & g;
    sr[q] ^= w.s[q] & g;
  }
}

// 32 bytes from eight little-endian words (16-byte aligned on the card).
DCF_HD void store32(uint8_t* p, const uint32_t w[8]) {
#if defined(__CUDA_ARCH__)
  uint4* o = reinterpret_cast<uint4*>(p);
  o[0] = make_uint4(w[0], w[1], w[2], w[3]);
  o[1] = make_uint4(w[4], w[5], w[6], w[7]);
#else
  for (int q = 0; q < 8; ++q)
    for (int j = 0; j < 4; ++j) p[4 * q + j] = (uint8_t)(w[q] >> (8 * j));
#endif
}

// B6's per-thread body: the parent (s, t) at level L expanded D levels in
// registers, w[0..D) the CWs of levels L..L+D-1.  The 2^D nodes of level
// L + D go to rows pos + stride * r of s_out and t_out (one key's rows),
// r their walk directions LSB first: with pos the parent's index j and
// stride the level's N parents, the rows D level-order launches of one
// level each would fill ([lefts ; rights] per level).  With np1 (not
// null) the stored nodes are leaf shares y = s ^ t * cw_np1; with Y false
// only their t bits are kept, each at bit `at` (its row) of *t_bits
// (s_out and t_out are not read; with pos 0 and stride 1, bit r holds the
// node of directions r, which the caller packs).  One call site of dpf_node_banked per level:
// the two children of a node are expanded in a rolled loop.  Y is a
// template argument: a run-time test of s_out cost the launches that write
// y about 10% (NVIDIA H100 80GB HBM3, 700 W, PERF.md).
template <int D, bool Y = true>
DCF_HD void dpf_subtree(const BkLane& t, const RoundKey* rk0,
                        const RoundKey* rk17, const DpfCw* w,
                        const uint32_t* np1, const uint32_t s[8], uint32_t tt,
                        uint8_t* s_out, uint8_t* t_out, size_t pos,
                        size_t stride, uint32_t* t_bits = nullptr) {
  uint32_t c[2][8], ct[2];
  dpf_node_banked(t, rk0, rk17, w[0], s, tt, c[0], ct[0], c[1], ct[1]);
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int d = 0; d < 2; ++d) {
    uint32_t cs[8];
    for (int q = 0; q < 8; ++q) cs[q] = d ? c[1][q] : c[0][q];
    const uint32_t ctd = d ? ct[1] : ct[0];
    const size_t at = pos + (size_t)d * stride;
    if constexpr (D == 1) {
      if constexpr (Y) {
        if (np1) dpf_leaf(cs, ctd, np1);
        store32(s_out + at * 32, cs);
        t_out[at] = (uint8_t)ctd;
      } else {
        *t_bits |= ctd << at;
      }
    } else {
      dpf_subtree<D - 1, Y>(t, rk0, rk17, w + 1, np1, cs, ctd, s_out, t_out,
                            at, 2 * stride, t_bits);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel B5a: the narrow frontier of the prefix-shared hybrid, built level
// by level.  Walk bit l of frontier node p is bit l of p, so node p at
// depth i has its children at p (walk bit i = 0) and p + 2^i (bit i = 1):
// depth i's nodes are rows [0, 2^i) of the key's range, and the build runs
// in place, each depth a valid frontier of its own.  A node is its raw
// carry (s, v) and its word: the gate bits of levels 0..i-1 and its t at
// bit i.
// ---------------------------------------------------------------------------

struct FrontierNode {
  uint32_t s[8], v[8];
  uint32_t word;
};

// Level i's narrow CW from one key's rows (cw_s / cw_v [n, 32], 16-byte
// aligned on the card, and cw_t [n, 2]).
DCF_HD void narrow_cw_load(const uint8_t* cw_s, const uint8_t* cw_v,
                           const uint8_t* cw_t, int i, NarrowCw& w) {
  load16(cw_s + 32 * i, w.s);
  load16(cw_s + 32 * i + 16, w.s + 4);
  load16(cw_v + 32 * i, w.v);
  load16(cw_v + 32 * i + 16, w.v + 4);
  w.t = kl_t_bits(cw_t, i);
}

DCF_HD void frontier_load(FrontierNode& p, const uint8_t* rows,
                          const uint32_t* words, size_t at) {
  load16(rows + at * 64, p.s);
  load16(rows + at * 64 + 16, p.s + 4);
  load16(rows + at * 64 + 32, p.v);
  load16(rows + at * 64 + 48, p.v + 4);
  p.word = words[at];
}

DCF_HD void frontier_store(const FrontierNode& c, uint8_t* rows,
                           uint32_t* words, size_t at) {
  store32(rows + at * 64, c.s);
  store32(rows + at * 64 + 32, c.v);
  words[at] = c.word;
}

// One seed's children under a Hirose step, uncorrected: seeds and values as
// the PRG gives them (the mask applied where the PRG masks) and the t bits
// from the unmasked outputs.  W words a seed: 4 at lam = 16, 8 in the
// narrow step.
template <int W>
struct StepChildren {
  uint32_t sl[W], sr[W], vl[W], vr[W];
  uint32_t tl, tr;
};

// The narrow step's four blocks of seed s, to be encrypted under the
// round keys {rk0, rk0, rk17, rk17}: s_a, ~s_a, s_b, ~s_b.
DCF_HD void narrow_step_in(const uint32_t s[8], uint32_t (*x)[4]) {
  for (int q = 0; q < 4; ++q) {
    x[0][q] = s[q];
    x[1][q] = ~s[q];
    x[2][q] = s[4 + q];
    x[3][q] = ~s[4 + q];
  }
}

// The unmasked narrow step's children of seed s from its four blocks
// encrypted (x, in narrow_step_in's order):
//
//   left  s = (E0(s_a) ^ s_a, s_b)     left  v = (E0(~s_a) ^ ~s_a, ~s_b)
//   right s = (s_a, E17(s_b) ^ s_b)    right v = (~s_a, E17(~s_b) ^ ~s_b)
//
// t_l / t_r are bit 0 of the left child's s and v.
DCF_HD void narrow_children(const uint32_t s[8], const uint32_t (*x)[4],
                            StepChildren<8>& c) {
  for (int q = 0; q < 4; ++q) {
    const uint32_t sa = s[q], sb = s[4 + q];
    c.sl[q] = x[0][q] ^ sa;
    c.sl[4 + q] = sb;
    c.vl[q] = x[1][q] ^ ~sa;
    c.vl[4 + q] = ~sb;
    c.sr[q] = sa;
    c.sr[4 + q] = x[2][q] ^ sb;
    c.vr[q] = ~sa;
    c.vr[4 + q] = x[3][q] ^ ~sb;
  }
  c.tl = c.sl[0] & 1u;
  c.tr = c.vl[0] & 1u;
}

// One node p at depth i into both children: the four blocks of the narrow
// step in lockstep on every lane (no vote), then the level's correction w
// under p's t and v accumulated, as narrow_level_banked does for the child
// a lane takes.  Each child's word is p's with the child's corrected t at
// bit i + 1.
DCF_HD void frontier_expand(const BkLane& t, const RoundKey* rk0,
                            const RoundKey* rk17, const NarrowCw& w, int i,
                            const FrontierNode& p, FrontierNode c[2]) {
  uint32_t x[4][4];
  narrow_step_in(p.s, x);
  const RoundKey* const rk[4] = {rk0, rk0, rk17, rk17};
  bk_encrypt<4>(t, rk, x);
  StepChildren<8> e;
  narrow_children(p.s, x, e);
  const uint32_t tt = (p.word >> i) & 1u;
  const uint32_t g = 0u - tt;
  for (int q = 0; q < 8; ++q) {
    const uint32_t cs = w.s[q] & g;
    const uint32_t cv = p.v[q] ^ (w.v[q] & g);
    c[0].s[q] = e.sl[q] ^ cs;
    c[1].s[q] = e.sr[q] ^ cs;
    c[0].v[q] = e.vl[q] ^ cv;
    c[1].v[q] = e.vr[q] ^ cv;
  }
  c[0].word = p.word | ((e.tl ^ (tt & w.t)) << (i + 1));
  c[1].word = p.word | ((e.tr ^ (tt & (w.t >> 1))) << (i + 1));
}

// B5a's per-thread body: the node p at depth `level` of one key (its CW
// rows cw_s / cw_v [n, 32], cw_t [n, 2]) expanded D levels in registers;
// the 2^D nodes of depth level + D go to rows pos + stride * r of the
// key's rows [2^k, 64] and words [2^k], r their walk bits LSB first: with
// pos = p's index and stride = 2^level, their frontier rows.  One call
// site of frontier_expand per level: the two children in a rolled loop.
template <int D>
DCF_HD void frontier_subtree(const BkLane& t, const RoundKey* rk0,
                             const RoundKey* rk17, const uint8_t* cw_s,
                             const uint8_t* cw_v, const uint8_t* cw_t,
                             int level, const FrontierNode& p, uint8_t* rows,
                             uint32_t* words, size_t pos, size_t stride) {
  NarrowCw w;
  narrow_cw_load(cw_s, cw_v, cw_t, level, w);
  FrontierNode c[2];
  frontier_expand(t, rk0, rk17, w, level, p, c);
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int d = 0; d < 2; ++d) {
    FrontierNode cd;
    for (int q = 0; q < 8; ++q) {
      cd.s[q] = d ? c[1].s[q] : c[0].s[q];
      cd.v[q] = d ? c[1].v[q] : c[0].v[q];
    }
    cd.word = d ? c[1].word : c[0].word;
    const size_t at = pos + (size_t)d * stride;
    if constexpr (D == 1) {
      frontier_store(cd, rows, words, at);
    } else {
      frontier_subtree<D - 1>(t, rk0, rk17, cw_s, cw_v, cw_t, level + 1, cd,
                              rows, words, at, 2 * stride);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel W1: the wide tail y[32:] = const ^ XOR over j < n1 of t_j * W[j],
// by the method of four Russians.  The n1 trajectory bits fall into
// wide_groups(n1) groups of kWideBits (the last may hold fewer); a table
// holds, for each group g and each value of its bits, the XOR of the rows
// of W that the value selects (rows 5g .. 5g + 4 below n1, const folded
// into group 0), so an output chunk of 16 bytes is one table read a group,
// with no data-dependent loop.  The table is laid out [group][value]
// [column]: entry (g, val) of column chunk c at 16-byte unit
// (kWideVals g + val) * cols + c.  Five bits a group (26 reads at n = 128,
// a 186 KB table at lam = 256) ran 26% faster than four (33 reads, 118 KB;
// NVIDIA H100 80GB HBM3, 700 W, chip_ab.py): the reads bound the kernel.
// ---------------------------------------------------------------------------

constexpr int kWideBits = 5;  // trajectory bits a table group
constexpr int kWideVals = 1 << kWideBits;

DCF_HD int wide_groups(int n1) { return (n1 + kWideBits - 1) / kWideBits; }

// Table entry (g, val) of one 16-byte column chunk: w_col and cst_col are
// that chunk of the key's W (rows wd bytes apart) and const.
DCF_HD void wide_table_entry(const uint8_t* w_col, const uint8_t* cst_col,
                             size_t wd, int n1, int g, int val,
                             uint32_t out[4]) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  if (g == 0) load16(cst_col, acc);
  for (int b = 0; b < kWideBits; ++b) {
    const int row = kWideBits * g + b;
    if (((val >> b) & 1) && row < n1) {
      uint32_t r[4];
      load16(w_col + (size_t)row * wd, r);
      for (int q = 0; q < 4; ++q) acc[q] ^= r[q];
    }
  }
  for (int q = 0; q < 4; ++q) out[q] = acc[q];
}

// The kWideBits bits at bit `off` of the 64-bit word (hi, lo).
DCF_HD uint32_t wide_field(uint32_t lo, uint32_t hi, int off) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, off) & (kWideVals - 1);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> off) & (kWideVals - 1);
#endif
}

// W1's per-(point, chunk) body: the XOR over the groups of the table
// entries that the point's trajectory (traj: bit j at bit j % 32 of word
// j / 32) selects; tab is the chunk's column of a table of `cols` columns.
// A batch's trajectory words are loaded before its lookups, so their
// latencies overlap; trajectory bits at or past n1 select nothing.
DCF_HD void wide_chunk(const uint32_t* traj, int n1, const uint32_t* tab,
                       int cols, uint32_t out[4]) {
  const int groups = wide_groups(n1);
  const int tw = (n1 + 31) >> 5;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  // Batches of 32 groups: 160 bits, five words and the next one.
  for (int g0 = 0; g0 < groups; g0 += 32) {
    const int w0 = g0 * kWideBits / 32;
    uint32_t words[6];
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int i = 0; i < 6; ++i) words[i] = w0 + i < tw ? traj[w0 + i] : 0u;
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int j = 0; j < 32; ++j) {
      const int g = g0 + j;
      if (g < groups) {
        const int bit = kWideBits * j;
        const uint32_t val =
            wide_field(words[bit >> 5], words[(bit >> 5) + 1], bit & 31);
        uint32_t e[4];
        load16(reinterpret_cast<const uint8_t*>(
                   tab + 4 * ((size_t)(kWideVals * g + val) * cols)),
               e);
        for (int q = 0; q < 4; ++q) acc[q] ^= e[q];
      }
    }
  }
  for (int q = 0; q < 4; ++q) out[q] = acc[q];
}

#if defined(__CUDACC__)
// Block-cooperative fill of a launch's narrow CWs; the caller syncs.
__device__ __forceinline__ void fill_narrow_cws(NarrowCw* cw,
                                                const uint8_t* cw_s,
                                                const uint8_t* cw_v,
                                                const uint8_t* cw_t, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    narrow_cw_entry(cw, cw_s, cw_v, cw_t, i);
}
#endif

}  // namespace dcf
