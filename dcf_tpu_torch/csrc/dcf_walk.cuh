// Per-thread DCF arithmetic at lam = 16 on four 1 KB T-tables, and the
// Hirose children, the tree node's algebra, the group algebra, the
// finalize and walk bits that the banked bodies of aes_banked.cuh share
// (kernels B2's and B2f's among them).
//
// walk_point, prefix_point and tree_leaves (B2f's first body) run on these
// tables; no kernel runs them (every kernel runs on the banked AES of
// aes_banked.cuh, B7b since it left them last), and the host tests hold
// them, and with them this file's Hirose step and group algebra, to the
// numpy oracle: a second reference beside the banked bodies.
//
// The TPU kernels run a bitsliced AES (128 one-bit planes, 32 points per
// int32 lane word) because the TPU has no byte gather.  A Hopper SM has
// fast shared memory that every thread can index, so here one thread owns
// one (key, point) walk or one tree node and runs a table AES on it: the
// 16-byte block is four uint32 words, little-endian (byte 4c+r is bits
// 8r..8r+7 of word c), and each AES round is 16 lookups into four 1 KB
// T-tables (SubBytes, ShiftRows and MixColumns in one step) held in shared
// memory.  Those lookups bound the kernels: 2 AES-256 blocks per point per
// level, 14 rounds of 16 lookups each.  The two blocks of a Hirose call
// (seed and complemented seed) are encrypted in lockstep, so each thread
// carries two independent lookup chains.
//
// Everything below is plain C++ over uint32_t and also compiles on the
// host, which lets the arithmetic be checked against the numpy oracle
// without a card.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define DCF_HD __host__ __device__ __forceinline__
#else
#define DCF_HD static inline
#endif

namespace dcf {

// Clears bit 0 of byte 15 (word 3, bit 24): the Hirose PRG's output bit
// 8*lam-1, which the reference masks in all four outputs.
constexpr uint32_t kMaskBit = 0xFEFFFFFFu;


struct AesTables {
  uint32_t te[4][256];  // te[r][x]: S-box and MixColumns of a byte at row r
  uint32_t sb[256];     // plain S-box, for the last round
  uint32_t rk[60];      // 15 AES-256 round keys, 4 little-endian words each
};

// One level's correction word: s and v blocks, t bits (tl in bit 0, tr in
// bit 1).
struct LevelCw {
  uint32_t s[4];
  uint32_t v[4];
  uint32_t t;
};

DCF_HD uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

DCF_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Entry i of the tables, from the S-box bytes.  The T-table of row 0 holds
// the column (2S, S, S, 3S); rows 1-3 are its byte rotations.
DCF_HD void aes_table_entry(AesTables& a, const uint8_t* sbox, int i) {
  const uint32_t s = sbox[i];
  const uint32_t s2 = ((s << 1) ^ ((s >> 7) * 0x1Bu)) & 0xFFu;
  const uint32_t s3 = s2 ^ s;
  const uint32_t t0 = s2 | (s << 8) | (s << 16) | (s3 << 24);
  a.te[0][i] = t0;
  a.te[1][i] = rotl32(t0, 8);
  a.te[2][i] = rotl32(t0, 16);
  a.te[3][i] = rotl32(t0, 24);
  a.sb[i] = s;
}

DCF_HD void level_cw_entry(LevelCw* cw, const uint8_t* cw_s,
                           const uint8_t* cw_v, const uint8_t* cw_t, int i) {
  for (int q = 0; q < 4; ++q) {
    cw[i].s[q] = le32(cw_s + 16 * i + 4 * q);
    cw[i].v[q] = le32(cw_v + 16 * i + 4 * q);
  }
  cw[i].t = (cw_t[2 * i] & 1u) | ((cw_t[2 * i + 1] & 1u) << 1);
}

// One AES round on the state (s0..s3) into (t0..t3).
#define DCF_AES_ROUND(T, K, s0, s1, s2, s3, t0, t1, t2, t3)                  \
  t0 = T.te[0][s0 & 0xFFu] ^ T.te[1][(s1 >> 8) & 0xFFu] ^                    \
       T.te[2][(s2 >> 16) & 0xFFu] ^ T.te[3][s3 >> 24] ^ (K)[0];             \
  t1 = T.te[0][s1 & 0xFFu] ^ T.te[1][(s2 >> 8) & 0xFFu] ^                    \
       T.te[2][(s3 >> 16) & 0xFFu] ^ T.te[3][s0 >> 24] ^ (K)[1];             \
  t2 = T.te[0][s2 & 0xFFu] ^ T.te[1][(s3 >> 8) & 0xFFu] ^                    \
       T.te[2][(s0 >> 16) & 0xFFu] ^ T.te[3][s1 >> 24] ^ (K)[2];             \
  t3 = T.te[0][s3 & 0xFFu] ^ T.te[1][(s0 >> 8) & 0xFFu] ^                    \
       T.te[2][(s1 >> 16) & 0xFFu] ^ T.te[3][s2 >> 24] ^ (K)[3];

// The last round: SubBytes and ShiftRows, no MixColumns.  RK is the key
// schedule (rk[60]) whose last round key it adds.
#define DCF_AES_LAST(T, RK, s0, s1, s2, s3, out)                              \
  out[0] = (T.sb[s0 & 0xFFu] | (T.sb[(s1 >> 8) & 0xFFu] << 8) |              \
            (T.sb[(s2 >> 16) & 0xFFu] << 16) | (T.sb[s3 >> 24] << 24)) ^     \
           (RK)[56];                                                         \
  out[1] = (T.sb[s1 & 0xFFu] | (T.sb[(s2 >> 8) & 0xFFu] << 8) |              \
            (T.sb[(s3 >> 16) & 0xFFu] << 16) | (T.sb[s0 >> 24] << 24)) ^     \
           (RK)[57];                                                         \
  out[2] = (T.sb[s2 & 0xFFu] | (T.sb[(s3 >> 8) & 0xFFu] << 8) |              \
            (T.sb[(s0 >> 16) & 0xFFu] << 16) | (T.sb[s1 >> 24] << 24)) ^     \
           (RK)[58];                                                         \
  out[3] = (T.sb[s3 & 0xFFu] | (T.sb[(s0 >> 8) & 0xFFu] << 8) |              \
            (T.sb[(s1 >> 16) & 0xFFu] << 16) | (T.sb[s2 >> 24] << 24)) ^     \
           (RK)[59];

// AES-256 of two blocks in lockstep (two independent dependency chains)
// under the round keys rk[60] (the tables' own or another cipher's).
DCF_HD void aes256_encrypt2_rk(const AesTables& a, const uint32_t* rk,
                               const uint32_t in0[4], const uint32_t in1[4],
                               uint32_t out0[4], uint32_t out1[4]) {
  uint32_t a0 = in0[0] ^ rk[0], a1 = in0[1] ^ rk[1];
  uint32_t a2 = in0[2] ^ rk[2], a3 = in0[3] ^ rk[3];
  uint32_t b0 = in1[0] ^ rk[0], b1 = in1[1] ^ rk[1];
  uint32_t b2 = in1[2] ^ rk[2], b3 = in1[3] ^ rk[3];
  uint32_t c0, c1, c2, c3, d0, d1, d2, d3;
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int r = 1; r < 14; ++r) {
    const uint32_t* k = rk + 4 * r;
    DCF_AES_ROUND(a, k, a0, a1, a2, a3, c0, c1, c2, c3)
    DCF_AES_ROUND(a, k, b0, b1, b2, b3, d0, d1, d2, d3)
    a0 = c0; a1 = c1; a2 = c2; a3 = c3;
    b0 = d0; b1 = d1; b2 = d2; b3 = d3;
  }
  DCF_AES_LAST(a, rk, a0, a1, a2, a3, out0)
  DCF_AES_LAST(a, rk, b0, b1, b2, b3, out1)
}

// The same under the tables' own round keys (cipher 0).
DCF_HD void aes256_encrypt2(const AesTables& a, const uint32_t in0[4],
                            const uint32_t in1[4], uint32_t out0[4],
                            uint32_t out1[4]) {
  aes256_encrypt2_rk(a, a.rk, in0, in1, out0, out1);
}

// One Hirose PRG call on a 16-byte seed (lam = 16, cipher 0 only):
//   s_l = E(s) ^ s, v_l = E(~s) ^ ~s     (encrypted half, feed-forward)
//   s_r = s,        v_r = ~s             (the never-encrypted copy)
// t_l and t_r are bit 0 of byte 0 of s_l and v_l before masking; then bit 0
// of byte 15 is cleared in all four outputs.
struct Children {
  uint32_t sl[4], vl[4], sr[4], vr[4];
  uint32_t tl, tr;
};

// The children from the two encryptions el = E(s) and er = E(~s), however
// they were computed (here, or on the banked AES of aes_banked.cuh).
DCF_HD void hirose_children(const uint32_t s[4], const uint32_t el[4],
                            const uint32_t er[4], Children& c) {
  for (int q = 0; q < 4; ++q) {
    c.sl[q] = el[q] ^ s[q];
    c.vl[q] = er[q] ^ ~s[q];
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

DCF_HD void hirose_expand(const AesTables& a, const uint32_t s[4],
                          Children& c) {
  uint32_t sp[4], el[4], er[4];
  for (int q = 0; q < 4; ++q) sp[q] = ~s[q];
  aes256_encrypt2(a, s, sp, el, er);
  hirose_children(s, el, er, c);
}

// Group add on one word of little-endian lanes: XOR (GW = 0) or lane-wise
// add mod 2^GW.  8- and 16-bit lanes add in SWAR form: the low bits of
// each lane add without crossing into the next lane, the top bit is the
// XOR of both top bits and the carry into it.
template <int GW>
DCF_HD uint32_t gadd(uint32_t a, uint32_t b) {
  if (GW == 0) return a ^ b;
  if (GW == 8)
    return ((a & 0x7F7F7F7Fu) + (b & 0x7F7F7F7Fu)) ^ ((a ^ b) & 0x80808080u);
  if (GW == 16)
    return ((a & 0x7FFF7FFFu) + (b & 0x7FFF7FFFu)) ^ ((a ^ b) & 0x80008000u);
  return a + b;
}

template <int GW>
DCF_HD uint32_t gneg(uint32_t a) {
  if (GW == 0) return a;
  if (GW == 8) return gadd<8>(~a, 0x01010101u);
  if (GW == 16) return gadd<16>(~a, 0x00010001u);
  return 0u - a;
}

// Bit `bit` of x in walk order: MSB-first over big-endian bytes.
DCF_HD uint32_t walk_bit(const uint8_t* x, int bit) {
  return ((uint32_t)x[bit >> 3] >> (7 - (bit & 7))) & 1u;
}

// Walk n_levels levels from (s, t, v), taking the input bits from level
// bit0 of x and the correction words from cw[0..n_levels).  Per level: one
// Hirose call, the s/t correction gated by t, the mux on the input bit,
// and v accumulated in the group (unsigned; the party sign is applied by
// the caller at the exit).
template <int GW>
DCF_HD void walk_levels(const AesTables& a, const LevelCw* cw, int n_levels,
                        const uint8_t* x, int bit0, uint32_t s[4],
                        uint32_t& t, uint32_t v[4]) {
  for (int i = 0; i < n_levels; ++i) {
    Children c;
    hirose_expand(a, s, c);
    const LevelCw& w = cw[i];
    const uint32_t g = 0u - t;
    const uint32_t xm = 0u - walk_bit(x, bit0 + i);
    const uint32_t tl = c.tl ^ (t & w.t);
    const uint32_t tr = c.tr ^ (t & (w.t >> 1));
    for (int q = 0; q < 4; ++q) {
      const uint32_t csg = w.s[q] & g;
      const uint32_t vhat = (c.vr[q] & xm) | (c.vl[q] & ~xm);
      v[q] = gadd<GW>(v[q], gadd<GW>(vhat, w.v[q] & g));
      s[q] = ((c.sr[q] ^ csg) & xm) | ((c.sl[q] ^ csg) & ~xm);
    }
    t = (tr & xm) | (tl & ~xm);
  }
}

// y = v + s + t*cw_np1 in the group over W words (4 at lam = 16, 8 for
// kernel E1's lam = 32); party 1 of an additive group negates.
template <int GW, int W = 4>
DCF_HD void finalize(const uint32_t s[W], uint32_t t, const uint32_t v[W],
                     const uint32_t np1[W], bool negate, uint32_t y[W]) {
  const uint32_t g = 0u - t;
  for (int q = 0; q < W; ++q) {
    const uint32_t r = gadd<GW>(v[q], gadd<GW>(s[q], np1[q] & g));
    y[q] = negate ? gneg<GW>(r) : r;
  }
}

// B1's per-thread body: the from-root walk of one point under one key.
template <int GW>
DCF_HD void walk_point(const AesTables& a, const LevelCw* cw, int n,
                       const uint32_t s0[4], const uint32_t np1[4],
                       const uint8_t* x, uint32_t t0, bool negate,
                       uint32_t y[4]) {
  uint32_t s[4] = {s0[0], s0[1], s0[2], s0[3]};
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  uint32_t t = t0;
  walk_levels<GW>(a, cw, n, x, 0, s, t, v);
  finalize<GW>(s, t, v, np1, negate, y);
}

// Frontier index of a point: its first k walk bits, bit-reversed (the
// tree stores each level as [lefts ; rights]).
DCF_HD uint32_t frontier_index(const uint8_t* x, int k) {
  uint32_t idx = 0;
  for (int i = 0; i < k; ++i) idx |= walk_bit(x, i) << i;
  return idx;
}

// B3's per-thread body: walk levels k..n-1 from a frontier row (s with t
// stashed in the masked bit, then v).  cw holds levels k..n-1.
template <int GW>
DCF_HD void prefix_point(const AesTables& a, const LevelCw* cw, int n, int k,
                         const uint32_t row_s[4], const uint32_t row_v[4],
                         const uint32_t np1[4], const uint8_t* x, bool negate,
                         uint32_t y[4]) {
  uint32_t s[4] = {row_s[0], row_s[1], row_s[2], row_s[3] & kMaskBit};
  uint32_t v[4] = {row_v[0], row_v[1], row_v[2], row_v[3]};
  uint32_t t = (row_s[3] >> 24) & 1u;
  walk_levels<GW>(a, cw, n - k, x, k, s, t, v);
  finalize<GW>(s, t, v, np1, negate, y);
}

// A tree node's children from its Hirose children c: the correction words
// applied where the parent's t is set, and v pushed down both branches.
template <int GW>
DCF_HD void tree_children(const Children& c, const LevelCw& w,
                          const uint32_t v[4], uint32_t t, uint32_t sl[4],
                          uint32_t vl[4], uint32_t& tl, uint32_t sr[4],
                          uint32_t vr[4], uint32_t& tr) {
  const uint32_t g = 0u - t;
  for (int q = 0; q < 4; ++q) {
    const uint32_t csg = w.s[q] & g;
    const uint32_t cvg = w.v[q] & g;
    sl[q] = c.sl[q] ^ csg;
    sr[q] = c.sr[q] ^ csg;
    vl[q] = gadd<GW>(v[q], gadd<GW>(c.vl[q], cvg));
    vr[q] = gadd<GW>(v[q], gadd<GW>(c.vr[q], cvg));
  }
  tl = c.tl ^ (t & w.t);
  tr = c.tr ^ (t & (w.t >> 1));
}

// One parent node into its two children on these tables (B2 and B2f run
// the same algebra on the banked AES, aes_banked.cuh::tree_subtree; this
// form stays the host tests' second reference).
template <int GW>
DCF_HD void tree_node(const AesTables& a, const LevelCw& w,
                      const uint32_t s[4], const uint32_t v[4], uint32_t t,
                      uint32_t sl[4], uint32_t vl[4], uint32_t& tl,
                      uint32_t sr[4], uint32_t vr[4], uint32_t& tr) {
  Children c;
  hirose_expand(a, s, c);
  tree_children<GW>(c, w, v, t, sl, vl, tl, sr, vr, tr);
}

// The last level of a full-domain expansion (XOR group): one parent node
// into the two leaf shares y = v ^ s ^ t * cw_np1 of its children (B2f's
// first, T-table body; the host tests hold the banked one against it).
DCF_HD void tree_leaves(const AesTables& a, const LevelCw& w,
                        const uint32_t np1[4], const uint32_t s[4],
                        const uint32_t v[4], uint32_t t, uint32_t yl[4],
                        uint32_t yr[4]) {
  uint32_t sl[4], vl[4], sr[4], vr[4], tl, tr;
  tree_node<0>(a, w, s, v, t, sl, vl, tl, sr, vr, tr);
  finalize<0>(sl, tl, vl, np1, false, yl);
  finalize<0>(sr, tr, vr, np1, false, yr);
}

}  // namespace dcf
