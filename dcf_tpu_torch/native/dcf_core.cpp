// dcf_core.cpp — the port's own copy of the native host core: AES-256,
// Hirose PRG, DCF gen/eval.
//
// Role: the C++ equivalent of the reference Rust crate's host side: host
// keygen and evaluation for the facade's backend="cpu", the byte anchor of
// the port's bench line (bench_torch.py) and the single-core rate it
// prints beside the pinned baseline.  Semantics mirror the reference
// crate's src/lib.rs:86-204 and src/prg.rs:42-73 exactly; layout is the
// KeyBundle SoA.  Below this header the code is the JAX package's
// dcf_tpu/native/dcf_core.cpp, unchanged, so the two cores give the same
// bytes.
//
// Build: dcf_tpu_torch.native compiles it with g++ at first use (-O3
// -march=native; AES-NI when the CPU has it, portable S-box path otherwise
// — both bit-exact).
//
// C ABI only; loaded from Python with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#if defined(__AES__)
#include <wmmintrin.h>
#define DCF_HAVE_AESNI 1
#else
#define DCF_HAVE_AESNI 0
#endif

namespace {

// ---------------------------------------------------------------------------
// AES-256, encrypt-only.
// ---------------------------------------------------------------------------

struct SboxTables {
  uint8_t sbox[256];
  constexpr SboxTables() : sbox{} {
    // GF(2^8) inverse via exp/log tables (generator 3), then the affine map.
    uint8_t exp[512] = {};
    uint8_t log[256] = {};
    uint8_t x = 1;
    for (int i = 0; i < 255; i++) {
      exp[i] = x;
      log[x] = static_cast<uint8_t>(i);
      uint8_t hi = static_cast<uint8_t>(x & 0x80);
      x = static_cast<uint8_t>(x ^ ((x << 1) ^ (hi ? 0x1B : 0)));
    }
    for (int i = 255; i < 512; i++) exp[i] = exp[i - 255];
    for (int a = 0; a < 256; a++) {
      uint8_t b = a == 0 ? 0 : exp[255 - log[a]];
      uint8_t r = 0x63;
      for (int sh = 0; sh < 5; sh++)
        r = static_cast<uint8_t>(r ^ static_cast<uint8_t>((b << sh) | (b >> (8 - sh))));
      sbox[a] = r;
    }
  }
};

constexpr SboxTables kTables;

constexpr uint8_t kRcon[11] = {0x01, 0x02, 0x04, 0x08, 0x10, 0x20,
                               0x40, 0x80, 0x1B, 0x36, 0x6C};

struct RoundKeys {
  uint8_t rk[15][16];
};

void expand_key(const uint8_t key[32], RoundKeys* out) {
  uint8_t w[60][4];
  std::memcpy(w, key, 32);
  for (int i = 8; i < 60; i++) {
    uint8_t t[4] = {w[i - 1][0], w[i - 1][1], w[i - 1][2], w[i - 1][3]};
    if (i % 8 == 0) {
      uint8_t rot = t[0];
      t[0] = static_cast<uint8_t>(kTables.sbox[t[1]] ^ kRcon[i / 8 - 1]);
      t[1] = kTables.sbox[t[2]];
      t[2] = kTables.sbox[t[3]];
      t[3] = kTables.sbox[rot];
    } else if (i % 8 == 4) {
      for (auto& b : t) b = kTables.sbox[b];
    }
    for (int j = 0; j < 4; j++) w[i][j] = static_cast<uint8_t>(w[i - 8][j] ^ t[j]);
  }
  std::memcpy(out->rk, w, 240);
}

inline uint8_t xtime(uint8_t a) {
  return static_cast<uint8_t>((a << 1) ^ ((a & 0x80) ? 0x1B : 0));
}

// [[maybe_unused]]: the AES-NI build keeps the portable cipher compiled
// (it is the -Werror-checked fallback the portable .so ships) but never
// calls it.
[[maybe_unused]] void aes256_encrypt_portable(const RoundKeys& rk,
                                              const uint8_t in[16],
                                              uint8_t out[16]) {
  uint8_t s[16];
  for (int i = 0; i < 16; i++) s[i] = static_cast<uint8_t>(in[i] ^ rk.rk[0][i]);
  static constexpr int kShift[16] = {0, 5, 10, 15, 4, 9, 14, 3,
                                     8, 13, 2, 7, 12, 1, 6, 11};
  uint8_t t[16];
  for (int rnd = 1; rnd < 14; rnd++) {
    for (int i = 0; i < 16; i++) t[i] = kTables.sbox[s[kShift[i]]];
    for (int c = 0; c < 4; c++) {
      uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2], a3 = t[4 * c + 3];
      s[4 * c + 0] = static_cast<uint8_t>(xtime(a0) ^ xtime(a1) ^ a1 ^ a2 ^ a3 ^ rk.rk[rnd][4 * c + 0]);
      s[4 * c + 1] = static_cast<uint8_t>(a0 ^ xtime(a1) ^ xtime(a2) ^ a2 ^ a3 ^ rk.rk[rnd][4 * c + 1]);
      s[4 * c + 2] = static_cast<uint8_t>(a0 ^ a1 ^ xtime(a2) ^ xtime(a3) ^ a3 ^ rk.rk[rnd][4 * c + 2]);
      s[4 * c + 3] = static_cast<uint8_t>(xtime(a0) ^ a0 ^ a1 ^ a2 ^ xtime(a3) ^ rk.rk[rnd][4 * c + 3]);
    }
  }
  for (int i = 0; i < 16; i++)
    out[i] = static_cast<uint8_t>(kTables.sbox[s[kShift[i]]] ^ rk.rk[14][i]);
}

#if DCF_HAVE_AESNI
// Encrypt two independent blocks with the same key schedule, pipelined so the
// two AESENC chains overlap (the PRG always encrypts seed and seed^c pairs).
inline void aes256_encrypt2_ni(const RoundKeys& rk, const uint8_t in0[16],
                               const uint8_t in1[16], uint8_t out0[16],
                               uint8_t out1[16]) {
  const __m128i* k = reinterpret_cast<const __m128i*>(rk.rk);
  __m128i r0 = _mm_xor_si128(_mm_loadu_si128(reinterpret_cast<const __m128i*>(in0)),
                             _mm_loadu_si128(k));
  __m128i r1 = _mm_xor_si128(_mm_loadu_si128(reinterpret_cast<const __m128i*>(in1)),
                             _mm_loadu_si128(k));
  for (int rnd = 1; rnd < 14; rnd++) {
    __m128i kr = _mm_loadu_si128(k + rnd);
    r0 = _mm_aesenc_si128(r0, kr);
    r1 = _mm_aesenc_si128(r1, kr);
  }
  __m128i kr = _mm_loadu_si128(k + 14);
  r0 = _mm_aesenclast_si128(r0, kr);
  r1 = _mm_aesenclast_si128(r1, kr);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(out0), r0);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(out1), r1);
}
#endif

inline void aes256_encrypt2(const RoundKeys& rk, const uint8_t in0[16],
                            const uint8_t in1[16], uint8_t out0[16],
                            uint8_t out1[16]) {
#if DCF_HAVE_AESNI
  aes256_encrypt2_ni(rk, in0, in1, out0, out1);
#else
  aes256_encrypt_portable(rk, in0, out0);
  aes256_encrypt_portable(rk, in1, out1);
#endif
}

// ---------------------------------------------------------------------------
// Hirose PRG (reference src/prg.rs:42-73).
// ---------------------------------------------------------------------------

struct Prg {
  uint32_t lam = 0;
  uint32_t n_enc = 0;  // min(2, lam/16)
  RoundKeys rk[2];     // ciphers 0 and 17 (the only ones ever used)
};

// One PRG call.  Outputs: s_l, v_l, s_r, v_r each `lam` bytes; t_l/t_r bits.
// seed_p_buf: caller-provided scratch of `lam` bytes (no allocation in the
// hot loop — this runs once per level per point in the CPU baseline).
void prg_gen(const Prg& prg, const uint8_t* seed, uint8_t* s_l, uint8_t* v_l,
             uint8_t* s_r, uint8_t* v_r, uint8_t* t_l, uint8_t* t_r,
             uint8_t* seed_p_buf) {
  const uint32_t lam = prg.lam;
  uint8_t* seed_p = seed_p_buf;
  for (uint32_t i = 0; i < lam; i++) seed_p[i] = static_cast<uint8_t>(seed[i] ^ 0xFF);
  uint8_t* buf0[2] = {s_l, s_r};  // result_buf0 halves
  uint8_t* buf1[2] = {v_l, v_r};  // result_buf1 halves
  std::memset(s_l, 0, lam);
  std::memset(s_r, 0, lam);
  std::memset(v_l, 0, lam);
  std::memset(v_r, 0, lam);
  for (uint32_t k = 0; k < prg.n_enc; k++) {
    aes256_encrypt2(prg.rk[k], seed + 16 * k, seed_p + 16 * k,
                    buf0[k] + 16 * k, buf1[k] + 16 * k);
  }
  for (int h = 0; h < 2; h++) {
    for (uint32_t i = 0; i < lam; i++) {
      buf0[h][i] = static_cast<uint8_t>(buf0[h][i] ^ seed[i]);
      buf1[h][i] = static_cast<uint8_t>(buf1[h][i] ^ seed_p[i]);
    }
  }
  *t_l = static_cast<uint8_t>(buf0[0][0] & 1);
  *t_r = static_cast<uint8_t>(buf1[0][0] & 1);
  buf0[0][lam - 1] &= 0xFE;
  buf0[1][lam - 1] &= 0xFE;
  buf1[0][lam - 1] &= 0xFE;
  buf1[1][lam - 1] &= 0xFE;
}

inline int bit_msb(const uint8_t* data, uint32_t i) {
  return (data[i >> 3] >> (7 - (i & 7))) & 1;
}

inline void xor_into(uint8_t* dst, const uint8_t* src, uint32_t n) {
  for (uint32_t i = 0; i < n; i++) dst[i] = static_cast<uint8_t>(dst[i] ^ src[i]);
}

// ---------------------------------------------------------------------------
// DCF gen (reference src/lib.rs:86-161) for one key.
// ---------------------------------------------------------------------------

void gen_one(const Prg& prg, uint32_t n_bytes, const uint8_t* alpha,
             const uint8_t* beta, const uint8_t* s0_pair, int bound_gt,
             uint8_t* cw_s, uint8_t* cw_v, uint8_t* cw_t, uint8_t* cw_np1) {
  const uint32_t lam = prg.lam;
  const uint32_t n = 8 * n_bytes;
  std::vector<uint8_t> s_a(s0_pair, s0_pair + lam);
  std::vector<uint8_t> s_b(s0_pair + lam, s0_pair + 2 * lam);
  uint8_t t_a = 0, t_b = 1;
  std::vector<uint8_t> v_alpha(lam, 0);
  std::vector<uint8_t> p0(4 * lam), p1(4 * lam), seed_p(lam);
  for (uint32_t i = 0; i < n; i++) {
    uint8_t* s0l = p0.data();
    uint8_t* v0l = p0.data() + lam;
    uint8_t* s0r = p0.data() + 2 * lam;
    uint8_t* v0r = p0.data() + 3 * lam;
    uint8_t* s1l = p1.data();
    uint8_t* v1l = p1.data() + lam;
    uint8_t* s1r = p1.data() + 2 * lam;
    uint8_t* v1r = p1.data() + 3 * lam;
    uint8_t t0l, t0r, t1l, t1r;
    prg_gen(prg, s_a.data(), s0l, v0l, s0r, v0r, &t0l, &t0r, seed_p.data());
    prg_gen(prg, s_b.data(), s1l, v1l, s1r, v1r, &t1l, &t1r, seed_p.data());
    int a_i = bit_msb(alpha, i);
    // keep = R iff a_i; lose is the other side.
    uint8_t* ls0 = a_i ? s0l : s0r;
    uint8_t* ls1 = a_i ? s1l : s1r;
    uint8_t* lv0 = a_i ? v0l : v0r;
    uint8_t* lv1 = a_i ? v1l : v1r;
    uint8_t* ks0 = a_i ? s0r : s0l;
    uint8_t* ks1 = a_i ? s1r : s1l;
    uint8_t* kv0 = a_i ? v0r : v0l;
    uint8_t* kv1 = a_i ? v1r : v1l;
    uint8_t* scw = cw_s + i * lam;
    uint8_t* vcw = cw_v + i * lam;
    for (uint32_t j = 0; j < lam; j++) {
      scw[j] = static_cast<uint8_t>(ls0[j] ^ ls1[j]);
      vcw[j] = static_cast<uint8_t>(lv0[j] ^ lv1[j] ^ v_alpha[j]);
    }
    // beta folds in when the lose side matches the bound (src/lib.rs:114-125):
    // LtBeta on lose==L (a_i==1), GtBeta on lose==R (a_i==0).
    if ((!bound_gt && a_i) || (bound_gt && !a_i)) xor_into(vcw, beta, lam);
    for (uint32_t j = 0; j < lam; j++)
      v_alpha[j] = static_cast<uint8_t>(v_alpha[j] ^ kv0[j] ^ kv1[j] ^ vcw[j]);
    uint8_t t0k = a_i ? t0r : t0l;
    uint8_t t1k = a_i ? t1r : t1l;
    uint8_t tl_cw = static_cast<uint8_t>(t0l ^ t1l ^ a_i ^ 1);
    uint8_t tr_cw = static_cast<uint8_t>(t0r ^ t1r ^ a_i);
    cw_t[i * 2] = tl_cw;
    cw_t[i * 2 + 1] = tr_cw;
    uint8_t t_cw_keep = a_i ? tr_cw : tl_cw;
    for (uint32_t j = 0; j < lam; j++) {
      s_a[j] = static_cast<uint8_t>(ks0[j] ^ (t_a ? scw[j] : 0));
      s_b[j] = static_cast<uint8_t>(ks1[j] ^ (t_b ? scw[j] : 0));
    }
    t_a = static_cast<uint8_t>(t0k ^ (t_a & t_cw_keep));
    t_b = static_cast<uint8_t>(t1k ^ (t_b & t_cw_keep));
  }
  for (uint32_t j = 0; j < lam; j++)
    cw_np1[j] = static_cast<uint8_t>(s_a[j] ^ s_b[j] ^ v_alpha[j]);
}

// ---------------------------------------------------------------------------
// DCF eval (reference src/lib.rs:163-204) for one (key, point) pair.
// ---------------------------------------------------------------------------

void eval_one(const Prg& prg, int b, uint32_t n_bytes, const uint8_t* s0,
              const uint8_t* cw_s, const uint8_t* cw_v, const uint8_t* cw_t,
              const uint8_t* cw_np1, const uint8_t* x, uint8_t* y,
              uint8_t* scratch /* 6*lam bytes */) {
  const uint32_t lam = prg.lam;
  const uint32_t n = 8 * n_bytes;
  uint8_t* s = scratch;
  uint8_t* s_l = scratch + lam;
  uint8_t* v_l = scratch + 2 * lam;
  uint8_t* s_r = scratch + 3 * lam;
  uint8_t* v_r = scratch + 4 * lam;
  uint8_t* seed_p = scratch + 5 * lam;
  std::memcpy(s, s0, lam);
  uint8_t t = static_cast<uint8_t>(b & 1);
  std::memset(y, 0, lam);
  for (uint32_t i = 0; i < n; i++) {
    uint8_t t_l, t_r;
    prg_gen(prg, s, s_l, v_l, s_r, v_r, &t_l, &t_r, seed_p);
    const uint8_t* scw = cw_s + i * lam;
    const uint8_t* vcw = cw_v + i * lam;
    int x_i = bit_msb(x, i);
    uint8_t* s_dir = x_i ? s_r : s_l;
    const uint8_t* v_dir = x_i ? v_r : v_l;
    uint8_t t_dir = x_i ? static_cast<uint8_t>(t_r ^ (t & cw_t[i * 2 + 1]))
                        : static_cast<uint8_t>(t_l ^ (t & cw_t[i * 2]));
    if (t) {
      for (uint32_t j = 0; j < lam; j++)
        y[j] = static_cast<uint8_t>(y[j] ^ v_dir[j] ^ vcw[j]);
      xor_into(s_dir, scw, lam);
    } else {
      xor_into(y, v_dir, lam);
    }
    std::memcpy(s, s_dir, lam);
    t = t_dir;
  }
  if (t) {
    for (uint32_t j = 0; j < lam; j++)
      y[j] = static_cast<uint8_t>(y[j] ^ s[j] ^ cw_np1[j]);
  } else {
    xor_into(y, s, lam);
  }
}

void run_threaded(uint64_t total, int num_threads,
                  const std::function<void(uint64_t, uint64_t)>& fn) {
  if (num_threads <= 1 || total < 2) {
    fn(0, total);
    return;
  }
  uint64_t nt = std::min<uint64_t>(num_threads, total);
  std::vector<std::thread> threads;
  uint64_t chunk = (total + nt - 1) / nt;
  for (uint64_t t = 0; t < nt; t++) {
    uint64_t lo = t * chunk;
    uint64_t hi = std::min(total, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}
}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Returns 1 if compiled with AES-NI, else 0 (both paths are bit-exact).
int dcf_has_aesni() { return DCF_HAVE_AESNI; }

// keys: num_keys contiguous 32-byte AES-256 keys.  Uses indices 17*k for
// k < min(2, lam/16) (the reference's truncating loop).  Returns 0 on
// success, negative on contract violation.
int dcf_prg_init(void* prg_out, uint32_t lam, const uint8_t* keys,
                 uint32_t num_keys) {
  if (lam == 0 || lam % 16 != 0) return -1;
  Prg* prg = static_cast<Prg*>(prg_out);
  prg->lam = lam;
  prg->n_enc = lam / 16 < 2 ? lam / 16 : 2;
  for (uint32_t k = 0; k < prg->n_enc; k++) {
    uint32_t idx = 17 * k;
    if (idx >= num_keys) return -2;
    expand_key(keys + 32 * idx, &prg->rk[k]);
  }
  return 0;
}

uint32_t dcf_prg_sizeof() { return sizeof(Prg); }

// Batched PRG (for tests): seeds [B, lam] -> six output arrays.
void dcf_prg_gen_batch(const void* prg_in, uint64_t batch, const uint8_t* seeds,
                       uint8_t* s_l, uint8_t* v_l, uint8_t* t_l, uint8_t* s_r,
                       uint8_t* v_r, uint8_t* t_r) {
  const Prg& prg = *static_cast<const Prg*>(prg_in);
  const uint32_t lam = prg.lam;
  std::vector<uint8_t> seed_p(lam);
  for (uint64_t i = 0; i < batch; i++) {
    prg_gen(prg, seeds + i * lam, s_l + i * lam, v_l + i * lam, s_r + i * lam,
            v_r + i * lam, t_l + i, t_r + i, seed_p.data());
  }
}

// Batched keygen: K keys, outputs in KeyBundle SoA layout (key-major).
void dcf_gen_batch(const void* prg_in, uint32_t num_keys, uint32_t n_bytes,
                   const uint8_t* alphas, const uint8_t* betas,
                   const uint8_t* s0s, int bound_gt, uint8_t* cw_s,
                   uint8_t* cw_v, uint8_t* cw_t, uint8_t* cw_np1,
                   int num_threads) {
  const Prg& prg = *static_cast<const Prg*>(prg_in);
  const uint32_t lam = prg.lam;
  const uint32_t n = 8 * n_bytes;
  run_threaded(num_keys, num_threads, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t k = lo; k < hi; k++) {
      gen_one(prg, n_bytes, alphas + k * n_bytes, betas + k * lam,
              s0s + k * 2 * lam, bound_gt, cw_s + k * static_cast<uint64_t>(n) * lam,
              cw_v + k * static_cast<uint64_t>(n) * lam, cw_t + k * static_cast<uint64_t>(n) * 2,
              cw_np1 + k * lam);
    }
  });
}

// Batched eval: K keys x M points -> ys [K, M, lam].
// xs is [M, n_bytes] when shared_xs != 0, else [K, M, n_bytes].
// s0 is the party-restricted seed array [K, lam].
void dcf_eval_batch(const void* prg_in, int b, uint32_t num_keys,
                    uint32_t n_bytes, uint64_t num_points, const uint8_t* s0,
                    const uint8_t* cw_s, const uint8_t* cw_v,
                    const uint8_t* cw_t, const uint8_t* cw_np1,
                    const uint8_t* xs, int shared_xs, uint8_t* ys,
                    int num_threads) {
  const Prg& prg = *static_cast<const Prg*>(prg_in);
  const uint32_t lam = prg.lam;
  const uint32_t n = 8 * n_bytes;
  const uint64_t total = static_cast<uint64_t>(num_keys) * num_points;
  run_threaded(total, num_threads, [&](uint64_t lo, uint64_t hi) {
    std::vector<uint8_t> scratch(6 * lam);
    for (uint64_t idx = lo; idx < hi; idx++) {
      uint64_t k = idx / num_points;
      uint64_t m = idx % num_points;
      const uint8_t* x = shared_xs ? xs + m * n_bytes
                                   : xs + (k * num_points + m) * n_bytes;
      eval_one(prg, b, n_bytes, s0 + k * lam,
               cw_s + k * static_cast<uint64_t>(n) * lam,
               cw_v + k * static_cast<uint64_t>(n) * lam,
               cw_t + k * static_cast<uint64_t>(n) * 2, cw_np1 + k * lam, x,
               ys + idx * lam, scratch.data());
    }
  });
}

}  // extern "C"
