"""Plain numpy DCF: AES-256, the Hirose PRG, key generation and
evaluation, written from the construction alone.

This is the yardstick that decides whether a benchmark run is correct.  It
imports nothing but numpy, and takes nothing that the program made: the
harness hands it the same alphas, betas, root seeds, cipher keys and
points it handed the program, and it works the keys out again.

The construction (Boyle, Chandran, Gilboa, Gupta, Ishai, Kumar, Rathee,
"Function Secret Sharing for Mixed-Mode and Fixed-Point Secure
Computation", EUROCRYPT 2021, eprint 2020/1392, Fig. 1, XOR output group) over the Hirose double-block-length PRG of the reference
crate (github.com/xymeng16/dcf, ``Aes256HirosePrg``):

- ``prg(s)`` for a lam-byte seed s: for block k < min(2, lam / 16), cipher
  17 * k encrypts s's k-th 16-byte block into buffer 0 and ~s's into
  buffer 1; both buffers are then XORed with s (buffer 0) and ~s (buffer
  1) over their whole width, with the other half of each a plain copy of
  the seed.  t_l and t_r are bit 0 of byte 0 of the two buffers' first
  halves; bit 0 of the last byte of all four outputs is then cleared.
  Left child (s_l, v_l) = the first halves, right child (s_r, v_r) = the
  second halves.
- ``gen`` walks both parties' seeds down alpha's bits (MSB first),
  emitting per level a seed, value and two t correction words, and
  CW_{n+1} at the end; beta is folded into the value word where alpha's
  bit is 1 (bound LT_BETA: f(x) = beta for x < alpha, else 0).
- ``eval`` walks party b's seed down x's bits, XORing the value words;
  the share is v ^ s_n ^ t_n * CW_{n+1}.

``rounds`` below 14 is the control: AES-256's key schedule with fewer
rounds, a tempting speed-up that breaks the configuration's "AES-256
Hirose PRG" guarantee.  The comparison must fail it.

``expected`` and ``control`` are what the harness's comparison calls
(``check.py``) for a configuration that names this reference.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SBOX", "expand_key", "encrypt", "prg", "gen_keys",
           "eval_points", "dcf_value", "expected", "control",
           "CONTROL_ROUNDS"]

AES_ROUNDS = 14
CONTROL_ROUNDS = 10


def _gf_mul(a: int, b: int) -> int:
    """Multiply in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = ((a << 1) ^ (0x11B if a & 0x80 else 0)) & 0xFF
        b >>= 1
    return out


def _sbox() -> np.ndarray:
    """The AES S-box from its definition: the GF(2^8) inverse (through
    the powers of the generator 3) followed by the affine map with
    constant 0x63."""
    exp = [1] * 255
    for i in range(1, 255):
        exp[i] = _gf_mul(exp[i - 1], 3)
    log = {e: i for i, e in enumerate(exp)}
    box = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        inv = exp[(255 - log[a]) % 255] if a else 0
        rot = out = inv
        for _ in range(4):
            rot = ((rot << 1) | (rot >> 7)) & 0xFF
            out ^= rot
        box[a] = out ^ 0x63
    return box


SBOX = _sbox()


def _t_tables() -> tuple[np.ndarray, ...]:
    """T0..T3 as little-endian uint32: byte r of T_j[a] is row r of
    MixColumns applied to S[a] placed in row j of a column."""
    mix = ((2, 3, 1, 1), (1, 2, 3, 1), (1, 1, 2, 3), (3, 1, 1, 2))
    tables = []
    for j in range(4):
        t = np.zeros(256, dtype=np.uint32)
        for a in range(256):
            s = int(SBOX[a])
            word = 0
            for r in range(4):
                word |= _gf_mul(s, mix[r][j]) << (8 * r)
            t[a] = word
        tables.append(t)
    return tuple(tables)


T_TABLES = _t_tables()


def expand_key(key: bytes) -> np.ndarray:
    """AES-256 key schedule: 32 key bytes -> round keys uint8 [15, 16]."""
    if len(key) != 32:
        raise ValueError("an AES-256 key has 32 bytes")
    words = [list(key[4 * i:4 * i + 4]) for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        w = list(words[i - 1])
        if i % 8 == 0:
            w = w[1:] + w[:1]
            w = [int(SBOX[x]) for x in w]
            w[0] ^= rcon
            rcon = _gf_mul(rcon, 2)
        elif i % 8 == 4:
            w = [int(SBOX[x]) for x in w]
        words.append([a ^ b for a, b in zip(words[i - 8], w)])
    return np.array(words, dtype=np.uint8).reshape(15, 16)


def encrypt(round_keys: np.ndarray, blocks: np.ndarray,
            rounds: int = AES_ROUNDS) -> np.ndarray:
    """Encrypt uint8 blocks [N, 16] with round keys uint8 [15, 16].

    The state is held as four little-endian uint32 columns; a full round
    is four T-table lookups a column.  ``rounds`` < 14 is the control."""
    rk = np.ascontiguousarray(round_keys).view("<u4")  # [15, 4]
    state = np.ascontiguousarray(blocks).view("<u4") ^ rk[0]  # [N, 4]
    t0, t1, t2, t3 = T_TABLES
    for rnd in range(1, rounds):
        b = state.view(np.uint8)  # [N, 16], byte 4c + r = row r, column c
        cols = [t0[b[:, 4 * c]] ^ t1[b[:, 4 * ((c + 1) % 4) + 1]]
                ^ t2[b[:, 4 * ((c + 2) % 4) + 2]]
                ^ t3[b[:, 4 * ((c + 3) % 4) + 3]] for c in range(4)]
        state = np.stack(cols, axis=1) ^ rk[rnd]
    b = state.view(np.uint8)
    shifted = np.stack([b[:, 4 * ((c + r) % 4) + r]
                        for c in range(4) for r in range(4)], axis=1)
    return SBOX[shifted] ^ round_keys[rounds]


def prg(round_keys: dict, seeds: np.ndarray, rounds: int = AES_ROUNDS):
    """The Hirose PRG over seeds uint8 [N, lam] -> (s_l, v_l, t_l, s_r,
    v_r, t_r); ``round_keys`` maps cipher index to its round keys."""
    n, lam = seeds.shape
    comp = seeds ^ np.uint8(0xFF)
    buf0 = np.zeros((n, 2, lam), dtype=np.uint8)
    buf1 = np.zeros((n, 2, lam), dtype=np.uint8)
    for k in range(min(2, lam // 16)):
        both = encrypt(round_keys[17 * k],
                       np.concatenate([seeds[:, 16 * k:16 * k + 16],
                                       comp[:, 16 * k:16 * k + 16]]), rounds)
        buf0[:, k, 16 * k:16 * k + 16] = both[:n]
        buf1[:, k, 16 * k:16 * k + 16] = both[n:]
    buf0 ^= seeds[:, None, :]
    buf1 ^= comp[:, None, :]
    t_l = buf0[:, 0, 0] & 1
    t_r = buf1[:, 0, 0] & 1
    buf0[:, :, lam - 1] &= 0xFE
    buf1[:, :, lam - 1] &= 0xFE
    return buf0[:, 0], buf1[:, 0], t_l, buf0[:, 1], buf1[:, 1], t_r


def _round_keys(cipher_keys, lam: int) -> dict:
    return {17 * k: expand_key(cipher_keys[17 * k])
            for k in range(min(2, lam // 16))}


def _pick(q: tuple, left: int, right: int, right_mask) -> np.ndarray:
    """PRG output ``q[right]`` where ``right_mask`` holds, else
    ``q[left]`` (indices into prg's six outputs)."""
    return np.where(right_mask, q[right], q[left])


def _bits(a: np.ndarray) -> np.ndarray:
    """uint8 [N, nb] -> bits uint8 [N, 8 nb], most significant first."""
    return np.unpackbits(a, axis=1)


def gen_keys(cipher_keys, alphas: np.ndarray, betas: np.ndarray,
             s0s: np.ndarray, rounds: int = AES_ROUNDS) -> dict:
    """Keys of f_k(x) = betas[k] if x < alphas[k] else 0, XOR group.

    alphas uint8 [K, nb], betas uint8 [K, lam], s0s uint8 [K, 2, lam] (the
    two parties' root seeds).  Returns s0s and the correction words cw_s,
    cw_v uint8 [K, n, lam], cw_t uint8 [K, n, 2], cw_np1 uint8 [K, lam]."""
    k_num, lam = betas.shape
    rks = _round_keys(cipher_keys, lam)
    a_bits = _bits(alphas)
    n = a_bits.shape[1]
    s = [s0s[:, 0].copy(), s0s[:, 1].copy()]
    t = [np.zeros(k_num, np.uint8), np.ones(k_num, np.uint8)]
    v_alpha = np.zeros((k_num, lam), np.uint8)
    cw_s = np.zeros((k_num, n, lam), np.uint8)
    cw_v = np.zeros((k_num, n, lam), np.uint8)
    cw_t = np.zeros((k_num, n, 2), np.uint8)
    for i in range(n):
        p = [prg(rks, s[0], rounds), prg(rks, s[1], rounds)]
        a = a_bits[:, i]
        keep_r = a.astype(bool)[:, None]
        # The "lose" side is the child alpha does not take.
        s_lose = [_pick(q, 3, 0, keep_r) for q in p]
        v_lose = [_pick(q, 4, 1, keep_r) for q in p]
        v_keep = [_pick(q, 1, 4, keep_r) for q in p]
        scw = s_lose[0] ^ s_lose[1]
        vcw = v_lose[0] ^ v_lose[1] ^ v_alpha ^ (betas * a[:, None])
        v_alpha = v_alpha ^ v_keep[0] ^ v_keep[1] ^ vcw
        tl_cw = p[0][2] ^ p[1][2] ^ a ^ 1
        tr_cw = p[0][5] ^ p[1][5] ^ a
        cw_s[:, i], cw_v[:, i] = scw, vcw
        cw_t[:, i, 0], cw_t[:, i, 1] = tl_cw, tr_cw
        t_keep_cw = np.where(a.astype(bool), tr_cw, tl_cw)
        for b in (0, 1):
            s_keep = _pick(p[b], 0, 3, keep_r)
            t_keep = np.where(a.astype(bool), p[b][5], p[b][2])
            s[b] = s_keep ^ scw * t[b][:, None]
            t[b] = t_keep ^ (t[b] & t_keep_cw)
    return {"s0s": s0s.copy(), "cw_s": cw_s, "cw_v": cw_v, "cw_t": cw_t,
            "cw_np1": s[0] ^ s[1] ^ v_alpha}


def eval_points(cipher_keys, b: int, keys: dict, xs: np.ndarray,
                rounds: int = AES_ROUNDS) -> np.ndarray:
    """Party b's shares at P (key, point) pairs: ``keys`` holds one key a
    pair (s0s [P, 2, lam], cw_s, cw_v [P, n, lam], cw_t [P, n, 2], cw_np1
    [P, lam]; ``np.broadcast_to`` serves one key at many points) and xs
    uint8 [P, nb].  Returns uint8 [P, lam]."""
    p_num, n, lam = keys["cw_s"].shape
    rks = _round_keys(cipher_keys, lam)
    x_bits = _bits(xs)
    if x_bits.shape != (p_num, n):
        raise ValueError(f"points {xs.shape} do not fit {n}-level keys "
                         f"at {p_num} pairs")
    s = np.ascontiguousarray(keys["s0s"][:, b])
    t = np.full(p_num, b, np.uint8)
    v = np.zeros((p_num, lam), np.uint8)
    for i in range(n):
        s_l, v_l, t_l, s_r, v_r, t_r = prg(rks, s, rounds)
        tm = t[:, None]
        right = x_bits[:, i].astype(bool)
        v ^= np.where(right[:, None], v_r, v_l) ^ keys["cw_v"][:, i] * tm
        cs = keys["cw_s"][:, i] * tm
        s = np.where(right[:, None], s_r ^ cs, s_l ^ cs)
        cwt = keys["cw_t"][:, i]
        t = np.where(right, t_r ^ (t & cwt[:, 1]), t_l ^ (t & cwt[:, 0]))
    return v ^ s ^ keys["cw_np1"] * t[:, None]


def dcf_value(alphas: np.ndarray, betas: np.ndarray,
              xs: np.ndarray) -> np.ndarray:
    """f(x) at P (key, point) pairs: betas[p] where xs[p] < alphas[p]
    (unsigned big-endian), else zero.  The two parties' shares XOR to
    this."""
    below = np.zeros(xs.shape[0], bool)
    equal = np.ones(xs.shape[0], bool)
    for j in range(xs.shape[1]):
        below |= equal & (xs[:, j] < alphas[:, j])
        equal &= xs[:, j] == alphas[:, j]
    return np.where(below[:, None], betas, 0).astype(np.uint8)


def expected(inputs: dict, queries: list, rounds: int = AES_ROUNDS) -> list:
    """Party ``inputs["party"]``'s shares for each query: ``inputs`` holds
    the cipher keys, the alphas, betas and root seeds of every key, the
    bound and the group; a query {"keys": int [Kq], "xs": uint8 [P, nb]}
    asks for those keys at those points.  Returns uint8 [Kq, P, lam] a
    query.  Each key used is generated once."""
    if inputs["bound"] != "LT_BETA" or inputs["group"] != "xor":
        raise ValueError("the reference computes bound LT_BETA over the XOR "
                         f"group, not {inputs['bound']} over "
                         f"{inputs['group']}")
    used = np.unique(np.concatenate([q["keys"] for q in queries]))
    pos = np.searchsorted(used, np.concatenate(
        [np.repeat(q["keys"], len(q["xs"])) for q in queries]))
    keys = gen_keys(inputs["cipher_keys"], inputs["alphas"][used],
                    inputs["betas"][used], inputs["s0s"][used],
                    rounds=rounds)
    xs = np.concatenate([np.tile(q["xs"], (len(q["keys"]), 1))
                         for q in queries])
    shares = eval_points(inputs["cipher_keys"], inputs["party"],
                         {name: a[pos] for name, a in keys.items()}, xs,
                         rounds=rounds)
    out, at = [], 0
    for q in queries:
        kq, p = len(q["keys"]), len(q["xs"])
        out.append(shares[at:at + kq * p].reshape(kq, p, -1))
        at += kq * p
    return out


def control(inputs: dict, queries: list) -> list:
    """``expected`` with AES-256 cut to ``CONTROL_ROUNDS`` rounds in
    keygen and evaluation: the comparison's control."""
    return expected(inputs, queries, rounds=CONTROL_ROUNDS)
