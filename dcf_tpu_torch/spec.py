"""Pure-Python golden model of the DCF scheme (the "spec").

Counterpart of ``dcf_tpu/spec.py``: the slow, obviously-correct
executable specification every other evaluator of the port (the numpy
oracle, the C++ host core, the CUDA kernels and their plain versions) is
held against, byte for byte.  It carries the scheme constants (``Bound``,
the output-group tables and ``check_group``, ``ReferenceContractWarning``
and ``hirose_used_cipher_indices``, the AES S-box, ``SHIFT_ROWS`` and the
AES-256 key schedule), the byte-level group algebra (``bytes_to_lanes``,
``lanes_to_bytes``, ``group_add`` / ``group_sub`` / ``group_neg``), one
AES-256 block (``aes256_encrypt_block``), the Hirose PRG
(``HirosePrgSpec``) and the scheme itself: ``gen``, ``eval_point`` and
``eval_batch`` over ``CmpFn`` / ``Cw`` / ``Share``.  Everything here
works on ``bytes`` and Python ints: no numpy, no torch.

Semantics (shared with the reference package):

* ``f(x) = beta if x < alpha else 0`` for ``Bound.LT_BETA`` (strict),
  ``x > alpha`` for ``Bound.GT_BETA``; x is compared as unsigned
  big-endian bytes and the GGM tree is walked MSB-first.
* Output groups: ``xor`` (byte-wise) and ``add8``/``add16``/``add32``,
  the lam payload bytes read as little-endian w-bit lanes.
* The PRG is the Hirose double-block construction over AES-256 with the
  reference's loop truncation: only cipher indices ``17*k`` for
  ``k < min(2, lam // 16)`` ever encrypt.
"""

from __future__ import annotations

import os
import sys
import warnings
from dataclasses import dataclass
from enum import Enum
from typing import Sequence

__all__ = [
    "AES_SBOX",
    "GROUPS",
    "GROUP_CODE",
    "GROUP_FROM_CODE",
    "GROUP_WIDTH",
    "SHIFT_ROWS",
    "Bound",
    "CmpFn",
    "Cw",
    "HirosePrgSpec",
    "ReferenceContractWarning",
    "Share",
    "aes256_encrypt_block",
    "aes256_expand_key",
    "bytes_to_lanes",
    "check_group",
    "eval_batch",
    "eval_point",
    "gen",
    "group_add",
    "group_neg",
    "group_sub",
    "hirose_used_cipher_indices",
    "lanes_to_bytes",
    "xor_bytes",
]

GROUPS = ("xor", "add8", "add16", "add32")
GROUP_CODE = {"xor": 0, "add8": 1, "add16": 2, "add32": 3}
GROUP_FROM_CODE = {code: name for name, code in GROUP_CODE.items()}
GROUP_WIDTH = {"add8": 8, "add16": 16, "add32": 32}  # lane width, bits


def check_group(group: str, lam: int) -> None:
    """Validate a group name against a payload width (API edge)."""
    if group not in GROUP_CODE:
        # api-edge: documented output-group contract
        raise ValueError(
            f"unknown output group {group!r}; expected one of {GROUPS}")
    if group != "xor" and (8 * lam) % GROUP_WIDTH[group] != 0:
        # api-edge: additive lanes must tile the payload exactly
        raise ValueError(
            f"group {group!r} needs lam*8={8 * lam} divisible by "
            f"{GROUP_WIDTH[group]}")


def bytes_to_lanes(data: bytes, w: int) -> list[int]:
    """Read bytes as little-endian w-bit lanes (w in 8, 16, 32)."""
    step = w // 8
    return [int.from_bytes(data[i:i + step], "little")
            for i in range(0, len(data), step)]


def lanes_to_bytes(lanes: Sequence[int], w: int) -> bytes:
    """Inverse of :func:`bytes_to_lanes`; values reduced mod 2^w."""
    step, mask = w // 8, (1 << w) - 1
    return b"".join((v & mask).to_bytes(step, "little") for v in lanes)


def group_add(a: bytes, b: bytes, group: str) -> bytes:
    """Group operation on payload bytes: XOR, or per-lane add mod 2^w."""
    if group == "xor":
        return xor_bytes(a, b)
    w = GROUP_WIDTH[group]
    return lanes_to_bytes(
        [x + y for x, y in zip(bytes_to_lanes(a, w), bytes_to_lanes(b, w))],
        w)


def group_sub(a: bytes, b: bytes, group: str) -> bytes:
    """Group inverse-apply: XOR, or per-lane ``a - b mod 2^w``."""
    if group == "xor":
        return xor_bytes(a, b)
    w = GROUP_WIDTH[group]
    return lanes_to_bytes(
        [x - y for x, y in zip(bytes_to_lanes(a, w), bytes_to_lanes(b, w))],
        w)


def group_neg(a: bytes, group: str) -> bytes:
    """Group negation: identity for XOR, per-lane ``-a mod 2^w`` else."""
    if group == "xor":
        return a
    w = GROUP_WIDTH[group]
    return lanes_to_bytes([-x for x in bytes_to_lanes(a, w)], w)


class Bound(Enum):
    """Which side of alpha gets beta."""

    LT_BETA = "lt"  # f(x) = beta iff x < alpha
    GT_BETA = "gt"  # f(x) = beta iff x > alpha


# ---------------------------------------------------------------------------
# AES-256 (FIPS-197) tables and key schedule.
# ---------------------------------------------------------------------------

def _build_sbox() -> bytes:
    """The AES S-box from first principles (GF(2^8) inverse + affine map)."""
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 512):
        exp[i] = exp[i - 255]

    sbox = bytearray(256)
    for a in range(256):
        b = 0 if a == 0 else exp[255 - log[a]]
        r = 0x63
        for shift in (0, 1, 2, 3, 4):
            r ^= ((b << shift) | (b >> (8 - shift))) & 0xFF
        sbox[a] = r
    return bytes(sbox)


AES_SBOX = _build_sbox()

# ShiftRows as a gather over the 16 state bytes (column-major state).
SHIFT_ROWS = [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11]

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C]


def aes256_expand_key(key: bytes) -> list[bytes]:
    """Expand a 32-byte AES-256 key into 15 round keys of 16 bytes each."""
    if len(key) != 32:
        # api-edge: documented AES-256 key contract (reference parity)
        raise ValueError("AES-256 key must be 32 bytes")
    nk, nr = 8, 14
    w = [key[4 * i: 4 * i + 4] for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        temp = w[i - 1]
        if i % nk == 0:
            rot = temp[1:] + temp[:1]
            temp = bytes(AES_SBOX[b] for b in rot)
            temp = bytes([temp[0] ^ _RCON[i // nk - 1], temp[1], temp[2],
                          temp[3]])
        elif i % nk == 4:
            temp = bytes(AES_SBOX[b] for b in temp)
        w.append(bytes(a ^ b for a, b in zip(w[i - nk], temp)))
    return [b"".join(w[4 * r: 4 * r + 4]) for r in range(nr + 1)]


def _xtime(a: int) -> int:
    return ((a << 1) ^ (0x1B if a & 0x80 else 0)) & 0xFF


def aes256_encrypt_block(round_keys: Sequence[bytes], block: bytes) -> bytes:
    """Encrypt one 16-byte block with pre-expanded AES-256 round keys."""
    s = bytes(a ^ b for a, b in zip(block, round_keys[0]))
    for rnd in range(1, 14):
        s = bytes(AES_SBOX[b] for b in s)
        s = bytes(s[i] for i in SHIFT_ROWS)
        out = bytearray(16)
        for c in range(4):
            a0, a1, a2, a3 = s[4 * c: 4 * c + 4]
            out[4 * c + 0] = _xtime(a0) ^ _xtime(a1) ^ a1 ^ a2 ^ a3
            out[4 * c + 1] = a0 ^ _xtime(a1) ^ _xtime(a2) ^ a2 ^ a3
            out[4 * c + 2] = a0 ^ a1 ^ _xtime(a2) ^ _xtime(a3) ^ a3
            out[4 * c + 3] = _xtime(a0) ^ a0 ^ a1 ^ a2 ^ _xtime(a3)
        s = bytes(a ^ b for a, b in zip(out, round_keys[rnd]))
    s = bytes(AES_SBOX[b] for b in s)
    s = bytes(s[i] for i in SHIFT_ROWS)
    return bytes(a ^ b for a, b in zip(s, round_keys[14]))


def xor_bytes(*parts: bytes) -> bytes:
    """Byte-wise XOR of equal-length byte strings."""
    out = bytearray(parts[0])
    for p in parts[1:]:
        for i, b in enumerate(p):
            out[i] ^= b
    return bytes(out)


# ---------------------------------------------------------------------------
# Hirose PRG key-count contract.
# ---------------------------------------------------------------------------


class ReferenceContractWarning(UserWarning):
    """The requested shape is an extension the reference itself cannot run:
    ``32 <= lam < 144`` (the reference's key-count contract cannot cover
    cipher index 17) or fewer cipher keys than ``2*(lam/16)`` (only the used
    indices affect outputs, which are unchanged)."""


# Warnings skip package-internal frames so they point at the caller's line.
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_WARN_KWARGS = (
    {"skip_file_prefixes": (_PKG_DIR,)}
    if sys.version_info >= (3, 12) else {}
)


def hirose_used_cipher_indices(lam: int, num_keys: int,
                               warn: bool = True) -> list[int]:
    """Validate a Hirose PRG shape and return the cipher indices it uses:
    ``17*k for k < min(2, lam // 16)``.  Shapes the reference could not
    run warn with ``ReferenceContractWarning`` unless ``warn`` is False
    (internal constructions, such as the hybrid's narrow sub-walk of a
    larger shape, are not API edges)."""
    if lam % 16 != 0:
        # api-edge: documented Hirose lam contract (reference parity)
        raise ValueError("lam must be a multiple of 16 bytes")
    used = [17 * k for k in range(min(2, lam // 16))]
    if used and used[-1] >= num_keys:
        # api-edge: documented cipher-key-count contract (reference parity)
        raise ValueError(
            f"lam={lam} uses cipher indices {used}; got {num_keys} keys")
    if not warn:
        return used
    if 32 <= lam < 144:
        warnings.warn(
            f"lam={lam} is reference-inexecutable: its key-count contract "
            f"2*(lam/16)={2 * (lam // 16)} cannot cover cipher index 17; "
            "this framework runs it as an extension",
            ReferenceContractWarning, stacklevel=2, **_WARN_KWARGS)
    elif num_keys < 2 * (lam // 16):
        idx = "/".join(str(i) for i in used)
        warnings.warn(
            f"{num_keys} cipher keys relaxes the reference contract "
            f"N_KEYS=2*(lam/16)={2 * (lam // 16)}; only the used cipher "
            f"{'index' if len(used) == 1 else 'indices'} ({idx}) affect "
            "outputs, which are unchanged",
            ReferenceContractWarning, stacklevel=2, **_WARN_KWARGS)
    return used


# ---------------------------------------------------------------------------
# The Hirose PRG, with the reference's quirks.
# ---------------------------------------------------------------------------


class HirosePrgSpec:
    """Bit-exact model of the reference's ``Aes256HirosePrg<LAMBDA,
    N_KEYS>``.

    ``keys`` are the caller's 32-byte AES-256 keys.  Only ciphers ``0`` and
    (when ``lam >= 32``) ``17`` are ever used: the encryption loop
    ``(0..2).zip(0..lam/16)`` truncates to ``min(2, lam // 16)``
    iterations with ``i == j``.  Shapes the reference cannot run (``32 <=
    lam < 144``) are supported as an extension when ``keys`` covers index
    17 (``hirose_used_cipher_indices``).
    """

    def __init__(self, lam: int, keys: Sequence[bytes]):
        self.lam = lam
        used = hirose_used_cipher_indices(lam, len(keys))
        self.round_keys = {i: aes256_expand_key(keys[i]) for i in used}

    def gen(self, seed: bytes) -> list[tuple[bytes, bytes, bool]]:
        lam = self.lam
        assert len(seed) == lam
        seed_p = bytes(b ^ 0xFF for b in seed)  # seed ^ c, c = 0xff..
        buf0 = [bytearray(lam), bytearray(lam)]
        buf1 = [bytearray(lam), bytearray(lam)]
        # zip truncation: iterations (k, k) for k < min(2, lam/16); the
        # cipher index is i*16 + j = 17*k.
        for k in range(min(2, lam // 16)):
            rk = self.round_keys[17 * k]
            lo, hi = 16 * k, 16 * (k + 1)
            buf0[k][lo:hi] = aes256_encrypt_block(rk, seed[lo:hi])
            buf1[k][lo:hi] = aes256_encrypt_block(rk, seed_p[lo:hi])
        # Feed-forward into BOTH halves; never-encrypted halves become
        # literal copies of seed / seed_p.
        for k in range(2):
            buf0[k] = bytearray(a ^ b for a, b in zip(buf0[k], seed))
            buf1[k] = bytearray(a ^ b for a, b in zip(buf1[k], seed_p))
        # t bits from the two buffers of half 0, before masking.
        bit0 = bool(buf0[0][0] & 1)
        bit1 = bool(buf1[0][0] & 1)
        # Clear the LSB of the last byte of all four outputs.
        for buf in (buf0[0], buf0[1], buf1[0], buf1[1]):
            buf[lam - 1] &= 0xFE
        return [
            (bytes(buf0[0]), bytes(buf1[0]), bit0),
            (bytes(buf0[1]), bytes(buf1[1]), bit1),
        ]


# ---------------------------------------------------------------------------
# DCF gen / eval.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CmpFn:
    """Comparison function description: ``alpha`` and ``beta`` bytes."""

    alpha: bytes
    beta: bytes


@dataclass(frozen=True)
class Cw:
    """One level's correction word."""

    s: bytes
    v: bytes
    tl: bool
    tr: bool

    def __repr__(self) -> str:
        """Redacted: the s/v bytes are key material."""
        return (f"Cw(lam={len(self.s)}, tl={self.tl}, tr={self.tr}, "
                "<s/v bytes redacted>)")


@dataclass(frozen=True)
class Share:
    """One DCF key.

    ``s0s`` has length 2 out of ``gen`` and length 1 as input to ``eval``
    (only ``s0s[0]`` is read).  ``cws`` / ``cw_np1`` are the same for both
    parties; only the starting seed differs.
    """

    s0s: tuple[bytes, ...]
    cws: tuple[Cw, ...]
    cw_np1: bytes

    def __repr__(self) -> str:
        """Redacted: geometry only; the fields are the key material."""
        lam = len(self.cw_np1)
        return (f"Share(parties={len(self.s0s)}, n_bits={len(self.cws)}, "
                f"lam={lam}, <key-material bytes redacted>)")

    def for_party(self, b: int) -> "Share":
        return Share(s0s=(self.s0s[b],), cws=self.cws, cw_np1=self.cw_np1)


def _bit_msb(data: bytes, i: int) -> bool:
    """Bit i of ``data`` in MSB-first order."""
    return bool((data[i // 8] >> (7 - i % 8)) & 1)


def gen(
    prg: HirosePrgSpec,
    f: CmpFn,
    s0s: Sequence[bytes],
    bound: Bound,
    group: str = "xor",
) -> Share:
    """GGM-tree key generation.

    ``group`` selects the output group.  The tree walk (seeds, t bits) is
    the same for every group; only the value correction words change.
    For the additive groups the algebra is Boyle et al. EUROCRYPT 2021
    Fig. 1: the correction words carry the party sign ``(-1)^{t1}`` of
    party 1's previous control bit (party 0 starts at t = 0, party 1 at
    t = 1), and the XOR group is the characteristic-2 degeneration of the
    same formulas (``-x = x``, the signs vanish), so one code path serves
    both.
    """
    n_bytes, lam = len(f.alpha), len(f.beta)
    check_group(group, lam)
    n = 8 * n_bytes
    zero = bytes(lam)
    v_alpha = zero
    ss = [(bytes(s0s[0]), bytes(s0s[1]))]
    ts = [(False, True)]
    cws: list[Cw] = []
    for i in range(1, n + 1):
        (s0l, v0l, t0l), (s0r, v0r, t0r) = prg.gen(ss[i - 1][0])
        (s1l, v1l, t1l), (s1r, v1r, t1r) = prg.gen(ss[i - 1][1])
        alpha_i = _bit_msb(f.alpha, i - 1)
        keep, lose = (1, 0) if alpha_i else (0, 1)  # 0 = L, 1 = R
        sign1 = ts[i - 1][1]  # party 1's t on the alpha path: (-1)^{t1}
        s_cw = xor_bytes([s0l, s0r][lose], [s1l, s1r][lose])
        # V_CW <- (-1)^{t1} * [Convert(v1_lose) - Convert(v0_lose) - V_alpha
        #                      (+ beta on the bound-matching lose side)]
        v_cw = group_sub(
            group_sub([v1l, v1r][lose], [v0l, v0r][lose], group),
            v_alpha, group)
        if bound is Bound.LT_BETA:
            if lose == 0:
                v_cw = group_add(v_cw, f.beta, group)
        else:
            if lose == 1:
                v_cw = group_add(v_cw, f.beta, group)
        if sign1:
            v_cw = group_neg(v_cw, group)
        # V_alpha <- V_alpha - Convert(v1_keep) + Convert(v0_keep)
        #            + (-1)^{t1} * V_CW
        v_alpha = group_add(
            group_sub(v_alpha, [v1l, v1r][keep], group),
            group_add([v0l, v0r][keep],
                      group_neg(v_cw, group) if sign1 else v_cw, group),
            group)
        tl_cw = t0l ^ t1l ^ alpha_i ^ True
        tr_cw = t0r ^ t1r ^ alpha_i
        cws.append(Cw(s=s_cw, v=v_cw, tl=tl_cw, tr=tr_cw))
        ss.append(
            (
                xor_bytes([s0l, s0r][keep], s_cw if ts[i - 1][0] else zero),
                xor_bytes([s1l, s1r][keep], s_cw if ts[i - 1][1] else zero),
            )
        )
        ts.append(
            (
                [t0l, t0r][keep] ^ (ts[i - 1][0] & [tl_cw, tr_cw][keep]),
                [t1l, t1r][keep] ^ (ts[i - 1][1] & [tl_cw, tr_cw][keep]),
            )
        )
    # CW_{n+1} <- (-1)^{t1_n} * [Convert(s1_n) - Convert(s0_n) - V_alpha]
    cw_np1 = group_sub(group_sub(ss[n][1], ss[n][0], group), v_alpha, group)
    if ts[n][1]:
        cw_np1 = group_neg(cw_np1, group)
    return Share(s0s=(bytes(s0s[0]), bytes(s0s[1])), cws=tuple(cws),
                 cw_np1=cw_np1)


def eval_point(
    prg: HirosePrgSpec, b: bool, k: Share, x: bytes, group: str = "xor"
) -> bytes:
    """Party ``b``'s output-group share at one point.

    For the additive groups the share carries the party sign ``(-1)^b``
    (Boyle et al. Fig. 1), so reconstruction is always
    ``group_add(y0, y1, group)``; for XOR the sign is the identity and
    this is ``y0 ^ y1``.
    """
    n = len(k.cws)
    lam = len(k.cw_np1)
    assert n == 8 * len(x)
    check_group(group, lam)
    zero = bytes(lam)
    s = k.s0s[0]
    t = bool(b)
    v = zero
    for i in range(1, n + 1):
        cw = k.cws[i - 1]
        (sl, vl_hat, tl), (sr, vr_hat, tr) = prg.gen(s)
        if t:
            sl = xor_bytes(sl, cw.s)
            sr = xor_bytes(sr, cw.s)
        tl ^= t & cw.tl
        tr ^= t & cw.tr
        # V <- V + (-1)^b * [Convert(v_hat_chosen) + t * V_CW]
        if _bit_msb(x, i - 1):
            inc = group_add(vr_hat, cw.v if t else zero, group)
            s_next, t_next = sr, tr
        else:
            inc = group_add(vl_hat, cw.v if t else zero, group)
            s_next, t_next = sl, tl
        if b:
            inc = group_neg(inc, group)
        v = group_add(v, inc, group)
        s, t = s_next, t_next
    inc = group_add(s, k.cw_np1 if t else zero, group)
    if b:
        inc = group_neg(inc, group)
    return group_add(v, inc, group)


def eval_batch(
    prg: HirosePrgSpec, b: bool, k: Share, xs: Sequence[bytes],
    group: str = "xor",
) -> list[bytes]:
    """Batch evaluation: a pure map of ``eval_point`` over the points."""
    return [eval_point(prg, b, k, x, group) for x in xs]
