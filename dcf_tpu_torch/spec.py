"""Scheme constants of the DCF: bounds, output groups, AES tables, the
Hirose key-count contract.

Counterpart of a subset of ``dcf_tpu/spec.py``: ``Bound``, the output
group tables and ``check_group`` (its lines 81-98),
``ReferenceContractWarning`` and ``hirose_used_cipher_indices``
(:241-318), the AES S-box, ``SHIFT_ROWS`` and the AES-256 key schedule.
The pure-Python golden model (``gen``, ``eval_point``) is not part of
this package yet.

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
from enum import Enum

__all__ = [
    "AES_SBOX",
    "GROUPS",
    "GROUP_CODE",
    "GROUP_FROM_CODE",
    "GROUP_WIDTH",
    "SHIFT_ROWS",
    "Bound",
    "ReferenceContractWarning",
    "aes256_expand_key",
    "check_group",
    "hirose_used_cipher_indices",
]

GROUPS = ("xor", "add8", "add16", "add32")
GROUP_CODE = {"xor": 0, "add8": 1, "add16": 2, "add32": 3}
GROUP_FROM_CODE = {code: name for name, code in GROUP_CODE.items()}
GROUP_WIDTH = {"add8": 8, "add16": 16, "add32": 32}  # lane width, bits


def check_group(group: str, lam: int) -> None:
    """Validate a group name against a payload width (API edge)."""
    if group not in GROUP_CODE:
        raise ValueError(
            f"unknown output group {group!r}; expected one of {GROUPS}")
    if group != "xor" and (8 * lam) % GROUP_WIDTH[group] != 0:
        raise ValueError(
            f"group {group!r} needs lam*8={8 * lam} divisible by "
            f"{GROUP_WIDTH[group]}")


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
        raise ValueError("lam must be a multiple of 16 bytes")
    used = [17 * k for k in range(min(2, lam // 16))]
    if used and used[-1] >= num_keys:
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
