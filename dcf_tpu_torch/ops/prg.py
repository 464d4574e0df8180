"""Batched Hirose PRG over numpy uint8 arrays (host).

Counterpart of ``dcf_tpu/ops/prg.py``: bit-exact with the reference's
``Aes256HirosePrg``, vectorized over an arbitrary leading batch shape.
One ``gen`` call expands a batch of seeds into left/right child
``(s, v, t)`` triples.  The zip quirk is kept: only block positions
``k < min(2, lam/16)`` with cipher index ``17*k`` encrypt, every other
half is a feed-forward copy of the seed (or its complement).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from dcf_tpu_torch.ops.aes import aes256_encrypt_np, expand_key_np
from dcf_tpu_torch.spec import hirose_used_cipher_indices

__all__ = ["PrgOut", "HirosePrgNp"]


@dataclass(frozen=True)
class PrgOut:
    """PRG expansion of a seed batch [..., lam]: s/v are uint8 [..., lam],
    t is uint8 [...] with values in {0, 1}."""

    s_l: np.ndarray
    v_l: np.ndarray
    t_l: np.ndarray
    s_r: np.ndarray
    v_r: np.ndarray
    t_r: np.ndarray


class HirosePrgNp:
    """Numpy Hirose PRG over ``keys`` (the same key-count contract as the
    reference: cipher indices 0 and, for lam >= 32, 17 must exist).

    ``mask=False`` skips the final clearing of bit 8*lam-1: the large-lambda
    hybrid's narrow 32-byte walk replicates the first two blocks of a
    bigger PRG whose masked byte lies in its wide part
    (``backends.large_lambda``).  ``warn=False`` marks such internal
    constructions, which are not API edges."""

    def __init__(self, lam: int, keys: Sequence[bytes], mask: bool = True,
                 warn: bool = True):
        self.lam = lam
        self.mask = mask
        used = hirose_used_cipher_indices(lam, len(keys), warn=warn)
        self.round_keys = {i: expand_key_np(keys[i]) for i in used}

    def gen(self, seeds: np.ndarray) -> PrgOut:
        lam = self.lam
        if seeds.dtype != np.uint8 or seeds.shape[-1] != lam:
            raise ValueError(f"seeds must be uint8 [..., {lam}]")
        seed_p = seeds ^ np.uint8(0xFF)
        batch = seeds.shape[:-1]
        buf0 = np.zeros((*batch, 2, lam), dtype=np.uint8)
        buf1 = np.zeros((*batch, 2, lam), dtype=np.uint8)
        # Truncated encryption loop: only block positions k < min(2, lam/16)
        # with cipher index 17*k are encrypted.
        for k in range(min(2, lam // 16)):
            rk = self.round_keys[17 * k]
            lo, hi = 16 * k, 16 * (k + 1)
            buf0[..., k, lo:hi] = aes256_encrypt_np(rk, seeds[..., lo:hi])
            buf1[..., k, lo:hi] = aes256_encrypt_np(rk, seed_p[..., lo:hi])
        # Feed-forward into both halves.
        buf0 ^= seeds[..., None, :]
        buf1 ^= seed_p[..., None, :]
        # t-bits from the half-0 buffers, before masking.
        t_l = buf0[..., 0, 0] & np.uint8(1)
        t_r = buf1[..., 0, 0] & np.uint8(1)
        # Clear the LSB of the last byte of all four outputs.
        if self.mask:
            buf0[..., lam - 1] &= np.uint8(0xFE)
            buf1[..., lam - 1] &= np.uint8(0xFE)
        return PrgOut(
            s_l=buf0[..., 0, :],
            v_l=buf1[..., 0, :],
            t_l=t_l,
            s_r=buf0[..., 1, :],
            v_r=buf1[..., 1, :],
            t_r=t_r,
        )
