"""Vectorized AES-256 (encrypt-only) over numpy uint8 batches.

Counterpart of ``dcf_tpu/ops/aes.py``: the host AES behind the numpy
keygen walk and the numpy eval oracle, and the source of the round keys
and S-box that the CUDA kernels and their plain versions take.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.spec import AES_SBOX, SHIFT_ROWS, aes256_expand_key

__all__ = ["SBOX_NP", "SHIFT_ROWS_NP", "expand_key_np", "aes256_encrypt_np"]

SBOX_NP = np.frombuffer(AES_SBOX, dtype=np.uint8).copy()
SHIFT_ROWS_NP = np.array(SHIFT_ROWS, dtype=np.int64)


def expand_key_np(key: bytes) -> np.ndarray:
    """32-byte key -> round keys as a uint8 array of shape [15, 16]."""
    return np.array(
        [np.frombuffer(rk, dtype=np.uint8) for rk in aes256_expand_key(key)]
    )


def _xtime(a: np.ndarray) -> np.ndarray:
    """GF(2^8) multiply-by-2 on uint8 arrays."""
    return (((a.astype(np.uint16) << 1) ^ np.where(a & 0x80, 0x1B, 0))
            & 0xFF).astype(np.uint8)


def aes256_encrypt_np(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Encrypt a batch of 16-byte blocks.

    round_keys: uint8 [15, 16]; blocks: uint8 [..., 16] -> uint8 [..., 16].
    """
    s = blocks ^ round_keys[0]
    for rnd in range(1, 14):
        s = SBOX_NP[s]
        s = s[..., SHIFT_ROWS_NP]
        a = s.reshape(*s.shape[:-1], 4, 4)
        a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        mixed = np.stack(
            [
                _xtime(a0) ^ _xtime(a1) ^ a1 ^ a2 ^ a3,
                a0 ^ _xtime(a1) ^ _xtime(a2) ^ a2 ^ a3,
                a0 ^ a1 ^ _xtime(a2) ^ _xtime(a3) ^ a3,
                _xtime(a0) ^ a0 ^ a1 ^ a2 ^ _xtime(a3),
            ],
            axis=-1,
        )
        s = mixed.reshape(*blocks.shape) ^ round_keys[rnd]
    s = SBOX_NP[s]
    s = s[..., SHIFT_ROWS_NP]
    return s ^ round_keys[14]
