"""Shared batch-shape validation/padding and device selection for the
port's backends.

Counterpart of ``dcf_tpu/backends/_common.py``.  Every backend accepts xs
as uint8 [M, n_bytes] (points shared by all keys) or [K, M, n_bytes]
(per-key points) and returns uint8 [K, M, lam]; the checks and the
pad-and-promote step are identical across backends and live here.
"""

from __future__ import annotations

import numpy as np
import torch

from dcf_tpu_torch.errors import BackendUnavailableError, ShapeError

__all__ = ["validate_xs", "pad_xs", "prepare_batch", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  ``None`` means ``cuda``; a CUDA request on a host
    without CUDA raises instead of running somewhere else."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BackendUnavailableError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    return dev


def validate_xs(xs: np.ndarray, k_num: int, n_bits: int) -> tuple[bool, int]:
    """Check xs against the on-device bundle; returns (shared, num_points)."""
    if xs.ndim not in (2, 3):
        raise ShapeError(f"xs must be 2D or 3D, got {xs.ndim}D")
    shared = xs.ndim == 2
    m = xs.shape[0] if shared else xs.shape[1]
    if xs.shape[-1] * 8 != n_bits:
        raise ShapeError("xs width mismatch with bundle")
    if not shared and xs.shape[0] != k_num:
        raise ShapeError(
            f"xs has {xs.shape[0]} key rows but bundle has {k_num} keys"
        )
    return shared, m


def pad_xs(xs: np.ndarray, shared: bool, m: int, m_pad: int) -> np.ndarray:
    """Zero-pad the point axis to m_pad and promote shared xs to [1, M, nb]."""
    if m_pad != m:
        pad = ([(0, m_pad - m), (0, 0)] if shared
               else [(0, 0), (0, m_pad - m), (0, 0)])
        xs = np.pad(xs, pad)
    return xs[None] if shared else xs


def prepare_batch(dims: tuple[int, int], xs: np.ndarray,
                  m_pad_of) -> tuple[np.ndarray, bool, int]:
    """The stage/eval preamble the backends share: shape validation
    against the bundle dims (k_num, n_bits), point padding
    (``m_pad_of(m)`` -> padded point count), contiguity.  Returns
    (xs_padded [Kx, M_pad, nb], shared, m)."""
    k_num, n_bits = dims
    shared, m = validate_xs(xs, k_num, n_bits)
    xs = pad_xs(xs, shared, m, m_pad_of(m))
    return np.ascontiguousarray(xs), shared, m
