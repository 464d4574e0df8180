"""Shared batch-shape validation/padding, device selection, the
two-party verifier and the full-domain evaluators' ship-once cache of the
port's backends.

Counterpart of ``dcf_tpu/backends/_common.py``.  Every backend accepts xs
as uint8 [M, n_bytes] (points shared by all keys) or [K, M, n_bytes]
(per-key points) and returns uint8 [K, M, lam]; the checks, the
pad-and-promote step and the on-device mismatch count are identical
across backends and live here.
"""

from __future__ import annotations

import numpy as np
import torch

from dcf_tpu_torch.errors import BackendUnavailableError, ShapeError
from dcf_tpu_torch.ops.walk_eval import group_add_plain
from dcf_tpu_torch.utils.groups import group_width

__all__ = ["validate_xs", "pad_xs", "prepare_batch", "resolve_device",
           "points_mismatch_count", "xor_mismatch_count", "to_device",
           "bitrev_values", "StagedFrontierCache"]


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


def _lex_inside(xs: torch.Tensor, alphas: torch.Tensor,
                gt: bool) -> torch.Tensor:
    """bool [K, M]: x < alpha (x > alpha for gt), unsigned big-endian.
    xs uint8 [1 or K, M, nb]; alphas uint8 [K, nb]."""
    inside = torch.zeros(alphas.shape[0], xs.shape[1], dtype=torch.bool,
                         device=xs.device)
    eq = torch.ones_like(inside)
    for j in range(xs.shape[-1]):
        xj = xs[:, :, j]
        aj = alphas[:, j, None]
        inside |= eq & ((xj > aj) if gt else (xj < aj))
        eq &= xj == aj
    return inside


def points_mismatch_count(y0: torch.Tensor, y1: torch.Tensor, alpha, beta,
                          xs: torch.Tensor, lam: int, group: str,
                          gt: bool = False) -> torch.Tensor:
    """Two-party check on the device: the number of (key, point) pairs,
    pad points included, whose reconstruction differs from ``beta if
    x < alpha else 0`` (``>`` for gt).  y0/y1 are both parties' shares
    uint8 [K, M_pad, lam] over the same staged points xs uint8 [1 or K,
    M_pad, nb]; the reconstruction is the group add (XOR or lane-wise).

    Single key: alpha/beta as bytes.  Multi-key: uint8 arrays [K, n_bytes]
    / [K, lam].  Returns a device int64 scalar."""
    k_num = y0.shape[0]
    if isinstance(alpha, (bytes, bytearray)):
        if k_num != 1:
            raise ShapeError(
                "bytes alpha/beta is the single-key form; pass "
                "[K, n_bytes]/[K, lam] arrays for multi-key bundles")
        alphas = np.frombuffer(bytes(alpha), dtype=np.uint8)[None]
        betas = np.frombuffer(bytes(beta), dtype=np.uint8)[None]
    else:
        alphas = np.asarray(alpha, dtype=np.uint8)
        betas = np.asarray(beta, dtype=np.uint8)
    if alphas.shape != (k_num, xs.shape[-1]) or betas.shape != (k_num, lam):
        raise ShapeError(
            f"alphas {alphas.shape} / betas {betas.shape} do not fit "
            f"{k_num}-key outputs over {xs.shape[-1]}-byte points")
    a = torch.tensor(alphas, device=xs.device)
    bt = torch.tensor(betas, device=xs.device)
    inside = _lex_inside(xs, a, gt)
    expect = torch.where(inside[..., None], bt[:, None, :],
                         torch.zeros_like(bt[:, None, :]))
    recon = group_add_plain(y0, y1, group_width(group))
    return (recon != expect).any(-1).sum()


def xor_mismatch_count(y0: torch.Tensor, y1: torch.Tensor,
                       inside: torch.Tensor, beta: bytes) -> torch.Tensor:
    """The full-domain verifiers' count: the rows of y0 ^ y1 (uint8
    [M, lam], lam a multiple of 8: 16 or 32 on the per-point walk) that
    differ from ``beta`` where ``inside`` (bool [M]) holds and from zero
    elsewhere.  A device int64 scalar."""
    recon = (y0 ^ y1).view(torch.int64)  # [M, lam / 8]
    want = torch.from_numpy(np.frombuffer(beta, dtype=np.uint8).copy()).to(
        y0.device).view(torch.int64)
    bad = torch.where(inside, (recon != want).any(-1), (recon != 0).any(-1))
    return bad.sum()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a contiguous tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def bitrev_values(n_bits: int, device) -> torch.Tensor:
    """int64 [2^n_bits]: the domain value of each leaf position,
    value[p] = bitreverse_n(p), computed on ``device``."""
    pos = torch.arange(1 << n_bits, dtype=torch.int64, device=device)
    value = torch.zeros_like(pos)
    for k in range(n_bits):
        value |= ((pos >> k) & 1) << (n_bits - 1 - k)
    return value


class StagedFrontierCache:
    """The ship-once cache of the full-domain evaluators
    (``fulldomain.TreeFullDomain``, ``evalall.DpfEvalAll``): the staged
    correction words and both parties' host-expanded frontiers of the
    bundle last evaluated, keyed on the caller's object by identity (the
    entry retains it, so a freed bundle's reused address cannot hit) and
    on the depth.

    Subclass contract: set ``host_levels``, provide ``_stage_cw(bundle)``
    (the party-independent CW image on the device) and
    ``_frontier(bundle_b, b, k0)`` (party b's level-k0 nodes on the
    device)."""

    host_levels: int
    _cache = None  # (bundle, n_bits, staged_cw, fronts, parts)

    def _k0(self, n_bits: int) -> int:
        """Levels expanded on the host: the last one always runs on the
        device."""
        return min(self.host_levels, n_bits - 1)

    def invalidate(self) -> None:
        """Drop the staged image (the serving layer's retry-then-evict
        rule: a faulted evaluation must not hand its device residency to
        the retry)."""
        self._cache = None

    def _staged_for(self, bundle, n_bits: int):
        """``(staged_cw, fronts, parts)`` of the two-party ``bundle``:
        shipped once and reused while the caller keeps evaluating the
        same bundle object at the same depth."""
        c = self._cache
        if c is not None and c[0] is bundle and c[1] == n_bits:
            return c[2], c[3], c[4]
        k0 = self._k0(n_bits)
        staged_cw = self._stage_cw(bundle)
        parts = {b: bundle.for_party(b) for b in (0, 1)}
        fronts = {b: self._frontier(parts[b], b, k0) for b in (0, 1)}
        self._cache = (bundle, n_bits, staged_cw, fronts, parts)
        return staged_cw, fronts, parts
