"""BASELINE.json config 3 as runnable functions: full-domain evaluation at
n bits with the two-party XOR reconstruction verified against the plain
comparison function, point by point.

Counterpart of ``dcf_tpu/workloads/core.py`` (its lines 36-110).  This is
the n * 2^n path, every point walked from the root; the tree evaluator
(``backends.fulldomain.TreeFullDomain``) does the same check in about
2^(n+1) PRG calls.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dcf_tpu_torch.errors import ShapeError

__all__ = ["domain_points", "full_domain_check", "full_domain_check_device"]


def domain_points(n_bytes: int, start: int, count: int) -> np.ndarray:
    """Points start..start+count-1 as big-endian uint8 [count, n_bytes]."""
    idx = np.arange(start, start + count, dtype=np.uint64)
    shifts = (8 * np.arange(n_bytes - 1, -1, -1)).astype(np.uint64)
    return ((idx[:, None] >> shifts) & np.uint64(0xFF)).astype(np.uint8)


def full_domain_check(
    eval0: Callable[[np.ndarray], np.ndarray],
    eval1: Callable[[np.ndarray], np.ndarray],
    alpha: int,
    beta: bytes,
    n_bits: int,
    gt: bool = False,
    chunk: int = 1 << 18,
) -> int:
    """Evaluate both parties over the whole 2^n_bits domain in chunks and
    verify that the XOR reconstruction equals the comparison function
    everywhere.

    eval_b(xs uint8 [M, n_bytes]) -> uint8 [1, M, lam] (or [K, M, lam]; key
    0 is checked).  Returns the number of mismatching points (0 = pass).
    """
    n_bytes = n_bits // 8
    beta_arr = np.frombuffer(beta, dtype=np.uint8)
    zero = np.zeros(len(beta), dtype=np.uint8)
    total = 1 << n_bits
    mismatches = 0
    for start in range(0, total, chunk):
        count = min(chunk, total - start)
        xs = domain_points(n_bytes, start, count)
        recon = (eval0(xs)[0] ^ eval1(xs)[0]).astype(np.uint8)  # [count, lam]
        idx = np.arange(start, start + count)
        inside = (idx > alpha) if gt else (idx < alpha)
        expect = np.where(inside[:, None], beta_arr[None, :], zero[None, :])
        mismatches += int(np.count_nonzero(np.any(recon != expect, axis=1)))
    return mismatches


def full_domain_check_device(
    backend0,
    backend1,
    alpha: int,
    beta: bytes,
    n_bits: int,
    gt: bool = False,
    chunk: int = 1 << 20,
) -> int:
    """Config 3 on the staged-backend protocol, resident on the device.

    Neither the 2^n_bits points nor the 2 x 2^n_bits x lam shares touch
    the host: each chunk's points are made on the device
    (``stage_range``), both parties evaluate there, and the XOR
    reconstruction is compared there against the plain comparison
    function (``mismatch_count``); only the sum of the per-chunk counters
    is fetched.  backend0/backend1: ``WalkBackend``s holding the two
    party bundles of one key.  Returns the number of mismatching points
    (0 = pass).
    """
    total = 1 << n_bits
    chunk = min(chunk, total)
    if total % chunk != 0:
        raise ShapeError(f"chunk {chunk} must divide the domain {total}")
    counters = []
    for start in range(0, total, chunk):
        staged = backend0.stage_range(start, chunk)
        y0 = backend0.eval_staged(0, staged)
        y1 = backend1.eval_staged(1, staged)
        counters.append(
            backend0.mismatch_count(y0, y1, alpha, beta, start, gt))
    return int(torch.stack(counters).sum())
