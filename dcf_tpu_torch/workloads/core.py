"""Reference workloads (BASELINE.json configs 3 and 5) as runnable
functions.  Counterpart of ``dcf_tpu/workloads/core.py``.

- ``domain_points`` / ``full_domain_check`` / ``full_domain_check_device``
  -- config 3: full-domain evaluation at n bits with the two-party XOR
  reconstruction verified against the plain comparison function, point by
  point (the n * 2^n path; ``backends.fulldomain.TreeFullDomain`` does the
  same check in about 2^(n+1) PRG calls).
- ``secure_relu_check_device`` / ``secure_relu_eval`` -- config 5: many
  keys x few shared points (10^6 keys x 1024 points at lam = 16).  In
  FSS-based secure inference a ReLU gate costs one DCF evaluation per
  wire and input, so the workload is a large batch of independent DCF
  evaluations.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.keys import KeyBundle

__all__ = ["domain_points", "full_domain_check", "full_domain_check_device",
           "secure_relu_check_device", "secure_relu_eval"]

# Share bytes of one party and key chunk that secure_relu_check_device
# holds on the device: 2^17 keys at 1024 points of 16 bytes.
RELU_CHUNK_BYTES = 1 << 31


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


def secure_relu_check_device(
    lam: int,
    cipher_keys,
    alphas: np.ndarray,
    betas: np.ndarray,
    s0s: np.ndarray,
    xs: np.ndarray,
    key_chunk: int | None = None,
    device=None,
    on_chunk: Callable | None = None,
) -> int:
    """Config 5 on the device from end to end: keygen, both parties'
    evaluation and the check, streamed over key chunks.

    Per chunk, kernel G1 (``backends.device_gen.DeviceKeyGen``) writes the
    key image on the device from the chunk's alphas uint8 [K, n_bytes],
    betas uint8 [K, 16] and root seeds uint8 [K, 2, 16] (bound LT_BETA),
    kernel B8 (``backends.keylanes_backend.KeyLanesBackend``) evaluates
    both parties at the shared points xs uint8 [M, n_bytes], and the XOR
    reconstruction is compared on the device with ``beta_k if x_m <
    alpha_k else 0``.  The per-chunk counts are summed on the device and
    fetched once.  ``key_chunk`` defaults to the keys whose shares of one
    party fill ``RELU_CHUNK_BYTES`` (2^17 at 1024 points).  ``on_chunk``,
    if given, is called after each chunk's count as ``on_chunk(lo, hi, y0,
    y1, backend)`` with both parties' device shares of keys lo..hi-1 and
    the backend holding their image (for callers that audit the shares).
    Returns the number of mismatching (key, point) pairs (0 = pass)."""
    from dcf_tpu_torch.backends.device_gen import DeviceKeyGen
    from dcf_tpu_torch.backends.keylanes_backend import KeyLanesBackend
    from dcf_tpu_torch.spec import Bound

    k = alphas.shape[0]
    if key_chunk is None:
        key_chunk = max(1, RELU_CHUNK_BYTES // max(1, xs.shape[0] * lam))
    gen = DeviceKeyGen(lam, cipher_keys, device=device)
    be = KeyLanesBackend(lam, cipher_keys, device=device)
    counters = []
    staged = None
    for lo in range(0, k, key_chunk):
        hi = min(k, lo + key_chunk)
        be.put_bundle_device(gen.gen(alphas[lo:hi], betas[lo:hi],
                                     s0s[lo:hi], Bound.LT_BETA))
        if staged is None:
            staged = be.stage(xs)
        y0 = be.eval_staged(0, staged)
        y1 = be.eval_staged(1, staged)
        counters.append(be.relu_mismatch_count(y0, y1, alphas[lo:hi],
                                               betas[lo:hi], staged))
        if on_chunk is not None:
            on_chunk(lo, hi, y0, y1, be)
        del y0, y1
    return int(torch.stack(counters).sum())


def secure_relu_eval(
    backend0,
    backend1,
    bundle: KeyBundle,
    xs: np.ndarray,
    key_chunk: int = 1 << 16,
) -> np.ndarray:
    """Config 5 on the host edge: evaluate K keys at M shared points, both
    parties, and return the reconstruction uint8 [K, M, lam], streaming
    over keys.  A thin client of
    ``protocols.combine.xor_reconstruct_stream``; backend0 / backend1 are
    evaluators with ``eval(b, xs, bundle=party_bundle)``."""
    from dcf_tpu_torch.protocols.combine import xor_reconstruct_stream

    return xor_reconstruct_stream(backend0, backend1, bundle, xs,
                                  key_chunk=key_chunk)
