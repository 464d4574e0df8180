"""Kernels B5a and B5b, the prefix-shared narrow walk of the large-lambda
hybrid, and their plain versions.

Counterpart of ``dcf_tpu/ops/pallas_hybrid_prefix.py``
(``narrow_state_walk_pallas``, ``dcf_hybrid_prefix_pallas``) together with
the gathers of ``dcf_tpu/backends/large_lambda.py``
(``hybrid_prefix_gather_walk``, ``_traj_words``).  A batch of shared points
repeats the top k levels of the narrow walk; those are walked once per
(key, party) for all 2^k node prefixes (B5a), and each point then gathers
its carry and walks only levels k..n-1 (B5b).

Frontier: ``rows`` uint8 [K * 2^k, 64], key j's nodes at [j*2^k,
(j+1)*2^k) in frontier-index order (walk bit i of node r is bit i of r,
the order of ``ops.prefix_eval.frontier_index_plain``); a row is the
32-byte s, then the 32-byte v.  ``words`` uint8 [K * 2^k, 4], one little-
endian uint32 per node: the gate bits of levels 0..k-1, and the depth-k
carry t at bit k.  The narrow walk is unmasked, so no bit of s is free to
carry t as the lam = 16 frontier does; the wide tail needs the top-k gates
anyway, so t rides with them.

The order makes the build natural level by level, in place: node p at
depth i has its children at p (walk bit i = 0) and p + 2^i (bit i = 1),
so depth i's nodes are rows [0, 2^i) of a key's range.  Kernel B5a
(``narrow_frontier``, ``csrc/hybrid_state.cu``) expands each parent once,
into both children: the top ``TOP_LEVELS`` levels in one launch, a level
at a time, then launches of one or two levels, the second kept in
registers (``ops._launch.launch_depths`` with ``most=2`` cuts
them), all from one call of its entry point; B5b (``hybrid_prefix_eval``,
``csrc/hybrid_prefix.cu``) gathers inside the kernel.  Both launch their
kernels for tensors on the card and run their plain versions for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import (
    check_u8,
    key_slices,
    launch_checked,
    launch_depths,
)
from dcf_tpu_torch.ops.narrow_walk import (
    NARROW,
    check_narrow_image,
    narrow_finalize_plain,
    narrow_levels_plain,
    pack_traj_plain,
    traj_bytes,
    unpack_traj_plain,
)
from dcf_tpu_torch.ops.prefix_eval import frontier_index_plain
from dcf_tpu_torch.ops.walk_eval import walk_bits_plain

__all__ = ["node_prefix_xs", "frontier_launches", "narrow_frontier_plain",
           "narrow_frontier", "hybrid_prefix_eval_plain",
           "hybrid_prefix_eval"]

MAX_K = 30  # the gate bits and the carry t share one 32-bit word
# Kernel B5a: levels built by its top launch (up to 512 parents a key on
# the last, one a thread of a block), and levels a later launch expands.
TOP_LEVELS = 10
FUSED_LEVELS = 2


def node_prefix_xs(k: int, n_bytes: int) -> np.ndarray:
    """uint8 [2^k, n_bytes]: node r's MSB-first walk bit i is (r >> i) & 1
    for i < k, zero beyond -- the frontier-index enumeration, so the
    depth-k carry of "point" r is frontier row r (the port's copy of
    ``_node_prefix_xs`` in ``dcf_tpu/backends/large_lambda.py``; kernel
    B5a writes node r's children to rows r and r + 2^i)."""
    r = np.arange(1 << k, dtype=np.uint32)
    bits = np.zeros((1 << k, 8 * n_bytes), dtype=np.uint8)
    for i in range(k):
        bits[:, i] = (r >> np.uint32(i)) & np.uint32(1)
    return np.packbits(bits, axis=1)


def narrow_frontier_plain(aes, s0, cw_s, cw_v, cw_t, *, k: int, b: int):
    """Plain PyTorch version of kernel B5a (same arguments as
    ``narrow_frontier``)."""
    k_num = s0.shape[0]
    nodes = 1 << k
    s = s0[:, None, :].expand(k_num, nodes, NARROW)
    t = torch.full((k_num, nodes), int(b), dtype=torch.uint8,
                   device=s0.device)
    v = torch.zeros((k_num, nodes, NARROW), dtype=torch.uint8,
                    device=s0.device)
    s, t, v, gates = narrow_levels_plain(
        aes, s, t, v, cw_s[:, :k], cw_v[:, :k], cw_t[:, :k],
        walk_bits_plain(torch.from_numpy(
            node_prefix_xs(k, -(-k // 8))).to(s0.device))[None, :, :k])
    rows = torch.cat([s, v], -1).reshape(k_num * nodes, 2 * NARROW)
    words = pack_traj_plain(torch.cat([gates, t.unsqueeze(-1)], -1))
    return rows, words.reshape(k_num * nodes, 4)


_STATE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def frontier_launches(k: int) -> tuple[int, list[int]]:
    """Kernel B5a's launches for depth k: (the levels of the top launch,
    the depths of the launches after it)."""
    top = min(k, TOP_LEVELS)
    return top, [d for _, d in launch_depths(top, k, FUSED_LEVELS)] \
        if top < k else []


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= MAX_K or n < 8 or n % 8 or not k < n:
        raise ShapeError(f"bad hybrid prefix geometry: n={n}, k={k}")


def narrow_frontier(aes, s0, cw_s, cw_v, cw_t, *, k: int, b: int):
    """Party ``b``'s narrow frontier of K keys at depth k: (rows uint8
    [K * 2^k, 64], words uint8 [K * 2^k, 4]).

    aes uint8 [736]; s0 [K, 32]; cw_s/cw_v [K, n, 32], cw_t [K, n, 2]
    (all n levels; the build reads levels 0..k-1).  The card launches
    kernel B5a (``frontier_launches``), the CPU runs
    ``narrow_frontier_plain``."""
    device = s0.device
    k_num = s0.shape[0]
    n = cw_s.shape[1] if cw_s.dim() == 3 else -1
    _check_k(k, n)
    check_narrow_image(aes, s0, cw_s, cw_v, cw_t, device, k_num, n, align=16)
    if b not in (0, 1):
        raise ShapeError(f"party must be 0 or 1, got {b}")
    if device.type == "cpu":
        return narrow_frontier_plain(aes, s0, cw_s, cw_v, cw_t, k=k, b=b)
    if device.type != "cuda":
        raise ShapeError(f"narrow_frontier runs on cuda or cpu, not {device}")
    rows = torch.empty((k_num << k, 2 * NARROW), dtype=torch.uint8,
                       device=device)
    words = torch.empty((k_num << k, 4), dtype=torch.uint8, device=device)
    fn = _build.load("hybrid_state", "dcf_hybrid_state", _STATE_ARGTYPES)
    a = aes.data_ptr()
    top, depths = frontier_launches(k)
    launch_checked("hybrid_state", fn, device, a, a + 256, a + 496,
                   s0.data_ptr(), cw_s.data_ptr(), cw_v.data_ptr(),
                   cw_t.data_ptr(), rows.data_ptr(), words.data_ptr(), k_num,
                   n, k, top, (ctypes.c_int * max(1, len(depths)))(*depths),
                   len(depths), int(b))
    narrow_frontier.launches += 1 + len(depths)
    return rows, words


narrow_frontier.launches = 0  # kernel B5a launches in this process


def hybrid_prefix_eval_plain(aes, rows, words, cw_s, cw_v, cw_t, cw_np1, xs,
                             *, k: int, lam: int):
    """Plain PyTorch version of kernel B5b (same arguments as
    ``hybrid_prefix_eval``); bytes 32.. of y are zero."""
    k_num, n = cw_s.shape[:2]
    m = xs.shape[1]
    idx = frontier_index_plain(xs[0], k)
    row = rows.view(k_num, 1 << k, 2 * NARROW)[:, idx]  # [K, M, 64]
    top = unpack_traj_plain(words.view(k_num, 1 << k, 4)[:, idx], k + 1)
    s, t, v, gates = narrow_levels_plain(
        aes, row[..., :NARROW], top[..., k], row[..., NARROW:], cw_s[:, k:],
        cw_v[:, k:], cw_t[:, k:], walk_bits_plain(xs)[:, :, k:])
    y = torch.zeros((k_num, m, lam), dtype=torch.uint8, device=rows.device)
    y[..., :NARROW] = narrow_finalize_plain(s, t, v, cw_np1)
    traj = torch.cat([top[..., :k], gates, t.unsqueeze(-1)], -1)
    return y, pack_traj_plain(traj)


_EVAL_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def hybrid_prefix_eval(aes, rows, words, cw_s, cw_v, cw_t, cw_np1, xs, *,
                       k: int, lam: int):
    """Narrow walk of K keys at M shared points from their frontiers:
    (y uint8 [K, M, lam] with y[..., :32] written, trajectories uint8
    [K, M, traj_bytes(n + 1)]), as ``ops.narrow_walk.narrow_walk``.

    aes uint8 [736]; rows/words from ``narrow_frontier`` (keys stacked);
    cw_s/cw_v [K, n, 32], cw_t [K, n, 2], cw_np1 [K, 32] (all n levels; the
    walk reads levels k..n-1); xs [1, M, n/8].  The party is implicit in
    the frontier.  The card launches kernel B5b, the CPU runs
    ``hybrid_prefix_eval_plain``."""
    device = rows.device
    k_num = cw_s.shape[0]
    n = cw_s.shape[1] if cw_s.dim() == 3 else -1
    m = xs.shape[1]
    _check_k(k, n)
    check_u8("rows", rows, (k_num << k, 2 * NARROW), device, align=16)
    check_u8("words", words, (k_num << k, 4), device, align=4)
    check_u8("cw_s", cw_s, (k_num, n, NARROW), device)
    check_u8("cw_v", cw_v, (k_num, n, NARROW), device)
    check_u8("cw_t", cw_t, (k_num, n, 2), device)
    check_u8("cw_np1", cw_np1, (k_num, NARROW), device)
    check_u8("xs", xs, (1, m, n // 8), device)
    if lam < 48 or lam % 16:
        raise ShapeError(f"bad hybrid prefix output width: lam={lam}")
    if device.type == "cpu":
        return hybrid_prefix_eval_plain(aes, rows, words, cw_s, cw_v, cw_t,
                                        cw_np1, xs, k=k, lam=lam)
    if device.type != "cuda":
        raise ShapeError(
            f"hybrid_prefix_eval runs on cuda or cpu, not {device}")
    nt = traj_bytes(n + 1)
    y = torch.empty((k_num, m, lam), dtype=torch.uint8, device=device)
    traj = torch.empty((k_num, m, nt), dtype=torch.uint8, device=device)
    if m == 0:
        return y, traj
    fn = _build.load("hybrid_prefix", "dcf_hybrid_prefix", _EVAL_ARGTYPES)
    a = aes.data_ptr()
    for k0, kk in key_slices(k_num):
        launch_checked("hybrid_prefix", fn, device, a, a + 256, a + 496,
                       rows.data_ptr() + (k0 << k) * 2 * NARROW,
                       words.data_ptr() + (k0 << k) * 4,
                       cw_s.data_ptr() + k0 * n * NARROW,
                       cw_v.data_ptr() + k0 * n * NARROW,
                       cw_t.data_ptr() + k0 * n * 2,
                       cw_np1.data_ptr() + k0 * NARROW, xs.data_ptr(),
                       y.data_ptr() + k0 * m * lam,
                       traj.data_ptr() + k0 * m * nt, kk, n, k, m, lam,
                       nt // 4)
        hybrid_prefix_eval.launches += 1
    return y, traj


hybrid_prefix_eval.launches = 0  # kernel B5b launches in this process
