"""Kernel B3, DCF evaluation from a prefix frontier at lam = 16, and its
plain version.

Counterpart of ``dcf_tpu/ops/pallas_prefix.py`` (``dcf_eval_prefix_pallas``)
together with the row gather of ``dcf_tpu/backends/pallas_prefix.py``
(``gather_and_walk``, ``_stage_prefix_idx``).  A batch of random points
shares the top k levels of the GGM walk; those are expanded once per key
and party as a frontier table (kernel B2), and each point gathers its
(s, v, t) carry from the table and walks only the remaining n - k levels.

Frontier table: uint8 [K * 2^k, 32], key j's 2^k rows at [j*2^k,
(j+1)*2^k) in bitreverse order.  A row is s (16 bytes) with t stashed in
bit 0 of byte 15, then v (16 bytes).  That bit is the Hirose PRG's
masked output bit, so it is zero in every seed below the root, and the
stash costs no extra load (``frontier_table`` checks the invariant).

``prefix_eval`` launches the CUDA kernel (``csrc/prefix_eval.cu``, which
gathers inside the kernel) for tensors on the card, and runs
``prefix_eval_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import DcfError, ShapeError
from dcf_tpu_torch.ops._launch import check_u8, key_slices, launch_checked
from dcf_tpu_torch.ops.walk_eval import (
    AES_IMAGE_BYTES,
    finalize_plain,
    walk_bits_plain,
    walk_levels_plain,
)
from dcf_tpu_torch.utils.groups import group_width

__all__ = ["frontier_table", "frontier_index_plain", "prefix_eval_plain",
           "prefix_eval"]


def frontier_table(s: torch.Tensor, v: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """Level-k nodes (s [N, 16], v [N, 16], t [N]) -> frontier rows
    uint8 [N, 32] with t stashed in bit 0 of byte 15 of s.  Raises
    ``DcfError`` if that bit is not zero in every seed (a broken stash
    would corrupt key material silently)."""
    if bool((s[:, 15] & 1).any()):
        raise DcfError("frontier seed bit 0 of byte 15 is not zero; the "
                       "t-stash invariant is broken")
    rows = torch.cat([s, v], dim=1)
    rows[:, 15] |= t & 1
    return rows


def frontier_index_plain(xs: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 points [M, nb] -> frontier positions int64 [M]: the first k
    walk bits, bit-reversed (position = sum of bit_i * 2^i)."""
    bits = walk_bits_plain(xs)[:, :k].long()
    return (bits << torch.arange(k, device=xs.device)).sum(-1)


def prefix_eval_plain(aes, table, cw_s, cw_v, cw_t, cw_np1, xs, *, k: int,
                      negate: bool, group: str) -> torch.Tensor:
    """Plain PyTorch version of kernel B3 (same arguments as
    ``prefix_eval``)."""
    gw = group_width(group)
    k_num = cw_s.shape[0]
    idx = frontier_index_plain(xs[0], k)
    rows = table.view(k_num, 1 << k, 32)[:, idx]  # [K, M, 32]
    s = rows[..., :16].clone()
    v = rows[..., 16:]
    t = s[..., 15] & 1
    s[..., 15] &= 0xFE
    s, t, v = walk_levels_plain(aes, s, t, v, cw_s[:, k:], cw_v[:, k:],
                                cw_t[:, k:], walk_bits_plain(xs)[:, :, k:],
                                gw)
    return finalize_plain(s, t, v, cw_np1, gw, negate)


_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def prefix_eval(aes, table, cw_s, cw_v, cw_t, cw_np1, xs, *, k: int,
                negate: bool, group: str) -> torch.Tensor:
    """Shares of K keys at M shared points from their frontiers: uint8
    [K, M, 16].

    aes uint8 [496]; table uint8 [K * 2^k, 32] (``frontier_table`` rows,
    keys stacked); cw_s/cw_v [K, n, 16], cw_t [K, n, 2], cw_np1 [K, 16]
    (all n levels; the walk reads levels k..n-1); xs [1, M, n/8].  The
    party is implicit in the frontier; ``negate`` is party 1 of an
    additive group.  The card launches kernel B3, the CPU runs
    ``prefix_eval_plain``."""
    device = table.device
    k_num = cw_s.shape[0]
    n = cw_s.shape[1] if cw_s.dim() == 3 else -1
    m = xs.shape[1]
    if not 1 <= k <= 30 or n < 8 or n % 8 or not k < n:
        raise ShapeError(f"bad prefix geometry: n={n}, k={k}")
    check_u8("aes", aes, (AES_IMAGE_BYTES,), device)
    check_u8("table", table, (k_num << k, 32), device, align=16)
    check_u8("cw_s", cw_s, (k_num, n, 16), device, align=16)
    check_u8("cw_v", cw_v, (k_num, n, 16), device, align=16)
    check_u8("cw_t", cw_t, (k_num, n, 2), device)
    check_u8("cw_np1", cw_np1, (k_num, 16), device, align=16)
    check_u8("xs", xs, (1, m, n // 8), device)
    if device.type == "cpu":
        return prefix_eval_plain(aes, table, cw_s, cw_v, cw_t, cw_np1, xs,
                                 k=k, negate=negate, group=group)
    if device.type != "cuda":
        raise ShapeError(f"prefix_eval runs on cuda or cpu, not {device}")
    y = torch.empty((k_num, m, 16), dtype=torch.uint8, device=device)
    if m == 0:
        return y
    fn = _build.load("prefix_eval", "dcf_prefix_eval", _ARGTYPES)
    a = aes.data_ptr()
    for k0, kk in key_slices(k_num):
        launch_checked("prefix_eval", fn, device, a, a + 256,
                       table.data_ptr() + (k0 << k) * 32,
                       cw_s.data_ptr() + k0 * n * 16,
                       cw_v.data_ptr() + k0 * n * 16,
                       cw_t.data_ptr() + k0 * n * 2,
                       cw_np1.data_ptr() + k0 * 16, xs.data_ptr(),
                       y.data_ptr() + k0 * m * 16, kk, n, k, m,
                       int(bool(negate)), group_width(group))
        prefix_eval.launches += 1
    return y


prefix_eval.launches = 0  # kernel B3 launches in this process
