"""Kernel E1, the from-root DCF walk at lam = 32, and its plain version.

Counterpart of ``dcf_tpu/backends/jax_bitsliced.py`` at lam = 32: its
``eval_core_bitsliced``, the XLA ``lax.scan`` over the n levels of
``prg_planes``, which ``BitslicedBackend`` runs (``dcf_tpu``'s facade picks
it for 16 < lam < 48).  The JAX package walks 256 bit planes of 32 points
per lane word; this port keeps the bytes at the edges and nothing of that
layout.

At lam = 32 the Hirose PRG encrypts both 16-byte blocks (cipher 0 on block
0, cipher 17 on block 1), as the narrow walk of kernel B4 does, and clears
its output bit 8*lam-1 (bit 0 of byte 31) in all four children before the
level's correction enters; t_l and t_r are read before the mask.  The
value accumulates in the output group (XOR, or lane-wise add mod 2^w with
little-endian lanes), and party 1 of an additive group negates once, at
the exit, so the shares are signed.

``walk32_eval`` launches the CUDA kernel (``csrc/walk32_eval.cu``, per-
thread code ``walk32_point_banked`` in ``csrc/narrow_walk.cuh``: B4's
three-slot level on the banked AES, masked, with the group's v) for
tensors on the card and runs ``walk32_eval_plain`` -- B4's plain level loop
``narrow_levels_plain`` with the mask and the group add, then the group
finalize -- for tensors on the CPU.  There is no fallback from one to the
other.

Cipher image: B4's, the S-box then the round keys of ciphers 0 and 17,
uint8 [736] (``ops.narrow_walk.narrow_aes_image``).
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, key_slices, launch_checked
from dcf_tpu_torch.ops.narrow_walk import (
    NARROW,
    NARROW_AES_BYTES,
    narrow_levels_plain,
)
from dcf_tpu_torch.ops.walk_eval import (
    group_add_plain,
    group_neg_plain,
    walk_bits_plain,
)
from dcf_tpu_torch.utils.groups import group_width

__all__ = ["walk32_eval_plain", "walk32_eval"]


def walk32_eval_plain(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, *, b: int,
                      group: str) -> torch.Tensor:
    """Plain PyTorch version of kernel E1 (same arguments as
    ``walk32_eval``)."""
    gw = group_width(group)
    k_num, m = s0.shape[0], xs.shape[1]
    s = s0[:, None, :].expand(k_num, m, NARROW)
    t = torch.full((k_num, m), int(b), dtype=torch.uint8, device=s0.device)
    v = torch.zeros((k_num, m, NARROW), dtype=torch.uint8, device=s0.device)
    s, t, v, _ = narrow_levels_plain(aes, s, t, v, cw_s, cw_v, cw_t,
                                     walk_bits_plain(xs), gw=gw, masked=True)
    g = t.unsqueeze(-1) * 0xFF
    y = group_add_plain(v, group_add_plain(s, cw_np1[:, None, :] & g, gw),
                        gw)
    return group_neg_plain(y, gw) if b and gw else y


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def walk32_eval(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, *, b: int,
                group: str) -> torch.Tensor:
    """Party ``b`` DCF shares of K lam = 32 keys at M points: uint8
    [K, M, 32].

    aes uint8 [736] (``narrow_aes_image``); s0 [K, 32]; cw_s/cw_v
    [K, n, 32]; cw_t [K, n, 2] (0/1); cw_np1 [K, 32]; xs [1 or K, M, n/8]
    (points shared by all keys, or per key).  All tensors on one device:
    the card launches kernel E1, the CPU runs ``walk32_eval_plain``.
    Additive groups come out as signed shares (party 1 negated)."""
    device = s0.device
    k_num = s0.shape[0]
    n = cw_s.shape[1] if cw_s.dim() == 3 else -1
    kx, m = xs.shape[0], xs.shape[1]
    check_u8("aes", aes, (NARROW_AES_BYTES,), device)
    check_u8("s0", s0, (k_num, NARROW), device)
    check_u8("cw_s", cw_s, (k_num, n, NARROW), device)
    check_u8("cw_v", cw_v, (k_num, n, NARROW), device)
    check_u8("cw_t", cw_t, (k_num, n, 2), device)
    check_u8("cw_np1", cw_np1, (k_num, NARROW), device)
    check_u8("xs", xs, (kx, m, n // 8), device)
    if n < 8 or n % 8 or kx not in (1, k_num) or b not in (0, 1):
        raise ShapeError(f"bad lam = 32 walk geometry: n={n}, Kx={kx}, "
                         f"K={k_num}, b={b}")
    if device.type == "cpu":
        return walk32_eval_plain(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, b=b,
                                 group=group)
    if device.type != "cuda":
        raise ShapeError(f"walk32_eval runs on cuda or cpu, not {device}")
    gw = group_width(group)
    y = torch.empty((k_num, m, NARROW), dtype=torch.uint8, device=device)
    if m == 0:
        return y
    fn = _build.load("walk32_eval", "dcf_walk32_eval", _ARGTYPES)
    a = aes.data_ptr()
    per_key = int(kx == k_num and k_num > 1)
    for k0, kk in key_slices(k_num):
        launch_checked("walk32_eval", fn, device, a, a + 256, a + 496,
                       s0.data_ptr() + k0 * NARROW,
                       cw_s.data_ptr() + k0 * n * NARROW,
                       cw_v.data_ptr() + k0 * n * NARROW,
                       cw_t.data_ptr() + k0 * n * 2,
                       cw_np1.data_ptr() + k0 * NARROW,
                       xs.data_ptr() + per_key * k0 * m * (n // 8),
                       y.data_ptr() + k0 * m * NARROW, kk, n, m, per_key,
                       int(b), gw)
        walk32_eval.launches += 1
    return y


walk32_eval.launches = 0  # kernel E1 launches in this process
