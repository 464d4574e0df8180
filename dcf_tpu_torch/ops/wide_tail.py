"""Kernel W1, the GF(2) wide tail of the large-lambda hybrid, and its
plain version.

Counterpart of ``_wide_tail`` in ``dcf_tpu/backends/large_lambda.py``
(an XLA int8 ``dot_general`` with parity extraction, not a Pallas
kernel).  Beyond its first 32 bytes a lam-byte DCF share is an affine
function of the narrow walk's gate bits:

    y[32:] = const ^ XOR over k of (t_k ? W[k] : 0)

with ``const`` [K, lam-32] and ``W`` [K, n+1, lam-32] from
``backends.large_lambda.wide_affine_batch_np``.  A GF(2) product is an
XOR of the rows the trajectory selects, so the kernel multiplies nothing
and reads the packed bits as they are.  (``torch._int_mm`` would need
every bit unpacked to an int8, a 4-byte sum per output bit and a parity
pass; ``chip_smoke.py`` times it beside W1.)

The kernel (``csrc/wide_xor.cu``) uses the method of four Russians: the
trajectory's bits in groups of five, a shared table per group of the 32
XORs of W's rows that the group's bits can select (const folded into the
first group), so each 16 bytes of a share are one table read a group, 26
at n = 128.  A block builds the table of a column tile (up to 256 bytes of
a row, the whole 224 at lam = 256) once and strides over the points.

``wide_tail`` writes bytes 32..lam-1 of the share tensor ``y`` in place
(no concatenation) and returns it: the CUDA kernel for tensors on the
card, ``wide_tail_plain`` -- the same XOR of masked rows, one row at a
time -- for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, launch_checked
from dcf_tpu_torch.ops.narrow_walk import NARROW, traj_bytes, unpack_traj_plain

__all__ = ["wide_tail_plain", "wide_tail"]


def wide_tail_plain(y: torch.Tensor, traj: torch.Tensor, const: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel W1 (same arguments as
    ``wide_tail``).  Works on the card too: it XORs masked rows and never
    multiplies."""
    n1 = w.shape[1]
    bits = unpack_traj_plain(traj, n1)
    acc = const[:, None, :].expand(y.shape[0], y.shape[1], -1).clone()
    for k in range(n1):
        acc ^= w[:, k, None, :] & (bits[:, :, k, None] * 0xFF)
    y[..., NARROW:] = acc
    return y


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def wide_tail(y: torch.Tensor, traj: torch.Tensor, const: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Fill y[..., 32:] of the shares y uint8 [K, M, lam] from the packed
    trajectories traj uint8 [K, M, traj_bytes(n + 1)], const uint8
    [K, lam-32] and W uint8 [K, n+1, lam-32]; returns y.  The card
    launches kernel W1, the CPU runs ``wide_tail_plain``."""
    device = y.device
    if y.dim() != 3 or w.dim() != 3:
        raise ShapeError("y must be [K, M, lam] and w [K, n+1, lam-32]")
    k_num, m, lam = y.shape
    n1 = w.shape[1]
    wd = lam - NARROW
    check_u8("y", y, (k_num, m, lam), device, align=16)
    check_u8("traj", traj, (k_num, m, traj_bytes(n1)), device, align=4)
    check_u8("const", const, (k_num, wd), device, align=16)
    check_u8("w", w, (k_num, n1, wd), device, align=16)
    if lam < 48 or lam % 16 or n1 < 1:
        raise ShapeError(f"bad wide tail geometry: lam={lam}, n+1={n1}")
    if device.type == "cpu":
        return wide_tail_plain(y, traj, const, w)
    if device.type != "cuda":
        raise ShapeError(f"wide_tail runs on cuda or cpu, not {device}")
    if m == 0 or k_num == 0:
        return y
    fn = _build.load("wide_xor", "dcf_wide_xor", _ARGTYPES)
    launch_checked("wide_xor", fn, device, traj.data_ptr(), w.data_ptr(),
                   const.data_ptr(), y.data_ptr(), k_num, n1,
                   traj.shape[2] // 4, wd // 4, m, lam)
    wide_tail.launches += 1
    return y


wide_tail.launches = 0  # kernel W1 launches in this process
