"""Kernel B2, one breadth-first GGM tree level at lam = 16, and its plain
version.

Counterpart of ``dcf_tpu/ops/pallas_tree.py`` (``_expand_level`` and
``tree_expand_raw``).  A level turns N parent nodes (s, v, t) into 2N
children with the correction words applied and the value accumulator
pushed down both branches; the children are stored as [all lefts ; all
rights], so after several levels the leaf at position p is the node whose
walk directions are the bits of p, LSB first (bitreverse order).  The
prefix backend uses it to build the frontier that kernel B3 gathers from.

``tree_expand_level`` launches the CUDA kernel (``csrc/tree_expand.cu``)
for tensors on the card and runs ``tree_expand_level_plain`` for tensors
on the CPU.  The full-domain finalization (``tree_expand_device``) is not
part of this package yet.
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, launch_checked
from dcf_tpu_torch.ops.walk_eval import (
    AES_IMAGE_BYTES,
    group_add_plain,
    hirose_expand_plain,
)
from dcf_tpu_torch.utils.groups import group_width

__all__ = ["tree_expand_level_plain", "tree_expand_level", "tree_expand"]


def tree_expand_level_plain(aes, cw_s, cw_v, cw_t, s, v, t, *, group: str):
    """Plain PyTorch version of kernel B2 (same arguments as
    ``tree_expand_level``)."""
    gw = group_width(group)
    sl, vl, tl, sr, vr, tr = hirose_expand_plain(aes, s)
    g = t.unsqueeze(-1) * 0xFF
    cs = cw_s & g
    cv = cw_v & g
    s2 = torch.cat([sl ^ cs, sr ^ cs])
    v2 = torch.cat([group_add_plain(v, group_add_plain(vl, cv, gw), gw),
                    group_add_plain(v, group_add_plain(vr, cv, gw), gw)])
    t2 = torch.cat([tl ^ (t & cw_t[0]), tr ^ (t & cw_t[1])])
    return s2, v2, t2


_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def tree_expand_level(aes, cw_s, cw_v, cw_t, s, v, t, *, group: str):
    """One tree level: N parents -> 2N children, [lefts ; rights].

    aes uint8 [496]; cw_s/cw_v uint8 [16] and cw_t uint8 [2] (0/1) are the
    level's correction words; s/v uint8 [N, 16], t uint8 [N] (0/1).
    Returns (s2 [2N, 16], v2 [2N, 16], t2 [2N]).  Additive groups push
    down the unsigned sum.  The card launches kernel B2, the CPU runs
    ``tree_expand_level_plain``."""
    device = s.device
    n_par = s.shape[0]
    check_u8("aes", aes, (AES_IMAGE_BYTES,), device)
    check_u8("cw_s", cw_s, (16,), device)
    check_u8("cw_v", cw_v, (16,), device)
    check_u8("cw_t", cw_t, (2,), device)
    check_u8("s", s, (n_par, 16), device, align=16)
    check_u8("v", v, (n_par, 16), device, align=16)
    check_u8("t", t, (n_par,), device)
    if n_par < 1 or n_par >= 1 << 30:
        raise ShapeError(f"bad parent count {n_par}")
    if device.type == "cpu":
        return tree_expand_level_plain(aes, cw_s, cw_v, cw_t, s, v, t,
                                       group=group)
    if device.type != "cuda":
        raise ShapeError(f"tree_expand_level runs on cuda or cpu, not {device}")
    s2 = torch.empty((2 * n_par, 16), dtype=torch.uint8, device=device)
    v2 = torch.empty((2 * n_par, 16), dtype=torch.uint8, device=device)
    t2 = torch.empty((2 * n_par,), dtype=torch.uint8, device=device)
    fn = _build.load("tree_expand", "dcf_tree_expand_level", _ARGTYPES)
    a = aes.data_ptr()
    launch_checked("tree_expand", fn, device, a, a + 256, cw_s.data_ptr(),
                   cw_v.data_ptr(), cw_t.data_ptr(), s.data_ptr(),
                   v.data_ptr(), t.data_ptr(), s2.data_ptr(), v2.data_ptr(),
                   t2.data_ptr(), n_par, group_width(group))
    tree_expand_level.launches += 1
    return s2, v2, t2


tree_expand_level.launches = 0  # kernel B2 launches in this process


def tree_expand(aes, cw_s, cw_v, cw_t, s, v, t, *, k0: int, k1: int,
                group: str):
    """Expand levels k0..k1-1 without finalizing (``tree_expand_raw``):
    cw_s/cw_v uint8 [n, 16], cw_t uint8 [n, 2] of one key; (s, v, t) the
    level-k0 nodes in bitreverse order.  Returns the level-k1 nodes, also
    in bitreverse order: one kernel launch per level."""
    for i in range(k0, k1):
        s, v, t = tree_expand_level(aes, cw_s[i], cw_v[i], cw_t[i], s, v, t,
                                    group=group)
    return s, v, t
