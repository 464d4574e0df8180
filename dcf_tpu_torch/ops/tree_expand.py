"""Kernel B2, breadth-first GGM tree levels at lam = 16, its leaf-level
form B2f, and their plain versions.

Counterpart of ``dcf_tpu/ops/pallas_tree.py`` (``_expand_level``,
``tree_expand_raw`` and ``tree_expand_device``).  A level turns N parent nodes (s, v, t) into 2N
children with the correction words applied and the value accumulator
pushed down both branches; the children are stored as [all lefts ; all
rights], so after several levels the leaf at position p is the node whose
walk directions are the bits of p, LSB first (bitreverse order).  The
prefix backend uses it to build the frontier that kernel B3 gathers from.

Kernel B2 (``csrc/tree_expand.cu``, per-thread code ``tree_subtree`` in
``csrc/aes_banked.cuh``) expands one to ``MAX_DEPTH`` levels a launch on
the banked AES, the levels between kept in registers; a launch of d
levels leaves its 2^d N nodes where d launches of one level would.
``tree_expand`` cuts a span of levels into such launches, the deepest
last (``ops._launch.launch_depths``), and ``tree_expand_level`` is
the one-level entry.  ``tree_expand_levels.launches`` counts every launch of
kernel B2, of any depth.

The full-domain evaluator (``tree_expand_device``) runs the levels above
the last ``FINAL_LEVELS`` through B2 and those through B2f
(``tree_expand_final``), the same kernel with the leaf finalize as the
last level of its launch: each parent on the tree's last level turns
straight into the two leaf shares y = v ^ s ^ t * cw_np1 of its children
(XOR group), so the leaf level's s, v and t are never stored.

The wrappers launch their CUDA kernels for tensors on the card and run
their plain versions for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import (
    MAX_DEPTH,
    check_u8,
    launch_checked,
    launch_depths,
)
from dcf_tpu_torch.ops.walk_eval import (
    AES_IMAGE_BYTES,
    group_add_plain,
    hirose_expand_plain,
)
from dcf_tpu_torch.utils.groups import group_width

__all__ = ["tree_expand_level_plain", "tree_expand_levels",
           "tree_expand_level", "tree_expand", "tree_expand_final_plain",
           "tree_expand_final", "tree_expand_device"]


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


def tree_expand_final_plain(aes, cw_s, cw_v, cw_t, cw_np1, s, v, t):
    """Plain PyTorch version of kernel B2f (same arguments as
    ``tree_expand_final``): ``tree_expand_level_plain`` level by level,
    then the leaf finalize."""
    if cw_s.dim() == 1:
        cw_s, cw_v, cw_t = cw_s[None], cw_v[None], cw_t[None]
    for i in range(cw_s.shape[0]):
        s, v, t = tree_expand_level_plain(aes, cw_s[i], cw_v[i], cw_t[i], s,
                                          v, t, group="xor")
    return v ^ s ^ (cw_np1 & (t.unsqueeze(-1) * 0xFF))


_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_FINAL_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
# Levels of the full domain's last launch, the B2f one (1..MAX_DEPTH): the
# tree's last level and the levels above it, kept in registers.  Three
# (B2f from 2^21 parents at n = 24, B2 over levels 6..20 in five launches)
# ran the full domain 2-4% faster than one (B2 over 6..22 in six
# launches, then B2f from 2^23 parents), whose level-23 parents went
# through HBM (NVIDIA H100 80GB HBM3, 700 W, chip_ab.py
# tree_expand_device, PERF.md).
FINAL_LEVELS = 3


def _check_nodes(aes, s, v, t) -> int:
    """The node checks B2 and B2f share; returns the parent count."""
    device = s.device
    n_par = s.shape[0]
    check_u8("aes", aes, (AES_IMAGE_BYTES,), device)
    check_u8("s", s, (n_par, 16), device, align=16)
    check_u8("v", v, (n_par, 16), device, align=16)
    check_u8("t", t, (n_par,), device)
    if n_par < 1 or n_par >= 1 << 30:
        raise ShapeError(f"bad parent count {n_par}")
    return n_par


def _check_level_cws(cw_s, cw_v, cw_t, device) -> None:
    """The checks of one level's correction words (B2's one-level entry
    and B2f)."""
    check_u8("cw_s", cw_s, (16,), device)
    check_u8("cw_v", cw_v, (16,), device)
    check_u8("cw_t", cw_t, (2,), device)


def tree_expand_levels(aes, cw_s, cw_v, cw_t, s, v, t, *, level: int,
                       depth: int, group: str):
    """Levels level .. level + depth - 1 of one key in one launch
    (depth 1..MAX_DEPTH): N parents -> 2^depth N nodes, as ``depth`` calls
    of ``tree_expand_level`` would leave them.

    cw_s/cw_v uint8 [n, 16] and cw_t uint8 [n, 2] (0/1) are the key's
    correction words, ``level`` picks the first; s/v uint8 [N, 16], t uint8
    [N] (0/1).  Returns (s2 [2^d N, 16], v2 [2^d N, 16], t2 [2^d N]).
    Additive groups push down the unsigned sum.  The card launches kernel
    B2, the CPU runs ``tree_expand_level_plain`` level by level."""
    device = s.device
    n_par = _check_nodes(aes, s, v, t)
    n = cw_s.shape[0] if cw_s.dim() == 2 else -1
    check_u8("cw_s", cw_s, (n, 16), device)
    check_u8("cw_v", cw_v, (n, 16), device)
    check_u8("cw_t", cw_t, (n, 2), device)
    if not 1 <= depth <= MAX_DEPTH or not 0 <= level <= n - depth \
            or n_par << depth >= 1 << 31:
        raise ShapeError(f"bad level geometry: levels {level}.."
                         f"{level + depth - 1} of {n}, {n_par} parents")
    if device.type == "cpu":
        for i in range(level, level + depth):
            s, v, t = tree_expand_level_plain(aes, cw_s[i], cw_v[i], cw_t[i],
                                              s, v, t, group=group)
        return s, v, t
    if device.type != "cuda":
        raise ShapeError(f"tree_expand runs on cuda or cpu, not {device}")
    n_out = n_par << depth
    s2 = torch.empty((n_out, 16), dtype=torch.uint8, device=device)
    v2 = torch.empty((n_out, 16), dtype=torch.uint8, device=device)
    t2 = torch.empty((n_out,), dtype=torch.uint8, device=device)
    fn = _build.load("tree_expand", "dcf_tree_expand_levels", _ARGTYPES)
    a = aes.data_ptr()
    launch_checked("tree_expand", fn, device, a, a + 256,
                   cw_s.data_ptr() + 16 * level, cw_v.data_ptr() + 16 * level,
                   cw_t.data_ptr() + 2 * level, s.data_ptr(), v.data_ptr(),
                   t.data_ptr(), s2.data_ptr(), v2.data_ptr(), t2.data_ptr(),
                   n_par, group_width(group), depth)
    tree_expand_levels.launches += 1
    return s2, v2, t2


tree_expand_levels.launches = 0  # kernel B2 launches in this process, any depth


def tree_expand_level(aes, cw_s, cw_v, cw_t, s, v, t, *, group: str):
    """One tree level: N parents -> 2N children, [lefts ; rights].

    aes uint8 [496]; cw_s/cw_v uint8 [16] and cw_t uint8 [2] (0/1) are the
    level's correction words; s/v uint8 [N, 16], t uint8 [N] (0/1).
    Returns (s2 [2N, 16], v2 [2N, 16], t2 [2N]).  Additive groups push
    down the unsigned sum.  The card launches kernel B2 one level deep,
    the CPU runs ``tree_expand_level_plain``."""
    _check_level_cws(cw_s, cw_v, cw_t, s.device)
    return tree_expand_levels(aes, cw_s[None], cw_v[None], cw_t[None], s, v,
                              t, level=0, depth=1, group=group)


def tree_expand(aes, cw_s, cw_v, cw_t, s, v, t, *, k0: int, k1: int,
                group: str):
    """Expand levels k0..k1-1 without finalizing (``tree_expand_raw``):
    cw_s/cw_v uint8 [n, 16], cw_t uint8 [n, 2] of one key; (s, v, t) the
    level-k0 nodes in bitreverse order.  Returns the level-k1 nodes, also
    in bitreverse order: one launch of kernel B2 per
    ``launch_depths(k0, k1)`` entry (levels 6..20 in five)."""
    if k1 <= k0:
        return s, v, t
    for i, depth in launch_depths(k0, k1):
        s, v, t = tree_expand_levels(aes, cw_s, cw_v, cw_t, s, v, t,
                                     level=i, depth=depth, group=group)
    return s, v, t


def tree_expand_final(aes, cw_s, cw_v, cw_t, cw_np1, s, v, t):
    """The tree's last level and the leaf finalize in one launch (XOR
    group): N parents -> 2N leaf shares y = v ^ s ^ t * cw_np1, uint8
    [2N, 16], [lefts ; rights]; or, with cw_s / cw_v uint8 [d, 16] and
    cw_t uint8 [d, 2], the tree's last d levels (d <= MAX_DEPTH), the
    levels above the leaves kept in registers: N parents -> 2^d N leaf
    shares in the rows d launches of one level would fill.

    Arguments as ``tree_expand_level`` (the last level's correction
    words, or the last d levels') plus cw_np1 uint8 [16].  The card
    launches kernel B2f, the CPU runs ``tree_expand_final_plain``."""
    device = s.device
    if cw_s.dim() == 1:
        _check_level_cws(cw_s, cw_v, cw_t, device)
        depth = 1
    else:
        depth = cw_s.shape[0]
        check_u8("cw_s", cw_s, (depth, 16), device)
        check_u8("cw_v", cw_v, (depth, 16), device)
        check_u8("cw_t", cw_t, (depth, 2), device)
    n_par = _check_nodes(aes, s, v, t)
    check_u8("cw_np1", cw_np1, (16,), device)
    if not 1 <= depth <= MAX_DEPTH or n_par << depth >= 1 << 31:
        raise ShapeError(f"bad leaf launch: {depth} levels from {n_par} "
                         "parents")
    if device.type == "cpu":
        return tree_expand_final_plain(aes, cw_s, cw_v, cw_t, cw_np1, s, v,
                                       t)
    if device.type != "cuda":
        raise ShapeError(f"tree_expand_final runs on cuda or cpu, not {device}")
    y = torch.empty((n_par << depth, 16), dtype=torch.uint8, device=device)
    fn = _build.load("tree_expand", "dcf_tree_expand_final_levels",
                     _FINAL_ARGTYPES)
    a = aes.data_ptr()
    launch_checked("tree_expand_final", fn, device, a, a + 256,
                   cw_s.data_ptr(), cw_v.data_ptr(), cw_t.data_ptr(),
                   cw_np1.data_ptr(), s.data_ptr(), v.data_ptr(),
                   t.data_ptr(), y.data_ptr(), n_par, depth)
    tree_expand_final.launches += 1
    return y


tree_expand_final.launches = 0  # kernel B2f launches in this process


def tree_expand_device(aes, cw_s, cw_v, cw_t, cw_np1, s, v, t, *, k0: int,
                       n: int):
    """Expand levels k0..n-1 of one XOR-group key and finalize the leaves:
    cw_s/cw_v uint8 [n, 16], cw_t uint8 [n, 2], cw_np1 uint8 [16];
    (s, v, t) the level-k0 nodes in bitreverse order, k0 < n.  Returns the
    leaf shares uint8 [2^n, 16] in bitreverse_n order: kernel B2 for the
    levels above the last ``FINAL_LEVELS`` (at most n - k0), kernel B2f
    for those."""
    if not 0 <= k0 < n or cw_s.shape[0] != n or s.shape[0] != 1 << k0:
        raise ShapeError(
            f"tree_expand_device wants 2^k0 nodes and 0 <= k0 < n = "
            f"{cw_s.shape[0]} levels, got k0={k0}, n={n}, "
            f"{s.shape[0]} nodes")
    last = n - min(FINAL_LEVELS, n - k0)
    s, v, t = tree_expand(aes, cw_s, cw_v, cw_t, s, v, t, k0=k0, k1=last,
                          group="xor")
    return tree_expand_final(aes, cw_s[last:], cw_v[last:], cw_t[last:],
                             cw_np1, s, v, t)
