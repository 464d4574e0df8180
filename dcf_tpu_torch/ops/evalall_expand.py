"""Kernel B6, one breadth-first level of the DPF tree at lam = 32 for K
keys, and its plain version.

Counterpart of ``dcf_tpu/ops/pallas_evalall.py`` (``_expand_level``,
``dpf_tree_expand_raw`` and ``dpf_tree_expand_device``).  A level turns
the N parent nodes (s, t) of each key into 2N children with the key's seed
correction applied; there is no value accumulator, a DPF key has no
``cw_v``.  Children per Hirose step at lam = 32 (blocks 0 / 1 = bytes
0..15 / 16..31, cipher 0 on block 0, cipher 17 on block 1):

    s_l = (E0(s_b0) ^ s_b0, s_b1)      s_r = (s_b0, E17(s_b1) ^ s_b1)

with bit 8*lam-1 (bit 0 of byte 31) cleared in both, and t_l / t_r bit 0
of byte 0 of E0(s_b0) ^ s_b0 and E0(~s_b0) ^ ~s_b0 before the mask.  Each
key's children are stored as [all lefts ; all rights], so after several
levels the leaf at position p is the node whose walk directions are the
bits of p, LSB first: position p holds domain point bitreverse(p), as
from kernel B2.

Layout: s uint8 [K, N, 32], t uint8 [K, N] with one byte (0/1) per node;
``Dcf.eval_all`` returns the last level's t bytes as they are.

With ``cw_np1`` the level is the last one and writes the leaf shares
y = s ^ t * cw_np1 in place of the children's seeds, or, with
``want_y=False``, only the leaves' t bits, packed: int32 [K, ceil(2^d N /
32)], bit i of word w the leaf at position 32 w + i (``pir_answer``'s
``pack_selection`` layout, the reference's ``t_words``).  That is the PIR
selection-vector share kernel P1 (``ops.pir_answer``) reads, and a PIR
server reads nothing else: at 2^24 leaves and K = 4 it saves writing
2 GiB of y and 56 MiB of t bytes, and the launch computes no cipher-17
block, since t never depends on one.  One launch may
expand up to ``MAX_DEPTH`` levels, the levels between them kept in
registers: its nodes land in the rows that launches of one level each
would fill, so only the launches' count and the traffic between them
change.  ``evalall_expand`` cuts a tree's levels into such launches
(``launch_depths``).

``evalall_expand_level`` launches the CUDA kernel
(``csrc/evalall_expand.cu``, per-thread code ``dpf_subtree`` in
``csrc/narrow_walk.cuh``, on the banked AES of ``csrc/aes_banked.cuh``) for tensors on the card and runs
``evalall_expand_level_plain`` for tensors on the CPU.  The cipher image
is the narrow one, uint8 [736] (``ops.narrow_walk.narrow_aes_image``).
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import (
    MAX_DEPTH,
    check_u8,
    key_slices,
    launch_checked,
    launch_depths,
)
from dcf_tpu_torch.ops.narrow_walk import NARROW, NARROW_AES_BYTES, _ciphers
from dcf_tpu_torch.ops.pir_answer import pack_selection
from dcf_tpu_torch.ops.walk_eval import aes256_encrypt_plain

__all__ = ["evalall_expand_level_plain",
           "evalall_expand_level", "evalall_expand"]

def evalall_expand_level_plain(aes, cw_s, cw_t, s, t, *, level: int,
                               cw_np1=None, depth: int = 1,
                               want_y: bool = True):
    """Plain PyTorch version of kernel B6 (same arguments as
    ``evalall_expand_level``)."""
    for i in range(level, level + depth - 1):
        s, t = _level_plain(aes, cw_s, cw_t, s, t, level=i, cw_np1=None)
    y, t = _level_plain(aes, cw_s, cw_t, s, t, level=level + depth - 1,
                        cw_np1=cw_np1)
    return (y, t) if want_y else (None, pack_selection(t))


def _level_plain(aes, cw_s, cw_t, s, t, *, level: int, cw_np1):
    aes0, aes17 = _ciphers(aes)
    sa, sb = s[..., :16], s[..., 16:]
    spa = ~sa
    e0 = aes256_encrypt_plain(aes0, torch.stack([sa, spa]))
    es0, ev0 = e0[0] ^ sa, e0[1] ^ spa
    es1 = aes256_encrypt_plain(aes17, sb) ^ sb
    mask = torch.full((16,), 0xFF, dtype=torch.uint8, device=s.device)
    mask[15] = 0xFE
    g = t.unsqueeze(-1) * 0xFF
    cs = cw_s[:, level, None, :] & g
    s2 = torch.cat([torch.cat([es0, sb & mask], -1) ^ cs,
                    torch.cat([sa, es1 & mask], -1) ^ cs], dim=1)
    t2 = torch.cat([(es0[..., 0] & 1) ^ (t & cw_t[:, level, 0, None]),
                    (ev0[..., 0] & 1) ^ (t & cw_t[:, level, 1, None])],
                   dim=1)
    if cw_np1 is not None:
        s2 = s2 ^ (cw_np1[:, None, :] & (t2.unsqueeze(-1) * 0xFF))
    return s2, t2


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DEPTH_ARGTYPES = _ARGTYPES[:14] + [ctypes.c_int] + _ARGTYPES[14:]


def evalall_expand_level(aes, cw_s, cw_t, s, t, *, level: int, cw_np1=None,
                         depth: int = 1, want_y: bool = True):
    """One DPF tree level for K keys: N parents -> 2N children per key,
    [lefts ; rights]; with ``depth`` d (1..MAX_DEPTH), levels level ..
    level + d - 1 in one launch: N parents -> 2^d N nodes per key, as d
    calls of one level would leave them.

    aes uint8 [736]; cw_s uint8 [K, n, 32] and cw_t uint8 [K, n, 2] (0/1)
    are the keys' whole correction-word arrays and ``level`` picks the
    (first) level; s uint8 [K, N, 32], t uint8 [K, N] (0/1).  Returns (s2
    [K, 2^d N, 32], t2 [K, 2^d N]).  With cw_np1 uint8 [K, 32] the last
    level expanded is the tree's last: s2 holds the leaf shares
    y = s ^ t * cw_np1, or is None with ``want_y=False``, and t2 is then
    the leaves' t bits packed, int32 [K, ceil(2^d N / 32)].  The card
    launches kernel B6, the CPU runs ``evalall_expand_level_plain``."""
    device = s.device
    if s.dim() != 3 or cw_s.dim() != 3:
        raise ShapeError("s must be [K, N, 32] and cw_s [K, n, 32]")
    k_num, n_par = s.shape[0], s.shape[1]
    n = cw_s.shape[1]
    check_u8("aes", aes, (NARROW_AES_BYTES,), device)
    check_u8("cw_s", cw_s, (k_num, n, NARROW), device)
    check_u8("cw_t", cw_t, (k_num, n, 2), device)
    check_u8("s", s, (k_num, n_par, NARROW), device, align=16)
    check_u8("t", t, (k_num, n_par), device)
    if cw_np1 is not None:
        check_u8("cw_np1", cw_np1, (k_num, NARROW), device)
    if not 1 <= depth <= MAX_DEPTH or not 0 <= level <= n - depth \
            or not 1 <= n_par < 1 << 30 or k_num < 1:
        raise ShapeError(f"bad level geometry: levels {level}.."
                         f"{level + depth - 1} of {n}, {n_par} parents, "
                         f"{k_num} keys")
    if not want_y and cw_np1 is None:
        raise ShapeError("only the tree's last level may leave out y")
    if device.type == "cpu":
        return evalall_expand_level_plain(aes, cw_s, cw_t, s, t, level=level,
                                          cw_np1=cw_np1, depth=depth,
                                          want_y=want_y)
    if device.type != "cuda":
        raise ShapeError(
            f"evalall_expand_level runs on cuda or cpu, not {device}")
    n_out = n_par << depth
    s2 = torch.empty((k_num, n_out, NARROW), dtype=torch.uint8,
                     device=device) if want_y else None
    if want_y:
        t2 = torch.empty((k_num, n_out), dtype=torch.uint8, device=device)
    else:  # packed words; a ballot writes each whole where N % 32 == 0
        t2 = (torch.empty if n_par % 32 == 0 else torch.zeros)(
            (k_num, -(-n_out // 32)), dtype=torch.int32, device=device)
    if depth == 1:
        fn = _build.load("evalall_expand", "dcf_evalall_expand_level",
                         _ARGTYPES)
        levels = (int(level),)
    else:  # the same kernel, the levels between kept in registers
        fn = _build.load("evalall_expand", "dcf_evalall_expand_levels",
                         _DEPTH_ARGTYPES)
        levels = (int(level), int(depth))
    a = aes.data_ptr()
    for k0, kk in key_slices(k_num):
        launch_checked("evalall_expand", fn, device, a, a + 256, a + 496,
                       cw_s.data_ptr() + k0 * n * NARROW,
                       cw_t.data_ptr() + k0 * n * 2,
                       cw_np1.data_ptr() + k0 * NARROW
                       if cw_np1 is not None else 0,
                       s.data_ptr() + k0 * n_par * NARROW,
                       t.data_ptr() + k0 * n_par,
                       s2.data_ptr() + k0 * n_out * NARROW
                       if want_y else 0,
                       t2.data_ptr() + k0 * t2.shape[1] * t2.element_size(),
                       kk, n_par, n, *levels,
                       int(cw_np1 is not None))
        evalall_expand_level.launches += 1
    return s2, t2


evalall_expand_level.launches = 0  # kernel B6 launches in this process


def evalall_expand(aes, cw_s, cw_t, cw_np1, s, t, *, k0: int, k1: int,
                   want_y: bool = True):
    """Expand levels k0..k1-1 of K keys from the level-k0 nodes (s
    [K, 2^k0, 32], t [K, 2^k0], bitreverse order) and apply the leaf
    correction on the last one, k0 < k1 <= n: one kernel launch per
    ``launch_depths(k0, k1)`` entry.
    Returns (y uint8 [K, 2^k1, 32], t uint8 [K, 2^k1]) in bitreverse_k1
    order.  y is the leaf share only at full depth, k1 = n; at a prefix
    depth the correction lands on inner seeds and only t means something
    (the one-hot share of alpha's top k1 bits).  With ``want_y=False`` y
    is None: the last launch writes the t bits alone, packed (int32
    [K, ceil(2^k1 / 32)])."""
    if not 0 <= k0 < k1 <= cw_s.shape[1] or s.shape[1] != 1 << k0:
        raise ShapeError(
            f"evalall_expand wants 2^k0 nodes and 0 <= k0 < k1 <= n = "
            f"{cw_s.shape[1]}, got k0={k0}, k1={k1}, {s.shape[1]} nodes")
    for i, depth in launch_depths(k0, k1):
        last = i + depth == k1
        s, t = evalall_expand_level(
            aes, cw_s, cw_t, s, t, level=i, depth=depth,
            cw_np1=cw_np1 if last else None, want_y=want_y or not last)
    return s, t
