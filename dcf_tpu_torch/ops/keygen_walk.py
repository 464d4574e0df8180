"""Kernels G1, G2, B7a and B7b, DCF and DPF key generation on the card,
kernel W2, B7a's wide tail, and their plain versions.

Counterparts of ``dcf_tpu/backends/device_gen.py`` (``_gen_core``, the XLA
level scan at lam < 48: G1 here at lam = 16, G2 at lam = 32),
``dcf_tpu/ops/pallas_keygen.py``
(``dcf_keygen_walk_pallas``, B7a: the narrow 32 bytes of a lam >= 48 key;
``dpf_keygen_walk_pallas``, B7b: lam = 32 DPF keys) and its
``_keygen_wide_tail`` (the XLA scan over bytes 32..lam-1: W2 here).  The
JAX package packs 32 keys per lane word and emits bit planes; the port
keeps the byte rows of a ``KeyBundle`` from end to end, and on the card
one thread walks one key (``csrc/keygen_walk.cu``) and one thread carries
one 16-byte column of a key's wide part (``csrc/keygen_wide.cu``);
per-thread code in ``csrc/keygen_walk.cuh``.

Inputs, on one device: alphas uint8 [K, n/8], betas uint8 [K, lam], s0s
uint8 [K, 2, lam] (both parties' root seeds).  Outputs, left on that
device: cw_s / cw_v uint8 [K, n, lam], cw_t uint8 [K, n, 2] (0/1), cw_np1
uint8 [K, lam], and for B7a the trajectories uint8 [K, n, 2]: party 0's
and party 1's t at the entry of each level.  B7a writes the first 32 bytes
of each cw row; ``keygen_wide_tail`` the rest, in place.

``keygen_dcf16``, ``keygen_dcf32``, ``keygen_narrow``, ``keygen_dpf`` and
``keygen_wide_tail`` launch their kernel for tensors on the card and run
their plain version for tensors on the CPU: ``keygen_walk_plain`` (the
same walk in plain PyTorch ops over the AES and Hirose pieces of
``ops.walk_eval``) and ``keygen_wide_tail_plain`` (the wide part's GF(2)
recursion as n levels of torch ops over [K, lam - 32] bytes).
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, launch_checked
from dcf_tpu_torch.ops.narrow_walk import NARROW, NARROW_AES_BYTES, _ciphers
from dcf_tpu_torch.ops.walk_eval import (
    AES_IMAGE_BYTES,
    _BYTE15_MASK,
    aes256_encrypt_plain,
    hirose_expand_plain,
    walk_bits_plain,
)

__all__ = ["MODE_G1", "MODE_B7A", "MODE_B7B", "MODE_G2",
           "keygen_walk_plain", "keygen_wide_tail_plain", "keygen_dcf16",
           "keygen_dcf32", "keygen_narrow", "keygen_dpf", "keygen_wide_tail"]

# csrc/keygen_walk.cuh's KgMode
MODE_G1, MODE_B7A, MODE_B7B, MODE_G2 = 0, 1, 2, 3


# --------------------------------------------------------------------------
# Plain PyTorch versions.
# --------------------------------------------------------------------------

def _expand_plain(aes, s, mode: int):
    """One party's children at one level: (s_l, s_r, v_l, v_r, t_l, t_r),
    uint8 [K, 16 or 32] and [K] (v is None for a DPF)."""
    if mode == MODE_G1:
        sl, vl, tl, sr, vr, tr = hirose_expand_plain(aes, s)
        return sl, sr, vl, vr, tl, tr
    aes0, aes17 = _ciphers(aes)
    sa, sb = s[..., :16], s[..., 16:]
    spa, spb = ~sa, ~sb
    e0 = aes256_encrypt_plain(aes0, torch.stack([sa, spa]))
    es0, ev0 = e0[0] ^ sa, e0[1] ^ spa
    tl, tr = es0[..., 0] & 1, ev0[..., 0] & 1
    mask = torch.as_tensor(_BYTE15_MASK, device=s.device)  # block 1 only
    if mode == MODE_B7B:
        es1 = aes256_encrypt_plain(aes17, sb) ^ sb
        return (torch.cat([es0, sb & mask], -1),
                torch.cat([sa, es1 & mask], -1), None, None, tl, tr)
    e1 = aes256_encrypt_plain(aes17, torch.stack([sb, spb]))
    es1, ev1 = e1[0] ^ sb, e1[1] ^ spb
    if mode == MODE_G2:  # the lam = 32 PRG masks block 1 of its children
        sb, spb, es1, ev1 = (x & mask for x in (sb, spb, es1, ev1))
    return (torch.cat([es0, sb], -1), torch.cat([sa, es1], -1),
            torch.cat([ev0, spb], -1), torch.cat([spa, ev1], -1), tl, tr)


def keygen_walk_plain(aes, alphas, betas, s0s, *, mode: int, lt: bool = True):
    """Plain PyTorch version of kernels G1 (``mode=MODE_G1``), B7a, B7b and
    G2: the outputs of ``keygen_dcf16``, ``keygen_narrow``, ``keygen_dpf``
    and ``keygen_dcf32`` (bytes 32.. of B7a's rows zero).  ``lt``: the
    bound is LT_BETA."""
    k_num, n = alphas.shape[0], 8 * alphas.shape[1]
    lam = betas.shape[1]
    w = 16 if mode == MODE_G1 else NARROW
    has_v = mode != MODE_B7B
    dev = alphas.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device=dev)

    cw_s, cw_t = zeros(k_num, n, lam), zeros(k_num, n, 2)
    cw_v = zeros(k_num, n, lam) if has_v else None
    traj = zeros(k_num, n, 2) if mode == MODE_B7A else None
    sa, sb = s0s[:, 0, :w].clone(), s0s[:, 1, :w].clone()
    va, beta = zeros(k_num, w), betas[:, :w]
    ta = zeros(k_num)  # party 0 starts at t = 0, party 1 at t = 1
    tb = torch.ones_like(ta)
    bits = walk_bits_plain(alphas)  # [K, n], MSB first
    for i in range(n):
        if traj is not None:
            traj[:, i, 0], traj[:, i, 1] = ta, tb
        a_sl, a_sr, a_vl, a_vr, a_tl, a_tr = _expand_plain(aes, sa, mode)
        b_sl, b_sr, b_vl, b_vr, b_tl, b_tr = _expand_plain(aes, sb, mode)
        a = bits[:, i]
        keep_r = a.bool()  # alpha's bit 1 keeps the right child
        am = (a * 0xFF)[:, None]
        nam = ~am

        def mux(if_one, if_zero):
            return (if_one & am) | (if_zero & nam)

        cs = mux(a_sl ^ b_sl, a_sr ^ b_sr)  # the lost children's XOR
        if has_v:
            dl, dr = a_vl ^ b_vl, a_vr ^ b_vr
            cv = mux(dl, dr) ^ va ^ (beta & (am if lt else nam))
            va = va ^ mux(dr, dl) ^ cv
            cw_v[:, i, :w] = cv
        tl_cw = a_tl ^ b_tl ^ a ^ 1
        tr_cw = a_tr ^ b_tr ^ a
        t_keep = torch.where(keep_r, tr_cw, tl_cw)
        sa = mux(a_sr, a_sl) ^ (cs & (ta * 0xFF)[:, None])
        sb = mux(b_sr, b_sl) ^ (cs & (tb * 0xFF)[:, None])
        ta = torch.where(keep_r, a_tr, a_tl) ^ (ta & t_keep)
        tb = torch.where(keep_r, b_tr, b_tl) ^ (tb & t_keep)
        cw_s[:, i, :w] = cs
        cw_t[:, i, 0], cw_t[:, i, 1] = tl_cw, tr_cw
    cw_np1 = zeros(k_num, lam)
    cw_np1[:, :w] = sa ^ sb ^ (va if has_v else beta)
    if mode in (MODE_G1, MODE_G2):
        return cw_s, cw_v, cw_t, cw_np1
    if mode == MODE_B7A:
        return cw_s, cw_v, cw_t, cw_np1, traj
    return cw_s, cw_t, cw_np1


def keygen_wide_tail_plain(cw_s, cw_v, cw_np1, traj, alphas, betas, s0s, *,
                           lt: bool = True) -> None:
    """Plain PyTorch version of kernel W2: bytes 32..lam-1 of B7a's keys,
    in place, from its trajectories.

    Beyond byte 32 the Hirose PRG of lam >= 48 is a copy of its input, so
    the wide part is a GF(2) recursion in alpha's bits and the two
    trajectories (``_keygen_wide_tail`` in ``dcf_tpu/ops/pallas_keygen.py``):
    per level, with ``mask`` clearing the PRG's bit 8*lam-1 (byte lam-1,
    bit 0),

        s_cw = mask(s_a ^ s_b)              (lose side == keep side)
        v_cw = s_cw ^ v ^ beta * gate
        v'   = v ^ s_cw ^ v_cw              (v_l == v_r)
        s_p' = mask(s_p) ^ s_cw * t_p       (p in {a, b})

    and cw_np1 = s_a ^ s_b ^ v after the last level.  Runs as n levels of
    torch ops on the tensors' device."""
    k_num, n, lam = cw_s.shape
    wd = lam - NARROW
    mask = torch.full((wd,), 0xFF, dtype=torch.uint8, device=cw_s.device)
    mask[wd - 1] = 0xFE
    s_a = s0s[:, 0, NARROW:].clone()
    s_b = s0s[:, 1, NARROW:].clone()
    v = torch.zeros_like(s_a)
    beta = betas[:, NARROW:]
    bits = walk_bits_plain(alphas)
    if not lt:
        bits = bits ^ 1
    for i in range(n):
        sx = (s_a ^ s_b) & mask
        v_cw = sx ^ v ^ (beta * bits[:, i, None])
        v = v ^ sx ^ v_cw
        s_a = (s_a & mask) ^ (sx * traj[:, i, 0, None])
        s_b = (s_b & mask) ^ (sx * traj[:, i, 1, None])
        cw_s[:, i, NARROW:] = sx
        cw_v[:, i, NARROW:] = v_cw
    cw_np1[:, NARROW:] = s_a ^ s_b ^ v


# --------------------------------------------------------------------------
# The CUDA kernels.
# --------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(aes, alphas, betas, s0s, image_bytes: int, lam_ok) -> tuple:
    device = alphas.device
    if alphas.dim() != 2 or betas.dim() != 2:
        raise ShapeError("alphas must be [K, n/8] and betas [K, lam]")
    k_num, nb = alphas.shape
    lam = betas.shape[1]
    check_u8("aes", aes, (image_bytes,), device)
    check_u8("alphas", alphas, (k_num, nb), device)
    check_u8("betas", betas, (k_num, lam), device)
    check_u8("s0s", s0s, (k_num, 2, lam), device)
    if k_num < 1 or nb < 1 or not lam_ok(lam):
        raise ShapeError(f"bad keygen geometry: K={k_num}, n={8 * nb}, "
                         f"lam={lam}")
    if device.type not in ("cuda", "cpu"):
        raise ShapeError(f"keygen runs on cuda or cpu, not {device}")
    return device, k_num, 8 * nb, lam


def _launch(aes, alphas, betas, s0s, device, k_num: int, n: int, lam: int,
            mode: int, lt: bool):
    def empty(*shape):
        return torch.empty(shape, dtype=torch.uint8, device=device)

    cw_s, cw_t, cw_np1 = empty(k_num, n, lam), empty(k_num, n, 2), \
        empty(k_num, lam)
    cw_v = empty(k_num, n, lam) if mode != MODE_B7B else None
    traj = empty(k_num, n, 2) if mode == MODE_B7A else None
    fn = _build.load("keygen_walk", "dcf_keygen_walk", _ARGTYPES)
    a = aes.data_ptr()
    launch_checked("keygen_walk", fn, device, a, a + 256,
                   a + 496 if mode != MODE_G1 else a + 256,
                   alphas.data_ptr(), betas.data_ptr(), s0s.data_ptr(),
                   cw_s.data_ptr(), cw_v.data_ptr() if cw_v is not None else 0,
                   cw_t.data_ptr(), cw_np1.data_ptr(),
                   traj.data_ptr() if traj is not None else 0, k_num, n, lam,
                   int(bool(lt)), mode)
    return cw_s, cw_v, cw_t, cw_np1, traj


def keygen_dcf16(aes, alphas, betas, s0s, *, lt: bool = True):
    """K DCF keys at lam = 16: (cw_s, cw_v [K, n, 16], cw_t [K, n, 2],
    cw_np1 [K, 16]).  aes uint8 [496] (``ops.walk_eval.aes_image``).  The
    card launches kernel G1, the CPU runs ``keygen_walk_plain``."""
    device, k_num, n, lam = _check(aes, alphas, betas, s0s,
                                   AES_IMAGE_BYTES, lambda lam: lam == 16)
    if device.type == "cpu":
        return keygen_walk_plain(aes, alphas, betas, s0s, mode=MODE_G1, lt=lt)
    out = _launch(aes, alphas, betas, s0s, device, k_num, n, lam, MODE_G1, lt)
    keygen_dcf16.launches += 1
    return out[:4]


keygen_dcf16.launches = 0  # kernel G1 launches in this process


def keygen_dcf32(aes, alphas, betas, s0s, *, lt: bool = True):
    """K DCF keys at lam = 32, XOR group: (cw_s, cw_v [K, n, 32], cw_t
    [K, n, 2], cw_np1 [K, 32]).  aes uint8 [736]
    (``ops.narrow_walk.narrow_aes_image``).  The card launches kernel G2,
    the CPU runs ``keygen_walk_plain``."""
    device, k_num, n, lam = _check(aes, alphas, betas, s0s, NARROW_AES_BYTES,
                                   lambda lam: lam == NARROW)
    if device.type == "cpu":
        return keygen_walk_plain(aes, alphas, betas, s0s, mode=MODE_G2, lt=lt)
    out = _launch(aes, alphas, betas, s0s, device, k_num, n, lam, MODE_G2, lt)
    keygen_dcf32.launches += 1
    return out[:4]


keygen_dcf32.launches = 0  # kernel G2 launches in this process


def keygen_narrow(aes, alphas, betas, s0s, *, lt: bool = True):
    """The narrow part of K DCF keys at lam >= 48: (cw_s, cw_v [K, n, lam],
    cw_t [K, n, 2], cw_np1 [K, lam], traj [K, n, 2]), bytes 0..31 of each
    row written (``keygen_wide_tail`` fills the rest).  aes uint8 [736]
    (``ops.narrow_walk.narrow_aes_image``).  The card launches kernel B7a,
    the CPU runs ``keygen_walk_plain``."""
    device, k_num, n, lam = _check(aes, alphas, betas, s0s, NARROW_AES_BYTES,
                                   lambda lam: lam >= 48 and lam % 16 == 0)
    if device.type == "cpu":
        return keygen_walk_plain(aes, alphas, betas, s0s, mode=MODE_B7A,
                                 lt=lt)
    out = _launch(aes, alphas, betas, s0s, device, k_num, n, lam, MODE_B7A,
                  lt)
    keygen_narrow.launches += 1
    return out[0], out[1], out[2], out[3], out[4]


keygen_narrow.launches = 0  # kernel B7a launches in this process


def keygen_dpf(aes, alphas, betas, s0s):
    """K DPF keys at lam = 32: (cw_s [K, n, 32], cw_t [K, n, 2], cw_np1
    [K, 32]).  aes uint8 [736].  The card launches kernel B7b, the CPU runs
    ``keygen_walk_plain``."""
    device, k_num, n, lam = _check(aes, alphas, betas, s0s, NARROW_AES_BYTES,
                                   lambda lam: lam == NARROW)
    if device.type == "cpu":
        return keygen_walk_plain(aes, alphas, betas, s0s, mode=MODE_B7B)
    cw_s, _, cw_t, cw_np1, _ = _launch(aes, alphas, betas, s0s, device, k_num,
                                       n, lam, MODE_B7B, True)
    keygen_dpf.launches += 1
    return cw_s, cw_t, cw_np1


keygen_dpf.launches = 0  # kernel B7b launches in this process


_WIDE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def keygen_wide_tail(cw_s, cw_v, cw_np1, traj, alphas, betas, s0s, *,
                     lt: bool = True) -> None:
    """Bytes 32..lam-1 of B7a's keys (``keygen_narrow``'s cw_s, cw_v,
    cw_np1 and traj), in place.  The card launches kernel W2, the CPU runs
    ``keygen_wide_tail_plain``."""
    device = cw_s.device
    if cw_s.dim() != 3 or alphas.dim() != 2:
        raise ShapeError("cw_s must be [K, n, lam] and alphas [K, n/8]")
    k_num, n, lam = cw_s.shape
    if k_num < 1 or n < 8 or n % 8 or lam < 48 or lam % 16:
        raise ShapeError(f"bad wide tail geometry: K={k_num}, n={n}, "
                         f"lam={lam}")
    if device.type == "cpu":
        keygen_wide_tail_plain(cw_s, cw_v, cw_np1, traj, alphas, betas, s0s,
                               lt=lt)
        return
    if device.type != "cuda":
        raise ShapeError(f"keygen runs on cuda or cpu, not {device}")
    for name, t, shape, align in (
            ("cw_s", cw_s, (k_num, n, lam), 16),
            ("cw_v", cw_v, (k_num, n, lam), 16),
            ("cw_np1", cw_np1, (k_num, lam), 16),
            ("traj", traj, (k_num, n, 2), 16),
            ("alphas", alphas, (k_num, n // 8), 1),
            ("betas", betas, (k_num, lam), 16),
            ("s0s", s0s, (k_num, 2, lam), 16)):
        check_u8(name, t, shape, device, align)
    fn = _build.load("keygen_wide", "dcf_keygen_wide", _WIDE_ARGTYPES)
    launch_checked("keygen_wide", fn, device, alphas.data_ptr(),
                   betas.data_ptr(), s0s.data_ptr(), traj.data_ptr(),
                   cw_s.data_ptr(), cw_v.data_ptr(), cw_np1.data_ptr(),
                   k_num, n, lam, int(bool(lt)))
    keygen_wide_tail.launches += 1


keygen_wide_tail.launches = 0  # kernel W2 launches in this process
