"""Kernel B4, the narrow walk of the large-lambda hybrid, and its plain
version.

Counterpart of ``dcf_tpu/ops/pallas_narrow.py`` (``dcf_narrow_walk_pallas``
and its Pallas helpers ``narrow_prg_expand`` and ``narrow_walk_levels``,
here ``narrow_levels_plain``).  For lam >= 48 a DCF
evaluation splits into a 32-byte narrow walk -- the first two blocks of
the Hirose PRG, cipher 0 on block 0 and cipher 17 on block 1, without the
final-bit mask -- and a GF(2) affine wide part over the walk's gate bits
(``ops.wide_tail``, kernel W1).  This module is the narrow walk: it
returns y[:32] inside a lam-byte output row and the (n+1)-bit trajectory
t_0 = b, the gate of every level, the final t.

``narrow_walk`` launches the CUDA kernel (``csrc/narrow_walk.cu``, per-
thread code in ``csrc/narrow_walk.cuh``) for tensors on the card and runs
``narrow_walk_plain`` for tensors on the CPU.  What bounds the kernel is
the AES table lookups in shared memory; it runs them on the banked table
of ``csrc/aes_banked.cuh`` (a warp's lookups are one wavefront), and runs
each level as three slots with per-lane inputs and round keys
(``narrow_level_banked``): a warp whose points turn both ways computes
three AES blocks a level, not four.  Its first design (four blocks a
level on four 1 KB tables) reached 19% of the lookup bound on an NVIDIA
H100 80GB HBM3 at a 700 W power limit (``chip_smoke.py``).  The plain
pieces (the two-cipher step, the level loop, the trajectory packing) are
shared with the plain versions of kernels B5a and B5b.

Cipher image: the S-box (256 bytes), then the 15 AES-256 round keys of
cipher 0 and of cipher 17 (240 bytes each), uint8 [736]
(``narrow_aes_image``).

Trajectory: bit i = t_i, packed into ``traj_bytes(n + 1)`` bytes per (key,
point), bit i in bit i % 8 of byte i // 8 -- little-endian uint32 words to
the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, key_slices, launch_checked
from dcf_tpu_torch.ops.aes import SBOX_NP, expand_key_np
from dcf_tpu_torch.ops.walk_eval import (
    aes256_encrypt_plain,
    group_add_plain,
    walk_bits_plain,
)

__all__ = [
    "NARROW",
    "NARROW_AES_BYTES",
    "narrow_aes_image",
    "traj_bytes",
    "pack_traj_plain",
    "unpack_traj_plain",
    "narrow_levels_plain",
    "narrow_walk_plain",
    "narrow_walk",
]

NARROW = 32  # bytes covered by the encrypted blocks
NARROW_AES_BYTES = 256 + 2 * 15 * 16


def narrow_aes_image(key0: bytes, key17: bytes) -> np.ndarray:
    """uint8 [736]: the AES S-box, then the round keys of ciphers 0 and 17."""
    return np.concatenate([SBOX_NP, expand_key_np(key0).reshape(-1),
                           expand_key_np(key17).reshape(-1)])


def traj_bytes(n1: int) -> int:
    """Bytes of one packed n1-bit trajectory: whole uint32 words."""
    return 4 * (-(-n1 // 32))


# --------------------------------------------------------------------------
# Plain PyTorch versions.
# --------------------------------------------------------------------------

def pack_traj_plain(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [..., L] in {0, 1} -> packed trajectories uint8
    [..., traj_bytes(L)], bit i in bit i % 8 of byte i // 8."""
    nbytes = traj_bytes(bits.shape[-1])
    pad = bits.new_zeros(*bits.shape[:-1], 8 * nbytes - bits.shape[-1])
    b = torch.cat([bits, pad], dim=-1).view(*bits.shape[:-1], nbytes, 8)
    shifts = torch.arange(8, device=bits.device, dtype=torch.uint8)
    return (b << shifts).sum(-1).to(torch.uint8)


def unpack_traj_plain(traj: torch.Tensor, n1: int) -> torch.Tensor:
    """Inverse of ``pack_traj_plain``: uint8 bits [..., n1]."""
    shifts = torch.arange(8, device=traj.device, dtype=torch.uint8)
    bits = (traj.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*traj.shape[:-1], -1)[..., :n1]


def _ciphers(aes: torch.Tensor):
    """Cipher 0's and cipher 17's [496] images from the narrow image."""
    return aes[:496], torch.cat([aes[:256], aes[496:]])


def narrow_levels_plain(aes, s, t, v, cw_s, cw_v, cw_t, x_bits, *,
                        gw: int = 0, masked: bool = False):
    """Walk the levels of ``cw_*`` from the narrow carry (s, t, v).

    s/v: uint8 [K, M, 32]; t: uint8 [K, M] in {0, 1}; cw_s/cw_v: uint8
    [K, L, 32]; cw_t: uint8 [K, L, 2]; x_bits: uint8 [1 or K, M, L].
    Returns (s, t, v, gates uint8 [K, M, L]), gates[..., i] the t that
    gated level i.  The narrow walk of lam >= 48 is unmasked and XOR
    (the defaults); the lam = 32 walk (kernel E1) clears the PRG's bit
    8*lam-1, bit 0 of byte 31, in the children before the correction
    (``masked``) and accumulates v in the group of lane width ``gw``."""
    aes0, aes17 = _ciphers(aes)
    mask = torch.full((NARROW,), 0xFF, dtype=torch.uint8, device=s.device)
    if masked:
        mask[NARROW - 1] = 0xFE
    gates = []
    for i in range(cw_s.shape[1]):
        gates.append(t)
        sa, sb = s[..., :16], s[..., 16:]
        spa, spb = ~sa, ~sb
        e0 = aes256_encrypt_plain(aes0, torch.stack([sa, spa]))
        e1 = aes256_encrypt_plain(aes17, torch.stack([sb, spb]))
        es0, ev0 = e0[0] ^ sa, e0[1] ^ spa
        es1, ev1 = e1[0] ^ sb, e1[1] ^ spb
        # Cipher 0 gives the left child's block 0, cipher 17 the right
        # child's block 1; the other blocks are feed-forward copies.
        sl, sr = torch.cat([es0, sb], -1), torch.cat([sa, es1], -1)
        vl, vr = torch.cat([ev0, spb], -1), torch.cat([spa, ev1], -1)
        g = t.unsqueeze(-1) * 0xFF
        tl = (es0[..., 0] & 1) ^ (t & cw_t[:, i, 0, None])
        tr = (ev0[..., 0] & 1) ^ (t & cw_t[:, i, 1, None])
        xb = x_bits[:, :, i].bool()
        xm = xb.unsqueeze(-1)
        v = group_add_plain(v, group_add_plain(
            torch.where(xm, vr, vl) & mask, cw_v[:, i, None, :] & g, gw), gw)
        s = (torch.where(xm, sr, sl) & mask) ^ (cw_s[:, i, None, :] & g)
        t = torch.where(xb, tr, tl)
    gates = (torch.stack(gates, -1) if gates
             else t.new_zeros(*t.shape, 0))
    return s, t, v, gates


def narrow_finalize_plain(s, t, v, cw_np1) -> torch.Tensor:
    """y[:32] = v ^ s ^ t * cw_np1[:32]."""
    return v ^ s ^ (cw_np1[:, None, :] & (t.unsqueeze(-1) * 0xFF))


def narrow_walk_plain(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, *, b: int,
                      lam: int):
    """Plain PyTorch version of kernel B4 (same arguments as
    ``narrow_walk``); bytes 32.. of y are zero."""
    k_num, m = s0.shape[0], xs.shape[1]
    s = s0[:, None, :].expand(k_num, m, NARROW)
    t = torch.full((k_num, m), int(b), dtype=torch.uint8, device=s0.device)
    v = torch.zeros((k_num, m, NARROW), dtype=torch.uint8, device=s0.device)
    s, t, v, gates = narrow_levels_plain(aes, s, t, v, cw_s, cw_v, cw_t,
                                         walk_bits_plain(xs))
    y = torch.zeros((k_num, m, lam), dtype=torch.uint8, device=s0.device)
    y[..., :NARROW] = narrow_finalize_plain(s, t, v, cw_np1)
    return y, pack_traj_plain(torch.cat([gates, t.unsqueeze(-1)], -1))


# --------------------------------------------------------------------------
# The CUDA kernel.
# --------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def check_narrow_image(aes, s0, cw_s, cw_v, cw_t, device, k_num: int,
                       n_levels: int, align: int = 1) -> None:
    """The input checks kernels B4 and B5a share: the narrow cipher image
    and the narrow key arrays of ``n_levels`` levels (s0, cw_s and cw_v
    ``align``-byte aligned on the card)."""
    check_u8("aes", aes, (NARROW_AES_BYTES,), device)
    check_u8("s0", s0, (k_num, NARROW), device, align=align)
    check_u8("cw_s", cw_s, (k_num, n_levels, NARROW), device, align=align)
    check_u8("cw_v", cw_v, (k_num, n_levels, NARROW), device, align=align)
    check_u8("cw_t", cw_t, (k_num, n_levels, 2), device)


def narrow_walk(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, *, b: int, lam: int):
    """Party ``b``'s narrow walk of K keys at M shared points.

    aes uint8 [736] (``narrow_aes_image``); s0 [K, 32]; cw_s/cw_v
    [K, n, 32]; cw_t [K, n, 2] (0/1); cw_np1 [K, 32] (the first 32 bytes
    of each key's arrays); xs [1, M, n/8].  Returns (y uint8 [K, M, lam]
    with y[..., :32] written -- the rest is kernel W1's to fill --,
    trajectories uint8 [K, M, traj_bytes(n + 1)]).  The card launches
    kernel B4, the CPU runs ``narrow_walk_plain``."""
    device = s0.device
    k_num = s0.shape[0]
    n = cw_s.shape[1] if cw_s.dim() == 3 else -1
    m = xs.shape[1]
    check_narrow_image(aes, s0, cw_s, cw_v, cw_t, device, k_num, n)
    check_u8("cw_np1", cw_np1, (k_num, NARROW), device)
    check_u8("xs", xs, (1, m, n // 8), device)
    if n < 8 or n % 8 or b not in (0, 1) or lam < 48 or lam % 16:
        raise ShapeError(f"bad narrow walk geometry: n={n}, b={b}, "
                         f"lam={lam}")
    if device.type == "cpu":
        return narrow_walk_plain(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs,
                                 b=b, lam=lam)
    if device.type != "cuda":
        raise ShapeError(f"narrow_walk runs on cuda or cpu, not {device}")
    nt = traj_bytes(n + 1)
    y = torch.empty((k_num, m, lam), dtype=torch.uint8, device=device)
    traj = torch.empty((k_num, m, nt), dtype=torch.uint8, device=device)
    if m == 0:
        return y, traj
    fn = _build.load("narrow_walk", "dcf_narrow_walk", _ARGTYPES)
    a = aes.data_ptr()
    for k0, kk in key_slices(k_num):
        launch_checked("narrow_walk", fn, device, a, a + 256, a + 496,
                       s0.data_ptr() + k0 * NARROW,
                       cw_s.data_ptr() + k0 * n * NARROW,
                       cw_v.data_ptr() + k0 * n * NARROW,
                       cw_t.data_ptr() + k0 * n * 2,
                       cw_np1.data_ptr() + k0 * NARROW, xs.data_ptr(),
                       y.data_ptr() + k0 * m * lam,
                       traj.data_ptr() + k0 * m * nt, kk, n, m, lam, nt // 4,
                       int(b))
        narrow_walk.launches += 1
    return y, traj


narrow_walk.launches = 0  # kernel B4 launches in this process
