"""Kernel B1, the from-root DCF walk at lam = 16, and its plain version.

Counterpart of ``dcf_tpu/ops/pallas_eval.py`` (``dcf_eval_pallas``, its
``_kernel`` and ``walk_levels``).  The TPU kernel walks bit planes of 32
points per lane word; this port keeps the bytes at the edges and nothing
of that layout: the state of a walk is 16 bytes, and on the card a lane
owns two (key, point) walks whose AES blocks the warp deals out among
its lanes (``csrc/walk_eval.cu``, sharing its level loop with kernel B3
in ``csrc/aes_banked.cuh``).

``walk_eval`` launches the CUDA kernel for tensors on the card and runs
``walk_eval_plain`` -- the same function in plain PyTorch ops, S-box by
indexing and xtime by shifts -- for tensors on the CPU.  There is no
fallback from one to the other.

The plain pieces (AES, Hirose step, group add, level loop) are shared
with the plain versions of kernels B2 and B3.

Cipher image: the S-box (256 bytes) followed by the 15 AES-256 round keys
(240 bytes) of cipher 0, uint8 [496] (``aes_image``).  It is built once
per backend and passed to every kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, key_slices, launch_checked
from dcf_tpu_torch.ops.aes import SBOX_NP, SHIFT_ROWS_NP, expand_key_np
from dcf_tpu_torch.utils.groups import group_width

__all__ = [
    "aes_image",
    "aes256_encrypt_plain",
    "hirose_expand_plain",
    "group_add_plain",
    "group_neg_plain",
    "walk_bits_plain",
    "walk_levels_plain",
    "finalize_plain",
    "walk_eval_plain",
    "walk_eval",
]

AES_IMAGE_BYTES = 256 + 15 * 16

# Bit 0 of byte 15 is the Hirose PRG's masked output bit 8*lam-1.
_BYTE15_MASK = np.full(16, 0xFF, dtype=np.uint8)
_BYTE15_MASK[15] = 0xFE


def aes_image(cipher_key: bytes) -> np.ndarray:
    """uint8 [496]: the AES S-box, then the 15 round keys of ``cipher_key``."""
    return np.concatenate([SBOX_NP, expand_key_np(cipher_key).reshape(-1)])


# --------------------------------------------------------------------------
# Plain PyTorch versions (uint8 and int64 arithmetic only: on the CPU,
# PyTorch has no uint32 right shift and int32 >> is arithmetic).
# --------------------------------------------------------------------------

def _xtime(a: torch.Tensor) -> torch.Tensor:
    """GF(2^8) multiply-by-2 on uint8 tensors (the shift wraps in uint8)."""
    return (a << 1) ^ ((a >> 7) * 0x1B)


def aes256_encrypt_plain(aes: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """AES-256 of uint8 [..., 16] blocks with the cipher image ``aes``."""
    sbox = aes[:256]
    rk = aes[256:].view(15, 16)
    shift = torch.as_tensor(SHIFT_ROWS_NP, device=blocks.device)
    s = blocks ^ rk[0]
    for rnd in range(1, 14):
        s = sbox[s.long()][..., shift]
        a0, a1, a2, a3 = s.view(*s.shape[:-1], 4, 4).unbind(-1)
        x0, x1, x2, x3 = _xtime(a0), _xtime(a1), _xtime(a2), _xtime(a3)
        s = torch.stack([x0 ^ x1 ^ a1 ^ a2 ^ a3,
                         a0 ^ x1 ^ x2 ^ a2 ^ a3,
                         a0 ^ a1 ^ x2 ^ x3 ^ a3,
                         x0 ^ a0 ^ a1 ^ a2 ^ x3], dim=-1)
        s = s.view(blocks.shape) ^ rk[rnd]
    s = sbox[s.long()][..., shift]
    return s ^ rk[14]


def hirose_expand_plain(aes: torch.Tensor, s: torch.Tensor):
    """One Hirose PRG call on uint8 [..., 16] seeds (lam = 16).

    Returns (s_l, v_l, t_l, s_r, v_r, t_r): s_l = E(s)^s, v_l = E(~s)^~s,
    s_r = s, v_r = ~s, with bit 0 of byte 15 cleared; t_l/t_r are bit 0 of
    byte 0 of s_l/v_l before masking (uint8 0/1)."""
    sp = ~s
    enc = aes256_encrypt_plain(aes, torch.stack([s, sp]))
    sl = enc[0] ^ s
    vl = enc[1] ^ sp
    mask = torch.as_tensor(_BYTE15_MASK, device=s.device)
    return (sl & mask, vl & mask, sl[..., 0] & 1,
            s & mask, sp & mask, vl[..., 0] & 1)


def _lane_shifts(gw: int, device) -> torch.Tensor:
    return 8 * torch.arange(gw // 8, device=device, dtype=torch.int64)


def _lanes(a: torch.Tensor, gw: int) -> torch.Tensor:
    """uint8 [..., L] -> int64 little-endian gw-bit lanes [..., 8L/gw]."""
    b = a.long().reshape(*a.shape[:-1], -1, gw // 8)
    return (b << _lane_shifts(gw, a.device)).sum(-1)


def _from_lanes(lanes: torch.Tensor, gw: int) -> torch.Tensor:
    """Inverse of ``_lanes`` for lanes already reduced mod 2^gw."""
    b = (lanes.unsqueeze(-1) >> _lane_shifts(gw, lanes.device)) & 0xFF
    return b.to(torch.uint8).reshape(*lanes.shape[:-1], -1)


def group_add_plain(a: torch.Tensor, b: torch.Tensor, gw: int) -> torch.Tensor:
    """Group add on uint8 payloads (broadcasting): XOR or lane-wise mod 2^gw."""
    if gw == 0:
        return a ^ b
    return _from_lanes((_lanes(a, gw) + _lanes(b, gw)) & ((1 << gw) - 1), gw)


def group_neg_plain(a: torch.Tensor, gw: int) -> torch.Tensor:
    """Group negation on uint8 payloads (identity for XOR)."""
    if gw == 0:
        return a
    return _from_lanes((-_lanes(a, gw)) & ((1 << gw) - 1), gw)


def walk_bits_plain(xs: torch.Tensor) -> torch.Tensor:
    """uint8 points [..., nb] -> walk bits uint8 [..., 8*nb], MSB-first."""
    shifts = torch.arange(7, -1, -1, device=xs.device, dtype=torch.uint8)
    bits = (xs.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*xs.shape[:-1], xs.shape[-1] * 8)


def walk_levels_plain(aes, s, t, v, cw_s, cw_v, cw_t, x_bits, gw: int):
    """Walk the levels of ``cw_*`` from the carry (s, t, v).

    s/v: uint8 [K, M, 16]; t: uint8 [K, M] in {0, 1}; cw_s/cw_v: uint8
    [K, L, 16]; cw_t: uint8 [K, L, 2]; x_bits: uint8 [1 or K, M, L], the
    walk bits of these L levels.  v accumulates unsigned in the group."""
    for i in range(cw_s.shape[1]):
        sl, vl, tl, sr, vr, tr = hirose_expand_plain(aes, s)
        g = t.unsqueeze(-1) * 0xFF  # 0x00 or 0xFF per (key, point)
        cs = cw_s[:, i, None, :] & g
        cv = cw_v[:, i, None, :] & g
        tl = tl ^ (t & cw_t[:, i, 0, None])
        tr = tr ^ (t & cw_t[:, i, 1, None])
        xb = x_bits[:, :, i].bool()
        xm = xb.unsqueeze(-1)
        v = group_add_plain(v, group_add_plain(
            torch.where(xm, vr, vl), cv, gw), gw)
        s = torch.where(xm, sr ^ cs, sl ^ cs)
        t = torch.where(xb, tr, tl)
    return s, t, v


def finalize_plain(s, t, v, cw_np1, gw: int, negate: bool):
    """y = v + s + t*cw_np1 in the group, negated for party 1 when asked."""
    g = t.unsqueeze(-1) * 0xFF
    y = group_add_plain(v, group_add_plain(s, cw_np1[:, None, :] & g, gw), gw)
    return group_neg_plain(y, gw) if negate else y


def walk_eval_plain(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, *, b: int,
                    group: str) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (same arguments as ``walk_eval``)."""
    gw = group_width(group)
    k_num = s0.shape[0]
    m = xs.shape[1]
    s = s0[:, None, :].expand(k_num, m, 16)
    t = torch.full((k_num, m), int(b), dtype=torch.uint8, device=s0.device)
    v = torch.zeros((k_num, m, 16), dtype=torch.uint8, device=s0.device)
    s, t, v = walk_levels_plain(aes, s, t, v, cw_s, cw_v, cw_t,
                                walk_bits_plain(xs), gw)
    return finalize_plain(s, t, v, cw_np1, gw, negate=bool(b) and gw > 0)


# --------------------------------------------------------------------------
# The CUDA kernel.
# --------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def walk_eval(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, *, b: int,
              group: str) -> torch.Tensor:
    """Party ``b`` DCF shares of K keys at M points: uint8 [K, M, 16].

    aes uint8 [496] (``aes_image``); s0 [K, 16]; cw_s/cw_v [K, n, 16];
    cw_t [K, n, 2] (0/1); cw_np1 [K, 16]; xs [1 or K, M, n/8] (points
    shared by all keys, or per key).  All tensors on one device: the card
    launches kernel B1, the CPU runs ``walk_eval_plain``.  Additive groups
    come out as signed shares (party 1 negated)."""
    device = s0.device
    k_num = s0.shape[0]
    n = cw_s.shape[1] if cw_s.dim() == 3 else -1
    kx, m = xs.shape[0], xs.shape[1]
    check_u8("aes", aes, (AES_IMAGE_BYTES,), device)
    check_u8("s0", s0, (k_num, 16), device, align=16)
    check_u8("cw_s", cw_s, (k_num, n, 16), device, align=16)
    check_u8("cw_v", cw_v, (k_num, n, 16), device, align=16)
    check_u8("cw_t", cw_t, (k_num, n, 2), device)
    check_u8("cw_np1", cw_np1, (k_num, 16), device, align=16)
    check_u8("xs", xs, (kx, m, n // 8), device)
    if n < 8 or n % 8 or kx not in (1, k_num) or b not in (0, 1):
        raise ShapeError(f"bad walk geometry: n={n}, Kx={kx}, K={k_num}, b={b}")
    if device.type == "cpu":
        return walk_eval_plain(aes, s0, cw_s, cw_v, cw_t, cw_np1, xs, b=b,
                               group=group)
    if device.type != "cuda":
        raise ShapeError(f"walk_eval runs on cuda or cpu, not {device}")
    gw = group_width(group)
    y = torch.empty((k_num, m, 16), dtype=torch.uint8, device=device)
    if m == 0:
        return y
    fn = _build.load("walk_eval", "dcf_walk_eval", _ARGTYPES)
    a = aes.data_ptr()
    per_key = int(kx == k_num and k_num > 1)
    for k0, kk in key_slices(k_num):
        launch_checked("walk_eval", fn, device, a, a + 256,
                       s0.data_ptr() + k0 * 16,
                       cw_s.data_ptr() + k0 * n * 16,
                       cw_v.data_ptr() + k0 * n * 16,
                       cw_t.data_ptr() + k0 * n * 2,
                       cw_np1.data_ptr() + k0 * 16,
                       xs.data_ptr() + per_key * k0 * m * (n // 8),
                       y.data_ptr() + k0 * m * 16, kk, n, m, per_key, int(b),
                       int(bool(b) and gw > 0), gw)
        walk_eval.launches += 1
    return y


walk_eval.launches = 0  # kernel B1 launches in this process
