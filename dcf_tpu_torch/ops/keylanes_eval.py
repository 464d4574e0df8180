"""Kernel B8, the many-keys DCF evaluation at lam = 16, and its plain
version.

Counterpart of ``dcf_tpu/ops/pallas_keylanes.py``
(``dcf_eval_keylanes_pallas``): party-b shares of K keys at M points
shared by all keys, XOR group, the secure-ReLU shape (BASELINE.json
config 5: 10^6 keys x 1024 points).  The TPU kernel packs 32 keys per lane
word and carries a tile's state through HBM every ``level_chunk`` levels;
the port keeps the keys in lanes and drops the carry.

What bounds the kernel on the card is the AES table lookups in shared
memory.  ``csrc/keylanes_eval.cu`` runs them on the banked table of
``csrc/aes_banked.cuh`` (T0 and T2 once for each of a warp's 32 lanes:
a warp's lookups are one wavefront, not the ~3.3 that random indices cost
in four 1 KB tables, and one byte permute forms each address), and walks
32 keys at shared points a warp, so that every lane turns the same way at
every level and a right turn encrypts one block, to its t bit, not two.
Each warp walks two points at a time, their blocks in lockstep.  A block
of 16 warps stages its 32 keys' correction words in shared memory once,
transposed into the lanes' banks, and takes the M points in a stride
loop; a persistent grid takes groups of 32 keys, and splits the groups
of the last wave by points.  Its first design (one thread a (key,
point), kernel B1's walk) reached 23% of the lookup bound on an NVIDIA
H100 80GB HBM3 at a 700 W power limit (``chip_smoke.py``).

It reads the key image as kernel G1 writes it (``ops.keygen_walk``):
s0s uint8 [K, 2, 16] with both parties' seeds, cw_s / cw_v [K, n, 16],
cw_t [K, n, 2], cw_np1 [K, 16].  ``keylanes_eval`` launches the kernel for
tensors on the card and runs ``keylanes_eval_plain`` (kernel B1's plain
version on party b's seeds) for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, launch_checked
from dcf_tpu_torch.ops.walk_eval import AES_IMAGE_BYTES, walk_eval_plain

__all__ = ["keylanes_eval_plain", "keylanes_eval"]


def keylanes_eval_plain(aes, s0s, cw_s, cw_v, cw_t, cw_np1, xs, *,
                        b: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B8 (same arguments as
    ``keylanes_eval``)."""
    return walk_eval_plain(aes, s0s[:, b], cw_s, cw_v, cw_t, cw_np1, xs, b=b,
                           group="xor")


_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def keylanes_eval(aes, s0s, cw_s, cw_v, cw_t, cw_np1, xs, *,
                  b: int) -> torch.Tensor:
    """Party ``b``'s XOR shares of K keys at M shared points: uint8
    [K, M, 16].

    aes uint8 [496] (``ops.walk_eval.aes_image``); s0s [K, 2, 16] (both
    parties' seeds; party b's are read); cw_s / cw_v [K, n, 16]; cw_t
    [K, n, 2] (0/1); cw_np1 [K, 16]; xs [1, M, n/8].  The card launches
    kernel B8, the CPU runs ``keylanes_eval_plain``."""
    device = s0s.device
    k_num = s0s.shape[0]
    n = cw_s.shape[1] if cw_s.dim() == 3 else -1
    m = xs.shape[1] if xs.dim() == 3 else -1
    check_u8("aes", aes, (AES_IMAGE_BYTES,), device)
    check_u8("s0s", s0s, (k_num, 2, 16), device, align=16)
    check_u8("cw_s", cw_s, (k_num, n, 16), device, align=16)
    check_u8("cw_v", cw_v, (k_num, n, 16), device, align=16)
    check_u8("cw_t", cw_t, (k_num, n, 2), device)
    check_u8("cw_np1", cw_np1, (k_num, 16), device, align=16)
    check_u8("xs", xs, (1, m, n // 8), device)
    if n < 8 or n % 8 or b not in (0, 1):
        raise ShapeError(f"bad keylanes geometry: n={n}, b={b}")
    if device.type == "cpu":
        return keylanes_eval_plain(aes, s0s, cw_s, cw_v, cw_t, cw_np1, xs,
                                   b=b)
    if device.type != "cuda":
        raise ShapeError(f"keylanes_eval runs on cuda or cpu, not {device}")
    y = torch.empty((k_num, m, 16), dtype=torch.uint8, device=device)
    if m == 0 or k_num == 0:
        return y
    fn = _build.load("keylanes_eval", "dcf_keylanes_eval", _ARGTYPES)
    a = aes.data_ptr()
    launch_checked("keylanes_eval", fn, device, a, a + 256, s0s.data_ptr(),
                   cw_s.data_ptr(), cw_v.data_ptr(), cw_t.data_ptr(),
                   cw_np1.data_ptr(), xs.data_ptr(), y.data_ptr(), k_num, n,
                   m, int(b))
    keylanes_eval.launches += 1
    return y


keylanes_eval.launches = 0  # kernel B8 launches in this process
