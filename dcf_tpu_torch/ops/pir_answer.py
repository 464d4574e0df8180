"""Kernel P1, the PIR answer: the GF(2) inner product of K selection-vector
shares with the database, and its plain version.

Counterpart of ``_pir_answer_device`` in ``dcf_tpu/workloads/pir.py`` (its
lines 110-124), which the JAX package leaves to XLA as
``popcount(t_word & db_plane) mod 2`` over a database packed into bit
planes.  Here the database stays as record bytes in leaf (bitreverse)
order, uint8 [N, R], and

    answer[k] = XOR over positions p with t[k, p] = 1 of db[p]

which is the same parity per bit.  t is one byte (0/1) per (key,
position), uint8 [K, N], as kernel B6 writes it.  All K keys are served
in one pass over the database.

``pir_answer`` launches the CUDA kernel (``csrc/pir_answer.cu``) for
tensors on the card and runs ``pir_answer_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, launch_checked

__all__ = ["pir_answer_plain", "pir_answer"]

_PLAIN_CHUNK = 1 << 16  # rows per step of the plain version's XOR fold


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of uint8 [K, L, R] -> [K, R], by halving (PyTorch
    has no XOR reduction)."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[2])], 1)
        half = x.shape[1] // 2
        x = x[:, :half] ^ x[:, half:]
    return x[:, 0]


def pir_answer_plain(t: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel P1 (same arguments as
    ``pir_answer``): the selected rows, XOR-folded chunk by chunk."""
    out = torch.zeros((t.shape[0], db.shape[1]), dtype=torch.uint8,
                      device=db.device)
    for lo in range(0, db.shape[0], _PLAIN_CHUNK):
        rows = db[None, lo:lo + _PLAIN_CHUNK]
        sel = (t[:, lo:lo + _PLAIN_CHUNK, None] & 1) * 0xFF
        out ^= _xor_fold(rows & sel)
    return out


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_BLOCKS_PER_SM = 16  # resident 256-thread blocks that cover the card


def pir_answer(t: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Answer shares of K queries: uint8 [K, R].

    t uint8 [K, N] (0/1), one party's selection-vector shares in leaf
    order; db uint8 [N, R], the records in the same order, R a multiple
    of 4 up to 1024.  The card launches kernel P1, the CPU runs
    ``pir_answer_plain``."""
    device = db.device
    if t.dim() != 2 or db.dim() != 2:
        raise ShapeError("t must be [K, N] and db [N, R]")
    k_num, n_rows = t.shape
    r = db.shape[1]
    check_u8("t", t, (k_num, n_rows), device)
    check_u8("db", db, (n_rows, r), device, align=4)
    if k_num < 1 or n_rows < 1 or r < 4 or r % 4 or r > 1024:
        raise ShapeError(f"bad PIR geometry: {k_num} keys, {n_rows} records "
                         f"of {r} bytes (a multiple of 4 up to 1024)")
    if device.type == "cpu":
        return pir_answer_plain(t, db)
    if device.type != "cuda":
        raise ShapeError(f"pir_answer runs on cuda or cpu, not {device}")
    out = torch.zeros((k_num, r), dtype=torch.uint8, device=device)
    rw = r // 4
    rows_per_pass = 256 // rw
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(-(-n_rows // rows_per_pass), sms * _BLOCKS_PER_SM))
    fn = _build.load("pir_answer", "dcf_pir_answer", _ARGTYPES)
    launch_checked("pir_answer", fn, device, t.data_ptr(), db.data_ptr(),
                   out.data_ptr(), k_num, n_rows, rw, blocks)
    pir_answer.launches += 1
    return out


pir_answer.launches = 0  # kernel P1 launches in this process
