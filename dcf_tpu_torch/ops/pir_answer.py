"""Kernel P1, the PIR answer: the GF(2) inner product of K selection-vector
shares with the database, and its plain version.

Counterpart of ``_pir_answer_device`` in ``dcf_tpu/workloads/pir.py`` (its
lines 110-124), which the JAX package leaves to XLA as
``popcount(t_word & db_plane) mod 2`` over a database packed into bit
planes.  Here the database stays as record bytes in leaf (bitreverse)
order, uint8 [N, R], and

    answer[k] = XOR over rows p with bit p of t[k] set of db[p]

which is the same parity per bit.  The selection is packed as the
reference packs it (``t_words``, ``dcf_tpu/utils/bits.py``
``pack_lanes``): int32 [K, ceil(N / 32)], bit i of word w the bit of row
32 w + i, least significant first, as kernel B6's t-only launch writes it
(``pack_selection`` packs bytes the same way).  All K keys are served in
one pass over the database.

``pir_answer`` launches the CUDA kernel (``csrc/pir_answer.cu``, per-lane
code in ``csrc/pir_answer.cuh``) for tensors on the card and runs
``pir_answer_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dcf_tpu_torch import _build
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops._launch import check_u8, check_words, launch_checked

__all__ = ["pack_selection", "unpack_selection", "pir_answer_plain",
           "pir_answer"]

_PLAIN_CHUNK = 1 << 16  # rows per step of the plain version's XOR fold


def pack_selection(t: torch.Tensor) -> torch.Tensor:
    """Selection bits uint8 [K, N] (0/1) -> packed words int32
    [K, ceil(N / 32)]: bit i of word w is row 32 w + i, the bits past N
    zero.  Torch ops; the card's t-only B6 launch packs its own."""
    k_num, n = t.shape
    bits = torch.nn.functional.pad(t & 1, (0, -n % 32)).view(k_num, -1, 32)
    shifts = torch.arange(32, device=t.device, dtype=torch.int64)
    words = (bits.to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_selection(t_words: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``pack_selection``: int32 [K, ceil(n / 32)] ->
    uint8 [K, n] (0/1)."""
    shifts = torch.arange(32, device=t_words.device, dtype=torch.int32)
    bits = (t_words.unsqueeze(-1) >> shifts) & 1
    return bits.to(torch.uint8).reshape(t_words.shape[0], -1)[:, :n]


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of uint8 [K, L, R] -> [K, R], by halving (PyTorch
    has no XOR reduction)."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[2])], 1)
        half = x.shape[1] // 2
        x = x[:, :half] ^ x[:, half:]
    return x[:, 0]


def pir_answer_plain(t_words: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel P1 (same arguments as
    ``pir_answer``): the words unpacked, the selected rows XOR-folded
    chunk by chunk."""
    t = unpack_selection(t_words, db.shape[0])
    out = torch.zeros((t.shape[0], db.shape[1]), dtype=torch.uint8,
                      device=db.device)
    for lo in range(0, db.shape[0], _PLAIN_CHUNK):
        rows = db[None, lo:lo + _PLAIN_CHUNK]
        sel = t[:, lo:lo + _PLAIN_CHUNK, None] * 0xFF
        out ^= _xor_fold(rows & sel)
    return out


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p])


def pir_answer(t_words: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Answer shares of K queries: uint8 [K, R].

    t_words int32 [K, ceil(N / 32)], one party's selection-vector shares
    packed in leaf order; db uint8 [N, R], the records in the same order,
    R a multiple of 4 up to 1024 (on the card 16-byte aligned where R is
    a multiple of 16).  The card launches kernel P1, the CPU runs
    ``pir_answer_plain``."""
    device = db.device
    if t_words.dim() != 2 or db.dim() != 2:
        raise ShapeError("t_words must be [K, ceil(N / 32)] and db [N, R]")
    k_num = t_words.shape[0]
    n_rows, r = db.shape
    check_words("t_words", t_words, (k_num, -(-n_rows // 32)), device)
    check_u8("db", db, (n_rows, r), device, align=16 if r % 16 == 0 else 4)
    if k_num < 1 or n_rows < 1 or r < 4 or r % 4 or r > 1024:
        raise ShapeError(f"bad PIR geometry: {k_num} keys, {n_rows} records "
                         f"of {r} bytes (a multiple of 4 up to 1024)")
    if device.type == "cpu":
        return pir_answer_plain(t_words, db)
    if device.type != "cuda":
        raise ShapeError(f"pir_answer runs on cuda or cpu, not {device}")
    out = torch.zeros((k_num, r), dtype=torch.uint8, device=device)
    fn = _build.load("pir_answer", "dcf_pir_answer", _ARGTYPES)
    launch_checked("pir_answer", fn, device, t_words.data_ptr(),
                   db.data_ptr(), out.data_ptr(), k_num, n_rows, r)
    pir_answer.launches += 1
    return out


pir_answer.launches = 0  # kernel P1 launches in this process
