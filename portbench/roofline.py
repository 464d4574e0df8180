"""The work a walk kernel needs, and the card's peaks: the two halves of
a kernel's share of its roofline.

A kernel's least time is the larger of its AES table lookups over the
card's lookup rate and its bytes over the card's memory rate.  The
lookups are those the *function* needs at the run's own points, not what
a kernel's design computes.  At lam = 16 a walk follows one child a level:
a left turn needs E(s) and E(~s) in full (2 x 14 rounds x 16 lookups), a
right turn only t_r, bit 0 of E(~s) (12 full rounds, the 4 lookups of
round 13's column that feeds byte 0, and byte 0's S-box lookup); the
right child's s and v are copies of s and ~s.  The bytes count each input
read once and each output written once.

NVIDIA publishes no AES rate, so the lookup rate is derived from shared
memory: each SM serves 32 four-byte words a clock (one a bank) at the
card's highest SM clock.  ``peaks.json`` holds the table.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["LOOKUPS_BLOCK", "LOOKUPS_T_BIT", "column_ones", "prefix_rows",
           "walk_lookups", "lookups_of_columns", "prefix_work",
           "prefix_work_of", "prefix_work_of_summary", "peaks_for", "bound_s",
           "share"]

LOOKUPS_BLOCK = 14 * 16  # T-table lookups of one AES-256 block
LOOKUPS_T_BIT = 12 * 16 + 4 + 1  # ... of its bit 0 alone
LEFT, RIGHT = 2 * LOOKUPS_BLOCK, LOOKUPS_T_BIT  # a left turn, a right turn
AES_IMAGE_BYTES = 496  # the cipher image a walk kernel reads: 240 + 256
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def column_ones(xs: np.ndarray) -> np.ndarray:
    """int64 [8 nb]: the 1-bits of each bit column (MSB first) of points
    xs (uint8 [M, nb])."""
    return np.unpackbits(xs, axis=-1).sum(axis=0, dtype=np.int64)


def prefix_rows(xs: np.ndarray, k: int) -> int:
    """The distinct top-k prefixes among points xs: the frontier rows
    they gather."""
    top = np.unpackbits(xs, axis=-1)[:, :k].astype(np.int64)
    return int(np.unique(top @ (1 << np.arange(k, dtype=np.int64))).size)


def lookups_of_columns(ones: np.ndarray, m: int, lo: int, hi: int,
                       left: int = LEFT, right: int = RIGHT) -> int:
    """Lookups of a walk through levels lo..hi-1 of m points whose bit
    columns hold ``ones`` 1-bits (a right turn each)."""
    rights = int(ones[lo:hi].sum())
    return left * (m * (hi - lo) - rights) + right * rights


def walk_lookups(xs: np.ndarray, lo: int, hi: int, left: int = LEFT,
                 right: int = RIGHT) -> int:
    """Lookups of a walk over points xs (uint8 [M, nb], bits MSB first)
    through levels lo..hi-1, at ``left`` lookups a left turn and
    ``right`` a right turn."""
    return lookups_of_columns(column_ones(xs), xs.shape[0], lo, hi, left,
                              right)


def prefix_work_of(m: int, nb: int, ones: np.ndarray, rows: int, k: int,
                   n: int) -> tuple[int, int]:
    """(lookups, bytes) of one prefix evaluation (kernel B3, one key,
    lam = 16) of m points with column counts ``ones`` gathering ``rows``
    frontier rows: levels k..n-1 walked from the frontier; the points and
    the rows read once, the shares written once, the correction words of
    the walked levels, CW_{n+1} and the cipher image read once."""
    nbytes = (m * nb + rows * 32 + m * 16 + (n - k) * 34 + 16
              + AES_IMAGE_BYTES)
    return lookups_of_columns(ones, m, k, n), nbytes


def prefix_work_of_summary(p: dict, geo: dict) -> tuple[int, int]:
    """``prefix_work_of`` of one traced request's summary ``p`` (m, bit
    column counts, frontier rows) in a cell of geometry ``geo``."""
    return prefix_work_of(p["m"], geo["nb"], p["ones"], p["rows"], geo["k"],
                          geo["n"])


def prefix_work(xs: np.ndarray, k: int, n: int) -> tuple[int, int]:
    """``prefix_work_of`` at points xs."""
    return prefix_work_of(xs.shape[0], xs.shape[1], column_ones(xs),
                          prefix_rows(xs, k), k, n)


def peaks_for(device_name: str) -> dict | None:
    """The peaks of the card named ``device_name`` (the longest entry of
    ``peaks.json`` that the name starts with), or None for a card the
    table does not hold."""
    table = json.loads(PEAKS.read_text())["cards"]
    names = [k for k in table if device_name.startswith(k)]
    if not names:
        return None
    p = table[max(names, key=len)]
    return {"lookups_per_s": p["sms"] * p["shared_words_per_clock_per_sm"]
            * p["max_sm_clock_hz"], "bytes_per_s": p["hbm_bytes_per_s"]}


def bound_s(lookups: int, nbytes: int, peaks: dict) -> float:
    """The least seconds the card could take for this work."""
    return max(lookups / peaks["lookups_per_s"],
               nbytes / peaks["bytes_per_s"])


def share(rec, kernel: str, work) -> float | None:
    """A kernel's share of its roofline, in %: the least time its traced
    requests needed (``work(summary, geometry)`` -> (lookups, bytes) of
    each, at the card's peaks) over the device time of the operations
    whose name holds ``kernel``.  None where the trace holds no such
    time, no traced request, or the card is not in ``peaks.json``."""
    from portbench import trace

    kernel_ns = trace.device_ns(rec, lambda name: kernel in name)
    if not kernel_ns or rec.peaks is None or not rec.points:
        return None
    least = sum(bound_s(*work(p, rec.geometry), rec.peaks)
                for p in rec.points)
    return 100.0 * least / (kernel_ns / 1e9)
