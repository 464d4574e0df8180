"""Faults planted under the timed path, for the tests that show the
comparison catches them.  Each takes the shares a request produced
(uint8 [K, M, lam], a tensor or an array), the shares of the request
before it and the request's index, and returns what a broken program
would have handed back."""

from __future__ import annotations

import numpy as np

__all__ = ["FAULTS"]


def _copy(out):
    return out.copy() if isinstance(out, np.ndarray) else out.clone()


def stale(out, prev, r):
    """A step that returns its state unchanged: the previous request's
    shares (zeros before the first)."""
    if prev is not None:
        return prev
    bad = _copy(out)
    bad[...] = 0
    return bad


def half(out, prev, r):
    """Half of the batch left out: the second half of the points is never
    evaluated and reads zero."""
    bad = _copy(out)
    bad[:, out.shape[1] // 2:] = 0
    return bad


def alter(out, prev, r):
    """An answer altered where it is produced: bit 0 of byte 0 flipped in
    the share of every eighth point."""
    bad = _copy(out)
    bad[:, ::8, 0] ^= 1
    return bad


FAULTS = {"stale": stale, "half": half, "alter": alter}
