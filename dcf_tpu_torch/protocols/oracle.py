"""Numpy golden models for the protocol layer (the protocols "spec").

Counterpart of ``dcf_tpu/protocols/oracle.py``.  Slow, obviously-correct
references for interval containment, MIC and piecewise-constant
evaluation.  Every protocol evaluator of the port (the facade path and
the staged path with its combine on the card) is held against these
byte for byte, as the DCF backends are held against ``spec``.

The oracles are OUTPUT-GROUP INDEPENDENT: each models the plaintext
function (``beta`` where the indicator fires, ``0`` elsewhere; the
firing piece's value for piecewise), and that plaintext is the same
whether the shares being checked against it reconstruct by XOR or by
mod-2^w lane addition — the group only changes HOW the two parties'
outputs are folded (``utils.groups.np_group_add``), not what they fold
to.  The fixed-point gate oracles (sign, truncation, sigmoid), which DO
have group-specific plaintext semantics, live with their gates in
``protocols.fixedpoint``.

Interval convention (shared with ``protocols.keygen`` — the single
source of the semantics):

* the domain is ``[0, N)`` with ``N = 2^(8*n_bytes)``; interval bounds
  are Python ints ``0 <= p, q <= N`` (``N`` itself is a legal bound so
  ``[p, N)`` suffixes are expressible);
* ``(p, q)`` denotes the half-open interval ``[p, q)`` when ``p <= q``
  and the WRAPAROUND interval ``[p, N) ∪ [0, q)`` when ``p > q``;
* ``p == q`` is the EMPTY interval (never full-domain: the full domain
  is ``(0, N)``).  This disambiguation is load-bearing — in the XOR
  group the two cases differ only by the public correction bit, see
  ``keygen.interval_bound_alphas``.

Outputs mirror the DCF evaluators: uint8 ``[m, M, lam]`` (MIC),
``[M, lam]`` (IC / piecewise), with ``beta`` where the indicator is 1
and ``0`` elsewhere.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from dcf_tpu_torch.errors import ShapeError

__all__ = [
    "dpf_oracle",
    "ic_oracle",
    "interval_indicator",
    "mic_oracle",
    "piecewise_oracle",
    "points_to_ints",
]


def points_to_ints(xs: np.ndarray) -> list[int]:
    """uint8 [M, n_bytes] big-endian points -> Python ints (arbitrary
    width: the flagship 16-byte domain overflows uint64)."""
    xs = np.asarray(xs, dtype=np.uint8)
    if xs.ndim != 2:
        raise ShapeError(f"xs must be [M, n_bytes], got {xs.shape}")
    return [int.from_bytes(row.tobytes(), "big") for row in xs]


def _check_bounds(p: int, q: int, n: int) -> None:
    if not (0 <= p <= n and 0 <= q <= n):
        raise ValueError(
            f"interval bounds must lie in [0, {n}], got ({p}, {q})")


def interval_indicator(xs: np.ndarray, p: int, q: int) -> np.ndarray:
    """bool [M]: x in [p, q), wraparound when p > q, empty when p == q."""
    n_total = 1 << (8 * xs.shape[1])
    _check_bounds(p, q, n_total)
    vals = points_to_ints(xs)
    if p <= q:
        inside = [p <= x < q for x in vals]
    else:
        inside = [x >= p or x < q for x in vals]
    return np.asarray(inside, dtype=bool)


def dpf_oracle(xs: np.ndarray, alpha: int, beta: np.ndarray) -> np.ndarray:
    """Distributed point function 1_{x == alpha} * beta: uint8 [M, lam].

    The DPF golden model: ``beta`` at the single point ``alpha``, zero
    everywhere else — the degenerate interval ``[alpha, alpha+1)`` of
    the IC family, kept separate because the DPF key (protocols.dpf)
    carries no comparison accumulation and its evaluators are validated
    against this directly.
    """
    n_total = 1 << (8 * xs.shape[1])
    if not 0 <= alpha < n_total:
        raise ValueError(f"alpha must lie in [0, {n_total}), got {alpha}")
    beta = np.asarray(beta, dtype=np.uint8)
    hit = np.asarray([x == alpha for x in points_to_ints(xs)], dtype=bool)
    return np.where(hit[:, None], beta[None, :],
                    np.zeros_like(beta)[None, :])


def ic_oracle(xs: np.ndarray, p: int, q: int, beta: np.ndarray) -> np.ndarray:
    """Interval containment 1_{x in [p, q)} * beta: uint8 [M, lam]."""
    beta = np.asarray(beta, dtype=np.uint8)
    inside = interval_indicator(xs, p, q)
    return np.where(inside[:, None], beta[None, :],
                    np.zeros_like(beta)[None, :])


def mic_oracle(xs: np.ndarray, intervals: Sequence[tuple[int, int]],
               betas: np.ndarray) -> np.ndarray:
    """Multiple interval containment: uint8 [m, M, lam], row i is
    ``ic_oracle(xs, *intervals[i], betas[i])``.  Disjointness is the
    caller's protocol-level concern — each row is independent."""
    betas = np.asarray(betas, dtype=np.uint8)
    if betas.ndim != 2 or betas.shape[0] != len(intervals):
        raise ShapeError(
            f"betas must be [{len(intervals)}, lam], got {betas.shape}")
    return np.stack([ic_oracle(xs, p, q, betas[i])
                     for i, (p, q) in enumerate(intervals)])


def piecewise_oracle(xs: np.ndarray, cuts: Sequence[int],
                     values: np.ndarray) -> np.ndarray:
    """Piecewise-constant lookup: uint8 [M, lam].

    ``cuts`` (strictly increasing ints in [0, N)) partition the domain
    into m = len(cuts) intervals ``[cuts[i], cuts[i+1])`` with the LAST
    one wrapping: ``[cuts[m-1], N) ∪ [0, cuts[0])``.  With
    ``cuts[0] == 0`` this is the standard spline table over [0, N);
    a nonzero ``cuts[0]`` rotates the table.  ``values``: uint8
    [m, lam].  Exactly one interval contains each x, so the XOR-reduce
    over the MIC rows IS the lookup — the identity the evaluator relies
    on (``protocols.piecewise``).
    """
    from dcf_tpu_torch.protocols.piecewise import partition_intervals

    intervals = partition_intervals(cuts, 8 * xs.shape[1])
    rows = mic_oracle(xs, intervals, values)
    return np.bitwise_xor.reduce(rows, axis=0)
