"""Piecewise-constant function evaluation as a MIC over a partition.

Counterpart of ``dcf_tpu/protocols/piecewise.py``.  A piecewise-constant f with m pieces is an m-interval MIC whose
intervals PARTITION the domain: exactly one indicator fires per point,
so the group sum over the per-interval rows collapses to the containing
piece's value — "sum of selected values" and "the selected value"
coincide in ANY output group when exactly one indicator fires, which is
what makes the spline lookup a pure reduce over the MIC output.  In the
XOR group that needs no arithmetic shares at all; in an additive group
the same reduce yields ADDITIVE shares of the piece value — the form
the fixed-point gates (``protocols.fixedpoint``) compose further.  The
last interval wraps (``[cuts[-1], N) ∪ [0, cuts[0])``), so with
``cuts[0] == 0`` the table covers [0, N) in the standard way and the
wraparound machinery costs nothing extra.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from dcf_tpu_torch.protocols.keygen import ProtocolBundle
from dcf_tpu_torch.protocols.mic import eval_mic
from dcf_tpu_torch.utils.groups import np_group_reduce

__all__ = ["eval_piecewise", "partition_intervals"]


def partition_intervals(cuts: Sequence[int],
                        n_bits: int) -> list[tuple[int, int]]:
    """Breakpoints -> the m partition intervals (last one wrapping).

    ``cuts``: strictly increasing ints in [0, 2^n_bits).  Returns
    ``[(cuts[0], cuts[1]), ..., (cuts[-1], cuts[0])]`` — the final
    pair wraps around the domain top (with ``cuts[0] == 0`` it
    degenerates to the plain suffix ``[cuts[-1], N)``).  A single cut
    would yield ``(c, c)``, which the interval convention reads as
    EMPTY, so m == 1 maps to the explicit full-domain interval
    ``(0, N)`` instead: a one-piece table is the constant function.
    """
    n_total = 1 << n_bits
    m = len(cuts)
    if m == 0:
        raise ValueError("need at least one breakpoint")
    for i, c in enumerate(cuts):
        if not 0 <= c < n_total:
            raise ValueError(
                f"cut {i} must lie in [0, {n_total}), got {c}")
        if i and c <= cuts[i - 1]:
            raise ValueError(
                f"cuts must be strictly increasing, got {cuts[i - 1]} "
                f"then {c}")
    if m == 1:
        return [(0, n_total)]  # one piece == the constant function
    out = [(cuts[i], cuts[i + 1]) for i in range(m - 1)]
    out.append((cuts[-1], cuts[0]))  # wraparound back to the first cut
    return out


def eval_piecewise(dcf, b: int, pb: ProtocolBundle,
                   xs: np.ndarray) -> np.ndarray:
    """Party ``b``'s piecewise-lookup share: uint8 [M, lam] — the
    group-sum reduce of the MIC rows (XOR in the default group; mod-2^w
    lane sums for additive bundles, where the share rows are uniform
    and only the reduce in the RIGHT group telescopes to the containing
    piece).  Valid because the bundle's intervals partition the domain;
    ``Dcf.piecewise`` builds exactly that."""
    rows = eval_mic(dcf, b, pb, xs)  # [m, M, lam]
    return np_group_reduce(rows, pb.group, axis=0)
