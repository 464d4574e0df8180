"""Batched multiple-interval-containment (MIC) evaluation.

Counterpart of ``dcf_tpu/protocols/mic.py``.  Two paths, both
byte-exact against ``protocols.oracle.mic_oracle``:

* ``eval_mic(dcf, b, pb, xs)`` -- the facade path: the 2m bound keys
  evaluate through ``Dcf.eval`` (any backend the facade can select; the
  key image ships once per (bundle, party) as for plain DCF) and the
  pair-combine runs on the host bytes.  The zero-setup path, and the
  only one for the host backends.
* ``MicEvaluator`` -- the staged discipline for long-lived keys: a
  backend instance of its own per (bundle, party) holds the key image
  (``put_bundle``), points are staged per batch (``stage``), and the
  pair-combine runs on the card before the shares are fetched (half the
  bytes brought back; see ``protocols.combine``).
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.protocols.combine import (
    combine_pair_shares,
    staged_pair_combine,
)
from dcf_tpu_torch.protocols.keygen import ProtocolBundle
from dcf_tpu_torch.utils.groups import np_group_add

__all__ = ["MicEvaluator", "eval_mic"]


def eval_mic(dcf, b: int, pb: ProtocolBundle, xs: np.ndarray) -> np.ndarray:
    """Party ``b``'s per-interval MIC shares: uint8 [m, M, lam].

    Group-add both parties' outputs (XOR for the default group) to
    reconstruct ``betas[i] if x in intervals[i] else 0`` per interval
    row.  ``dcf``: the facade the keys were generated for; any backend.
    """
    y = dcf.eval(b, pb.keys, xs)  # [2m, M, lam]
    return combine_pair_shares(np.asarray(y), pb.masks_for(b), pb.group)


class MicEvaluator:
    """Staged MIC evaluation for one (bundle, party): stage once, eval
    many, combine on device.

    >>> ev = MicEvaluator(dcf, pb, b=0)
    >>> y0 = ev.eval(xs)            # uint8 [m, M, lam]

    Owns a fresh backend instance (``Dcf.new_eval_backend``) holding
    this bundle's device image, so many protocol bundles can stay
    resident at once without thrashing the facade's per-party slot.
    On a host-backend facade (cpu, numpy) it evaluates through the
    facade path, which is the host there already.
    """

    def __init__(self, dcf, pb: ProtocolBundle, b: int):
        if b not in (0, 1):
            raise ValueError(f"party must be 0 or 1, got {b}")
        self._dcf = dcf
        self._pb = pb
        self._b = int(b)
        self._group = pb.group
        self._masks = pb.masks_for(b)
        self._be = dcf.new_eval_backend()
        if self._be is not None:
            kb = (pb.keys if dcf.backend_name == "keylanes"
                  else pb.keys.for_party(b) if pb.keys.s0s.shape[1] == 2
                  else pb.keys)
            self._be.put_bundle(kb)

    @property
    def backend(self):
        """The owned backend instance (None for host paths) — the
        escape hatch to its staged API once ``eval`` calls have
        shipped the image."""
        return self._be

    def eval(self, xs: np.ndarray) -> np.ndarray:
        """Per-interval shares uint8 [m, M, lam] for this party."""
        xs = np.asarray(xs, dtype=np.uint8)
        if xs.ndim != 2:
            raise ShapeError(f"xs must be [M, n_bytes], got {xs.shape}")
        m_points = xs.shape[0]
        be = self._be
        if be is None:  # host path: the facade dispatches directly
            return eval_mic(self._dcf, self._b, self._pb, xs)
        staged = be.stage(xs)
        y_dev = be.eval_staged(self._b, staged)
        y_comb = staged_pair_combine(y_dev, self._group)  # seam
        y = be.staged_to_bytes(y_comb, m_points)  # [m, M, lam]
        return np_group_add(y, self._masks[:, None, :], self._group)

    def reconstruct_with(self, other: "MicEvaluator",
                         xs: np.ndarray) -> np.ndarray:
        """Two-party reconstruction convenience (tests/benches): the
        group add of this evaluator's shares with ``other``'s (the
        opposite party) — XOR in the default group."""
        if other._b == self._b:
            raise ValueError("reconstruct_with wants the OPPOSITE party")
        return np_group_add(self.eval(xs), other.eval(xs), self._group)
