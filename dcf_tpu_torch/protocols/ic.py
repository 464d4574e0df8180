"""Single-interval containment (IC): the m=1 slice of MIC.

Counterpart of ``dcf_tpu/protocols/ic.py``.  IC is where the XOR-group
derivation (``protocols.keygen``) is easiest to see: two DCF keys — one per bound — K-packed into a K=2
bundle, pair-combined to ``1_{p <= x < q} * beta`` shares.  Everything
here delegates to ``protocols.mic``; the module exists so the facade's
``Dcf.interval``/``Dcf.eval_interval`` surface has a first-class
single-interval form with [M, lam]-shaped outputs.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.protocols.keygen import ProtocolBundle
from dcf_tpu_torch.protocols.mic import eval_mic

__all__ = ["eval_interval"]


def eval_interval(dcf, b: int, pb: ProtocolBundle,
                  xs: np.ndarray) -> np.ndarray:
    """Party ``b``'s IC share: uint8 [M, lam].  Group-add both parties'
    outputs (XOR in the default group) to reconstruct
    ``beta if x in [p, q) else 0`` (wraparound intervals included — the
    combine mask carries the correction)."""
    if pb.num_intervals != 1:
        raise ShapeError(
            f"eval_interval wants a single-interval bundle, got m="
            f"{pb.num_intervals}; use eval_mic for the batched form")
    return eval_mic(dcf, b, pb, xs)[0]
