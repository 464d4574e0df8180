"""Served fixed-point gates: protocols.fixedpoint through DcfService.

Counterpart of ``dcf_tpu/workloads/gates.py`` (``GateServer``, its lines
42-148), line for line, over the port's ``protocols.fixedpoint`` and
``serve.DcfService``: on a ``walk`` or ``prefix`` facade the components'
batches run kernel B1, or B2 + B3, and the pair combine on the card.

A gate is a composition of protocol bundles plus public scalars
(``protocols.fixedpoint`` derivations), so SERVING one is pure
registration plumbing: each component ``ProtocolBundle`` registers in
a ``DcfService`` under a derived key id (``<gate_id>/wrap`` etc.,
DCFK v4 frames through the registry / durable store / replication like
any protocol key), and a gate evaluation submits the PUBLIC masked
points to every component and folds the resulting additive shares
client-side — lane adds and a group-sum reduce, no extra crypto.  The
device never learns it is running a gate; it sees K-packed interval
bundles, which is the whole point of the composition.

Fault discipline is inherited, not reimplemented: each component
submit rides the service's admission / deadline / retry-then-evict
machinery, and an injected ``protocols.combine`` fault surfaces as the
service retrying that component batch from the registry snapshot (the
gate soak test drives exactly that path).

``GateServer`` holds one service per domain: the main service for the
gate's w-bit domain and (for truncation) a second service over the
f-bit low half — two facades, two batchers, one registry discipline.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.protocols.fixedpoint import (
    SigmoidGate,
    SignGate,
    TruncGate,
    encode_lanes,
    points_of,
)
from dcf_tpu_torch.utils.groups import np_group_add, np_group_reduce

__all__ = ["GateServer"]


class GateServer:
    """Serve registered fixed-point gates through ``DcfService``.

    ``svc``: the service whose facade matches the gates' full domain;
    ``svc_low``: the f-bit-domain service truncation gates need (the
    two facades must share ``lam``; ``svc_low`` may be omitted when no
    truncation gate is registered).  ``register`` accepts the DEALER
    (two-party) gate objects — the per-party material ships through
    the service's registry exactly like any protocol key, so both
    parties of the 2PC are served off registry snapshots, mirroring
    ``workloads.pir.PirServer``.
    """

    def __init__(self, svc, svc_low=None):
        self._svc = svc
        self._svc_low = svc_low
        self._gates: dict[str, object] = {}

    # -- registration --------------------------------------------------

    def register(self, gate_id: str, gate) -> None:
        """Register one gate's component bundles under derived ids.

        Re-registering a gate_id hot-swaps every component atomically
        enough for the gate's purposes: component ids are derived, so
        a swapped gate never mixes generations ACROSS gate ids."""
        if isinstance(gate, SignGate):
            self._svc.register_key(f"{gate_id}/sign", gate.pb)
        elif isinstance(gate, TruncGate):
            if self._svc_low is None:
                # api-edge: documented server contract
                raise ShapeError(
                    "truncation gates need the low-domain service: "
                    "construct GateServer(svc, svc_low)")
            if self._svc_low.n_bytes != gate.f // 8:
                # api-edge: documented server contract
                raise ShapeError(
                    f"svc_low serves n_bytes={self._svc_low.n_bytes} "
                    f"but gate f={gate.f} wants {gate.f // 8}")
            self._svc.register_key(f"{gate_id}/wrap", gate.pb_wrap)
            self._svc_low.register_key(f"{gate_id}/low", gate.pb_low)
        elif isinstance(gate, SigmoidGate):
            self._svc.register_key(f"{gate_id}/spline", gate.pb)
        else:
            # api-edge: documented server contract
            raise ShapeError(
                f"not a servable gate: {type(gate).__name__}")
        self._gates[gate_id] = gate

    def gate(self, gate_id: str):
        """The registered dealer gate object (oracle parameters live
        here — e.g. the sigmoid's public table)."""
        return self._gates[gate_id]

    # -- served evaluation ---------------------------------------------

    def eval_share(self, gate_id: str, b: int, x_hat,
                   deadline_ms: float | None = None) -> np.ndarray:
        """Party ``b``'s gate share uint8 [M, lam] via the SERVED path.

        ``x_hat``: public masked inputs, int array [M].  Component
        submits are issued concurrently (futures), then folded
        client-side in the gate's group."""
        try:
            gate = self._gates[gate_id]
        except KeyError:
            # api-edge: documented server contract
            raise ShapeError(f"no gate registered as {gate_id!r}") \
                from None
        x_int = np.asarray(x_hat)
        n_bytes = self._svc.n_bytes
        xs = points_of(x_int, n_bytes)
        group = gate.group
        if isinstance(gate, SignGate):
            rows = self._svc.submit(f"{gate_id}/sign", xs, b=b,
                                    deadline_ms=deadline_ms).result()
            return rows[0]
        if isinstance(gate, TruncGate):
            xs_low = np.ascontiguousarray(
                xs[:, n_bytes - gate.f // 8:])
            f_wrap = self._svc.submit(f"{gate_id}/wrap", xs, b=b,
                                      deadline_ms=deadline_ms)
            f_low = self._svc_low.submit(f"{gate_id}/low", xs_low, b=b,
                                         deadline_ms=deadline_ms)
            y = np_group_add(f_wrap.result()[0], f_low.result()[0],
                             group)
            y = np_group_add(y, gate.const_for(b)[None, :], group)
            if b == 0:
                pub = ((x_int.astype(np.uint64)
                        & np.uint64((1 << (8 * n_bytes)) - 1))
                       >> np.uint64(gate.f)).astype(np.int64)
                y = np_group_add(
                    y, encode_lanes(pub, group, y.shape[1]), group)
            return y
        # SigmoidGate
        rows = self._svc.submit(f"{gate_id}/spline", xs, b=b,
                                deadline_ms=deadline_ms).result()
        return np_group_reduce(rows, group, axis=0)

    def reconstruct(self, gate_id: str, x_hat,
                    deadline_ms: float | None = None) -> np.ndarray:
        """Both parties' served shares, group-added: uint8 [M, lam].
        (Test/bench convenience — a real deployment's parties never
        meet like this.)"""
        y0 = self.eval_share(gate_id, 0, x_hat, deadline_ms)
        y1 = self.eval_share(gate_id, 1, x_hat, deadline_ms)
        return np_group_add(y0, y1, self._gates[gate_id].group)
