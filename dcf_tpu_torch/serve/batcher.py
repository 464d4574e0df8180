"""Micro-batch planning: coalesce ragged requests into padded device
batches, and scatter batch results back per request.

Counterpart of ``dcf_tpu/serve/batcher.py``, line for line: the plans,
spans and occupancies are the same for the same request sizes
(``tests/test_torch_serve_core.py``).

Pure host math — no backend, no clock, no device: a plan is a pure
function of the request sizes and the batch cap, so this layer is
exhaustively property-testable in isolation and the service above it
stays thin.

Batches pad to a power of two, as in ``dcf_tpu``, where every distinct
staged shape costs one XLA compile.  The port's kernels compile nothing
per shape, so on the card the padding buys only equal plans and equal
occupancy metrics in both packages; its cost is the evaluation of the
pad rows (the ``serve_batch_occupancy`` histogram shows it).  Pad rows
are zero — a genuine evaluation of x=0 whose output the scatter step
simply never reads (same policy as the backends' own 32-point padding).

Out-of-order completion is safe by construction: each request's output
rows are described by disjoint ``Span``s, so batches may complete in any
order (the double-buffered pipeline finishes batch N while N+1 is in
flight) and each span writes its slice into the request's own
preallocated output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from dcf_tpu_torch.errors import ShapeError

__all__ = ["Span", "BatchPlan", "next_pow2", "plan_batches",
           "ingest_points", "gather_batch", "scatter_batch"]


@dataclass(frozen=True)
class Span:
    """One contiguous run of points: request ``req``'s rows
    [req_off, req_off+length) live at batch rows
    [batch_off, batch_off+length)."""

    req: int
    req_off: int
    batch_off: int
    length: int


@dataclass(frozen=True)
class BatchPlan:
    """One device batch: ``spans`` cover rows [0, m); rows [m, padded_m)
    are zero padding (evaluated, never scattered)."""

    spans: tuple[Span, ...]
    m: int
    padded_m: int

    @property
    def occupancy(self) -> float:
        """Useful fraction of the padded batch (the occupancy metric)."""
        return self.m / self.padded_m if self.padded_m else 0.0


def next_pow2(m: int) -> int:
    """Smallest power of two >= m (>= 1)."""
    return 1 << max(m - 1, 0).bit_length()


def plan_batches(sizes: Sequence[int], max_batch: int) -> list[BatchPlan]:
    """FIFO-greedy coalescing of request sizes into batches of at most
    ``max_batch`` points, each padded up to the next power of two.

    Requests fill the current batch in submission order; a request that
    does not fit in the remaining space is SPLIT across batches (its
    spans reassemble it — occupancy beats keeping requests whole, and
    point order within a request is preserved either way).  ``max_batch``
    must itself be a power of two so padded batches never exceed it.
    """
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ShapeError(
            f"max_batch must be a power of two >= 1, got {max_batch}")
    for i, s in enumerate(sizes):
        if s < 1:
            raise ShapeError(f"request {i} has {s} points; requests are "
                             "non-empty by admission")
    plans: list[BatchPlan] = []
    spans: list[Span] = []
    fill = 0
    for req, size in enumerate(sizes):
        done = 0
        while done < size:
            take = min(size - done, max_batch - fill)
            spans.append(Span(req=req, req_off=done, batch_off=fill,
                              length=take))
            fill += take
            done += take
            if fill == max_batch:
                plans.append(BatchPlan(tuple(spans), fill, fill))
                spans, fill = [], 0
    if spans:
        plans.append(BatchPlan(tuple(spans), fill, next_pow2(fill)))
    return plans


def ingest_points(data, n_bytes: int, m: int | None = None) -> np.ndarray:
    """The ONE bytes-ingest entry feeding the batcher: wrap a
    buffer-protocol object holding ``m`` packed ``n_bytes``-wide points
    as the uint8 [m, n_bytes] array ``gather_batch`` reads spans from —
    ZERO copies and zero per-point Python objects (``np.frombuffer``
    aliases the caller's buffer; the one copy on the wire path is the
    socket read into that buffer, and the next is the span gather into
    the padded device batch).

    Both ingest paths route here: ``DcfService.submit`` hands the
    normalized ndarray's own buffer over, and the network edge
    (``serve.edge``) hands the received frame's payload ``memoryview``
    — so "what the batcher evaluates" has exactly one definition and
    the zero-copy claim is assertable at this seam.

    ``m=None`` derives the point count from the buffer size (must
    divide exactly).  The caller owns the buffer's lifetime: it must
    stay untouched until the request's batches have been gathered
    (the edge allocates one fresh buffer per frame for exactly this
    reason).
    """
    view = memoryview(data)
    if view.ndim != 1 or view.itemsize != 1:
        view = view.cast("B")  # flatten: C-contiguous bytes either way
    total = view.nbytes
    if n_bytes < 1:
        raise ShapeError(f"n_bytes must be >= 1, got {n_bytes}")
    if m is None:
        m, rem = divmod(total, n_bytes)
        if rem:
            raise ShapeError(
                f"payload of {total} bytes is not a whole number of "
                f"{n_bytes}-byte points ({rem} trailing bytes)")
    elif total != m * n_bytes:
        raise ShapeError(
            f"payload of {total} bytes != {m} points x {n_bytes} bytes")
    if m < 1:
        raise ShapeError("cannot ingest an empty request")
    return np.frombuffer(view, dtype=np.uint8).reshape(m, n_bytes)


def gather_batch(xs_list: Sequence[np.ndarray],
                 plan: BatchPlan, n_bytes: int) -> np.ndarray:
    """Assemble one padded device batch uint8 [padded_m, n_bytes] from
    the per-request point arrays (``xs_list[i]`` is request i's full
    uint8 [m_i, n_bytes]).  Pad rows stay zero."""
    out = np.zeros((plan.padded_m, n_bytes), dtype=np.uint8)
    for sp in plan.spans:
        out[sp.batch_off:sp.batch_off + sp.length] = \
            xs_list[sp.req][sp.req_off:sp.req_off + sp.length]
    return out


def scatter_batch(outs: Sequence[np.ndarray], plan: BatchPlan,
                  y: np.ndarray) -> None:
    """Scatter one completed batch result back into the per-request
    output buffers.

    ``y``: uint8 [K, padded_m(or m), lam] — the backend's bytes for this
    batch; ``outs[i]``: request i's preallocated uint8 [K, m_i, lam].
    Only span rows are read, so pad rows and completion order are
    irrelevant.
    """
    for sp in plan.spans:
        outs[sp.req][:, sp.req_off:sp.req_off + sp.length, :] = \
            y[:, sp.batch_off:sp.batch_off + sp.length, :]
