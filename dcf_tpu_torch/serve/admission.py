"""Admission control: bounded request queue, priority classes, deadlines.

Counterpart of ``dcf_tpu/serve/admission.py``, line for line (host
code; the sheds, evictions, expiry and brownout of one scripted
sequence are the same in both packages).

The service's overload policy is decided HERE, at submit time, not
discovered later as memory pressure: the queue is bounded in queued
POINTS (requests are ragged — a bound in requests would let one giant
request soak the device for seconds while claiming a queue depth of 1),
and a submit that would exceed the bound is shed immediately with
``QueueFullError``.  A shed request costs the caller one exception and
zero device work — the cheapest possible failure in a loaded system.

Priority classes: every request carries a ``Priority`` —
``CRITICAL`` / ``NORMAL`` / ``BATCH`` — and overload sheds
lowest-class-first:

* a submit that would exceed the points bound may EVICT queued
  strictly-lower-class requests (lowest class first, newest first) to
  make room; evicted futures complete with ``QueueFullError``.  The
  eviction is all-or-nothing — nobody is evicted unless the incoming
  request then fits (shedding two requests to admit zero would be pure
  loss).
* **brownout** — a degraded-admission mode the service enters on
  sustained queue pressure or open circuit breakers (``serve.breaker``)
  and exports as the ``serve_brownout`` gauge — refuses ``BATCH``
  submits outright at the door, before they cost queue room.
* ``CRITICAL`` keeps the pre-priority semantics exactly: admitted
  whenever the bound allows (evicting lower classes if needed), never
  brownout-refused, never evicted (nothing outranks it).

Dispatch order stays FIFO (``take_group`` is priority-blind): classes
decide *who is shed*, not *who jumps the queue* — a reordering queue
would starve BATCH under permanent moderate load, whereas shed-only
priorities degrade it exactly when something is actually wrong.

Deadlines propagate as absolute clock values (the injectable serve clock,
``utils.benchtime.monotonic`` by default).  They are enforced at batch
formation: an expired request is completed with ``DeadlineExceededError``
and never reaches the device.  In-flight batches are never aborted — a
dispatched batch is at most one ``max_delay + eval`` old, and tearing
down a device dispatch mid-flight costs more than finishing it.

``ServeFuture`` is the result handle: ``result(timeout)`` blocks on a
``threading.Event`` (the service's worker thread completes it) and either
returns the uint8 [K, M, lam] share or raises the typed failure.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np

from dcf_tpu_torch.errors import (
    DeadlineExceededError,
    QueueFullError,
    ShapeError,
)
from dcf_tpu_torch.serve.metrics import Metrics, labeled

__all__ = ["Priority", "parse_priority", "TenantSpec", "ServeFuture",
           "Request", "AdmissionQueue", "expire"]


class Priority(enum.IntEnum):
    """Request priority class; LOWER value = higher priority (sorting a
    mixed list ascending puts the most-protected traffic first)."""

    CRITICAL = 0
    NORMAL = 1
    BATCH = 2


def parse_priority(p) -> Priority:
    """``Priority`` | case-insensitive name -> ``Priority`` (the serve
    edge accepts both so CLI flags and loadgen specs stay strings)."""
    if isinstance(p, Priority):
        return p
    if isinstance(p, str):
        try:
            return Priority[p.upper()]
        except KeyError:
            pass
    # api-edge: documented priority-class contract at the serve edge
    raise ValueError(
        f"priority must be a Priority or one of "
        f"{[x.name.lower() for x in Priority]}, got {p!r}")


@dataclass(frozen=True)
class TenantSpec:
    """One network-edge tenant and its admission policy.

    Tenants map onto the EXISTING priority classes — the tenant table
    is a naming layer over the shed/brownout policy, never a
    second policy: ``priority`` is the class every request from this
    tenant is admitted as (a request frame may self-DEMOTE below it —
    a gold tenant running an offline sweep can mark it BATCH — but can
    never self-promote above its tenant class).

    ``points_per_sec`` / ``burst_points`` configure the per-tenant
    token bucket the edge applies BEFORE the request touches the shared
    queue (``serve.edge.TokenBucket``): 0 points/s disables rate
    limiting for the tenant; ``burst_points`` is the bucket capacity
    (0 = one second of rate — a full-rate burst).  The bucket refuses
    with ``QueueFullError`` carrying the exact time-to-refill as its
    ``retry_after_s``.
    """

    name: str
    priority: Priority | str = Priority.NORMAL
    points_per_sec: float = 0.0
    burst_points: int = 0

    def __post_init__(self):
        if not self.name:
            # api-edge: tenant-table contract (the empty name is the
            # anonymous default-tenant spelling on the wire, never a
            # declarable tenant)
            raise ValueError("tenant name must be non-empty")
        # Normalize the class eagerly so a typo'd name dies at config
        # time, not per-request on a serving thread.
        object.__setattr__(self, "priority", parse_priority(self.priority))
        if self.points_per_sec < 0:
            # api-edge: tenant-table contract (0 = unlimited)
            raise ValueError(
                f"tenant {self.name!r}: points_per_sec must be >= 0, "
                f"got {self.points_per_sec}")
        if self.burst_points < 0:
            # api-edge: tenant-table contract (0 = one second of rate)
            raise ValueError(
                f"tenant {self.name!r}: burst_points must be >= 0, "
                f"got {self.burst_points}")


class ServeFuture:
    """Completion handle for one submitted request."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value: np.ndarray) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        """The request's uint8 [K, M, lam] share, or its typed failure.
        Raises ``TimeoutError`` if the service has not completed the
        request within ``timeout`` seconds (the request stays live)."""
        if not self._event.wait(timeout):
            # dcflint: disable=typed-error a result-wait timeout means
            # "not done yet", not a framework failure: the builtin
            # TimeoutError is the documented contract (and deliberately
            # NOT DeadlineExceededError, which means "dropped undone")
            raise TimeoutError("request not completed yet")
        error = self._error  # re-raise of the stored completion failure
        if error is not None:
            raise error
        return self._value


class Request:
    """One accepted request: points for one (key_id, party) pair."""

    __slots__ = ("key_id", "b", "xs", "m", "deadline", "enq_t", "future",
                 "priority")

    def __init__(self, key_id: str, b: int, xs: np.ndarray,
                 deadline: float | None, enq_t: float,
                 priority: Priority = Priority.NORMAL):
        self.key_id = key_id
        self.b = int(b)
        self.xs = xs
        self.m = int(xs.shape[0])
        self.deadline = deadline
        self.enq_t = enq_t
        self.priority = priority
        self.future = ServeFuture()

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def __repr__(self) -> str:  # points are caller data: shapes only
        return (f"Request(key_id={self.key_id!r}, b={self.b}, m={self.m}, "
                f"priority={self.priority.name}, "
                f"deadline={self.deadline})")


class AdmissionQueue:
    """FIFO bounded-points queue with group extraction for the batcher.

    Thread-safe; ``cond`` is the wakeup signal the worker waits on
    (notified on every accepted submit and on ``close``).
    """

    def __init__(self, max_queued_points: int,
                 metrics: Metrics | None = None, *,
                 shed_retry_after_s: float | None = None,
                 brownout_retry_after_s: float | None = None):
        if max_queued_points < 1:
            # api-edge: constructor bound contract
            raise ValueError(
                f"max_queued_points must be >= 1, got {max_queued_points}")
        self.max_queued_points = int(max_queued_points)
        # Retry-after hints: what a shed caller is told to
        # back off for.  Overload sheds carry ``shed_retry_after_s``
        # (the service passes ~one coalescing drain interval — the
        # soonest the queue could plausibly have room again); brownout
        # refusals carry ``brownout_retry_after_s`` (the service passes
        # ``brownout_clear_s`` — the calm the hysteresis controller
        # needs before it re-admits BATCH).  Draining/closed refusals
        # carry no hint: the service is not coming back.
        self.shed_retry_after_s = shed_retry_after_s
        self.brownout_retry_after_s = brownout_retry_after_s
        self._metrics = metrics if metrics is not None else Metrics()
        self.cond = threading.Condition()
        # guarded-by: cond
        self._reqs: list[Request] = []
        # guarded-by: cond
        self._points = 0
        # guarded-by: cond
        self._closed = False
        # guarded-by: cond
        self._brownout = False
        self._g_depth = self._metrics.gauge("serve_queue_depth")
        self._g_points = self._metrics.gauge("serve_queue_points")
        self._g_brownout = self._metrics.gauge("serve_brownout")
        self._c_shed = self._metrics.counter("serve_shed_total")
        self._c_accepted = self._metrics.counter("serve_requests_total")
        self._c_accepted_points = self._metrics.counter("serve_points_total")
        self._c_brownout_refused = self._metrics.counter(
            "serve_brownout_refusals_total")
        self._c_evicted = self._metrics.counter("serve_queue_evicted_total")
        # Pre-registered per-class series: a snapshot always carries all
        # three keys (a missing class reads as "never shed" — tests and
        # the chaos harness assert on exact zeros).
        self._c_shed_by = {
            pr: self._metrics.counter(labeled(
                "serve_shed_by_class_total", priority=pr.name.lower()))
            for pr in Priority}
        self._c_evicted_by = {
            pr: self._metrics.counter(labeled(
                "serve_queue_evicted_by_class_total",
                priority=pr.name.lower()))
            for pr in Priority}

    def set_brownout(self, on: bool) -> None:
        """Flip the brownout gate (the SERVICE owns the entry/exit
        policy — sustained pressure with hysteresis; the queue just
        enforces the refusal)."""
        on = bool(on)
        # dcflint: disable=guarded-by hot-path no-op probe (see below):
        # a torn/stale read at worst takes or skips the condvar once;
        # the guarded write below re-checks nothing because same-value
        # sets are idempotent.
        if self._brownout == on:
            # Hot-path no-op: the service calls this on every submit
            # and pump iteration while pressure holds; don't take the
            # queue condvar to rewrite an unchanged gauge.  (Unlocked
            # read is benign: concurrent same-value sets are idempotent.)
            return
        with self.cond:
            self._brownout = on
            self._g_brownout.set(int(on))

    @property
    def brownout(self) -> bool:
        # dcflint: disable=guarded-by monitoring snapshot: a single
        # bool read (atomic under the GIL), advisory by contract —
        # admission decisions re-read it under the condvar in put()
        return self._brownout

    def _shed(self, req: Request) -> None:
        self._c_shed.inc()
        self._c_shed_by[req.priority].inc()

    # holds-lock: cond
    def _pick_victims(self, req: Request) -> list[Request] | None:
        """Queued strictly-lower-class requests whose eviction makes
        ``req`` fit — lowest class first, newest first within a class —
        or ``None`` when no such set exists (all-or-nothing: nobody is
        evicted for an admit that still fails)."""
        need = self._points + req.m - self.max_queued_points
        victims: list[Request] = []
        # Newest-first = highest queue index (enq_t ties under a fake
        # clock; position is the unambiguous arrival order).
        candidates = [r for _, r in sorted(
            ((i, r) for i, r in enumerate(self._reqs)
             if r.priority > req.priority),
            key=lambda ir: (-ir[1].priority, -ir[0]))]
        for r in candidates:
            if need <= 0:
                break
            victims.append(r)
            need -= r.m
        return victims if need <= 0 else None

    def put(self, req: Request) -> None:
        """Admit or shed ``req`` (QueueFullError on overload/brownout/
        shutdown); may evict queued lower-class requests to admit it."""
        if req.m > self.max_queued_points:
            # Not an overload: this request can NEVER be admitted, so a
            # "back off and retry" QueueFullError would send the caller
            # into a futile loop — it is a size-contract violation.
            raise ShapeError(
                f"request of {req.m} points exceeds the admission bound "
                f"max_queued_points={self.max_queued_points} outright; "
                "split the request (or raise the bound)")
        victims: list[Request] = []
        with self.cond:
            if self._closed:
                # Shutdown rejections count as shed too: loadgen counts
                # them off the same QueueFullError, and the two numbers
                # land in the same RESULTS_serve line — they must agree.
                self._shed(req)
                raise QueueFullError(
                    "service is draining/closed; no new requests")
            if self._brownout and req.priority is Priority.BATCH:
                self._shed(req)
                self._c_brownout_refused.inc()
                raise QueueFullError(
                    "brownout: the service is shedding BATCH-class load "
                    "(sustained queue pressure or an open circuit "
                    "breaker); back off and retry, or raise the class",
                    retry_after_s=self.brownout_retry_after_s)
            if self._points + req.m > self.max_queued_points:
                picked = self._pick_victims(req)
                if picked is None:
                    self._shed(req)
                    raise QueueFullError(
                        f"admission queue full: {self._points} points "
                        f"queued + {req.m} requested > bound "
                        f"{self.max_queued_points}; back off and retry",
                        retry_after_s=self.shed_retry_after_s)
                victims = picked
                evicted = set(map(id, victims))
                self._reqs = [r for r in self._reqs
                              if id(r) not in evicted]
                self._points -= sum(r.m for r in victims)
                self._c_evicted.inc(len(victims))
                for r in victims:
                    self._c_evicted_by[r.priority].inc()
                    # Evictions are sheds delivered late: count them in
                    # the same totals loadgen reconciles against.
                    self._shed(r)
            self._reqs.append(req)
            self._points += req.m
            self._c_accepted.inc()
            self._c_accepted_points.inc(req.m)
            self._sync_gauges()
            self.cond.notify_all()
        # Complete evicted futures outside the lock: result() waiters
        # wake immediately and must not contend the admission path.
        for r in victims:
            r.future.set_exception(QueueFullError(
                f"evicted from the admission queue: a higher-priority "
                f"submit needed the room ({r!r})",
                retry_after_s=self.shed_retry_after_s, evicted=True))

    def close(self) -> None:
        """Stop admitting; queued requests remain for draining."""
        with self.cond:
            self._closed = True
            self.cond.notify_all()

    @property
    def closed(self) -> bool:
        # dcflint: disable=guarded-by monitoring snapshot: one atomic
        # bool read; the admit path re-checks under the condvar
        return self._closed

    def __len__(self) -> int:
        # dcflint: disable=guarded-by monitoring snapshot: len() of a
        # list the GIL keeps internally consistent; depth gauges and
        # tests tolerate one-update staleness by contract
        return len(self._reqs)

    @property
    def points(self) -> int:
        # dcflint: disable=guarded-by monitoring snapshot: one atomic
        # int read, used for gauges/pressure sampling only — admission
        # re-reads it under the condvar
        return self._points

    def oldest_enq_t(self) -> float | None:
        with self.cond:
            return self._reqs[0].enq_t if self._reqs else None

    def take_expired(self, now: float) -> list[Request]:
        """Remove and return every queued request whose deadline passed
        (the caller completes them with ``DeadlineExceededError``)."""
        with self.cond:
            expired = [r for r in self._reqs if r.expired(now)]
            if expired:
                self._reqs = [r for r in self._reqs if not r.expired(now)]
                self._points = sum(r.m for r in self._reqs)
                self._sync_gauges()
            return expired

    def take_group(self, max_batch_points: int) -> list[Request]:
        """Remove and return the head request's (key_id, party) group:
        same-group requests in FIFO order until one does not fit in
        ``max_batch_points`` — at which point the group CLOSES, so a
        later-submitted smaller request can never jump an earlier one
        (per-request latency stays FIFO within a group).  The head
        request is always taken, however large — the batcher splits it.
        Other groups keep their order."""
        with self.cond:
            if not self._reqs:
                return []
            head = self._reqs[0]
            group, rest, total = [head], [], head.m
            closed_group = False
            for r in self._reqs[1:]:
                if (r.key_id, r.b) == (head.key_id, head.b) \
                        and not closed_group:
                    if total + r.m <= max_batch_points:
                        group.append(r)
                        total += r.m
                        continue
                    closed_group = True  # preserve FIFO within the group
                rest.append(r)
            self._reqs = rest
            self._points = sum(r.m for r in rest)
            self._sync_gauges()
            return group

    def fail_all(self, make_error: Callable[[], BaseException]) -> int:
        """Drop every queued request, completing each with a fresh error
        (non-drain shutdown).  Returns the count."""
        with self.cond:
            reqs, self._reqs, self._points = self._reqs, [], 0
            self._sync_gauges()
        for r in reqs:
            r.future.set_exception(make_error())
        return len(reqs)

    # holds-lock: cond
    def _sync_gauges(self) -> None:
        self._g_depth.set(len(self._reqs))
        self._g_points.set(self._points)


def expire(reqs: list[Request], metrics: Metrics) -> None:
    """Complete ``reqs`` with DeadlineExceededError (and count them)."""
    if reqs:
        metrics.counter("serve_deadline_expired_total").inc(len(reqs))
    for r in reqs:
        r.future.set_exception(DeadlineExceededError(
            f"deadline passed before dispatch ({r!r})"))
