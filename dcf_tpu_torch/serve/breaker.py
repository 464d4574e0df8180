"""Per-(key_id, backend-family) circuit breakers for the serving layer.

Counterpart of ``dcf_tpu/serve/breaker.py``, line for line (host code).

A plain retry assumes one-shot faults: a batch fails, the
retry runs the shared invalidation path, the re-staged backend serves.
Production backends do not fail once — they fail for a *window* (a
wedged driver, a recompiling kernel, a remote core restarting), and
during that window every retried batch burns its full retry budget and
its callers' deadline headroom before failing anyway.  The breaker is
the memory that turns "this batch failed" into "this backend family is
failing for this key": after ``failures_to_open`` consecutive recorded
failures the breaker OPENS and subsequent batches fail fast with
``errors.CircuitOpenError``.  The port's facade never demotes: the
final retry re-stages on a fresh instance of the same backend, so a
family's breaker is the one that opens (``dcf_tpu``'s auto facade moves
down its fallback chain instead, and a new family there is a new
breaker, born closed).

State machine (the classic three-state breaker)::

                 failures >= threshold
      CLOSED ───────────────────────────► OPEN ◄──┐
        ▲                                  │      │ probe fails
        │ probe succeeds                   │ cooldown elapses
        │                                  ▼      │
        └────────────────────────────── HALF_OPEN ┘

* CLOSED: every batch dispatches; a success resets the consecutive-
  failure count.
* OPEN: non-CRITICAL batches fail fast (``CircuitOpenError``) without
  touching the backend; CRITICAL-priority batches bypass and dispatch
  (their outcomes are recorded but do not transition an open breaker —
  a bypass success is not a sanctioned probe, and treating it as one
  would let a lucky critical flip the breaker mid-cooldown, i.e.
  thrash).  After ``cooldown_s`` on the injectable clock the first
  ``allow`` becomes the half-open probe.
* HALF_OPEN: exactly one probe is in flight; other non-CRITICAL batches
  keep failing fast (a half-open flood would hammer the recovering
  backend).  Probe success closes the breaker; any recorded failure
  re-opens it and restarts the cooldown.

Keying: breakers live per (key_id, backend-family) — the failure domain is the
pairing, not the key (in ``dcf_tpu`` a key that died on one family is healthy
on the one it demotes to) and not the family (one key's poisoned frontier must
not open every other key's breaker).  The board survives registry hot-swaps and
LRU residency evictions by construction: breaker state is *history about a
serving pairing*, and a re-registered bundle re-staged onto the same dying
backend is still on a dying backend. ``forget(key_id)`` (unregistration) is the
one deliberate reset.

Clocking: all cooldown math uses the injectable clock
(``utils.benchtime.monotonic`` by default), never ``time.*``, so tests
replay whole open/half-open/close walks on a fake clock.

Metrics: per-pairing ``serve_breaker_state{backend=...,key=...}`` gauge
(0 closed / 1 half-open / 2 open), aggregate ``serve_breakers_open``
gauge, and ``serve_breaker_transitions_total`` (plus a ``{to=...}``
labeled series per target state) — the counters the chaos harness
asserts its scripted scenarios against.
"""

from __future__ import annotations

import threading

from dcf_tpu_torch.serve.metrics import Metrics, labeled
from dcf_tpu_torch.utils.benchtime import monotonic

__all__ = ["CLOSED", "HALF_OPEN", "OPEN", "STATE_CODES",
           "CircuitBreaker", "BreakerBoard"]

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

#: Gauge encoding: sorted by severity so dashboards can max() over keys.
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """One (key_id, backend-family) breaker; see the module docstring.

    Not self-locking: the owning ``BreakerBoard`` serializes every call
    (state transitions must be atomic with the metrics that report
    them).  Usable standalone in single-threaded tests.
    """

    __slots__ = ("failures_to_open", "cooldown_s", "state", "failures",
                 "opened_at", "probe_inflight")

    def __init__(self, failures_to_open: int, cooldown_s: float):
        if failures_to_open < 1:
            # api-edge: constructor bound contract (0 disables breakers
            # at the ServeConfig level, not per instance)
            raise ValueError(
                f"failures_to_open must be >= 1, got {failures_to_open}")
        if cooldown_s < 0:
            # api-edge: constructor bound contract
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.failures_to_open = int(failures_to_open)
        self.cooldown_s = float(cooldown_s)
        self.state = CLOSED
        self.failures = 0  # consecutive, reset by any success when closed
        self.opened_at = 0.0
        self.probe_inflight = False

    def allow(self, now: float, critical: bool = False) -> bool:
        """May a new batch dispatch?  OPEN -> HALF_OPEN happens here
        (the allowed caller becomes the probe) once the cooldown has
        elapsed on the injected clock."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if now - self.opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
                self.probe_inflight = True
                return True
            return critical  # CRITICAL bypasses the open window
        # HALF_OPEN: one probe at a time; criticals ride along.
        if critical:
            return True
        if not self.probe_inflight:
            self.probe_inflight = True
            return True
        return False

    def record_success(self) -> None:
        # No clock: success timing never matters to the state machine
        # (only record_failure stamps opened_at).
        if self.state == CLOSED:
            self.failures = 0
        elif self.state == HALF_OPEN:
            self.state = CLOSED
            self.failures = 0
            self.probe_inflight = False
        # OPEN: a CRITICAL bypass that got lucky is not a probe — the
        # breaker waits for the cooldown + sanctioned probe (no thrash).

    def record_failure(self, now: float) -> None:
        if self.state == CLOSED:
            self.failures += 1
            if self.failures >= self.failures_to_open:
                self.state = OPEN
                self.opened_at = now
        elif self.state == HALF_OPEN:
            self.state = OPEN
            self.opened_at = now  # cooldown restarts after a failed probe
            self.probe_inflight = False
        # OPEN: a CRITICAL bypass failing changes nothing — restarting
        # the cooldown on bypass traffic would keep a busy breaker open
        # forever (the starvation flavor of thrash).

    def abort_probe(self) -> None:
        """The caller that ``allow`` sanctioned as the half-open probe
        died without a batch outcome (e.g. the key was unregistered
        between the gate and the dispatch).  Release the probe slot so
        the NEXT allow can probe — without this, a vanished prober would
        wedge the breaker half-open forever (criticals only)."""
        if self.state == HALF_OPEN:
            self.probe_inflight = False


class BreakerBoard:
    """Registry of per-(key_id, backend-family) breakers + metrics.

    Thread-safe; one lock serializes state transitions with the gauges
    and counters that report them, so a metrics snapshot can never show
    an open count that disagrees with the per-pairing state gauges.
    """

    def __init__(self, *, failures_to_open: int = 3,
                 cooldown_s: float = 5.0,
                 metrics: Metrics | None = None, clock=monotonic):
        self.failures_to_open = int(failures_to_open)
        self.cooldown_s = float(cooldown_s)
        self._metrics = metrics if metrics is not None else Metrics()
        self._clock = clock
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._breakers: dict[tuple[str, str], CircuitBreaker] = {}
        # guarded-by: _lock
        self._open = 0
        self._g_open = self._metrics.gauge("serve_breakers_open")
        self._c_transitions = self._metrics.counter(
            "serve_breaker_transitions_total")

    # -- internals (call under self._lock) ----------------------------------

    # holds-lock: _lock
    def _get(self, key_id: str, family: str) -> CircuitBreaker:
        br = self._breakers.get((key_id, family))
        if br is None:
            br = CircuitBreaker(self.failures_to_open, self.cooldown_s)
            self._breakers[(key_id, family)] = br
        return br

    # holds-lock: _lock
    def _sync(self, key_id: str, family: str, br: CircuitBreaker,
              before: str) -> None:
        if br.state == before:
            return
        self._c_transitions.inc()
        self._metrics.counter(labeled(
            "serve_breaker_transitions_total", to=br.state)).inc()
        self._metrics.gauge(labeled(
            "serve_breaker_state", backend=family,
            key=key_id)).set(STATE_CODES[br.state])
        self._open += (br.state == OPEN) - (before == OPEN)
        self._g_open.set(self._open)

    # -- the serving-layer surface ------------------------------------------

    def allow(self, key_id: str, family: str,
              critical: bool = False) -> bool:
        with self._lock:
            br = self._get(key_id, family)
            before = br.state
            ok = br.allow(self._clock(), critical)
            self._sync(key_id, family, br, before)
            return ok

    def record_success(self, key_id: str, family: str) -> None:
        with self._lock:
            br = self._breakers.get((key_id, family))
            if br is None:
                # Every dispatch passes the allow() gate first (which
                # creates the entry), so a missing pairing here means
                # forget() raced an in-flight batch: the key was
                # unregistered, and a late outcome must not resurrect
                # board state (or its labeled gauge) for a dead pairing.
                return
            before = br.state
            br.record_success()
            self._sync(key_id, family, br, before)

    def record_failure(self, key_id: str, family: str) -> None:
        with self._lock:
            br = self._breakers.get((key_id, family))
            if br is None:  # forgotten pairing: see record_success
                return
            before = br.state
            br.record_failure(self._clock())
            self._sync(key_id, family, br, before)

    def abort_probe(self, key_id: str, family: str) -> None:
        with self._lock:
            br = self._breakers.get((key_id, family))
            if br is not None:
                br.abort_probe()  # never a transition: no _sync needed

    def state(self, key_id: str, family: str) -> str:
        with self._lock:
            br = self._breakers.get((key_id, family))
            return br.state if br is not None else CLOSED

    def retry_after(self, key_id: str, family: str) -> float | None:
        """The backoff hint for a caller refused by this pairing:
        OPEN -> the remaining cooldown (when it elapses the
        next allow becomes the half-open probe, so retrying then is not
        a guess but the sanctioned schedule); HALF_OPEN -> the full
        cooldown (a probe is in flight; if it fails the cooldown
        restarts, so anything shorter invites a thundering re-try at a
        breaker that may just have re-opened); CLOSED/unknown ->
        ``None`` (nothing to wait out).  Clamped at 0: a probe-ready
        breaker means "retry now"."""
        with self._lock:
            br = self._breakers.get((key_id, family))
            if br is None or br.state == CLOSED:
                return None
            if br.state == HALF_OPEN:
                return br.cooldown_s
            return max(0.0,
                       br.cooldown_s - (self._clock() - br.opened_at))

    def any_open(self) -> bool:
        """An open breaker still inside its cooldown — one of the
        brownout controller's two pressure signals (a failing backend
        family sheds load upstream at admission, not just at dispatch).

        OPEN past its cooldown does NOT count: such a breaker is merely
        probe-ready, and if the facade has demoted away from its family
        no traffic will ever route there to probe it — counting it
        would latch brownout on (and BATCH traffic off) forever on a
        service that is serving fine on the demoted-to family.  Open
        pressure means *actively failing*, not *historically failed*."""
        now = self._clock()
        with self._lock:
            if self._open == 0:  # the steady-state hot path: this runs
                # on every submit — don't scan the board when nothing
                # is open (the cooldown filter only matters when
                # something is)
                return False
            return any(
                br.state == OPEN and now - br.opened_at < br.cooldown_s
                for br in self._breakers.values())

    def forget(self, key_id: str) -> None:
        """Drop every family's breaker for ``key_id`` (unregistration —
        the pairing no longer exists).  Registry hot-swaps and LRU
        residency evictions deliberately do NOT route here: the failure
        history is about the backend family, which both survive."""
        with self._lock:
            for k, br in list(self._breakers.items()):
                if k[0] != key_id:
                    continue
                if br.state == OPEN:
                    # Keep the aggregate open gauge consistent with the
                    # board's contents, but do NOT route through _sync:
                    # unregistration is not a recovery, and counting a
                    # to=closed transition here would inflate the
                    # counter chaos_bench reads as proof the backend
                    # healed.
                    self._open -= 1
                    self._g_open.set(self._open)
                del self._breakers[k]
                # Cardinality hygiene: the pairing no longer exists, so
                # its labeled state series leaves the snapshot too —
                # under key churn (fresh keys per session) dead series
                # would otherwise accumulate in every snapshot forever.
                self._metrics.remove(labeled(
                    "serve_breaker_state", backend=k[1], key=k[0]))
