"""Active shard health probing for the pod routing tier.

Counterpart of ``dcf_tpu/serve/health.py``: the same state machine,
probe frames and metric names.  Request traffic alone tells the router
only that a forwarded request died (the shard goes suspect for a
cooldown); it never tells it that a shard recovered.  This module is
the control plane that adds observed state:

* the prober sends a lightweight DCFE **PING** frame to every shard
  through the router's existing ``EdgeClientPool``s — no second
  transport, no second health protocol — every ``interval_s``;
* per-shard state walks **UP -> SUSPECT -> DOWN -> UP** with fail-N /
  recover-M hysteresis (the breaker's vocabulary: ``fail_n``
  consecutive probe failures mirror ``failures_to_open``,
  ``recover_m`` consecutive successes mirror the half-open probe
  discipline — one blip is SUSPECT, not an outage; one lucky pong is
  not a recovery)::

                     1st probe failure
          UP ─────────────────────────► SUSPECT ──┐
          ▲  ◄──────────────────────────┘ │       │ fail_n consecutive
          │        1 probe success        │       │ failures (total)
          │                               ▼       ▼
          └───────────────────────────── DOWN ◄───┘
            recover_m consecutive successes
            AND the recovery gate passes (anti-entropy)

* every transition is a typed ``HealthEvent`` (drained via
  ``events()``, pushed via ``on_transition``) and a metrics write —
  ``router_health_state{shard=...}`` (0 up / 1 suspect / 2 down),
  ``router_probes_total`` / ``router_probe_failures_total{shard=...}``,
  ``router_health_transitions_total{to=...}`` — so dashboards and the
  chaos gates read the same facts the router routes on;
* **DOWN is promotion**: the router drops DOWN hosts from the
  placement walk for EVERY priority class, so each victim key's
  replica serves as owner (no keys move — rendezvous already pinned
  the successor).  SUSPECT keeps the request-signal semantics:
  CRITICAL fails over, everything else is refused typed with
  ``retry_after_s``;
* **recovery is gated**: the DOWN -> UP transition runs
  ``recover_gate(host_id)`` first (the router wires the anti-entropy
  pass here — ``serve.replicate``); a gate that fails or raises keeps
  the shard DOWN and resets the recovery count, because re-admitting
  a shard that could not converge its registrations would serve stale
  generations — the silent-wrong-answer partition bug.

Driving modes, mirroring ``DcfService``: ``start()`` spawns a daemon
thread probing every ``interval_s`` (production); ``pump()`` runs ONE
probe round inline — the deterministic mode tests drive with armed
fault seams and a fake clock (event timestamps come from the
injectable clock; the thread's wait is a plain ``Event.wait``, never
``time.*``).

Cardinality: ``remove_target`` (ring membership churn) forgets the
host's state AND its labeled metric series — the ``BreakerBoard.forget``
discipline applied to the health plane, so host churn cannot grow the
snapshot without limit.

Load sampling: a target that exposes
``ping_load`` (the router's ``EdgeClientPool`` does) is probed with it
instead of ``ping`` — the SAME round trip, now also carrying the
shard's ``edge.LoadSample`` back (queue points vs bound, brownout,
cumulative shed/refusal/pool-miss counters).  The freshest sample per
host is readable via ``loads()`` (``dcf_tpu``'s capacity controller
reads the same samples).  Gated exactly like the epoch kwarg: a scripted
test target without ``ping_load`` keeps its one-argument ``ping``
signature and simply yields no sample — liveness never depends on the
load surface.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from dcf_tpu_torch.serve.metrics import Metrics, labeled
from dcf_tpu_torch.utils.benchtime import monotonic

__all__ = ["UP", "SUSPECT", "DOWN", "HEALTH_CODES", "HealthEvent",
           "HealthProber"]

UP = "up"
SUSPECT = "suspect"
DOWN = "down"

#: Gauge encoding, severity-sorted like the breaker's STATE_CODES.
HEALTH_CODES = {UP: 0, SUSPECT: 1, DOWN: 2}


@dataclass(frozen=True)
class HealthEvent:
    """One observed ring-state transition: ``host_id`` went
    ``frm -> to`` at injectable-clock time ``at``."""

    host_id: str
    frm: str
    to: str
    at: float


class _HostHealth:
    """Per-host hysteresis state (guarded by the prober's lock)."""

    __slots__ = ("state", "fails", "oks")

    def __init__(self):
        self.state = UP
        self.fails = 0  # consecutive probe failures
        self.oks = 0    # consecutive probe successes while DOWN


class HealthProber:
    """Active prober over ``{host_id: pingable}`` targets (anything
    with ``ping(timeout=)`` — the router hands its shard pools in).
    See the module docstring for the state machine and the driving
    modes.  Thread-safe: ``pump`` serializes probe rounds, the state
    lock makes reads consistent with the metrics that report them."""

    def __init__(self, targets: dict, *, interval_s: float = 0.25,
                 timeout_s: float | None = None, fail_n: int = 3,
                 recover_m: int = 2, clock=monotonic,
                 metrics: Metrics | None = None, recover_gate=None,
                 on_transition=None, max_events: int = 256,
                 epoch_source=None):
        if interval_s <= 0:
            # api-edge: prober config contract
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}")
        if fail_n < 1 or recover_m < 1:
            # api-edge: prober config contract — 0 would transition on
            # nothing, i.e. flap on every probe
            raise ValueError(
                f"fail_n/recover_m must be >= 1, got "
                f"{fail_n}/{recover_m}")
        self.interval_s = float(interval_s)
        # Default probe budget: generous relative to the interval — a
        # ping slower than the cadence on a loaded host is congestion,
        # not death, and a too-tight budget turns CPU contention into
        # spurious DOWN verdicts (a dead/cut target still fails FAST:
        # refused dials and resets do not wait the budget out).
        self.timeout_s = (float(timeout_s) if timeout_s is not None
                          else max(self.interval_s, 1.0))
        self.fail_n = int(fail_n)
        self.recover_m = int(recover_m)
        self._clock = clock
        self._metrics = metrics if metrics is not None else Metrics()
        self._recover_gate = recover_gate
        self._on_transition = on_transition
        # Epoch dissemination: when set (a zero-arg callable
        # returning the router's current ring epoch), every probe
        # carries it — shards adopt a committed membership epoch within
        # about one probe interval, and a STALE prober's pings are
        # refused E_EPOCH (one more probe failure: the hysteresis walks
        # the stale router's view DOWN, which is exactly the structural
        # refusal the fence promises).  None = unfenced pings, and the
        # target's ``ping`` is called WITHOUT the epoch kwarg (scripted
        # test targets keep their one-argument signature).
        self._epoch_source = epoch_source
        self._max_events = int(max_events)
        self._lock = threading.Lock()
        self._pump_lock = threading.Lock()  # one probe round at a time
        # guarded-by: _lock
        self._targets = dict(targets)
        # guarded-by: _lock
        self._hosts = {hid: _HostHealth() for hid in self._targets}
        # Freshest per-host LoadSample off the probe round trip
        #: None = probed but no load surface; absent =
        # never successfully probed (or removed).
        # guarded-by: _lock
        self._loads: dict = {}
        # guarded-by: _lock
        self._events: list[HealthEvent] = []
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        m = self._metrics
        self._c_transitions = m.counter(
            "router_health_transitions_total")
        self._c_gate_failures = m.counter(
            "router_recover_gate_failures_total")
        self._g_down = m.gauge("router_down_shards")
        for hid in self._targets:
            self._init_series(hid)

    def _init_series(self, host_id: str) -> None:
        self._metrics.gauge(labeled(
            "router_health_state", shard=host_id)).set(0)
        self._metrics.counter(labeled(
            "router_probes_total", shard=host_id))
        self._metrics.counter(labeled(
            "router_probe_failures_total", shard=host_id))

    # -- state reads ---------------------------------------------------

    def state(self, host_id: str) -> str:
        with self._lock:
            h = self._hosts.get(host_id)
            return h.state if h is not None else UP

    def states(self) -> dict:
        with self._lock:
            return {hid: h.state for hid, h in self._hosts.items()}

    def events(self) -> list:
        """Drain the typed transition events observed so far (bounded:
        oldest dropped past ``max_events`` — the stream is a debugging
        aid; the state machine and metrics are the durable record)."""
        with self._lock:
            out, self._events = self._events, []
            return out

    def loads(self) -> dict:
        """Freshest ``{host_id: LoadSample | None}`` sampled off the
        probe round trips.  None = the host answered but
        has no load surface; a host that never answered a load probe
        is absent.  A snapshot copy — safe to iterate while probing."""
        with self._lock:
            return dict(self._loads)

    # -- targets (bounded cardinality) ---------------------------------

    def add_target(self, host_id: str, target) -> None:
        with self._lock:
            self._targets[host_id] = target
            if host_id not in self._hosts:
                self._hosts[host_id] = _HostHealth()
        self._init_series(host_id)

    def remove_target(self, host_id: str) -> None:
        """Forget a host that left the ring: state AND its labeled
        series (the ``BreakerBoard.forget`` cardinality discipline —
        host churn must not grow probe state or the snapshot without
        limit)."""
        with self._lock:
            self._targets.pop(host_id, None)
            self._hosts.pop(host_id, None)
            self._loads.pop(host_id, None)
        for name in ("router_health_state", "router_probes_total",
                     "router_probe_failures_total"):
            self._metrics.remove(labeled(name, shard=host_id))
        self._sync_down_gauge()

    # -- probing -------------------------------------------------------

    def pump(self) -> dict:
        """One probe round inline (the deterministic driving mode):
        ping every target, feed the outcomes through the hysteresis,
        return the post-round ``{host_id: state}``."""
        with self._pump_lock:
            with self._lock:
                targets = list(self._targets.items())
            for host_id, target in targets:
                self._metrics.counter(labeled(
                    "router_probes_total", shard=host_id)).inc()
                sampler = getattr(target, "ping_load", None)
                kwargs = {"timeout": self.timeout_s}
                if self._epoch_source is not None:
                    kwargs["epoch"] = int(self._epoch_source())
                try:
                    if callable(sampler):
                        # One round trip, two facts: liveness AND the
                        # shard's demand signals — never a
                        # second probe protocol.
                        _, sample = sampler(**kwargs)
                        with self._lock:
                            if host_id in self._hosts:
                                self._loads[host_id] = sample
                        ok = True
                    elif self._epoch_source is not None:
                        ok = bool(target.ping(**kwargs))
                    else:
                        # Scripted test targets keep their one-argument
                        # signature (no epoch kwarg, no load surface).
                        ok = bool(target.ping(timeout=self.timeout_s))
                except Exception:  # fallback-ok: ANY probe failure
                    # (transport death, dark-target backoff, timeout)
                    # is one observation for the hysteresis — the
                    # prober must outlive every probe outcome
                    ok = False
                if not ok:
                    self._metrics.counter(labeled(
                        "router_probe_failures_total",
                        shard=host_id)).inc()
                self.observe(host_id, ok)
            return self.states()

    def observe(self, host_id: str, ok: bool) -> None:
        """Feed one probe outcome through the hysteresis (public so
        tests — and a router that learned something out-of-band — can
        drive the state machine without a socket)."""
        gate_host = None
        with self._lock:
            h = self._hosts.get(host_id)
            if h is None:
                return  # removed mid-round: nothing to resurrect
            before = h.state
            if ok:
                if h.state == UP:
                    h.fails = 0
                elif h.state == SUSPECT:
                    # One good probe clears a blip (the breaker's
                    # half-open-success analog at the suspicion stage).
                    h.state = UP
                    h.fails = 0
                else:  # DOWN
                    h.fails = 0  # the consecutive-failure run is
                    # broken; _try_recover's post-gate check reads
                    # fails > 0 as "new failure evidence mid-gate"
                    h.oks += 1
                    if h.oks >= self.recover_m:
                        h.oks = 0
                        gate_host = host_id  # gate OUTSIDE the lock
            else:
                h.oks = 0
                h.fails += 1
                if h.state == UP:
                    h.state = SUSPECT
                elif h.state == SUSPECT and h.fails >= self.fail_n:
                    h.state = DOWN
            after = h.state
        if after != before:
            self._transition(host_id, before, after)
        if gate_host is not None:
            self._try_recover(gate_host)

    def _try_recover(self, host_id: str) -> None:
        """recover_m consecutive successes observed on a DOWN host:
        run the recovery gate (anti-entropy) and only then re-admit.
        Runs OUTSIDE the state lock — the gate does wire round trips —
        so a concurrent failed probe can race it; the post-gate check
        re-admits only a host that is still DOWN with no new failure
        evidence (``oks`` was reset, so a race costs at most one more
        recover_m window, never a wrong UP)."""
        if self._recover_gate is not None:
            try:
                gate_ok = self._recover_gate(host_id)
            except Exception:  # fallback-ok: a failing gate (a peer
                # died mid-exchange) keeps the shard DOWN — counted,
                # retried on the next recover_m window
                gate_ok = False
            if not gate_ok:
                self._c_gate_failures.inc()
                return
        with self._lock:
            h = self._hosts.get(host_id)
            if h is None or h.state != DOWN or h.fails > 0:
                return
            h.state = UP
            h.fails = 0
            h.oks = 0
        self._transition(host_id, DOWN, UP)

    def _transition(self, host_id: str, frm: str, to: str) -> None:
        ev = HealthEvent(host_id, frm, to, self._clock())
        with self._lock:
            self._events.append(ev)
            del self._events[:-self._max_events]
        self._c_transitions.inc()
        self._metrics.counter(labeled(
            "router_health_transitions_total", to=to)).inc()
        self._metrics.gauge(labeled(
            "router_health_state",
            shard=host_id)).set(HEALTH_CODES[to])
        self._sync_down_gauge()
        if self._on_transition is not None:
            self._on_transition(ev)

    def _sync_down_gauge(self) -> None:
        with self._lock:
            self._g_down.set(sum(
                1 for h in self._hosts.values() if h.state == DOWN))

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "HealthProber":
        """Spawn the probe worker (idempotent)."""
        if self._worker is None or not self._worker.is_alive():
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._worker_loop, name="dcf-health-probe",
                daemon=True)
            self._worker.start()
        return self

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            self.pump()
            self._stop.wait(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        worker = self._worker
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            worker.join(5.0)
        self._worker = None

    def __repr__(self) -> str:
        # dcflint: disable=guarded-by diagnostic snapshot: sorted()
        # copies under the GIL, and a repr racing add/remove_target may
        # legitimately show either side of the change
        return (f"HealthProber(hosts={sorted(self._targets)}, "
                f"interval_s={self.interval_s}, fail_n={self.fail_n}, "
                f"recover_m={self.recover_m})")
