"""Demand-driven pod autoscaling: the capacity controller.

Counterpart of ``dcf_tpu/serve/capacity.py``: the same verdicts,
hysteresis, cooldown, rails, operator verbs, events and ``capacity_*``
metric series, so the same ``LoadSample`` streams give both packages
the same verdict stream, events and skip counts
(``tests/test_torch_capacity.py``).  Host code: the ring changes it
commits are ``MembershipController.join`` / ``drain``, and the shards
it sizes evaluate on the card.

Ring membership reacts to *health* (``serve.membership``); this
module closes the membership loop on demand: a ``CapacityController``
that watches the demand signals the pod already emits and sizes the
ring through the SAME epoch-fenced join/drain machinery, so
autoscaling inherits every membership fence instead of growing a
second reconfiguration path.

Signals (per shard, sampled off the health prober's PING/PONG round
trip — ``edge.LoadSample``, see ``serve.health``): queue points vs the
admission bound, the brownout latch, and the cumulative
``serve_shed_total`` / ``edge_refused_total`` /
``keyfactory_pool_misses_total`` counters.  Each control tick the
controller aggregates the freshest samples across shards via the
metrics-rollup path (``serve.metrics.rollup_snapshots``), differences
the cumulative counters against the previous tick, and computes a
typed ``CapacityVerdict``:

* **pressure** — the pod is demand-bound: the brownout fraction (shards
  in brownout / shards sampled) or the pooled queue fraction (summed
  points / summed bounds) crossed its threshold, or sheds / tenant
  refusals / key-factory pool misses accrued this tick;
* **idle** — the pod is over-provisioned: queue fraction under the idle
  threshold, zero brownout, zero new sheds/refusals/misses;
* **steady** — anything in between (including "nothing sampled yet":
  no evidence is never a scaling reason).

Hysteresis — the prober's fail-N/recover-M discipline lifted to
scaling decisions: scale-out only after ``scale_out_n`` CONSECUTIVE
pressure ticks, scale-in only after ``scale_in_m`` consecutive idle
ticks, any other verdict resets the streak.  On top of that sits a
hard **cooldown**: after ANY observed ring-epoch change — this
controller's own commits AND health ejects alike — no scaling change
commits for ``cooldown_s``, and the streaks reset.  Oscillating load
inside the hysteresis windows therefore produces exactly ZERO ring
churn.

Scale-out admits a host from the declared **standby pool** (ordered
``(ShardSpec, KeyStore | None)`` entries, provisioned but not in the
ring) through ``MembershipController.join``: warm-before-admit,
epoch-fenced.  Scale-in drains the LEAST-LOADED ring host (smallest
sampled queue points) through ``MembershipController.drain`` and
returns it to the back of the standby pool, store attached.  Safety
rails, each a counted skip (``capacity_skips_total{reason=...}``):
``min_hosts``, ``eject_inflight``, ``cooldown``, ``max_hosts``,
``no_standby``, ``no_sample``.  The automatic loop only ever counts;
the explicit ``scale_out()`` / ``scale_in(host_id)`` operator verbs
raise typed (``StandbyExhaustedError`` on an empty pool).

Fault seam: ``capacity.decide`` fires once per tick with the computed
verdict.  A handler raising ``ForcedVerdict(kind)`` FORCES that kind
for the tick; any other raise FREEZES the tick — no streak advance, no
scaling, counted ``reason=frozen``.

Driving modes mirror ``HealthProber`` / ``MembershipController``:
``start()`` spawns a worker ticking every ``interval_s``; ``pump()``
runs one tick inline on the injectable clock and returns the verdict
it acted on.  Every committed change is a typed ``CapacityEvent`` plus
the ``capacity_*`` metric series (see ``serve.metrics``).

Secret hygiene: this module handles load arithmetic and host names
only — key material stays inside the membership/edge calls it
delegates to.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace

from dcf_tpu_torch.errors import StandbyExhaustedError
from dcf_tpu_torch.serve.metrics import labeled, rollup_snapshots
from dcf_tpu_torch.serve.shardmap import ShardSpec
from dcf_tpu_torch.testing.faults import fire

__all__ = ["PRESSURE", "IDLE", "STEADY", "CapacityVerdict",
           "CapacityEvent", "ForcedVerdict", "CapacityController"]

PRESSURE = "pressure"
IDLE = "idle"
STEADY = "steady"

#: The typed verdict vocabulary (severity order, like HEALTH_CODES).
VERDICT_CODES = {IDLE: -1, STEADY: 0, PRESSURE: 1}


@dataclass(frozen=True)
class CapacityVerdict:
    """One control tick's aggregated pressure reading.  ``kind`` is
    ``pressure`` / ``idle`` / ``steady``; ``sampled`` how many ring
    hosts contributed a ``LoadSample`` this tick; the fractions and
    per-tick deltas are the aggregated signals the kind was computed
    from (deltas are 0 on a host's FIRST sample — pre-existing totals
    are history, not fresh demand); ``at`` the injectable-clock
    time."""

    kind: str
    sampled: int
    ring_size: int
    brownout_fraction: float
    queue_fraction: float
    shed_delta: int
    refusal_delta: int
    pool_miss_delta: int
    at: float


@dataclass(frozen=True)
class CapacityEvent:
    """One committed scaling change: ``kind`` is ``scale-out`` /
    ``scale-in``, ``epoch`` the ring epoch it committed under, ``at``
    the injectable-clock time."""

    kind: str
    host_id: str
    epoch: int
    at: float


class ForcedVerdict(Exception):
    """Control-flow exception for the ``capacity.decide`` seam: a
    handler raising this forces the tick's verdict to ``kind`` (the
    scripted-load-walk tool; see the module docstring).  Any OTHER
    exception from the seam freezes the tick instead."""

    def __init__(self, kind: str):
        if kind not in VERDICT_CODES:
            # api-edge: seam-usage contract (a typo'd kind must fail
            # the test arming it, not silently freeze every tick)
            raise ValueError(
                f"verdict kind must be one of "
                f"{sorted(VERDICT_CODES)}, got {kind!r}")
        super().__init__(kind)
        self.kind = kind


class CapacityController:
    """Load-signal capacity controller over one ``DcfRouter`` +
    ``MembershipController`` pair (see the module docstring).

    ``standby``: the declared standby pool — an ordered iterable of
    ``ShardSpec`` or ``(ShardSpec, KeyStore)`` entries, consumed
    front-first on scale-out; drained hosts return to the back.
    ``scale_out_n`` / ``scale_in_m``: the consecutive-tick hysteresis.
    ``cooldown_s``: the hard floor between ANY two membership changes
    this controller observes (its own and the health plane's).
    ``min_hosts`` defaults to the membership controller's floor;
    ``max_hosts`` (None = unbounded) caps scale-out.  Thresholds:
    ``brownout_pressure_fraction`` / ``queue_pressure_fraction`` flag
    pressure, ``queue_idle_fraction`` gates idle; the per-tick
    shed/refusal/pool-miss deltas flag pressure at >= 1.
    ``clock``: the injectable clock (defaults to the router's)."""

    def __init__(self, router, membership, *, standby=(),
                 interval_s: float = 1.0, scale_out_n: int = 3,
                 scale_in_m: int = 6, cooldown_s: float = 30.0,
                 min_hosts: int | None = None,
                 max_hosts: int | None = None,
                 brownout_pressure_fraction: float = 0.5,
                 queue_pressure_fraction: float = 0.75,
                 queue_idle_fraction: float = 0.05,
                 clock=None, max_events: int = 256):
        if interval_s <= 0:
            # api-edge: controller config contract
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}")
        if scale_out_n < 1 or scale_in_m < 1:
            # api-edge: controller config contract — 0 would scale on
            # a single tick's noise, i.e. flap on every reading
            raise ValueError(
                f"scale_out_n/scale_in_m must be >= 1, got "
                f"{scale_out_n}/{scale_in_m}")
        if cooldown_s < 0:
            # api-edge: controller config contract
            raise ValueError(
                f"cooldown_s must be >= 0, got {cooldown_s}")
        if not 0 < brownout_pressure_fraction <= 1 \
                or not 0 < queue_pressure_fraction <= 1:
            # api-edge: controller config contract
            raise ValueError(
                f"pressure fractions must be in (0, 1], got "
                f"brownout={brownout_pressure_fraction}/"
                f"queue={queue_pressure_fraction}")
        if not 0 <= queue_idle_fraction < queue_pressure_fraction:
            # api-edge: controller config contract — an idle threshold
            # at or above the pressure threshold makes one queue
            # reading both verdicts at once
            raise ValueError(
                f"queue_idle_fraction must be in [0, "
                f"queue_pressure_fraction), got {queue_idle_fraction}"
                f" vs {queue_pressure_fraction}")
        self._router = router
        self._membership = membership
        self.interval_s = float(interval_s)
        self.scale_out_n = int(scale_out_n)
        self.scale_in_m = int(scale_in_m)
        self.cooldown_s = float(cooldown_s)
        self.min_hosts = int(min_hosts if min_hosts is not None
                             else membership.min_hosts)
        if self.min_hosts < 1:
            # api-edge: controller config contract
            raise ValueError(
                f"min_hosts must be >= 1, got {self.min_hosts}")
        self.max_hosts = None if max_hosts is None else int(max_hosts)
        if self.max_hosts is not None \
                and self.max_hosts < self.min_hosts:
            # api-edge: controller config contract
            raise ValueError(
                f"max_hosts must be >= min_hosts, got "
                f"{self.max_hosts} < {self.min_hosts}")
        self.brownout_pressure_fraction = float(
            brownout_pressure_fraction)
        self.queue_pressure_fraction = float(queue_pressure_fraction)
        self.queue_idle_fraction = float(queue_idle_fraction)
        self._clock = clock if clock is not None else router._clock
        self._max_events = int(max_events)
        self._lock = threading.Lock()       # standby/event state
        self._pump_lock = threading.Lock()  # one control tick at a time
        # guarded-by: _lock
        self._standby: list = [self._standby_entry(e) for e in standby]
        # Tick-cursor state: written only by the (serialized) control
        # tick, so the pump lock IS its guard.
        # guarded-by: _pump_lock
        self._prev_totals: dict = {}  # host -> (shed, refused, misses)
        # guarded-by: _pump_lock
        self._last_loads: dict = {}
        # guarded-by: _pump_lock
        self._pressure_streak = 0
        # guarded-by: _pump_lock
        self._idle_streak = 0
        # guarded-by: _pump_lock
        self._last_epoch = router.ring_epoch
        # guarded-by: _pump_lock
        self._cooldown_until = 0.0
        self.last_verdict: CapacityVerdict | None = None
        # guarded-by: _lock
        self._events: list[CapacityEvent] = []
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        m = router.metrics
        self._metrics = m
        self._c_ticks = m.counter("capacity_ticks_total")
        self._c_pressure = m.counter("capacity_pressure_ticks_total")
        self._c_idle = m.counter("capacity_idle_ticks_total")
        self._c_out = m.counter("capacity_scale_out_total")
        self._c_in = m.counter("capacity_scale_in_total")
        self._c_failures = m.counter("capacity_scale_failures_total")
        self._c_forced = m.counter("capacity_forced_verdicts_total")
        self._g_standby = m.gauge("capacity_standby_hosts")
        self._g_pressure_streak = m.gauge("capacity_pressure_streak")
        self._g_idle_streak = m.gauge("capacity_idle_streak")
        self._g_queue_fraction = m.gauge("capacity_queue_fraction")
        self._g_brownout_fraction = m.gauge(
            "capacity_brownout_fraction")
        self._g_standby.set(len(self._standby))

    @staticmethod
    def _standby_entry(entry) -> tuple:
        if isinstance(entry, ShardSpec):
            return entry, None
        spec, store = entry
        if not isinstance(spec, ShardSpec):
            # api-edge: standby-pool declaration contract
            raise ValueError(
                f"standby entries must be ShardSpec or (ShardSpec, "
                f"store), got {type(spec).__name__}")
        return spec, store

    # -- observability ------------------------------------------------

    def events(self) -> list:
        """Drain the committed scaling events observed so far
        (bounded, like the sibling controllers — the ``capacity_*``
        metrics are the durable record)."""
        with self._lock:
            out, self._events = self._events, []
            return out

    def standby(self) -> list:
        """Host ids currently waiting in the standby pool, in
        admission order."""
        with self._lock:
            return [spec.host_id for spec, _store in self._standby]

    def add_standby(self, spec: ShardSpec, store=None) -> None:
        """Declare one more standby host (appended — the pool is
        consumed front-first)."""
        entry = self._standby_entry((spec, store))
        with self._lock:
            self._standby.append(entry)
            self._g_standby.set(len(self._standby))

    def _record(self, kind: str, host_id: str,
                epoch: int) -> CapacityEvent:
        ev = CapacityEvent(kind, host_id, int(epoch), self._clock())
        with self._lock:
            self._events.append(ev)
            del self._events[:-self._max_events]
        return ev

    def _skip(self, reason: str) -> None:
        self._metrics.counter(labeled(
            "capacity_skips_total", reason=reason)).inc()

    # -- the control tick ---------------------------------------------

    # holds-lock: _pump_lock
    def _assess(self, now: float) -> CapacityVerdict:
        """Aggregate the freshest per-shard samples into one verdict
        (the metrics-rollup path: per-shard mini-snapshots summed by
        ``rollup_snapshots``, exactly like the pod dashboard view)."""
        ring_ids = set(self._router.map.host_ids())
        loads = {h: s for h, s in self._router.health.loads().items()
                 if h in ring_ids}
        self._last_loads = loads
        snaps = []
        deltas = {"shed": 0, "refused": 0, "misses": 0}
        fresh_totals: dict = {}
        for host_id, s in sorted(loads.items()):
            if s is None:
                continue  # answered, but no load surface
            snaps.append({
                "serve_queue_points": s.queue_points,
                "serve_queue_limit": s.queue_limit,
                "serve_brownout": 1 if s.brownout else 0,
                "serve_shed_total": s.shed_total,
                "edge_refused_total": s.refusals_total,
                "keyfactory_pool_misses_total": s.pool_misses,
            })
            totals = (s.shed_total, s.refusals_total, s.pool_misses)
            prev = self._prev_totals.get(host_id)
            if prev is not None:
                # max(0, ...): a restarted shard's counters reset —
                # a negative "delta" is a restart, not negative demand
                deltas["shed"] += max(totals[0] - prev[0], 0)
                deltas["refused"] += max(totals[1] - prev[1], 0)
                deltas["misses"] += max(totals[2] - prev[2], 0)
            fresh_totals[host_id] = totals
        self._prev_totals = fresh_totals  # hosts that left fall away
        sampled = len(snaps)
        agg = rollup_snapshots(snaps) if snaps else {}
        qp = agg.get("serve_queue_points", 0)
        ql = agg.get("serve_queue_limit", 0)
        queue_fraction = (qp / ql) if ql else 0.0
        brownout_fraction = (agg.get("serve_brownout", 0) / sampled
                             if sampled else 0.0)
        if sampled == 0:
            kind = STEADY  # no evidence is never a scaling reason
        elif (brownout_fraction >= self.brownout_pressure_fraction
              or queue_fraction >= self.queue_pressure_fraction
              or deltas["shed"] >= 1 or deltas["refused"] >= 1
              or deltas["misses"] >= 1):
            kind = PRESSURE
        elif queue_fraction <= self.queue_idle_fraction \
                and brownout_fraction == 0:
            kind = IDLE
        else:
            kind = STEADY
        return CapacityVerdict(
            kind=kind, sampled=sampled, ring_size=len(ring_ids),
            brownout_fraction=brownout_fraction,
            queue_fraction=queue_fraction,
            shed_delta=deltas["shed"],
            refusal_delta=deltas["refused"],
            pool_miss_delta=deltas["misses"], at=now)

    def pump(self) -> CapacityVerdict | None:
        """One control tick inline (the deterministic driving mode):
        aggregate, decide, and — hysteresis and rails permitting —
        scale.  Returns the verdict acted on (post-seam), or None for
        a frozen tick."""
        with self._pump_lock:
            now = self._clock()
            self._c_ticks.inc()
            verdict = self._assess(now)
            try:
                fire("capacity.decide", verdict.kind, verdict)
            except ForcedVerdict as f:
                self._c_forced.inc()
                verdict = replace(verdict, kind=f.kind)
            except Exception:  # fallback-ok: ANY other raise from the
                # seam freezes the tick — no streak advance, no
                # scaling, counted; the operator's emergency brake
                self._skip("frozen")
                return None
            self.last_verdict = verdict
            self._g_queue_fraction.set(
                round(verdict.queue_fraction, 9))
            self._g_brownout_fraction.set(
                round(verdict.brownout_fraction, 9))
            # The epoch-observed cooldown: ANY membership commit since
            # the last tick — ours or the health plane's — restarts
            # the clock AND resets the streaks (a ring change
            # invalidates the evidence gathered against the old ring).
            epoch = self._router.ring_epoch
            if epoch != self._last_epoch:
                self._last_epoch = epoch
                self._cooldown_until = now + self.cooldown_s
                self._pressure_streak = 0
                self._idle_streak = 0
            if verdict.kind == PRESSURE:
                self._c_pressure.inc()
                self._pressure_streak += 1
                self._idle_streak = 0
            elif verdict.kind == IDLE:
                self._c_idle.inc()
                self._idle_streak += 1
                self._pressure_streak = 0
            else:
                self._pressure_streak = 0
                self._idle_streak = 0
            self._g_pressure_streak.set(self._pressure_streak)
            self._g_idle_streak.set(self._idle_streak)
            if self._pressure_streak >= self.scale_out_n:
                self._maybe_scale_out(now)
            elif self._idle_streak >= self.scale_in_m:
                self._maybe_scale_in(now)
            return verdict

    # -- scaling ------------------------------------------------------

    # holds-lock: _pump_lock
    def _rails(self, now: float) -> str | None:
        """The shared rails, in announcement order; returns the
        counted skip reason or None (clear to scale)."""
        if now < self._cooldown_until:
            return "cooldown"
        if self._membership.eject_in_flight():
            return "eject_inflight"
        return None

    # holds-lock: _pump_lock
    def _maybe_scale_out(self, now: float) -> None:
        reason = self._rails(now)
        if reason is None and self.max_hosts is not None \
                and len(self._router.map) >= self.max_hosts:
            reason = "max_hosts"
        entry = None
        if reason is None:
            # Emptiness check and pop under ONE lock acquisition: an
            # unlocked `not self._standby` probe could race a
            # concurrent pool mutation between check and pop — the
            # claim must be atomic with the decision that the pool has
            # something to claim.
            with self._lock:
                if self._standby:
                    entry = self._standby.pop(0)
                    self._g_standby.set(len(self._standby))
                else:
                    reason = "no_standby"
        if reason is not None:
            self._skip(reason)
            return
        spec, store = entry
        try:
            ev = self._membership.join(spec, store=store)
        except Exception:  # fallback-ok: a failed join (the standby
            # host died, a warm source failed) was counted by the
            # membership layer; the host returns to the FRONT of the
            # pool and the streak retries on a later tick
            self._c_failures.inc()
            with self._lock:
                self._standby.insert(0, (spec, store))
                self._g_standby.set(len(self._standby))
            return
        self._after_change(now)
        self._c_out.inc()
        self._record("scale-out", spec.host_id, ev.epoch)

    # holds-lock: _pump_lock
    def _maybe_scale_in(self, now: float) -> None:
        reason = self._rails(now)
        if reason is None \
                and len(self._router.map) <= self.min_hosts:
            reason = "min_hosts"
        victim = None
        if reason is None:
            sampled = {h: s for h, s in self._last_loads.items()
                       if s is not None and h in self._router.map}
            if not sampled:
                reason = "no_sample"
            else:
                victim = min(sorted(sampled),
                             key=lambda h: sampled[h].queue_points)
        if reason is not None:
            self._skip(reason)
            return
        spec = self._router.map.get(victim)
        store = self._membership.store_for(victim)
        try:
            ev = self._membership.drain(victim)
        except Exception:  # fallback-ok: a failed drain (a migration
            # source died) was counted by the membership layer; the
            # host stays a full member and the streak retries later
            self._c_failures.inc()
            return
        self._after_change(now)
        self._c_in.inc()
        if spec is not None:
            # Back of the pool: a just-drained host is the LAST one a
            # future surge should re-admit (coldest caches).
            with self._lock:
                self._standby.append((spec, store))
                self._g_standby.set(len(self._standby))
        self._record("scale-in", victim, ev.epoch)

    # holds-lock: _pump_lock
    def _after_change(self, now: float) -> None:
        """Bookkeeping after OUR OWN committed change: adopt the fresh
        epoch (so the next tick's observation does not double-restart
        the cooldown), start the cooldown, reset the streaks."""
        self._last_epoch = self._router.ring_epoch
        self._cooldown_until = now + self.cooldown_s
        self._pressure_streak = 0
        self._idle_streak = 0
        self._g_pressure_streak.set(0)
        self._g_idle_streak.set(0)

    # -- operator verbs -----------------------------------------------

    def scale_out(self) -> CapacityEvent:
        """Admit the next standby host NOW (the operator's verb):
        bypasses the hysteresis and the cooldown but never the
        membership fences.  Raises typed ``StandbyExhaustedError`` on
        an empty pool — an operator asking for capacity that does not
        exist must not get a silent no-op."""
        with self._pump_lock:
            with self._lock:
                if not self._standby:
                    raise StandbyExhaustedError(
                        "standby pool is empty: no host to admit "
                        "(declare more with add_standby, or drain "
                        "elsewhere first)")
                spec, store = self._standby.pop(0)
                self._g_standby.set(len(self._standby))
            try:
                ev = self._membership.join(spec, store=store)
            except Exception:  # fallback-ok: count + restore the pool,
                # then re-raise — the operator called, the operator
                # sees the join's own typed failure
                self._c_failures.inc()
                with self._lock:
                    self._standby.insert(0, (spec, store))
                    self._g_standby.set(len(self._standby))
                raise
            self._after_change(self._clock())
            self._c_out.inc()
            return self._record("scale-out", spec.host_id, ev.epoch)

    def scale_in(self, host_id: str) -> CapacityEvent:
        """Drain ``host_id`` NOW and return it to the standby pool
        (the operator's verb): bypasses hysteresis and cooldown, never
        the membership fences (``drain`` refuses the last host; the
        ``min_hosts`` floor is the AUTOMATIC loop's rail — a planned
        decommission is the operator's call, same as membership)."""
        with self._pump_lock:
            spec = self._router.map.get(host_id)
            store = self._membership.store_for(host_id)
            ev = self._membership.drain(host_id)
            self._after_change(self._clock())
            self._c_in.inc()
            if spec is not None:
                with self._lock:
                    self._standby.append((spec, store))
                    self._g_standby.set(len(self._standby))
            return self._record("scale-in", host_id, ev.epoch)

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "CapacityController":
        """Spawn the control worker (idempotent): one tick every
        ``interval_s``."""
        if self._worker is None or not self._worker.is_alive():
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._worker_loop, name="dcf-capacity",
                daemon=True)
            self._worker.start()
        return self

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.pump()
            except Exception:  # fallback-ok: the control worker must
                # outlive any one tick's failure (scaling failures are
                # counted inside pump's per-change containment)
                self._c_failures.inc()
            self._stop.wait(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        worker = self._worker
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            worker.join(5.0)
        self._worker = None

    def __repr__(self) -> str:
        return (f"CapacityController(ring={self._router.map.host_ids()},"
                f" standby={self.standby()}, "
                f"scale_out_n={self.scale_out_n}, "
                f"scale_in_m={self.scale_in_m}, "
                f"cooldown_s={self.cooldown_s})")
