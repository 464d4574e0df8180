"""Closed-loop, open-loop and session-churn load generators for the
serving layer.

Counterpart of ``dcf_tpu/serve/loadgen.py``, line for line (host code:
key choices, request sizes and arrival gaps draw from seeded generators
in the same order as ``dcf_tpu``'s, so a seed gives both packages the
same request sequence).  ``chip_smoke.py`` phases 20-22 run them on the
card and ``reconcile_against_rollup`` on their metrics.

A submit target is anything with ``submit`` and ``n_bytes``: a
``DcfService``, an ``EdgeClient`` / ``EdgeClientPool`` (the wire) or a
``DcfRouter`` (the pod).

Closed-loop means each client thread keeps exactly one request in
flight: submit -> wait -> submit.  Offered load therefore tracks service
capacity instead of running away from it, which makes the headline
number a genuine sustainable throughput (an open-loop generator against
a saturated service measures its own queue, not the server).

Clients pick key ids from a seeded RNG over the registered set —
uniformly by default, or Zipf-weighted with ``skew`` > 0 (``key_ids``
order is rank order: p(rank r) ∝ 1/r^skew, the standard model of
skewed production query streams and the shape the serve-resident
frontier cache amortizes) — and draw ragged request sizes uniformly
from ``[min_points, max_points]``, the bursty many-keys shape the
batcher exists for.
Timing uses the SAME injectable clock as the service; this is the one
measurement harness allowed to loop on the clock, and the loop bound is
wall duration by design.

``open_loop_ramp`` generalizes the open-loop mode to a piecewise
offered-rate SCHEDULE: ordered ``(duration_s, rate_rps)`` segments
driven by one seeded arrival process, so a surge is one load shape —
ramp up, hold, fall idle — instead of three stitched runs whose seams
hide the transient.  A zero-rate segment offers nothing but still holds
the schedule (the window the autoscaler's scale-in hysteresis watches).
Latency stays anchored to each request's scheduled arrival across
segment boundaries.  ``open_loop`` is the one-segment case and
delegates.

``session_churn`` is the fresh-key-per-session mode: each client
registers a fresh key from a key-factory pool, evaluates one request
for both parties, and unregisters — the provisioning-bound arrival
pattern, as opposed to ``closed_loop``'s eval-bound re-use of a static
key set.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from dcf_tpu_torch.serve.admission import parse_priority
from dcf_tpu_torch.utils.benchtime import monotonic

__all__ = ["LoadgenResult", "closed_loop", "ChurnResult",
           "session_churn", "OpenLoopResult", "open_loop",
           "open_loop_ramp", "reconcile_against_rollup"]


@dataclass
class LoadgenResult:
    """One closed-loop run: totals, latencies, and what was shed.

    ``by_class``: per-priority ``{ok, shed, failed}`` counts —
    the client-side view the chaos harness reconciles against the
    service's ``serve_shed_by_class_total`` metrics (they must agree:
    shedding is observable on both sides of the admission door)."""

    duration_s: float
    requests_ok: int = 0
    points_ok: int = 0
    requests_failed: int = 0
    requests_shed: int = 0
    latencies_s: list = field(default_factory=list)
    by_class: dict = field(default_factory=dict)

    def _count(self, priority: str, outcome: str) -> None:
        cls = self.by_class.setdefault(
            priority, {"ok": 0, "shed": 0, "failed": 0})
        cls[outcome] += 1

    @property
    def throughput(self) -> float:
        """Reconstructed DCF evals/s: points completed per second."""
        return self.points_ok / self.duration_s if self.duration_s else 0.0

    def latency_quantiles(self) -> dict:
        return _quantiles(self.latencies_s, "")


@dataclass
class ChurnResult:
    """One session-churn run: per-session outcomes plus the two latency
    populations the key factory exists to separate — registration (pool
    pop vs synchronous keygen) and the whole session."""

    duration_s: float
    sessions_ok: int = 0
    sessions_failed: int = 0
    points_ok: int = 0
    register_latencies_s: list = field(default_factory=list)
    session_latencies_s: list = field(default_factory=list)

    @property
    def sessions_per_sec(self) -> float:
        return (self.sessions_ok / self.duration_s if self.duration_s
                else 0.0)

    def register_quantiles(self) -> dict:
        return _quantiles(self.register_latencies_s, "register_")

    def session_quantiles(self) -> dict:
        return _quantiles(self.session_latencies_s, "session_")


@dataclass
class OpenLoopResult:
    """One open-loop (Poisson-arrival) run.

    ``sent`` counts submits the service ACCEPTED (they reached the
    queue); ``shed`` counts typed refusals at submit (``shed_hinted``
    of which carried a ``retry_after_s``); accepted requests complete
    as ``ok`` / ``expired`` (``DeadlineExceededError``) / ``failed``
    (``failed`` also absorbs any non-shed submit-time error, so every
    arrival lands in exactly one bucket:
    ``attempts == shed + ok + expired + failed`` after the drain).
    The counts reconcile against the service's
    ``serve_requests_total`` / ``serve_shed_total`` /
    ``serve_deadline_expired_total``.

    ``latencies_s`` measure from each request's SCHEDULED arrival to
    completion — the anti-coordinated-omission definition: a request
    delayed by the queue (or by the generator catching up after a
    stall) is charged that delay, so ``p99`` reflects what an
    independent caller would have seen at this offered rate."""

    duration_s: float
    offered_rps: float
    sent: int = 0
    shed: int = 0
    shed_hinted: int = 0
    ok: int = 0
    expired: int = 0
    failed: int = 0
    points_ok: int = 0
    latencies_s: list = field(default_factory=list)
    by_class: dict = field(default_factory=dict)
    #: The offered-rate schedule: ``[(duration_s, rate_rps), ...]`` —
    #: one entry for a plain ``open_loop`` run; ``offered_rps`` is its
    #: duration-weighted mean.
    offered_segments: list = field(default_factory=list)

    def _count(self, priority: str, outcome: str) -> None:
        cls = self.by_class.setdefault(
            priority, {"ok": 0, "shed": 0, "expired": 0, "failed": 0})
        cls[outcome] += 1

    @property
    def attempts(self) -> int:
        """Every scheduled arrival (exact after the drain: each lands
        in exactly one of shed/ok/expired/failed)."""
        return self.shed + self.ok + self.expired + self.failed

    @property
    def throughput(self) -> float:
        """Completed evals/s: points of OK requests per second."""
        return self.points_ok / self.duration_s if self.duration_s \
            else 0.0

    def latency_quantiles(self) -> dict:
        return _quantiles(self.latencies_s, "")


def _quantiles(values, prefix: str) -> dict:
    """The one p50/p90/p99 extraction every result type reports
    (``prefix`` e.g. ``"register_"``; empty = the plain ``p50_s``
    keys)."""
    if not values:
        return {}
    arr = np.sort(np.asarray(values))

    def q(p):
        return float(arr[min(int(p * len(arr)), len(arr) - 1)])

    return {f"{prefix}p50_s": round(q(0.50), 6),
            f"{prefix}p90_s": round(q(0.90), 6),
            f"{prefix}p99_s": round(q(0.99), 6)}


def reconcile_against_rollup(res, rollup_before: dict,
                             rollup_after: dict) -> dict:
    """Reconcile one loadgen result against a metrics rollup
    (``serve.metrics.rollup_snapshots`` of the services' snapshots, or
    one service's snapshot).

    ``rollup_before``/``rollup_after``: rollups bracketing the run (the
    delta scopes the comparison to this run's traffic; the caller must
    quiesce other load across the bracket).  Returns a detail dict with
    per-class ``{"client": n, "pod": n}`` pairs and the overall verdict
    under ``"reconciled"``.  What is compared: per-class shed counts
    (submit-time sheds AND evictions both land in
    ``serve_shed_by_class_total`` — admission counts evictions as sheds
    delivered late) for both result types; open-loop results
    additionally reconcile ``sent`` against ``serve_requests_total`` and
    ``expired`` against ``serve_deadline_expired_total``.  Edge-tier
    refusals that never reach a shard queue (tenant token buckets, the
    router's suspect refusals) are OUTSIDE this ledger: they are counted
    by the tier that refused (``edge_tenant_refusals_total``,
    ``router_suspect_refusals_total``)."""

    def delta(name: str) -> int:
        return (rollup_after.get(name, 0) - rollup_before.get(name, 0))

    out: dict = {}
    ok = True
    by = res.by_class or {}
    for pr in ("critical", "normal", "batch"):
        client = by.get(pr, {}).get("shed", 0)
        pod = delta(f"serve_shed_by_class_total{{priority={pr}}}")
        out[f"shed_{pr}"] = {"client": client, "pod": pod}
        ok = ok and client == pod
    if isinstance(res, OpenLoopResult):
        out["sent"] = {"client": res.sent,
                       "pod": delta("serve_requests_total")}
        out["expired"] = {"client": res.expired,
                          "pod": delta("serve_deadline_expired_total")}
        ok = (ok and out["sent"]["client"] == out["sent"]["pod"]
              and out["expired"]["client"] == out["expired"]["pod"])
    out["reconciled"] = ok
    return out


def _client(service, key_ids, stop: threading.Event, res: LoadgenResult,
            lock: threading.Lock, rng: np.random.Generator,
            min_points: int, max_points: int, b: int, clock,
            priorities, weights, key_probs) -> None:
    from dcf_tpu_torch.errors import QueueFullError

    nb = service.n_bytes
    while not stop.is_set():
        m = int(rng.integers(min_points, max_points + 1))
        if key_probs is None:
            key_id = key_ids[int(rng.integers(0, len(key_ids)))]
        else:
            key_id = key_ids[int(rng.choice(len(key_ids), p=key_probs))]
        pr = priorities[int(rng.choice(len(priorities), p=weights))]
        xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
        t0 = clock()
        try:
            fut = service.submit(key_id, xs, b=b, priority=pr)
            fut.result()
        except QueueFullError:
            with lock:
                res.requests_shed += 1
                res._count(pr, "shed")
            continue
        except Exception:  # fallback-ok: a client must survive ANY
            # delivered failure — typed DcfErrors AND the raw backend
            # exception a retries-exhausted batch passes through (the
            # chaos harness injects exactly those); a dead client thread
            # silently halves the offered load.
            with lock:
                res.requests_failed += 1
                res._count(pr, "failed")
            continue
        dt = clock() - t0
        with lock:
            res.requests_ok += 1
            res.points_ok += m
            res.latencies_s.append(dt)
            res._count(pr, "ok")


def closed_loop(service, key_ids, *, duration_s: float, concurrency: int,
                min_points: int, max_points: int, seed: int = 2026,
                party: int = 0, clock=monotonic,
                priority_mix: dict | None = None,
                skew: float = 0.0, clients=None) -> LoadgenResult:
    """Drive ``service`` with ``concurrency`` closed-loop clients for
    ``duration_s`` seconds of wall time; returns the aggregated result.
    The service must be started (worker thread running).

    ``priority_mix``: ``{"critical": w, "normal": w, "batch": w}``
    weights (normalized here) drawn per request from the client's seeded
    RNG; default is the pre-priority behaviour (all NORMAL).

    ``skew``: Zipf exponent for key choice — 0 (default) is uniform;
    s > 0 weights rank r (the r-th entry of ``key_ids``) by 1/r^s,
    normalized.  Must be finite and >= 0 (the CLI benches validate the
    ``--skew`` flag before spending warmup time; this is the API-edge
    backstop).

    ``clients``: one submit target PER THREAD — the wire mode.  Pass a
    list of ``concurrency`` connected ``EdgeClient``s so each
    closed-loop client drives its own TCP connection (the in-process
    default shares the one ``service``)."""
    import math

    if not math.isfinite(skew) or skew < 0:
        # api-edge: loadgen config contract at the harness edge — a
        # negative or NaN exponent would die inside rng.choice in every
        # client thread, silently zeroing the offered load
        raise ValueError(f"skew must be finite and >= 0, got {skew}")
    key_probs = None
    if skew > 0:
        ranks = np.arange(1, len(list(key_ids)) + 1, dtype=np.float64)
        w = ranks ** -float(skew)
        key_probs = w / w.sum()
    if priority_mix:
        priorities = sorted(priority_mix)
        for p in priorities:
            # Unknown class names die here at the edge, not as a
            # parse_priority ValueError inside every client thread
            # (which _client's broadened except would count as
            # requests_failed — a 100%-failed run with no loud error).
            parse_priority(p)
        total = float(sum(priority_mix.values()))
        if total <= 0 or min(priority_mix.values()) < 0:
            # api-edge: loadgen config contract at the harness edge — a
            # negative weight would kill every client thread inside
            # rng.choice, silently zeroing the offered load
            raise ValueError(
                f"priority_mix weights must be >= 0 and sum > 0, "
                f"got {priority_mix}")
        weights = [priority_mix[p] / total for p in priorities]
    else:
        priorities, weights = ["normal"], [1.0]
    if clients is not None and len(clients) != concurrency:
        # api-edge: loadgen config contract at the harness edge — a
        # short list would silently drop offered load
        raise ValueError(
            f"clients must hold one target per thread "
            f"({concurrency}), got {len(clients)}")
    res = LoadgenResult(duration_s=0.0)
    lock = threading.Lock()
    stop = threading.Event()
    threads = [
        threading.Thread(
            target=_client,
            args=(clients[i] if clients is not None else service,
                  list(key_ids), stop, res, lock,
                  np.random.default_rng(seed + 7 * i), min_points,
                  max_points, party, clock, priorities, weights,
                  key_probs),
            name=f"loadgen-{i}", daemon=True)
        for i in range(concurrency)
    ]
    t0 = clock()
    for t in threads:
        t.start()
    # The generator loops on the clock by design: duration IS the bound.
    while clock() - t0 < duration_s:
        stop.wait(0.05)
    stop.set()
    for t in threads:
        t.join()
    res.duration_s = clock() - t0
    return res


def _session_client(service, pool: str, stop: threading.Event,
                    res: ChurnResult, lock: threading.Lock,
                    rng: np.random.Generator, min_points: int,
                    max_points: int, clock, tid: int,
                    durable: bool) -> None:
    nb = service.n_bytes
    n = 0
    while not stop.is_set():
        key_id = f"~sess/{tid}/{n}"
        n += 1
        m = int(rng.integers(min_points, max_points + 1))
        xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
        t0 = clock()
        try:
            service.register_key(key_id, pool=pool, durable=durable)
            t_reg = clock()
            f0 = service.submit(key_id, xs, b=0)
            f1 = service.submit(key_id, xs, b=1)
            f0.result()
            f1.result()
        except Exception:  # fallback-ok: a churn client must survive
            # ANY delivered failure (sheds, injected refill/eval faults,
            # retries-exhausted errors) — a dead client thread silently
            # halves the offered session arrival
            with lock:
                res.sessions_failed += 1
            try:
                service.unregister_key(key_id)
            except Exception:  # fallback-ok: best-effort cleanup of a
                # session that may never have registered
                pass
            continue
        service.unregister_key(key_id)
        dt = clock() - t0
        with lock:
            res.sessions_ok += 1
            res.points_ok += 2 * m
            res.register_latencies_s.append(max(t_reg - t0, 0.0))
            res.session_latencies_s.append(dt)


def session_churn(service, *, pool: str, duration_s: float,
                  concurrency: int, min_points: int, max_points: int,
                  seed: int = 2026, clock=monotonic,
                  durable: bool = False) -> ChurnResult:
    """Fresh-key-per-session churn: each closed-loop client repeatedly
    REGISTERS a fresh session key from the key-factory ``pool``
    (``register_key(key_id, pool=...)``), evaluates one ragged request
    for BOTH parties, and unregisters — the arrival pattern that
    provisions keys instead of re-using a static set.  The service must
    be started.  Same seeding and clock discipline as ``closed_loop``
    (client i draws from ``seed + 13 * i``)."""
    if min_points < 1 or min_points > max_points:
        # api-edge: loadgen config contract at the harness edge
        raise ValueError(
            f"bad request-size range [{min_points}, {max_points}]")
    res = ChurnResult(duration_s=0.0)
    lock = threading.Lock()
    stop = threading.Event()
    threads = [
        threading.Thread(
            target=_session_client,
            args=(service, pool, stop, res, lock,
                  np.random.default_rng(seed + 13 * i), min_points,
                  max_points, clock, i, durable),
            name=f"churn-{i}", daemon=True)
        for i in range(concurrency)
    ]
    t0 = clock()
    for t in threads:
        t.start()
    # The generator loops on the clock by design: duration IS the bound.
    while clock() - t0 < duration_s:
        stop.wait(0.05)
    stop.set()
    for t in threads:
        t.join()
    res.duration_s = clock() - t0
    return res


def _open_collector(out_q, res: OpenLoopResult, lock: threading.Lock,
                    clock) -> None:
    from dcf_tpu_torch.errors import DeadlineExceededError, QueueFullError

    while True:
        item = out_q.get()
        if item is None:
            return
        fut, t_sched, m, pr = item
        try:
            fut.result()
        except QueueFullError as e:
            # Refusals delivered through the future are sheds.  Two
            # flavors: the WIRE path's submit-time refusal (the server
            # shed BEFORE acceptance, after the local submit already
            # succeeded) retracts the ``sent`` — "sent" must mean "the
            # SERVICE accepted it" on both paths or the
            # serve_requests_total reconciliation breaks — while an
            # EVICTION (``e.evicted``) was accepted and counted before
            # losing its room, so its ``sent`` stands.
            with lock:
                if not getattr(e, "evicted", False):
                    res.sent -= 1
                res.shed += 1
                if getattr(e, "retry_after_s", None) is not None:
                    res.shed_hinted += 1
                res._count(pr, "shed")
            continue
        except DeadlineExceededError:
            with lock:
                res.expired += 1
                res._count(pr, "expired")
            continue
        except Exception:  # fallback-ok: a collector must survive ANY
            # delivered failure (typed DcfErrors and the raw backend
            # exception a retries-exhausted batch passes through) —
            # a dead collector would wedge the drain.
            with lock:
                res.failed += 1
                res._count(pr, "failed")
            continue
        dt = clock() - t_sched
        with lock:
            res.ok += 1
            res.points_ok += m
            res.latencies_s.append(max(dt, 0.0))
            res._count(pr, "ok")


def open_loop(service, key_ids, *, rate_rps: float, duration_s: float,
              min_points: int, max_points: int, seed: int = 2026,
              party: int = 0, clock=monotonic,
              priority_mix: dict | None = None, skew: float = 0.0,
              deadline_ms: float | None = None,
              collectors: int = 4) -> OpenLoopResult:
    """Offer ``rate_rps`` requests/s of Poisson arrivals to ``service``
    (a ``DcfService``, an ``EdgeClient`` or a ``DcfRouter`` — anything
    with ``submit``) for ``duration_s`` seconds, independent of
    completions, and return the ``OpenLoopResult``.  The service must
    be started.

    Arrivals are a seeded renewal process: inter-arrival gaps are
    exponential draws from ONE rng, so the whole arrival schedule (and
    every per-request key/size/priority draw) replays exactly per
    seed.  One scheduler thread submits on schedule; ``collectors``
    threads drain the futures so a slow completion never back-pressures
    the arrival process (that back-pressure is exactly the closed-loop
    artifact this mode exists to remove).  The run always DRAINS: every
    accepted future is collected before returning, however late.

    ``deadline_ms`` is attached to every request — under overload the
    service converts queue delay into typed ``DeadlineExceededError``
    expiries, which the result counts separately from failures."""
    import math

    if not rate_rps > 0 or not math.isfinite(rate_rps):
        # api-edge: loadgen config contract at the harness edge
        raise ValueError(
            f"rate_rps must be finite and > 0, got {rate_rps}")
    return open_loop_ramp(
        service, key_ids, segments=[(duration_s, rate_rps)],
        min_points=min_points, max_points=max_points, seed=seed,
        party=party, clock=clock, priority_mix=priority_mix,
        skew=skew, deadline_ms=deadline_ms, collectors=collectors)


def open_loop_ramp(service, key_ids, *, segments, min_points: int,
                   max_points: int, seed: int = 2026, party: int = 0,
                   clock=monotonic, priority_mix: dict | None = None,
                   skew: float = 0.0, deadline_ms: float | None = None,
                   collectors: int = 4) -> OpenLoopResult:
    """Offer a piecewise schedule of Poisson arrivals: ``segments`` is
    an ordered list of ``(duration_s, rate_rps)`` pairs, played
    back-to-back by ONE seeded arrival process — the surge shape (ramp
    up -> hold -> fall idle) as a single run, so the transient at each
    boundary lands in the same coordinated-omission-free latency
    population.  ``rate_rps`` may be 0: a quiet segment offers nothing
    but still holds the schedule.  A draw that lands past its segment's
    end is clamped to the boundary and the next segment's rate takes
    over there (seeded-deterministic, like everything else here).
    Everything not named ``segments`` behaves exactly as in
    ``open_loop`` — which is the one-segment case of this."""
    import math
    import queue as _queue

    segs = [(float(d), float(r)) for d, r in segments]
    if not segs:
        # api-edge: loadgen config contract at the harness edge
        raise ValueError("segments must be non-empty")
    for d, r in segs:
        if not (d > 0 and math.isfinite(d)) \
                or not (r >= 0 and math.isfinite(r)):
            # api-edge: loadgen config contract at the harness edge —
            # a zero-duration or negative-rate segment is a schedule
            # typo, not a load shape
            raise ValueError(
                f"each segment needs duration > 0 and rate >= 0, "
                f"got ({d}, {r})")
    if min_points < 1 or min_points > max_points:
        # api-edge: loadgen config contract at the harness edge
        raise ValueError(
            f"bad request-size range [{min_points}, {max_points}]")
    if not math.isfinite(skew) or skew < 0:
        # api-edge: same contract as closed_loop
        raise ValueError(f"skew must be finite and >= 0, got {skew}")
    from dcf_tpu_torch.errors import QueueFullError

    key_ids = list(key_ids)
    key_probs = None
    if skew > 0:
        ranks = np.arange(1, len(key_ids) + 1, dtype=np.float64)
        w = ranks ** -float(skew)
        key_probs = w / w.sum()
    if priority_mix:
        priorities = sorted(priority_mix)
        for p in priorities:
            parse_priority(p)  # typos die here, not per-arrival
        total = float(sum(priority_mix.values()))
        if total <= 0 or min(priority_mix.values()) < 0:
            # api-edge: same contract as closed_loop
            raise ValueError(
                f"priority_mix weights must be >= 0 and sum > 0, "
                f"got {priority_mix}")
        weights = [priority_mix[p] / total for p in priorities]
    else:
        priorities, weights = ["normal"], [1.0]

    nb = service.n_bytes
    rng = np.random.default_rng(seed)
    total_s = sum(d for d, _r in segs)
    mean_rps = sum(d * r for d, r in segs) / total_s
    res = OpenLoopResult(duration_s=0.0, offered_rps=mean_rps,
                         offered_segments=segs)
    lock = threading.Lock()
    out_q: _queue.Queue = _queue.Queue()
    pool = [threading.Thread(target=_open_collector,
                             args=(out_q, res, lock, clock),
                             name=f"openloop-collect-{i}", daemon=True)
            for i in range(max(collectors, 1))]
    for t in pool:
        t.start()
    # Purely a wait primitive (never set): the run is NOT cancellable
    # — the arrival schedule is the load definition and only the
    # schedule check ends the loop.
    sleeper = threading.Event()
    t0 = clock()
    seg_end = t0
    # The scheduler loops on the clock by design: the arrival SCHEDULE
    # is the load definition, and latency is measured from it.
    for seg_s, rate_rps in segs:
        t_next = seg_end  # a draw past the boundary was clamped here
        seg_end = seg_end + seg_s
        if rate_rps == 0:
            # Quiet segment: offer nothing, hold the schedule.
            wait = seg_end - clock()
            if wait > 0:
                sleeper.wait(wait)
            continue
        while True:
            t_next += float(rng.exponential(1.0 / rate_rps))
            if t_next >= seg_end:
                break
            wait = t_next - clock()
            if wait > 0:
                sleeper.wait(wait)
            m = int(rng.integers(min_points, max_points + 1))
            if key_probs is None:
                key_id = key_ids[int(rng.integers(0, len(key_ids)))]
            else:
                key_id = key_ids[int(
                    rng.choice(len(key_ids), p=key_probs))]
            pr = priorities[int(rng.choice(len(priorities), p=weights))]
            xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
            try:
                fut = service.submit(
                    key_id, xs, b=party,
                    deadline_ms=deadline_ms, priority=pr)
            except QueueFullError as e:
                with lock:
                    res.shed += 1
                    if getattr(e, "retry_after_s", None) is not None:
                        res.shed_hinted += 1
                    res._count(pr, "shed")
                continue
            except Exception:  # fallback-ok: the scheduler must
                # survive ANY submit-time failure (e.g. a hot-swapped
                # key) — a dead scheduler silently truncates the
                # offered load.
                with lock:
                    res.failed += 1
                    res._count(pr, "failed")
                continue
            with lock:
                res.sent += 1
            out_q.put((fut, t_next, m, pr))
    # Drain: every accepted future completes (the service's contract),
    # so the collectors empty the queue and exit on their sentinels.
    for _ in pool:
        out_q.put(None)
    for t in pool:
        t.join()
    res.duration_s = clock() - t0
    return res
