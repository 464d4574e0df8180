"""Closed-loop load generator for the serving layer.

Counterpart of ``dcf_tpu/serve/loadgen.py``'s closed loop, line for
line (host code: the clients' key choices and request sizes draw from
one seeded generator in the same order as ``dcf_tpu``'s, so a seed gives
both packages the same request sequence).  ``chip_smoke.py`` phase 20
runs ``closed_loop`` on the card and ``reconcile_against_rollup`` on its
metrics.  ``dcf_tpu``'s open-loop, ramp and session-churn modes are not
carried yet (ROADMAP.md).

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
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from dcf_tpu_torch.serve.admission import parse_priority
from dcf_tpu_torch.utils.benchtime import monotonic

__all__ = ["LoadgenResult", "closed_loop", "reconcile_against_rollup"]


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
        """p50 / p90 / p99 of the completed requests' latencies."""
        if not self.latencies_s:
            return {}
        arr = np.sort(np.asarray(self.latencies_s))

        def q(p):
            return float(arr[min(int(p * len(arr)), len(arr) - 1)])

        return {"p50_s": round(q(0.50), 6), "p90_s": round(q(0.90), 6),
                "p99_s": round(q(0.99), 6)}


def reconcile_against_rollup(res: LoadgenResult, rollup_before: dict,
                             rollup_after: dict) -> dict:
    """Reconcile one closed-loop result against a metrics rollup
    (``serve.metrics.rollup_snapshots`` of the services' snapshots, or
    one service's snapshot).

    ``rollup_before``/``rollup_after``: rollups bracketing the run (the
    delta scopes the comparison to this run's traffic; the caller must
    quiesce other load across the bracket).  Returns a detail dict with
    per-class ``{"client": n, "pod": n}`` pairs and the overall verdict
    under ``"reconciled"``.  What is compared: per-class shed counts
    (submit-time sheds AND evictions both land in
    ``serve_shed_by_class_total`` — admission counts evictions as sheds
    delivered late)."""

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
                skew: float = 0.0) -> LoadgenResult:
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
    backstop)."""
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
    res = LoadgenResult(duration_s=0.0)
    lock = threading.Lock()
    stop = threading.Event()
    threads = [
        threading.Thread(
            target=_client,
            args=(service, list(key_ids), stop, res, lock,
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
