"""Dependency-free serving metrics: counters, gauges, histograms, and a
deterministic snapshot.

Counterpart of ``dcf_tpu/serve/metrics.py``, with the same instruments,
names and snapshot rules, so a snapshot from either package diffs
cleanly against the other's:

* ``Counter``   monotonically increasing float/int (requests, points,
  evictions, shed load, retries);
* ``Gauge``     last-written value (queue depth, resident device bytes);
* ``Histogram`` fixed-bound buckets + sum + count (stage/eval latency,
  batch occupancy, queue wait) -- cumulative bucket counts in the
  snapshot, prometheus-style.

``Metrics.snapshot()`` returns a plain ``{name: value}`` dict with keys
in sorted order and only JSON-basic values, so a snapshot can be embedded
verbatim in a JSON line and two snapshots diff cleanly in tests.

Series of the serving tier this package carries:

* serving: ``serve_requests_total`` / ``serve_points_total``,
  ``serve_shed_total`` (+ ``serve_shed_by_class_total{priority=}``),
  ``serve_batches_total``, ``serve_retries_total``,
  ``serve_batch_failures_total``, ``serve_breaker_fast_fails_total``,
  ``serve_batch_timeouts_total`` (the hung-batch watchdog),
  ``serve_deadline_expired_total``, ``serve_pir_answers_total``; the
  histograms ``serve_batch_occupancy``, ``serve_stage_s``,
  ``serve_eval_s``, ``serve_queue_wait_s``;
* residency: ``serve_resident_device_bytes``, ``serve_resident_images``,
  ``serve_registered_keys`` (gauges), ``serve_evictions_total``,
  ``serve_key_stagings_total``;
* frontier cache: ``serve_frontier_hits_total`` /
  ``serve_frontier_misses_total`` (one consult per prefix-family eval
  plus the stage-time warm), ``serve_frontier_evictions_total``, and the
  ``serve_frontier_cache_bytes`` / ``serve_frontier_cache_entries``
  gauges.  Hit rate = hits / (hits + misses);
* durability: ``serve_store_writes_total`` / ``serve_store_deletes_total``,
  ``serve_store_quarantined_total`` (frames set aside typed at read
  time), ``serve_store_restored_total``, the ``serve_store_keys`` gauge;
* replication: ``serve_replica_applied_total`` /
  ``serve_replica_fenced_total`` (the monotonic-generation fence), and
  ``serve_ring_epoch`` / ``serve_epoch_fenced_total``;
* key factory: ``keyfactory_pool_depth{pool=...}``,
  ``keyfactory_pool_hits_total`` / ``keyfactory_pool_misses_total``,
  ``keyfactory_minted_keys_total``, ``keyfactory_published_total``,
  ``keyfactory_refills_total`` / ``keyfactory_refill_failures_total``,
  ``keyfactory_restored_total``, ``keyfactory_spent_reclaimed_total``,
  ``keyfactory_worker_errors_total``;
* admission: ``serve_queue_depth`` / ``serve_queue_points`` gauges,
  ``serve_queue_evicted_total``, ``serve_brownout`` (gauge, 0 or 1);
* breakers: ``serve_breaker_state{backend=,key=}``,
  ``serve_breakers_open`` and the transition counters of
  ``serve.breaker``.

Secret hygiene: metric NAMES are static strings and metric values are
scalars; key ids chosen by callers become label values via ``labeled``
and must never be derived from key material.

Thread safety: one lock per ``Metrics`` registry guards every mutation
and the snapshot; instruments are cheap enough that a shared lock beats
per-instrument locks at serving rates (the device eval dwarfs both).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Metrics", "labeled",
           "rollup_snapshots", "DEFAULT_LATENCY_BOUNDS",
           "OCCUPANCY_BOUNDS"]

#: Seconds buckets spanning sub-ms batching decisions to multi-second
#: CPU-mode large-batch evals.
DEFAULT_LATENCY_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)

#: Occupancy is a fraction in (0, 1]; padded batches land below 1.
OCCUPANCY_BOUNDS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def rollup_snapshots(snapshots) -> dict:
    """Sum per-host ``Metrics.snapshot()`` dicts into ONE pod view:
    counters and gauges add across hosts (a pod's resident
    bytes / queue depth / shed totals are the sums), histogram
    ``*_sum``/``*_count`` add, ``*_buckets`` add elementwise, and
    ``*_bounds`` must AGREE (same instrument definition on every host
    — a mismatch raises rather than summing apples onto oranges).
    Series only some hosts carry (per-tenant/per-key labels) sum over
    the hosts that have them.  Key order stays sorted — the rollup is
    itself a valid deterministic snapshot, so the pod benches embed it
    exactly like a single host's."""
    out: dict = {}
    for snap in snapshots:
        for name, value in snap.items():
            if name not in out:
                out[name] = (list(value) if isinstance(value, list)
                             else value)
            elif name.endswith("_bounds"):
                if list(value) != list(out[name]):
                    # api-edge: rollup contract — two hosts disagreeing
                    # on an instrument's bucket bounds is a deploy bug,
                    # not something to average away
                    raise ValueError(
                        f"histogram bounds differ across hosts for "
                        f"{name!r}")
            elif name.endswith("_buckets"):
                out[name] = [a + b for a, b in zip(out[name], value)]
            else:
                out[name] = out[name] + value
    return dict(sorted(out.items()))


def labeled(name: str, **labels: str) -> str:
    """Canonical ``name{k=v,...}`` metric-name form for labeled series
    (labels sorted, so the same label set is always the same series)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter; ``inc`` with a non-negative amount."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, amount: int | float = 1) -> None:
        if amount < 0:
            # api-edge: instrument-usage contract (programmer error)
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-written value."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def set(self, value: int | float) -> None:
        with self._lock:
            self.value = value

    def add(self, delta: int | float) -> None:
        with self._lock:
            self.value += delta


class Histogram:
    """Fixed-bound histogram: per-bucket counts (le semantics), sum,
    count.  Observations above the last bound land in the +Inf bucket."""

    __slots__ = ("_lock", "bounds", "buckets", "total", "count")

    def __init__(self, lock: threading.Lock,
                 bounds: Sequence[float] = DEFAULT_LATENCY_BOUNDS):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            # api-edge: instrument-usage contract (programmer error)
            raise ValueError("histogram bounds must be strictly increasing")
        self._lock = lock
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        # bisect_left gives prometheus "le" placement: an observation
        # EQUAL to a bound belongs in that bound's bucket (occupancy 1.0
        # must land in le=1.0, not +Inf).
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self.buckets[idx] += 1
            self.total += value
            self.count += 1


class Metrics:
    """Registry of named instruments with a deterministic snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, name: str, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            return inst

    def _typed(self, name: str, inst, want: type):
        if not isinstance(inst, want):
            # api-edge: instrument-usage contract (programmer error — one
            # name, one instrument kind)
            raise ValueError(f"metric {name!r} is already a "
                             f"{type(inst).__name__}, not a {want.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._typed(name, self._get(
            name, lambda: Counter(self._lock)), Counter)

    def gauge(self, name: str) -> Gauge:
        return self._typed(name, self._get(
            name, lambda: Gauge(self._lock)), Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_LATENCY_BOUNDS
                  ) -> Histogram:
        return self._typed(name, self._get(
            name, lambda: Histogram(self._lock, bounds)), Histogram)

    def remove(self, name: str) -> None:
        """Drop an instrument (and its snapshot series) by exact name.

        For bounded-cardinality hygiene on per-entity labeled series:
        a series keyed by a retired entity (e.g. an unregistered serve
        key's breaker-state gauge) would otherwise sit in every later
        snapshot forever — unbounded memory and snapshot bloat under
        entity churn.  Removing an absent name is a no-op."""
        with self._lock:
            self._instruments.pop(name, None)

    def snapshot(self) -> dict:
        """Point-in-time ``{name: value}`` with sorted keys and
        JSON-basic values only.  Counters/gauges map to their scalar;
        a histogram ``h`` expands to ``h_sum``, ``h_count``, and
        ``h_buckets`` (cumulative counts per ``h_bounds`` entry plus the
        trailing +Inf bucket)."""
        with self._lock:
            out: dict = {}
            for name in sorted(self._instruments):
                inst = self._instruments[name]
                if isinstance(inst, Histogram):
                    cum, acc = [], 0
                    for c in inst.buckets:
                        acc += c
                        cum.append(acc)
                    out[f"{name}_sum"] = round(inst.total, 9)
                    out[f"{name}_count"] = inst.count
                    out[f"{name}_bounds"] = list(inst.bounds)
                    out[f"{name}_buckets"] = cum
                else:
                    out[name] = inst.value
            # Key order is part of the determinism contract: expanded
            # histogram keys must land sorted too, not grouped.
            return dict(sorted(out.items()))
