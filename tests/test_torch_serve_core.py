"""The port's serving-tier host layers against ``dcf_tpu``'s, step for step.

``serve.batcher`` (plans, spans, gather, scatter), ``serve.admission``
(sheds, priority evictions, expiry, brownout), ``serve.breaker`` (the
closed / open / half-open walk on a fake clock), ``serve.metrics``
(snapshots, rollups), the serving errors, ``utils.benchtime`` and the
fault harness's schedules and clock are host code: each test drives both
packages through one scripted sequence, or one seeded stream of sizes,
and compares every outcome and the metrics snapshot.  Tolerance: exact
equality (byte equality for point and share arrays)."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import dcf_tpu.errors as jerrors
from dcf_tpu.serve import admission as jadmission
from dcf_tpu.serve import batcher as jbatcher
from dcf_tpu.serve import breaker as jbreaker
from dcf_tpu.serve import metrics as jmetrics
from dcf_tpu.testing import faults as jfaults

import dcf_tpu_torch.errors as errors
from dcf_tpu_torch.serve import admission, batcher, breaker, metrics
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.utils import benchtime
from tests.torch_threads import one_torch_thread  # noqa: F401

PORT = {"admission": admission, "breaker": breaker, "metrics": metrics,
        "faults": faults, "errors": errors}
JAX = {"admission": jadmission, "breaker": jbreaker, "metrics": jmetrics,
       "faults": jfaults, "errors": jerrors}


def _plans(mod, sizes, cap):
    return [(p.m, p.padded_m, p.occupancy,
             [(s.req, s.req_off, s.batch_off, s.length) for s in p.spans])
            for p in mod.plan_batches(sizes, cap)]


# -- batcher --------------------------------------------------------------


@pytest.mark.parametrize("seed,cap", [(0, 1), (1, 8), (2, 64), (3, 1024)])
def test_plan_gather_scatter_match_dcf_tpu(seed, cap):
    """Seeded ragged request sizes: the same plans, the same gathered
    padded batches, the same scattered outputs."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        sizes = [int(v) for v in rng.integers(1, 3 * cap + 2,
                                              rng.integers(1, 9))]
        assert _plans(batcher, sizes, cap) == _plans(jbatcher, sizes, cap)
        nb = int(rng.integers(1, 5))
        xs = [rng.integers(0, 256, (m, nb), dtype=np.uint8) for m in sizes]
        outs, jouts = ([np.zeros((2, m, 3), np.uint8) for m in sizes]
                       for _ in range(2))
        for plan, jplan in zip(batcher.plan_batches(sizes, cap),
                               jbatcher.plan_batches(sizes, cap)):
            got = batcher.gather_batch(xs, plan, nb)
            assert np.array_equal(got, jbatcher.gather_batch(xs, jplan, nb))
            assert got.shape == (plan.padded_m, nb)
            y = rng.integers(0, 256, (2, plan.padded_m, 3), dtype=np.uint8)
            batcher.scatter_batch(outs, plan, y)
            jbatcher.scatter_batch(jouts, jplan, y)
        for a, b in zip(outs, jouts):
            assert np.array_equal(a, b)


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(1, 300), min_size=1, max_size=12),
       log_cap=st.integers(0, 9))
def test_plan_batches_property_matches_dcf_tpu(sizes, log_cap):
    cap = 1 << log_cap
    assert _plans(batcher, sizes, cap) == _plans(jbatcher, sizes, cap)
    assert batcher.next_pow2(sum(sizes)) == jbatcher.next_pow2(sum(sizes))


def test_ingest_points_and_contracts_match():
    data = bytes(range(12))
    for mod in (batcher, jbatcher):
        xs = mod.ingest_points(memoryview(data), 3)
        assert xs.shape == (4, 3) and xs.dtype == np.uint8
        assert xs.tobytes() == data
    for bad in ((b"", 3), (bytes(5), 3)):
        with pytest.raises(errors.ShapeError):
            batcher.ingest_points(*bad)
        with pytest.raises(jerrors.ShapeError):
            jbatcher.ingest_points(*bad)
    with pytest.raises(errors.ShapeError):
        batcher.plan_batches([3], 6)  # not a power of two


# -- admission -------------------------------------------------------------


def _drive_admission(ns) -> tuple[list, dict]:
    """One scripted sequence: fills, a priority eviction, a shed, brownout
    refusing BATCH, deadline expiry, FIFO group extraction, close."""
    adm, m = ns["admission"], ns["metrics"].Metrics()
    q = adm.AdmissionQueue(40, metrics=m, shed_retry_after_s=0.004,
                           brownout_retry_after_s=1.0)
    P = adm.Priority
    log, reqs = [], []

    def put(key, pts, pr, deadline=None, now=0.0):
        r = adm.Request(key, 0, np.zeros((pts, 2), np.uint8), deadline, now,
                        adm.parse_priority(pr))
        try:
            q.put(r)
            log.append(("ok", key))
        except Exception as e:  # the typed shed is the outcome
            log.append((type(e).__name__, key,
                        getattr(e, "retry_after_s", None),
                        getattr(e, "evicted", None)))
        reqs.append(r)
        return r

    put("a", 10, "batch", deadline=5.0)
    put("b", 10, P.NORMAL)
    put("a", 10, "batch")
    put("c", 10, "normal", deadline=1.0)
    put("d", 15, "critical")        # evicts the newest BATCH request
    put("e", 30, "normal")          # shed: nothing lower to evict
    q.set_brownout(True)
    put("f", 1, "batch")            # brownout refusal
    put("g", 1, "critical")         # may evict BATCH, never refused
    q.set_brownout(False)
    log.append(("points", q.points, len(q), q.oldest_enq_t()))
    expired = q.take_expired(2.0)
    adm.expire(expired, m)
    log.append(("expired", [r.key_id for r in expired]))
    while True:
        group = q.take_group(16)
        if not group:
            break
        log.append(("group", [(r.key_id, r.m) for r in group]))
    q.close()
    put("h", 1, "normal")
    log.append(("fail_all", q.fail_all(lambda: RuntimeError("closed"))))
    for r in reqs:
        if r.future.done():
            try:
                r.future.result(0)
                log.append(("res", r.key_id, "value"))
            except Exception as e:
                log.append(("res", r.key_id, type(e).__name__))
    return log, m.snapshot()


def test_admission_scripted_sequence_matches_dcf_tpu():
    log, snap = _drive_admission(PORT)
    jlog, jsnap = _drive_admission(JAX)
    assert log == jlog
    assert snap == jsnap
    assert ("QueueFullError", "e", 0.004, False) in log
    assert snap["serve_deadline_expired_total"] == 1


def test_priority_and_tenant_spec_contracts_match():
    for ns in (PORT, JAX):
        adm = ns["admission"]
        assert [p.name for p in adm.Priority] == ["CRITICAL", "NORMAL",
                                                  "BATCH"]
        spec = adm.TenantSpec("t", "critical", 10.0, 5)
        assert spec.priority is adm.Priority.CRITICAL
        with pytest.raises(ValueError):
            adm.parse_priority("urgent")
        with pytest.raises(ValueError):
            adm.TenantSpec("", "normal")


# -- breakers --------------------------------------------------------------


def _drive_breakers(ns) -> tuple[list, dict]:
    clock = ns["faults"].FakeClock()
    m = ns["metrics"].Metrics()
    board = ns["breaker"].BreakerBoard(failures_to_open=2, cooldown_s=5.0,
                                       metrics=m, clock=clock)
    log = []

    def step(what, *args):
        out = getattr(board, what)("k", "walk", *args)
        log.append((what, out, board.state("k", "walk"), board.any_open(),
                    board.retry_after("k", "walk")))

    step("allow")
    step("record_failure")
    step("record_success")
    step("record_failure")
    step("record_failure")            # opens
    step("allow")                      # fails fast
    step("allow", True)                # CRITICAL bypasses
    step("record_success")             # a bypass success does not close
    clock.advance(5.5)
    step("allow")                      # the half-open probe
    step("allow")                      # a second is refused
    step("record_failure")             # re-opens
    clock.advance(6.0)
    step("allow")
    step("abort_probe")                # an unresolved probe releases
    step("allow")
    step("record_success")             # closes
    board.record_failure("other", "prefix")
    board.forget("other")
    log.append(("forget", board.state("other", "prefix")))
    return log, m.snapshot()


def test_breaker_walk_matches_dcf_tpu():
    log, snap = _drive_breakers(PORT)
    jlog, jsnap = _drive_breakers(JAX)
    assert log == jlog
    assert snap == jsnap
    assert [s for _, _, s, _, _ in log[:6]] == [
        "closed", "closed", "closed", "closed", "open", "open"]


# -- metrics ---------------------------------------------------------------


def _drive_metrics(ns) -> tuple[dict, dict]:
    mm = ns["metrics"]
    snaps = []
    for i in range(3):
        m = mm.Metrics()
        m.counter("serve_requests_total").inc(3 + i)
        m.counter(mm.labeled("serve_shed_by_class_total",
                             priority="batch")).inc(i)
        m.gauge("serve_queue_points").set(7 * i)
        h = m.histogram("serve_eval_s")
        for v in (0.0004, 0.003, 0.02 * (i + 1), 5.0):
            h.observe(v)
        m.histogram("serve_batch_occupancy", mm.OCCUPANCY_BOUNDS).observe(
            0.5 + 0.2 * i)
        snaps.append(m.snapshot())
    return snaps[0], mm.rollup_snapshots(snaps)


def test_metrics_snapshot_and_rollup_match_dcf_tpu():
    snap, roll = _drive_metrics(PORT)
    jsnap, jroll = _drive_metrics(JAX)
    assert snap == jsnap and roll == jroll
    assert list(snap) == sorted(snap)
    assert roll["serve_requests_total"] == 12
    assert metrics.labeled("x", b="2", a="1") == jmetrics.labeled(
        "x", b="2", a="1")


def test_metrics_type_contract():
    m = metrics.Metrics()
    m.counter("c")
    with pytest.raises(ValueError):
        m.gauge("c")
    with pytest.raises(ValueError):
        m.counter("c").inc(-1)


# -- errors, clock, fault harness ------------------------------------------


@pytest.mark.parametrize("name", [
    "QueueFullError", "DeadlineExceededError", "CircuitOpenError",
    "KeyQuarantinedError", "BatchTimeoutError", "RingEpochError"])
def test_serving_errors_match_dcf_tpu(name):
    mine, theirs = getattr(errors, name), getattr(jerrors, name)
    assert [c.__name__ for c in mine.__mro__] == \
        [c.__name__ for c in theirs.__mro__]
    # The classes that take a hint define their own __init__.
    kw = {"retry_after_s": 1.5} if "__init__" in vars(theirs) else {}
    assert ("__init__" in vars(mine)) == bool(kw)
    e = mine("msg", **kw)
    assert str(e) == "msg" and isinstance(e, errors.DcfError)
    if kw:
        assert e.retry_after_s == 1.5


def test_benchtime_clock_and_device_sync():
    t0 = benchtime.monotonic()
    assert benchtime.monotonic() >= t0
    y = torch.zeros(4)
    benchtime.device_sync(y)  # a CPU tensor: nothing to wait for
    benchtime.device_sync(np.zeros(3))
    rtt = benchtime.measure_sync_rtt(y, reps=3)
    assert 0.0 <= rtt < 1.0


def test_fault_schedules_match_dcf_tpu(tmp_path):
    outs = []
    for ns in (PORT, JAX):
        fl = ns["faults"]
        clock = fl.FakeClock(5.0)
        seq = []
        handler = fl.flaky(0.4, seed=11)
        for i in range(30):
            try:
                handler(i)
                seq.append(0)
            except fl.InjectedFault:
                seq.append(1)
        with fl.inject_schedule("serve.eval", window_evals=2) as sched:
            for _ in range(4):
                try:
                    fl.fire("serve.eval", "k", 1)
                    seq.append("pass")
                except fl.InjectedFault:
                    seq.append("fail")
        seq += [sched.fired, sched.failed, sched.recovered]
        fl.latency(clock, 0.25)("k", 1)
        seq.append(clock())
        with pytest.raises(ValueError):
            clock.advance(-1)
        seq.append(fl.corrupt(b"\x00\x10\x20", 1, 0x81))
        path = tmp_path / f"torn-{len(outs)}"
        path.write_bytes(bytes(64))
        fl.torn_write(10)("k", str(path))
        seq.append(path.stat().st_size)
        cut = fl.partition([("a", "b")], clock=clock, window=(5.0, 6.0))
        for src, dst in (("a", "b"), ("b", "a"), ("a", "c")):
            try:
                cut(src, dst)
                seq.append("open")
            except OSError:
                seq.append("cut")
        outs.append(seq)
    assert outs[0] == outs[1]
    assert outs[0][-3:] == ["cut", "cut", "open"]
    with pytest.raises(ValueError):
        with faults.inject("serve.evil"):
            pass
    assert math.isclose(outs[0][-6], 5.25)
