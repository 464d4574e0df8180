"""The port's capacity controller (``dcf_tpu_torch.serve.capacity``)
against ``dcf_tpu``'s.

Every scripted sequence of ``tests/test_capacity.py`` runs through both
packages: the same ``LoadSample`` streams, fed on a ``FakeClock`` to a
``CapacityController`` over a stub router and a stub membership (joins
and drains commit a new epoch, as the real fences do).  The verdict
stream, the events, the stub's joins and drains, the standby pool and
the router's metrics snapshot (``capacity_skips_total`` by reason
included) must be equal, key for key; each script also asserts the
reference test's expectations.  Covered: the pooled queue and brownout
fractions, the idle / steady bands, counter deltas with the restart
clamp, hosts outside the ring, the fail-N / recover-M streaks, the flap
pin (oscillating load, zero ring changes), back-to-back surges giving
one join, an external epoch change resetting the streaks, each rail,
the forced and the frozen ``capacity.decide`` seam, the operator verbs
and a failed join.  Then the controller over a real port pod: a port
``MembershipController`` under it, shards serving on ``walk``'s plain
version, a scale-out and a scale-in through ``join`` / ``drain`` with
every share equal to the oracle.  Last, the load generator that drives
it: ``open_loop`` and ``open_loop_ramp`` against ``dcf_tpu``'s with one
seed and schedule, a zero-rate segment included — the same arrival
offsets, request sizes, keys, priorities and point bytes.  Tolerance:
exact; counters, gauges and event lists equal."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import dcf_tpu.errors as jerrors
import dcf_tpu.serve.capacity as jcapacity
import dcf_tpu.serve.edge as jedge
import dcf_tpu.serve.metrics as jmetrics
import dcf_tpu.serve.shardmap as jshardmap
from dcf_tpu.testing import faults as jfaults

import dcf_tpu_torch.errors as perrors
import dcf_tpu_torch.serve.capacity as pcapacity
import dcf_tpu_torch.serve.edge as pedge
import dcf_tpu_torch.serve.metrics as pmetrics
import dcf_tpu_torch.serve.shardmap as pshardmap
from dcf_tpu_torch.testing import faults as pfaults
from tests.torch_net import PORT, WAIT_S, Pod, make_bundle, oracle, points
from tests.torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "port": SimpleNamespace(cap=pcapacity, shardmap=pshardmap,
                            metrics=pmetrics, edge=pedge, faults=pfaults,
                            errors=perrors),
    "dcf_tpu": SimpleNamespace(cap=jcapacity, shardmap=jshardmap,
                               metrics=jmetrics, edge=jedge, faults=jfaults,
                               errors=jerrors),
}
PRESSURE, IDLE, STEADY = "pressure", "idle", "steady"


class StubHealth:
    """The prober surface the controller reads: ``loads()``."""

    def __init__(self):
        self.samples = {}

    def loads(self):
        return dict(self.samples)


class StubRouter:
    """The router surface the controller reads: ``map``, ``metrics``,
    ``ring_epoch``, ``health`` and the injectable clock."""

    def __init__(self, pkg, host_ids, clock):
        self.map = pkg.shardmap.ShardMap(
            [pkg.shardmap.ShardSpec(h) for h in host_ids])
        self.metrics = pkg.metrics.Metrics()
        self.health = StubHealth()
        self.ring_epoch = 0
        self._clock = clock


class StubMembership:
    """The membership surface the controller drives: joins and drains
    commit a new epoch on the router, as the real fences do."""

    def __init__(self, router, min_hosts=1):
        self.router = router
        self.min_hosts = min_hosts
        self.joins = []
        self.drains = []
        self.stores = {}
        self.eject = False
        self.fail_join = False

    def eject_in_flight(self):
        return self.eject

    def store_for(self, host_id):
        return self.stores.get(host_id)

    def join(self, spec, store=None):
        if self.fail_join:
            raise RuntimeError("injected join failure")
        self.router.map = self.router.map.with_host(spec)
        self.router.ring_epoch += 1
        self.joins.append(spec.host_id)
        return SimpleNamespace(kind="join", host_id=spec.host_id,
                               epoch=self.router.ring_epoch)

    def drain(self, host_id):
        self.router.map = self.router.map.without_host(host_id)
        self.router.ring_epoch += 1
        self.drains.append(host_id)
        return SimpleNamespace(kind="drain", host_id=host_id,
                               epoch=self.router.ring_epoch)


class Ctx:
    """One package's controller over the stubs, and the trace of what
    it did: every tick's verdict (as a tuple, None for a frozen tick)
    and every drained event."""

    def __init__(self, pkg, hosts=("a", "b"), standby=("s1",), **kw):
        self.pkg = pkg
        self.ck = pkg.faults.FakeClock()
        self.r = StubRouter(pkg, hosts, self.ck)
        self.mm = StubMembership(self.r)
        kw.setdefault("scale_out_n", 2)
        kw.setdefault("scale_in_m", 3)
        kw.setdefault("cooldown_s", 10.0)
        kw.setdefault("min_hosts", 1)
        self.cap = pkg.cap.CapacityController(
            self.r, self.mm,
            standby=[pkg.shardmap.ShardSpec(s) for s in standby], **kw)
        self.verdicts = []
        self.events = []

    def S(self, qp=0, ql=100, bo=False, shed=0, refused=0, misses=0):
        return self.pkg.edge.LoadSample(qp, ql, bo, shed, refused, misses)

    def tick(self, loads, dt=1.0):
        self.r.health.samples = loads
        self.ck.advance(dt)
        v = self.cap.pump()
        self.verdicts.append(None if v is None
                             else dataclasses.astuple(v))
        return v

    def drain_events(self):
        evs = [dataclasses.astuple(e) for e in self.cap.events()]
        self.events += evs
        return evs

    def skips(self, reason):
        return self.r.metrics.counter(self.pkg.metrics.labeled(
            "capacity_skips_total", reason=reason)).value

    def trace(self):
        self.drain_events()
        return {"verdicts": self.verdicts, "events": self.events,
                "joins": self.mm.joins, "drains": self.mm.drains,
                "standby": self.cap.standby(),
                "epoch": self.r.ring_epoch,
                "snapshot": self.r.metrics.snapshot()}


# ---------------------------------------------------- the scripts


def pooled_queue_fraction(pkg):
    c = Ctx(pkg)
    v = c.tick({"a": c.S(qp=90), "b": c.S(qp=80)})
    assert v.kind == PRESSURE and v.sampled == 2
    assert v.queue_fraction == pytest.approx(170 / 200)
    v = c.tick({"a": c.S(qp=90), "b": c.S(qp=0)})
    assert v.kind == STEADY  # 90/200 = 0.45 < 0.75: pooled, not max
    return c


def brownout_fraction(pkg):
    c = Ctx(pkg)
    v = c.tick({"a": c.S(bo=True), "b": c.S()})
    assert v.kind == PRESSURE
    assert v.brownout_fraction == pytest.approx(0.5)
    return c


def idle_steady_bands_and_empty_sample(pkg):
    c = Ctx(pkg)
    assert c.tick({"a": c.S(qp=2), "b": c.S(qp=2)}).kind == IDLE
    assert c.tick({"a": c.S(qp=30), "b": c.S(qp=30)}).kind == STEADY
    assert c.tick({"a": c.S(bo=True, qp=0),
                   "b": c.S(qp=0)}).kind == PRESSURE
    v = c.tick({})
    assert v.kind == STEADY and v.sampled == 0
    v = c.tick({"a": None, "b": None})  # answered, no load surface
    assert v.kind == STEADY and v.sampled == 0
    return c


def counter_deltas_and_restart_clamp(pkg):
    c = Ctx(pkg)
    v = c.tick({"a": c.S(qp=1, shed=500), "b": c.S(qp=1)})
    assert v.kind == IDLE and v.shed_delta == 0
    v = c.tick({"a": c.S(qp=1, shed=501), "b": c.S(qp=1)})
    assert v.kind == PRESSURE and v.shed_delta == 1
    v = c.tick({"a": c.S(qp=1, shed=3), "b": c.S(qp=1)})  # a restart
    assert v.kind == IDLE and v.shed_delta == 0
    v = c.tick({"a": c.S(qp=1, shed=3, refused=1), "b": c.S(qp=1)})
    assert v.kind == PRESSURE and v.refusal_delta == 1
    v = c.tick({"a": c.S(qp=1, shed=3, refused=1, misses=2),
                "b": c.S(qp=1)})
    assert v.kind == PRESSURE and v.pool_miss_delta == 2
    return c


def hosts_outside_the_ring(pkg):
    c = Ctx(pkg)
    v = c.tick({"a": c.S(qp=2), "b": c.S(qp=2),
                "ghost": c.S(qp=100, bo=True)})
    assert v.kind == IDLE and v.sampled == 2 and v.ring_size == 2
    return c


def scale_out_after_n_consecutive(pkg):
    c = Ctx(pkg, scale_out_n=3)
    hot = {"a": c.S(qp=90), "b": c.S(qp=90)}
    calm = {"a": c.S(qp=30), "b": c.S(qp=30)}
    for loads in (hot, hot, calm, hot, hot):
        c.tick(loads)
    assert c.mm.joins == []
    c.tick(hot)  # third CONSECUTIVE -> commit
    assert c.mm.joins == ["s1"] and c.cap.standby() == []
    (ev,) = c.drain_events()
    assert (ev[0], ev[1], ev[2]) == ("scale-out", "s1", 1)
    assert c.cap.events() == []  # events() drains
    return c


def scale_in_least_loaded_to_back_of_pool(pkg):
    c = Ctx(pkg, hosts=("a", "b", "c"), scale_in_m=2)
    c.mm.stores["b"] = store = object()
    idle = {"a": c.S(qp=2), "b": c.S(qp=0), "c": c.S(qp=3)}
    c.tick(idle)
    assert c.mm.drains == []
    c.tick(idle)
    assert c.mm.drains == ["b"]  # the smallest sampled queue
    assert c.cap.standby() == ["s1", "b"]
    assert c.cap._standby[-1][1] is store
    return c


def flap_pin_zero_ring_changes(pkg):
    c = Ctx(pkg, scale_out_n=2, scale_in_m=2)
    hot = {"a": c.S(qp=90), "b": c.S(qp=90)}
    calm = {"a": c.S(qp=1), "b": c.S(qp=1)}
    for i in range(40):
        c.tick(hot if i % 2 else calm)
    assert c.mm.joins == [] and c.mm.drains == []
    assert c.r.ring_epoch == 0
    return c


def back_to_back_surges_one_join(pkg):
    c = Ctx(pkg, standby=("s1", "s2"), scale_out_n=2, cooldown_s=10.0)
    hot = {"a": c.S(qp=90), "b": c.S(qp=90)}
    c.tick(hot)
    c.tick(hot)  # surge 1 commits
    assert c.mm.joins == ["s1"]
    for _ in range(5):  # surge 2, inside the cooldown
        c.tick(hot)
    assert c.mm.joins == ["s1"] and c.skips("cooldown") >= 1
    for _ in range(8):  # the cooldown clears; the surge holds
        c.tick(hot)
    assert c.mm.joins == ["s1", "s2"]
    return c


def external_epoch_change_resets(pkg):
    c = Ctx(pkg, scale_out_n=2, cooldown_s=10.0)
    hot = {"a": c.S(qp=90), "b": c.S(qp=90)}
    c.tick(hot)
    c.r.ring_epoch += 1  # the health plane ejected someone
    c.tick(hot)
    c.tick(hot)
    assert c.mm.joins == [] and c.skips("cooldown") == 1
    for _ in range(10):
        c.tick(hot)
    assert c.mm.joins == ["s1"]
    return c


def rail_max_hosts_and_no_standby(pkg):
    c = Ctx(pkg, standby=("s1",), scale_out_n=1, cooldown_s=0.0,
            max_hosts=2)
    hot = {"a": c.S(qp=90), "b": c.S(qp=90)}
    c.tick(hot)
    assert c.mm.joins == [] and c.skips("max_hosts") == 1
    c.cap.max_hosts = 4
    c.tick(hot)
    assert c.mm.joins == ["s1"]
    c.tick(hot)  # the pool is now empty
    assert c.skips("no_standby") == 1
    return c


def rail_eject_inflight(pkg):
    c = Ctx(pkg, scale_out_n=1, scale_in_m=1, cooldown_s=0.0)
    c.mm.eject = True
    c.tick({"a": c.S(qp=90), "b": c.S(qp=90)})
    c.tick({"a": c.S(qp=1), "b": c.S(qp=1)})
    assert c.mm.joins == [] and c.mm.drains == []
    assert c.skips("eject_inflight") == 2
    return c


def rail_min_hosts(pkg):
    c = Ctx(pkg, scale_in_m=1, cooldown_s=0.0, min_hosts=2)
    c.tick({"a": c.S(qp=1), "b": c.S(qp=1)})
    assert c.mm.drains == [] and c.skips("min_hosts") == 1
    return c


def rail_no_sample(pkg):
    c = Ctx(pkg, scale_in_m=1, cooldown_s=0.0)

    def force_idle(kind, verdict):
        raise pkg.cap.ForcedVerdict(IDLE)

    with pkg.faults.inject("capacity.decide", handler=force_idle):
        c.tick({})
    assert c.mm.drains == [] and c.skips("no_sample") == 1
    return c


def forced_verdict(pkg):
    c = Ctx(pkg, scale_out_n=1, cooldown_s=0.0)
    seen = []

    def force(kind, verdict):
        seen.append(kind)  # the seam sees the computed verdict
        raise pkg.cap.ForcedVerdict(PRESSURE)

    with pkg.faults.inject("capacity.decide", handler=force):
        v = c.tick({"a": c.S(qp=30), "b": c.S(qp=30)})
    assert seen == [STEADY] and v.kind == PRESSURE
    assert c.mm.joins == ["s1"]
    return c


def frozen_tick(pkg):
    c = Ctx(pkg, scale_out_n=1, cooldown_s=0.0)
    hot = {"a": c.S(qp=90), "b": c.S(qp=90)}
    with pkg.faults.inject("capacity.decide", exc=RuntimeError("brake")):
        assert c.tick(hot) is None
    assert c.mm.joins == [] and c.skips("frozen") == 1
    c.tick(hot)  # disarmed: the very next tick acts again
    assert c.mm.joins == ["s1"]
    return c


def forced_oscillation_epoch_unmoved(pkg):
    """The surge leg's oscillation: a forced load walk through the seam
    alternating pressure and idle moves the ring epoch not at all."""
    c = Ctx(pkg, scale_out_n=3, scale_in_m=3, cooldown_s=0.0)
    walk = iter([PRESSURE, PRESSURE, IDLE, IDLE, PRESSURE, STEADY] * 4)

    def force(kind, verdict):
        raise pkg.cap.ForcedVerdict(next(walk))

    with pkg.faults.inject("capacity.decide", handler=force):
        for _ in range(24):
            c.tick({"a": c.S(qp=50), "b": c.S(qp=50)})
    assert c.r.ring_epoch == 0 and c.mm.joins == c.mm.drains == []
    return c


def operator_verbs(pkg):
    c = Ctx(pkg, hosts=("a", "b"), cooldown_s=1e9)
    ev = c.cap.scale_out()  # no streak, giant cooldown: still commits
    assert (ev.kind, ev.host_id) == ("scale-out", "s1")
    ev = c.cap.scale_in("a")
    assert (ev.kind, ev.host_id) == ("scale-in", "a")
    assert c.cap.standby() == ["a"]
    c.cap.scale_out()
    with pytest.raises(pkg.errors.StandbyExhaustedError,
                       match="standby pool"):
        c.cap.scale_out()
    return c


def failed_join_back_to_front(pkg):
    c = Ctx(pkg, standby=("s1", "s2"), scale_out_n=1, cooldown_s=0.0)
    c.mm.fail_join = True
    hot = {"a": c.S(qp=90), "b": c.S(qp=90)}
    c.tick(hot)
    assert c.mm.joins == [] and c.cap.standby() == ["s1", "s2"]
    c.mm.fail_join = False
    c.tick(hot)
    assert c.mm.joins == ["s1"]
    return c


SCRIPTS = [pooled_queue_fraction, brownout_fraction,
           idle_steady_bands_and_empty_sample,
           counter_deltas_and_restart_clamp, hosts_outside_the_ring,
           scale_out_after_n_consecutive,
           scale_in_least_loaded_to_back_of_pool,
           flap_pin_zero_ring_changes, back_to_back_surges_one_join,
           external_epoch_change_resets, rail_max_hosts_and_no_standby,
           rail_eject_inflight, rail_min_hosts, rail_no_sample,
           forced_verdict, frozen_tick, forced_oscillation_epoch_unmoved,
           operator_verbs, failed_join_back_to_front]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__)
def test_capacity_script_equal_to_dcf_tpu(script):
    port = script(PKGS["port"]).trace()
    ref = script(PKGS["dcf_tpu"]).trace()
    snap_p, snap_j = port.pop("snapshot"), ref.pop("snapshot")
    assert port == ref
    assert sorted(snap_p) == sorted(snap_j)
    assert {k: (snap_p[k], snap_j[k]) for k in snap_p
            if snap_p[k] != snap_j[k]} == {}


def test_skip_reasons_cover_the_seven_rails():
    """Every ``capacity_skips_total`` reason the reference counts is
    reached by a script above, with the same label spelling."""
    reasons = set()
    for script in SCRIPTS:
        snap = script(PKGS["port"]).r.metrics.snapshot()
        reasons |= {k.split("reason=")[1].rstrip("}") for k in snap
                    if k.startswith("capacity_skips_total{")}
    assert reasons == {"cooldown", "eject_inflight", "min_hosts",
                       "max_hosts", "no_standby", "no_sample", "frozen"}


@pytest.mark.parametrize("kw", [
    {"interval_s": 0.0},
    {"scale_out_n": 0},
    {"scale_in_m": 0},
    {"cooldown_s": -1.0},
    {"brownout_pressure_fraction": 0.0},
    {"queue_pressure_fraction": 1.5},
    {"queue_idle_fraction": 0.75},   # == pressure threshold
    {"min_hosts": 0},
    {"max_hosts": 1, "min_hosts": 2},
])
def test_config_validation_api_edge(kw):
    for pkg in PKGS.values():
        ck = pkg.faults.FakeClock()
        r = StubRouter(pkg, ("a", "b"), ck)
        with pytest.raises(ValueError):
            pkg.cap.CapacityController(r, StubMembership(r), **kw)


def test_standby_declaration_and_forced_typo():
    pkg = PKGS["port"]
    r = StubRouter(pkg, ("a",), pkg.faults.FakeClock())
    with pytest.raises(ValueError, match="standby entries"):
        pcapacity.CapacityController(r, StubMembership(r),
                                     standby=[("not-a-spec", None)])
    cap = pcapacity.CapacityController(r, StubMembership(r), min_hosts=1)
    cap.add_standby(pshardmap.ShardSpec("late"), store=None)
    assert cap.standby() == ["late"]
    assert r.metrics.gauge("capacity_standby_hosts").value == 1
    with pytest.raises(ValueError, match="verdict kind"):
        pcapacity.ForcedVerdict("presure")


def test_controller_over_a_port_pod_scales_through_membership():
    """The controller over a real port pod: a ``MembershipController``
    under it, the router's prober sampling load off PING/PONG.  Forced
    pressure admits the standby host warm (``join``); forced idle drains
    the least-loaded host (``drain``) back to the pool.  Each commit
    bumps the ring epoch once; every key serves both parties equal to
    the oracle after each change."""
    from dcf_tpu_torch.serve import CapacityController, MembershipController
    from dcf_tpu_torch.testing.faults import FakeClock
    from tests.torch_net import service

    rng = np.random.default_rng(0xCA9)
    bundles = {f"cap-key-{i}": make_bundle(rng) for i in range(4)}
    pod = Pod(PORT, PORT, n=2, bundles=bundles)
    svc = service(PORT)
    edge = PORT.edge.EdgeServer(svc).start()
    clk = FakeClock(10.0)
    mm = MembershipController(pod.router, clock=clk, min_hosts=1)
    cap = CapacityController(
        pod.router, mm, clock=clk, scale_out_n=2, scale_in_m=2,
        cooldown_s=5.0, min_hosts=2,
        standby=[pshardmap.ShardSpec("shard-9", *edge.address)])
    walk = []

    def force(kind, verdict):
        raise pcapacity.ForcedVerdict(walk.pop(0))

    def serve_all():
        for name, kb in bundles.items():
            xs = points(rng, 5)
            for b in (0, 1):
                assert np.array_equal(pod.router.evaluate(
                    name, xs, b=b, timeout=WAIT_S), oracle(kb, b, xs))

    try:
        pod.router.health.pump()
        assert set(pod.router.loads()) == {"shard-0", "shard-1"}
        walk += [PRESSURE, PRESSURE]
        with pfaults.inject("capacity.decide", handler=force):
            for _ in range(2):
                clk.advance(1.0)
                cap.pump()
        assert "shard-9" in pod.router.map and pod.router.ring_epoch == 1
        serve_all()
        pod.router.health.pump()  # sample the newcomer too
        walk += [IDLE, IDLE, IDLE]
        with pfaults.inject("capacity.decide", handler=force):
            clk.advance(6.0)  # past the cooldown
            for _ in range(3):
                clk.advance(1.0)
                cap.pump()
        assert len(pod.router.map) == 2 and pod.router.ring_epoch == 2
        drained = [e for e in cap.events() if e.kind == "scale-in"]
        assert len(drained) == 1 and cap.standby() == [drained[0].host_id]
        serve_all()
        snap = pod.router.metrics_snapshot()
        assert snap["capacity_scale_out_total"] == 1
        assert snap["capacity_scale_in_total"] == 1
        assert snap["membership_joins_total"] == 1
        assert snap["membership_drains_total"] == 1
        assert snap["membership_change_failures_total"] == 0
    finally:
        cap.close()
        mm.close()
        pod.close()
        edge.close()
        svc.close(drain=False)


# ---------------------------------------------------- the ramp generator


class Recorder:
    """A submit target that completes every request at once and records
    what it was offered (key, party, priority, point bytes)."""

    n_bytes = 2

    def __init__(self):
        self.offered = []

    def submit(self, key_id, xs, b=0, deadline_ms=None, priority=None):
        from concurrent.futures import Future

        self.offered.append((key_id, int(b), str(priority), xs.tobytes()))
        fut = Future()
        fut.set_result(np.zeros((1, xs.shape[0], 16), np.uint8))
        return fut


def warp_clock():
    """0 at the run's start, 1000 ever after: no arrival waits, and each
    latency is 1000 minus its scheduled arrival offset."""
    calls = []

    def clock():
        calls.append(None)
        return 0.0 if len(calls) == 1 else 1000.0

    return clock


def _ramp(fn, segments, **kw):
    target = Recorder()
    if segments is None:
        res = fn(target, ["k0", "k1", "k2", "k3"], clock=warp_clock(),
                 collectors=1, **kw)
    else:
        res = fn(target, ["k0", "k1", "k2", "k3"], segments=segments,
                 clock=warp_clock(), collectors=1, **kw)
    offsets = sorted(round(1000.0 - lat, 9) for lat in res.latencies_s)
    return target.offered, offsets, (res.sent, res.ok, res.shed,
                                     res.failed, res.offered_rps,
                                     list(res.offered_segments))


@pytest.mark.parametrize("segments, kw", [
    ([(2.0, 40.0), (3.0, 90.0), (1.0, 0.0), (2.0, 25.0)],
     dict(skew=1.1, priority_mix={"critical": 1, "normal": 3})),
    ([(1.0, 0.0), (1.5, 60.0)], dict(party=1, deadline_ms=50.0)),
], ids=["surge-with-quiet", "quiet-first"])
def test_open_loop_ramp_arrivals_equal_to_dcf_tpu(segments, kw):
    """The same seed and schedule give both packages the same arrival
    offsets, request sizes, keys, priorities and point bytes, a quiet
    segment included (it offers nothing and holds the schedule)."""
    from dcf_tpu.serve.loadgen import open_loop_ramp as j_ramp
    from dcf_tpu_torch.serve.loadgen import open_loop_ramp

    common = dict(min_points=3, max_points=9, seed=41, **kw)
    port = _ramp(open_loop_ramp, segments, **common)
    ref = _ramp(j_ramp, segments, **common)
    assert port == ref
    offered, offsets, counts = port
    assert counts[0] == counts[1] == len(offered) == len(offsets) > 10
    quiet = [(sum(d for d, _ in segments[:i]),
              sum(d for d, _ in segments[:i + 1]))
             for i, (_, r) in enumerate(segments) if r == 0]
    for lo, hi in quiet:
        assert not any(lo <= t < hi for t in offsets)


def test_open_loop_is_the_one_segment_ramp():
    """``open_loop`` delegates: its arrivals are the one-segment ramp's
    and ``dcf_tpu``'s ``open_loop``'s."""
    from dcf_tpu.serve.loadgen import open_loop as j_open_loop
    from dcf_tpu_torch.serve.loadgen import open_loop, open_loop_ramp

    kw = dict(min_points=1, max_points=6, seed=7)
    one = _ramp(open_loop, None, rate_rps=120.0, duration_s=1.5, **kw)
    assert one == _ramp(open_loop_ramp, [(1.5, 120.0)], **kw)
    assert one == _ramp(j_open_loop, None, rate_rps=120.0, duration_s=1.5,
                        **kw)
    for bad in ([], [(0.0, 1.0)], [(1.0, -1.0)], [(float("inf"), 1.0)]):
        with pytest.raises(ValueError):
            open_loop_ramp(Recorder(), ["k"], segments=bad, min_points=1,
                           max_points=1)
