"""The port's self-healing pod tier (``dcf_tpu_torch.serve.health``,
the router-side ``Replicator``, DOWN promotion and gated recovery)
against ``dcf_tpu``'s, modelled on ``tests/test_selfheal.py``.

The health prober walks UP -> SUSPECT -> DOWN -> UP on a scripted target
exactly as ``dcf_tpu``'s does (states, events, metrics); live
registrations fan out with the owner's generation preserved; the
generation fence refuses typed in process and on the wire (``E_STALE``);
SYNC responses are chunked and ``DIGEST_SUPPRESS`` keeps unplaced keys
off the wire; a ``net.partition`` cut walks a replica DOWN and the heal
runs one anti-entropy pass before it is re-admitted (port shards and
``dcf_tpu`` shards behind the port router); DOWN promotes the replica
for every class; the UP transition clamps the pool's backoff; ring churn
leaves the router's state and metrics where they started; byte-flipped
REGISTER frames die typed.  Shards are port services on ``walk`` (B1's
plain version, ``device="cpu"``) unless named.  Every socket binds port
0 and every wait is bounded."""

import socket
import struct

import numpy as np
import pytest

import dcf_tpu.serve as jserve
from dcf_tpu.testing.faults import FakeClock as JFakeClock

from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    CircuitOpenError,
    StaleStateError,
)
from dcf_tpu_torch.serve import (
    EdgeClient,
    EdgeClientPool,
    EdgeServer,
    HealthProber,
    Metrics,
    ShardMap,
    ShardSpec,
)
from dcf_tpu_torch.serve import edge as pedge
from dcf_tpu_torch.serve.health import DOWN, SUSPECT, UP
from dcf_tpu_torch.serve.replicate import DIGEST_SUPPRESS, sync_frames
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.testing.faults import FakeClock
from tests.torch_net import (
    NB,
    PKGS,
    PORT,
    WAIT_S,
    Pod,
    assert_shares,
    make_bundle,
    oracle,
    points,
    read_frames,
    service,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0x5E1F)


# --------------------------------------------------- the state machine


class FakeTarget:
    """A pingable whose outcomes the test scripts."""

    def __init__(self):
        self.ok = True

    def ping(self, timeout=None):
        if not self.ok:
            raise BackendUnavailableError("scripted probe failure")
        return True


def _walk(prober_cls, metrics, clock):
    """One scripted walk: a blip, an outage, a refused gate, a passing
    gate.  Returns (states after each round, events, gate calls,
    snapshot)."""
    t = FakeTarget()
    gate = {"ok": False, "calls": 0}

    def recover_gate(_host):
        gate["calls"] += 1
        return gate["ok"]

    hp = prober_cls({"s0": t}, interval_s=0.5, fail_n=3, recover_m=2,
                    clock=clock, metrics=metrics, recover_gate=recover_gate)
    states = []
    for ok, gate_ok in ((True, 0), (False, 0), (True, 0), (False, 0),
                        (False, 0), (False, 0), (True, 0), (True, 0),
                        (True, 1), (True, 1)):
        t.ok, gate["ok"] = ok, bool(gate_ok)
        states.append(hp.pump()["s0"])
        clock.advance(0.5)
    events = [(e.host_id, e.frm, e.to, e.at) for e in hp.events()]
    return states, events, gate["calls"], metrics.snapshot()


def test_health_prober_walk_equal_to_dcf_tpu():
    """The same probe outcomes drive the port's and ``dcf_tpu``'s
    prober through the same states, events (with their clock stamps),
    gate calls and metrics."""
    got = _walk(HealthProber, Metrics(), FakeClock(100.0))
    want = _walk(jserve.HealthProber, jserve.Metrics(), JFakeClock(100.0))
    assert got == want
    states, events, calls, snap = got
    assert states == [UP, SUSPECT, UP, SUSPECT, SUSPECT, DOWN, DOWN,
                      DOWN, DOWN, UP]
    assert [(f, t) for _, f, t, _ in events] == [
        (UP, SUSPECT), (SUSPECT, UP), (UP, SUSPECT), (SUSPECT, DOWN),
        (DOWN, UP)]
    assert calls == 2
    assert snap["router_recover_gate_failures_total"] == 1
    assert snap["router_down_shards"] == 0


def test_health_prober_contracts_and_bounded_churn():
    with pytest.raises(ValueError):
        HealthProber({}, interval_s=0.0)
    with pytest.raises(ValueError):
        HealthProber({}, fail_n=0)
    with pytest.raises(ValueError):
        HealthProber({}, recover_m=0)
    m = Metrics()
    hp = HealthProber({}, interval_s=0.1, metrics=m)
    baseline = set(m.snapshot())
    for i in range(4):
        t = FakeTarget()
        t.ok = False
        hp.add_target(f"churn-{i}", t)
        hp.pump()
        assert hp.state(f"churn-{i}") == SUSPECT
        hp.remove_target(f"churn-{i}")
        assert hp.states() == {}
    assert {k for k in m.snapshot() if "churn-" in k} == set()
    assert set(m.snapshot()) == baseline | {
        "router_health_transitions_total",
        "router_health_transitions_total{to=suspect}"}


# --------------------------------------------------- wire control verbs


def test_ping_pool_and_dead_target_typed():
    svc = service(PORT)
    srv = EdgeServer(svc).start()
    host, port = srv.address
    try:
        with EdgeClient(host, port, n_bytes=NB) as c:
            assert c.ping(timeout=WAIT_S) and c.ping(timeout=WAIT_S)
        pool = EdgeClientPool(host, port, n_bytes=NB, size=1)
        try:
            assert pool.ping(timeout=WAIT_S)
            epoch, load = pool.ping_load(timeout=WAIT_S)
            assert epoch == 0 and load.queue_limit == \
                svc.config.max_queued_points
        finally:
            pool.close()
        srv.close()
        with pytest.raises(BackendUnavailableError):
            EdgeClientPool(host, port, n_bytes=NB, size=1,
                           connect_timeout=2.0).ping(timeout=5)
    finally:
        srv.close()
        svc.close(drain=False)


def test_live_registration_fans_out_generation_preserved(rng):
    pod = Pod(PORT, PORT, n=3)
    try:
        kb = make_bundle(rng)
        name = pod.key_owned_by("shard-0")
        gen = pod.router.register_key(name, kb)
        placed = pod.map.placement_ids(name, 1)
        for h in pod.map.host_ids():
            digest = pod.svc_of(h).replication_digest()
            assert digest == ({name: gen} if h in placed else {})
        xs = points(rng, 7)
        assert_shares(lambda b: pod.router.evaluate(
            name, xs, b=b, timeout=WAIT_S), kb, xs)
        snap = pod.router.metrics_snapshot()
        assert (snap["router_registered_total"],
                snap["router_replicated_total"]) == (1, 1)
        kb2 = make_bundle(rng, "add16")
        gen2 = pod.router.register_key(name, kb2)
        assert gen2 > gen
        for h in placed:
            assert pod.svc_of(h).replication_digest() == {name: gen2}
        assert_shares(lambda b: pod.router.evaluate(
            name, xs, b=b, timeout=WAIT_S), kb2, xs)
    finally:
        pod.close()


def test_generation_fence_typed_in_process_and_on_the_wire(rng):
    """A doctored old-generation frame is fenced ``StaleStateError``
    (``E_STALE`` on the wire), counted, and never served."""
    svc = service(PORT)
    srv = EdgeServer(svc).start()
    try:
        kb_new, kb_old = make_bundle(rng), make_bundle(rng)
        assert svc.apply_replica_frame("fk", kb_new.to_bytes(), 7) == 7
        for doctored in (7, 3):
            with pytest.raises(StaleStateError):
                svc.apply_replica_frame("fk", kb_old.to_bytes(), doctored)
        assert svc.metrics_snapshot()["serve_replica_fenced_total"] == 2
        with EdgeClient(*srv.address, n_bytes=NB) as c:
            with pytest.raises(StaleStateError) as ei:
                c.register_frame("fk", kb_old.to_bytes(), generation=7,
                                 timeout=WAIT_S)
            assert ei.value.wire_code == pedge.E_STALE
            xs = points(rng, 4)
            assert np.array_equal(c.evaluate("fk", xs, b=0,
                                             timeout=WAIT_S),
                                  oracle(kb_new, 0, xs))
        assert svc.apply_replica_frame("fk", kb_old.to_bytes(), 11) == 11
        svc.register_key("fk", kb_new)
        assert svc.replication_digest()["fk"] > 11
    finally:
        srv.close()
        svc.close(drain=False)


def test_sync_frames_chunked_and_suppressed(rng):
    svc = service(PORT, start=False)
    try:
        sizes = {}
        for i in range(5):
            kb = make_bundle(rng)
            svc.register_key(f"chunk-{i}", kb)
            sizes[f"chunk-{i}"] = len(kb.to_bytes())
        digest, seen = {}, []
        while True:
            entries = sync_frames(svc.registry, digest,
                                  max_bytes=max(sizes.values()))
            if not entries:
                break
            assert len(entries) == 1
            key_id, gen, _proto, _frame = entries[0]
            seen.append(key_id)
            digest[key_id] = gen
        assert seen == sorted(sizes)
        got = {e[0] for e in sync_frames(svc.registry,
                                         {"chunk-0": DIGEST_SUPPRESS})}
        assert got == set(sorted(sizes)[1:])
    finally:
        svc.close(drain=False)


# ---------------------------------------------------- partition and heal


@pytest.mark.parametrize("shards", ["port", "dcf_tpu"])
def test_partition_heals_via_anti_entropy(shards, rng):
    """A registration during a router <-> replica cut reaches only the
    owner (counted); probes walk the cut link DOWN; while it is DOWN the
    owner serves; on heal one anti-entropy pass pulls exactly the missed
    frame, generation preserved, before the shard is UP again."""
    pod = Pod(PKGS[shards], PORT, n=2)
    try:
        owner, victim = "shard-0", "shard-1"
        name = pod.key_owned_by(owner)
        assert pod.map.ranked(name)[1].host_id == victim
        kb = make_bundle(rng)
        with faults.inject("net.partition",
                           handler=faults.partition({("router", victim)})):
            gen = pod.router.register_key(name, kb)
            assert pod.svc_of(owner).replication_digest() == {name: gen}
            assert pod.svc_of(victim).replication_digest() == {}
            assert pod.pump_until(victim, DOWN)
            assert pod.router.metrics_snapshot()[
                "router_replicate_failures_total"] == 1
            xs = points(rng, 5)
            assert_shares(lambda b: pod.router.evaluate(
                name, xs, b=b, timeout=WAIT_S), kb, xs)
        assert pod.pump_until(victim, UP)
        assert pod.svc_of(victim).replication_digest() == {name: gen}
        snap = pod.router.metrics_snapshot()
        assert snap["router_anti_entropy_runs_total"] >= 1
        assert snap["router_anti_entropy_frames_total"] == 1
        evs = [(e.host_id, e.frm, e.to) for e in pod.router.health.events()]
        assert (victim, SUSPECT, DOWN) in evs and (victim, DOWN, UP) in evs
    finally:
        pod.close()


def test_down_promotion_serves_normal_from_replica(rng):
    pod = Pod(PORT, PORT, n=3)
    try:
        victim = "shard-0"
        name = pod.key_owned_by(victim)
        kb = make_bundle(rng)
        pod.router.register_key(name, kb)
        pod.kill(victim)
        assert pod.pump_until(victim, DOWN)
        assert pod.router.suspect_remaining(victim) == 0.0
        xs = points(rng, 6)
        assert_shares(lambda b: pod.router.evaluate(
            name, xs, b=b, timeout=WAIT_S), kb, xs)
        snap = pod.router.metrics_snapshot()
        assert snap["router_promoted_forwards_total"] >= 2
        assert snap["router_failovers_total"] == 0
        assert snap[f"router_suspected_total{{shard={victim}}}"] == 0
        assert snap[f"router_health_state{{shard={victim}}}"] == 2
        # every holder DOWN: refused typed with a hint
        replica = pod.map.ranked(name)[1].host_id
        pod.kill(replica)
        assert pod.pump_until(replica, DOWN)
        with pytest.raises(CircuitOpenError) as ei:
            pod.router.evaluate(name, xs, b=0, timeout=WAIT_S)
        assert ei.value.retry_after_s > 0
        assert pod.router.metrics_snapshot()[
            "router_down_refusals_total"] >= 1
    finally:
        pod.close()


def test_request_suspect_while_prober_up(rng):
    """A transport failure seen by a request while the prober still
    says UP: NORMAL refused typed on the request plane, CRITICAL fails
    over, no probe evidence on the health plane."""
    pod = Pod(PORT, PORT, n=3)
    try:
        victim = "shard-0"
        name = pod.key_owned_by(victim)
        kb = make_bundle(rng)
        pod.router.register_key(name, kb)
        pod.kill(victim)
        xs = points(rng, 4)
        with pytest.raises(CircuitOpenError) as ei:
            pod.router.evaluate(name, xs, b=0, timeout=WAIT_S)
        assert ei.value.retry_after_s is not None
        assert pod.router.health.state(victim) == UP
        assert_shares(lambda b: pod.router.evaluate(
            name, xs, b=b, timeout=WAIT_S, priority="critical"), kb, xs)
        snap = pod.router.metrics_snapshot()
        assert snap[f"router_suspected_total{{shard={victim}}}"] >= 1
        assert snap["router_failovers_total"] >= 2
        assert snap[f"router_probe_failures_total{{shard={victim}}}"] == 0
    finally:
        pod.close()


# ------------------------------------------------------ backoff, churn


def test_pool_backoff_clamped_on_probe_confirmed_recovery(monkeypatch):
    clk = FakeClock(10.0)
    dialed = {"n": 0}

    def failing_connect(*a, **kw):
        dialed["n"] += 1
        raise OSError("injected dead target")

    monkeypatch.setattr(pedge.socket, "create_connection", failing_connect)
    pool = EdgeClientPool("127.0.0.1", 1, n_bytes=NB, size=1, clock=clk,
                          reconnect_backoff_s=1.0, max_backoff_s=64.0)
    try:
        for _ in range(8):
            with pytest.raises(BackendUnavailableError):
                pool.ping(timeout=1)
            clk.advance(pool._backoff)
        with pytest.raises(BackendUnavailableError):
            pool.ping(timeout=1)
        assert pool._backoff == 64.0
        before = dialed["n"]
        clk.advance(1.0)
        with pytest.raises(BackendUnavailableError, match="dark"):
            pool.ping(timeout=1)
        assert dialed["n"] == before
        pool.reset_backoff()
        with pytest.raises(BackendUnavailableError, match="connect"):
            pool.ping(timeout=1)
        assert dialed["n"] == before + 1
    finally:
        pool.close()


def test_up_transition_clamps_backoff_and_suspicion():
    pod = Pod(PORT, PORT, n=2)
    try:
        victim = "shard-1"
        pod.router.mark_suspect(victim, 3600.0)
        pool = pod.router._pools[victim]
        assert pool.ping(timeout=WAIT_S)
        pool._backoff, pool._dark_until = 64.0, 1e18
        for _ in range(3):
            pod.router.health.observe(victim, False)
        assert pod.router.health.state(victim) == DOWN
        for _ in range(2):
            pod.router.health.observe(victim, True)
        assert pod.router.health.state(victim) == UP
        assert pool._dark_until is None and pool._backoff == 0.0
        assert pod.router.suspect_remaining(victim) == 0.0
    finally:
        pod.close()


def test_router_state_bounded_under_ring_churn(rng):
    """``set_ring`` in and out of a ghost host, five cycles: suspect
    map, pools, health targets and the metrics snapshot end where they
    started; the surviving ring still serves."""
    pod = Pod(PORT, PORT, n=2)
    try:
        xs = points(rng, 2)
        baseline = None
        for cycle in range(5):
            ghost = f"ghost-{cycle}"
            grown = ShardMap([*pod.map.hosts(),
                              ShardSpec(ghost, "127.0.0.1", 1)])
            pod.router.set_ring(grown)
            assert ghost in pod.router._pools
            name = next(f"gk-{n}" for n in range(500)
                        if grown.owner(f"gk-{n}").host_id == ghost)
            with pytest.raises(CircuitOpenError):
                pod.router.evaluate(name, xs, b=0, timeout=WAIT_S)
            pod.router.health.pump()
            assert pod.router.suspect_remaining(ghost) > 0
            pod.router.set_ring(pod.map)
            assert ghost not in pod.router._pools
            assert pod.router.suspect_remaining(ghost) == 0.0
            assert pod.router.health.states() == {"shard-0": UP,
                                                  "shard-1": UP}
            snap = pod.router.metrics_snapshot()
            assert {k for k in snap if ghost in k} == set()
            baseline = baseline or set(snap)
            assert set(snap) == baseline
        kb = make_bundle(rng)
        name = pod.key_owned_by("shard-0")
        pod.router.register_key(name, kb)
        assert np.array_equal(pod.router.evaluate(name, xs, b=0,
                                                  timeout=WAIT_S),
                              oracle(kb, 0, xs))
    finally:
        pod.close()


def test_partition_handler_contract():
    h = faults.partition({("a", "b")})
    h("a", "c")
    for pair in (("a", "b"), ("b", "a")):
        with pytest.raises(OSError):
            h(*pair)
    clk = FakeClock(0.0)
    hw = faults.partition({("a", "b")}, clock=clk, window=(5.0, 10.0))
    hw("a", "b")
    clk.advance(6.0)
    with pytest.raises(OSError):
        hw("a", "b")
    clk.advance(10.0)
    hw("a", "b")
    with pytest.raises(ValueError):
        faults.partition({("a",)})
    with pytest.raises(ValueError):
        faults.partition({("a", "b")}, clock=clk)


def test_register_frame_byte_flips_die_typed(rng):
    """Byte-flipped REGISTER frames at a shard door each die typed on
    their own connection; a healthy one keeps answering pings and the
    key is never registered."""
    svc = service(PORT)
    srv = EdgeServer(svc).start()
    addr = srv.address
    frame = pedge.encode_register(5, "fuzz-key", make_bundle(rng).to_bytes())
    healthy = EdgeClient(*addr, n_bytes=NB)
    try:
        for off in rng.choice(len(frame) - 4, size=8, replace=False):
            buf = bytearray(frame)
            buf[4 + int(off)] ^= 0x41
            s = socket.create_connection(addr, timeout=WAIT_S)
            try:
                s.sendall(bytes(buf))
                s.shutdown(socket.SHUT_WR)
                s.settimeout(WAIT_S)
                frames = read_frames(s, pedge.decode_response)
            finally:
                s.close()
            assert all(f[0] == "error" for f in frames), frames
            assert healthy.ping(timeout=WAIT_S) and not healthy.closed
        assert "fuzz-key" not in svc.replication_digest()
        assert struct.unpack_from("<I", frame, 0)[0] == len(frame) - 4
    finally:
        healthy.close()
        srv.close()
        svc.close(drain=False)
