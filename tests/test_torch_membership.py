"""The port's ring control plane (``dcf_tpu_torch.serve.membership``)
against ``dcf_tpu``'s.

Scripted sequences: the same seeded pod (three shards, a router and a
``MembershipController`` on one ``FakeClock``) runs the same script in
both packages — keys registered through the router, a shard killed,
prober pumps walking it DOWN, an eject only after the grace, a warm join
with a registration racing the warm, a drain with a hot-swap racing its
migration and its deferred forget.  The ``MembershipEvent``s (kind,
host, epoch, migrated count) and the router's metrics snapshot (the
controller writes its series there) are equal, key for key.

Interop over loopback TCP: a port controller and router over a ring
mixing port shards (``walk``'s plain version, ``device="cpu"``) and
``dcf_tpu`` shards (its ``numpy`` facade), and the reverse; eject, join
and drain converge through DIGEST / SYNC / REGISTER with generations
preserved, every key serves both parties equal to the port's numpy
oracle after every change (x = alpha included), the pod converges on
each epoch (``ping_epoch`` over the wire), and a doctored stale-epoch
REQUEST frame dies ``E_EPOCH`` on both kinds of shard.

Then the controller's contracts on the port, modelled on
``tests/test_membership.py``: the rails, durable re-replication, the
``membership.migrate`` seam, joins that abort, rejoin within the drain
grace, post-commit sweep failures, a changed address, the lost-keys
audit, an unreachable store, the durable fallback, the epoch fence
(adoption, refusal, unadmitted senders, a stale router), the edge's
graceful drain, and the wire fuzz of the five control verbs.
Tolerance: exact byte equality; counters, gauges and events equal.
Every socket binds port 0 and every wait is bounded."""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading

import numpy as np
import pytest

from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    CircuitOpenError,
    KeyQuarantinedError,
    RingEpochError,
)
from dcf_tpu_torch.serve import (
    DcfRouter,
    EdgeClient,
    EdgeServer,
    KeyStore,
    MembershipController,
    ShardMap,
    ShardSpec,
    TenantSpec,
)
from dcf_tpu_torch.serve.edge import (
    E_EPOCH,
    decode_response,
    encode_digest,
    encode_ping,
    encode_pong,
    encode_register,
    encode_request,
    encode_sync,
)
from dcf_tpu_torch.serve.health import DOWN
from dcf_tpu_torch.testing import faults
from tests.torch_net import (
    NB,
    PORT,
    REF,
    WAIT_S,
    make_bundle,
    oracle,
    points,
    raw_exchange,
    service,
    wait_for,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0x15E)


class MemberPod:
    """In-process shards (a service + ``EdgeServer`` each, of the
    packages named in ``shard_pkgs``) behind one router of
    ``router_pkg`` with a ``MembershipController``.  ``shared_clock``
    puts the router on the controller's ``FakeClock`` too (the scripted
    comparisons); otherwise the router keeps the real clock."""

    def __init__(self, shard_pkgs, router_pkg=PORT, ctrl_kw=None,
                 stores=None, shared_clock=False):
        self.router_pkg = router_pkg
        self.svcs, self.servers, self.pkgs = {}, {}, {}
        self.clk = router_pkg.faults.FakeClock(100.0)
        specs = [self._mk_shard(f"shard-{i}", pkg)
                 for i, pkg in enumerate(shard_pkgs)]
        self.map = router_pkg.serve.ShardMap(specs)
        kw = dict(probe_fail_n=2, probe_recover_m=2,
                  reconnect_backoff_s=0.01, max_backoff_s=0.05,
                  probe_interval_s=0.05)
        if shared_clock:
            kw["clock"] = self.clk
        self.router = router_pkg.serve.DcfRouter(self.map, n_bytes=NB, **kw)
        ckw = dict(eject_grace_s=2.0, drain_grace_s=1.0, min_hosts=2)
        ckw.update(ctrl_kw or {})
        self.ctrl = router_pkg.serve.MembershipController(
            self.router, clock=self.clk, stores=stores, **ckw)

    def _mk_shard(self, host_id, pkg):
        svc = service(pkg)
        srv = pkg.edge.EdgeServer(svc).start()
        self.svcs[host_id], self.servers[host_id] = svc, srv
        self.pkgs[host_id] = pkg
        return self.router_pkg.serve.ShardSpec(host_id, *srv.address)

    def add_shard(self, host_id, pkg=PORT):
        """A started-but-unadmitted host (the join candidate)."""
        return self._mk_shard(host_id, pkg)

    def key_owned_by(self, host_id, prefix="mb-key", ring=None):
        ring = ring if ring is not None else self.router.map
        for n in range(10_000):
            name = f"{prefix}-{n}"
            if ring.owner(name).host_id == host_id:
                return name
        raise AssertionError(f"no key of {host_id}")

    def kill(self, host_id):
        self.servers[host_id].close()
        self.svcs[host_id].close(drain=False)

    def pump_until(self, host_id, state, rounds=200):
        for _ in range(rounds):
            if self.router.health.pump()[host_id] == state:
                return True
            threading.Event().wait(0.02)
        return False

    def serves(self, bundles, rng):
        """Every key, both parties, x = alpha first, equal to the port's
        numpy oracle through the router."""
        for name, kb in sorted(bundles.items()):
            xs = points(rng, 5)
            for b in (0, 1):
                y = self.router.evaluate(name, xs, b=b, timeout=WAIT_S)
                assert np.array_equal(y, oracle(kb, b, xs)), (name, b)

    def holders_at(self, name, gen):
        """The router's placement of ``name`` each hold it at ``gen``."""
        for h in self.router.map.placement_ids(name, self.router.replicas):
            assert self.svcs[h].replication_digest().get(name) == gen, (
                name, h, self.svcs[h].replication_digest())

    def close(self):
        self.ctrl.close()
        self.router.close()
        for srv in self.servers.values():
            srv.close()
        for svc in self.svcs.values():
            try:
                svc.close(drain=False)
            except Exception:  # fallback-ok: teardown of a killed shard
                pass


def ev_tuple(ev) -> tuple:
    """A ``MembershipEvent`` as (kind, host, epoch, migrated)."""
    return dataclasses.astuple(ev)[:4]


# ------------------------------------------------ the scripted sequence


def _scripted(pkg, bundles) -> tuple:
    """One deterministic control-plane script on a ``FakeClock``;
    returns (events, router snapshot, per-shard digests)."""
    pod = MemberPod([pkg] * 3, router_pkg=pkg, shared_clock=True)
    events = []
    try:
        gens = {}
        for name, kb in sorted(bundles.items()):
            gens[name] = pod.router.register_key(name, pkg.bundle(kb))
        victim = "shard-0"
        pod.kill(victim)
        for _ in range(3):
            pod.router.health.pump()
        assert pod.router.health.state(victim) == DOWN
        assert pod.ctrl.pump() == []  # DOWN alone never ejects
        pod.clk.advance(1.0)
        assert pod.ctrl.pump() == []
        pod.clk.advance(1.5)  # past eject_grace_s = 2.0
        events += pod.ctrl.pump()
        assert [e.kind for e in events] == ["eject"]
        # A join whose warm races a registration on the old ring.
        spec = pod.add_shard("shard-3", pkg)
        prospective = pod.router.map.with_host(spec)
        race = pod.key_owned_by("shard-3", prefix="mb-race",
                                ring=prospective)
        orig = pod.ctrl._converge
        calls = {"n": 0}

        def racing(*a, **kw):
            moved = orig(*a, **kw)
            calls["n"] += 1
            if calls["n"] == 1:
                gens[race] = pod.router.register_key(
                    race, pkg.bundle(bundles["mb-key-0"]))
            return moved

        pod.ctrl._converge = racing
        events.append(pod.ctrl.join(spec))
        pod.ctrl._converge = orig
        assert calls["n"] == 2  # the warm and the post-admission sweep
        # A drain whose migration races a hot-swap of a drainee's key,
        # then its deferred forget after the grace.
        swap = pod.key_owned_by("shard-1", prefix="mb-key")
        calls["n"] = 0

        def hot_swap(*a, **kw):
            moved = orig(*a, **kw)
            calls["n"] += 1
            if calls["n"] == 1:
                gens[swap] = pod.router.register_key(
                    swap, pkg.bundle(bundles["mb-key-1"]))
            return moved

        pod.ctrl._converge = hot_swap
        events.append(pod.ctrl.drain("shard-1"))
        pod.ctrl._converge = orig
        assert pod.ctrl.pump() == []
        pod.clk.advance(1.5)
        events += pod.ctrl.pump()
        digests = {h: pod.svcs[h].replication_digest()
                   for h in pod.router.map.host_ids()}
        for name in gens:
            pod.holders_at(name, gens[name])
        pod.router.health.pump()
        return ([ev_tuple(e) for e in events] + [e.at for e in events],
                pod.router.metrics_snapshot(), digests)
    finally:
        pod.close()


def test_scripted_sequence_events_and_snapshot_equal_to_dcf_tpu(rng):
    bundles = {f"mb-key-{i}": make_bundle(rng) for i in range(6)}
    ev_p, snap_p, dig_p = _scripted(PORT, bundles)
    ev_j, snap_j, dig_j = _scripted(REF, bundles)
    assert ev_p == ev_j
    kinds = [e[0] for e in ev_p[:4]]
    assert kinds == ["eject", "join", "drain", "drain-complete"]
    assert [e[2] for e in ev_p[:3]] == [1, 2, 3]  # strictly increasing
    assert dig_p == dig_j
    assert sorted(snap_p) == sorted(snap_j)
    assert {k: (snap_p[k], snap_j[k]) for k in snap_p
            if snap_p[k] != snap_j[k]} == {}
    assert snap_p["membership_ejections_total"] == 1
    assert snap_p["membership_joins_total"] == 1
    assert snap_p["membership_drains_total"] == 1
    assert snap_p["membership_ring_size"] == 2
    assert snap_p["router_ring_epoch"] == 3
    assert not any("shard-0" in k or "shard-1" in k for k in snap_p)


def test_without_host_moves_exactly_the_victims_keys():
    """``ShardMap.without_host``: only the victim's keys move, each to
    the host its ranking had next, and the ranking equals
    ``dcf_tpu``'s; ``peers`` is every other member."""
    import dcf_tpu.serve.shardmap as jshardmap

    ids = [f"h{i}" for i in range(5)]
    ring = ShardMap([ShardSpec(h) for h in ids])
    jring = jshardmap.ShardMap([jshardmap.ShardSpec(h) for h in ids])
    smaller, jsmaller = ring.without_host("h2"), jring.without_host("h2")
    for n in range(2000):
        key = f"k-{n}"
        ranked = [s.host_id for s in ring.ranked(key)]
        after = smaller.owner(key).host_id
        assert after == jsmaller.owner(key).host_id
        if ranked[0] != "h2":
            assert after == ranked[0]
        else:
            assert after == ranked[1]
    assert [s.host_id for s in ring.peers("h2")] == ["h0", "h1", "h3",
                                                     "h4"]
    assert ring.with_host(ShardSpec("h2", "10.0.0.1", 9)).get("h2").port == 9
    for bad in (lambda: ring.without_host("h9"),
                lambda: ring.peers("h9")):
        with pytest.raises(ValueError, match="not in the ring"):
            bad()


# ------------------------------------------------ interop over loopback


def _epochs_converged(pod):
    """Every ring member reports the router's epoch over the wire."""
    pod.router.health.pump()
    for h in pod.router.map.host_ids():
        with EdgeClient(*pod.router.map.get(h).address, n_bytes=NB) as c:
            assert c.ping_epoch(timeout=WAIT_S) == pod.router.ring_epoch, h


def _stale_request_dies_e_epoch(pod, host_id, name, rng):
    xs = points(rng, 2)
    wire = encode_request(7, "default", name, 0, 1, None, xs.tobytes(),
                          NB, 2, epoch=pod.router.ring_epoch - 1)
    frames = raw_exchange(pod.router.map.get(host_id).address, wire,
                          decode_response)
    assert [f[:3] for f in frames] == [("error", 7, E_EPOCH)], frames


@pytest.mark.parametrize("router_pkg, shard_pkgs", [
    (PORT, [PORT, REF, PORT]),
    (REF, [REF, PORT, REF]),
], ids=["port-controller", "dcf_tpu-controller"])
def test_mixed_pod_converges_through_eject_join_drain(router_pkg,
                                                      shard_pkgs, rng):
    pod = MemberPod(shard_pkgs, router_pkg=router_pkg)
    bundles = {f"mx-key-{i}": make_bundle(rng) for i in range(6)}
    try:
        gens = {name: pod.router.register_key(name, router_pkg.bundle(kb))
                for name, kb in bundles.items()}
        pod.serves(bundles, rng)
        # Eject the shard of the OTHER package than the controller's.
        victim = "shard-1"
        pod.kill(victim)
        assert pod.pump_until(victim, DOWN)
        assert pod.ctrl.pump() == []
        pod.clk.advance(2.5)
        (ev,) = pod.ctrl.pump()
        assert (ev.kind, ev.epoch) == ("eject", 1)
        for name, gen in gens.items():
            pod.holders_at(name, gen)
        pod.serves(bundles, rng)
        _epochs_converged(pod)
        # Join a shard of the other package, warm.
        other = PORT if router_pkg is REF else REF
        ev = pod.ctrl.join(pod.add_shard("shard-3", other))
        assert (ev.kind, ev.epoch) == ("join", 2)
        for name, gen in gens.items():
            pod.holders_at(name, gen)
        pod.serves(bundles, rng)
        _epochs_converged(pod)
        # Drain a shard of the controller's package.
        ev = pod.ctrl.drain("shard-0")
        assert (ev.kind, ev.epoch) == ("drain", 3)
        for name, gen in gens.items():
            pod.holders_at(name, gen)
        pod.serves(bundles, rng)
        pod.clk.advance(1.5)
        assert [e.kind for e in pod.ctrl.pump()] == ["drain-complete"]
        _epochs_converged(pod)
        # A doctored stale-epoch REQUEST dies E_EPOCH on both kinds.
        name = sorted(bundles)[0]
        for h in ("shard-2", "shard-3"):
            _stale_request_dies_e_epoch(pod, h, name, rng)
        kinds = {pod.pkgs[h].name for h in ("shard-2", "shard-3")}
        assert kinds == {"port", "dcf_tpu"}
        snap = pod.router.metrics_snapshot()
        assert snap["membership_change_failures_total"] == 0
        assert pod.ctrl.lost_keys() == []
    finally:
        pod.close()


# ------------------------------------------------ contracts on the port


def test_controller_validates_config_and_epoch_monotonic():
    pod = MemberPod([PORT] * 2)
    try:
        for kw in (dict(eject_grace_s=-1), dict(min_hosts=0),
                   dict(poll_interval_s=0)):
            with pytest.raises(ValueError):
                MembershipController(pod.router, **kw)
        pod.router.set_ring(pod.map, epoch=3)
        for stale in (3, 1, 0):
            with pytest.raises(ValueError, match="monotonic"):
                pod.router.set_ring(pod.map, epoch=stale)
        assert pod.router.metrics_snapshot()["router_ring_epoch"] == 3
        with pytest.raises(ValueError, match="still in the ring"):
            pod.router.forget_host("shard-0")
        group = pod.router.set_mesh(epoch=7)
        assert group.epoch == 7
    finally:
        pod.close()


def test_eject_skipped_below_min_hosts_and_during_multi_failure():
    pod = MemberPod([PORT] * 2)
    try:
        pod.kill("shard-1")
        assert pod.pump_until("shard-1", DOWN)
        assert pod.ctrl.eject_in_flight()
        pod.ctrl.pump()
        pod.clk.advance(10.0)
        assert pod.ctrl.pump() == []
        assert "shard-1" in pod.router.map
        snap = pod.router.metrics_snapshot()
        assert snap["membership_eject_skipped_total"] >= 1
        assert snap["membership_ejections_total"] == 0
    finally:
        pod.close()
    pod = MemberPod([PORT] * 3)
    try:
        pod.kill("shard-0")
        pod.kill("shard-1")
        assert pod.pump_until("shard-0", DOWN)
        assert pod.pump_until("shard-1", DOWN)
        pod.ctrl.pump()
        pod.clk.advance(10.0)
        assert pod.ctrl.pump() == []
        assert len(pod.router.map) == 3
        assert pod.router.metrics_snapshot()[
            "membership_eject_skipped_total"] >= 2
    finally:
        pod.close()


def test_eject_replicates_durable_frames_via_stores(rng, tmp_path):
    stores = {f"shard-{i}": KeyStore(str(tmp_path / f"shard-{i}"))
              for i in range(3)}
    pod = MemberPod([PORT] * 3, stores=stores)
    try:
        victim = "shard-0"
        name = pod.key_owned_by(victim, prefix="mb-dur")
        kb = make_bundle(rng)
        gen = pod.router.register_key(name, kb)
        placed = [s.host_id
                  for s in pod.router.map.placement(name, replicas=1)]
        stores[placed[0]].put(name, kb, generation=gen)
        stores[placed[0]].replicate_to(stores[placed[1]], name)
        pod.kill(victim)
        assert pod.pump_until(victim, DOWN)
        pod.ctrl.pump()
        pod.clk.advance(3.0)
        assert [e.kind for e in pod.ctrl.pump()] == ["eject"]
        for hid in pod.router.map.placement_ids(name, replicas=1):
            assert stores[hid].digest().get(name) == gen, hid
        assert pod.ctrl.lost_keys(exclude={victim}) == []
        assert pod.ctrl.store_for("shard-1") is stores["shard-1"]
        snap = pod.router.metrics_snapshot()
        assert snap["membership_durable_replications_total"] >= 1
        assert snap["membership_lost_keys_total"] == 0
    finally:
        pod.close()


def test_migrate_seam_aborts_change_typed_then_retries(rng):
    pod = MemberPod([PORT] * 3)
    try:
        victim = "shard-0"
        name = pod.key_owned_by(victim)
        gen = pod.router.register_key(name, make_bundle(rng))
        pod.kill(victim)
        assert pod.pump_until(victim, DOWN)
        pod.ctrl.pump()
        pod.clk.advance(3.0)
        seen = []

        def source_dies(*args):
            seen.append(args)
            raise BackendUnavailableError("migration source died")

        with faults.inject("membership.migrate", handler=source_dies):
            with pytest.raises(BackendUnavailableError):
                pod.ctrl.eject(victim)
            assert pod.ctrl.pump() == []
            assert victim in pod.router.map
            assert pod.router.ring_epoch == 0
        assert seen == [(["shard-1", "shard-2"], 2)] * 2
        snap = pod.router.metrics_snapshot()
        assert snap["membership_change_failures_total"] >= 1
        assert snap["membership_ejections_total"] == 0
        assert [e.kind for e in pod.ctrl.pump()] == ["eject"]
        for hid in ("shard-1", "shard-2"):
            assert pod.svcs[hid].replication_digest()[name] == gen
    finally:
        pod.close()


def test_join_aborts_typed_on_unreachable_host_and_cleans_up(rng):
    pod = MemberPod([PORT] * 2)
    try:
        pod.router.register_key("mb-ja", make_bundle(rng))
        dead = ShardSpec("shard-dead", "127.0.0.1", 1)
        with pytest.raises(BackendUnavailableError):
            pod.ctrl.join(dead)
        assert "shard-dead" not in pod.router.map
        assert "shard-dead" not in pod.router._pools
        assert pod.router.ring_epoch == 0
        snap = pod.router.metrics_snapshot()
        assert snap["membership_change_failures_total"] == 1
        assert snap["membership_joins_total"] == 0
        with pytest.raises(ValueError, match="already in the ring"):
            pod.ctrl.join(pod.map.hosts()[0])
    finally:
        pod.close()


def test_drain_validations():
    pod = MemberPod([PORT], ctrl_kw=dict(min_hosts=1))
    try:
        with pytest.raises(ValueError, match="not in the ring"):
            pod.ctrl.drain("shard-9")
        with pytest.raises(ValueError, match="last host"):
            pod.ctrl.drain("shard-0")
        with pytest.raises(ValueError, match="not in the ring"):
            pod.ctrl.eject("shard-9")
    finally:
        pod.close()


def test_rejoin_within_drain_grace_does_not_wedge_pump(rng):
    pod = MemberPod([PORT] * 3)
    try:
        name = pod.key_owned_by("shard-0", prefix="mb-rr")
        kb = make_bundle(rng)
        pod.router.register_key(name, kb)
        spec = pod.map.get("shard-0")
        assert pod.ctrl.drain("shard-0").kind == "drain"
        assert pod.ctrl.draining() == {"shard-0": pytest.approx(101.0)}
        assert pod.ctrl.join(spec).kind == "join"
        pod.clk.advance(1.5)
        assert [e.kind for e in pod.ctrl.pump()] == ["drain-complete"]
        assert "shard-0" in pod.router._pools  # the member's pool
        assert pod.ctrl.draining() == {}
        assert pod.ctrl.pump() == []
        pod.serves({name: kb}, rng)
    finally:
        pod.close()


def test_post_commit_sweep_failure_does_not_abort_the_change(rng):
    pod = MemberPod([PORT] * 3)
    try:
        pod.router.register_key(
            pod.key_owned_by("shard-0", prefix="mb-ps"), make_bundle(rng))
        orig = pod.ctrl._converge
        calls = {"n": 0}

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 2:  # the post-swap sweep
                raise BackendUnavailableError("peer died post-commit")
            return orig(*a, **kw)

        pod.ctrl._converge = flaky
        ev = pod.ctrl.drain("shard-0")
        assert ev.kind == "drain" and ev.epoch == 1
        assert "shard-0" in pod.ctrl.draining()
        snap = pod.router.metrics_snapshot()
        assert snap["membership_drains_total"] == 1
        assert snap["membership_change_failures_total"] == 1
        pod.clk.advance(1.5)
        assert [e.kind for e in pod.ctrl.pump()] == ["drain-complete"]
        assert "shard-0" not in pod.router._pools
    finally:
        pod.close()


def test_join_redials_when_rejoining_host_changed_address(rng):
    pod = MemberPod([PORT] * 3)
    try:
        name = pod.key_owned_by("shard-0", prefix="mb-ra")
        kb = make_bundle(rng)
        pod.router.register_key(name, kb)
        assert pod.ctrl.drain("shard-0").kind == "drain"
        old_port = pod.router._pools["shard-0"].port
        spec = pod.add_shard("shard-0")  # same identity, fresh port
        assert spec.port != old_port
        assert pod.ctrl.join(spec).kind == "join"
        assert pod.router._pools["shard-0"].port == spec.port
        assert pod.svcs["shard-0"].replication_digest().get(name)
        pod.serves({name: kb}, rng)
    finally:
        pod.close()


def test_lost_keys_audit_counts_each_loss_once(rng, tmp_path):
    stores = {"shard-0": KeyStore(str(tmp_path / "s0")),
              "shard-1": KeyStore(str(tmp_path / "s1"))}
    pod = MemberPod([PORT] * 2, stores=stores)
    try:
        stores["shard-0"].put("lk", make_bundle(rng), generation=1)
        stores["shard-0"].put("~pool/p/0", make_bundle(rng), generation=2)
        assert pod.ctrl.lost_keys(exclude={"shard-0"}) == ["lk"]
        assert pod.ctrl.lost_keys(exclude={"shard-0"}) == ["lk"]
        assert pod.router.metrics_snapshot()[
            "membership_lost_keys_total"] == 1
        stores["shard-0"].replicate_to(stores["shard-1"], "lk")
        assert pod.ctrl.lost_keys(exclude={"shard-0"}) == []
        assert pod.ctrl.lost_keys(
            exclude={"shard-0", "shard-1"}) == ["lk"]
        assert pod.router.metrics_snapshot()[
            "membership_lost_keys_total"] == 2
    finally:
        pod.close()


def test_unreachable_store_does_not_wedge_eject(rng, tmp_path):
    stores = {f"shard-{i}": KeyStore(str(tmp_path / f"shard-{i}"))
              for i in range(3)}
    pod = MemberPod([PORT] * 3, stores=stores)
    try:
        victim = "shard-0"
        name = pod.key_owned_by(victim, prefix="mb-ds")
        kb = make_bundle(rng)
        gen = pod.router.register_key(name, kb)
        placed = [s.host_id
                  for s in pod.router.map.placement(name, replicas=1)]
        stores[placed[0]].put(name, kb, generation=gen)
        stores[placed[0]].replicate_to(stores[placed[1]], name)

        def dead_digest():
            raise OSError("mount gone")

        stores[victim].digest = dead_digest
        pod.kill(victim)
        assert pod.pump_until(victim, DOWN)
        pod.ctrl.pump()
        pod.clk.advance(3.0)
        assert [e.kind for e in pod.ctrl.pump()] == ["eject"]
        assert pod.router.metrics_snapshot()[
            "membership_store_unreachable_total"] >= 1
        for hid in pod.router.map.placement_ids(name, replicas=1):
            assert stores[hid].digest().get(name) == gen, hid
    finally:
        pod.close()


def test_durable_copy_falls_back_to_another_holder(rng, tmp_path):
    stores = {f"shard-{i}": KeyStore(str(tmp_path / f"s{i}"))
              for i in range(3)}
    pod = MemberPod([PORT] * 3, stores=stores)
    try:
        kb = make_bundle(rng)
        name = "mb-fb"
        ring = pod.router.map
        dst = [s.host_id for s in ring.placement(name, replicas=1)][1]
        holders = sorted(h for h in stores if h != dst)
        for h in holders:
            stores[h].put(name, kb, generation=2)

        def boom(*a, **kw):
            raise BackendUnavailableError("source store down")

        stores[holders[0]].replicate_to = boom
        assert pod.ctrl._replicate_durable(ring, exclude=set()) == 1
        assert stores[dst].digest().get(name) == 2
        stores[holders[1]].replicate_to = boom
        stores[dst].delete(name)
        with pytest.raises(BackendUnavailableError):
            pod.ctrl._replicate_durable(ring, exclude=set())
    finally:
        pod.close()


def test_start_worker_ejects_on_its_own():
    """``start()``: the control worker evaluates the grace itself; on
    the real clock a grace of 0 ejects within a few polls."""
    pod = MemberPod([PORT] * 3)
    ctrl = MembershipController(pod.router, eject_grace_s=0.0,
                                poll_interval_s=0.02)
    try:
        pod.kill("shard-2")
        assert pod.pump_until("shard-2", DOWN)
        ctrl.start()
        deadline = threading.Event()
        for _ in range(500):
            if "shard-2" not in pod.router.map:
                break
            deadline.wait(0.02)
        assert "shard-2" not in pod.router.map
        assert [e.kind for e in ctrl.events()] == ["eject"]
        assert "MembershipController(ring=" in repr(ctrl)
    finally:
        ctrl.close()
        pod.close()


# ------------------------------------------------ the epoch fence


def test_unadmitted_request_cannot_adopt_epoch(rng):
    svc = service(PORT, tenants=(TenantSpec("router", "critical"),))
    server = EdgeServer(svc).start()
    kb = make_bundle(rng)
    svc.register_key("ep-key", kb)
    svc.check_ring_epoch(3)
    xs = points(rng, 2)
    try:
        forged = encode_request(1, "intruder", "ep-key", 0, 255, None,
                                xs.tobytes(), NB, 2, epoch=(1 << 32) - 1)
        frames = raw_exchange(server.address, forged, decode_response)
        assert [f[0] for f in frames] == ["error"]
        assert svc.ring_epoch == 3  # NOT adopted
        with EdgeClient(*server.address, n_bytes=NB,
                        tenant="router") as c:
            y = c.submit_bytes("ep-key", xs.tobytes(), b=0,
                               epoch=3).result(timeout=WAIT_S)
            assert np.array_equal(y, oracle(kb, 0, xs))
            c.submit_bytes("ep-key", xs.tobytes(), b=0,
                           epoch=4).result(timeout=WAIT_S)
        assert svc.ring_epoch == 4
    finally:
        server.close()
        svc.close(drain=False)


def test_edge_graceful_drain_delivers_queued_responses(rng):
    """``stop_accepting`` refuses new dials with the live links open; a
    request accepted before it completes once the service drains, and
    ``EdgeServer.close(drain_s=)`` delivers the response.  The drain
    starts once the service has admitted the request: until then it is
    in the edge's reader, not yet accepted work."""
    svc = service(PORT, max_delay_ms=50.0)
    server = EdgeServer(svc).start()
    addr = server.address
    kb = make_bundle(rng)
    svc.register_key("gd-key", kb)
    client = EdgeClient(*addr, n_bytes=NB)
    try:
        xs = points(rng, 3)
        fut = client.submit("gd-key", xs, b=0)
        wait_for(lambda: svc.metrics_snapshot()["serve_requests_total"] >= 1,
                 "the service to admit the request")
        server.stop_accepting()
        with pytest.raises(OSError):
            socket.create_connection(addr, timeout=2)
        svc.close(drain=True)
        server.close(drain_s=5.0)
        assert np.array_equal(fut.result(timeout=WAIT_S), oracle(kb, 0, xs))
    finally:
        client.close()
        server.close()
        svc.close(drain=False)


def test_epoch_fence_adopt_and_refuse_in_process_and_wire(rng):
    svc = service(PORT)
    server = EdgeServer(svc).start()
    try:
        assert svc.check_ring_epoch(5) == 5
        with pytest.raises(RingEpochError):
            svc.check_ring_epoch(4)
        kb = make_bundle(rng)
        svc.register_key("fence-key", kb)
        xs = points(rng, 4)
        with EdgeClient(*server.address, n_bytes=NB) as c:
            assert c.ping_epoch(timeout=WAIT_S, epoch=7) == 7
            assert c.ping_epoch(timeout=WAIT_S) == 7  # unfenced echo
            with pytest.raises(RingEpochError) as ei:
                c.submit_bytes("fence-key", xs.data, b=0,
                               epoch=6).result(WAIT_S)
            assert ei.value.wire_code == E_EPOCH
            assert ei.value.retry_after_s is not None
            with pytest.raises(RingEpochError):
                c.register_frame("fence-key", make_bundle(rng).to_bytes(),
                                 epoch=3)
            with pytest.raises(RingEpochError):
                c.ping(timeout=WAIT_S, epoch=2)
            y0 = c.submit_bytes("fence-key", xs.data, b=0,
                                epoch=7).result(WAIT_S)
            assert np.array_equal(y0, oracle(kb, 0, xs))
        assert svc.metrics_snapshot()["serve_epoch_fenced_total"] == 4
    finally:
        server.close()
        svc.close(drain=False)


def test_stale_router_structurally_refused(rng):
    pod = MemberPod([PORT] * 2)
    stale = None
    try:
        name = pod.key_owned_by("shard-0")
        kb = make_bundle(rng)
        pod.router.register_key(name, kb)
        stale = DcfRouter(pod.map, n_bytes=NB)
        stale.set_ring(pod.map, epoch=1)
        pod.router.set_ring(pod.map, epoch=2)
        pod.serves({name: kb}, rng)
        xs = points(rng, 3)
        with pytest.raises(RingEpochError) as ei:
            stale.evaluate(name, xs, b=0, timeout=WAIT_S)
        assert ei.value.retry_after_s is not None
        assert stale.metrics_snapshot()["router_stale_epoch_total"] >= 1
        assert stale.suspect_remaining("shard-0") == 0.0
        stale.set_ring(pod.map, epoch=2)
        assert np.array_equal(stale.evaluate(name, xs, b=1,
                                             timeout=WAIT_S),
                              oracle(kb, 1, xs))
    finally:
        if stale is not None:
            stale.close()
        pod.close()


# ------------------------------------------------ control-verb fuzz


def test_wire_fuzz_all_control_verbs_die_typed_per_connection(rng):
    svc = service(PORT)
    server = EdgeServer(svc).start()
    addr = server.address
    kb = make_bundle(rng)
    valid = {
        "ping": encode_ping(11, 0),
        "register": encode_register(12, "fz-key", kb.to_bytes(), 0, False),
        "digest": encode_digest(13, {"fz-key": 3}, mode=1),
        "pong": encode_pong(14, 0),
        "sync": encode_sync(15, [("fz-key", 1, False, b"notakey")]),
    }
    healthy = EdgeClient(*addr, n_bytes=NB)
    try:
        for verb, frame in sorted(valid.items()):
            mangles = [frame] if verb in ("pong", "sync") else []
            for off in rng.choice(len(frame) - 4, size=4, replace=False):
                buf = bytearray(frame)
                buf[4 + int(off)] ^= 0x41
                mangles.append(bytes(buf))
            mangles.append(frame[: max(len(frame) // 2, 5)])
            mangles.append(struct.pack("<I", 1 << 30))
            for i, wire in enumerate(mangles):
                for decoded in raw_exchange(addr, wire, decode_response):
                    assert decoded[0] == "error", (verb, i, decoded)
                assert healthy.ping(timeout=WAIT_S)
                assert not healthy.closed
        assert "fz-key" not in svc.replication_digest()
        with EdgeClient(*addr, n_bytes=NB) as fresh:
            assert fresh.ping(timeout=WAIT_S)
    finally:
        healthy.close()
        server.close()
        svc.close(drain=False)


def test_corrupt_control_response_fails_client_typed():
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    host, port = lst.getsockname()[:2]

    def fake_server():
        conn, _ = lst.accept()
        try:
            conn.settimeout(WAIT_S)
            conn.recv(1 << 16)  # the client's ping frame
            pong = bytearray(encode_pong(1, 0))
            pong[9] ^= 0x7F  # corrupt inside the body: the CRC catches it
            conn.sendall(bytes(pong))
        finally:
            conn.close()

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    c = EdgeClient(host, port, n_bytes=NB)
    try:
        with pytest.raises(BackendUnavailableError):
            c.ping_epoch(timeout=WAIT_S)
        assert c.closed
    finally:
        c.close()
        lst.close()
        t.join(10)


def test_circuit_open_before_the_prober_then_eject_serves(rng):
    """The eject racing a request: before the prober speaks, a NORMAL
    submit for the dead owner's key is refused typed with a hint and a
    CRITICAL one fails over; after the eject the key serves NORMAL
    traffic on the new ring, and the victim's series are gone."""
    pod = MemberPod([PORT] * 3)
    try:
        victim = "shard-0"
        name = pod.key_owned_by(victim)
        kb = make_bundle(rng)
        pod.router.register_key(name, kb)
        pod.kill(victim)
        xs = points(rng, 5)
        with pytest.raises(CircuitOpenError) as ei:
            pod.router.evaluate(name, xs, b=0, timeout=WAIT_S)
        assert ei.value.retry_after_s is not None
        y = pod.router.evaluate(name, xs, b=1, timeout=WAIT_S,
                                priority="critical")
        assert np.array_equal(y, oracle(kb, 1, xs))
        assert pod.pump_until(victim, DOWN)
        pod.ctrl.pump()
        pod.clk.advance(2.5)
        assert [e.kind for e in pod.ctrl.pump()] == ["eject"]
        pod.serves({name: kb}, rng)
        snap = pod.router.metrics_snapshot()
        assert {k for k in snap if victim in k} == set()
        assert victim not in pod.router._pools
    finally:
        pod.close()


def test_replicate_to_retry_and_quarantine(rng, tmp_path):
    """The store's bounded transient retry under a migration: a blip
    is retried (counted) and succeeds; a corrupt source frame
    quarantines at once, typed, with no retry."""
    src = KeyStore(str(tmp_path / "src"))
    dst = KeyStore(str(tmp_path / "dst"))
    kb = make_bundle(rng)
    src.put("rk", kb, generation=5)
    naps = []
    with faults.inject_schedule("store.write", window_evals=2,
                                exc=OSError("injected blip")):
        assert src.replicate_to(dst, "rk", retries=3, backoff_s=0.05,
                                sleep=naps.append) == 5
    assert dst.digest() == {"rk": 5} and naps == [0.05, 0.1]
    assert src._metrics.counter(
        "serve_store_replicate_retries_total").value == 2
    src.put("bad", kb, generation=1)
    ent = src._read_manifest()["bad"]
    path = tmp_path / "src" / ent["file"]
    raw = bytearray(path.read_bytes())
    raw[10] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(KeyQuarantinedError):
        src.replicate_to(dst, "bad", retries=5, sleep=naps.append)
    assert len(naps) == 2
