"""The port's pod routing tier (``dcf_tpu_torch.serve.router``,
``shardmap``) against ``dcf_tpu``'s.

Placement: ``ShardMap.owner`` / ``ranked`` / ``placement`` equal
``dcf_tpu``'s over seeded member sets and 10^4 key ids.  Interop over
loopback TCP: port shards (``walk``, B1's plain version,
``device="cpu"``) behind a ``dcf_tpu`` ``DcfRouter``, ``dcf_tpu`` shards
(its ``numpy`` facade) behind a port router, and port behind port:
routed shares of both parties, XOR and add16, x = alpha included, equal
to the port's numpy oracle, and a live registration through the router
lands on owner and replica under the generation the owner minted.  Then
the router's contracts on the port, modelled on ``tests/test_pod.py``:
DCFE at the pod door, CRITICAL failover to the replica with the rest
refused typed, the hot-swap ``StaleStateError`` across the router, byte
flips at the door, the reconnecting ``EdgeClientPool``, the open loop
reconciled against the pod rollup, every request of a failover loop
accounted for, the ring-epoch fence across the router, and one scripted
router sequence whose metrics snapshot equals ``dcf_tpu``'s key for key.
Tolerance: exact byte equality; counters and gauges equal.  Every
socket binds port 0 and every wait is bounded."""

import socket
import threading
import time

import numpy as np
import pytest

import dcf_tpu.serve as jserve

from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    CircuitOpenError,
    DcfError,
    RingEpochError,
    StaleStateError,
)
from dcf_tpu_torch.serve import (
    DcfRouter,
    EdgeClient,
    EdgeClientPool,
    ShardMap,
    ShardSpec,
    TenantSpec,
    rollup_snapshots,
)
from dcf_tpu_torch.serve import edge as pedge
from dcf_tpu_torch.serve.loadgen import open_loop, reconcile_against_rollup
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.testing.faults import FakeClock
from tests.torch_net import (
    NB,
    PKGS,
    PORT,
    REF,
    WAIT_S,
    Pod,
    assert_shares,
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
    return np.random.default_rng(0x90D)


@pytest.fixture(scope="module")
def bundles(rng):
    out = {f"pod-key-{i}": make_bundle(rng) for i in range(5)}
    out["pod-add"] = make_bundle(rng, "add16")
    return out


# -------------------------------------------------------------- the ring


@pytest.mark.parametrize("n_hosts", [1, 2, 5, 9])
def test_shardmap_placement_equal_to_dcf_tpu(n_hosts):
    """Seeded member sets (ids of mixed length and alphabet) and 10^4
    key ids: owner, ranking and placement at 0-2 replicas are
    ``dcf_tpu``'s, whatever order the members are listed in."""
    r = np.random.default_rng(1000 + n_hosts)
    ids = [f"h{int(r.integers(0, 1 << 30)):x}-{'é' * int(r.integers(0, 3))}"
           for _ in range(n_hosts)]
    order = list(r.permutation(n_hosts))
    pm = ShardMap([ShardSpec(ids[i], port=1000 + i) for i in order])
    jm = jserve.ShardMap([jserve.ShardSpec(h, port=2000 + i)
                          for i, h in enumerate(ids)])
    assert pm.host_ids() == jm.host_ids()
    for i in range(10_000):
        key = f"key-{i}-{int(r.integers(0, 1 << 20))}"
        assert pm.owner(key).host_id == jm.owner(key).host_id
        if i % 10 == 0:
            assert [s.host_id for s in pm.ranked(key)] == \
                [s.host_id for s in jm.ranked(key)]
            for rep in (0, 1, 2):
                assert pm.placement_ids(key, rep) == \
                    jm.placement_ids(key, rep)


def test_membership_change_moves_only_the_changed_hosts_keys():
    """Adding a host moves keys only onto it; removing one moves only
    its keys, each to its old second choice (the replica)."""
    keys = [f"k{i}" for i in range(2000)]
    specs = [ShardSpec(f"h{i}") for i in range(4)]
    ring = ShardMap(specs)
    owners = {k: ring.owner(k).host_id for k in keys}
    grown = ShardMap([*specs, ShardSpec("h9")])
    moved = [k for k in keys if grown.owner(k).host_id != owners[k]]
    assert moved and all(grown.owner(k).host_id == "h9" for k in moved)
    shrunk = ShardMap([s for s in specs if s.host_id != "h1"])
    for k in keys:
        want = owners[k] if owners[k] != "h1" else ring.ranked(k)[1].host_id
        assert shrunk.owner(k).host_id == want
    with pytest.raises(ValueError):
        ShardMap([])
    with pytest.raises(ValueError):
        ShardMap([ShardSpec("a"), ShardSpec("a", port=2)])
    with pytest.raises(ValueError):
        ShardSpec("")
    assert ShardMap([ShardSpec("a")]).placement("k", 2) == [ShardSpec("a")]


# ------------------------------------------------------- routed serving


@pytest.mark.parametrize("shards,router", [
    ("port", "port"), ("port", "dcf_tpu"), ("dcf_tpu", "port")])
def test_routed_shares_and_live_registration_across_packages(
        shards, router, bundles, rng):
    """Routed shares of both parties equal the oracle, XOR and add16,
    x = alpha included, with traffic on more than one shard; a key
    registered through the router lands on its owner and replica under
    the generation the owner minted, and serves."""
    pod = Pod(PKGS[shards], PKGS[router], n=3, bundles=bundles)
    try:
        for name, kb in sorted(bundles.items()):
            xs = points(rng, int(rng.integers(1, 40)))
            assert_shares(lambda b: pod.router.evaluate(
                name, xs, b=b, timeout=WAIT_S), kb, xs)
        snap = pod.router.metrics_snapshot()
        assert sum(snap[f"router_forwards_total{{shard={h}}}"] > 0
                   for h in pod.map.host_ids()) >= 2
        kb = make_bundle(rng, "add16")
        gen = pod.router.register_key("live-key", PKGS[router].bundle(kb))
        placed = pod.map.placement_ids("live-key", 1)
        for h in pod.map.host_ids():
            digest = pod.svc_of(h).replication_digest()
            assert digest.get("live-key") == (gen if h in placed else None)
        xs = points(rng, 9)
        assert_shares(lambda b: pod.router.evaluate(
            "live-key", xs, b=b, timeout=WAIT_S), kb, xs)
    finally:
        pod.close()


@pytest.mark.parametrize("client", ["port", "dcf_tpu"])
def test_dcfe_on_both_sides_of_the_pod_door(client, bundles, rng):
    """A client of either package at the port router's own
    ``EdgeServer``: two hops, both parties equal to the oracle; the
    door's tenant table refuses an unknown tenant typed and an unknown
    key passes through typed, and the connection keeps serving."""
    pod = Pod(PORT, PORT, n=2, bundles=bundles, router_kw=dict(
        tenants=(TenantSpec("gold", "critical"),)))
    pod.router.start()
    cedge = PKGS[client].edge
    try:
        name = "pod-key-0"
        xs = points(rng, 9)
        with cedge.EdgeClient(*pod.router.address, n_bytes=NB,
                              tenant="gold") as c:
            assert_shares(lambda b: c.evaluate(
                name, xs, b=b, timeout=WAIT_S), bundles[name], xs)
            with pytest.raises(ValueError, match="no bundle"):
                c.evaluate("no-such-key", xs, timeout=WAIT_S)
            assert c.evaluate(name, xs, timeout=WAIT_S).shape == \
                (1, 9, 16)
        with cedge.EdgeClient(*pod.router.address, n_bytes=NB,
                              tenant="intruder") as c:
            with pytest.raises(ValueError, match="unknown tenant"):
                c.evaluate(name, xs, timeout=WAIT_S)
    finally:
        pod.close()


def test_critical_failover_replica_serves_rest_refused_typed(bundles,
                                                            rng):
    """A key's owner dies: CRITICAL traffic fails over to the replica
    (both parties equal to the oracle), NORMAL is refused
    ``CircuitOpenError`` with a positive ``retry_after_s``, keys the
    dead shard does not hold serve undisturbed."""
    pod = Pod(PORT, PORT, n=3, bundles=bundles)
    try:
        name = "pod-key-0"
        owner = pod.map.owner(name).host_id
        pod.kill(owner)
        xs = points(rng, 4)
        assert_shares(lambda b: pod.router.evaluate(
            name, xs, b=b, timeout=WAIT_S, priority="critical"),
            bundles[name], xs)
        assert pod.router.suspect_remaining(owner) > 0
        with pytest.raises(CircuitOpenError) as ei:
            pod.router.evaluate(name, xs, b=0, timeout=WAIT_S)
        assert ei.value.retry_after_s > 0
        other = next(k for k in sorted(bundles)
                     if owner not in pod.map.placement_ids(k, 1))
        assert_shares(lambda b: pod.router.evaluate(
            other, xs, b=b, timeout=WAIT_S), bundles[other], xs)
        snap = pod.router.metrics_snapshot()
        assert snap["router_failovers_total"] >= 1
        assert snap["router_suspect_refusals_total"] >= 1
    finally:
        pod.close()


def test_failover_loop_every_request_accounted(bundles, rng):
    """Three threads of mixed CRITICAL / NORMAL requests through the
    router while one shard dies: every request is served equal to the
    oracle or refused typed with a hint — served + refused = sent."""
    pod = Pod(PORT, PORT, n=3, bundles=bundles)
    names = sorted(bundles)
    stats = {"sent": 0, "ok": 0, "refused": 0, "other": 0}
    lock = threading.Lock()
    stop = threading.Event()

    def client(i):
        crng = np.random.default_rng(100 + i)
        while not stop.is_set():
            name = names[int(crng.integers(0, len(names)))]
            pr = "critical" if crng.random() < 0.5 else "normal"
            xs = points(crng, int(crng.integers(1, 17)))
            b = int(crng.integers(0, 2))
            with lock:
                stats["sent"] += 1
            try:
                y = pod.router.evaluate(name, xs, b=b, timeout=WAIT_S,
                                        priority=pr)
            except DcfError as e:
                key = "refused" if e.retry_after_s is not None \
                    else "other"
                with lock:
                    stats[key] += 1
                continue
            ok = np.array_equal(y, oracle(bundles[name], b, xs))
            with lock:
                stats["ok" if ok else "other"] += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
        pod.kill(pod.map.owner(names[0]).host_id)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        assert stats["other"] == 0, stats
        assert stats["ok"] > 0 and stats["refused"] > 0, stats
        assert stats["ok"] + stats["refused"] == stats["sent"], stats
    finally:
        stop.set()
        pod.close()


def test_hot_swap_stale_state_crosses_the_router(bundles, rng):
    """A re-registration racing a forwarded eval fails
    ``StaleStateError`` across both hops (``E_STALE`` keeps the class);
    the next request serves the new key."""
    pod = Pod(PORT, PORT, n=2, bundles=bundles)
    try:
        name = "pod-key-1"
        owner_svc = pod.svc_of(pod.map.owner(name).host_id)
        new_kb = make_bundle(rng)
        swapped = {"n": 0}

        def swap_once(key_id, _points):
            if key_id == name and swapped["n"] == 0:
                swapped["n"] = 1
                owner_svc.register_key(name, new_kb)

        xs = points(rng, 5)
        with faults.inject("serve.stage", handler=swap_once):
            fut = pod.router.submit(name, xs, b=0)
            with pytest.raises(StaleStateError) as ei:
                fut.result(WAIT_S)
        assert ei.value.wire_code == pedge.E_STALE
        assert swapped["n"] == 1
        assert_shares(lambda b: pod.router.evaluate(
            name, xs, b=b, timeout=WAIT_S), new_kb, xs)
    finally:
        pod.close()


def test_byte_flips_at_the_pod_door_die_typed(bundles, rng):
    pod = Pod(PORT, PORT, n=2, bundles=bundles)
    pod.router.start()
    xs = points(rng, 5)
    frame = pedge.encode_request(7, "", "pod-key-0", 0, 255, None,
                                 xs.data, NB, 5)
    try:
        with EdgeClient(*pod.router.address, n_bytes=NB) as healthy:
            for off, xor in zip(rng.integers(0, len(frame), 12),
                                rng.integers(1, 256, 12)):
                frames = raw_exchange(
                    pod.router.address,
                    faults.corrupt(frame, int(off), int(xor)),
                    pedge.decode_response)
                assert all(f[0] == "error" for f in frames)
                assert np.array_equal(
                    healthy.evaluate("pod-key-0", xs, timeout=WAIT_S),
                    oracle(bundles["pod-key-0"], 0, xs))
    finally:
        pod.close()


def test_edge_client_pool_reconnects_and_backs_off(bundles, rng,
                                                   monkeypatch):
    """A dead pooled connection is replaced on the next lease; a dark
    target fails typed without dialing until the backoff elapses on
    the injectable clock."""
    svc = service(PORT, bundles)
    srv = pedge.EdgeServer(svc).start()
    host, port = srv.address
    clk = FakeClock(50.0)
    dialed = {"n": 0}
    real_connect = socket.create_connection

    def counting_connect(*a, **kw):
        dialed["n"] += 1
        return real_connect(*a, **kw)

    monkeypatch.setattr(pedge.socket, "create_connection",
                        counting_connect)
    pool = EdgeClientPool(host, port, n_bytes=NB, size=1, clock=clk,
                          reconnect_backoff_s=1.0, max_backoff_s=4.0)
    xs = points(rng, 3)
    name = "pod-key-2"
    try:
        assert np.array_equal(pool.evaluate(name, xs, timeout=WAIT_S),
                              oracle(bundles[name], 0, xs))
        assert (pool.dials, pool.reconnects) == (1, 0)
        pool._slots[0].close()
        assert np.array_equal(pool.evaluate(name, xs, timeout=WAIT_S),
                              oracle(bundles[name], 0, xs))
        assert (pool.dials, pool.reconnects) == (2, 1)
        srv.close()
        wait_for(lambda: pool._slots[0].closed, "the pooled EOF")
        before = dialed["n"]
        with pytest.raises(BackendUnavailableError, match="connect"):
            pool.submit(name, xs)
        with pytest.raises(BackendUnavailableError, match="dark"):
            pool.submit(name, xs)
        assert dialed["n"] == before + 1
        clk.advance(1.5)
        with pytest.raises(BackendUnavailableError, match="connect"):
            pool.submit(name, xs)
        assert dialed["n"] == before + 2
    finally:
        pool.close()
        srv.close()
        svc.close()
    with pytest.raises(ValueError):
        EdgeClientPool("127.0.0.1", 1, n_bytes=NB,
                       reconnect_backoff_s=0.0)


def test_open_loop_through_router_reconciles_against_pod_rollup(
        bundles, rng):
    """An open loop against the router reconciles sent / expired /
    per-class sheds against the SUM of the shards' snapshots."""
    pod = Pod(PORT, PORT, n=2, bundles=bundles)
    try:
        before = rollup_snapshots([s.metrics_snapshot() for s in pod.svcs])
        res = open_loop(pod.router, sorted(bundles), rate_rps=80.0,
                        duration_s=0.5, min_points=1, max_points=8,
                        seed=5)
        after = rollup_snapshots([s.metrics_snapshot() for s in pod.svcs])
        rec = reconcile_against_rollup(res, before, after)
        assert rec["reconciled"], rec
        assert res.sent > 0 and res.failed == 0
    finally:
        pod.close()


# ------------------------------------------------------- the epoch fence


def test_ring_epoch_fence_across_the_router(bundles, rng):
    """``set_ring(epoch=)`` is strictly monotonic; forwards carry the
    epoch and shards adopt it; a second router still on an older epoch
    is refused ``RingEpochError`` (``E_EPOCH``), counted on the router
    and on the shard — in process, ``check_ring_epoch`` refuses the
    same."""
    pod = Pod(PORT, PORT, n=2, bundles=bundles)
    stale = DcfRouter(pod.map, n_bytes=NB)
    try:
        name = "pod-key-3"
        owner_svc = pod.svc_of(pod.map.owner(name).host_id)
        pod.router.set_ring(pod.map, epoch=2)
        with pytest.raises(ValueError, match="monotonic"):
            pod.router.set_ring(pod.map, epoch=2)
        stale.set_ring(pod.map, epoch=1)
        xs = points(rng, 4)
        assert np.array_equal(
            pod.router.evaluate(name, xs, b=1, timeout=WAIT_S),
            oracle(bundles[name], 1, xs))
        assert owner_svc.ring_epoch == 2
        with pytest.raises(RingEpochError) as ei:
            stale.evaluate(name, xs, timeout=WAIT_S)
        assert ei.value.wire_code == pedge.E_EPOCH
        with pytest.raises(RingEpochError):
            owner_svc.check_ring_epoch(1)
        assert stale.metrics_snapshot()["router_stale_epoch_total"] == 1
        assert stale.metrics_snapshot()["router_ring_epoch"] == 1
        assert owner_svc.metrics_snapshot()[
            "serve_epoch_fenced_total"] == 2
    finally:
        stale.close()
        pod.close()


# ------------------------------------------------- the pinned snapshot


def _scripted_router_snapshot(pkg, bundles) -> dict:
    """One deterministic router sequence on a ``FakeClock``: routed
    evaluations, a live registration, a shard's death, a CRITICAL
    failover, a suspect refusal, three probe rounds walking the dead
    shard DOWN, and a promoted forward."""
    rng = np.random.default_rng(77)
    clk = pkg.faults.FakeClock(10.0)
    pod = Pod(pkg, pkg, n=3, bundles=bundles, router_kw=dict(
        clock=clk, probe_fail_n=2))
    try:
        for name in ("pod-key-0", "pod-key-1"):
            xs = points(rng, 6)
            for b in (0, 1):
                assert np.array_equal(pod.router.evaluate(
                    name, xs, b=b, timeout=WAIT_S),
                    oracle(bundles[name], b, xs))
        pod.router.register_key("live", pkg.bundle(bundles["pod-add"]))
        victim = pod.map.owner("pod-key-0").host_id
        pod.kill(victim)
        xs = points(rng, 3)
        pod.router.evaluate("pod-key-0", xs, timeout=WAIT_S,
                            priority="critical")
        with pytest.raises(Exception) as ei:
            pod.router.evaluate("pod-key-0", xs, timeout=WAIT_S)
        assert type(ei.value).__name__ == "CircuitOpenError"
        for _ in range(3):
            pod.router.health.pump()
        assert pod.router.health.state(victim) == "down"
        pod.router.evaluate("pod-key-0", xs, timeout=WAIT_S)
        return pod.router.metrics_snapshot()
    finally:
        pod.close()


def test_router_metrics_snapshot_equal_to_dcf_tpu_key_for_key(bundles):
    snap_p = _scripted_router_snapshot(PORT, bundles)
    snap_j = _scripted_router_snapshot(REF, bundles)
    assert sorted(snap_p) == sorted(snap_j)
    assert {k: (snap_p[k], snap_j[k]) for k in snap_p
            if snap_p[k] != snap_j[k]} == {}
    assert snap_p["router_promoted_forwards_total"] == 1
    assert snap_p["router_failovers_total"] >= 1
