"""The port's co-evaluation tier (``dcf_tpu_torch.serve.meshgroup`` and
the router's ``set_mesh`` / ``register_mesh_key``) against
``dcf_tpu``'s.

``MeshGroup.plan`` equals ``dcf_tpu``'s over ragged batch sizes and
worker counts.  A batch scattered across three port shards (``walk``,
B1's plain version, ``device="cpu"``) and gathered back gives the
oracle's shares and route-mode's, both parties, XOR and add16, x =
alpha included, also behind a ``dcf_tpu`` router and over ``dcf_tpu``
shards; the dispatch policy, the forced mesh's typed refusal, the
``mesh.collective`` seam's counted and warned degrade, the epoch fence
and a dead worker degrade to route-mode with no key lost.  Tolerance:
exact byte equality.  Every socket binds port 0 and every wait is
bounded."""

import threading

import numpy as np
import pytest

import dcf_tpu.serve as jserve

from dcf_tpu_torch.errors import BackendFallbackWarning, MeshUnavailableError
from dcf_tpu_torch.serve import DcfRouter, MeshGroup, MeshSlice, ShardMap
from dcf_tpu_torch.serve import ShardSpec
from dcf_tpu_torch.serve.meshgroup import SLICE_ALIGN
from dcf_tpu_torch.testing import faults
from tests.torch_net import (
    NB,
    PKGS,
    WAIT_S,
    Pod,
    assert_shares,
    make_bundle,
    oracle,
    points,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0x3E5)


@pytest.fixture(scope="module")
def bundles(rng):
    return {"mesh-xor": make_bundle(rng), "mesh-add": make_bundle(rng,
                                                                  "add16"),
            "mesh-b": make_bundle(rng)}


# -------------------------------------------------------------- the plan


@pytest.mark.parametrize("workers", [1, 2, 3, 5, 8])
def test_plan_equal_to_dcf_tpu_over_ragged_sizes(workers):
    """Slices (worker, offset, count) equal ``dcf_tpu``'s, contiguous,
    32-aligned but for the batch end, sorted by worker, balanced to a
    lane word, workers with no word elided."""
    ids = [f"w{(7 * i) % 11}" for i in range(workers)]
    pg, jg = MeshGroup(ids, epoch=4), jserve.MeshGroup(ids, epoch=4)
    assert pg.host_ids() == jg.host_ids() and pg.epoch == jg.epoch == 4
    r = np.random.default_rng(workers)
    sizes = [1, 17, 31, 32, 33, 96, 97, 1000, 4096, 4097] + \
        [int(m) for m in r.integers(1, 1 << 14, 40)]
    for m in sizes:
        plan = pg.plan(m)
        assert [(s.host_id, s.offset, s.count) for s in plan] == \
            [(s.host_id, s.offset, s.count) for s in jg.plan(m)], m
        offset = 0
        for sl in plan:
            assert sl.offset == offset and sl.count > 0
            if sl is not plan[-1]:
                assert (sl.offset + sl.count) % SLICE_ALIGN == 0
            offset += sl.count
        assert offset == m
    assert MeshGroup([f"w{i}" for i in range(8)]).plan(17) == \
        [MeshSlice("w0", 0, 17)]


def test_meshgroup_and_router_contracts():
    with pytest.raises(ValueError):
        MeshGroup([])
    with pytest.raises(ValueError):
        MeshGroup(["a", "a"])
    with pytest.raises(ValueError):
        MeshGroup(["a"]).plan(0)
    g = MeshGroup(["a", "b"])
    assert len(g) == 2 and "a" in g and "c" not in g
    ring = ShardMap([ShardSpec("a", port=1)])
    with pytest.raises(ValueError):
        DcfRouter(ring, n_bytes=NB, co_eval="sometimes")
    with pytest.raises(ValueError):
        DcfRouter(ring, n_bytes=NB, co_eval_min_points=0)
    with pytest.raises(ValueError):
        DcfRouter(ring, n_bytes=NB, replicas=-1)
    router = DcfRouter(ring, n_bytes=NB)
    try:
        with pytest.raises(ValueError):
            router.set_mesh(["not-a-member"])
    finally:
        router.close()


# ------------------------------------------------- co-evaluated shares


def _mesh_pod(bundles, shards="port", router="port", n=3, **router_kw):
    kw = dict(co_eval="auto", co_eval_min_points=64)
    kw.update(router_kw)
    pod = Pod(PKGS[shards], PKGS[router], n=n, router_kw=kw)
    pod.router.set_mesh()
    for name, kb in sorted(bundles.items()):
        pod.router.register_mesh_key(name, PKGS[router].bundle(kb))
    return pod


@pytest.mark.parametrize("shards,router", [
    ("port", "port"), ("port", "dcf_tpu"), ("dcf_tpu", "port")])
def test_co_evaluated_shares_equal_oracle_and_route_mode(
        shards, router, bundles, rng):
    """One batch per party scattered over 3 workers: each party's
    gathered share equals the oracle and the same router's route-mode
    answer; every worker forwarded, nothing degraded, and the key is
    resident on every worker under one generation."""
    pod = _mesh_pod(bundles, shards, router)
    try:
        for name in ("mesh-xor", "mesh-add"):
            kb = bundles[name]
            xs = points(rng, 96)
            got = [pod.router.evaluate(name, xs, b=b, timeout=WAIT_S)
                   for b in (0, 1)]
            assert_shares(lambda b: got[b], kb, xs)
            pod.router.co_eval = "never"
            for b in (0, 1):
                assert np.array_equal(got[b], pod.router.evaluate(
                    name, xs, b=b, timeout=WAIT_S))
            pod.router.co_eval = "auto"
        snap = pod.router.metrics_snapshot()
        assert snap["router_co_evals_total"] == 4
        assert snap["router_mesh_degraded_total"] == 0
        assert snap["router_mesh_workers"] == 3
        assert snap["router_mesh_registered_total"] == len(bundles)
        for h in pod.map.host_ids():
            assert snap[f"router_forwards_total{{shard={h}}}"] > 0
        gens = {pod.svc_of(h).replication_digest()["mesh-b"]
                for h in pod.map.host_ids()}
        assert len(gens) == 1
    finally:
        pod.close()


def test_ragged_sizes_policy_and_forced_refusal(bundles, rng):
    """Sizes straddling every alignment edge; below the threshold a
    batch is routed, ``never`` disables the mesh, and ``always`` with no
    group refuses ``MeshUnavailableError`` with the probe interval as
    its hint (mesh registration without a group refuses the same)."""
    pod = _mesh_pod(bundles, co_eval_min_points=1)
    try:
        kb = bundles["mesh-b"]
        for m in (1, 31, 33, 64, 97):
            xs = points(rng, m)
            assert_shares(lambda b: pod.router.evaluate(
                "mesh-b", xs, b=b, timeout=WAIT_S), kb, xs)
        assert pod.router.metrics_snapshot()["router_co_evals_total"] == 10
        pod.router.co_eval_min_points = 64
        pod.router.evaluate("mesh-b", points(rng, 8), timeout=WAIT_S)
        assert pod.router.metrics_snapshot()["router_co_evals_total"] == 10
        pod.router.co_eval = "never"
        pod.router.evaluate("mesh-b", points(rng, 96), timeout=WAIT_S)
        assert pod.router.metrics_snapshot()["router_co_evals_total"] == 10
        pod.router.mesh_group = None
        pod.router.co_eval = "always"
        with pytest.raises(MeshUnavailableError) as ei:
            pod.router.evaluate("mesh-b", points(rng, 8), timeout=WAIT_S)
        assert ei.value.retry_after_s == pod.router.health.interval_s
        with pytest.raises(MeshUnavailableError):
            pod.router.register_mesh_key("x", kb)
    finally:
        pod.close()


def test_collective_fault_degrades_counted_and_warned(bundles, rng):
    """An armed ``mesh.collective`` seam: the batch is answered from
    route-mode, equal to the oracle, counted and warned
    ``BackendFallbackWarning``; under ``always`` it is refused typed."""
    pod = _mesh_pod(bundles)
    try:
        kb = bundles["mesh-xor"]
        xs = points(rng, 96)
        with faults.inject("mesh.collective"):
            with pytest.warns(BackendFallbackWarning):
                got = [pod.router.evaluate("mesh-xor", xs, b=b,
                                           timeout=WAIT_S) for b in (0, 1)]
            assert_shares(lambda b: got[b], kb, xs)
            snap = pod.router.metrics_snapshot()
            assert snap["router_mesh_degraded_total"] == 2
            assert snap["router_co_evals_total"] == 0
            pod.router.co_eval = "always"
            with pytest.raises(MeshUnavailableError):
                pod.router.evaluate("mesh-xor", xs, timeout=WAIT_S)
    finally:
        pod.close()


def test_epoch_fence_degrades_until_reformed(bundles, rng):
    pod = _mesh_pod(bundles)
    try:
        kb = bundles["mesh-xor"]
        xs = points(rng, 96)
        pod.router.set_ring(pod.map, epoch=pod.router.ring_epoch + 1)
        with pytest.warns(BackendFallbackWarning):
            y0 = pod.router.evaluate("mesh-xor", xs, b=0, timeout=WAIT_S)
        assert np.array_equal(y0, oracle(kb, 0, xs))
        assert pod.router.metrics_snapshot()[
            "router_mesh_degraded_total"] == 1
        assert pod.router.set_mesh().epoch == pod.router.ring_epoch
        assert np.array_equal(pod.router.evaluate(
            "mesh-xor", xs, b=1, timeout=WAIT_S), oracle(kb, 1, xs))
        assert pod.router.metrics_snapshot()["router_co_evals_total"] == 1
    finally:
        pod.close()


def test_dead_worker_degrades_with_no_key_lost(bundles, rng):
    """A worker that is neither owner nor replica of the key dies
    before the scatter: the batch degrades (worker suspect, counted,
    warned) and still equals the oracle; every key it does not hold
    keeps answering."""
    pod = _mesh_pod(bundles)
    try:
        kb = bundles["mesh-xor"]
        placed = pod.map.placement_ids("mesh-xor", 1)
        victim = next(h for h in pod.map.host_ids() if h not in placed)
        pod.kill(victim)
        xs = points(rng, 96)
        with pytest.warns(BackendFallbackWarning):
            got = [pod.router.evaluate("mesh-xor", xs, b=b,
                                       timeout=WAIT_S) for b in (0, 1)]
        assert_shares(lambda b: got[b], kb, xs)
        snap = pod.router.metrics_snapshot()
        assert snap["router_mesh_degraded_total"] == 2
        assert snap[f"router_suspected_total{{shard={victim}}}"] >= 1
        for name, kkb in sorted(bundles.items()):
            if victim not in pod.map.placement_ids(name, 1):
                xs2 = points(rng, 4)
                assert_shares(lambda b: pod.router.evaluate(
                    name, xs2, b=b, timeout=WAIT_S), kkb, xs2)
    finally:
        pod.close()


def test_mesh_future_waitable_from_another_thread(bundles, rng):
    pod = _mesh_pod(bundles)
    try:
        kb = bundles["mesh-xor"]
        xs = points(rng, 96)
        fut = pod.router.submit("mesh-xor", xs, b=0)
        out = {}
        t = threading.Thread(target=lambda: out.update(
            y=fut.result(WAIT_S)))
        t.start()
        t.join(WAIT_S)
        assert not t.is_alive() and fut.done()
        assert np.array_equal(out["y"], oracle(kb, 0, xs))
    finally:
        pod.close()


def test_port_router_scatters_over_dcf_tpu_router_group_plan(bundles):
    """The port router and ``dcf_tpu``'s form the same group over the
    same ring and scatter a batch into the same slices."""
    pod = _mesh_pod(bundles)
    try:
        jring = jserve.ShardMap([jserve.ShardSpec(s.host_id, s.host,
                                                  s.port)
                                 for s in pod.map.hosts()])
        jrouter = jserve.DcfRouter(jring, n_bytes=NB)
        try:
            jg = jrouter.set_mesh()
            pg = pod.router.mesh_group
            for m in (64, 96, 1000):
                assert [(s.host_id, s.offset, s.count)
                        for s in pg.plan(m)] == \
                    [(s.host_id, s.offset, s.count) for s in jg.plan(m)]
        finally:
            jrouter.close()
    finally:
        pod.close()
