"""The port's ``DcfService`` against ``dcf_tpu``'s, byte for byte.

The same bundles (DCFK frames made by the port, read by ``dcf_tpu``) and
the same ragged requests go through the port's service, on its ``walk``,
``prefix``, ``keylanes``, ``numpy`` and ``cpu`` facades (the kernels'
plain versions here, ``device="cpu"``), and through ``dcf_tpu``'s service
over its ``numpy`` facade; every party's shares must be byte-equal, both
bounds, XOR and add16, pad points dropped, requests split across batches,
and MIC protocol bundles (the pair combine on the device for the port's
staged backends).  Then each mechanism on the port alone: generations
and ``StaleStateError``, LRU eviction under ``device_bytes_budget``, the
frontier cache on ``prefix`` and on the lam = 48 hybrid with
``prefix_levels``, retries that re-stage on the same backend (the port
never demotes), breakers, deadlines and the watchdog on a ``FakeClock``,
the worker thread, ``reset_backend_health``, replication frames between
the packages, ``attach_pir``; and the metrics snapshot of one scripted
``pump()`` sequence on both packages' ``numpy`` facades.  Tolerance:
exact byte equality; counters and gauges equal."""

import numpy as np
import pytest

import dcf_tpu.api as japi
from dcf_tpu import Dcf as JDcf
from dcf_tpu.keys import KeyBundle as JKeyBundle
from dcf_tpu.protocols import ProtocolBundle as JProtocolBundle
from dcf_tpu.serve import DcfService as JDcfService
from dcf_tpu.serve import ServeConfig as JServeConfig
from dcf_tpu.testing import faults as jfaults

import dcf_tpu_torch.api as api
from dcf_tpu_torch import Bound, Dcf
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
from dcf_tpu_torch.errors import (
    BatchTimeoutError,
    CircuitOpenError,
    DeadlineExceededError,
    QueueFullError,
    ShapeError,
    StaleStateError,
)
from dcf_tpu_torch.protocols import mic_oracle
from dcf_tpu_torch.serve import DcfService, ServeConfig
from dcf_tpu_torch.serve.registry import device_image_bytes
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.testing.faults import FakeClock
from dcf_tpu_torch.utils.groups import np_group_add
from dcf_tpu_torch.workloads.pir import PirDatabase, pir_reconstruct
from tests.torch_threads import one_torch_thread  # noqa: F401

NB, LAM = 2, 16
#: 18 cipher keys: lam >= 32 uses ciphers 0 and 17.
CK = [bytes((7 * i + j) % 256 for j in range(32)) for i in range(18)]
#: Ragged request sizes: one past a batch (max_batch 32), one point, and
#: sizes whose totals pad to a power of two (pad points dropped).
SIZES = (37, 1, 9, 20)
MIC = [(10, 200), (300, 1000), (60000, 2000), (65000, 1 << 16)]


def port_dcf(backend: str, lam: int = LAM, nb: int = NB, **opts) -> Dcf:
    return Dcf(nb, lam, CK, backend=backend, device="cpu",
               backend_opts=opts or None)


def make_bundles(group: str, rng) -> dict:
    """Two single-key bundles, one per bound, and a 2-key one; host keygen
    on the port's numpy walk."""
    fac = port_dcf("numpy")
    out = {}
    for name, k, bnd in (("lt", 1, Bound.LT_BETA), ("gt", 1, Bound.GT_BETA),
                         ("multi", 2, Bound.LT_BETA)):
        alphas = rng.integers(0, 256, (k, NB), dtype=np.uint8)
        alphas[0] = [0x80, 0x00]
        out[name] = fac.gen(alphas, rng.integers(0, 256, (k, LAM),
                                                 dtype=np.uint8),
                            bound=bnd, rng=rng, group=group, device=False)
    return out


def jax_twin(bundle):
    """The same key material as a ``dcf_tpu`` object, through its frame."""
    if hasattr(bundle, "combine_masks"):
        return JProtocolBundle.from_bytes(bundle.to_bytes())
    return JKeyBundle.from_bytes(bundle.to_bytes())


def requests(rng, names) -> list:
    reqs = []
    for i, m in enumerate(SIZES):
        xs = rng.integers(0, 256, (m, NB), dtype=np.uint8)
        xs[0] = [0x80, 0x00]  # x = alpha of the first key
        reqs.append((names[i % len(names)], i % 2, xs))
    return reqs


def serve_all(svc, reqs) -> list:
    futs = [svc.submit(name, xs, b=b) for name, b, xs in reqs]
    svc.pump()
    return [f.result(0) for f in futs]


def jax_service(bundles, **knobs):
    jsvc = JDcfService(JDcf(NB, LAM, CK, backend="numpy"),
                       JServeConfig(**knobs), clock=jfaults.FakeClock())
    for name, kb in bundles.items():
        jsvc.register_key(name, jax_twin(kb))
    return jsvc


def port_service(dcf, bundles, clock=None, **knobs):
    svc = DcfService(dcf, ServeConfig(**knobs),
                     clock=clock if clock is not None else FakeClock())
    for name, kb in bundles.items():
        svc.register_key(name, kb)
    return svc


@pytest.mark.parametrize("backend,group", [
    ("walk", "xor"), ("walk", "add16"), ("prefix", "xor"),
    ("prefix", "add16"), ("keylanes", "xor"), ("numpy", "add16"),
    ("cpu", "xor")])
def test_shares_equal_dcf_tpu_service(backend, group):
    rng = np.random.default_rng(
        [ord(c) for c in backend + group])  # a seed per case
    bundles = make_bundles(group, rng)
    reqs = requests(rng, list(bundles))
    svc = port_service(port_dcf(backend), bundles, max_batch=32)
    got = serve_all(svc, reqs)
    want = serve_all(jax_service(bundles, max_batch=32), reqs)
    for (name, b, xs), y, w in zip(reqs, got, want):
        assert y.shape == (bundles[name].num_keys, xs.shape[0], LAM)
        assert np.array_equal(y, w), (name, b)
    snap = svc.metrics_snapshot()
    assert snap["serve_points_total"] == sum(SIZES)
    assert snap["serve_batches_total"] >= len(SIZES)


@pytest.mark.parametrize("backend,group", [
    ("walk", "xor"), ("prefix", "add16"), ("numpy", "xor")])
def test_mic_protocol_bundle_equals_dcf_tpu(backend, group):
    """A MIC ``ProtocolBundle``: the port combines the pairs on the device
    for staged backends, ``dcf_tpu``'s numpy facade on the host bytes."""
    rng = np.random.default_rng(7)
    fac = port_dcf("numpy")
    betas = rng.integers(0, 256, (len(MIC), LAM), dtype=np.uint8)
    pb = fac.mic(MIC, betas, rng=rng, group=group)
    xs = rng.integers(0, 256, (41, NB), dtype=np.uint8)
    xs[:4] = [[0, 10], [0, 9], [0xFD, 0xE8], [0xFF, 0xFF]]
    svc = port_service(port_dcf(backend), {"mic": pb}, max_batch=32)
    jsvc = jax_service({"mic": pb}, max_batch=32)
    reqs = [("mic", b, xs) for b in (0, 1)]
    y0, y1 = serve_all(svc, reqs)
    j0, j1 = serve_all(jsvc, reqs)
    assert np.array_equal(y0, j0) and np.array_equal(y1, j1)
    assert y0.shape == (len(MIC), 41, LAM)
    assert np.array_equal(np_group_add(y0, y1, group),
                          mic_oracle(xs, MIC, betas))


def test_generations_and_stale_state():
    rng = np.random.default_rng(3)
    bundles = make_bundles("xor", rng)
    svc = port_service(port_dcf("walk"), {"k": bundles["lt"]})
    _, _, g1 = svc.registry.snapshot("k")
    assert svc.register_key("k", bundles["lt"]) is bundles["lt"]
    assert svc.registry.snapshot("k")[2] == g1  # idempotent
    svc.register_key("k", bundles["gt"])
    _, _, g2 = svc.registry.snapshot("k")
    assert g2 == g1 + 1
    with pytest.raises(StaleStateError):
        svc.registry.resident("k", 0, g1)
    be = svc.registry.resident("k", 0, g2)
    assert be is svc.registry.resident("k", 0)  # the cached residency
    xs = rng.integers(0, 256, (5, NB), dtype=np.uint8)
    (y,) = serve_all(svc, [("k", 0, xs)])
    assert np.array_equal(y, eval_batch_np(
        port_dcf("numpy")._prg, 0, bundles["gt"].for_party(0), xs))
    with pytest.raises(ShapeError):
        svc.register_key("bad", bundles["gt"].for_party(0))
    with pytest.raises(ValueError, match="no bundle registered"):
        svc.submit("nope", xs)


def test_lru_eviction_under_device_budget():
    rng = np.random.default_rng(4)
    bundles = make_bundles("xor", rng)
    probe = port_service(port_dcf("walk"), bundles)
    one = device_image_bytes(probe.registry.resident("lt", 0))
    assert one > 0
    svc = port_service(port_dcf("walk"), bundles,
                       device_bytes_budget=int(2.5 * one))
    xs = rng.integers(0, 256, (3, NB), dtype=np.uint8)
    for name in ("lt", "gt", "lt", "gt", "multi", "lt"):
        (y,) = serve_all(svc, [(name, 0, xs)])
        assert np.array_equal(y, eval_batch_np(
            port_dcf("numpy")._prg, 0, bundles[name].for_party(0), xs))
    snap = svc.metrics_snapshot()
    assert snap["serve_evictions_total"] >= 1
    assert snap["serve_resident_device_bytes"] <= int(2.5 * one)
    assert snap["serve_key_stagings_total"] >= 4


def test_device_image_bytes_counts_every_tensor():
    """Walk, prefix, keylanes and the hybrid: the count is the sum of the
    tensors the instance holds (the AES image, the key image, the hybrid's
    wide tail once built, instance-store frontiers)."""
    rng = np.random.default_rng(5)
    kb = make_bundles("xor", rng)["lt"]
    for backend in ("walk", "prefix", "keylanes"):
        be = port_dcf(backend).new_eval_backend()
        be.put_bundle(kb if backend == "keylanes" else kb.for_party(0))
        want = be.aes.nbytes + sum(t.nbytes
                                   for t in be._bundle_dev.values())
        assert device_image_bytes(be) == want, backend
        if backend == "prefix":
            be.ensure_frontier(0)
            assert device_image_bytes(be) == want + be._frontier[0].nbytes
    fac = port_dcf("hybrid", lam=48, prefix_levels=5)
    kb48 = fac.gen(rng.integers(0, 256, (1, NB), dtype=np.uint8),
                   rng.integers(0, 256, (1, 48), dtype=np.uint8), rng=rng)
    be = fac.new_eval_backend()
    be.put_bundle(kb48.for_party(1))
    base = device_image_bytes(be)
    assert base == be.aes.nbytes + sum(t.nbytes for t in be._dev.values())
    be.eval(1, rng.integers(0, 256, (4, NB), dtype=np.uint8))
    grown = sum(t.nbytes for t in be._wide) + sum(
        t.nbytes for t in be._frontier[1])
    assert device_image_bytes(be) == base + grown


@pytest.mark.parametrize("backend,lam,opts", [
    ("prefix", 16, {"prefix_levels": 8}),
    ("hybrid", 48, {"prefix_levels": 5})])
def test_frontier_cache_hits_and_survives_budget_eviction(backend, lam,
                                                          opts):
    rng = np.random.default_rng(6)
    fac = port_dcf(backend, lam=lam, **opts)
    keys = {f"k{i}": fac.gen(rng.integers(0, 256, (1, NB), dtype=np.uint8),
                             rng.integers(0, 256, (1, lam), dtype=np.uint8),
                             rng=rng, device=False)
            for i in range(2)}
    svc = port_service(fac, keys)
    xs = rng.integers(0, 256, (6, NB), dtype=np.uint8)
    prg = fac._prg
    for name in ("k0", "k0", "k1"):
        (y,) = serve_all(svc, [(name, 1, xs)])
        assert np.array_equal(y, eval_batch_np(
            prg, 1, keys[name].for_party(1), xs))
    snap = svc.metrics_snapshot()
    # One miss per staged (key, party) warm; every eval consult hits.
    assert snap["serve_frontier_misses_total"] == 2
    assert snap["serve_frontier_hits_total"] == 3
    assert snap["serve_frontier_cache_entries"] == 2
    be = svc.registry.resident("k0", 1)
    assert be._frontier == {}  # held by the cache, not the instance
    # A budget eviction of the residency keeps the cached frontier: the
    # re-staged instance hits it.
    with svc.registry._lock:
        entry = svc.registry._entries["k0"]
        entry.residents.clear()
    (y,) = serve_all(svc, [("k0", 1, xs)])
    snap = svc.metrics_snapshot()
    assert snap["serve_frontier_misses_total"] == 2
    assert snap["serve_frontier_hits_total"] == 5
    # A failure eviction drops the key's cached frontier.
    svc.registry.evict_key("k0")
    assert svc.metrics_snapshot()["serve_frontier_cache_entries"] == 1
    cold = port_service(fac, keys, frontier_cache=False)
    serve_all(cold, [("k0", 1, xs)])
    assert cold.metrics_snapshot().get("serve_frontier_hits_total", 0) == 0
    assert cold.registry.resident("k0", 1)._frontier


def test_injected_eval_fault_retries_on_the_same_backend():
    rng = np.random.default_rng(8)
    bundles = make_bundles("xor", rng)
    dcf = port_dcf("prefix", prefix_levels=8)
    svc = port_service(dcf, bundles, retries=1)
    xs = rng.integers(0, 256, (7, NB), dtype=np.uint8)
    serve_all(svc, [("lt", 0, xs)])
    first = svc.registry.resident("lt", 0)
    calls = {"n": 0}

    def fail_once(*_args):
        calls["n"] += 1
        if calls["n"] == 1:
            raise faults.InjectedFault("device lost")

    with faults.inject("serve.eval", handler=fail_once):
        (y,) = serve_all(svc, [("lt", 0, xs)])
    assert np.array_equal(y, eval_batch_np(
        dcf._prg, 0, bundles["lt"].for_party(0), xs))
    again = svc.registry.resident("lt", 0)
    assert again is not first  # re-staged on a fresh instance ...
    assert type(again) is type(first) and dcf.backend_name == "prefix"
    snap = svc.metrics_snapshot()
    assert snap["serve_retries_total"] == 1
    assert snap["serve_batch_failures_total"] == 0
    # A persistent device fault fails the future typed; nothing demotes.
    # The last retry drops this service's residencies and the facade's
    # backend slots only: another service and facade keep theirs.
    other_dcf = port_dcf("prefix", prefix_levels=8)
    other = port_service(other_dcf, bundles)
    serve_all(other, [("gt", 1, xs)])
    other_dcf.eval(0, bundles["gt"], xs)
    kept = other.registry.resident("gt", 1)
    with faults.inject("serve.eval", exc=OSError("device gone")):
        fut = svc.submit("lt", xs)
        svc.pump()
    with pytest.raises(OSError, match="device gone"):
        fut.result(0)
    assert dcf.backend_name == "prefix"
    assert svc.metrics_snapshot()["serve_batch_failures_total"] == 1
    assert other.registry.resident("gt", 1) is kept
    assert other_dcf._eval_backends


def test_breaker_opens_and_critical_bypasses():
    rng = np.random.default_rng(9)
    bundles = make_bundles("xor", rng)
    clock = FakeClock()
    svc = port_service(port_dcf("walk"), bundles, clock=clock, retries=1,
                       breaker_failures=2, breaker_cooldown_s=5.0)
    xs = rng.integers(0, 256, (4, NB), dtype=np.uint8)
    with faults.inject("serve.eval"):
        fut = svc.submit("lt", xs)
        svc.pump()
        with pytest.raises(faults.InjectedFault):
            fut.result(0)
    assert svc.breakers.state("lt", "walk") == "open"
    fut = svc.submit("lt", xs)  # brownout (an open breaker) admits NORMAL
    svc.pump()
    with pytest.raises(CircuitOpenError) as ei:
        fut.result(0)
    assert ei.value.retry_after_s == pytest.approx(5.0)
    with pytest.raises(QueueFullError):
        svc.submit("lt", xs, priority="batch")  # brownout refuses BATCH
    crit = svc.submit("lt", xs, priority="critical")
    svc.pump()
    assert crit.result(0).shape == (1, 4, LAM)
    clock.advance(5.5)
    probe = svc.submit("lt", xs)
    svc.pump()
    probe.result(0)
    assert svc.breakers.state("lt", "walk") == "closed"
    assert svc.metrics_snapshot()["serve_breaker_fast_fails_total"] == 1


def test_deadline_expiry_and_watchdog_on_fake_clock():
    rng = np.random.default_rng(10)
    bundles = make_bundles("xor", rng)
    clock = FakeClock()
    svc = port_service(port_dcf("walk"), bundles, clock=clock,
                       batch_timeout_s=1.0, retries=1)
    xs = rng.integers(0, 256, (3, NB), dtype=np.uint8)
    late = svc.submit("lt", xs, deadline_ms=5.0)
    ok = svc.submit("gt", xs, deadline_ms=500.0)
    clock.advance(0.010)
    svc.pump()
    with pytest.raises(DeadlineExceededError):
        late.result(0)
    assert ok.result(0).shape == (1, 3, LAM)
    with faults.inject("serve.eval", handler=faults.latency(clock, 2.0)):
        hung = svc.submit("lt", xs)
        svc.pump()
    with pytest.raises(BatchTimeoutError):
        hung.result(0)
    snap = svc.metrics_snapshot()
    assert snap["serve_deadline_expired_total"] == 1
    assert snap["serve_batch_timeouts_total"] == 2  # dispatch and retry


def test_worker_thread_start_and_close():
    rng = np.random.default_rng(11)
    bundles = make_bundles("xor", rng)
    dcf = port_dcf("walk")
    svc = dcf.serve(max_batch=64, max_delay_ms=1.0)
    for name, kb in bundles.items():
        svc.register_key(name, kb)
    xs = rng.integers(0, 256, (12, NB), dtype=np.uint8)
    with svc:
        futs = [svc.submit(name, xs, b=b) for name in bundles
                for b in (0, 1)]
        ys = [f.result(60) for f in futs]
    for (name, b), y in zip([(n, b) for n in bundles for b in (0, 1)], ys):
        assert np.array_equal(y, eval_batch_np(
            dcf._prg, b, bundles[name].for_party(b), xs))
    assert not svc._worker.is_alive()
    with pytest.raises(QueueFullError):
        svc.submit("lt", xs)  # closed


def test_reset_backend_health_invalidates_facades_and_services():
    rng = np.random.default_rng(12)
    bundles = make_bundles("xor", rng)
    dcf = port_dcf("prefix", prefix_levels=8)
    svc = port_service(dcf, bundles)
    xs = rng.integers(0, 256, (3, NB), dtype=np.uint8)
    for reset in (dcf.reset_backend_health, api.reset_backend_health):
        serve_all(svc, [("lt", 0, xs)])
        dcf.eval(0, bundles["gt"], xs)
        assert dcf._eval_backends and svc.metrics_snapshot()[
            "serve_resident_images"] == 1
        reset()
        snap = svc.metrics_snapshot()
        assert snap["serve_resident_images"] == 0
        assert snap["serve_frontier_cache_entries"] == 0
        assert not dcf._eval_backends
        assert dcf.backend_name == "prefix"
    with pytest.raises(ValueError, match="either config"):
        dcf.serve(ServeConfig(), max_batch=8)
    assert dcf.serve(max_batch=8).config == ServeConfig(max_batch=8)


def test_replication_frames_cross_packages():
    """``register_frame`` mints a generation; ``sync_frames`` ships the
    strictly-newer frames; ``apply_replica_frame`` applies them under
    the owner's generation in the other package, and the fence refuses a
    rollback, in both directions."""
    rng = np.random.default_rng(13)
    bundles = make_bundles("add16", rng)
    pb = port_dcf("numpy").mic(MIC, rng.integers(0, 256, (4, LAM),
                                                 dtype=np.uint8), rng=rng)
    owner = port_service(port_dcf("walk"), {})
    g_lt = owner.register_frame("lt", bundles["lt"].to_bytes())
    g_mic = owner.register_frame("mic", pb.to_bytes(), proto=True)
    assert (g_lt, g_mic) == (1, 2)
    jrep = jax_service({})
    for key_id, gen, proto, frame in owner.sync_frames({}):
        assert jrep.apply_replica_frame(key_id, frame, gen, proto) == gen
    assert jrep.replication_digest() == owner.replication_digest()
    assert owner.sync_frames({"lt": 1, "mic": 2}) == []
    back = port_service(port_dcf("walk"), {})
    for key_id, gen, proto, frame in jrep.sync_frames({}):
        back.apply_replica_frame(key_id, frame, gen, proto)
    with pytest.raises(StaleStateError):
        back.apply_replica_frame("lt", bundles["gt"].to_bytes(), 1)
    assert back.metrics_snapshot()["serve_replica_fenced_total"] == 1
    xs = rng.integers(0, 256, (9, NB), dtype=np.uint8)
    reqs = [("lt", 0, xs), ("mic", 1, xs)]
    for y, w in zip(serve_all(back, reqs), serve_all(jrep, reqs)):
        assert np.array_equal(y, w)


def test_attach_pir_answers_through_the_service():
    rng = np.random.default_rng(14)
    dcf = Dcf(1, 32, CK, backend="walk", device="cpu")
    records = rng.integers(0, 256, (256, 8), dtype=np.uint8)
    svc = port_service(dcf, {})
    with pytest.raises(ShapeError, match="attach_pir"):
        svc.register_key("q", dcf.pir_query([3], rng=rng))
        svc.submit("q", np.zeros((1, 1), np.uint8))
    svc.attach_pir(PirDatabase(records, 8, device="cpu"))
    idx = [0, 77, 255]
    svc.register_key("q", dcf.pir_query(idx, rng=rng))
    a0 = svc.submit("q", np.zeros((1, 1), np.uint8), b=0).result(0)
    a1 = svc.submit("q", np.zeros((1, 1), np.uint8), b=1).result(0)
    assert a0.shape == (3, 1, 8)
    assert np.array_equal(pir_reconstruct(a0[:, 0], a1[:, 0]),
                          records[idx])
    assert svc.metrics_snapshot()["serve_pir_answers_total"] == 2


def _scripted(svc, bundles, clock, rng_seed: int) -> dict:
    """One scripted pump() sequence: ragged groups, a priority eviction,
    an expiry, a shed, a failed-then-retried batch, an unregister."""
    rng = np.random.default_rng(rng_seed)
    xs = [rng.integers(0, 256, (m, NB), dtype=np.uint8)
          for m in (5, 40, 3, 17, 2)]
    svc.submit("lt", xs[0], b=0)
    svc.submit("multi", xs[1], b=1, priority="batch")
    svc.submit("gt", xs[2], b=1, deadline_ms=1.0)
    clock.advance(0.002)
    svc.pump()
    svc.submit("lt", np.zeros((40, NB), np.uint8))
    try:
        svc.submit("gt", np.zeros((30, NB), np.uint8))
    except Exception:  # the typed shed is part of the script
        pass
    svc.submit("gt", xs[3], b=0, priority="critical")
    svc.submit("multi", xs[4], b=0)
    calls = {"n": 0}

    def fail_once(*_args):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected")

    fl = faults if isinstance(svc, DcfService) else jfaults
    with fl.inject("serve.eval", handler=fail_once):
        svc.pump()
    svc.unregister_key("gt")
    svc.close()
    return svc.metrics_snapshot()


def test_metrics_snapshot_equals_dcf_tpu_on_numpy_facades():
    bundles = make_bundles("xor", np.random.default_rng(15))
    knobs = dict(max_batch=16, max_queued_points=64, retries=1)
    clock, jclock = FakeClock(), jfaults.FakeClock()
    svc = DcfService(port_dcf("numpy"), ServeConfig(**knobs), clock=clock)
    jsvc = JDcfService(JDcf(NB, LAM, CK, backend="numpy"),
                       JServeConfig(**knobs), clock=jclock)
    for name, kb in bundles.items():
        svc.register_key(name, kb)
        jsvc.register_key(name, jax_twin(kb))
    snap = _scripted(svc, bundles, clock, 16)
    jsnap = _scripted(jsvc, bundles, jclock, 16)
    assert snap == jsnap
    assert snap["serve_retries_total"] == 1
    assert snap["serve_deadline_expired_total"] == 1
    assert snap["serve_shed_total"] >= 1
    japi.reset_backend_health()  # the dcf_tpu listener set is untouched


def test_closed_loop_reconciles_against_the_metrics():
    """``closed_loop`` (priority mix, Zipf keys) against a started service
    on the ``numpy`` facade: the client counts reconcile with the
    service's metrics, nothing fails."""
    from dcf_tpu_torch.serve.loadgen import (
        closed_loop, reconcile_against_rollup)

    bundles = make_bundles("xor", np.random.default_rng(17))
    svc = port_dcf("numpy").serve(max_batch=64, max_delay_ms=1.0)
    for name, kb in bundles.items():
        svc.register_key(name, kb)
    with svc:
        before = svc.metrics_snapshot()
        res = closed_loop(svc, sorted(bundles), duration_s=0.3,
                          concurrency=2, min_points=1, max_points=8,
                          priority_mix={"critical": 1, "normal": 2},
                          skew=1.1)
        after = svc.metrics_snapshot()
    assert res.requests_ok > 0 and res.requests_failed == 0
    assert reconcile_against_rollup(res, before, after)["reconciled"]
    assert res.points_ok == after["serve_points_total"] - before.get(
        "serve_points_total", 0)
    assert set(res.latency_quantiles()) == {"p50_s", "p90_s", "p99_s"}
