"""The port's key factory against ``dcf_tpu``'s.

Pools are refilled from one seeded ``np.random.Generator`` in each
package: the port mints on its plain G1 (``gen.gen_on_device`` on a
``device="cpu"`` facade, the device route every pool takes by default),
``dcf_tpu``'s factory on its host walk (``PoolSpec(device=False)``, so
that no XLA keygen compiles here); the draws (the refill's root seeds,
the exhaustion fallback's spawned child generator) happen in the same
order, so the pooled bundles, their frames and their generations are
byte-equal, plain and MIC.  Then the port alone: claims, refill
hysteresis, pool store ids, two-party reconstruction against the
oracle through ``register_key(pool=...)``, the ``keyfactory.refill``
fault and breaker, durable pools repooled at restart with their
generations, and the refill worker.  The lam = 256 staged-plane handoff:
a claimed key of a ``hybrid`` service (``prefix_levels``, plain versions)
stages from the keygen's device arrays, counted by the registry, and
serves the bytes of the same bundle staged from the host and of
``dcf_tpu``'s hybrid on its DCFK frame; a hot-swap drops the planes.
``session_churn`` over a pool: every session's shares reconstruct the
pool's function, and the hit and miss counters add up.  Tolerance:
exact byte equality."""

import threading
import warnings

import numpy as np
import pytest

from dcf_tpu import Dcf as JDcf
from dcf_tpu.serve import DcfService as JDcfService
from dcf_tpu.serve import PoolSpec as JPoolSpec
from dcf_tpu.serve import ServeConfig as JServeConfig
from dcf_tpu.serve.keyfactory import KeyFactory as JKeyFactory
from dcf_tpu.serve.keyfactory import parse_pool_store_id as jparse
from dcf_tpu.serve.registry import KeyRegistry as JKeyRegistry
from dcf_tpu.testing import faults as jfaults

from dcf_tpu_torch import Dcf
from dcf_tpu_torch.errors import BackendFallbackWarning, ShapeError
from dcf_tpu_torch.protocols import mic_oracle
from dcf_tpu_torch.serve import DcfService, PoolSpec, ServeConfig
from dcf_tpu_torch.serve.keyfactory import (
    KeyFactory,
    parse_pool_store_id,
    pool_store_id,
)
from dcf_tpu_torch.serve.registry import KeyRegistry
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.testing.faults import FakeClock
from tests.torch_threads import one_torch_thread  # noqa: F401

NB, LAM = 2, 16
CK = [bytes((11 * i + j) % 256 for j in range(32)) for i in range(2)]
ALPHAS = np.array([[0x42, 0x10]], dtype=np.uint8)
BETAS = np.arange(1, LAM + 1, dtype=np.uint8)[None]
MIC = ((7, 900), (60000, 300))
MIC_BETAS = np.arange(2 * LAM, dtype=np.uint8).reshape(2, LAM)


def port_facade(backend="walk") -> Dcf:
    return Dcf(NB, LAM, CK, backend=backend, device="cpu")


def spec(cls, name="p", **kw):
    base = dict(name=name, alphas=ALPHAS, betas=BETAS, target_depth=6,
                low_water=2, refill_batch=4)
    return cls(**{**base, **kw})


def mic_spec(cls, **kw):
    return cls(name="mic", betas=MIC_BETAS, intervals=MIC, target_depth=3,
               low_water=1, refill_batch=3, **kw)


def serve_check(svc, key_id, rng, points=12):
    """Both parties through the service; the reconstruction against the
    pool's function, x = alpha included."""
    xs = rng.integers(0, 256, (points, NB), dtype=np.uint8)
    xs[0] = ALPHAS[0]
    f0, f1 = (svc.submit(key_id, xs, b=b) for b in (0, 1))
    svc.pump()
    recon = f0.result(0) ^ f1.result(0)
    inside = [x.tobytes() < ALPHAS[0].tobytes() for x in xs]
    want = np.where(np.array(inside)[:, None], BETAS, 0).astype(np.uint8)
    assert np.array_equal(recon[0], want)


def test_pool_store_ids_match_dcf_tpu():
    for key_id in ("~pool/p/0", "~pool/a/b/17", "~pool/p/x", "~pool//3",
                   "plain", "~pool/p/", pool_store_id("relu", 42)):
        assert parse_pool_store_id(key_id) == jparse(key_id)
    assert parse_pool_store_id(pool_store_id("relu", 42)) == ("relu", 42)
    with pytest.raises(ValueError):
        PoolSpec(name="a/b", alphas=ALPHAS, betas=BETAS)
    with pytest.raises(ShapeError):
        PoolSpec(name="both", alphas=ALPHAS, betas=BETAS, intervals=MIC)
    with pytest.raises(ValueError):
        spec(PoolSpec, low_water=9)


@pytest.mark.parametrize("kind", ["plain", "mic"])
def test_pooled_bundles_equal_dcf_tpu_from_one_seed(kind):
    """One seed: the port's plain G1 and ``dcf_tpu``'s host walk mint the
    same bundles, frames and generations, refill after refill, and the
    exhaustion fallback's child generator draws the same seeds."""
    make = spec if kind == "plain" else mic_spec
    port = KeyFactory(port_facade(), registry=KeyRegistry(lambda: None),
                      clock=FakeClock(), rng=np.random.default_rng(99))
    jax = JKeyFactory(JDcf(NB, LAM, CK, backend="numpy"),
                      registry=JKeyRegistry(lambda: None),
                      clock=jfaults.FakeClock(),
                      rng=np.random.default_rng(99))
    port.add_pool(make(PoolSpec))
    jax.add_pool(make(JPoolSpec, device=False))
    name = "p" if kind == "plain" else "mic"
    got, want = [], []
    for _ in range(2):
        port.pump()
        jax.pump()
        assert port.pool_manifest(name) == jax.pool_manifest(name)
        while port.depth(name):
            got.append(port.claim(name))
            want.append(jax.claim(name))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got.append(port.claim(name))  # exhausted: the synchronous mint
        want.append(jax.claim(name))
    assert len(got) == (13 if kind == "plain" else 7)  # 2 refills + 1
    for m, j in zip(got, want):
        assert (m.pool_id, m.generation) == (j.pool_id, j.generation)
        frame = (m.protocol or m.bundle).to_bytes()
        assert frame == (j.protocol or j.bundle).to_bytes()
    assert port.metrics.snapshot() == jax.metrics.snapshot()


def test_claims_register_and_reconstruct_on_plain_g1():
    rng = np.random.default_rng(1)
    svc = DcfService(port_facade("prefix"), ServeConfig(), clock=FakeClock())
    svc.add_pool(spec(PoolSpec))
    report = svc.keyfactory.pump()
    assert report.minted == {"p": 6}
    assert svc.keyfactory.depth("p") == 6
    for i in range(5):  # 6 -> 1: below low water after the fifth claim
        svc.register_key(f"s{i}", pool="p")
    assert svc.keyfactory.depth("p") == 1
    serve_check(svc, "s0", rng)
    serve_check(svc, "s4", rng)
    assert svc.keyfactory.pump().minted == {"p": 5}
    snap = svc.metrics_snapshot()
    assert snap["keyfactory_pool_hits_total"] == 5
    assert snap["keyfactory_minted_keys_total"] == 11
    assert snap["keyfactory_pool_depth{pool=p}"] == 6
    with pytest.raises(ValueError, match="not both"):
        svc.register_key("x", svc.registry.bundle("s0"), pool="p")
    with pytest.raises(ValueError, match="needs a bundle"):
        svc.register_key("x")


def test_mic_pool_serves_protocol_keys():
    rng = np.random.default_rng(2)
    svc = DcfService(port_facade(), ServeConfig(), clock=FakeClock())
    svc.add_pool(mic_spec(PoolSpec))
    svc.keyfactory.pump()
    pb = svc.register_key("m", pool="mic")
    assert pb.num_intervals == 2
    xs = rng.integers(0, 256, (9, NB), dtype=np.uint8)
    xs[0] = [0, 7]
    f0, f1 = (svc.submit("m", xs, b=b) for b in (0, 1))
    svc.pump()
    assert np.array_equal(f0.result(0) ^ f1.result(0),
                          mic_oracle(xs, MIC, MIC_BETAS))


def test_exhaustion_falls_back_counted_and_warned():
    rng = np.random.default_rng(3)
    svc = DcfService(port_facade("cpu"), ServeConfig(), clock=FakeClock())
    svc.add_pool(spec(PoolSpec, name="empty"))
    with pytest.warns(BackendFallbackWarning):
        svc.register_key("fb", pool="empty")
    serve_check(svc, "fb", rng)
    assert svc.metrics_snapshot()["keyfactory_pool_misses_total"] == 1


@pytest.mark.parametrize("kind", ["plain", "mic"])
def test_pool_miss_mints_through_the_device_keygen(kind):
    """An empty pool's synchronous mint takes the refill's route: one
    ``gen.gen_on_device`` call (the ``keygen.device`` seam, the plain G1
    here) on a ``device="cpu"`` facade; ``PoolSpec(device=False)`` alone
    names the host walk.  The keys reconstruct either way."""
    make = spec if kind == "plain" else mic_spec
    seen = []
    for device in (None, False):
        svc = DcfService(port_facade("cpu"), ServeConfig(),
                         clock=FakeClock())
        svc.add_pool(make(PoolSpec, **({"name": "empty"} if kind == "plain"
                                       else {}), device=device))
        name = svc.keyfactory.pool_names()[0]
        calls = []
        with faults.inject("keygen.device",
                           handler=lambda k, lam: calls.append((k, lam))):
            with pytest.warns(BackendFallbackWarning):
                minted = svc.register_key("fb", pool=name)
        seen.append(calls)
        if kind == "plain":
            serve_check(svc, "fb", np.random.default_rng(5))
        else:
            assert minted.num_intervals == 2
    ks = 1 if kind == "plain" else 2 * len(MIC)
    assert seen == [[(ks, LAM)], []]


def test_refill_fault_opens_the_factory_breaker():
    rng = np.random.default_rng(4)
    clock = FakeClock()
    svc = DcfService(port_facade(), ServeConfig(breaker_failures=3,
                                                breaker_cooldown_s=5.0),
                     clock=clock)
    svc.add_pool(spec(PoolSpec, name="flaky"))
    with faults.inject_schedule("keyfactory.refill", window_evals=3):
        for _ in range(3):
            assert "flaky" in svc.keyfactory.pump().failed
        assert svc.keyfactory.breakers.state(
            "~pool/flaky", "keyfactory") == "open"
        assert svc.keyfactory.pump().skipped == ["flaky"]
    assert not svc.breakers.any_open()
    clock.advance(5.5)
    assert svc.keyfactory.pump().minted == {"flaky": 6}
    svc.register_key("ok", pool="flaky")
    serve_check(svc, "ok", rng)
    assert svc.metrics_snapshot()["keyfactory_refill_failures_total"] == 3


def test_durable_pool_repooled_at_restart(tmp_path):
    """A refill publishes ~pool frames under registry generations; a
    durable claim drops its pool frame in the same flip; a restarted
    service repools the rest with their generations and serves them.
    ``dcf_tpu``'s service restores the same pool from the port's store."""
    rng = np.random.default_rng(5)
    svc = DcfService(port_facade(), ServeConfig(store_dir=str(tmp_path)),
                     clock=FakeClock())
    svc.add_pool(spec(PoolSpec, target_depth=4, low_water=0))
    svc.keyfactory.pump()
    manifest = svc.keyfactory.pool_manifest("p")
    svc.register_key("sess", pool="p", durable=True)
    svc.close()
    left = {k: g for k, g in manifest.items() if k != "~pool/p/0"}
    fresh = DcfService(port_facade(), ServeConfig(store_dir=str(tmp_path)),
                       clock=FakeClock())
    fresh.add_pool(spec(PoolSpec, target_depth=4, low_water=0))
    report = fresh.restore_keys()
    assert report.repooled == left
    assert list(report.restored) == ["sess"]
    assert fresh.keyfactory.pool_manifest("p") == left
    serve_check(fresh, "sess", rng)
    fresh.register_key("s2", pool="p")
    serve_check(fresh, "s2", rng)
    jsvc = JDcfService(JDcf(NB, LAM, CK, backend="numpy"),
                       JServeConfig(store_dir=str(tmp_path)),
                       clock=jfaults.FakeClock())
    jsvc.add_pool(spec(JPoolSpec, target_depth=4, low_water=0))
    jreport = jsvc.restore_keys()
    assert jreport.repooled == report.repooled
    assert jreport.restored == report.restored


def test_refill_worker_fills_a_pool_declared_after_start():
    svc = DcfService(port_facade(), ServeConfig(
        keyfactory_refill_interval_s=0.01))
    with svc:
        svc.add_pool(spec(PoolSpec))
        for _ in range(3000):
            if svc.keyfactory.depth("p") == 6:
                break
            svc.keyfactory._wake.wait(0.01)
        assert svc.keyfactory.depth("p") == 6
    assert not svc.keyfactory._worker.is_alive()


# ------------------------------------ the lam >= 48 staged-plane handoff

LAM_WIDE = 256
CK_WIDE = [bytes((7 * i + 3 * j) % 256 for j in range(32))
           for i in range(2 * (LAM_WIDE // 16))]
ALPHAS_WIDE = np.array([[0x81, 0x3C]], dtype=np.uint8)
BETAS_WIDE = (np.arange(LAM_WIDE, dtype=np.uint16) * 5 % 256).astype(
    np.uint8)[None]
PREFIX_LEVELS = 6


def wide_service():
    dcf = Dcf(NB, LAM_WIDE, CK_WIDE, backend="hybrid", device="cpu",
              backend_opts={"prefix_levels": PREFIX_LEVELS})
    svc = DcfService(dcf, ServeConfig(max_batch=64), clock=FakeClock())
    svc.add_pool(PoolSpec(name="wide", alphas=ALPHAS_WIDE,
                          betas=BETAS_WIDE, target_depth=3, low_water=1,
                          refill_batch=3))
    return svc


def wide_points(rng, m=40):
    xs = rng.integers(0, 256, (m, NB), dtype=np.uint8)
    xs[0] = ALPHAS_WIDE[0]  # x = alpha
    xs[1] = np.frombuffer((int.from_bytes(ALPHAS_WIDE[0].tobytes(), "big")
                           - 1).to_bytes(NB, "big"), np.uint8)
    return xs


def both_parties(svc, key_id, xs):
    futs = [svc.submit(key_id, xs, b=b) for b in (0, 1)]
    svc.pump()
    return [f.result(0) for f in futs]


def test_pool_claim_at_lam_256_stages_from_its_device_planes():
    """A lam = 256 key the pool minted on the keygen kernels' plain
    versions (B7a + W2) carries both parties' narrow arrays; claimed and
    served on the ``hybrid`` (prefix_levels, B5a + B5b + W1), it stages
    from them (``stagings_from_planes``), and its shares equal the same
    bundle's registered from the host and ``dcf_tpu``'s hybrid on the
    bundle's DCFK frame, both parties, x = alpha included; the
    reconstruction is the pool's function."""
    import dcf_tpu.backends.large_lambda as jll
    from dcf_tpu.keys import KeyBundle as JKeyBundle

    rng = np.random.default_rng(0x256)
    svc = wide_service()
    svc.keyfactory.pump()
    minted = svc.keyfactory._pools["wide"].entries[0]
    assert set(minted.planes) == {0, 1}
    assert minted.planes[0]["cw_s"] is minted.planes[1]["cw_s"]
    assert minted.planes[0]["s0"].shape == (1, 32)
    kb = svc.register_key("sess", pool="wide")
    assert svc.registry._entries["sess"].planes is not None
    xs = wide_points(rng)
    ys = both_parties(svc, "sess", xs)
    assert (svc.registry.stagings_from_planes,
            svc.registry.stagings_from_bundle) == (2, 0)
    svc.register_key("host-copy", kb)
    ys_host = both_parties(svc, "host-copy", xs)
    assert (svc.registry.stagings_from_planes,
            svc.registry.stagings_from_bundle) == (2, 2)
    for b in (0, 1):
        assert np.array_equal(ys[b], ys_host[b]), b
    jkb = JKeyBundle.from_bytes(kb.to_bytes())
    for b in (0, 1):
        jbe = jll.LargeLambdaBackend(LAM_WIDE, CK_WIDE,
                                     prefix_levels=PREFIX_LEVELS,
                                     interpret=True)
        assert np.array_equal(jbe.eval(b, xs, jkb.for_party(b)),
                              ys[b]), b
    inside = [x.tobytes() < ALPHAS_WIDE[0].tobytes() for x in xs]
    want = np.where(np.array(inside)[:, None], BETAS_WIDE, 0)
    assert np.array_equal(ys[0][0] ^ ys[1][0], want.astype(np.uint8))


def test_staged_planes_equal_the_bundles_narrow_arrays():
    """What ``put_bundle(bundle, dev_planes=...)`` stages is what
    ``put_bundle(bundle)`` ships from the host, array for array; a plane
    of the wrong shape is refused typed."""
    from dcf_tpu_torch.backends.device_gen import HybridKeyGen
    from dcf_tpu_torch.backends.large_lambda import LargeLambdaBackend
    from dcf_tpu_torch.gen import gen_on_device_with_planes, random_s0s
    from dcf_tpu_torch import Bound

    rng = np.random.default_rng(0x48)
    al = np.tile(ALPHAS_WIDE, (3, 1))
    bt = np.tile(BETAS_WIDE, (3, 1))
    s0s = random_s0s(3, LAM_WIDE, rng)
    kb, planes = gen_on_device_with_planes(LAM_WIDE, CK_WIDE, al, bt, s0s,
                                           Bound.LT_BETA, device="cpu")
    assert kb.to_bytes() == HybridKeyGen(LAM_WIDE, CK_WIDE, device="cpu"
                                         ).gen(al, bt, s0s,
                                               Bound.LT_BETA).to_bytes()
    for b in (0, 1):
        host = LargeLambdaBackend(LAM_WIDE, CK_WIDE, device="cpu")
        host.put_bundle(kb.for_party(b))
        dev = LargeLambdaBackend(LAM_WIDE, CK_WIDE, device="cpu")
        assert dev.accepts_dev_planes
        dev.put_bundle(kb.for_party(b), dev_planes=planes[b])
        for name, t in host._dev.items():
            assert np.array_equal(t.numpy(), dev._dev[name].numpy()), name
    bad = dict(planes[0], s0=planes[0]["s0"][:, :16])
    with pytest.raises(ShapeError, match="dev_planes"):
        LargeLambdaBackend(LAM_WIDE, CK_WIDE, device="cpu").put_bundle(
            kb.for_party(0), dev_planes=bad)
    # Below lam = 48 there is no staged layout: planes is None.
    kb16, none = gen_on_device_with_planes(16, CK, ALPHAS, BETAS,
                                           random_s0s(1, 16, rng),
                                           Bound.LT_BETA, device="cpu")
    assert none is None and kb16.lam == 16


def test_reregistering_drops_the_planes_with_the_residency():
    """A hot-swap under the same name evicts the residency and the
    entry's planes: the new key stages from its bundle.  A budget
    (LRU) eviction keeps them, and the re-stage uses them again."""
    rng = np.random.default_rng(0x49)
    svc = wide_service()
    svc.keyfactory.pump()
    kb = svc.register_key("sess", pool="wide")
    xs = wide_points(rng, 8)
    ys = both_parties(svc, "sess", xs)
    with svc.registry._lock:
        entry = svc.registry._entries["sess"]
        entry.residents.clear()  # what a budget eviction does
        svc.registry._update_gauges()
    assert entry.planes is not None
    assert [np.array_equal(a, b) for a, b in
            zip(both_parties(svc, "sess", xs), ys)] == [True, True]
    assert svc.registry.stagings_from_planes == 4
    svc.register_key("sess", pool="wide")  # a fresh session key
    assert svc.registry._entries["sess"].planes is not None
    svc.register_key("sess", kb)  # the old bundle, from the host
    assert svc.registry._entries["sess"].planes is None
    assert [np.array_equal(a, b) for a, b in
            zip(both_parties(svc, "sess", xs), ys)] == [True, True]
    assert (svc.registry.stagings_from_planes,
            svc.registry.stagings_from_bundle) == (4, 2)
    assert svc.metrics_snapshot()["serve_evictions_total"] >= 2


def test_pool_miss_and_host_pools_at_lam_256():
    """The exhaustion fallback mints one session on the same route and
    carries its planes; a ``PoolSpec(device=False)`` pool (the host walk)
    carries none, and its claims stage from the bundle."""
    rng = np.random.default_rng(0x50)
    svc = wide_service()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", BackendFallbackWarning)
        kb = svc.register_key("miss", pool="wide")  # empty: a sync mint
    assert svc.registry._entries["miss"].planes is not None
    svc.add_pool(PoolSpec(name="host", alphas=ALPHAS_WIDE,
                          betas=BETAS_WIDE, target_depth=2, low_water=0,
                          refill_batch=2, device=False))
    svc.keyfactory.pump()
    assert svc.keyfactory._pools["host"].entries[0].planes is None
    kb_host = svc.register_key("h", pool="host")
    xs = wide_points(rng, 8)
    for name, bundle in (("miss", kb), ("h", kb_host)):
        y0, y1 = (y[0] for y in both_parties(svc, name, xs))
        inside = [x.tobytes() < ALPHAS_WIDE[0].tobytes() for x in xs]
        want = np.where(np.array(inside)[:, None], BETAS_WIDE, 0)
        assert np.array_equal(y0 ^ y1, want.astype(np.uint8)), name
    assert (svc.registry.stagings_from_planes,
            svc.registry.stagings_from_bundle) == (2, 2)
    assert svc.metrics_snapshot()["keyfactory_pool_misses_total"] == 1


# ---------------------------------------------------- session churn


class ChurnProbe:
    """A service proxy for ``session_churn`` that keeps each session's
    claimed bundle and both parties' results, to check them after the
    run."""

    def __init__(self, svc):
        self.svc = svc
        self.n_bytes = svc.n_bytes
        self.bundles, self.shares = {}, {}
        self._lock = threading.Lock()

    def register_key(self, key_id, pool=None, durable=False):
        kb = self.svc.register_key(key_id, pool=pool, durable=durable)
        with self._lock:
            self.bundles[key_id] = kb
        return kb

    def submit(self, key_id, xs, b=0):
        fut = self.svc.submit(key_id, xs, b=b)
        with self._lock:
            self.shares.setdefault(key_id, {})[b] = (xs, fut)
        return fut

    def unregister_key(self, key_id):
        self.svc.unregister_key(key_id)


def test_session_churn_over_a_port_pool():
    """``session_churn`` over a started port service whose pool refills
    on G1's plain version: sessions complete, every session's two
    shares reconstruct the pool's function (x = alpha included when
    drawn), and the pool's hit and miss counters add up to the claims
    the sessions made."""
    from dcf_tpu_torch.serve.loadgen import session_churn

    svc = DcfService(port_facade(), ServeConfig(
        max_batch=64, max_delay_ms=1.0, keyfactory_refill_interval_s=0.01))
    svc.add_pool(spec(PoolSpec, target_depth=8, low_water=4,
                      refill_batch=4))
    svc.keyfactory.pump()
    probe = ChurnProbe(svc)
    with svc, warnings.catch_warnings():
        warnings.simplefilter("ignore", BackendFallbackWarning)
        res = session_churn(probe, pool="p", duration_s=1.0,
                            concurrency=2, min_points=1, max_points=9,
                            seed=5)
    assert res.sessions_ok > 0 and res.sessions_failed == 0
    assert res.points_ok == sum(2 * xs.shape[0] for xs, _ in
                                (s[0] for s in probe.shares.values()))
    assert len(probe.bundles) == res.sessions_ok
    for key_id, parties in probe.shares.items():
        xs = parties[0][0]
        recon = parties[0][1].result(0) ^ parties[1][1].result(0)
        inside = [x.tobytes() < ALPHAS[0].tobytes() for x in xs]
        want = np.where(np.array(inside)[:, None], BETAS, 0)
        assert np.array_equal(recon[0], want.astype(np.uint8)), key_id
    snap = svc.metrics_snapshot()
    assert snap["keyfactory_pool_hits_total"] \
        + snap["keyfactory_pool_misses_total"] == res.sessions_ok
    q = res.register_quantiles()
    assert set(q) == {"register_p50_s", "register_p90_s", "register_p99_s"}
    assert res.sessions_per_sec > 0
    assert svc.registry.key_ids() == []  # every session unregistered
