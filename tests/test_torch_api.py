"""The port's Dcf facade on the CPU: gen + eval reconstruct beta*[x < alpha]
(x = alpha included) on every ported lam = 16 backend; unported backend
names, the lam = 16 kernels at other lam and 16 < lam < 48 raise, but for
DCF at lam = 32 under an explicit backend="numpy", which runs on the host
and matches dcf_tpu's frames and shares; a CUDA request without CUDA
raises instead of running on the CPU; keygen matches dcf_tpu's.  The lam >= 48 hybrid has its own tests
(test_torch_large_lambda.py, test_torch_hybrid_prefix.py)."""

import warnings

import numpy as np
import pytest
import torch

from dcf_tpu import spec as jspec
from dcf_tpu.api import Dcf as JDcf
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.ops.prg import HirosePrgNp as JPrg

from dcf_tpu_torch import BackendUnavailableError, Bound, Dcf
from dcf_tpu_torch.gen import gen_on_device
from dcf_tpu_torch.utils.groups import np_group_add
from tests.torch_threads import one_torch_thread  # noqa: F401

BACKENDS = ("numpy", "walk", "prefix")


def _int(b: bytes) -> int:
    return int.from_bytes(b, "big")


@pytest.mark.parametrize("backend", BACKENDS)
def test_reconstructs_comparison(backend):
    rng = np.random.default_rng(150 + BACKENDS.index(backend))
    ck = [rng.bytes(32), rng.bytes(32)]
    dcf = Dcf(2, 16, ck, backend=backend, device="cpu")
    for group, bound in (("xor", Bound.LT_BETA), ("add8", Bound.GT_BETA),
                         ("add32", Bound.LT_BETA)):
        alphas = rng.integers(0, 256, (1, 2), dtype=np.uint8)
        betas = rng.integers(0, 256, (1, 16), dtype=np.uint8)
        bundle = dcf.gen(alphas, betas, bound=bound, rng=rng, group=group)
        a = _int(alphas[0].tobytes())
        xs = rng.integers(0, 256, (40, 2), dtype=np.uint8)
        for j, x in enumerate((a, a - 1, a + 1, 0, 0xFFFF)):
            xs[j] = np.frombuffer((x % 0x10000).to_bytes(2, "big"), np.uint8)
        y0, y1 = (dcf.eval(b, bundle, xs) for b in (0, 1))
        recon = np_group_add(y0, y1, group)[0]
        for j in range(len(xs)):
            x = _int(xs[j].tobytes())
            hit = x < a if bound is Bound.LT_BETA else x > a
            assert recon[j].tobytes() == (betas[0].tobytes() if hit
                                          else bytes(16)), (group, j)


def test_gen_matches_dcf_tpu_and_bundle_ships_once():
    rng = np.random.default_rng(160)
    ck = [rng.bytes(32), rng.bytes(32)]
    alphas = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    s0s = rng.integers(0, 256, (2, 2, 16), dtype=np.uint8)
    dcf = Dcf(2, 16, ck, device="cpu")
    assert dcf.backend_name == "walk"  # auto
    got = dcf.gen(alphas, betas, s0s=s0s, bound=Bound.GT_BETA, group="add16")
    want = j_gen_batch(JPrg(16, ck), alphas, betas, s0s,
                       jspec.Bound.GT_BETA, group="add16")
    for f in ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    xs = rng.integers(0, 256, (2, 8, 2), dtype=np.uint8)  # per-key points
    dcf.eval(0, got, xs)
    be = dcf.eval_backend(0)
    image = be._bundle_dev
    dcf.eval(0, got, xs)
    assert be._bundle_dev is image  # same bundle object: not re-shipped
    assert dcf.eval_backend(0) is be and dcf.eval_backend(1) is not be
    assert Dcf(2, 16, ck, backend="numpy", device="cpu").eval_backend() \
        is None


@pytest.mark.parametrize("name", ["cpu", "jax", "bitsliced", "pallas",
                                  "keylanes", "hybrid", "nope"])
def test_unported_backends_raise(name):
    """Every JAX backend name but hybrid, keylanes and cpu is not in the
    package; hybrid is, for lam >= 48 only, keylanes for lam = 16 only,
    and cpu (the C++ core) takes no backend_opts, as in dcf_tpu."""
    lam = 48 if name == "keylanes" else 16
    match = {"hybrid": "lam >= 48", "keylanes": "lam=16 only",
             "cpu": "do not apply"}.get(name, "not in this package")
    opts = {"threads": 1} if name == "cpu" else None
    with pytest.raises(ValueError, match=match):
        Dcf(2, lam, [b"k" * 32] * 2, backend=name, backend_opts=opts,
            device="cpu")


@pytest.mark.parametrize("lam", [32, 48, 128])
def test_other_lam_raises(lam):
    """walk is the lam = 16 and lam = 32 kernel walk (B1, E1), prefix and
    keylanes lam = 16 kernels; auto takes walk up to lam = 32 and hybrid
    from lam = 48 on.  At lam = 32 the refusals name walk, above it
    hybrid."""
    ck = [b"k" * 32] * 18
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        auto = Dcf(2, lam, ck, device="cpu")
        assert auto.backend_name == ("walk" if lam == 32 else "hybrid")
        if lam == 32:
            assert Dcf(2, lam, ck, backend="walk",
                       device="cpu").backend_name == "walk"
        else:
            with pytest.raises(ValueError, match="lam=16 and lam=32"):
                Dcf(2, lam, ck, backend="walk", device="cpu")
    use = "walk" if lam == 32 else "hybrid"
    for name in ("prefix", "keylanes"):
        with pytest.raises(ValueError, match=f"lam=16 only.*use {use}"):
            Dcf(2, lam, ck, backend=name, device="cpu")


@pytest.mark.parametrize("bound", list(Bound))
@pytest.mark.parametrize("group", ["xor", "add8", "add16", "add32"])
def test_lam32_numpy_backend_matches_dcf_tpu(group, bound):
    """DCF at lam = 32 under an explicit backend="numpy": gen (device=None
    takes the host walk) gives DCFK frames byte-equal to dcf_tpu's facade
    with the same backend, and eval gives its shares for both parties,
    with x = alpha and alpha +- 1 planted for every key; the shares
    reconstruct beta * [x < alpha] (or [x > alpha])."""
    rng = np.random.default_rng(
        180 + 2 * ["xor", "add8", "add16", "add32"].index(group)
        + list(Bound).index(bound))
    ck = [rng.bytes(32) for _ in range(18)]
    k_num, n_bytes, lam = 3, 2, 32
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    s0s = rng.integers(0, 256, (k_num, 2, lam), dtype=np.uint8)
    xs = rng.integers(0, 256, (16, n_bytes), dtype=np.uint8)
    for key in range(k_num):
        a = _int(alphas[key].tobytes())
        for d in (-1, 0, 1):
            xs[3 * key + d + 1] = np.frombuffer(
                ((a + d) % 0x10000).to_bytes(2, "big"), np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcf = Dcf(n_bytes, lam, ck, backend="numpy", device="cpu")
        ref = JDcf(n_bytes, lam, ck, backend="numpy")
    got = dcf.gen(alphas, betas, s0s=s0s, bound=bound, group=group)
    want = ref.gen(alphas, betas, s0s=s0s, bound=jspec.Bound[bound.name],
                   group=group)
    assert got.to_bytes() == want.to_bytes()
    ys = []
    for b in (0, 1):
        assert got.for_party(b).to_bytes() == want.for_party(b).to_bytes()
        y = dcf.eval(b, got, xs)
        assert np.array_equal(y, ref.eval(b, want, xs)), b
        ys.append(y)
    recon = np_group_add(ys[0], ys[1], group)
    for key in range(k_num):
        a = _int(alphas[key].tobytes())
        for j in range(len(xs)):
            x = _int(xs[j].tobytes())
            hit = x < a if bound is Bound.LT_BETA else x > a
            assert recon[key, j].tobytes() == (
                betas[key].tobytes() if hit else bytes(lam)), (key, j)


def test_lam32_keygen_routing(monkeypatch):
    """At lam = 32 DCF keys take kernel G2: gen(device=None) under auto
    (= walk) enters the kernel path, device=True too, device=False is the
    host walk with the same bytes, an additive group the host walk; the
    shares of auto's eval (kernel E1's plain version here) equal the numpy
    backend's; the DPF methods are still served, and prefix, keylanes and
    hybrid refuse the width, naming walk."""
    import dcf_tpu_torch.api as api

    entered = []

    def spy(*a, **k):
        entered.append(a[0])
        return gen_on_device(*a, **k)

    monkeypatch.setattr(api, "gen_on_device", spy)
    rng = np.random.default_rng(190)
    ck = [rng.bytes(32) for _ in range(18)]
    alphas = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 32), dtype=np.uint8)
    s0s = rng.integers(0, 256, (2, 2, 32), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        host = Dcf(2, 32, ck, backend="numpy", device="cpu")
        auto = Dcf(2, 32, ck, device="cpu")
    assert host.backend_name == "numpy" and auto.backend_name == "walk"
    kernel = auto.gen(alphas, betas, s0s=s0s)
    assert entered == [32]
    assert kernel.to_bytes() == auto.gen(alphas, betas, s0s=s0s,
                                         device=False).to_bytes()
    assert kernel.to_bytes() == host.gen(alphas, betas, s0s=s0s,
                                         device=True).to_bytes()
    assert entered == [32, 32]
    auto.gen(alphas, betas, s0s=s0s, group="add16")  # the host walk
    assert entered == [32, 32]
    for b in (0, 1):
        assert np.array_equal(auto.eval(b, kernel, alphas),
                              host.eval(b, kernel, alphas))
    assert auto.dpf(alphas, s0s=s0s, device=False).num_keys == 2
    for name in ("prefix", "keylanes", "hybrid"):
        with pytest.raises(ValueError, match="use walk"):
            Dcf(2, 32, ck, backend=name, device="cpu")


def test_facade_argument_contract():
    ck = [b"k" * 32] * 2
    with pytest.raises(ValueError):
        Dcf(0, 16, ck, device="cpu")
    with pytest.raises(ValueError):
        Dcf(2, 16, ck, backend="numpy", backend_opts={"x": 1}, device="cpu")
    with pytest.raises(ValueError):
        Dcf(2, 16, ck, device="meta")
    dcf = Dcf(2, 16, ck, device="cpu")
    alphas, betas = np.zeros((1, 2), np.uint8), np.zeros((1, 16), np.uint8)
    s0s = np.ones((1, 2, 16), np.uint8)
    on_card = dcf.gen(alphas, betas, s0s=s0s, device=True)
    host = dcf.gen(alphas, betas, s0s=s0s, device=False)
    assert on_card.to_bytes() == host.to_bytes()
    with pytest.raises(ValueError, match="additive algebra"):
        dcf.gen(alphas, betas, s0s=s0s, device=True, group="add8")


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_cuda_request_without_cuda_raises(monkeypatch, device):
    """The card is the default; without CUDA the facade and the backends
    raise rather than run the plain versions on the CPU."""
    from dcf_tpu_torch.backends.large_lambda import LargeLambdaBackend
    from dcf_tpu_torch.backends.prefix_backend import PrefixBackend
    from dcf_tpu_torch.backends.walk_backend import WalkBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = [b"k" * 32] * 2
    with pytest.raises(BackendUnavailableError, match="CUDA"):
        Dcf(2, 16, ck, backend="walk", device=device)
    for cls in (WalkBackend, PrefixBackend):
        with pytest.raises(BackendUnavailableError):
            cls(16, ck, device=device)
    with pytest.raises(BackendUnavailableError):
        LargeLambdaBackend(48, ck * 9, device=device)


def test_eval_all_follows_the_facade_device():
    """``eval_all`` runs kernel B6's evaluator on the facade's device by
    default (here its plain version, the facade being built for the CPU)
    and the numpy expansion only on ``device=False``; at a lam without
    the kernel the default raises and names the host argument."""
    from dcf_tpu_torch.backends.evalall import DpfEvalAll

    rng = np.random.default_rng(31)
    ck = [rng.bytes(32) for _ in range(18)]
    alphas = rng.integers(0, 256, (2, 1), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcf = Dcf(1, 32, ck, device="cpu")
        wide = Dcf(1, 48, ck, device="cpu")
    bundle = dcf.dpf(alphas, rng=rng)
    host = dcf.eval_all(0, bundle, device=False)
    assert dcf._dpf_evalall is None  # the host expansion builds no evaluator
    got = dcf.eval_all(0, bundle)
    assert isinstance(dcf._dpf_evalall, DpfEvalAll)
    assert dcf._dpf_evalall.device == dcf.device == torch.device("cpu")
    for g, h in zip(got, host):
        assert g.dtype == np.uint8 and np.array_equal(g, h)
    wb = wide.dpf(alphas, rng=rng)
    with pytest.raises(ValueError, match="device=False"):
        wide.eval_all(0, wb)
    y, t = wide.eval_all(0, wb, device=False)
    assert y.shape == (2, 256, 48) and t.shape == (2, 256)
