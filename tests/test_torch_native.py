"""The port's C++ host core (``dcf_tpu_torch.native``) and the facade's
``backend="cpu"`` against ``dcf_tpu``'s, byte for byte.

The same seeded numpy inputs go through the port's ``NativeDcf``,
``dcf_tpu.native.NativeDcf`` and the port's numpy oracle: keys and shares
at lam = 16, 32, 48 and 256, both bounds, both parties, x = alpha and
alpha +- 1 planted; the PRG against ``HirosePrgNp``; DCFK frames across
the two packages; ``Dcf(..., backend="cpu")`` against ``dcf_tpu``'s.  The
tolerance is exact byte equality (integer cryptography).  The build goes
to ``dcf_tpu_torch/_build/native/`` and nowhere in the source tree; the
AES-NI build falls back to the portable one with a warning, and without
either the cpu backend raises."""

import warnings

import numpy as np
import pytest

from dcf_tpu import keys as jkeys
from dcf_tpu.api import Dcf as JDcf
from dcf_tpu.errors import ShapeError as JShapeError
from dcf_tpu.native import NativeDcf as JNativeDcf
from dcf_tpu.spec import Bound as JBound

from dcf_tpu_torch import Bound, Dcf, native
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
from dcf_tpu_torch.errors import (
    BackendFallbackWarning,
    NativeBuildError,
    ShapeError,
)
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.native import NativeDcf
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.testing import faults
from tests.torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1")
PRG_FIELDS = ("s_l", "v_l", "t_l", "s_r", "v_r", "t_r")


def _keys(rng, lam):
    return [rng.bytes(32) for _ in range(2 if lam == 16 else 18)]


def _planted(rng, alphas, m):
    """m random points with alpha and alpha +- 1 of every key planted."""
    k_num, n_bytes = alphas.shape
    xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
    mod = 1 << (8 * n_bytes)
    for key in range(k_num):
        a = int.from_bytes(alphas[key].tobytes(), "big")
        for j, d in enumerate((0, -1, 1)):
            xs[3 * key + j] = np.frombuffer(
                ((a + d) % mod).to_bytes(n_bytes, "big"), dtype=np.uint8)
    return xs


@pytest.mark.parametrize("bound", list(Bound))
@pytest.mark.parametrize("lam", [16, 32, 48, 256])
def test_native_gen_and_eval_match_dcf_tpu_and_numpy(lam, bound):
    """Keys from the port's core equal dcf_tpu's core's and the port's
    numpy gen_batch; both parties' shares, shared and per-key points,
    equal dcf_tpu's core's and the port's numpy oracle."""
    rng = np.random.default_rng(700 + lam + list(Bound).index(bound))
    ck = _keys(rng, lam)
    k_num, n_bytes = 3, 2
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    alphas[0] = 0
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    s0s = random_s0s(k_num, lam, rng)
    xs = _planted(rng, alphas, 40)
    per_key = rng.integers(0, 256, (k_num, 5, n_bytes), dtype=np.uint8)
    per_key[:, 0] = alphas
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mine, theirs = NativeDcf(lam, ck), JNativeDcf(lam, ck)
        prg = HirosePrgNp(lam, ck)
    kb = mine.gen_batch(alphas, betas, s0s, bound)
    jb = theirs.gen_batch(alphas, betas, s0s, JBound(bound.value))
    want = gen_batch(prg, alphas, betas, s0s, bound)
    for f in FIELDS:
        assert np.array_equal(getattr(kb, f), getattr(jb, f)), f
        assert np.array_equal(getattr(kb, f), getattr(want, f)), f
    for b in (0, 1):
        for pts in (xs, per_key):
            got = mine.eval(b, kb, pts)
            assert np.array_equal(got, theirs.eval(b, jb, pts)), b
            assert np.array_equal(got, eval_batch_np(prg, b,
                                                     kb.for_party(b), pts))
        assert np.array_equal(mine.eval(b, kb.for_party(b), xs),
                              mine.eval(b, kb, xs, num_threads=1))


@pytest.mark.parametrize("lam", [16, 32, 48, 256])
def test_native_prg_matches_hirose_np(lam):
    """prg_gen over a [4, 5] batch of seeds equals HirosePrgNp.gen, every
    field."""
    rng = np.random.default_rng(720 + lam)
    ck = _keys(rng, lam)
    seeds = rng.integers(0, 256, (4, 5, lam), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = NativeDcf(lam, ck).prg_gen(seeds)
        want = HirosePrgNp(lam, ck).gen(seeds)
    for f in PRG_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_native_frames_cross_packages():
    """A DCFK frame of keys from the port's core reads back in dcf_tpu
    to the same arrays, and dcf_tpu's frame of its core's keys reads back
    in the port; the frames are byte-equal."""
    rng = np.random.default_rng(730)
    ck = _keys(rng, 16)
    alphas = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    betas = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    s0s = random_s0s(4, 16, rng)
    kb = NativeDcf(16, ck).gen_batch(alphas, betas, s0s, Bound.GT_BETA)
    jb = JNativeDcf(16, ck).gen_batch(alphas, betas, s0s, JBound.GT_BETA)
    frame = kb.to_bytes()
    assert frame == jb.to_bytes()
    back = jkeys.KeyBundle.from_bytes(frame)
    mine = KeyBundle.from_bytes(jb.to_bytes())
    for f in FIELDS:
        assert np.array_equal(getattr(back, f), getattr(kb, f)), f
        assert np.array_equal(getattr(mine, f), getattr(jb, f)), f
    part = kb.for_party(1).to_bytes()
    assert part == jb.for_party(1).to_bytes()
    assert KeyBundle.from_bytes(part).s0s.shape == (4, 1, 16)


@pytest.mark.parametrize("lam", [16, 32, 256])
def test_cpu_backend_matches_dcf_tpu(lam):
    """Dcf(..., backend="cpu"): gen's frames (both bounds) and both
    parties' shares equal dcf_tpu's facade with the same backend; the
    shares reconstruct beta * [x < alpha] (or [x > alpha])."""
    rng = np.random.default_rng(740 + lam)
    ck = _keys(rng, lam)
    k_num, n_bytes = 2, 2
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    xs = _planted(rng, alphas, 24)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcf = Dcf(n_bytes, lam, ck, backend="cpu", device="cpu")
        jdcf = JDcf(n_bytes, lam, ck, backend="cpu")
    assert dcf.backend_name == "cpu" and dcf.eval_backend() is None
    for bound in Bound:
        s0s = random_s0s(k_num, lam, rng)
        bundle = dcf.gen(alphas, betas, s0s=s0s, bound=bound)
        jbundle = jdcf.gen(alphas, betas, s0s=s0s, bound=JBound(bound.value))
        assert bundle.to_bytes() == jbundle.to_bytes()
        ys = [dcf.eval(b, bundle, xs) for b in (0, 1)]
        for b in (0, 1):
            assert np.array_equal(ys[b], jdcf.eval(b, jbundle, xs))
        x_int = [int.from_bytes(x.tobytes(), "big") for x in xs]
        for key in range(k_num):
            a = int.from_bytes(alphas[key].tobytes(), "big")
            for j, x in enumerate(x_int):
                inside = x < a if bound is Bound.LT_BETA else x > a
                want = betas[key] if inside else np.zeros(lam, np.uint8)
                assert np.array_equal(ys[0][key, j] ^ ys[1][key, j], want)


def test_cpu_backend_refuses_additive_groups_as_dcf_tpu():
    """Additive keys take the host numpy walk under backend="cpu" (as in
    dcf_tpu, frames equal), and evaluating them raises the same error
    class and message as dcf_tpu's cpu backend."""
    rng = np.random.default_rng(750)
    ck = _keys(rng, 16)
    alphas = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    s0s = random_s0s(2, 16, rng)
    dcf = Dcf(2, 16, ck, backend="cpu", device="cpu")
    jdcf = JDcf(2, 16, ck, backend="cpu")
    bundle = dcf.gen(alphas, betas, s0s=s0s, group="add16")
    jbundle = jdcf.gen(alphas, betas, s0s=s0s, group="add16")
    assert bundle.to_bytes() == jbundle.to_bytes()
    xs = alphas.copy()
    with pytest.raises(ShapeError) as mine:
        dcf.eval(0, bundle, xs)
    with pytest.raises(JShapeError) as theirs:
        jdcf.eval(0, jbundle, xs)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ShapeError, match="XOR-only"):
        NativeDcf(16, ck).eval(0, bundle, xs)


def test_build_goes_under_the_build_dir_only(tmp_path, monkeypatch):
    """Both variants build into the build directory given (by default
    dcf_tpu_torch/_build/native/), under names that carry a digest, and
    nothing is written beside the source; the portable build gives the
    same bytes without AES-NI."""
    src_dir = native.SOURCE.parent
    before = sorted(p.name for p in src_dir.iterdir()
                    if p.name != "__pycache__")
    assert native.BUILD_DIR == src_dir.parent / "_build" / "native"
    assert native.build().parent == native.BUILD_DIR
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_FAILED", set())
    paths = [native.build(portable) for portable in (False, True)]
    assert {p.parent for p in paths} == {tmp_path / "native"}
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) \
        == sorted(p.name for p in paths)
    assert paths[0].name.startswith("libdcf-") \
        and paths[1].name.startswith("libdcf_portable-")
    after = sorted(p.name for p in src_dir.iterdir()
                   if p.name != "__pycache__")
    assert before == after == ["__init__.py", "dcf_core.cpp"]
    rng = np.random.default_rng(760)
    ck = _keys(rng, 16)
    alphas = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    s0s = random_s0s(2, 16, rng)
    xs = rng.integers(0, 256, (9, 16), dtype=np.uint8)
    fast, slow = NativeDcf(16, ck), NativeDcf(16, ck, portable=True)
    assert not slow.has_aesni
    ka = fast.gen_batch(alphas, betas, s0s, Bound.LT_BETA)
    kp = slow.gen_batch(alphas, betas, s0s, Bound.LT_BETA)
    assert ka.to_bytes() == kp.to_bytes()
    assert np.array_equal(fast.eval(1, ka, xs), slow.eval(1, kp, xs))


def test_failed_builds_warn_then_raise(monkeypatch):
    """An AES-NI build that fails falls back to the portable build with
    a BackendFallbackWarning; where the portable build fails too,
    NativeDcf and Dcf(..., backend="cpu") raise NativeBuildError (no
    numpy keygen stands in)."""
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_FAILED", set())
    ck = [b"k" * 32] * 2
    with faults.inject("native.build", handler=faults.fail_unless(
            lambda portable: portable)):
        with pytest.warns(BackendFallbackWarning, match="portable"):
            fallback = NativeDcf(16, ck)
    assert not fallback.has_aesni
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_FAILED", set())
    with faults.inject("native.load"):
        with pytest.warns(BackendFallbackWarning):
            with pytest.raises(NativeBuildError):
                Dcf(2, 16, ck, backend="cpu", device="cpu")
        with pytest.raises(NativeBuildError):  # remembered, not rebuilt
            NativeDcf(16, ck)
