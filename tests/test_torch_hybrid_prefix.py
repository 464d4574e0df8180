"""The port's prefix-shared hybrid on the CPU against dcf_tpu's.

Kernels B5a (frontier build), B5b (gather + levels k..n-1) and W1 run their
plain PyTorch versions here.  The port's LargeLambdaBackend with
``prefix_levels`` is held byte for byte against dcf_tpu's
``LargeLambdaBackend(144, ck, prefix_levels=6, interpret=True)`` -- its
shares and its frontier tables, which dcf_tpu builds with
``narrow_state_walk_pallas`` (interpret mode) and which this test decodes
to bytes -- and against dcf_tpu's full-width numpy oracle over lam in
{48, 144, 2048}, both parties, both bounds, K in {1, 3}, x = alpha and
alpha +- 1 planted.  The staged-geometry guard (StaleStateError) and the
prefix-depth clamps are pinned.  Tolerance: exact equality."""

import warnings

import numpy as np
import pytest

from dcf_tpu import spec as jspec
from dcf_tpu.backends import large_lambda as jll
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.gen import random_s0s
from dcf_tpu.ops.prg import HirosePrgNp as JPrg

from dcf_tpu_torch import Bound
from dcf_tpu_torch.backends.large_lambda import LargeLambdaBackend
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from tests.torch_threads import one_torch_thread  # noqa: F401



def _setup(seed, lam, k_num, bound, n_bytes=2, m=37):
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jspec.ReferenceContractWarning)
        jprg = JPrg(lam, ck)
    jb = j_gen_batch(jprg, alphas, betas, random_s0s(k_num, lam, rng),
                     getattr(jspec.Bound, bound.name))
    tb = KeyBundle.from_arrays(jb.s0s, jb.cw_s, jb.cw_v, jb.cw_t, jb.cw_np1)
    xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
    top = 1 << (8 * n_bytes)
    for j, a in enumerate(alphas):
        a = int.from_bytes(a.tobytes(), "big")
        for d in (-1, 0, 1):
            xs[3 * j + d + 1] = np.frombuffer(
                ((a + d) % top).to_bytes(n_bytes, "big"), np.uint8)
    return ck, jprg, alphas, betas, jb, tb, xs


def _backend(lam, ck, prefix_levels=6):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return LargeLambdaBackend(lam, ck, prefix_levels=prefix_levels,
                                  device="cpu")


@pytest.mark.parametrize("k_num,bound", [(1, Bound.LT_BETA),
                                         (3, Bound.GT_BETA)])
def test_prefix_matches_pallas_interpret(k_num, bound):
    """Shares and the depth-k frontier (64-byte rows and trajectory words)
    against dcf_tpu's prefix hybrid, both parties."""
    ck, _, _, _, jb, tb, xs = _setup(500 + k_num, 144, k_num, bound)
    jbe = jll.LargeLambdaBackend(144, ck, prefix_levels=6, interpret=True)
    tbe = _backend(144, ck)
    for b in (0, 1):
        want = jbe.eval(b, xs, bundle=jb.for_party(b))
        got = tbe.eval(b, xs, bundle=tb.for_party(b))
        assert tbe._k() == jbe._k() == 6
        assert np.array_equal(got, want), b
        state_tbl, traj_words = jbe._frontier[b]
        rows, words = tbe._frontier[b]
        # dcf_tpu's rows are int32 [K, 2^k, 16] columns sa|sb|va|vb, each
        # the little-endian word of four state bytes.
        want_rows = np.asarray(state_tbl).astype("<i4").view(np.uint8)
        assert np.array_equal(rows.numpy(), want_rows.reshape(-1, 64)), b
        want_words = np.asarray(traj_words).astype("<u4").view(np.uint8)
        assert np.array_equal(words.numpy(), want_words.reshape(-1, 4)), b


@pytest.mark.parametrize("k_num", [1, 3])
@pytest.mark.parametrize("lam", [48, 144, 2048])
def test_prefix_matches_oracle(lam, k_num):
    """Against dcf_tpu's full-width numpy oracle, both parties, both
    bounds, one staged dict shared by both parties' backends; then the
    on-device two-party check."""
    for bound in Bound:
        ck, jprg, alphas, betas, jb, tb, xs = _setup(
            510 + lam + k_num, lam, k_num, bound)
        bes = [_backend(lam, ck) for _ in (0, 1)]
        for b in (0, 1):
            got = bes[b].eval(b, xs, bundle=tb.for_party(b))
            want = j_eval_np(jprg, b, jb.for_party(b), xs)
            assert np.array_equal(got, want), (bound, b)
        staged = bes[0].stage(xs)
        ys = [bes[b].eval_staged(b, staged) for b in (0, 1)]
        assert int(bes[0].points_mismatch_count(
            ys[0], ys[1], alphas, betas, staged,
            gt=bound is Bound.GT_BETA)) == 0


def test_frontier_cached_per_party():
    ck, _, _, _, _, tb, xs = _setup(520, 144, 1, Bound.LT_BETA)
    be = _backend(144, ck)
    be.put_bundle(tb.for_party(0))
    staged = be.stage(xs)
    y0 = be.eval_staged(0, staged)
    rows, words = be._frontier[0]
    assert rows.shape == (1 << 6, 64) and words.shape == (1 << 6, 4)
    assert be._frontier[0][0] is rows
    assert np.array_equal(be.eval_staged(0, staged).numpy(), y0.numpy())
    assert be._frontier[0][0] is rows  # built once, reused
    be.put_bundle(tb.for_party(1))  # a new key image drops the frontier
    assert be._frontier == {}


def test_stale_staging_raises():
    """Points staged for one (k, n) geometry are refused after put_bundle
    changes it; a from-root backend's staged dict is refused by name."""
    ck, _, _, _, _, tb2, xs2 = _setup(530, 144, 1, Bound.LT_BETA)
    _, _, _, _, _, tb3, _ = _setup(531, 144, 1, Bound.LT_BETA, n_bytes=3)
    be = _backend(144, ck)
    be.put_bundle(tb2.for_party(0))
    staged = be.stage(xs2)
    assert (staged["k"], staged["n"]) == (6, 16)
    be.put_bundle(tb2.for_party(0))  # same geometry: still valid
    be.eval_staged(0, staged)
    be.put_bundle(tb3.for_party(0))
    with pytest.raises(StaleStateError, match="re-stage"):
        be.eval_staged(0, staged)
    # A key count that lowers k: 1 key -> k = 20, 3 keys -> k = 18.
    _, _, _, _, _, one, _ = _setup(532, 144, 1, Bound.LT_BETA, n_bytes=4)
    _, _, _, _, _, three, _ = _setup(533, 144, 3, Bound.LT_BETA, n_bytes=4)
    deep = _backend(144, ck, prefix_levels=20)
    deep.put_bundle(one.for_party(0))
    staged = deep.stage(np.zeros((8, 4), np.uint8))
    deep.put_bundle(three.for_party(0))
    with pytest.raises(StaleStateError):
        deep.eval_staged(0, staged)
    root = _backend(144, ck, prefix_levels=0)
    root.put_bundle(tb2.for_party(0))
    be.put_bundle(tb2.for_party(0))
    with pytest.raises(ValueError, match="prefix-enabled"):
        be.eval_staged(0, root.stage(xs2))


@pytest.mark.parametrize("prefix_levels,k_num,n_bytes", [
    (20, 1, 2), (20, 9, 4), (20, 1, 4), (6, 3, 4), (5, 1, 2), (25, 1, 16)])
def test_k_clamps_match_dcf_tpu(prefix_levels, k_num, n_bytes):
    """_k(): at least 8 walked levels, the cap shrinks with ceil(log2 K),
    prefix_levels clamped to HYBRID_MAX_PREFIX_LEVELS, floor 5 -- the
    same depth as dcf_tpu's."""
    ck, _, _, _, jb, tb, _ = _setup(540, 144, k_num, Bound.LT_BETA,
                                    n_bytes=n_bytes, m=30)
    jbe = jll.LargeLambdaBackend(144, ck, prefix_levels=prefix_levels,
                                 interpret=True)
    tbe = _backend(144, ck, prefix_levels=prefix_levels)
    jbe.put_bundle(jb.for_party(0))
    tbe.put_bundle(tb.for_party(0))
    assert tbe._k() == jbe._k()
    assert tbe.prefix_levels == jbe.prefix_levels


def test_prefix_validation():
    ck = [bytes([i]) * 32 for i in range(18)]
    with pytest.raises(ValueError, match="prefix_levels"):
        _backend(144, ck, prefix_levels=3)
    with pytest.raises(ValueError, match="lam >= 48"):
        _backend(32, ck)
    ck, _, _, _, _, shallow, _ = _setup(550, 144, 1, Bound.LT_BETA,
                                        n_bytes=1, m=9)
    be = _backend(144, ck)
    with pytest.raises(ShapeError, match="too shallow"):
        be.put_bundle(shallow.for_party(0))
    with pytest.raises(StaleStateError, match="put_bundle"):
        be.stage(np.zeros((4, 1), np.uint8))
