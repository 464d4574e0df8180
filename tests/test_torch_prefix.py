"""Kernels B2 + B3's plain versions (the port's PrefixBackend on the CPU)
against dcf_tpu's PrefixPallasBackend in interpret mode and its numpy
oracle.  Exact byte equality, both parties, both bounds, x = alpha
planted; the staged-geometry guard raises StaleStateError on drift."""

import numpy as np
import pytest

from dcf_tpu import spec as jspec
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.backends.pallas_prefix import PrefixPallasBackend
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.gen import random_s0s
from dcf_tpu.ops.prg import HirosePrgNp as JPrg

from dcf_tpu_torch.backends.prefix_backend import PrefixBackend
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from tests.torch_threads import one_torch_thread  # noqa: F401

GROUPS = ("xor", "add8", "add16", "add32")


def _setup(seed, k_num, n_bytes, group, bound):
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32), rng.bytes(32)]
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, 16), dtype=np.uint8)
    jb = j_gen_batch(JPrg(16, ck), alphas, betas,
                     random_s0s(k_num, 16, rng), bound, group=group)
    tb = KeyBundle.from_arrays(jb.s0s, jb.cw_s, jb.cw_v, jb.cw_t, jb.cw_np1,
                               group=group)
    return rng, ck, alphas, betas, jb, tb


@pytest.mark.parametrize("k_num,group", [(1, "xor"), (2, "add16")])
def test_prefix_backend_matches_pallas_interpret(k_num, group):
    for bound in (jspec.Bound.LT_BETA, jspec.Bound.GT_BETA):
        rng, ck, alphas, _, jb, tb = _setup(100 + k_num, k_num, 2, group, bound)
        xs = rng.integers(0, 256, (37, 2), dtype=np.uint8)  # ragged m
        xs[:k_num] = alphas
        xs[k_num] = 0
        xs[k_num + 1] = 255
        jbe = PrefixPallasBackend(16, ck, interpret=True, tile_words=2)
        tbe = PrefixBackend(16, ck, device="cpu")
        for b in (0, 1):
            want = jbe.eval(b, xs, bundle=jb.for_party(b))
            got = tbe.eval(b, xs, bundle=tb.for_party(b))
            assert tbe._k() == jbe._k() == 8
            assert np.array_equal(got, want), (bound, b)


@pytest.mark.parametrize("group", GROUPS)
def test_prefix_backend_matches_numpy_oracle_n128(group):
    bound = jspec.Bound.GT_BETA if group in ("add8", "add32") \
        else jspec.Bound.LT_BETA
    rng, ck, alphas, _, jb, tb = _setup(110 + GROUPS.index(group), 1, 16,
                                     group, bound)
    xs = rng.integers(0, 256, (48, 16), dtype=np.uint8)
    xs[0] = alphas[0]
    be = PrefixBackend(16, ck, prefix_levels=8, device="cpu")
    for b in (0, 1):
        got = be.eval(b, xs, bundle=tb.for_party(b))
        assert be._k() == 8
        want = j_eval_np(JPrg(16, ck), b, jb.for_party(b), xs)
        assert np.array_equal(got, want), b


def test_frontier_cached_per_party_and_staged_counter():
    rng, ck, alphas, betas, jb, tb = _setup(120, 1, 2, "xor",
                                            jspec.Bound.LT_BETA)
    xs = rng.integers(0, 256, (64, 2), dtype=np.uint8)
    be0 = PrefixBackend(16, ck, device="cpu")
    be1 = PrefixBackend(16, ck, device="cpu")
    be0.put_bundle(tb.for_party(0))
    be1.put_bundle(tb.for_party(1))
    staged = be0.stage(xs)
    y0 = be0.eval_staged(0, staged)
    table = be0._frontier[0]
    assert table.shape == (1 << 8, 32)
    y0b = be0.eval_staged(0, staged)
    assert be0._frontier[0] is table  # built once, reused
    assert np.array_equal(y0.numpy(), y0b.numpy())
    y1 = be1.eval_staged(1, staged)  # the other party's instance, same dict
    a = alphas[0].tobytes()
    assert int(be0.points_mismatch_count(y0, y1, a, betas[0].tobytes(),
                                         staged)) == 0
    be0.put_bundle(tb.for_party(0))  # a new key image drops the frontier
    assert be0._frontier == {}


def test_stale_staging_raises():
    """Points staged for one (k, n) geometry are refused after put_bundle
    changes it: a deeper domain, or a key count that lowers k."""
    rng, ck, _, _, _, tb2 = _setup(130, 1, 2, "xor", jspec.Bound.LT_BETA)
    _, _, _, _, _, tb3 = _setup(131, 1, 3, "xor", jspec.Bound.LT_BETA)
    be = PrefixBackend(16, ck, device="cpu")
    be.put_bundle(tb2.for_party(0))
    staged = be.stage(rng.integers(0, 256, (8, 2), dtype=np.uint8))
    be.put_bundle(tb3.for_party(0))
    with pytest.raises(StaleStateError, match="stale"):
        be.eval_staged(0, staged)
    # k = 21 for one key over a 32-level domain, 20 for two keys.
    _, _, _, _, _, one = _setup(132, 1, 4, "xor", jspec.Bound.LT_BETA)
    _, _, _, _, _, two = _setup(133, 2, 4, "xor", jspec.Bound.LT_BETA)
    be.put_bundle(one.for_party(0))
    assert be._k() == 21
    staged = be.stage(rng.integers(0, 256, (8, 4), dtype=np.uint8))
    be.put_bundle(two.for_party(0))
    assert be._k() == 20
    with pytest.raises(StaleStateError):
        be.eval_staged(0, staged)
    with pytest.raises(ValueError, match="not from a prefix"):
        be.eval_staged(0, {"xs": staged["xs"], "m": 8})


def test_prefix_backend_validation():
    rng, ck, _, _, _, tb = _setup(140, 2, 2, "xor", jspec.Bound.LT_BETA)
    be = PrefixBackend(16, ck, device="cpu")
    be.put_bundle(tb.for_party(0))
    with pytest.raises(ShapeError, match="shared points"):
        be.eval(0, rng.integers(0, 256, (2, 5, 2), dtype=np.uint8))
    _, _, _, _, _, shallow = _setup(141, 1, 1, "xor", jspec.Bound.LT_BETA)
    with pytest.raises(ShapeError, match="too shallow"):
        be.put_bundle(shallow.for_party(0))
    with pytest.raises(ValueError, match="host_levels"):
        PrefixBackend(16, ck, prefix_levels=4, host_levels=6, device="cpu")
