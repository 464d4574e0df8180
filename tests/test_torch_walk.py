"""Kernel B1's plain version (the port's WalkBackend on the CPU) against
dcf_tpu's Pallas walk kernel in interpret mode and its numpy oracle.

Same seeded numpy inputs through both packages, exact byte equality: both
parties, both bounds, all four groups, x = alpha planted, shared and
per-key points, a point count that forces padding.  The JAX side stays at
n_bytes = 2 (the interpret-mode graph is slow); the port also meets the
numpy oracle at n_bytes = 16."""

import numpy as np
import pytest
import torch

from dcf_tpu import spec as jspec
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.backends.pallas_backend import PallasBackend
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.gen import random_s0s
from dcf_tpu.ops.prg import HirosePrgNp as JPrg

from dcf_tpu_torch.backends.walk_backend import WalkBackend
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.walk_eval import aes_image, walk_eval, walk_eval_plain
from dcf_tpu_torch.utils.groups import np_group_add
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
                               group=jb.group)
    return rng, ck, alphas, betas, jb, tb


@pytest.mark.parametrize("group", GROUPS)
def test_walk_backend_matches_pallas_interpret(group):
    k_num, n_bytes, m = 2, 2, 45  # m forces padding (45 -> 64 points)
    for bound in (jspec.Bound.LT_BETA, jspec.Bound.GT_BETA):
        rng, ck, alphas, _, jb, tb = _setup(
            60 + GROUPS.index(group), k_num, n_bytes, group, bound)
        shared = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
        shared[:k_num] = alphas
        per_key = rng.integers(0, 256, (k_num, m, n_bytes), dtype=np.uint8)
        per_key[:, 0] = alphas
        jbe = PallasBackend(16, ck, interpret=True)
        tbe = WalkBackend(16, ck, device="cpu")
        for xs in (shared, per_key):
            for b in (0, 1):
                # Per-key points meet the interpret-mode kernel in two
                # groups (each is a fresh compile) and its numpy oracle in
                # the other two.
                if xs.ndim == 2 or group in ("xor", "add32"):
                    want = jbe.eval(b, xs, bundle=jb.for_party(b))
                else:
                    want = j_eval_np(JPrg(16, ck), b, jb.for_party(b), xs)
                got = tbe.eval(b, xs, bundle=tb.for_party(b))
                assert got.shape == (k_num, m, 16)
                assert np.array_equal(got, want), (bound, b, xs.ndim)


def test_walk_backend_matches_numpy_oracle_full_domain_width():
    """n_bytes = 16 (128 levels), as on the main path."""
    for group, bound in (("xor", jspec.Bound.LT_BETA),
                         ("add32", jspec.Bound.GT_BETA)):
        rng, ck, alphas, betas, jb, tb = _setup(70, 1, 16, group, bound)
        xs = rng.integers(0, 256, (64, 16), dtype=np.uint8)
        xs[0] = alphas[0]
        be = WalkBackend(16, ck, device="cpu")
        ys = []
        for b in (0, 1):
            got = be.eval(b, xs, bundle=tb.for_party(b))
            want = j_eval_np(JPrg(16, ck), b, jb.for_party(b), xs)
            assert np.array_equal(got, want), (group, b)
            ys.append(got)
        recon = np_group_add(ys[0], ys[1], group)[0]
        a = alphas[0].tobytes()
        for j in range(len(xs)):
            x = xs[j].tobytes()
            hit = x < a if bound is jspec.Bound.LT_BETA else x > a
            assert recon[j].tobytes() == (betas[0].tobytes() if hit
                                          else bytes(16))


@pytest.mark.parametrize("gt", [False, True])
def test_staged_path_and_mismatch_counter(gt):
    bound = jspec.Bound.GT_BETA if gt else jspec.Bound.LT_BETA
    rng, ck, alphas, betas, jb, tb = _setup(71, 1, 2, "xor", bound)
    xs = rng.integers(0, 256, (64, 2), dtype=np.uint8)  # two whole warps
    xs[0] = alphas[0]
    be0 = WalkBackend(16, ck, device="cpu")
    be1 = WalkBackend(16, ck, device="cpu")
    be0.put_bundle(tb.for_party(0))
    be1.put_bundle(tb.for_party(1))
    staged = be0.stage(xs)
    y0, y1 = be0.eval_staged(0, staged), be1.eval_staged(1, staged)
    assert isinstance(y0, torch.Tensor) and tuple(y0.shape) == (1, 64, 16)
    assert np.array_equal(be0.staged_to_bytes(y0, 64), be0.eval(0, xs))
    a, bt = alphas[0].tobytes(), betas[0].tobytes()
    assert int(be0.points_mismatch_count(y0, y1, a, bt, staged, gt=gt)) == 0
    wrong = bytes(x ^ 1 for x in bt)
    inside = sum((x.tobytes() > a) if gt else (x.tobytes() < a) for x in xs)
    assert int(be0.points_mismatch_count(y0, y1, a, wrong, staged,
                                         gt=gt)) == inside
    # The multi-key (array) form agrees on one key.
    assert int(be0.points_mismatch_count(y0, y1, alphas, betas, staged,
                                         gt=gt)) == 0


def test_multikey_additive_mismatch_counter():
    rng, ck, alphas, betas, jb, tb = _setup(72, 3, 2, "add16",
                                            jspec.Bound.LT_BETA)
    xs = rng.integers(0, 256, (32, 2), dtype=np.uint8)
    xs[:3] = alphas
    be = [WalkBackend(16, ck, device="cpu") for _ in (0, 1)]
    for b in (0, 1):
        be[b].put_bundle(tb.for_party(b))
    staged = be[0].stage(xs)
    y0, y1 = (be[b].eval_staged(b, staged) for b in (0, 1))
    assert int(be[0].points_mismatch_count(y0, y1, alphas, betas,
                                           staged)) == 0
    assert int(be[0].points_mismatch_count(y0, y1, alphas, betas ^ 1,
                                           staged)) > 0
    with pytest.raises(ShapeError):
        be[0].points_mismatch_count(y0, y1, alphas[0].tobytes(),
                                    betas[0].tobytes(), staged)


def test_walk_wrapper_runs_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version, and counts no
    kernel launch; bad tensors are refused typed."""
    rng, ck, alphas, _, jb, tb = _setup(73, 2, 2, "add8",
                                        jspec.Bound.LT_BETA)
    kb = tb.for_party(1)
    aes = torch.from_numpy(aes_image(ck[0]))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (kb.s0s[:, 0], kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)]
    xs = torch.from_numpy(rng.integers(0, 256, (1, 40, 2), dtype=np.uint8))
    before = walk_eval.launches
    got = walk_eval(aes, *args, xs, b=1, group="add8")
    assert walk_eval.launches == before
    assert torch.equal(got, walk_eval_plain(aes, *args, xs, b=1,
                                            group="add8"))
    with pytest.raises(ShapeError):
        walk_eval(aes, *args, xs.to(torch.int16), b=1, group="add8")
    with pytest.raises(ShapeError):
        walk_eval(aes[:100], *args, xs, b=1, group="add8")
    with pytest.raises(ShapeError):
        walk_eval(aes, *args, xs[:, :, :1], b=1, group="add8")


def test_walk_backend_contract():
    rng, ck, alphas, _, jb, tb = _setup(74, 1, 2, "xor",
                                        jspec.Bound.LT_BETA)
    be = WalkBackend(16, ck, device="cpu")
    with pytest.raises(StaleStateError):
        be.eval(0, np.zeros((4, 2), np.uint8))
    with pytest.raises(ShapeError):
        be.put_bundle(tb)  # not party-restricted
    with pytest.raises(ValueError, match="hybrid"):
        WalkBackend(48, ck * 9, device="cpu")
    be.put_bundle(tb.for_party(0))
    assert be.eval(0, np.zeros((0, 2), np.uint8)).shape == (1, 0, 16)
    with pytest.raises(ShapeError):
        be.stage(np.zeros((0, 2), np.uint8))
    with pytest.raises(ShapeError):
        be.eval(0, np.zeros((4, 3), np.uint8))
