"""The port's large-lambda hybrid on the CPU against dcf_tpu's.

Kernels B4 (narrow walk) and W1 (GF(2) wide tail) run their plain PyTorch
versions here; the port's LargeLambdaBackend (``device="cpu"``) is held
byte for byte against dcf_tpu's LargeLambdaBackend with the Pallas narrow
kernel in interpret mode and against dcf_tpu's full-width numpy oracle,
with the same seeded numpy inputs: lam in {48, 144, 2048}, both parties,
both bounds, K in {1, 3}, x = alpha and alpha +- 1 planted, a point count
that forces padding.  The host halves (narrow_walk_np, the basis-probed
wide_affine_batch_np, the unmasked PRG, the node enumeration) are held
against their JAX counterparts, and the facade's routing and refusals are
pinned.  Tolerance: exact equality (integer cryptography)."""

import warnings

import numpy as np
import pytest
import torch

from dcf_tpu import spec as jspec
from dcf_tpu.backends import large_lambda as jll
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.gen import random_s0s
from dcf_tpu.ops.prg import HirosePrgNp as JPrg

from dcf_tpu_torch import BackendUnavailableError, Bound, Dcf
from dcf_tpu_torch.backends import large_lambda as tll
from dcf_tpu_torch.backends.large_lambda import LargeLambdaBackend
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.gen import gen_batch as t_gen_batch
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.hybrid_prefix import node_prefix_xs
from dcf_tpu_torch.ops.narrow_walk import (
    narrow_aes_image,
    narrow_walk,
    pack_traj_plain,
    unpack_traj_plain,
)
from dcf_tpu_torch.ops.prg import HirosePrgNp as TPrg
from dcf_tpu_torch.ops.wide_tail import wide_tail
from tests.torch_threads import one_torch_thread  # noqa: F401

LAMS = (48, 144, 2048)



def _setup(seed, lam, k_num, bound, n_bytes=2, m=37):
    """A dcf_tpu bundle at lam carried into the port, and points with
    x = alpha and alpha +- 1 planted for every key."""
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


@pytest.mark.parametrize("lam", LAMS)
def test_host_half_matches_dcf_tpu(lam):
    """narrow_walk_np, wide_affine_batch_np (also against the JAX
    single-key form), the unmasked narrow PRG and the node enumeration,
    byte for byte."""
    ck, _, _, _, jb, tb, xs = _setup(400 + lam, lam, 3, Bound.LT_BETA)
    for b in (0, 1):
        jkb, tkb = jb.for_party(b), tb.for_party(b)
        got = tll.wide_affine_batch_np(tkb)
        for g, want in zip(got, jll.wide_affine_batch_np(jkb)):
            assert np.array_equal(g, want), b
        for g, want in zip(got, jll.wide_affine_np(jkb)):
            assert np.array_equal(g[0], want), b
        for got, want in zip(tll.narrow_walk_np(ck, tkb, b, xs),
                             jll.narrow_walk_np(ck, jkb, b, xs)):
            assert np.array_equal(got, want), b
    seeds = np.random.default_rng(lam).integers(0, 256, (5, 32),
                                                dtype=np.uint8)
    jo = JPrg(32, ck, mask=False, warn=False).gen(seeds)
    to = TPrg(32, ck, mask=False, warn=False).gen(seeds)
    for f in ("s_l", "v_l", "t_l", "s_r", "v_r", "t_r"):
        assert np.array_equal(getattr(to, f), getattr(jo, f)), f
    assert not np.array_equal(to.s_l, TPrg(32, ck, warn=False).gen(seeds).s_l)
    for k, nb in ((5, 2), (7, 3)):
        assert np.array_equal(node_prefix_xs(k, nb),
                              jll._node_prefix_xs(k, nb))
    assert tll.HYBRID_MAX_PREFIX_LEVELS == jll.HYBRID_MAX_PREFIX_LEVELS


@pytest.mark.parametrize("k_num,bound", [(1, Bound.LT_BETA),
                                         (3, Bound.GT_BETA)])
def test_backend_matches_pallas_interpret(k_num, bound):
    """From the root: the port's B4 + W1 (plain) against dcf_tpu's Pallas
    narrow kernel (interpret mode) + XLA wide tail, both parties."""
    ck, _, _, _, jb, tb, xs = _setup(410 + k_num, 144, k_num, bound)
    jbe = jll.LargeLambdaBackend(144, ck, narrow="pallas", interpret=True)
    tbe = LargeLambdaBackend(144, ck, device="cpu")
    for b in (0, 1):
        want = jbe.eval(b, xs, bundle=jb.for_party(b))
        got = tbe.eval(b, xs, bundle=tb.for_party(b))
        assert got.shape == (k_num, xs.shape[0], 144)
        assert np.array_equal(got, want), b


@pytest.mark.parametrize("k_num", [1, 3])
@pytest.mark.parametrize("lam", LAMS)
def test_backend_matches_oracle(lam, k_num):
    """From the root against dcf_tpu's full-width numpy oracle, both
    parties and both bounds; then the on-device two-party check."""
    for bound in Bound:
        ck, jprg, alphas, betas, jb, tb, xs = _setup(
            420 + lam + k_num, lam, k_num, bound)
        bes = [LargeLambdaBackend(lam, ck, device="cpu") for _ in (0, 1)]
        ys = []
        for b in (0, 1):
            got = bes[b].eval(b, xs, bundle=tb.for_party(b))
            want = j_eval_np(jprg, b, jb.for_party(b), xs)
            assert np.array_equal(got, want), (bound, b)
            ys.append(bes[b].eval_staged(b, bes[0].stage(xs)))
        staged = bes[0].stage(xs)
        gt = bound is Bound.GT_BETA
        assert int(bes[0].points_mismatch_count(
            ys[0], ys[1], alphas, betas, staged, gt=gt)) == 0
        assert int(bes[0].points_mismatch_count(
            ys[0], ys[1], alphas, betas ^ 1, staged, gt=gt)) > 0


def test_kernel_wrappers_against_host_halves():
    """The B4 and W1 wrappers (plain on the CPU) against the port's
    narrow_walk_np and wide affine form, at n = 32 (the final bit opens a
    second trajectory word); the trajectory packing round-trips."""
    lam, n_bytes = 144, 4
    ck, _, _, _, _, tb, xs = _setup(430, lam, 1, Bound.GT_BETA,
                                    n_bytes=n_bytes, m=40)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    for b in (0, 1):
        kb = tb.for_party(b)
        arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            kb.s0s[:, 0, :32], kb.cw_s[..., :32], kb.cw_v[..., :32],
            kb.cw_t, kb.cw_np1[:, :32])]
        y, traj = narrow_walk(aes, *arrays, torch.from_numpy(xs[None]), b=b,
                              lam=lam)
        want_y, want_t = tll.narrow_walk_np(ck, kb, b, xs)
        assert traj.shape == (1, 40, 8)
        assert np.array_equal(y[0, :, :32].numpy(), want_y)
        bits = unpack_traj_plain(traj, 33)
        assert np.array_equal(bits[0].numpy(), want_t)
        assert torch.equal(pack_traj_plain(bits), traj)
        const, w = (torch.from_numpy(a) for a in tll.wide_affine_batch_np(kb))
        out = wide_tail(y, traj, const, w)
        assert out is y  # filled in place
        want = const.numpy()[0] ^ np.bitwise_xor.reduce(
            w.numpy()[0][None] * want_t[:, :, None], axis=1)
        assert np.array_equal(y[0, :, 32:].numpy(), want)


@pytest.mark.parametrize("lam", [48, 144, 256, 2048])
def test_carried_bundle_takes_any_lam(lam):
    """KeyBundle.from_arrays carries a dcf_tpu bundle at any lam; at lam =
    144 the port's own keygen gives the same bytes and the carried bundle
    evaluates to dcf_tpu's bytes."""
    ck, jprg, alphas, betas, jb, tb, xs = _setup(440 + lam, lam, 2,
                                                 Bound.LT_BETA)
    assert tb.lam == lam and tb.num_keys == 2
    for f in ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1"):
        assert np.array_equal(getattr(tb, f), getattr(jb, f))
    if lam != 144:
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        own = t_gen_batch(TPrg(lam, ck), alphas, betas, jb.s0s,
                          Bound.LT_BETA)
    for f in ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1"):
        assert np.array_equal(getattr(own, f), getattr(jb, f))
    dcf = Dcf(2, lam, ck, device="cpu")
    for b in (0, 1):
        assert np.array_equal(dcf.eval(b, tb, xs),
                              j_eval_np(jprg, b, jb.for_party(b), xs))


def test_facade_routing():
    """auto is walk at lam = 16 and 32 and hybrid at lam >= 48; hybrid
    at lam = 32 and the other mismatches raise, naming why."""
    ck = [bytes([i]) * 32 for i in range(32)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert Dcf(2, 16, ck, device="cpu").backend_name == "walk"
        for lam in (48, 144, 256, 2048):
            dcf = Dcf(2, lam, ck, device="cpu")
            assert dcf.backend_name == "hybrid"
            assert isinstance(dcf.eval_backend(0), LargeLambdaBackend)
        dcf = Dcf(2, 256, ck, backend_opts={"prefix_levels": 6},
                  device="cpu")
        assert dcf.eval_backend(1).prefix_levels == 6
        with pytest.raises(ValueError, match="lam >= 48.*use walk"):
            Dcf(2, 32, ck, backend="hybrid", device="cpu")
        assert Dcf(2, 32, ck, device="cpu").gen(
            np.zeros((1, 2), np.uint8), np.zeros((1, 32), np.uint8),
            rng=np.random.default_rng(0)).lam == 32
        for name, match in (("walk", "lam=16 and lam=32"),
                            ("prefix", "lam=16 only")):
            with pytest.raises(ValueError, match=f"{match}.*use hybrid"):
                Dcf(2, 256, ck, backend=name, device="cpu")
        with pytest.raises(ValueError, match="lam >= 48"):
            Dcf(2, 16, ck, backend="hybrid", device="cpu")
        with pytest.raises(ValueError, match="multiple of 16"):
            Dcf(2, 40, ck, device="cpu")


@pytest.mark.parametrize("opt", ["col_chunk", "narrow", "interpret",
                                 "host_levels", "tile_words"])
def test_facade_refuses_jax_backend_opts(opt):
    ck = [bytes([i]) * 32 for i in range(32)]
    with pytest.raises(ValueError, match=repr(opt)):
        Dcf(2, 256, ck, backend_opts={opt: 1}, device="cpu")


def test_facade_refuses_additive_groups_and_per_key_points():
    rng = np.random.default_rng(450)
    ck = [rng.bytes(32) for _ in range(18)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcf = Dcf(2, 144, ck, device="cpu")
    alphas = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 144), dtype=np.uint8)
    add = dcf.gen(alphas, betas, rng=rng, group="add16")
    with pytest.raises(ShapeError, match="XOR-only"):
        dcf.eval(0, add, rng.integers(0, 256, (8, 2), dtype=np.uint8))
    xor = dcf.gen(alphas, betas, rng=rng)
    with pytest.raises(ShapeError, match="shared points"):
        dcf.eval(0, xor, rng.integers(0, 256, (2, 8, 2), dtype=np.uint8))
    with pytest.raises(ShapeError, match="party-restricted"):
        dcf.eval_backend(0).put_bundle(xor)


def test_hybrid_defaults_to_cuda(monkeypatch):
    """Dcf(16, 256, keys) is a hybrid on the card: without CUDA it raises
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = [bytes([i]) * 32 for i in range(32)]
    with pytest.raises(BackendUnavailableError, match="CUDA"):
        Dcf(16, 256, ck)
    with pytest.raises(BackendUnavailableError):
        LargeLambdaBackend(256, ck)
    assert Dcf(16, 256, ck, device="cpu").device.type == "cpu"
