"""The port's full-domain path at lam = 16 on the CPU against dcf_tpu's:
``tree_expand_device`` (kernels B2 and B2f as their plain versions)
against ``dcf_tpu.ops.pallas_tree.tree_expand_device`` in interpret mode,
``TreeFullDomain`` against dcf_tpu's (leaves, the clean and the tampered
check, both bounds), and the per-point pair (``stage_range``,
``mismatch_count``, ``full_domain_check_device``) against the host
``full_domain_check`` of both packages.  The same seeded numpy keys go
through both; tolerance: exact byte equality and equal counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcf_tpu import spec as jspec
from dcf_tpu.backends.fulldomain import TreeFullDomain as JTreeFullDomain
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.ops.aes_bitsliced import round_key_masks_bitmajor
from dcf_tpu.ops.pallas_tree import tree_expand_device as j_tree_device
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.utils.bits import (
    bitmajor_perm,
    bitmajor_plane_masks,
    byte_bits_lsb,
    pack_lanes,
    planes_to_bytes,
)
from dcf_tpu.workloads import domain_points as j_domain_points
from dcf_tpu.workloads import full_domain_check as j_full_domain_check

from dcf_tpu_torch.backends._common import bitrev_values
from dcf_tpu_torch.backends.fulldomain import (
    TreeFullDomain,
    leaf_mismatch_count,
    tree_expand_np,
)
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
from dcf_tpu_torch.backends.walk_backend import WalkBackend
from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    ShapeError,
    StaleStateError,
)
from dcf_tpu_torch.gen import random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp as TPrg
from dcf_tpu_torch.ops.tree_expand import (
    tree_expand_device,
    tree_expand_final,
    tree_expand_final_plain,
)
from dcf_tpu_torch.ops.walk_eval import aes_image
from dcf_tpu_torch.workloads.core import (
    domain_points,
    full_domain_check,
    full_domain_check_device,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

BOUNDS = ("LT_BETA", "GT_BETA")
_PERM = bitmajor_perm(16)
FIELDS = ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1")


def _setup(seed, alpha, n_bits, bound, group="xor"):
    """One key as a dcf_tpu bundle and carried into the port."""
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32), rng.bytes(32)]
    beta = rng.integers(0, 256, (1, 16), dtype=np.uint8)
    jb = j_gen_batch(
        JPrg(16, ck),
        np.frombuffer(alpha.to_bytes(n_bits // 8, "big"), np.uint8)[None],
        beta, random_s0s(1, 16, rng), getattr(jspec.Bound, bound),
        group=group)
    tb = KeyBundle.from_arrays(*(getattr(jb, f) for f in FIELDS),
                               group=group)
    return ck, beta[0].tobytes(), jb, tb


def _planes(a):  # uint8 [N, 16] -> int32 bit-major planes [128, N/32]
    bits = byte_bits_lsb(a)[:, _PERM]
    return jnp.asarray(pack_lanes(np.ascontiguousarray(bits.T)).view(np.int32))


def _leaf_bytes(planes):  # int32 bit-major planes [128, W] -> [32W, 16]
    return planes_to_bytes(
        np.asarray(planes).view(np.uint32)[np.argsort(_PERM)], 16)


@pytest.mark.parametrize("k0", [5, 7])
@pytest.mark.parametrize("bound", BOUNDS)
def test_tree_expand_device_matches_pallas_interpret(bound, k0):
    """Levels k0..7 and the leaf finalize of an n = 8 key: the port's
    plain B2 / B2f against the Pallas tree kernel, both parties."""
    n = 8
    ck, _, jb, tb = _setup(600 + k0, 0x9D, n, bound)
    rk = jnp.asarray(round_key_masks_bitmajor(ck[0]))
    aes = torch.from_numpy(aes_image(ck[0]))
    for b in (0, 1):
        jkb, tkb = jb.for_party(b), tb.for_party(b)
        s, v, t = tree_expand_np(TPrg(16, ck), tkb, b, k0)
        want = j_tree_device(
            rk, jnp.asarray(bitmajor_plane_masks(jkb.cw_s[0])[..., None]),
            jnp.asarray(bitmajor_plane_masks(jkb.cw_v[0])[..., None]),
            jnp.asarray(jkb.cw_t[0].astype(np.int32) * -1),
            jnp.asarray(bitmajor_plane_masks(jkb.cw_np1[0])[:, None]),
            _planes(s), _planes(v),
            jnp.asarray(pack_lanes(t[None]).view(np.int32)),
            k0=k0, n=n, interpret=True)
        got = tree_expand_device(
            aes, *(torch.from_numpy(np.ascontiguousarray(a[0])) for a in (
                tkb.cw_s, tkb.cw_v, tkb.cw_t, tkb.cw_np1)),
            torch.from_numpy(s), torch.from_numpy(v), torch.from_numpy(t),
            k0=k0, n=n)
        assert got.shape == (1 << n, 16)
        assert np.array_equal(got.numpy(), _leaf_bytes(want)), b


@pytest.mark.parametrize("bound", BOUNDS)
def test_leaf_launch_of_one_to_three_levels_matches_pallas_interpret(
        bound, monkeypatch):
    """B2f's launch may take the tree's last 1-3 levels
    (``FINAL_LEVELS``): ``tree_expand_device`` from k0 = 3 of an n = 8
    key gives the Pallas tree kernel's leaves at each cut, both parties,
    and ``tree_expand_final`` on the last d levels' correction words
    equals d - 1 levels of B2 and one of B2f."""
    import dcf_tpu_torch.ops.tree_expand as te

    n, k0 = 8, 3
    ck, _, jb, tb = _setup(610, 0x3C, n, bound)
    rk = jnp.asarray(round_key_masks_bitmajor(ck[0]))
    aes = torch.from_numpy(aes_image(ck[0]))
    for b in (0, 1):
        jkb, tkb = jb.for_party(b), tb.for_party(b)
        s, v, t = tree_expand_np(TPrg(16, ck), tkb, b, 5)
        want = _leaf_bytes(j_tree_device(
            rk, jnp.asarray(bitmajor_plane_masks(jkb.cw_s[0])[..., None]),
            jnp.asarray(bitmajor_plane_masks(jkb.cw_v[0])[..., None]),
            jnp.asarray(jkb.cw_t[0].astype(np.int32) * -1),
            jnp.asarray(bitmajor_plane_masks(jkb.cw_np1[0])[:, None]),
            _planes(s), _planes(v),
            jnp.asarray(pack_lanes(t[None]).view(np.int32)),
            k0=5, n=n, interpret=True))
        cws = [torch.from_numpy(np.ascontiguousarray(a[0])) for a in (
            tkb.cw_s, tkb.cw_v, tkb.cw_t, tkb.cw_np1)]
        top = [torch.from_numpy(a)
               for a in tree_expand_np(TPrg(16, ck), tkb, b, k0)]
        for levels in (1, 2, 3):
            monkeypatch.setattr(te, "FINAL_LEVELS", levels)
            got = tree_expand_device(aes, *cws, *top, k0=k0, n=n)
            assert np.array_equal(got.numpy(), want), (b, levels)
            nodes = te.tree_expand(aes, *cws[:3], *top, k0=k0,
                                   k1=n - levels, group="xor")
            last = [c[n - levels:] for c in cws[:3]]
            assert torch.equal(
                tree_expand_final(aes, *last, cws[3], *nodes), got)
            assert torch.equal(
                tree_expand_final_plain(aes, *last, cws[3], *nodes), got)


@pytest.mark.parametrize("bound", BOUNDS)
def test_tree_fulldomain_matches_dcf_tpu_n8(bound):
    """Leaves and check counts of both evaluators on one key (the JAX one
    through its kernel in interpret mode)."""
    alpha, gt = 0x6B, bound == "GT_BETA"
    ck, beta, jb, tb = _setup(610, alpha, 8, bound)
    jfd = JTreeFullDomain(16, ck, host_levels=5, interpret=True)
    tfd = TreeFullDomain(16, ck, host_levels=5, device="cpu")
    for b in (0, 1):
        want = _leaf_bytes(jfd.eval_party(b, jb.for_party(b), 8))
        got = tfd.eval_party(b, tb.for_party(b), 8)
        assert np.array_equal(got.numpy(), want), b
    for shift in (0, 7, -3):
        assert tfd.check(tb, alpha + shift, beta, 8, gt) == abs(shift)
        assert jfd.check(jb, alpha + shift, beta, n_bits=8, gt=gt) \
            == abs(shift)
    assert tfd.check(tb, alpha, beta, 8, not gt) > 200  # the wrong bound


@pytest.mark.parametrize("bound", BOUNDS)
def test_tree_fulldomain_check_n16(bound):
    """The tamper control of dcf_tpu's own test, at its size: a shifted
    alpha flips exactly that many leaves."""
    alpha, gt = 0x51C3, bound == "GT_BETA"
    ck, beta, _, tb = _setup(92, alpha, 16, bound)
    fd = TreeFullDomain(16, ck, host_levels=8, device="cpu")
    assert fd.check(tb, alpha, beta, 16, gt) == 0
    assert fd.check(tb, alpha + 7, beta, 16, gt) == 7
    count = fd.check_device(tb, alpha, beta, 16, gt)
    assert isinstance(count, torch.Tensor) and count.dim() == 0


@pytest.mark.parametrize("host_levels", [0, 3, 12])
def test_leaves_match_the_numpy_oracle_for_any_host_split(host_levels):
    """Leaf p of either party is the oracle's share of domain point
    bitreverse(p), wherever the host's levels end."""
    ck, _, _, tb = _setup(620, 0xA7, 8, "LT_BETA")
    fd = TreeFullDomain(16, ck, host_levels=host_levels, device="cpu")
    value = bitrev_values(8, "cpu").numpy()
    xs = domain_points(1, 0, 1 << 8)[value]
    for b in (0, 1):
        kb = tb.for_party(b)
        got = fd.eval_party(b, kb, 8).numpy()
        assert np.array_equal(got, eval_batch_np(TPrg(16, ck), b, kb, xs)[0])


def test_contracts_and_ship_once_cache():
    ck, beta, _, tb = _setup(630, 0x33, 8, "LT_BETA")
    fd = TreeFullDomain(16, ck, device="cpu")
    with pytest.raises(ShapeError, match="depth mismatch"):
        fd.eval_party(0, tb.for_party(0), 16)
    with pytest.raises(ShapeError, match="party-restricted"):
        fd.eval_party(0, tb, 8)
    _, _, _, additive = _setup(631, 0x33, 8, "LT_BETA", group="add16")
    with pytest.raises(ShapeError, match="XOR-only"):
        fd.eval_party(0, additive.for_party(0), 8)
    with pytest.raises(ShapeError, match="XOR-only"):
        fd.check(additive, 0x33, beta, 8)
    with pytest.raises(ValueError, match="lam=16 only"):
        TreeFullDomain(32, ck, device="cpu")
    with pytest.raises(ValueError):
        TreeFullDomain(16, ck, host_levels=-1, device="cpu")
    with pytest.raises(BackendUnavailableError):
        TreeFullDomain(16, ck)  # no CUDA on this host, and no CPU fallback
    first = fd._staged_for(tb, 8)
    assert fd._staged_for(tb, 8)[0] is first[0]
    twin = KeyBundle.from_arrays(*(getattr(tb, f) for f in FIELDS))
    assert fd._staged_for(twin, 8)[0] is not first[0]  # keyed by identity


def test_final_level_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(640)
    aes = torch.from_numpy(aes_image(rng.bytes(32)))
    s, v = (torch.from_numpy(rng.integers(0, 256, (8, 16), dtype=np.uint8))
            for _ in range(2))
    t = torch.from_numpy(rng.integers(0, 2, 8, dtype=np.uint8))
    cs, cv, np1 = (torch.from_numpy(rng.integers(0, 256, 16, dtype=np.uint8))
                   for _ in range(3))
    ct = torch.tensor([0, 1], dtype=torch.uint8)
    before = tree_expand_final.launches
    got = tree_expand_final(aes, cs, cv, ct, np1, s, v, t)
    assert tree_expand_final.launches == before  # CPU: no launch
    assert torch.equal(got, tree_expand_final_plain(aes, cs, cv, ct, np1, s,
                                                    v, t))
    assert got.shape == (16, 16)
    with pytest.raises(ShapeError):
        tree_expand_final(aes, cs, cv, ct, np1[:8], s, v, t)
    with pytest.raises(ShapeError):  # at most MAX_DEPTH levels a launch
        tree_expand_final(aes, cs.repeat(4, 1), cv.repeat(4, 1),
                          ct.repeat(4, 1), np1, s, v, t)
    with pytest.raises(ShapeError):
        tree_expand_device(aes, cs[None], cv[None], ct[None], np1, s, v, t,
                           k0=3, n=3)


def test_leaf_mismatch_count_counts_each_kind_once():
    n = 6
    value = bitrev_values(n, "cpu")
    assert sorted(value.tolist()) == list(range(1 << n))
    assert value[1] == 1 << (n - 1) and value[(1 << n) - 1] == (1 << n) - 1
    beta = bytes(range(1, 17))
    alpha = 20
    want = torch.where((value < alpha)[:, None],
                       torch.tensor(list(beta), dtype=torch.uint8),
                       torch.zeros(16, dtype=torch.uint8))
    y0 = torch.from_numpy(np.random.default_rng(650).integers(
        0, 256, (1 << n, 16), dtype=np.uint8))
    y1 = y0 ^ want
    assert int(leaf_mismatch_count(y0, y1, alpha, beta, n)) == 0
    y1[5, 15] ^= 1  # one bit in the high word
    y1[9, 0] ^= 0x80  # and one in the low word of another leaf
    assert int(leaf_mismatch_count(y0, y1, alpha, beta, n)) == 2
    assert int(leaf_mismatch_count(y0, y1, alpha, beta, n, gt=True)) \
        == (1 << n) - 1  # every leaf but value == alpha


@pytest.mark.parametrize("bound", BOUNDS)
def test_per_point_full_domain_check_matches_host(bound):
    """``full_domain_check_device`` over two WalkBackends (stage_range and
    mismatch_count on the CPU), and the host ``full_domain_check`` of both
    packages over their numpy oracles: 0 clean, the shift when tampered."""
    n, alpha, gt = 8, 0xA4, bound == "GT_BETA"
    ck, beta, jb, tb = _setup(660, alpha, n, bound)
    bes = [WalkBackend(16, ck, device="cpu") for _ in (0, 1)]
    with pytest.raises(StaleStateError):
        bes[0].stage_range(0, 32)
    for b in (0, 1):
        bes[b].put_bundle(tb.for_party(b))
    tprg, jprg = TPrg(16, ck), JPrg(16, ck)
    for shift in (0, 5):
        counts = {
            "device": full_domain_check_device(
                bes[0], bes[1], alpha + shift, beta, n, gt, chunk=64),
            "host": full_domain_check(
                lambda xs: eval_batch_np(tprg, 0, tb.for_party(0), xs),
                lambda xs: eval_batch_np(tprg, 1, tb.for_party(1), xs),
                alpha + shift, beta, n, gt, chunk=100),
            "dcf_tpu": j_full_domain_check(
                lambda xs: j_eval_np(jprg, 0, jb.for_party(0), xs),
                lambda xs: j_eval_np(jprg, 1, jb.for_party(1), xs),
                alpha + shift, beta, n, gt, chunk=100),
        }
        assert set(counts.values()) == {shift}, counts
    staged = bes[0].stage_range(64, 96)
    assert np.array_equal(staged["xs"][0].numpy(), domain_points(1, 64, 96))
    assert np.array_equal(domain_points(3, 65000, 700),
                          j_domain_points(3, 65000, 700))
    for start, count in ((0, 33), (224, 64), (-32, 32)):
        with pytest.raises(ShapeError):
            bes[0].stage_range(start, count)
    with pytest.raises(ShapeError, match="must divide"):
        full_domain_check_device(bes[0], bes[1], alpha, beta, n, gt,
                                 chunk=96)
