"""Kernel B2's plain version (the port's tree expansion on the CPU) against
dcf_tpu's Pallas tree kernel in interpret mode (``tree_expand_raw``) and its
host expansion (``tree_expand_np``), both parties and all four groups, at a
small depth.  Exact byte equality; the JAX side's bit planes are turned
into bytes with dcf_tpu's own helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcf_tpu import spec as jspec
from dcf_tpu.backends.fulldomain import tree_expand_np as j_tree_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.gen import random_s0s
from dcf_tpu.ops.aes_bitsliced import round_key_masks_bitmajor
from dcf_tpu.ops.pallas_tree import tree_expand_raw
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.utils.bits import (
    bitmajor_perm,
    bitmajor_plane_masks,
    byte_bits_lsb,
    pack_lanes,
    planes_to_bytes,
    unpack_lanes,
)

from dcf_tpu_torch.backends.fulldomain import tree_expand_np as t_tree_np
from dcf_tpu_torch.errors import DcfError, ShapeError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops._launch import launch_depths
from dcf_tpu_torch.ops.prefix_eval import frontier_table
from dcf_tpu_torch.ops.prg import HirosePrgNp as TPrg
from dcf_tpu_torch.ops.tree_expand import (
    tree_expand,
    tree_expand_level,
    tree_expand_level_plain,
    tree_expand_levels,
)
from dcf_tpu_torch.ops.walk_eval import aes_image
from tests.torch_threads import one_torch_thread  # noqa: F401

GROUPS = ("xor", "add8", "add16", "add32")
K0, K1 = 5, 7
_PERM = bitmajor_perm(16)


def _to_planes(a):  # uint8 [N, 16] -> int32 bit-major planes [128, N/32]
    bits = byte_bits_lsb(a)[:, _PERM]
    return jnp.asarray(pack_lanes(np.ascontiguousarray(bits.T)).view(np.int32))


def _from_planes(p):  # int32 bit-major planes [128, W] -> uint8 [32W, 16]
    return planes_to_bytes(np.asarray(p).view(np.uint32)[np.argsort(_PERM)],
                           16)


@pytest.mark.parametrize("group", GROUPS)
def test_tree_expand_matches_pallas_and_host(group):
    rng = np.random.default_rng(80 + GROUPS.index(group))
    ck = [rng.bytes(32), rng.bytes(32)]
    jb = j_gen_batch(JPrg(16, ck),
                     rng.integers(0, 256, (1, 2), dtype=np.uint8),
                     rng.integers(0, 256, (1, 16), dtype=np.uint8),
                     random_s0s(1, 16, rng), jspec.Bound.LT_BETA,
                     group=group)
    tb = KeyBundle.from_arrays(jb.s0s, jb.cw_s, jb.cw_v, jb.cw_t, jb.cw_np1,
                               group=group)
    rk = jnp.asarray(round_key_masks_bitmajor(ck[0]))
    aes = torch.from_numpy(aes_image(ck[0]))
    for b in (0, 1):
        jkb, tkb = jb.for_party(b), tb.for_party(b)
        # The host expansions agree at every depth used below.
        for depth in (K0, K1):
            for got, want in zip(t_tree_np(TPrg(16, ck), tkb, b, depth),
                                 j_tree_np(JPrg(16, ck), jkb, b, depth)):
                assert np.array_equal(got, want)
        s, v, t = t_tree_np(TPrg(16, ck), tkb, b, K0)
        js, jv, jt = tree_expand_raw(
            rk, jnp.asarray(bitmajor_plane_masks(jkb.cw_s[0])[..., None]),
            jnp.asarray(bitmajor_plane_masks(jkb.cw_v[0])[..., None]),
            jnp.asarray(jkb.cw_t[0].astype(np.int32) * -1),
            _to_planes(s), _to_planes(v),
            jnp.asarray(pack_lanes(t[None]).view(np.int32)),
            k0=K0, k1=K1, interpret=True, group=group)
        gs, gv, gt = tree_expand(
            aes, torch.from_numpy(tkb.cw_s[0]), torch.from_numpy(tkb.cw_v[0]),
            torch.from_numpy(tkb.cw_t[0]), torch.from_numpy(s),
            torch.from_numpy(v), torch.from_numpy(t), k0=K0, k1=K1,
            group=group)
        assert np.array_equal(gs.numpy(), _from_planes(js)), b
        assert np.array_equal(gv.numpy(), _from_planes(jv)), b
        assert np.array_equal(
            gt.numpy(), unpack_lanes(np.asarray(jt).view(np.uint32))[0]), b
        hs, hv, ht = j_tree_np(JPrg(16, ck), jkb, b, K1)
        assert np.array_equal(gs.numpy(), hs)
        assert np.array_equal(gv.numpy(), hv)
        assert np.array_equal(gt.numpy(), ht)


# The cuts of the flagship prefix path (levels 6..20: five launches of
# three levels) and of the full domain's B2 span (6..22: two, then five of
# three), and the spans below that share their shapes: all threes, a
# first launch of two, a first launch of one.
PREFIX_CUT = [(6, 3), (9, 3), (12, 3), (15, 3), (18, 3)]
FULL_DOMAIN_CUT = [(6, 2), (8, 3), (11, 3), (14, 3), (17, 3), (20, 3)]


@pytest.mark.parametrize("k0,k1", [(5, 11), (5, 10), (5, 9)])
@pytest.mark.parametrize("group", ("xor", "add16"))
def test_tree_expand_launch_cut_matches_pallas(monkeypatch, group, k0, k1):
    """``tree_expand`` through the wrapper's depth cut (on the CPU each
    launch runs the plain version level by level) against ``dcf_tpu``'s
    host expansion for both parties and its ``tree_expand_raw`` in
    interpret mode for one (party k1 % 2), byte-exact: spans cut 3 + 3
    (the shape of levels 6..20's cut), 2 + 3 (of 6..22's) and 1 + 3."""
    from dcf_tpu_torch.ops import tree_expand as mod

    assert launch_depths(6, 21) == PREFIX_CUT
    assert launch_depths(6, 23) == FULL_DOMAIN_CUT
    calls = []
    levels = mod.tree_expand_levels

    def spy(*args, level, depth, group):
        calls.append((level, depth))
        return levels(*args, level=level, depth=depth, group=group)

    monkeypatch.setattr(mod, "tree_expand_levels", spy)
    rng = np.random.default_rng(95 + k1 + GROUPS.index(group))
    ck = [rng.bytes(32), rng.bytes(32)]
    jb = j_gen_batch(JPrg(16, ck),
                     rng.integers(0, 256, (1, 2), dtype=np.uint8),
                     rng.integers(0, 256, (1, 16), dtype=np.uint8),
                     random_s0s(1, 16, rng), jspec.Bound.GT_BETA,
                     group=group)
    tb = KeyBundle.from_arrays(jb.s0s, jb.cw_s, jb.cw_v, jb.cw_t, jb.cw_np1,
                               group=group)
    rk = jnp.asarray(round_key_masks_bitmajor(ck[0]))
    aes = torch.from_numpy(aes_image(ck[0]))
    for b in (0, 1):
        jkb, tkb = jb.for_party(b), tb.for_party(b)
        s, v, t = t_tree_np(TPrg(16, ck), tkb, b, k0)
        calls.clear()
        gs, gv, gt = tree_expand(
            aes, torch.from_numpy(tkb.cw_s[0]), torch.from_numpy(tkb.cw_v[0]),
            torch.from_numpy(tkb.cw_t[0]), torch.from_numpy(s),
            torch.from_numpy(v), torch.from_numpy(t), k0=k0, k1=k1,
            group=group)
        assert calls == launch_depths(k0, k1)
        assert [d for _, d in calls] in ([3, 3], [2, 3], [1, 3])
        for got, want in zip((gs, gv, gt),
                             j_tree_np(JPrg(16, ck), jkb, b, k1)):
            assert np.array_equal(got.numpy(), want), b
        if b != k1 % 2:
            continue
        js, jv, jt = tree_expand_raw(
            rk, jnp.asarray(bitmajor_plane_masks(jkb.cw_s[0])[..., None]),
            jnp.asarray(bitmajor_plane_masks(jkb.cw_v[0])[..., None]),
            jnp.asarray(jkb.cw_t[0].astype(np.int32) * -1),
            _to_planes(s), _to_planes(v),
            jnp.asarray(pack_lanes(t[None]).view(np.int32)),
            k0=k0, k1=k1, interpret=True, group=group)
        assert np.array_equal(gs.numpy(), _from_planes(js)), b
        assert np.array_equal(gv.numpy(), _from_planes(jv)), b
        assert np.array_equal(
            gt.numpy(), unpack_lanes(np.asarray(jt).view(np.uint32))[0]), b


def test_tree_level_wrapper_and_frontier_stash():
    rng = np.random.default_rng(90)
    aes = torch.from_numpy(aes_image(rng.bytes(32)))
    s = torch.from_numpy(rng.integers(0, 256, (8, 16), dtype=np.uint8))
    v = torch.from_numpy(rng.integers(0, 256, (8, 16), dtype=np.uint8))
    t = torch.from_numpy(rng.integers(0, 2, 8, dtype=np.uint8))
    cs, cv = (torch.from_numpy(rng.integers(0, 256, 16, dtype=np.uint8))
              for _ in range(2))
    cs[15] &= 0xFE  # a real seed CW is a XOR of masked PRG outputs
    ct = torch.tensor([1, 0], dtype=torch.uint8)
    before = tree_expand_levels.launches
    got = tree_expand_level(aes, cs, cv, ct, s, v, t, group="add16")
    assert tree_expand_levels.launches == before  # CPU: the plain version
    want = tree_expand_level_plain(aes, cs, cv, ct, s, v, t, group="add16")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s2, v2, t2 = got
    assert s2.shape == (16, 16) and t2.shape == (16,)
    # Children seeds have the masked bit clear, so t can ride in it.
    rows = frontier_table(s2, v2, t2)
    assert rows.shape == (16, 32)
    assert torch.equal(rows[:, 15] & 1, t2)
    assert torch.equal(rows[:, 16:], v2)
    with pytest.raises(DcfError):
        frontier_table(s2 | 1, v2, t2)
    with pytest.raises(ShapeError):
        tree_expand_level(aes, cs, cv, ct, s[:, :8], v, t, group="xor")
