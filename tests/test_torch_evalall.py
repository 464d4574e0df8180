"""Kernel B6's plain version and the port's ``DpfEvalAll`` on the CPU
against dcf_tpu's Pallas EvalAll kernel in interpret mode
(``dcf_tpu.backends.evalall.DpfEvalAll(interpret=True)`` after
``leaf_planes_to_bytes``) and against its host expansion: leaf shares and
t bits, K = 1 and 3, both parties, at full depth and at prefix depths.
The same seeded numpy keys go through both packages; tolerance: exact
byte equality."""

import warnings

import numpy as np
import pytest
import torch

from dcf_tpu.api import Dcf as JDcf
from dcf_tpu.backends.evalall import DpfEvalAll as JDpfEvalAll
from dcf_tpu.backends.evalall import dpf_tree_expand_np as j_tree_np
from dcf_tpu.backends.evalall import leaf_planes_to_bytes
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.protocols.dpf import DpfBundle as JDpfBundle
from dcf_tpu.protocols.dpf import dpf_gen_batch as j_dpf_gen_batch

from dcf_tpu_torch import Dcf
from dcf_tpu_torch.backends.evalall import (
    DpfEvalAll,
    bitrev,
    dpf_finalize_np,
    dpf_tree_expand_np,
    leaves_to_bytes,
)
from dcf_tpu_torch.errors import BackendUnavailableError, ShapeError
from dcf_tpu_torch.gen import random_s0s
from dcf_tpu_torch.ops._launch import MAX_DEPTH, launch_depths
from dcf_tpu_torch.ops.evalall_expand import (
    evalall_expand,
    evalall_expand_level,
    evalall_expand_level_plain,
)
from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
from dcf_tpu_torch.ops.pir_answer import pack_selection
from dcf_tpu_torch.ops.prg import HirosePrgNp as TPrg
from dcf_tpu_torch.protocols.dpf import DpfBundle, dpf_eval_points
from tests.torch_threads import one_torch_thread  # noqa: F401

LAM = 32
FIELDS = ("s0s", "cw_s", "cw_t", "cw_np1")


@pytest.fixture(scope="module")
def ck():
    rng = np.random.default_rng(0xEA11)
    return [rng.bytes(32) for _ in range(18)]


@pytest.fixture(scope="module")
def prgs(ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JPrg(LAM, ck), TPrg(LAM, ck)


@pytest.fixture(scope="module")
def j_eval(ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JDpfEvalAll(LAM, ck, interpret=True)


@pytest.fixture(scope="module")
def t_eval(ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return DpfEvalAll(LAM, ck, device="cpu")


def _bundles(prgs, seed, alpha_vals, n_bits):
    """The same keys as a dcf_tpu bundle and carried into the port."""
    rng = np.random.default_rng(seed)
    alphas = np.array([list(int(a).to_bytes(n_bits // 8, "big"))
                       for a in alpha_vals], dtype=np.uint8)
    betas = rng.integers(0, 256, (len(alpha_vals), LAM), dtype=np.uint8)
    jb = j_dpf_gen_batch(prgs[0], alphas, betas,
                         random_s0s(len(alpha_vals), LAM, rng))
    tb = DpfBundle.from_arrays(*(getattr(jb, f) for f in FIELDS))
    return jb, tb, betas


CASES = [  # (key depth, evaluated depth, alphas)
    (8, 8, [0xA7]),
    (8, 8, [0, 0xFF, 0x5C]),
    (8, 7, [0x31, 0xC0, 0x5C]),
    (16, 12, [0xBEEF]),
    (16, 10, [0x0001, 0xFFFF, 0x8421]),
]


@pytest.mark.parametrize("n_key,depth,alpha_vals", CASES)
def test_eval_party_matches_pallas_interpret(prgs, j_eval, t_eval, n_key,
                                             depth, alpha_vals):
    """``DpfEvalAll.eval_party`` (B6's plain version under the level loop)
    against the Pallas kernel: y and t, both parties."""
    jb, tb, _ = _bundles(prgs, 500 + depth + len(alpha_vals), alpha_vals,
                         n_key)
    ts = []
    for b in (0, 1):
        want_y, want_t = leaf_planes_to_bytes(
            *j_eval.eval_party(b, jb.for_party(b), depth))
        y, t = leaves_to_bytes(*t_eval.eval_party(b, tb.for_party(b), depth))
        assert y.shape == (len(alpha_vals), 1 << depth, LAM)
        assert np.array_equal(t, want_t), b
        assert np.array_equal(y, want_y), b
        ts.append(t)
    # The t bits are the one-hot share of alpha's top `depth` bits.
    sel = ts[0] ^ ts[1]
    for k, a in enumerate(alpha_vals):
        want = np.zeros(1 << depth, np.uint8)
        want[bitrev(a >> (n_key - depth), depth)] = 1
        assert np.array_equal(sel[k], want), k


@pytest.fixture(scope="module")
def j_t_words(prgs, j_eval):
    """The reference's selection words at depth n, t int32 [K, 1, 2^n / 32]
    from ``dcf_tpu``'s ``DpfEvalAll.eval_party`` (interpret mode), for
    both parties of three keys of a byte-granular domain above n,
    computed once per n."""
    made = {}

    def get(n):
        if n not in made:
            jb, tb, _ = _bundles(prgs, 530 + n, [0x00, 0xFF, 0x6B],
                                 8 * ((n + 7) // 8))
            made[n] = tb, [np.asarray(j_eval.eval_party(
                b, jb.for_party(b), n)[2]) for b in (0, 1)]
        return made[n]

    return get


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("n", [5, 10])
def test_t_only_words_match_dcf_tpu_t_words(prgs, ck, j_t_words, n, depth):
    """B6's t-only last launch (its plain version here) of ``depth``
    levels, from the host expansion at n - depth, and
    ``evalall_expand(..., want_y=False)`` from the roots: int32 [K,
    2^n / 32] words equal, as uint32 bit patterns, the reference's
    ``t_words`` (bit i of word w the leaf at 32 w + i), both parties."""
    tb, want = j_t_words(n)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    for b in (0, 1):
        kb = tb.for_party(b)
        cw_s, cw_t, cw_np1 = (torch.from_numpy(a)
                              for a in (kb.cw_s, kb.cw_t, kb.cw_np1))
        s, t = (torch.from_numpy(a)
                for a in dpf_tree_expand_np(prgs[1], kb, b, n - depth))
        y, words = evalall_expand_level(aes, cw_s, cw_t, s, t,
                                        level=n - depth, depth=depth,
                                        cw_np1=cw_np1, want_y=False)
        assert y is None and words.dtype == torch.int32
        assert words.shape == (3, (1 << n) // 32)
        assert np.array_equal(words.numpy().view(np.uint32),
                              want[b][:, 0].view(np.uint32)), b
        s0, t0 = (torch.from_numpy(a)
                  for a in dpf_tree_expand_np(prgs[1], kb, b, 0))
        y, words = evalall_expand(aes, cw_s, cw_t, cw_np1, s0, t0, k0=0,
                                  k1=n, want_y=False)
        assert y is None
        assert np.array_equal(words.numpy(), want[b][:, 0]), b


@pytest.mark.parametrize("k_num", [1, 3])
def test_plain_level_matches_host_expansion_every_level(prgs, ck, k_num):
    """One plain B6 level at a time from the root against both packages'
    host expansions (which agree), and the finalize on the last level."""
    jb, tb, _ = _bundles(prgs, 510 + k_num, [0x1234, 0, 0xFFFF][:k_num], 16)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    cw_s, cw_t, cw_np1 = (torch.from_numpy(a)
                          for a in (tb.cw_s, tb.cw_t, tb.cw_np1))
    for b in (0, 1):
        kb = tb.for_party(b)
        s = torch.from_numpy(kb.s0s[:, 0, None, :].copy())
        t = torch.full((k_num, 1), b, dtype=torch.uint8)
        for lvl in range(9):
            want_s, want_t = dpf_tree_expand_np(prgs[1], kb, b, lvl + 1)
            js, jt = j_tree_np(prgs[0], jb.for_party(b), b, lvl + 1)
            assert np.array_equal(want_s, js) and np.array_equal(want_t, jt)
            fin = evalall_expand_level_plain(aes, cw_s, cw_t, s, t,
                                             level=lvl, cw_np1=cw_np1)
            assert np.array_equal(
                fin[0].numpy(), dpf_finalize_np(kb, want_s, want_t))
            s, t = evalall_expand_level_plain(aes, cw_s, cw_t, s, t,
                                              level=lvl)
            assert np.array_equal(s.numpy(), want_s), (b, lvl)
            assert np.array_equal(t.numpy(), want_t), (b, lvl)
            assert torch.equal(fin[1], t)


@pytest.mark.parametrize("host_levels", [0, 3, 6, 20])
def test_host_levels_do_not_change_the_leaves(prgs, ck, t_eval, host_levels):
    """Any split between the host's levels and the kernel's gives the
    same leaves (there is no 5-level floor in the byte layout), and the
    same t bits without y, packed (``want_y=False``, the PIR selection)."""
    _, tb, _ = _bundles(prgs, 520, [0x4D, 0xE2], 8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ev = DpfEvalAll(LAM, ck, host_levels=host_levels, device="cpu")
    for b in (0, 1):
        kb = tb.for_party(b)
        for depth in (8, 5, 1):
            got = ev.eval_party(b, kb, depth)
            want = t_eval.eval_party(b, kb, depth)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
            y, t_words = ev.eval_party(b, kb, depth, want_y=False)
            assert y is None
            assert torch.equal(t_words, pack_selection(want[1]))
    with pytest.raises(ValueError):
        DpfEvalAll(LAM, ck, host_levels=-1, device="cpu")


def test_full_depth_leaves_match_per_point_walk(prgs, t_eval):
    """Leaf p holds the share of domain point bitreverse(p)."""
    _, tb, betas = _bundles(prgs, 530, [0x9C, 0x00], 8)
    xs = np.array([[bitrev(p, 8)] for p in range(256)], dtype=np.uint8)
    ys = []
    for b in (0, 1):
        y, _ = leaves_to_bytes(*t_eval.eval_party(b, tb.for_party(b), 8))
        assert np.array_equal(y, dpf_eval_points(prgs[1], tb, b, xs))
        ys.append(y)
    recon = ys[0] ^ ys[1]
    assert np.array_equal(recon[0, bitrev(0x9C, 8)], betas[0])
    assert np.array_equal(recon[1, 0], betas[1])
    assert np.count_nonzero(recon.any(-1)) == 2


def test_check_clean_and_tampered(prgs, j_eval, t_eval):
    alphas = [0x1F, 0xE0, 0x77]
    jb, tb, betas = _bundles(prgs, 540, alphas, 8)
    assert t_eval.check(tb, alphas, betas, 8) == 0
    assert j_eval.check(jb, alphas, betas, 8) == 0
    moved = [0x1F, 0xE1, 0x77]  # its old leaf and its new one
    assert t_eval.check(tb, moved, betas, 8) == 2
    assert int(j_eval.check(jb, moved, betas, 8)) == 2
    bad_beta = betas.copy()
    bad_beta[2, 31] ^= 0x80
    assert t_eval.check(tb, alphas, bad_beta, 8) == 1
    count = t_eval.check_device(tb, alphas, betas, 8)
    assert isinstance(count, torch.Tensor) and count.dim() == 0
    with pytest.raises(ShapeError):
        t_eval.check(tb, alphas[:2], betas, 8)


def test_eval_party_contracts_and_ship_once_cache(prgs, ck, t_eval):
    _, tb, _ = _bundles(prgs, 550, [0x42], 8)
    with pytest.raises(ShapeError, match="cannot evaluate"):
        t_eval.eval_party(0, tb.for_party(0), 9)
    with pytest.raises(ShapeError, match="cannot evaluate"):
        t_eval.eval_party(0, tb.for_party(0), 0)
    with pytest.raises(ShapeError, match="party-restricted"):
        t_eval.eval_party(0, tb, 8)
    with pytest.raises(ShapeError, match="full depth"):
        t_eval.check(tb, [0x42], np.zeros((1, 32), np.uint8), 7)
    with pytest.raises(ValueError, match="lam=32 only"):
        DpfEvalAll(16, ck[:2], device="cpu")
    with pytest.raises(BackendUnavailableError):
        DpfEvalAll(LAM, ck)  # no CUDA on this host, and no CPU fallback
    first = t_eval._staged_for(tb, 8)
    assert t_eval._staged_for(tb, 8)[0] is first[0]  # same object: reused
    assert t_eval._staged_for(tb, 7)[0] is not first[0]  # another depth
    twin = DpfBundle.from_arrays(*(getattr(tb, f) for f in FIELDS))
    assert t_eval._staged_for(twin, 7)[0] is not first[0]  # by identity
    t_eval.invalidate()
    assert t_eval._cache is None


def test_level_wrapper_runs_the_plain_version_on_the_cpu(prgs, ck):
    _, tb, _ = _bundles(prgs, 560, [0x10, 0x20], 8)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    kb = tb.for_party(1)
    cw_s, cw_t, cw_np1 = (torch.from_numpy(a)
                          for a in (kb.cw_s, kb.cw_t, kb.cw_np1))
    s, t = (torch.from_numpy(a)
            for a in dpf_tree_expand_np(prgs[1], kb, 1, 3))
    before = evalall_expand_level.launches
    got = evalall_expand_level(aes, cw_s, cw_t, s, t, level=3)
    assert evalall_expand_level.launches == before  # CPU: no launch
    want = evalall_expand_level_plain(aes, cw_s, cw_t, s, t, level=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (2, 16, 32) and got[1].shape == (2, 16)
    y, t8 = evalall_expand(aes, cw_s, cw_t, cw_np1, s, t, k0=3, k1=8)
    hs, ht = dpf_tree_expand_np(prgs[1], kb, 1, 8)
    assert np.array_equal(y.numpy(), dpf_finalize_np(kb, hs, ht))
    assert np.array_equal(t8.numpy(), ht)
    with pytest.raises(ShapeError):
        evalall_expand_level(aes, cw_s, cw_t, s[..., :16], t, level=3)
    with pytest.raises(ShapeError):
        evalall_expand_level(aes, cw_s, cw_t, s, t, level=8)
    with pytest.raises(ShapeError):
        evalall_expand_level(aes[:496], cw_s, cw_t, s, t, level=3)
    with pytest.raises(ShapeError):
        evalall_expand(aes, cw_s, cw_t, cw_np1, s, t, k0=3, k1=3)
    with pytest.raises(ShapeError):
        evalall_expand(aes, cw_s, cw_t, cw_np1, s, t, k0=4, k1=8)


def test_launch_depths_cover_the_levels_once():
    """The launches of an expansion cover levels k0..k1-1 in order, each
    once, at most MAX_DEPTH a launch, the last always MAX_DEPTH deep when
    the span allows."""
    for k0 in range(0, 8):
        for k1 in range(k0 + 1, 26):
            got = launch_depths(k0, k1)
            levels = [i + d for i, depth in got for d in range(depth)]
            assert levels == list(range(k0, k1)), (k0, k1)
            assert all(1 <= d <= MAX_DEPTH for _, d in got)
            assert got[-1][1] == min(MAX_DEPTH, k1 - k0)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_level_wrapper_depth_equals_levels_one_at_a_time(prgs, ck, depth):
    """``evalall_expand_level`` at depth d (its plain version on the CPU)
    equals d calls of one level, with and without the leaf correction,
    both parties; with the correction and ``want_y=False`` it returns the
    t bits alone, packed (only the tree's last level may leave y out)."""
    _, tb, _ = _bundles(prgs, 590 + depth, [0x5A, 0xC3], 8)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    for b in (0, 1):
        kb = tb.for_party(b)
        cw_s, cw_t, cw_np1 = (torch.from_numpy(a)
                              for a in (kb.cw_s, kb.cw_t, kb.cw_np1))
        s, t = (torch.from_numpy(a)
                for a in dpf_tree_expand_np(prgs[1], kb, b, 8 - depth))
        for np1 in (None, cw_np1):
            got = evalall_expand_level(aes, cw_s, cw_t, s, t,
                                       level=8 - depth, cw_np1=np1,
                                       depth=depth)
            want = (s, t)
            for i in range(8 - depth, 8):
                want = evalall_expand_level(
                    aes, cw_s, cw_t, *want, level=i,
                    cw_np1=np1 if i == 7 else None)
            assert torch.equal(got[0], want[0]), (b, np1 is None)
            assert torch.equal(got[1], want[1]), (b, np1 is None)
        y, t_only = evalall_expand_level(aes, cw_s, cw_t, s, t,
                                         level=8 - depth, cw_np1=cw_np1,
                                         depth=depth, want_y=False)
        assert y is None, b
        assert torch.equal(t_only, pack_selection(want[1])), b
        with pytest.raises(ShapeError):
            evalall_expand_level(aes, cw_s, cw_t, s, t, level=8 - depth,
                                 depth=depth, want_y=False)
        with pytest.raises(ShapeError):
            evalall_expand_level(aes, cw_s, cw_t, s, t, level=9 - depth,
                                 depth=depth)
    with pytest.raises(ShapeError):
        evalall_expand_level(aes, cw_s, cw_t, s, t, level=0,
                             depth=MAX_DEPTH + 1)


@pytest.mark.parametrize("device", [False, True])
def test_facade_eval_all_matches_dcf_tpu(ck, device):
    """``Dcf.dpf`` and ``Dcf.eval_all`` against the JAX facade on the same
    seeds: keys byte-identical, leaves and t bits identical (the JAX side
    runs its host expansion or its kernel in interpret mode)."""
    rng = np.random.default_rng(570)
    alphas = rng.integers(0, 256, (2, 1), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, LAM), dtype=np.uint8)
    s0s = random_s0s(2, LAM, rng)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jd = JDcf(1, LAM, ck, backend="numpy")
        td = Dcf(1, LAM, ck, device="cpu")
    jb = jd.dpf(alphas, betas, s0s=s0s)
    tb = td.dpf(alphas, betas, s0s=s0s)
    assert isinstance(jb, JDpfBundle) and tb.to_bytes() == jb.to_bytes()
    for b in (0, 1):
        jy, jt = jd.eval_all(b, jb, device=device)
        for bundle in (tb, tb.for_party(b)):
            y, t = td.eval_all(b, bundle, device=device)
            assert np.array_equal(y, jy) and np.array_equal(t, jt)
            assert t.dtype == np.uint8 and t.shape == (2, 256)
    default = td.dpf(alphas, rng=np.random.default_rng(1))
    assert default.lam == LAM and default.s0s.shape == (2, 2, LAM)
    on_card = td.dpf(alphas, betas, s0s=s0s, device=True)  # B7b's plain
    assert on_card.to_bytes() == td.dpf(alphas, betas, s0s=s0s,
                                        device=False).to_bytes()
    with pytest.raises(ShapeError):
        td.dpf(np.zeros((2, 2), np.uint8))


def test_facade_default_eval_all_runs_from_the_roots(ck, monkeypatch):
    """The facade's default ``eval_all`` on ``device="cpu"``: its
    evaluator keeps no level on the host (``host_levels`` 0, so the numpy
    PRG walks no level of a fresh key) and its leaves and t bits equal
    dcf_tpu's ``eval_all`` on the same keys, n = 16, K = 2, both
    parties."""
    import dcf_tpu_torch.backends.evalall as evalall_mod

    rng = np.random.default_rng(580)
    alphas = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, LAM), dtype=np.uint8)
    s0s = random_s0s(2, LAM, rng)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jd = JDcf(2, LAM, ck, backend="numpy")
        td = Dcf(2, LAM, ck, device="cpu")
    jb = jd.dpf(alphas, betas, s0s=s0s)
    tb = td.dpf(alphas, betas, s0s=s0s)
    host_levels = []
    expand = evalall_mod.dpf_tree_expand_np
    monkeypatch.setattr(
        evalall_mod, "dpf_tree_expand_np",
        lambda prg, bundle, b, levels: host_levels.append(levels)
        or expand(prg, bundle, b, levels))
    for b in (0, 1):
        y, t = td.eval_all(b, tb)
        jy, jt = jd.eval_all(b, jb, device=False)
        assert np.array_equal(y, jy) and np.array_equal(t, jt), b
        assert y.shape == (2, 1 << 16, LAM)
    assert td._dpf_evalall.host_levels == 0
    assert host_levels == [0, 0]
