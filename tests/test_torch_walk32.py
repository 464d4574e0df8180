"""DCF at lam = 32: kernel E1's and kernel G2's plain versions (the port's
lam = 32 ``WalkBackend`` and ``gen_on_device`` on the CPU) against
dcf_tpu's ``BitslicedBackend`` (its XLA ``eval_core_bitsliced``, what
``dcf_tpu``'s facade picks at lam = 32), its ``DeviceKeyGen`` / ``gen_on_device``
(XLA ``_gen_core``) and its numpy ``gen_batch``, byte for byte.

Same seeded numpy inputs through both packages: both parties, both
bounds, all four groups, shared and per-key points, x = alpha and
alpha +- 1 planted, root seeds with the PRG's masked bit (bit 0 of byte
31) set.  One small shape (n = 16 bits, 64 points, 3 keys) keeps the JAX
side to a few compiles of the bitsliced scan.  Then the facade at
lam = 32 (``auto`` = ``walk``), the per-point full domain over two lam = 32
``WalkBackend``s, and MIC through ``MicEvaluator`` on them."""

import warnings

import numpy as np
import pytest
import torch

from dcf_tpu import spec as jspec
from dcf_tpu.api import Dcf as JDcf
from dcf_tpu.backends.jax_bitsliced import BitslicedBackend
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.gen import gen_on_device as j_gen_on_device
from dcf_tpu.keys import KeyBundle as JKeyBundle
from dcf_tpu.ops.prg import HirosePrgNp as JPrg

from dcf_tpu_torch import Bound, Dcf
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
from dcf_tpu_torch.backends.walk_backend import WalkBackend
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.gen import gen_batch, gen_on_device, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.keygen_walk import (
    MODE_G2,
    keygen_dcf32,
    keygen_walk_plain,
)
from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.ops.walk32_eval import walk32_eval, walk32_eval_plain
from dcf_tpu_torch.protocols import MicEvaluator, mic_oracle
from dcf_tpu_torch.utils.groups import np_group_add
from dcf_tpu_torch.workloads.core import full_domain_check_device
from tests.torch_threads import one_torch_thread  # noqa: F401

GROUPS = ("xor", "add8", "add16", "add32")
K_NUM, N_BYTES, M = 3, 2, 64


def _int(b: bytes) -> int:
    return int.from_bytes(b, "big")


def _setup(seed, group, bound, k_num=K_NUM, n_bytes=N_BYTES):
    """lam = 32 keys from dcf_tpu's gen_batch (root seeds of keys 1.. with
    the masked bit set) as both packages' bundles, and points with
    x = alpha and alpha +- 1 planted for every key, shared and per key."""
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32) for _ in range(18)]
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, 32), dtype=np.uint8)
    s0s = random_s0s(k_num, 32, rng)
    s0s[1:, :, 31] |= 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = j_gen_batch(JPrg(32, ck), alphas, betas, s0s,
                         jspec.Bound[bound.name], group=group)
    tb = KeyBundle.from_arrays(jb.s0s, jb.cw_s, jb.cw_v, jb.cw_t, jb.cw_np1,
                               group=jb.group)
    top = 1 << (8 * n_bytes)
    shared = rng.integers(0, 256, (M, n_bytes), dtype=np.uint8)
    for j, a in enumerate(alphas):
        a = _int(a.tobytes())
        for d in (-1, 0, 1):
            shared[3 * j + d + 1] = np.frombuffer(
                ((a + d) % top).to_bytes(n_bytes, "big"), np.uint8)
    per_key = rng.integers(0, 256, (k_num, M, n_bytes), dtype=np.uint8)
    per_key[:, :3] = shared[None, :3]
    per_key[:, 3] = alphas
    return rng, ck, alphas, betas, s0s, jb, tb, shared, per_key


def _jprg(ck) -> JPrg:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JPrg(32, ck)


def _jbackend(ck) -> BitslicedBackend:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return BitslicedBackend(32, ck)


def _backend(ck) -> WalkBackend:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return WalkBackend(32, ck, device="cpu")


@pytest.mark.parametrize("group", GROUPS)
def test_walk32_backend_matches_bitsliced(group):
    """E1's plain version through ``WalkBackend(32)`` against dcf_tpu's
    ``BitslicedBackend``: both parties, both bounds, shared and per-key
    points (per-key points meet the bitsliced scan in two groups, each
    shape a compile of its own, and dcf_tpu's numpy oracle in the other
    two); the shares reconstruct beta * [x < alpha] (or [x > alpha])."""
    for bound in Bound:
        _, ck, alphas, betas, _, jb, tb, shared, per_key = _setup(
            1500 + GROUPS.index(group), group, bound)
        jbe, tbe = _jbackend(ck), _backend(ck)
        for xs in (shared, per_key):
            ys = []
            for b in (0, 1):
                if xs.ndim == 2 or group in ("xor", "add32"):
                    want = jbe.eval(b, xs, bundle=jb.for_party(b))
                else:
                    want = j_eval_np(_jprg(ck), b, jb.for_party(b), xs)
                got = tbe.eval(b, xs, bundle=tb.for_party(b))
                assert got.shape == (K_NUM, M, 32)
                assert np.array_equal(got, want), (bound, b, xs.ndim)
                ys.append(got)
            recon = np_group_add(ys[0], ys[1], group)
            for key in range(K_NUM):
                a = alphas[key].tobytes()
                pts = xs if xs.ndim == 2 else xs[key]
                for j in range(M):
                    x = pts[j].tobytes()
                    hit = x < a if bound is Bound.LT_BETA else x > a
                    assert recon[key, j].tobytes() == (
                        betas[key].tobytes() if hit else bytes(32))


@pytest.mark.parametrize("bound", list(Bound))
def test_walk32_stage_range_mismatch_count(bound):
    """``stage_range`` + ``mismatch_count`` at lam = 32 against dcf_tpu's
    ``BitslicedBackend`` counts over a range of 256 points around alpha:
    0 with the key's alpha, and the same nonzero count with alpha moved;
    then ``points_mismatch_count`` on the staged random points."""
    gt = bound is Bound.GT_BETA
    _, ck, alphas, betas, _, jb, tb, shared, _ = _setup(1510, "xor", bound,
                                                        k_num=1)
    alpha = _int(alphas[0].tobytes())
    beta = betas[0].tobytes()
    start = max(0, min(alpha - 128, (1 << 16) - 256)) // 32 * 32
    jbe = [_jbackend(ck) for _ in (0, 1)]
    tbe = [_backend(ck) for _ in (0, 1)]
    for b in (0, 1):
        jbe[b].put_bundle(jb.for_party(b))
        tbe[b].put_bundle(tb.for_party(b))
    js, ts = jbe[0].stage_range(start, 256), tbe[0].stage_range(start, 256)
    jy = [jbe[b].eval_staged(b, js) for b in (0, 1)]
    ty = [tbe[b].eval_staged(b, ts) for b in (0, 1)]
    assert np.array_equal(tbe[0].staged_to_bytes(ty[0], 256),
                          jbe[0].staged_to_bytes(jy[0], 256))
    for a in (alpha, alpha + 5, alpha - 9):
        want = int(jbe[0].mismatch_count(jy[0], jy[1], a, beta, start, gt))
        got = int(tbe[0].mismatch_count(ty[0], ty[1], a, beta, start, gt))
        assert got == want, a
        assert (got == 0) == (a == alpha)
    staged = tbe[0].stage(shared)
    y0, y1 = (tbe[b].eval_staged(b, staged) for b in (0, 1))
    a_bytes = alphas[0].tobytes()
    assert int(tbe[0].points_mismatch_count(y0, y1, a_bytes, beta, staged,
                                            gt=gt)) == 0
    inside = sum((x.tobytes() > a_bytes) if gt else (x.tobytes() < a_bytes)
                 for x in shared)
    wrong = bytes(x ^ 1 for x in beta)
    assert int(tbe[0].points_mismatch_count(y0, y1, a_bytes, wrong, staged,
                                            gt=gt)) == inside


def test_walk32_multikey_additive_mismatch_count():
    """The two-party check of three add32 keys on the device (here the
    CPU), x = alpha planted: 0, and > 0 against flipped betas."""
    _, ck, alphas, betas, _, _, tb, shared, _ = _setup(
        1515, "add32", Bound.LT_BETA)
    be = [_backend(ck) for _ in (0, 1)]
    for b in (0, 1):
        be[b].put_bundle(tb.for_party(b))
    staged = be[0].stage(shared)
    y0, y1 = (be[b].eval_staged(b, staged) for b in (0, 1))
    assert tuple(y0.shape) == (K_NUM, M, 32)
    assert int(be[0].points_mismatch_count(y0, y1, alphas, betas,
                                           staged)) == 0
    assert int(be[0].points_mismatch_count(y0, y1, alphas, betas ^ 1,
                                           staged)) > 0


@pytest.mark.parametrize("k_num", [1, 33])
@pytest.mark.parametrize("bound", list(Bound))
def test_gen_on_device_lam32_matches_dcf_tpu(bound, k_num):
    """G2's plain version through ``gen_on_device(32, device="cpu")``:
    the bytes of dcf_tpu's ``gen_on_device`` (its XLA ``_gen_core`` at
    lam = 32) and of both packages' ``gen_batch``; DCFK frames read both
    ways."""
    rng = np.random.default_rng(1520 + k_num + len(bound.name))
    ck = [rng.bytes(32) for _ in range(18)]
    alphas = rng.integers(0, 256, (k_num, 2), dtype=np.uint8)
    if k_num > 2:
        alphas[1], alphas[2] = 0, 0xFF
    betas = rng.integers(0, 256, (k_num, 32), dtype=np.uint8)
    s0s = random_s0s(k_num, 32, rng)
    s0s[::2, :, 31] |= 1
    got = gen_on_device(32, ck, alphas, betas, s0s, bound, device="cpu")
    jbound = jspec.Bound[bound.name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_gen_on_device(32, ck, alphas, betas, s0s, jbound)
        host = j_gen_batch(JPrg(32, ck), alphas, betas, s0s, jbound)
    frame = got.to_bytes()
    assert frame == want.to_bytes() == host.to_bytes()
    assert frame == gen_batch(HirosePrgNp(32, ck, warn=False), alphas, betas,
                              s0s, bound).to_bytes()
    assert JKeyBundle.from_bytes(frame).to_bytes() == frame
    assert KeyBundle.from_bytes(want.to_bytes()).to_bytes() == frame
    for b in (0, 1):
        assert got.for_party(b).to_bytes() == want.for_party(b).to_bytes()


def test_walk32_wrapper_runs_plain_version_on_cpu_tensors():
    """On CPU tensors E1's wrapper is its plain version and counts no
    kernel launch; bad tensors are refused typed."""
    _, ck, _, _, _, _, tb, shared, _ = _setup(1530, "add16", Bound.LT_BETA)
    kb = tb.for_party(1)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (kb.s0s[:, 0], kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)]
    xs = torch.from_numpy(shared[None, :40].copy())
    before = walk32_eval.launches
    got = walk32_eval(aes, *args, xs, b=1, group="add16")
    assert walk32_eval.launches == before
    assert torch.equal(got, walk32_eval_plain(aes, *args, xs, b=1,
                                              group="add16"))
    want = eval_batch_np(HirosePrgNp(32, ck, warn=False), 1, kb,
                         shared[:40])
    assert np.array_equal(got.numpy(), want)
    for bad in (dict(xs=xs.to(torch.int16)), dict(aes=aes[:496]),
                dict(xs=xs[:, :, :1].contiguous())):
        call = dict(aes=aes, xs=xs) | bad
        with pytest.raises(ShapeError):
            walk32_eval(call["aes"], *args, call["xs"], b=1, group="add16")


def test_keygen_dcf32_wrapper_runs_plain_version_on_cpu_tensors():
    """On CPU tensors G2's wrapper is its plain version (``keygen_walk_plain``
    in mode ``MODE_G2``), counts no launch, and refuses other widths."""
    rng = np.random.default_rng(1535)
    ck = [rng.bytes(32) for _ in range(18)]
    ins = [torch.from_numpy(a) for a in (
        rng.integers(0, 256, (5, 2), dtype=np.uint8),
        rng.integers(0, 256, (5, 32), dtype=np.uint8),
        random_s0s(5, 32, rng))]
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    before = keygen_dcf32.launches
    got = keygen_dcf32(aes, *ins, lt=False)
    assert keygen_dcf32.launches == before
    want = keygen_walk_plain(aes, *ins, mode=MODE_G2, lt=False)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    host = gen_batch(HirosePrgNp(32, ck, warn=False),
                     *(a.numpy() for a in ins), Bound.GT_BETA)
    for name, g in zip(("cw_s", "cw_v", "cw_t", "cw_np1"), got):
        assert np.array_equal(g.numpy(), getattr(host, name)), name
    with pytest.raises(ShapeError):
        keygen_dcf32(aes, ins[0], ins[1][:, :16].contiguous(),
                     ins[2][..., :16].contiguous())


@pytest.mark.parametrize("group", ["xor", "add32"])
def test_facade_lam32_matches_dcf_tpu(group):
    """``Dcf(2, 32)`` under ``auto`` (= ``walk``; keygen on G2's plain
    version for XOR, the host walk for add32) against dcf_tpu's facade
    (its bitsliced backend): the same DCFK frames and shares, both
    parties."""
    rng = np.random.default_rng(1540 + len(group))
    ck = [rng.bytes(32) for _ in range(18)]
    alphas = rng.integers(0, 256, (2, N_BYTES), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 32), dtype=np.uint8)
    s0s = random_s0s(2, 32, rng)
    xs = rng.integers(0, 256, (M, N_BYTES), dtype=np.uint8)
    xs[:2] = alphas
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcf = Dcf(N_BYTES, 32, ck, device="cpu")
        ref = JDcf(N_BYTES, 32, ck)
    assert dcf.backend_name == "walk" and ref.backend_name == "bitsliced"
    got = dcf.gen(alphas, betas, s0s=s0s, group=group)
    want = ref.gen(alphas, betas, s0s=s0s, group=group)
    assert got.to_bytes() == want.to_bytes()
    for b in (0, 1):
        y = dcf.eval(b, got, xs)
        assert y.shape == (2, M, 32)
        assert np.array_equal(y, ref.eval(b, want, xs)), b
    assert isinstance(dcf.eval_backend(0), WalkBackend)


@pytest.mark.parametrize("bound", list(Bound))
def test_full_domain_check_device_lam32(bound):
    """Config 3's per-point full domain over two lam = 32 ``WalkBackend``s
    (n = 8, one chunk of 256): 0 for the key's alpha, 7 for alpha + 7."""
    gt = bound is Bound.GT_BETA
    rng = np.random.default_rng(1550 + gt)
    ck = [rng.bytes(32) for _ in range(18)]
    alpha = int(rng.integers(8, 240))
    beta = rng.integers(0, 256, (1, 32), dtype=np.uint8)
    kb = gen_on_device(32, ck, np.array([[alpha]], np.uint8), beta,
                       random_s0s(1, 32, rng), bound, device="cpu")
    be = [_backend(ck) for _ in (0, 1)]
    for b in (0, 1):
        be[b].put_bundle(kb.for_party(b))
    args = (beta[0].tobytes(), 8, gt)
    assert full_domain_check_device(be[0], be[1], alpha, *args) == 0
    assert full_domain_check_device(be[0], be[1], alpha + 7, *args) == 7


def test_mic_lam32_on_walk():
    """MIC at lam = 32 (n = 16, 3 intervals, one wrapping): keys from
    ``Dcf.mic(device=True)`` (G2's plain version) equal the host walk's
    frame, and ``MicEvaluator`` on two lam = 32 ``WalkBackend``s (the pair
    combine on the device) reconstructs ``mic_oracle``."""
    rng = np.random.default_rng(1560)
    ck = [rng.bytes(32) for _ in range(18)]
    intervals = [(10, 4000), (30000, 65536), (60000, 200)]
    betas = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcf = Dcf(N_BYTES, 32, ck, device="cpu")
    pb = dcf.mic(intervals, betas, rng=np.random.default_rng(7),
                 device=True)
    host = dcf.mic(intervals, betas, rng=np.random.default_rng(7))
    assert pb.to_bytes() == host.to_bytes()
    xs = rng.integers(0, 256, (M, N_BYTES), dtype=np.uint8)
    xs[:2] = np.frombuffer((4000).to_bytes(2, "big") + (9).to_bytes(2, "big"),
                           np.uint8).reshape(2, 2)
    ev = [MicEvaluator(dcf, pb, b) for b in (0, 1)]
    assert isinstance(ev[0].backend, WalkBackend)
    got = ev[0].reconstruct_with(ev[1], xs)
    want = mic_oracle(xs, intervals, betas)
    assert np.array_equal(got, want)
    assert np.array_equal(ev[0].eval(xs), dcf.eval_mic(0, pb, xs))
