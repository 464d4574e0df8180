"""The many-keys path on the CPU: kernel B8's plain version, KeyLanesBackend,
the facade's ``keylanes`` backend and the secure-ReLU workload (BASELINE.json
config 5) against dcf_tpu, byte for byte; and the key slicing that lifts the
65,535-key grid limit of kernels B1-B6 and W1.

The JAX side runs ``KeyLanesPallasBackend`` and
``workloads.secure_relu_check_device`` in interpret mode at tiny tiles
(``m_tile=2, kw_tile=1``, as tests/test_pallas_keylanes.py does)."""

import warnings

import numpy as np
import pytest
import torch

from dcf_tpu import spec as jspec
from dcf_tpu.backends.pallas_keylanes import KeyLanesPallasBackend
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.workloads.core import (
    secure_relu_check_device as j_secure_relu_check_device,
)

from dcf_tpu_torch import Bound, Dcf, ShapeError, StaleStateError
from dcf_tpu_torch.backends.device_gen import DeviceKeyGen
from dcf_tpu_torch.backends.keylanes_backend import KeyLanesBackend
from dcf_tpu_torch.backends.walk_backend import WalkBackend
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.ops._launch import MAX_GRID_Y, key_slices
from dcf_tpu_torch.ops.keylanes_eval import keylanes_eval
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.workloads import secure_relu_check_device, secure_relu_eval
from tests.torch_threads import one_torch_thread  # noqa: F401


def _setup(seed, k_num, n_bytes, m, bound=Bound.LT_BETA):
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32), rng.bytes(32)]
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, 16), dtype=np.uint8)
    s0s = random_s0s(k_num, 16, rng)
    bundle = gen_batch(HirosePrgNp(16, ck), alphas, betas, s0s, bound)
    xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
    xs[0] = alphas[0]  # x = alpha
    return ck, alphas, betas, s0s, bundle, xs


@pytest.mark.parametrize("k_num, want", [
    (0, []), (1, [(0, 1)]), (MAX_GRID_Y, [(0, MAX_GRID_Y)]),
    (MAX_GRID_Y + 2, [(0, MAX_GRID_Y), (MAX_GRID_Y, 2)]),
    (3 * MAX_GRID_Y, [(0, MAX_GRID_Y), (MAX_GRID_Y, MAX_GRID_Y),
                      (2 * MAX_GRID_Y, MAX_GRID_Y)])])
def test_key_slices_cover_the_keys(k_num, want):
    assert key_slices(k_num) == want


def test_key_slices_contract():
    assert key_slices(5, limit=2) == [(0, 2), (2, 2), (4, 1)]
    with pytest.raises(ValueError):
        key_slices(5, limit=0)


@pytest.mark.parametrize("b", [0, 1])
def test_keylanes_matches_pallas_interpret(b):
    """B8's plain version (through KeyLanesBackend) against dcf_tpu's
    keylanes kernel in interpret mode, and against the wrapper called
    directly on G1's image."""
    ck, alphas, betas, s0s, bundle, xs = _setup(900, 5, 2, 6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jbe = KeyLanesPallasBackend(16, ck, m_tile=2, kw_tile=1,
                                    level_chunk=8, interpret=True)
    jb = j_gen_batch(JPrg(16, ck), alphas, betas, s0s, jspec.Bound.LT_BETA)
    want = jbe.eval(b, xs, bundle=jb)
    be = KeyLanesBackend(16, ck, device="cpu")
    assert np.array_equal(be.eval(b, xs, bundle=bundle), want)
    dev = DeviceKeyGen(16, ck, device="cpu").gen(alphas, betas, s0s,
                                                 Bound.LT_BETA)
    y = keylanes_eval(be.aes, dev["s0s"], dev["cw_s"], dev["cw_v"],
                      dev["cw_t"], dev["cw_np1"],
                      torch.from_numpy(xs[None].copy()), b=b)
    assert np.array_equal(y.numpy(), want)


def test_keylanes_backend_contract():
    ck, alphas, betas, s0s, bundle, xs = _setup(910, 3, 2, 4)
    be = KeyLanesBackend(16, ck, device="cpu")
    with pytest.raises(StaleStateError):
        be.stage(xs)
    with pytest.raises(ShapeError, match="two-party"):
        be.put_bundle(bundle.for_party(0))
    add = gen_batch(HirosePrgNp(16, ck), alphas, betas, s0s, Bound.LT_BETA,
                    group="add16")
    with pytest.raises(ShapeError, match="XOR-only"):
        be.put_bundle(add)
    be.put_bundle(bundle)
    assert be.num_keys == 3
    with pytest.raises(ShapeError, match="shared points"):
        be.stage(np.zeros((3, 4, 2), np.uint8))
    with pytest.raises(ShapeError, match="width"):
        be.stage(np.zeros((4, 3), np.uint8))
    staged = be.stage(xs)
    y0, y1 = (be.eval_staged(b, staged) for b in (0, 1))
    assert int(be.relu_mismatch_count(y0, y1, alphas, betas, staged)) == 0
    with pytest.raises(ShapeError, match="alphas"):
        be.relu_mismatch_count(y0, y1, alphas[:2], betas[:2], staged)
    with pytest.raises(ValueError, match="lam=16"):
        KeyLanesBackend(48, ck * 9, device="cpu")


def test_facade_keylanes_backend():
    """``backend="keylanes"``: one two-party image shared by both parties,
    shipped once; shares equal the walk backend's; XOR only."""
    ck, alphas, betas, s0s, bundle, xs = _setup(920, 4, 2, 9, Bound.GT_BETA)
    dcf = Dcf(2, 16, ck, backend="keylanes", device="cpu")
    walk = Dcf(2, 16, ck, backend="walk", device="cpu")
    ys = [dcf.eval(b, bundle, xs) for b in (0, 1)]
    assert dcf.eval_backend(0) is dcf.eval_backend(1)
    image = dcf.eval_backend(0)._bundle_dev
    for b in (0, 1):
        assert np.array_equal(ys[b], walk.eval(b, bundle, xs))
    assert dcf.eval_backend(1)._bundle_dev is image  # shipped once
    with pytest.raises(ShapeError, match="two-party"):
        dcf.eval(0, bundle.for_party(0), xs)
    with pytest.raises(ValueError, match="tiling"):
        Dcf(2, 16, ck, backend="keylanes", backend_opts={"kw_tile": 1},
            device="cpu")
    add = dcf.gen(alphas, betas, s0s=s0s, group="add8")
    with pytest.raises(ShapeError, match="XOR-only"):
        dcf.eval(0, add, xs)


def test_secure_relu_check_device_matches_dcf_tpu():
    """Config 5's pipeline at K = 70 keys in chunks of 32 (a ragged tail),
    n = 16, M = 8: 0 mismatches in both packages; with one alpha moved
    past a point, the recount of that chunk's shares is not 0."""
    ck, alphas, betas, s0s, _, xs = _setup(930, 70, 2, 8)
    xs[1] = alphas[40]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert j_secure_relu_check_device(16, ck, alphas, betas, s0s, xs,
                                          key_chunk=32, kw_tile=1,
                                          interpret=True) == 0
    a40 = int.from_bytes(alphas[40].tobytes(), "big")
    assert a40 < 0xFFFF
    seen = []

    def audit(lo, hi, y0, y1, be):
        moved = alphas[lo:hi].copy()
        if lo <= 40 < hi:  # x = old alpha < new alpha: beta, not 0
            moved[40 - lo] = np.frombuffer((a40 + 1).to_bytes(2, "big"),
                                           dtype=np.uint8)
        staged = be.stage(xs)
        seen.append((lo, hi, int(be.relu_mismatch_count(
            y0, y1, moved, betas[lo:hi], staged))))

    assert secure_relu_check_device(16, ck, alphas, betas, s0s, xs,
                                    key_chunk=32, device="cpu",
                                    on_chunk=audit) == 0
    assert [(lo, hi) for lo, hi, _ in seen] == [(0, 32), (32, 64), (64, 70)]
    assert [c for _, _, c in seen] == [0, 1, 0]


def test_secure_relu_eval_streams_keys():
    """The host-edge workload over two walk backends: the reconstruction
    equals beta * [x < alpha] for every key and point, K = 70 in chunks of
    32."""
    ck, alphas, betas, _, bundle, xs = _setup(940, 70, 2, 8)
    bes = [WalkBackend(16, ck, device="cpu") for _ in (0, 1)]
    recon = secure_relu_eval(bes[0], bes[1], bundle, xs, key_chunk=32)
    for i in range(70):
        for j in range(8):
            want = (betas[i].tobytes() if xs[j].tobytes() <
                    alphas[i].tobytes() else bytes(16))
            assert recon[i, j].tobytes() == want, (i, j)
