"""Keygen on the device (kernels G1, G2, B7a and B7b through their plain
versions on the CPU) against dcf_tpu, byte for byte.

The sweep holds ``gen.gen_on_device`` / ``protocols.dpf.dpf_gen_on_device``
to ``dcf_tpu``'s host ``gen_batch`` / ``dpf_gen_batch`` as DCFK frames, at
n = 16, K in {1, 3, 8, 33}, both bounds, lam in {16, 32, 48, 256} and DPF
lam = 32 (the JAX package's own tests pin those to its device kernels).
One tiny run each holds the port against ``dcf_tpu``'s ``DeviceKeyGen`` on
XLA-CPU and its ``PallasKeyGen`` / ``PallasDpfKeyGen`` in interpret mode,
and kernel W2's plain version against ``dcf_tpu``'s XLA wide-tail scan on
the same trajectories.
Then the facade's routing of ``gen`` / ``dpf`` / ``pir_query`` and the
``keygen.device`` fault point, which raises: there is no fallback."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcf_tpu import spec as jspec
from dcf_tpu.backends.device_gen import DeviceKeyGen as JDeviceKeyGen
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.ops.pallas_keygen import (
    PallasDpfKeyGen,
    PallasKeyGen,
    _keygen_wide_tail,
)
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.protocols.dpf import dpf_gen_batch as j_dpf_gen_batch

from dcf_tpu_torch import Bound, Dcf
from dcf_tpu_torch.backends.device_gen import (
    DeviceKeyGen,
    DpfKeyGen,
    HybridKeyGen,
)
from dcf_tpu_torch.gen import gen_on_device, random_s0s
from dcf_tpu_torch.ops.keygen_walk import (
    keygen_narrow,
    keygen_wide_tail_plain,
)
from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
from dcf_tpu_torch.ops.walk_eval import walk_bits_plain
from dcf_tpu_torch.protocols.dpf import dpf_gen_on_device
from dcf_tpu_torch.testing import faults
from tests.torch_threads import one_torch_thread  # noqa: F401


def _ck(rng, lam):
    return [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]


def _inputs(rng, k_num, lam, n_bytes=2):
    return (rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8),
            rng.integers(0, 256, (k_num, lam), dtype=np.uint8),
            random_s0s(k_num, lam, rng))


def _jprg(lam, ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JPrg(lam, ck)


@pytest.mark.parametrize("k_num", [1, 3, 8, 33])
@pytest.mark.parametrize("bound", list(Bound))
@pytest.mark.parametrize("lam", [16, 32, 48, 256])
def test_gen_on_device_frames_match_dcf_tpu(lam, bound, k_num):
    rng = np.random.default_rng(800 + lam + 7 * k_num + len(bound.name))
    ck = _ck(rng, lam)
    alphas, betas, s0s = _inputs(rng, k_num, lam)
    alphas[0] = (0xFF, 0xFF) if k_num > 2 else alphas[0]
    got = gen_on_device(lam, ck, alphas, betas, s0s, bound, device="cpu")
    want = j_gen_batch(_jprg(lam, ck), alphas, betas, s0s,
                       jspec.Bound[bound.name])
    assert got.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("k_num", [1, 3, 8, 33])
def test_dpf_gen_on_device_frames_match_dcf_tpu(k_num):
    rng = np.random.default_rng(850 + k_num)
    ck = _ck(rng, 32)
    alphas, betas, s0s = _inputs(rng, k_num, 32)
    got = dpf_gen_on_device(32, ck, alphas, betas, s0s, device="cpu")
    want = j_dpf_gen_batch(_jprg(32, ck), alphas, betas, s0s)
    assert got.to_bytes() == want.to_bytes()


def test_device_keygen_matches_dcf_tpu_device_gen():
    """G1's plain version against dcf_tpu's keys-in-lanes generator on
    XLA-CPU (its ``_gen_core``), through both ``to_host_bundle``s."""
    rng = np.random.default_rng(860)
    ck = _ck(rng, 16)[:2]
    alphas, betas, s0s = _inputs(rng, 5, 16)
    for bound in Bound:
        dev = DeviceKeyGen(16, ck, device="cpu").gen(alphas, betas, s0s,
                                                     bound)
        assert dev["num_keys"] == 5 and dev["s0s"].shape == (5, 2, 16)
        jg = JDeviceKeyGen(16, ck)
        want = jg.to_host_bundle(jg.gen(alphas, betas, s0s,
                                        jspec.Bound[bound.name]))
        got = DeviceKeyGen.to_host_bundle(dev)
        assert got.to_bytes() == want.to_bytes(), bound


def test_hybrid_and_dpf_keygen_match_pallas_interpret():
    """B7a (+ the wide tail) and B7b's plain versions against the JAX
    kernels in interpret mode, n = 8, K = 3."""
    rng = np.random.default_rng(870)
    ck = _ck(rng, 48)
    alphas, betas, s0s = _inputs(rng, 3, 48, n_bytes=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = PallasKeyGen(48, ck, interpret=True).gen(
            alphas, betas, s0s, jspec.Bound.GT_BETA)
    got = HybridKeyGen(48, ck, device="cpu").gen(alphas, betas, s0s,
                                                 Bound.GT_BETA)
    assert got.to_bytes() == want.to_bytes()
    alphas, betas, s0s = _inputs(rng, 3, 32, n_bytes=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = PallasDpfKeyGen(32, ck, interpret=True).gen(alphas, betas,
                                                           s0s)
    got = DpfKeyGen(32, ck, device="cpu").gen(alphas, betas, s0s)
    assert got.to_bytes() == want.to_bytes()


def _lane_planes(bits: np.ndarray) -> np.ndarray:
    """uint8 [K, n] (0/1) -> the JAX kernels' int32 lane planes [n, 1, W]:
    key k at bit k % 32 of word k // 32."""
    k_num, n = bits.shape
    w = -(-k_num // 32)
    padded = np.zeros((w * 32, n), np.uint64)
    padded[:k_num] = bits
    words = (padded.reshape(w, 32, n)
             << np.arange(32, dtype=np.uint64)[None, :, None]).sum(1)
    return words.astype(np.uint32).view(np.int32).T.reshape(n, 1, w)


@pytest.mark.parametrize("bound", list(Bound))
@pytest.mark.parametrize("lam", [48, 256])
def test_wide_tail_plain_matches_dcf_tpu_scan(lam, bound):
    """W2's plain version against ``dcf_tpu``'s ``_keygen_wide_tail`` (the
    XLA scan behind ``PallasKeyGen``) on the trajectories of B7a's plain
    version, K = 33, n = 16: every wide byte of cw_s, cw_v and cw_np1."""
    rng = np.random.default_rng(900 + lam + len(bound.name))
    ck = _ck(rng, lam)
    k_num, lt = 33, bound is Bound.LT_BETA
    alphas, betas, s0s = _inputs(rng, k_num, lam)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17]))
    ins = [torch.from_numpy(a) for a in (alphas, betas, s0s)]
    cw_s, cw_v, _, cw_np1, traj = keygen_narrow(aes, *ins, lt=lt)
    keygen_wide_tail_plain(cw_s, cw_v, cw_np1, traj, *ins, lt=lt)
    tr = traj.numpy()
    want = _keygen_wide_tail(
        jnp.asarray(s0s[:, :, 32:]), jnp.asarray(betas[:, 32:]),
        jnp.asarray(walk_bits_plain(ins[0]).numpy()),
        jnp.asarray(_lane_planes(tr[..., 0])),
        jnp.asarray(_lane_planes(tr[..., 1])), lam=lam, lt_beta=lt,
        k_num=k_num)
    for name, got, w in zip(("cw_s", "cw_v", "cw_np1"),
                            (cw_s, cw_v, cw_np1), want):
        assert np.array_equal(got.numpy()[..., 32:], np.asarray(w)), name


def test_keygen_device_fault_raises():
    """An injected ``keygen.device`` failure reaches the caller of
    ``gen_on_device``, ``dpf_gen_on_device`` and the facade: no host
    walk takes over (the port's counterpart of dcf_tpu's
    test_keygen_device_fault_falls_back_counted)."""
    rng = np.random.default_rng(880)
    ck = _ck(rng, 32)
    seen = []
    with faults.inject("keygen.device", handler=faults.fail_unless(
            lambda k, lam: seen.append((k, lam)) and False)):
        for lam in (16, 48):
            alphas, betas, s0s = _inputs(rng, 2, lam)
            with pytest.raises(faults.InjectedFault):
                gen_on_device(lam, ck, alphas, betas, s0s, Bound.LT_BETA,
                              device="cpu")
        alphas, betas, s0s = _inputs(rng, 2, 32)
        with pytest.raises(faults.InjectedFault):
            dpf_gen_on_device(32, ck, alphas, betas, s0s, device="cpu")
    assert seen == [(2, 16), (2, 48), (2, 32)]
    with faults.inject("keygen.device"):
        with pytest.raises(faults.InjectedFault):
            Dcf(2, 16, ck[:2], device="cpu").gen(alphas[:, :2],
                                                 betas[:, :16])


def test_facade_keygen_routing():
    """``device=None`` takes a keygen kernel where one exists (XOR at
    lam = 16, 32 and >= 48, DPF at lam = 32; its plain version on a CPU
    facade, seen through the armed fault point) and the host walk where
    none does; ``device=False`` is the host walk; ``device=True`` without
    a kernel raises.  At lam = 32 DCF keys take kernel G2, with the host
    walk's bytes."""
    rng = np.random.default_rng(890)
    ck = _ck(rng, 48)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d16, d32, d48 = (Dcf(2, lam, ck, device="cpu") for lam in (16, 32,
                                                                  48))
    a = rng.integers(0, 256, (2, 2), dtype=np.uint8)

    def beta(lam):
        return rng.integers(0, 256, (2, lam), dtype=np.uint8)

    with faults.inject("keygen.device"):
        for dcf in (d16, d32, d48):
            with pytest.raises(faults.InjectedFault):
                dcf.gen(a, beta(dcf.lam), rng=rng)
            dcf.gen(a, beta(dcf.lam), rng=rng, device=False)
            dcf.gen(a, beta(dcf.lam), rng=rng, group="add16")  # host walk
        with pytest.raises(faults.InjectedFault):
            d32.dpf(a, rng=rng)
        with pytest.raises(faults.InjectedFault):
            d32.pir_query([3, 9], rng=rng)
        d32.dpf(a, rng=rng, device=False)
        d48.dpf(a, rng=rng)  # no DPF kernel at lam = 48: the host walk
        d48.pir_query([3], rng=rng)
    with pytest.raises(ValueError, match="additive algebra"):
        d16.gen(a, beta(16), rng=rng, group="add8", device=True)
    for call in (lambda: d48.dpf(a, rng=rng, device=True),
                 lambda: d48.pir_query([3], rng=rng, device=True)):
        with pytest.raises(ValueError, match="lam=32 only"):
            call()
    s0s, b32 = random_s0s(2, 32, rng), beta(32)
    assert d32.gen(a, b32, s0s=s0s).to_bytes() == gen_on_device(
        32, ck, a, b32, s0s, Bound.LT_BETA, device="cpu").to_bytes() \
        == d32.gen(a, b32, s0s=s0s, device=False).to_bytes()
    assert d32.pir_query([3, 9], s0s=s0s).to_bytes() == d32.pir_query(
        [3, 9], s0s=s0s, device=False).to_bytes()
