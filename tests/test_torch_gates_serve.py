"""The port's served gates (``workloads.gates.GateServer`` over
``serve.DcfService``) against ``dcf_tpu``'s, byte for byte.

One seeded ``np.random.Generator`` per package, from the same seed: the
gate keygen draws in ``dcf_tpu``'s order (a bundle's root seeds inside
its ``gen``, truncation's ``c0`` after both of its bundles, the
sigmoid's cuts shifted by r before ``mic``), so every registered
component's frame and each party's served share equal ``dcf_tpu``'s,
whose ``GateServer`` runs over services on its ``numpy`` facades.  The
port serves on ``walk`` and ``prefix`` (the kernels' plain versions,
``device="cpu"``; truncation's one-byte low half on ``walk``) with
started worker threads, as a gate's submits wait on their futures.  The
reconstructions equal the clear-input oracles.  Sign and sigmoid run in
add8 and add16; truncation in add16 (it needs the group width to equal
the domain's bits).  Tolerance: exact byte equality."""

import numpy as np
import pytest

from dcf_tpu import Dcf as JDcf
from dcf_tpu.protocols import fixedpoint as jfp
from dcf_tpu.workloads import GateServer as JGateServer

from dcf_tpu_torch import Dcf
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.protocols import fixedpoint as fp
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.workloads import GateServer
from tests.torch_threads import one_torch_thread  # noqa: F401

LAM, W = 16, 16
N = 1 << W
CK = [bytes(range(3, 35)), bytes(range(9, 41))]


def x_points(seed, n=48):
    return np.concatenate([
        np.random.default_rng(seed).integers(0, N, size=n, dtype=np.int64),
        np.array([0, 1, N - 1, N // 2, N // 2 - 1, 255, 256, 257],
                 dtype=np.int64)])


class Pair:
    """A port gate server on ``backend`` and ``dcf_tpu``'s on numpy, each
    over a main (n = 16) and a low (n = 8) service, workers started."""

    def __init__(self, backend):
        self.d = Dcf(2, LAM, CK, backend=backend, device="cpu")
        self.d_low = Dcf(1, LAM, CK, backend="walk", device="cpu")
        self.jd = JDcf(2, LAM, CK, backend="numpy")
        self.jd_low = JDcf(1, LAM, CK, backend="numpy")
        self.svcs = [f.serve(max_batch=64, max_delay_ms=0.5).start()
                     for f in (self.d, self.d_low, self.jd, self.jd_low)]
        self.gs = GateServer(self.svcs[0], self.svcs[1])
        self.jgs = JGateServer(self.svcs[2], self.svcs[3])

    def close(self):
        for s in self.svcs:
            s.close()


@pytest.fixture(params=["walk", "prefix"])
def pair(request):
    p = Pair(request.param)
    yield p
    p.close()


def check_served(pair, gate_id, x_hat, group, oracle):
    for b in (0, 1):
        y = pair.gs.eval_share(gate_id, b, x_hat)
        assert np.array_equal(y, pair.jgs.eval_share(gate_id, b, x_hat)), b
    got = fp.decode_lanes(pair.gs.reconstruct(gate_id, x_hat), group)
    assert np.array_equal(got, oracle)


@pytest.mark.parametrize("group", ["add8", "add16"])
def test_served_sign_gate_equals_dcf_tpu(pair, group):
    for r in (0, 0x8000, 0x1234):
        g = fp.gen_sign_gate(pair.d, r, np.random.default_rng(r), group)
        jg = jfp.gen_sign_gate(pair.jd, r, np.random.default_rng(r), group)
        assert g.pb.to_bytes() == jg.pb.to_bytes()
        pair.gs.register("cmp", g)
        pair.jgs.register("cmp", jg)
        x_hat = x_points(r)
        check_served(pair, "cmp", x_hat, group,
                     fp.sign_oracle((x_hat - r) % N, W))


def test_served_trunc_gate_equals_dcf_tpu(pair):
    for r in (0xBEEF, 7):
        g = fp.gen_trunc_gate(pair.d, pair.d_low, r, 8,
                              np.random.default_rng(r), "add16")
        jg = jfp.gen_trunc_gate(pair.jd, pair.jd_low, r, 8,
                                np.random.default_rng(r), "add16")
        assert g.pb_wrap.to_bytes() == jg.pb_wrap.to_bytes()
        assert g.pb_low.to_bytes() == jg.pb_low.to_bytes()
        pair.gs.register("trunc", g)
        pair.jgs.register("trunc", jg)
        x_hat = x_points(r)
        check_served(pair, "trunc", x_hat, "add16",
                     fp.trunc_oracle(x_hat, r, 8, W))


@pytest.mark.parametrize("group", ["add8", "add16"])
def test_served_sigmoid_gate_equals_dcf_tpu(pair, group):
    f = 6 if group == "add8" else 8
    for r in (0x00FF, 0x8421):
        g = fp.gen_sigmoid_gate(pair.d, r, np.random.default_rng(r), group,
                                f=f, m=8)
        jg = jfp.gen_sigmoid_gate(pair.jd, r, np.random.default_rng(r),
                                  group, f=f, m=8)
        assert g.pb.to_bytes() == jg.pb.to_bytes()
        pair.gs.register("sig", g)
        pair.jgs.register("sig", jg)
        x_hat = x_points(r, n=24)
        check_served(pair, "sig", x_hat, group, fp.sigmoid_fixed_oracle(
            (x_hat - r) % N, g.cuts, g.values))
        assert pair.gs.gate("sig") is g


def test_served_gate_retries_a_combine_fault():
    """An injected ``protocols.combine`` fault on the device combine is
    retried by the service from the registry snapshot; the share is the
    same."""
    p = Pair("walk")
    try:
        g = fp.gen_sign_gate(p.d, 99, np.random.default_rng(1), "add16")
        p.gs.register("cmp", g)
        x_hat = x_points(5)
        want = p.gs.eval_share("cmp", 0, x_hat)
        calls = {"n": 0}

        def fail_first(*_args):
            calls["n"] += 1
            if calls["n"] == 1:
                raise faults.InjectedFault("combine lost")

        with faults.inject("protocols.combine", handler=fail_first):
            got = p.gs.eval_share("cmp", 0, x_hat)
        assert calls["n"] >= 2 and np.array_equal(got, want)
        assert p.svcs[0].metrics_snapshot()["serve_retries_total"] == 1
    finally:
        p.close()


def test_gate_server_typed_refusals():
    d = Dcf(2, LAM, CK, backend="walk", device="cpu")
    d_low = Dcf(1, LAM, CK, backend="walk", device="cpu")
    svc = d.serve()
    try:
        gs = GateServer(svc)
        with pytest.raises(ShapeError):
            gs.register("t", fp.gen_trunc_gate(
                d, d_low, 1, 8, np.random.default_rng(0), "add16"))
        with pytest.raises(ShapeError):
            gs.register("x", object())
        with pytest.raises(ShapeError):
            gs.eval_share("missing", 0, np.array([1]))
    finally:
        svc.close()
