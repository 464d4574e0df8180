"""The port's fixed-point gates (``dcf_tpu_torch.protocols.fixedpoint``:
the lane codec, signed comparison, faithful truncation, spline sigmoid)
against ``dcf_tpu``'s, byte for byte, and the additive MIC under them.

One seeded ``np.random.Generator`` per package, from the same seed: the
gate keygen draws in ``dcf_tpu``'s order (a bundle's root seeds inside
its ``gen``, truncation's ``c0`` after both of its bundles, sigmoid's
cuts shifted by r before ``mic``), so the gates' frames, their constant
shares and each party's output shares equal ``dcf_tpu``'s (its ``numpy``
facade); the reconstructions equal the clear-input oracles.  The port
runs through its ``walk`` and ``prefix`` backends (the kernels' plain
versions, ``device="cpu"``) and ``numpy``; truncation's low half (one
byte, n = 8 levels) is on ``walk``, as ``prefix`` needs 14 levels or
more.  Truncation needs the group width to equal the domain's bits and
a whole-byte fraction, so it runs in add16 (n = 16, f = 8) and add32
(n = 32, f = 16); add8 has no such domain.  Tolerance: exact equality."""

import numpy as np
import pytest

from dcf_tpu import Dcf as JDcf
from dcf_tpu.protocols import fixedpoint as jfp
from dcf_tpu.spec import Bound as JBound

from dcf_tpu_torch import Dcf
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.protocols import fixedpoint as tfp
from dcf_tpu_torch.protocols import mic_oracle
from dcf_tpu_torch.spec import Bound
from dcf_tpu_torch.utils.groups import np_group_add
from tests.torch_threads import one_torch_thread  # noqa: F401

LAM = 16
JB = {Bound.LT_BETA: JBound.LT_BETA, Bound.GT_BETA: JBound.GT_BETA}
CK = [bytes(range(3, 35)), bytes(range(9, 41))]
_FACADES = {}


def facade(backend, n_bytes=2):
    key = (backend, n_bytes)
    if key not in _FACADES:
        _FACADES[key] = Dcf(n_bytes, LAM, CK, backend=backend, device="cpu")
    return _FACADES[key]


def jfacade(n_bytes=2):
    key = ("jax", n_bytes)
    if key not in _FACADES:
        _FACADES[key] = JDcf(n_bytes, LAM, CK, backend="numpy")
    return _FACADES[key]


def gate_points(seed, n_bits, n=100):
    """Random masked inputs plus 0, 1, N - 1, the sign boundary and the
    f = 8 carry edges."""
    top = 1 << n_bits
    return np.concatenate([
        np.random.default_rng(seed).integers(0, top, size=n,
                                             dtype=np.int64),
        np.array([0, 1, top - 1, top // 2, top // 2 - 1, 255, 256, 257],
                 dtype=np.int64)])


def same_bundle(pb, jpb):
    assert pb.to_bytes() == jpb.to_bytes()
    for b in (0, 1):
        assert pb.for_party(b).to_bytes() == jpb.for_party(b).to_bytes()


def shares(fn, jfn, gate, jgate, x_hat):
    """Both parties' shares (from party-restricted gates) equal
    dcf_tpu's."""
    out = []
    for b in (0, 1):
        y = fn(b, gate.for_party(b), x_hat)
        assert np.array_equal(y, jfn(b, jgate.for_party(b), x_hat)), b
        out.append(y)
    return out


# ------------------------------------------------------------ lane codec


@pytest.mark.parametrize("group", ["add8", "add16", "add32"])
def test_lane_codec_matches(group):
    vals = np.array([5, -3, 70000, 0, -(1 << 40)])
    enc = tfp.encode_lanes(vals, group, LAM)
    assert np.array_equal(enc, jfp.encode_lanes(vals, group, LAM))
    w = int(group[3:])
    assert tfp.decode_lanes(enc, group).tolist() == [
        int(v) % (1 << w) for v in vals]
    assert np.array_equal(tfp.points_of(vals, 2), jfp.points_of(vals, 2))
    y0, y1 = enc, tfp.encode_lanes(vals[::-1], group, LAM)
    assert np.array_equal(tfp.gate_reconstruct(y0, y1, group),
                          jfp.gate_reconstruct(y0, y1, group))
    with pytest.raises(ShapeError):
        tfp.encode_lanes(np.array([1.5]), group, LAM)
    with pytest.raises(ShapeError):
        tfp.points_of(np.array([1.5]), 2)
    with pytest.raises(ShapeError):
        tfp.encode_lanes(np.array([1]), "xor", LAM)


# ------------------------------------------------------------- sign gate


@pytest.mark.parametrize("group", ["add8", "add16", "add32"])
@pytest.mark.parametrize("backend", ["walk", "prefix", "numpy"])
def test_sign_gate(backend, group):
    """beta * [x < 0]: one wraparound IC at [2^15 + r, r) on the masked
    input, for every mask class (0, 1, the sign boundary, N - 1)."""
    d, jd = facade(backend), jfacade()
    x_hat = gate_points(31, 16)
    for r in (0, 1, 12345, 1 << 15, (1 << 16) - 1, 0x00FF):
        g = tfp.gen_sign_gate(d, r, np.random.default_rng(r), group)
        jg = jfp.gen_sign_gate(jd, r, np.random.default_rng(r), group)
        same_bundle(g.pb, jg.pb)
        y0, y1 = shares(
            lambda b, gg, x: tfp.eval_sign_share(d, b, gg, x),
            lambda b, gg, x: jfp.eval_sign_share(jd, b, gg, x),
            g, jg, x_hat)
        got = tfp.gate_reconstruct(y0, y1, group)
        assert np.array_equal(
            got, tfp.sign_oracle((x_hat - r) % (1 << 16), 16)), r
        assert np.array_equal(tfp.sign_oracle(x_hat, 16),
                              jfp.sign_oracle(x_hat, 16))


# ------------------------------------------------------------ truncation


@pytest.mark.parametrize("backend", ["walk", "numpy"])
@pytest.mark.parametrize("wide", [False, True])
def test_trunc_gate(backend, wide):
    """Faithful truncation: the borrow IC on the low f bits (a facade of
    f/8 bytes), the wrap IC on the full domain and the constant shares
    drawn after both bundles; n = 16, f = 8 in add16, and the wide domain
    n = 32, f = 16 in add32."""
    nb, f, group = (4, 16, "add32") if wide else (2, 8, "add16")
    n_bits = 8 * nb
    d, d_low = facade(backend, nb), facade(backend, nb - f // 8)
    jd, jd_low = jfacade(nb), jfacade(nb - f // 8)
    x_hat = gate_points(32, n_bits, n=60)
    top = 1 << n_bits
    rs = ((0, 0xDEADBEEF, 0x0000FFFF, top - 1) if wide
          else (0, 1, 0x1200, 0x00FF, 0xFF00, top - 1, 54321))
    for r in rs:
        g = tfp.gen_trunc_gate(d, d_low, r, f, np.random.default_rng(r),
                               group)
        jg = jfp.gen_trunc_gate(jd, jd_low, r, f, np.random.default_rng(r),
                                group)
        same_bundle(g.pb_low, jg.pb_low)
        same_bundle(g.pb_wrap, jg.pb_wrap)
        assert np.array_equal(g.const_share, jg.const_share)
        y0, y1 = shares(
            lambda b, gg, x: tfp.eval_trunc_share(d, d_low, b, gg, x),
            lambda b, gg, x: jfp.eval_trunc_share(jd, jd_low, b, gg, x),
            g, jg, x_hat)
        got = tfp.gate_reconstruct(y0, y1, group)
        want = tfp.trunc_oracle(x_hat, r, f, n_bits)
        assert np.array_equal(want, jfp.trunc_oracle(x_hat, r, f, n_bits))
        assert np.array_equal(got, want), r


def test_trunc_gate_contracts():
    d, d_low = facade("walk"), facade("walk", 1)
    g = tfp.gen_trunc_gate(d, d_low, 0x1234, 8, np.random.default_rng(7),
                           "add16")
    g0 = g.for_party(0)
    assert g0.const_for(0).shape == (LAM,)
    with pytest.raises(ShapeError):
        g0.const_for(1)
    text = repr(g) + repr(g0)
    assert "TruncGate(f=8" in text
    for b in (0, 1):
        assert g.const_for(b).tobytes().hex() not in text
    rng = np.random.default_rng(0)
    with pytest.raises(ShapeError):
        tfp.gen_trunc_gate(d, d_low, 1, 4, rng, "add16")  # f not bytes
    with pytest.raises(ShapeError):
        tfp.gen_trunc_gate(d, d_low, 1, 8, rng, "add32")  # width != n
    with pytest.raises(ShapeError):
        tfp.gen_trunc_gate(d, d, 1, 8, rng, "add16")  # low facade width
    with pytest.raises(ShapeError):
        tfp.gen_sign_gate(d, 5, rng, "xor")


# --------------------------------------------------------------- sigmoid


def test_sigmoid_table_contract():
    for n_bits, f, m in ((16, 8, 16), (16, 8, 32), (16, 8, 8), (16, 6, 8)):
        cuts, vals = tfp.sigmoid_table(n_bits, f, m)
        jcuts, jvals = jfp.sigmoid_table(n_bits, f, m)
        assert list(cuts) == list(jcuts) and np.array_equal(vals, jvals)
        assert vals.dtype == np.int64 and cuts[0] == 0 and len(cuts) == m
    cuts, vals = tfp.sigmoid_table(16, 8, 16)
    assert vals.min() == 0 and vals.max() <= 256
    mid = tfp.sigmoid_fixed_oracle(np.array([0]), cuts, vals)[0]
    assert abs(int(mid) - 128) <= 40, mid
    for bad in ((16, 8, 15), (16, 8, 2), (16, 16, 16), (8, 1, 64)):
        with pytest.raises(ShapeError):
            tfp.sigmoid_table(*bad)


def test_sigmoid_accuracy_pin():
    """m = 32 table, max abs error against the real sigmoid below 0.08
    (slope x half a piece, 0.25 * 8/15)."""
    cuts, vals = tfp.sigmoid_table(16, 8, 32)
    xs = np.arange(0, 1 << 16, 37, dtype=np.int64)
    tab = tfp.sigmoid_fixed_oracle(xs, cuts, vals) / 256
    signed = np.where(xs >= 1 << 15, xs - (1 << 16), xs)
    assert np.abs(tab - 1 / (1 + np.exp(-signed / 256))).max() < 0.08
    assert np.array_equal(tfp.sigmoid_fixed_oracle(xs, cuts, vals),
                          jfp.sigmoid_fixed_oracle(xs, cuts, vals))


@pytest.mark.parametrize("group", ["add8", "add16", "add32"])
@pytest.mark.parametrize("backend", ["walk", "prefix", "numpy"])
def test_sigmoid_gate(backend, group):
    """The r-shifted partition is still a partition: the reconstruction
    equals the table at the unmasked input (m = 8 pieces, the gate
    bench's table).  add8 takes f = 6, so that the table's values (up to
    2^f) fit a lane."""
    d, jd = facade(backend), jfacade()
    f = 6 if group == "add8" else 8
    x_hat = gate_points(33, 16, n=40)
    for r in (0, 7, 0x8000, (1 << 16) - 1):
        g = tfp.gen_sigmoid_gate(d, r, np.random.default_rng(r), group,
                                 f=f, m=8)
        jg = jfp.gen_sigmoid_gate(jd, r, np.random.default_rng(r), group,
                                  f=f, m=8)
        same_bundle(g.pb, jg.pb)
        assert g.cuts == jg.cuts and np.array_equal(g.values, jg.values)
        y0, y1 = shares(
            lambda b, gg, x: tfp.eval_sigmoid_share(d, b, gg, x),
            lambda b, gg, x: jfp.eval_sigmoid_share(jd, b, gg, x),
            g, jg, x_hat)
        got = tfp.gate_reconstruct(y0, y1, group)
        want = tfp.sigmoid_fixed_oracle((x_hat - r) % (1 << 16), g.cuts,
                                        g.values)
        assert np.array_equal(got, want), r


# ------------------------------------------ additive MIC under the gates


IV = [(10, 60), (60, 300), (300, 4096), (40000, 40001), (60000, 1 << 16),
      (5000, 5000), (0, 1 << 16), (50000, 2000)]


@pytest.mark.parametrize("backend", ["walk", "prefix", "numpy"])
def test_additive_mic_backend_parity(backend):
    """Every port backend equals dcf_tpu on the additive MIC, both
    parties, both bounds, all three groups, points on the cuts."""
    d, jd = facade(backend), jfacade()
    xs = np.vstack([
        np.random.default_rng(34).integers(0, 256, (40, 2), np.uint8),
        np.array([[0, 10], [0, 59], [0, 60], [19, 136], [234, 96],
                  [255, 255], [0, 0], [195, 80]], dtype=np.uint8)])
    for group in ("add8", "add16", "add32"):
        for bound in Bound:
            rngs = [np.random.default_rng(35), np.random.default_rng(35)]
            betas = rngs[0].integers(0, 256, (len(IV), LAM), np.uint8)
            jbetas = rngs[1].integers(0, 256, (len(IV), LAM), np.uint8)
            pb = d.mic(IV, betas, bound=bound, rng=rngs[0], group=group)
            jpb = jd.mic(IV, jbetas, bound=JB[bound], rng=rngs[1],
                         group=group)
            assert pb.group == group
            same_bundle(pb, jpb)
            ys = [d.eval_mic(b, pb.for_party(b), xs) for b in (0, 1)]
            for b in (0, 1):
                assert np.array_equal(
                    ys[b], jd.eval_mic(b, jpb.for_party(b), xs))
            assert np.array_equal(np_group_add(ys[0], ys[1], group),
                                  mic_oracle(xs, IV, betas)), (group, bound)
