"""The port's interval protocols (``dcf_tpu_torch.protocols``: oracle,
keygen, combine, IC, MIC, piecewise) against ``dcf_tpu``'s, byte for byte.

The same seeded ``np.random.Generator`` drives both packages, so every
draw (betas, root seeds) happens in the same order on both sides.  Each
case compares the port's ``ProtocolBundle.to_bytes()`` and each party's
shares with ``dcf_tpu``'s (its ``numpy`` facade), then the reconstruction
with the oracle.  The port runs through its ``walk`` and ``prefix``
backends (the kernels' plain versions, ``device="cpu"``), ``numpy`` and
``cpu`` (the C++ core, XOR), the staged ``MicEvaluator`` with its combine
on the device (the CPU here) and its ``keylanes`` branch.  Frames are
written by one package and read by the other, for v3 (XOR) and v4
(add8 / add16 / add32), both bounds, both parties.  Tolerance: exact
byte equality."""

import numpy as np
import pytest

from dcf_tpu import Dcf as JDcf
from dcf_tpu.errors import KeyFormatError as JKeyFormatError
from dcf_tpu.protocols import ProtocolBundle as JProtocolBundle
from dcf_tpu.protocols import interval_bound_alphas as j_alphas
from dcf_tpu.protocols import oracle as joracle
from dcf_tpu.spec import Bound as JBound

from dcf_tpu_torch import Dcf
from dcf_tpu_torch.errors import KeyFormatError, ShapeError
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.protocols import (
    MicEvaluator,
    ProtocolBundle,
    decode_proto_frame,
    dpf_oracle,
    eval_interval,
    eval_mic,
    gen_interval_bundle,
    ic_oracle,
    interval_bound_alphas,
    mic_oracle,
    partition_intervals,
    piecewise_oracle,
)
from dcf_tpu_torch.spec import Bound
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.utils.groups import np_group_add
from tests.torch_threads import one_torch_thread  # noqa: F401

NB, LAM = 2, 16
N = 1 << 16
JB = {Bound.LT_BETA: JBound.LT_BETA, Bound.GT_BETA: JBound.GT_BETA}
CK = [bytes(range(32)), bytes(range(7, 39))]

#: The MIC shape of ``tests/test_protocols.py``: 8 intervals, every edge
#: class at once (plain, adjacent, empty, single point, wraparound, the
#: N-as-upper-bound suffix).
MIC_INTERVALS = [(10, 200), (200, 300), (300, 1000), (5000, 5000),
                 (6000, 6001), (40000, 50000), (60000, 2000), (65000, N)]


def edge_points(intervals, seed=0, extra=40):
    """x = b - 1, b, b + 1 for every bound b, the domain corners, and
    ``extra`` random points (a count that is no multiple of 32, so the
    walk's pad points are in play)."""
    pts = {0, 1, N - 1}
    for p, q in intervals:
        for b in (p, q):
            pts |= {(b + d) % N for d in (-1, 0, 1)}
    rnd = np.random.default_rng(seed).integers(0, N, extra)
    xs = sorted(pts) + [int(x) for x in rnd]
    return np.array([[x >> 8, x & 0xFF] for x in xs], dtype=np.uint8)


_FACADES = {}


def facade(backend, n_bytes=NB):
    """A cached port facade on the CPU."""
    key = (backend, n_bytes)
    if key not in _FACADES:
        _FACADES[key] = Dcf(n_bytes, LAM, CK, backend=backend, device="cpu")
    return _FACADES[key]


@pytest.fixture(scope="module")
def jdcf():
    return JDcf(NB, LAM, CK, backend="numpy")


def both(seed, make, dcf, jdcf):
    """``make(rng, facade, bound_map)`` on each package from one seed."""
    return (make(np.random.default_rng(seed), dcf, lambda b: b),
            make(np.random.default_rng(seed), jdcf, JB.get))


def same_frames(pb, jpb):
    data = pb.to_bytes()
    assert data == jpb.to_bytes()
    for b in (0, 1):
        assert pb.for_party(b).to_bytes() == jpb.for_party(b).to_bytes()
    return data


def check_parties(fn, pb, jfn, jpb, xs, group="xor"):
    """Both parties' shares equal dcf_tpu's; returns their group sum."""
    ys = []
    for b in (0, 1):
        y = fn(b, pb, xs)
        assert y.dtype == np.uint8
        assert np.array_equal(y, jfn(b, jpb, xs)), f"party {b}"
        ys.append(y)
    return np_group_add(ys[0], ys[1], group)


def mic_pair(seed, dcf, jdcf, intervals=MIC_INTERVALS, bound=Bound.LT_BETA,
             group="xor"):
    def make(rng, d, bmap):
        betas = rng.integers(0, 256, (len(intervals), LAM), dtype=np.uint8)
        return d.mic(intervals, betas, bound=bmap(bound), rng=rng,
                     group=group), betas

    (pb, betas), (jpb, jbetas) = both(seed, make, dcf, jdcf)
    assert np.array_equal(betas, jbetas)
    return pb, jpb, betas


# ----------------------------------------------------------------- oracles


@pytest.mark.parametrize("p,q", [(10, 200), (7, 7), (0, N), (60000, 6),
                                 (N - 1, N), (0, 1)])
def test_oracle_edges(p, q):
    """The port's oracles equal dcf_tpu's; x = p is inside, x = q is not,
    p == q is empty, (0, N) the full domain, p > q wraps."""
    beta = np.arange(1, LAM + 1, dtype=np.uint8)
    xs = edge_points([(p, q)])
    got = ic_oracle(xs, p, q, beta)
    assert np.array_equal(got, joracle.ic_oracle(xs, p, q, beta))
    vals = [int.from_bytes(x.tobytes(), "big") for x in xs]
    for x, row in zip(vals, got):
        inside = (p <= x < q) if p <= q else (x >= p or x < q)
        assert np.array_equal(row, beta if inside else np.zeros_like(beta))
    assert np.array_equal(dpf_oracle(xs, p % N, beta),
                          joracle.dpf_oracle(xs, p % N, beta))
    cuts = [0, 100, 5000, 60000]
    vals8 = np.random.default_rng(5).integers(0, 256, (4, LAM), np.uint8)
    assert np.array_equal(piecewise_oracle(xs, cuts, vals8),
                          joracle.piecewise_oracle(xs, cuts, vals8))


def test_oracle_bounds_validated():
    beta = np.zeros(LAM, dtype=np.uint8)
    with pytest.raises(ValueError):
        ic_oracle(np.zeros((1, NB), dtype=np.uint8), 0, N + 1, beta)
    with pytest.raises(ShapeError):
        mic_oracle(np.zeros((1, NB), dtype=np.uint8), [(0, 1)],
                   np.zeros((2, LAM), dtype=np.uint8))


# ------------------------------------------------- bound decomposition


@pytest.mark.parametrize("group", ["xor", "add8", "add16", "add32"])
@pytest.mark.parametrize("bound", [Bound.LT_BETA, Bound.GT_BETA])
def test_interval_bound_alphas_decomposition(bound, group):
    """The LT and GT decompositions, the public bits [p > q], [p == N],
    [q == N] (XOR) and the signed pub of the additive groups, equal to
    dcf_tpu's."""
    iv = [(10, 200), (200, 10), (0, N), (5, 5), (N, N), (0, 0), (N, 3),
          (3, N), (0, 7)]
    al, pub = interval_bound_alphas(iv, NB, bound, group)
    jal, jpub = j_alphas(iv, NB, JB[bound], group)
    assert np.array_equal(al, jal)
    assert pub.dtype == jpub.dtype and np.array_equal(pub, jpub)
    if group == "xor":
        assert pub.tolist()[:6] == [0, 1, 1, 0, 0, 0]
    if bound is Bound.GT_BETA:
        assert al[0].tolist() == [0, 9] and al[1].tolist() == [0, 199]
    with pytest.raises(ValueError):
        interval_bound_alphas([(0, N + 1)], NB, bound, group)


# --------------------------------------------------- IC edge-case sweep


@pytest.mark.parametrize("bound", [Bound.LT_BETA, Bound.GT_BETA])
@pytest.mark.parametrize("p,q", [
    (10, 200), (0, 1), (123, 124), (57, 57), (0, N), (0, 0), (N, N),
    (60000, 300), (N - 1, N), (0, 32768)])
def test_ic_edge_cases_both_parties(jdcf, p, q, bound):
    """x = p, q - 1, q and the corners, every interval class, both
    parties, both bound families, on the port's walk backend: frames and
    shares equal dcf_tpu's, the reconstruction equals the oracle."""
    def make(rng, d, bmap):
        beta = rng.integers(1, 256, LAM, dtype=np.uint8)
        return d.interval(p, q, beta, bound=bmap(bound), rng=rng), beta

    (pb, beta), (jpb, _) = both(1000 + p % 97 + q % 89, make,
                                facade("walk"), jdcf)
    assert pb.num_intervals == 1 and pb.keys.num_keys == 2
    same_frames(pb, jpb)
    xs = edge_points([(p, q)], seed=p ^ q)
    got = check_parties(facade("walk").eval_interval, pb, jdcf.eval_interval,
                        jpb, xs)
    assert np.array_equal(got, ic_oracle(xs, p, q, beta))


# ------------------------------------------------------------- 8-interval MIC


@pytest.mark.parametrize("bound", [Bound.LT_BETA, Bound.GT_BETA])
@pytest.mark.parametrize("backend", ["walk", "prefix", "numpy", "cpu"])
def test_mic_8_intervals_facade_backends(jdcf, backend, bound):
    """The 8-interval MIC (16 keys packed on the K axis) through each of
    the port's facade backends, both parties, LT and GT."""
    d = facade(backend)
    pb, jpb, betas = mic_pair(1100, d, jdcf, bound=bound)
    assert pb.keys.num_keys == 16 and pb.bound is bound
    same_frames(pb, jpb)
    xs = edge_points(MIC_INTERVALS, seed=11)
    got = check_parties(d.eval_mic, pb, jdcf.eval_mic, jpb, xs)
    assert np.array_equal(got, mic_oracle(xs, MIC_INTERVALS, betas))


@pytest.mark.parametrize("backend,group", [
    (be, g) for be in ("walk", "prefix", "numpy")
    for g in ("xor", "add16", "add32")] + [("keylanes", "xor")])
def test_mic_evaluator_staged_matches_facade(jdcf, backend, group):
    """The staged ``MicEvaluator`` (its own backend, the pairwise combine
    on the device before the fetch; keylanes is XOR-only) equals the
    facade path and dcf_tpu's shares; 45 random points, so the pad points
    are combined and then dropped."""
    d = facade(backend)
    pb, jpb, betas = mic_pair(1200, d, jdcf, group=group)
    xs = edge_points(MIC_INTERVALS, seed=12, extra=45)
    ev = [MicEvaluator(d, pb, b) for b in (0, 1)]
    assert (ev[0].backend is None) == (backend == "numpy")
    for b in (0, 1):
        y = ev[b].eval(xs)
        assert np.array_equal(y, jdcf.eval_mic(b, jpb, xs)), b
        if backend != "keylanes":
            assert np.array_equal(y, d.eval_mic(b, pb, xs)), b
    assert np.array_equal(ev[0].reconstruct_with(ev[1], xs),
                          mic_oracle(xs, MIC_INTERVALS, betas))
    with pytest.raises(ValueError):
        ev[0].reconstruct_with(ev[0], xs)
    with pytest.raises(ValueError):
        MicEvaluator(d, pb, 2)


def test_mic_evaluator_party_bundle_and_hybrid(jdcf):
    """A party-restricted bundle on walk, and the large-lambda hybrid
    (lam = 48), whose staged shares have the same byte layout, so the
    same staged combine serves it."""
    d = facade("walk")
    pb, jpb, _ = mic_pair(1250, d, jdcf)
    xs = edge_points(MIC_INTERVALS, seed=13, extra=5)
    for b in (0, 1):
        assert np.array_equal(MicEvaluator(d, pb.for_party(b), b).eval(xs),
                              jdcf.eval_mic(b, jpb, xs))
    ck48 = [bytes([i]) * 32 for i in range(18)]
    with pytest.warns(Warning):
        d48 = Dcf(NB, 48, ck48, backend="hybrid", device="cpu")
        j48 = JDcf(NB, 48, ck48, backend="numpy")
    iv = [(5, 900), (60000, 7)]

    def make(rng, dd, bmap):
        betas = rng.integers(0, 256, (2, 48), dtype=np.uint8)
        return dd.mic(iv, betas, rng=rng), betas

    (pb48, betas), (jpb48, _) = both(1251, make, d48, j48)
    same_frames(pb48, jpb48)
    ev = [MicEvaluator(d48, pb48, b) for b in (0, 1)]
    for b in (0, 1):
        assert np.array_equal(ev[b].eval(xs), j48.eval_mic(b, jpb48, xs))
    assert np.array_equal(ev[0].reconstruct_with(ev[1], xs),
                          mic_oracle(xs, iv, betas))


def test_mic_device_keygen_matches_host(jdcf):
    """``Dcf.mic(..., device=True)`` runs keygen kernel G1 (its plain
    version here) and gives the host walk's frame; an additive group
    has no keygen kernel and raises."""
    d = facade("walk")
    pb_host, jpb, _ = mic_pair(1300, d, jdcf)

    def make(rng, dd, bmap):
        betas = rng.integers(0, 256, (len(MIC_INTERVALS), LAM),
                             dtype=np.uint8)
        return dd.mic(MIC_INTERVALS, betas, rng=rng, device=True)

    pb_dev = make(np.random.default_rng(1300), d, None)
    assert pb_dev.to_bytes() == pb_host.to_bytes() == jpb.to_bytes()
    with pytest.raises(ValueError, match="additive"):
        d.mic(MIC_INTERVALS, np.zeros((8, LAM), np.uint8), device=True,
              group="add16", rng=np.random.default_rng(0))


def test_adjacent_partition_covers_domain(jdcf):
    cuts = [0, 100, 5000, 60000]
    intervals = partition_intervals(cuts, 8 * NB)
    assert intervals == [(0, 100), (100, 5000), (5000, 60000), (60000, 0)]
    d = facade("prefix")
    pb, jpb, betas = mic_pair(1400, d, jdcf, intervals=intervals)
    same_frames(pb, jpb)
    xs = edge_points(intervals, seed=14)
    rows = check_parties(d.eval_mic, pb, jdcf.eval_mic, jpb, xs)
    assert (np.count_nonzero((rows != 0).any(axis=2), axis=0) <= 1).all()
    assert np.array_equal(rows, mic_oracle(xs, intervals, betas))


# ------------------------------------------------------------- piecewise


@pytest.mark.parametrize("group", ["xor", "add16"])
@pytest.mark.parametrize("backend", ["walk", "prefix", "numpy"])
def test_piecewise_lookup(jdcf, backend, group):
    d = facade(backend)
    cuts = [0, 100, 5000, 60000]

    def make(rng, dd, bmap):
        vals = rng.integers(0, 256, (4, LAM), dtype=np.uint8)
        return dd.piecewise(cuts, vals, rng=rng, group=group), vals

    (pb, vals), (jpb, _) = both(1500, make, d, jdcf)
    same_frames(pb, jpb)
    xs = edge_points(partition_intervals(cuts, 8 * NB), seed=15)
    y = check_parties(d.eval_piecewise, pb, jdcf.eval_piecewise, jpb, xs,
                      group)
    assert np.array_equal(y, piecewise_oracle(xs, cuts, vals))
    xq = np.array([[0x13, 0x87]], dtype=np.uint8)  # 4999 -> piece 1
    yq = np_group_add(d.eval_piecewise(0, pb, xq),
                      d.eval_piecewise(1, pb, xq), group)
    assert np.array_equal(yq[0], vals[1])


def test_piecewise_single_piece_is_constant(jdcf):
    d = facade("walk")

    def make(rng, dd, bmap):
        vals = rng.integers(0, 256, (1, LAM), dtype=np.uint8)
        return dd.piecewise([42], vals, rng=rng), vals

    (pb, vals), (jpb, _) = both(1510, make, d, jdcf)
    same_frames(pb, jpb)
    xs = edge_points([(42, 43)], seed=16, extra=10)
    y = check_parties(d.eval_piecewise, pb, jdcf.eval_piecewise, jpb, xs)
    assert np.array_equal(y, np.broadcast_to(vals[0], y.shape))


def test_partition_validation():
    for bad in ([], [5, 5], [0, N], [-1, 3]):
        with pytest.raises(ValueError):
            partition_intervals(bad, 16)
    assert partition_intervals([7], 16) == [(0, N)]


# ------------------------------------------------------------ wire format


@pytest.mark.parametrize("bound", [Bound.LT_BETA, Bound.GT_BETA])
@pytest.mark.parametrize("group", ["xor", "add8", "add16", "add32"])
def test_frames_cross_read(jdcf, group, bound):
    """v3 proto = 1 (XOR) and v4 (additive) frames, both bounds, two-party
    and each party's: the port writes and dcf_tpu reads, and the
    reverse; ``decode_proto_frame`` decodes the XOR frame."""
    pb, jpb, _ = mic_pair(1600, facade("numpy"), jdcf, bound=bound,
                          group=group)
    version = 3 if group == "xor" else 4
    for t, j in ((pb, jpb), (pb.for_party(0), jpb.for_party(0)),
                 (pb.for_party(1), jpb.for_party(1))):
        data = t.to_bytes()
        assert data == j.to_bytes() and data[4] == version
        back = ProtocolBundle.from_bytes(j.to_bytes())
        jback = JProtocolBundle.from_bytes(data)
        assert back.to_bytes() == jback.to_bytes() == data
        assert back.bound is bound and back.group == group
        assert jback.bound is JB[bound] and jback.group == group
        assert np.array_equal(back.combine_masks, j.combine_masks)
    if group == "xor":
        assert decode_proto_frame(pb.to_bytes()).to_bytes() == pb.to_bytes()
    with pytest.raises(KeyFormatError, match="protocol section"):
        KeyBundle.from_bytes(pb.to_bytes())
    with pytest.raises(KeyFormatError, match="KeyBundle.from_bytes"):
        ProtocolBundle.from_bytes(pb.keys.to_bytes())


def _flip(data: bytes, offset: int) -> bytes:
    buf = bytearray(data)
    buf[offset] ^= 0x01
    return bytes(buf)


@pytest.mark.parametrize("group", ["xor", "add16"])
def test_frame_corruption_same_typed_errors(jdcf, group):
    """Truncation, a flipped byte (the CRC catches it), a bad magic, an
    unknown group code and a trailing byte: both readers raise their
    KeyFormatError, naming the same fault (the message up to its first
    colon; the packages punctuate the rest differently)."""
    pb, _, _ = mic_pair(1700, facade("numpy"), jdcf, group=group)
    data = pb.to_bytes()
    bad = {"crc": _flip(data, len(data) // 2), "trunc": data[:len(data) // 2],
           "header": data[:19], "magic": b"XXXX" + data[4:],
           "long": data + b"\0"}
    if group != "xor":
        code = bytearray(data)
        code[20] = 9
        bad["group"] = bytes(code)
    for what, frame in bad.items():
        with pytest.raises(KeyFormatError) as te:
            ProtocolBundle.from_bytes(frame)
        with pytest.raises(JKeyFormatError) as je:
            JProtocolBundle.from_bytes(frame)
        assert str(te.value).split(":")[0] == str(je.value).split(":")[0], \
            what


def test_protocol_bundle_repr_and_shape_contracts(jdcf):
    pb, jpb, betas = mic_pair(1800, facade("numpy"), jdcf)
    r = repr(pb)
    assert r == repr(jpb) and "redacted" in r and "m=8" in r
    assert betas.tobytes().hex()[:16] not in r
    assert repr(pb.keys) == repr(jpb.keys)
    with pytest.raises(ShapeError):
        ProtocolBundle(keys=pb.keys,
                       combine_masks=np.zeros((2, 3, LAM), np.uint8))
    odd = KeyBundle(s0s=pb.keys.s0s[:3], cw_s=pb.keys.cw_s[:3],
                    cw_v=pb.keys.cw_v[:3], cw_t=pb.keys.cw_t[:3],
                    cw_np1=pb.keys.cw_np1[:3])
    with pytest.raises(ShapeError):
        ProtocolBundle(keys=odd,
                       combine_masks=np.zeros((2, 1, LAM), np.uint8))
    with pytest.raises(ShapeError):
        ProtocolBundle(keys=pb.keys, combine_masks=pb.combine_masks.astype(
            np.int16))
    assert pb.masks_for(1).shape == (8, LAM)
    assert np.array_equal(pb.for_party(1).masks_for(0), pb.masks_for(1))
    with pytest.raises(ValueError):
        pb.masks_for(2)


# ----------------------------------------------------------------- faults


@pytest.mark.parametrize("backend,staged", [
    ("walk", False), ("walk", True), ("keylanes", True)])
def test_combine_fault_seam(jdcf, backend, staged):
    """The ``protocols.combine`` seam fires on the facade path with (m,
    points) and on the staged combine with (m, -1), keylanes included;
    armed, it raises, and it is disarmed again afterwards."""
    d = facade(backend)
    pb, _, _ = mic_pair(1900, d, jdcf)
    xs = edge_points(MIC_INTERVALS, seed=19, extra=3)

    def run():
        if staged:
            return MicEvaluator(d, pb, 1).eval(xs)
        return d.eval_mic(1, pb, xs)

    with faults.inject("protocols.combine"):
        with pytest.raises(faults.InjectedFault):
            run()
    seen = []
    with faults.inject("protocols.combine",
                       handler=lambda m, pts: seen.append((m, pts))):
        run()
    assert seen == [(8, -1 if staged else xs.shape[0])]
    run()


# ------------------------------------------------- keygen reuse contract


def test_gen_interval_bundle_custom_gen_fn(jdcf):
    """Any K-batched keygen gives an equivalent bundle; a closure that
    drops the group is caught."""
    prg = HirosePrgNp(LAM, CK)
    seeds = np.random.default_rng(3)

    def gen_fn(alphas, betas, bound):
        return gen_batch(prg, alphas, betas,
                         random_s0s(alphas.shape[0], LAM, seeds), bound)

    iv = [(100, 60000), (60001, 100)]
    betas = np.random.default_rng(4).integers(0, 256, (2, LAM), np.uint8)
    pb = gen_interval_bundle(gen_fn, iv, betas, NB)
    xs = edge_points(iv, seed=20)
    d = facade("numpy")
    got = np_group_add(d.eval_mic(0, pb, xs), d.eval_mic(1, pb, xs), "xor")
    assert np.array_equal(got, mic_oracle(xs, iv, betas))
    with pytest.raises(ShapeError, match="group"):
        gen_interval_bundle(gen_fn, iv, betas, NB, group="add16")
    with pytest.raises(ShapeError):
        gen_interval_bundle(gen_fn, [], betas[:0], NB)


def test_eval_interval_rejects_mic_bundle_and_new_backend(jdcf):
    d = facade("walk")
    pb, _, _ = mic_pair(2000, d, jdcf)
    xs = edge_points(MIC_INTERVALS, seed=21, extra=2)
    with pytest.raises(ShapeError):
        eval_interval(d, 0, pb, xs)
    assert eval_mic(d, 0, pb, xs).shape == (8, xs.shape[0], LAM)
    a, b = d.new_eval_backend(), d.new_eval_backend()
    assert a is not b and type(a).__name__ == "WalkBackend"
    assert a is not d.eval_backend(0)
    assert facade("numpy").new_eval_backend() is None
    assert facade("cpu").new_eval_backend() is None
