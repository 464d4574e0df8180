"""The port's multi-device tier on CPU positions against dcf_tpu.

Counterpart of ``tests/test_sharding.py`` and of
``tests/test_evalall.py::test_sharded_evalall_2x2_mesh``: every sharded
class of ``dcf_tpu_torch.parallel`` over meshes (1, 1), (2, 2), (4, 2),
(1, 8) and (8, 1) of CPU positions (the kernels' plain versions), held
byte for byte against ``dcf_tpu``'s numpy oracle (both parties, both
bounds, x = alpha, ragged point counts, shared and per-key points, the
groups the class takes), and one small case per class against
``dcf_tpu``'s sharded class on the conftest's 8-device CPU mesh
(``interpret=True``).  The full-domain and DPF counts equal
``dcf_tpu``'s ``check``, 0 clean and above 0 with a planted beta flip.
Then ``make_mesh``'s shapes and errors, the typed errors, the facade's
``mesh=`` (routing, validation, MIC on a 2 x 2 mesh, one
``Dcf(mesh=).serve()`` round trip).  Integer cryptography: exact
equality throughout.

The CPU positions number ``DCF_CPU_DEVICES`` = 8 here, as the conftest
gives ``dcf_tpu`` 8 virtual XLA devices."""

import numpy as np
import pytest
import torch

from dcf_tpu import spec as jspec
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.protocols.dpf import dpf_gen_batch as j_dpf_gen_batch

from dcf_tpu_torch import Bound, Dcf, ShapeError, StaleStateError
from dcf_tpu_torch.backends._common import (
    shard_leaf_positions,
    shard_local_leaf,
)
from dcf_tpu_torch.errors import BackendUnavailableError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.parallel import (
    Mesh,
    MeshLargeLambdaBackend,
    ShardedDpfEvalAll,
    ShardedKeyLanesBackend,
    ShardedLargeLambdaBackend,
    ShardedPrefixBackend,
    ShardedTensor,
    ShardedTreeFullDomain,
    ShardedWalkBackend,
    make_mesh,
    make_pod_mesh,
)
from dcf_tpu_torch.protocols import MicEvaluator, mic_oracle
from dcf_tpu_torch.protocols.dpf import DpfBundle
from dcf_tpu_torch.testing import faults
from tests.torch_threads import one_torch_thread  # noqa: F401

JB = {Bound.LT_BETA: jspec.Bound.LT_BETA, Bound.GT_BETA: jspec.Bound.GT_BETA}
SHAPES = [(1, 1), (2, 2), (4, 2), (1, 8), (8, 1)]
NB = 2  # 16-bit domains
#: 18 cipher keys: lam >= 32 uses ciphers 0 and 17.
CK = [bytes((11 * i + j) % 256 for j in range(32)) for i in range(18)]


@pytest.fixture(autouse=True)
def eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("DCF_CPU_DEVICES", "8")


def cpu_mesh(shape):
    return make_mesh(shape=shape, device="cpu")


def jbundle(lam, k_num, bound, seed, group="xor", nb=NB):
    """dcf_tpu's keygen from a seed: (prg, alphas, betas, bundle) with the
    bundle crossing to the port by its DCFK frame."""
    rng = np.random.default_rng(seed)
    prg = JPrg(lam, CK, warn=False) if lam > 16 else JPrg(lam, CK[:2])
    alphas = rng.integers(0, 256, (k_num, nb), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    s0s = rng.integers(0, 256, (k_num, 2, lam), dtype=np.uint8)
    jb = j_gen_batch(prg, alphas, betas, s0s, JB[bound], group=group)
    return prg, alphas, betas, jb, KeyBundle.from_bytes(jb.to_bytes())


def points(alphas, m, seed, nb=NB):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
    xs[0] = alphas[0]  # x = alpha
    return xs


# ----------------------------------------------------------------- meshes


def test_mesh_shapes_and_errors():
    """``test_mesh_shapes``' contract, on CPU positions."""
    from dcf_tpu.parallel import make_mesh as j_make_mesh

    for n in (1, 2, 4, 6, 8):
        assert make_mesh(n, device="cpu").shape == j_make_mesh(n).shape
    assert make_mesh(8, device="cpu").shape == {"keys": 4, "points": 2}
    assert make_mesh(device="cpu").shape == {"keys": 4, "points": 2}
    assert make_mesh(shape=(2, 4), device="cpu").shape == \
        j_make_mesh(shape=(2, 4)).shape
    for bad in (dict(n_devices=16), dict(shape=(4, 4)),
                dict(n_devices=8, shape=(2, 2))):
        with pytest.raises(ValueError) as e:
            make_mesh(device="cpu", **bad)
        with pytest.raises(ValueError) as je:
            j_make_mesh(**bad)
        assert str(e.value) == str(je.value)
    # No card here: a CUDA mesh raises typed, nothing falls back.
    with pytest.raises(BackendUnavailableError):
        make_mesh()
    with pytest.raises(BackendUnavailableError):
        make_mesh(shape=(2, 2), device="cuda")
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_mesh(device="meta")
    with faults.inject("mesh.provision"):
        with pytest.raises(BackendUnavailableError, match="provisioning"):
            make_mesh(2, device="cpu")


def test_mesh_counts_positions_and_repeats_devices(monkeypatch):
    monkeypatch.delenv("DCF_CPU_DEVICES")
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(16, device="cpu").shape == {"keys": 8, "points": 2}
    monkeypatch.setenv("DCF_CPU_DEVICES", "3")
    assert make_mesh(device="cpu").shape == {"keys": 3, "points": 1}
    grid = Mesh([["cpu", "cpu"], ["cpu", "cpu"]])
    assert grid.shape == {"keys": 2, "points": 2} and grid.size == 4
    assert all(d == torch.device("cpu") for d in grid.devices.reshape(-1))
    with pytest.raises(ShapeError):
        Mesh(["cpu", "cpu"])
    pod = make_pod_mesh(device="cpu")  # standalone: this host's positions
    assert pod.shape == {"keys": 1, "points": 3}
    with pytest.raises(ValueError, match="does not cover all 3"):
        make_pod_mesh(shape=(2, 2), device="cpu")


@pytest.mark.parametrize("n_bits,k0,log2p", [(8, 6, 1), (10, 7, 2),
                                              (12, 8, 3), (9, 3, 3)])
def test_shard_leaf_positions_partition_the_domain(n_bits, k0, log2p):
    """Every global leaf lies in exactly one shard, at the local index
    ``shard_local_leaf`` gives (the map of pallas_sharded.py:253-273)."""
    n_local = 1 << (n_bits - log2p)
    seen = []
    for q in range(1 << log2p):
        pos = shard_leaf_positions(n_local, (q, log2p, k0), "cpu").tolist()
        for local, p in enumerate(pos):
            assert shard_local_leaf(p, (q, log2p, k0)) == local
            for other in range(1 << log2p):
                if other != q:
                    assert shard_local_leaf(p, (other, log2p, k0)) is None
        seen += pos
    assert sorted(seen) == list(range(1 << n_bits))


# --------------------------------------------------------------- the walk


@pytest.mark.parametrize("shape,lam,group,bound", [
    *((s, 16, "xor", Bound.LT_BETA) for s in SHAPES),
    *((s, 16, "add16", Bound.GT_BETA) for s in SHAPES),
    ((2, 2), 32, "add32", Bound.LT_BETA)])
def test_sharded_walk_matches_numpy(shape, lam, group, bound):
    """B1 / E1 sharded: both parties, each bound, shared and per-key
    points, a ragged m, x = alpha, against dcf_tpu's numpy oracle; each
    block on its position's device."""
    mesh = cpu_mesh(shape)
    be = ShardedWalkBackend(lam, CK if lam > 16 else CK[:2], mesh)
    k_num, m = 8, 37
    prg, alphas, _b, jb, bundle = jbundle(lam, k_num, bound,
                                          [lam, shape[0], shape[1]],
                                          group)
    xs = points(alphas, m, 1)
    xs3 = np.random.default_rng(2).integers(0, 256, (k_num, m, NB),
                                            dtype=np.uint8)
    for b in (0, 1):
        kb = bundle.for_party(b)
        got = be.eval(b, xs, bundle=kb)
        assert np.array_equal(got, j_eval_np(prg, b, jb.for_party(b),
                                             xs)), (bound, b)
        assert np.array_equal(be.eval(b, xs3),
                              j_eval_np(prg, b, jb.for_party(b), xs3))
    y = be.eval_staged(0, be.stage(xs))
    for i, row in enumerate(y.blocks):
        for j, blk in enumerate(row):
            assert blk.device == mesh.devices[i, j]
            assert blk.shape[1] % 32 == 0


def test_sharded_walk_matches_dcf_tpu_sharded_pallas():
    """One small case against ``ShardedPallasBackend`` (interpret mode)
    on dcf_tpu's 8-device mesh, both bounds' keys, the staged count."""
    from dcf_tpu.parallel import ShardedPallasBackend, make_mesh as jmm

    prg, alphas, betas, jb, bundle = jbundle(16, 4, Bound.GT_BETA, 7)
    xs = points(alphas, 37, 8)
    jbe = ShardedPallasBackend(16, CK[:2], jmm(8), interpret=True)
    be = ShardedWalkBackend(16, CK[:2], cpu_mesh((4, 2)))
    for b in (0, 1):
        assert np.array_equal(be.eval(b, xs, bundle=bundle.for_party(b)),
                              jbe.eval(b, xs, bundle=jb.for_party(b)))
    bes = [ShardedWalkBackend(16, CK[:2], cpu_mesh((4, 2)))
           for _ in (0, 1)]
    for b in (0, 1):
        bes[b].put_bundle(bundle.for_party(b))
    staged = bes[0].stage(xs)
    ys = [bes[b].eval_staged(b, staged) for b in (0, 1)]
    assert int(bes[0].points_mismatch_count(
        ys[0], ys[1], alphas, betas, staged, gt=True)) == 0
    assert int(bes[0].points_mismatch_count(
        ys[0], ys[1], alphas, betas, staged)) > 0  # the wrong bound


def test_sharded_walk_errors():
    """``test_sharded_eval_divisibility_errors``: a key count the keys
    axis does not divide raises ShapeError (a ValueError), as dcf_tpu's
    does; no bundle is stale state."""
    from dcf_tpu.parallel import ShardedJaxBackend, make_mesh as jmm

    _p, _a, _b, jb, bundle = jbundle(16, 3, Bound.LT_BETA, 3)
    be = ShardedWalkBackend(16, CK[:2], cpu_mesh((4, 2)))
    with pytest.raises(StaleStateError):
        be.stage(np.zeros((4, NB), np.uint8))
    with pytest.raises(ShapeError, match="not divisible by keys-axis"):
        be.put_bundle(bundle.for_party(0))
    with pytest.raises(ValueError, match="not divisible by keys-axis"):
        ShardedJaxBackend(16, CK[:2], jmm(8)).put_bundle(jb.for_party(0))
    with pytest.raises(ValueError, match="lam=16 and lam=32"):
        ShardedWalkBackend(64, CK, cpu_mesh((1, 1)))
    assert be.eval(0, np.zeros((0, NB), np.uint8),
                   bundle=KeyBundle.from_bytes(
                       jbundle(16, 4, Bound.LT_BETA, 4)[3].for_party(0)
                       .to_bytes())).shape == (4, 0, 16)


# ---------------------------------------------------------------- prefix


@pytest.mark.parametrize("shape", [(1, 1), (1, 8)])
@pytest.mark.parametrize("bound", list(Bound))
@pytest.mark.parametrize("k_num", [1, 3])
def test_sharded_prefix_matches_numpy(shape, bound, k_num):
    """B2 + B3 on a 1 x N mesh: both parties, ragged m, multi-key
    bundles walking every key on every point shard, the staged count;
    one frontier a distinct device."""
    prg, alphas, betas, jb, bundle = jbundle(16, k_num, bound, 11 + k_num)
    xs = points(alphas, 37, 12)
    bes = {b: ShardedPrefixBackend(16, CK[:2], cpu_mesh(shape),
                                   prefix_levels=8) for b in (0, 1)}
    ys, staged = {}, None
    for b in (0, 1):
        bes[b].put_bundle(bundle.for_party(b))
        if staged is None:
            staged = bes[b].stage(xs)
        ys[b] = bes[b].eval_staged(b, staged)
        got = bes[b].staged_to_bytes(ys[b], staged["m"])
        assert np.array_equal(got, j_eval_np(prg, b, jb.for_party(b), xs))
        assert len(bes[b].shard_backends()) == 1  # one device: one table
    if k_num == 1:
        assert int(bes[0].points_mismatch_count(
            ys[0], ys[1], alphas[0].tobytes(), betas[0].tobytes(), staged,
            gt=bound is Bound.GT_BETA)) == 0


def test_sharded_prefix_matches_dcf_tpu_and_is_single_key():
    from dcf_tpu.parallel import ShardedPrefixBackend as JPrefix
    from dcf_tpu.parallel import make_mesh as jmm

    prg, alphas, _b, jb, bundle = jbundle(16, 1, Bound.LT_BETA, 21)
    xs = points(alphas, 37, 22)
    jbe = JPrefix(16, CK[:2], jmm(shape=(1, 8)), interpret=True,
                  tile_words=2, prefix_levels=8)
    be = ShardedPrefixBackend(16, CK[:2], cpu_mesh((1, 8)), prefix_levels=8)
    for b in (0, 1):
        assert np.array_equal(be.eval(b, xs, bundle=bundle.for_party(b)),
                              jbe.eval(b, xs, bundle=jb.for_party(b)))
    with pytest.raises(ShapeError, match="single-key"):
        ShardedPrefixBackend(16, CK[:2], cpu_mesh((4, 2)))
    with pytest.raises(ValueError, match="single-key"):
        JPrefix(16, CK[:2], jmm(8), interpret=True)


# -------------------------------------------------------------- keylanes


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_keylanes_matches_numpy(shape):
    """B8 sharded: a key count ragged against 32-key words a shard,
    ragged points, x = alpha; the count 0 clean and equal to the
    unsharded backend's on a moved alpha."""
    from dcf_tpu_torch.backends.keylanes_backend import KeyLanesBackend

    prg, alphas, betas, jb, bundle = jbundle(16, 40, Bound.LT_BETA, 31)
    xs = points(alphas, 9, 32)
    be = ShardedKeyLanesBackend(16, CK[:2], cpu_mesh(shape))
    be.put_bundle(bundle)
    staged = be.stage(xs)
    ys = {b: be.eval_staged(b, staged) for b in (0, 1)}
    for b in (0, 1):
        assert np.array_equal(be.staged_to_bytes(ys[b], staged["m"]),
                              j_eval_np(prg, b, jb.for_party(b), xs))
    assert int(be.relu_mismatch_count(ys[0], ys[1], alphas, betas,
                                      staged)) == 0
    moved = alphas.copy()
    moved[0] = xs[1]  # key 0's alpha moved onto another point
    one = KeyLanesBackend(16, CK[:2], device="cpu")
    one.put_bundle(bundle)
    st1 = one.stage(xs)
    want = int(one.relu_mismatch_count(one.eval_staged(0, st1),
                                       one.eval_staged(1, st1), moved,
                                       betas, st1))
    assert want > 0
    assert int(be.relu_mismatch_count(ys[0], ys[1], moved, betas,
                                      staged)) == want
    with pytest.raises(ShapeError, match="two-party"):
        be.put_bundle(bundle.for_party(0))


def test_sharded_keylanes_matches_dcf_tpu():
    from dcf_tpu.parallel import ShardedKeyLanesBackend as JKL
    from dcf_tpu.parallel import make_mesh as jmm

    _p, alphas, betas, jb, bundle = jbundle(16, 40, Bound.LT_BETA, 33)
    xs = points(alphas, 9, 34)
    jbe = JKL(16, CK[:2], jmm(8), m_tile=2, kw_tile=1, level_chunk=4,
              interpret=True)
    jbe.put_bundle(jb)
    jst = jbe.stage(xs)
    be = ShardedKeyLanesBackend(16, CK[:2], cpu_mesh((4, 2)))
    be.put_bundle(bundle)
    st = be.stage(xs)
    jys = {b: jbe.eval_staged(b, jst) for b in (0, 1)}
    ys = {b: be.eval_staged(b, st) for b in (0, 1)}
    for b in (0, 1):
        assert np.array_equal(be.staged_to_bytes(ys[b], st["m"]),
                              jbe.staged_to_bytes(jys[b], jst["m"]))
    assert int(be.relu_mismatch_count(ys[0], ys[1], alphas, betas, st)) \
        == int(jbe.relu_mismatch_count(jys[0], jys[1], alphas, betas,
                                       xs)) == 0


# ---------------------------------------------------------------- hybrid


@pytest.mark.parametrize("shape,prefix_levels", [
    ((1, 1), 0), ((2, 2), 0), ((4, 2), 0), ((2, 2), 5)])
def test_sharded_large_lambda_matches_numpy(shape, prefix_levels):
    """B4 + W1 (B5a + B5b + W1 with prefix_levels) sharded at lam = 64:
    both parties, both bounds, a ragged m, x = alpha."""
    mesh = cpu_mesh(shape)
    be = ShardedLargeLambdaBackend(64, CK, mesh,
                                   prefix_levels=prefix_levels)
    for bound in Bound:
        prg, alphas, betas, jb, bundle = jbundle(64, 8, bound, 41)
        xs = points(alphas, 37, 42)
        for b in (0, 1):
            got = be.eval(b, xs, bundle=bundle.for_party(b))
            assert np.array_equal(got, j_eval_np(prg, b, jb.for_party(b),
                                                 xs)), (bound, b)


def test_sharded_large_lambda_matches_dcf_tpu_and_errors():
    from dcf_tpu.parallel import ShardedLargeLambdaBackend as JLL
    from dcf_tpu.parallel import make_mesh as jmm

    prg, alphas, betas, jb, bundle = jbundle(64, 4, Bound.LT_BETA, 43)
    xs = points(alphas, 37, 44)
    jbe = JLL(64, CK, jmm(8), interpret=True)
    be = ShardedLargeLambdaBackend(64, CK, cpu_mesh((4, 2)))
    for b in (0, 1):
        assert np.array_equal(be.eval(b, xs, bundle=bundle.for_party(b)),
                              jbe.eval(b, xs, bundle=jb.for_party(b)))
    assert not be.accepts_dev_planes and not jbe.accepts_dev_planes
    with pytest.raises(ShapeError, match="single-device staged layout"):
        be.put_bundle(bundle.for_party(0), dev_planes={})
    three = KeyBundle.from_bytes(jbundle(64, 3, Bound.LT_BETA, 45)[3]
                                 .for_party(0).to_bytes())
    with pytest.raises(ShapeError, match="not divisible by keys-axis"):
        be.put_bundle(three)
    with pytest.raises(ShapeError, match="shared points"):
        be.stage(np.zeros((4, 3, NB), np.uint8))


# ------------------------------------------------------------ full domain


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gt", [False, True])
def test_sharded_tree_fulldomain(shape, gt):
    """B2 + B2f sharded, n = 16: each position checks its own leaves; 0
    clean, and with a planted beta flip exactly the leaves inside the
    bound (dcf_tpu's count, test_sharded_tree_fulldomain)."""
    rng = np.random.default_rng(51)
    n_bits = 16
    alpha = int(rng.integers(0, 1 << n_bits))
    beta = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    bound = Bound.GT_BETA if gt else Bound.LT_BETA
    prg = JPrg(16, CK[:2])
    jb = j_gen_batch(prg, np.frombuffer(alpha.to_bytes(2, "big"),
                                        np.uint8)[None],
                     np.frombuffer(beta, np.uint8)[None],
                     rng.integers(0, 256, (1, 2, 16), dtype=np.uint8),
                     JB[bound])
    bundle = KeyBundle.from_bytes(jb.to_bytes())
    fd = ShardedTreeFullDomain(16, CK[:2], cpu_mesh(shape))
    assert fd.host_levels == max(6, 5 + (shape[0] * shape[1]).bit_length()
                                 - 1)
    assert fd.check(bundle, alpha, beta, n_bits, gt=gt) == 0
    wrong = bytes(b ^ 1 for b in beta)
    inside = ((1 << n_bits) - 1 - alpha) if gt else alpha
    assert fd.check(bundle, alpha, wrong, n_bits, gt=gt) == inside


def test_sharded_tree_matches_dcf_tpu_and_validates():
    """The count of dcf_tpu's ShardedTreeFullDomain on its 8-device mesh,
    clean and planted; test_sharded_tree_validation's errors."""
    from dcf_tpu.parallel import ShardedTreeFullDomain as JTree
    from dcf_tpu.parallel import make_mesh as jmm

    rng = np.random.default_rng(52)
    alpha = int(rng.integers(0, 1 << 16))
    beta = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    jb = j_gen_batch(JPrg(16, CK[:2]),
                     np.frombuffer(alpha.to_bytes(2, "big"), np.uint8)[None],
                     np.frombuffer(beta, np.uint8)[None],
                     rng.integers(0, 256, (1, 2, 16), dtype=np.uint8),
                     jspec.Bound.LT_BETA)
    bundle = KeyBundle.from_bytes(jb.to_bytes())
    jfd = JTree(16, CK[:2], jmm(8), interpret=True)
    fd = ShardedTreeFullDomain(16, CK[:2], cpu_mesh((4, 2)))
    assert fd.host_levels == jfd.host_levels == 8
    wrong = bytes(b ^ 0x80 for b in beta)
    for bt in (beta, wrong):
        assert fd.check(bundle, alpha, bt, 16) == jfd.check(jb, alpha, bt,
                                                            16)
    for mesh, jmesh in ((cpu_mesh((4, 2)), jmm(8)),
                        (cpu_mesh((3, 1)), jmm(3))):
        with pytest.raises(ValueError) as e:
            ShardedTreeFullDomain(16, CK[:2], mesh, host_levels=7)
        with pytest.raises(ValueError) as je:
            JTree(16, CK[:2], jmesh, host_levels=7, interpret=True)
        assert str(e.value) == str(je.value)
    with pytest.raises(ShapeError, match="host levels the mesh frontier"):
        fd.check(bundle, alpha, beta, 7)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 8), (8, 1)])
def test_sharded_dpf_evalall(shape):
    """B6 sharded over every position: 0 clean, and the count of the
    unsharded evaluator with one beta byte flipped."""
    from dcf_tpu_torch.backends.evalall import DpfEvalAll

    rng = np.random.default_rng(61)
    alphas = [7, 200, 201]
    betas = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    jdb = j_dpf_gen_batch(
        JPrg(32, CK, warn=False), np.array([[a] for a in alphas], np.uint8),
        betas, rng.integers(0, 256, (3, 2, 32), dtype=np.uint8))
    db = DpfBundle.from_bytes(jdb.to_bytes())
    ev = ShardedDpfEvalAll(32, CK, cpu_mesh(shape))
    assert ev.check(db, alphas, betas, 8) == 0
    bad = betas.copy()
    bad[1, 5] ^= 0x01
    ev.invalidate()
    got = ev.check(db, alphas, bad, 8)
    assert got == DpfEvalAll(32, CK, device="cpu").check(db, alphas, bad,
                                                         8) == 1


def test_sharded_evalall_2x2_mesh_matches_dcf_tpu():
    """``test_sharded_evalall_2x2_mesh`` on both packages: the same
    counts, and the host_levels floor's error text."""
    from dcf_tpu.parallel import ShardedDpfEvalAll as JDpf
    from dcf_tpu.parallel import make_mesh as jmm

    rng = np.random.default_rng(62)
    alphas = [7, 200]
    betas = rng.integers(0, 256, (2, 32), dtype=np.uint8)
    jdb = j_dpf_gen_batch(JPrg(32, CK, warn=False),
                          np.array([[a] for a in alphas], np.uint8), betas,
                          rng.integers(0, 256, (2, 2, 32), dtype=np.uint8))
    db = DpfBundle.from_bytes(jdb.to_bytes())
    jev = JDpf(32, CK, jmm(shape=(2, 2)), interpret=True)
    ev = ShardedDpfEvalAll(32, CK, cpu_mesh((2, 2)))
    bad = betas.copy()
    bad[0, 5] ^= 0x01
    for bt in (betas, bad):
        ev.invalidate()
        jev.invalidate()
        assert ev.check(db, alphas, bt, 8) == jev.check(jdb, alphas, bt, 8)
    assert ev.check(db, alphas, bad, 8) > 0
    with pytest.raises(ValueError, match="need >= 7 for 4 devices"):
        ShardedDpfEvalAll(32, CK, cpu_mesh((2, 2)), host_levels=6)


# ------------------------------------------------------- the pod mesh class


def test_mesh_large_lambda_standalone_equals_sharded():
    """Without a process group, MeshLargeLambdaBackend is the sharded
    hybrid over the same positions, byte for byte; its keys axis must be
    1."""
    prg, alphas, betas, jb, bundle = jbundle(64, 3, Bound.LT_BETA, 71)
    xs = points(alphas, 70, 72)
    pod = make_pod_mesh(device="cpu", shape=(1, 8))
    mb = MeshLargeLambdaBackend(64, CK, pod)
    ys = []
    for b in (0, 1):
        mb.put_bundle(bundle.for_party(b))
        st = mb.stage(xs)
        ys.append(mb.eval_staged(b, st))
        assert np.array_equal(mb.staged_to_bytes(ys[-1], st["m"]),
                              j_eval_np(prg, b, jb.for_party(b), xs))
    assert int(mb.points_mismatch_count(ys[0], ys[1], alphas, betas,
                                        st)) == 0
    with pytest.raises(ShapeError, match="keys axis must be 1"):
        MeshLargeLambdaBackend(64, CK, cpu_mesh((2, 2)))


# ---------------------------------------------------------------- facade


def test_facade_mesh_routes_and_ships_once(monkeypatch):
    """``test_facade_mesh_routes_sharded_pallas``: Dcf(mesh=) at lam = 16
    runs the sharded walk, one ship per party."""
    mesh = cpu_mesh((4, 2))
    dcf = Dcf(NB, 16, CK[:2], mesh=mesh)
    assert dcf.backend_name == "walk" and dcf.device == torch.device("cpu")
    rng = np.random.default_rng(81)
    alphas = rng.integers(0, 256, (4, NB), dtype=np.uint8)
    betas = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    bundle = dcf.gen(alphas, betas, rng=rng)
    xs = points(alphas, 9, 82)
    ships = []
    orig = ShardedWalkBackend.put_bundle
    monkeypatch.setattr(ShardedWalkBackend, "put_bundle",
                        lambda self, kb: (ships.append(1), orig(self, kb)))
    for _ in range(2):
        y0 = dcf.eval(0, bundle, xs)
        y1 = dcf.eval(1, bundle, xs)
    assert len(ships) == 2
    assert isinstance(dcf.eval_backend(0), ShardedWalkBackend)
    np.testing.assert_array_equal(
        y0 ^ y1, comparison_oracle(xs, alphas, betas))


def comparison_oracle(xs, alphas, betas):
    want = np.zeros((alphas.shape[0], xs.shape[0], betas.shape[1]),
                    np.uint8)
    for i in range(alphas.shape[0]):
        for j in range(xs.shape[0]):
            if xs[j].tobytes() < alphas[i].tobytes():
                want[i, j] = betas[i]
    return want


def test_facade_mesh_keylanes_ships_once(monkeypatch):
    """``test_facade_mesh_keylanes``: one two-party image for both
    parties, a ragged key count."""
    dcf = Dcf(NB, 16, CK[:2], backend="keylanes", mesh=cpu_mesh((4, 2)))
    rng = np.random.default_rng(83)
    alphas = rng.integers(0, 256, (40, NB), dtype=np.uint8)
    betas = rng.integers(0, 256, (40, 16), dtype=np.uint8)
    bundle = dcf.gen(alphas, betas, rng=rng)
    xs = points(alphas, 6, 84)
    ships = []
    orig = ShardedKeyLanesBackend.put_bundle
    monkeypatch.setattr(ShardedKeyLanesBackend, "put_bundle",
                        lambda self, kb: (ships.append(1), orig(self, kb)))
    for _ in range(2):
        y0 = dcf.eval(0, bundle, xs)
        y1 = dcf.eval(1, bundle, xs)
    assert len(ships) == 1
    np.testing.assert_array_equal(y0 ^ y1,
                                  comparison_oracle(xs, alphas, betas))
    with pytest.raises(ValueError, match="two-party"):
        dcf.eval(0, bundle.for_party(0), xs)


def test_facade_mesh_validation():
    """``test_facade_mesh_validation``: the host backends have no sharded
    variant, prefix and keylanes take lam = 16, auto picks walk at
    lam <= 32 and hybrid at lam >= 48, device= must agree."""
    from dcf_tpu import Dcf as JDcf
    from dcf_tpu.parallel import make_mesh as jmm

    mesh = cpu_mesh((4, 2))
    for backend in ("cpu", "numpy"):
        with pytest.raises(ValueError, match="no mesh-sharded variant"):
            Dcf(NB, 16, CK[:2], backend=backend, mesh=mesh)
        with pytest.raises(ValueError, match="no mesh-sharded variant"):
            JDcf(NB, 16, CK[:2], backend=backend, mesh=jmm(8))
    for backend in ("keylanes", "prefix"):
        with pytest.raises(ValueError, match="lam=16 only"):
            Dcf(NB, 64, CK, backend=backend, mesh=mesh)
    assert Dcf(NB, 64, CK, mesh=mesh).backend_name == "hybrid"
    assert Dcf(NB, 32, CK, mesh=mesh).backend_name == "walk"
    assert Dcf(NB, 16, CK[:2], mesh=mesh, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="does not agree with the mesh"):
        Dcf(NB, 16, CK[:2], mesh=mesh, device="cuda")
    hyb = Dcf(NB, 64, CK, mesh=mesh, backend_opts={"prefix_levels": 5})
    assert isinstance(hyb.new_eval_backend(), ShardedLargeLambdaBackend)
    pre = Dcf(NB, 16, CK[:2], backend="prefix", mesh=cpu_mesh((1, 8)))
    assert isinstance(pre.new_eval_backend(), ShardedPrefixBackend)


def test_facade_mesh_hybrid_auto():
    """``test_facade_mesh_hybrid_auto``: lam = 64 on a mesh is the
    sharded hybrid, four keys over keys axis 4."""
    dcf = Dcf(NB, 64, CK, mesh=cpu_mesh((4, 2)))
    rng = np.random.default_rng(85)
    alphas = rng.integers(0, 256, (4, NB), dtype=np.uint8)
    betas = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    bundle = dcf.gen(alphas, betas, rng=rng)
    xs = points(alphas, 6, 86)
    recon = dcf.eval(0, bundle, xs) ^ dcf.eval(1, bundle, xs)
    assert isinstance(dcf.eval_backend(0), ShardedLargeLambdaBackend)
    np.testing.assert_array_equal(recon, comparison_oracle(xs, alphas, betas))


@pytest.mark.parametrize("intervals", [
    [(10, 200), (200, 300), (300, 1000), (5000, 5000), (6000, 6001),
     (40000, 50000), (60000, 2000), (65000, 1 << 16)],
    [(10, 200), (300, 1000), (60000, 2000)]])
def test_mic_sharded_2x2_mesh(intervals):
    """``test_mic_sharded_2x2_mesh``: the 2m K-packed keys over a 2 x 2
    mesh through eval_mic and MicEvaluator (the pair combine shard by
    shard; with 3 intervals each key shard holds 3 keys, so the pairs
    cross shards and meet on one device), against mic_oracle and the
    unsharded facade."""
    d = Dcf(NB, 16, CK[:2], mesh=cpu_mesh((2, 2)))
    one = Dcf(NB, 16, CK[:2], device="cpu")
    rng = np.random.default_rng(87)
    betas = rng.integers(0, 256, (len(intervals), 16), dtype=np.uint8)
    pb = d.mic(intervals, betas, rng=rng)
    xs = np.random.default_rng(88).integers(0, 256, (45, NB), np.uint8)
    want = mic_oracle(xs, intervals, betas)
    ys = [d.eval_mic(b, pb, xs) for b in (0, 1)]
    np.testing.assert_array_equal(ys[0] ^ ys[1], want)
    for b in (0, 1):
        np.testing.assert_array_equal(ys[b], one.eval_mic(b, pb, xs))
        np.testing.assert_array_equal(MicEvaluator(d, pb, b).eval(xs),
                                      ys[b])


def test_sharded_tensor_pair_combine_and_to_bytes():
    """The combine of pairs inside each key shard and across shards
    gives the unsharded combine's bytes; ``to_bytes`` drops pad keys and
    pad points."""
    from dcf_tpu_torch.ops.walk_eval import group_add_plain

    rng = np.random.default_rng(89)
    full = torch.from_numpy(rng.integers(0, 256, (6, 8, 16), np.uint8))
    want = group_add_plain(full[0::2], full[1::2], 16).numpy()
    for cut in ([0, 2, 4, 6], [0, 3, 6]):
        blocks = [[full[a:b, :4], full[a:b, 4:]]
                  for a, b in zip(cut, cut[1:])]
        y = ShardedTensor(blocks)
        assert y.shape == (6, 8, 16)
        np.testing.assert_array_equal(y.pair_combine("add16").to_bytes(7),
                                      want[:, :7])
    padded = ShardedTensor([[torch.cat([full[:3], full[:1]])]], rows=[3])
    np.testing.assert_array_equal(padded.to_bytes(5), full[:3, :5].numpy())


def test_facade_mesh_serve_round_trip():
    """One ``Dcf(mesh=).serve()`` round trip: a registered key served
    through the sharded walk on a 2 x 2 mesh, both parties, equal to the
    unsharded facade's shares; the registry counts the shards' bytes."""
    from dcf_tpu_torch.serve import DcfService, ServeConfig
    from dcf_tpu_torch.serve.registry import device_image_bytes
    from dcf_tpu_torch.testing.faults import FakeClock

    d = Dcf(NB, 16, CK[:2], mesh=cpu_mesh((2, 2)))
    one = Dcf(NB, 16, CK[:2], device="cpu")
    rng = np.random.default_rng(90)
    alphas = rng.integers(0, 256, (2, NB), dtype=np.uint8)
    bundle = d.gen(alphas, rng.integers(0, 256, (2, 16), np.uint8),
                   rng=rng)
    svc = DcfService(d, ServeConfig(max_batch=64), clock=FakeClock())
    svc.register_key("k", bundle)
    xs = points(alphas, 37, 91)
    futs = [svc.submit("k", xs, b=b) for b in (0, 1)]
    svc.pump()
    for b, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(0), one.eval(b, bundle, xs))
    be = svc.registry.resident("k", 0)
    assert isinstance(be, ShardedWalkBackend)
    assert device_image_bytes(be) == sum(
        device_image_bytes(x) for x in be.shard_backends()) > 0
