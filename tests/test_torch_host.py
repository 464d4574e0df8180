"""Port host foundation: dcf_tpu_torch's spec constants, numpy AES/PRG,
keygen, numpy oracle and KeyBundle against dcf_tpu's, byte for byte; and
the import rule (the port never imports jax or dcf_tpu).

The same seeded numpy inputs go through both packages; the tolerance is
exact byte equality (integer cryptography)."""

import ast
import contextlib
import pathlib

import numpy as np
import pytest

from dcf_tpu import spec as jspec
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.ops.aes import aes256_encrypt_np as j_aes
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.utils import groups as jgroups

from dcf_tpu_torch import spec as tspec
from dcf_tpu_torch.backends._common import prepare_batch
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np as t_eval_np
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.gen import gen_batch as t_gen_batch
from dcf_tpu_torch.gen import random_s0s as t_random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.aes import aes256_encrypt_np as t_aes
from dcf_tpu_torch.ops.aes import expand_key_np
from dcf_tpu_torch.ops.prg import HirosePrgNp as TPrg
from dcf_tpu_torch.utils import groups as tgroups
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
GROUPS = ("xor", "add8", "add16", "add32")
BOUNDS = ("LT_BETA", "GT_BETA")


def _keys(rng, n=2):
    return [rng.bytes(32) for _ in range(n)]


def _bundle_arrays(b):
    return (b.s0s, b.cw_s, b.cw_v, b.cw_t, b.cw_np1)


def test_spec_constants_match():
    assert tspec.AES_SBOX == jspec.AES_SBOX
    assert tspec.SHIFT_ROWS == jspec.SHIFT_ROWS
    assert tspec.GROUPS == jspec.GROUPS
    assert tspec.GROUP_WIDTH == jspec.GROUP_WIDTH
    assert [b.value for b in tspec.Bound] == [b.value for b in jspec.Bound]
    key = np.random.default_rng(1).bytes(32)
    assert tspec.aes256_expand_key(key) == jspec.aes256_expand_key(key)


@pytest.mark.parametrize("lam,nkeys", [(16, 2), (16, 1), (48, 18), (144, 18)])
def test_hirose_contract_matches(lam, nkeys, recwarn):
    got = tspec.hirose_used_cipher_indices(lam, nkeys)
    assert got == jspec.hirose_used_cipher_indices(lam, nkeys)
    with pytest.raises(ValueError):
        tspec.hirose_used_cipher_indices(lam + 8, nkeys)
    with pytest.raises(ValueError):
        tspec.hirose_used_cipher_indices(32, 17)


def test_check_group_matches():
    for group in GROUPS:
        tspec.check_group(group, 16)
    for bad, lam in (("add64", 16), ("nope", 16), ("add32", 3)):
        with pytest.raises(ValueError):
            jspec.check_group(bad, lam)
        with pytest.raises(ValueError):
            tspec.check_group(bad, lam)


def test_aes_and_prg_match():
    rng = np.random.default_rng(2)
    keys = _keys(rng, 18)
    rk = expand_key_np(keys[0])
    blocks = rng.integers(0, 256, (5, 7, 16), dtype=np.uint8)
    assert np.array_equal(t_aes(rk, blocks), j_aes(rk, blocks))
    for lam in (16, 48):
        seeds = rng.integers(0, 256, (3, 5, lam), dtype=np.uint8)
        with pytest.warns(jspec.ReferenceContractWarning) if lam == 48 \
                else contextlib.nullcontext():
            jp = JPrg(lam, keys)
        with pytest.warns(tspec.ReferenceContractWarning) if lam == 48 \
                else contextlib.nullcontext():
            tp = TPrg(lam, keys)
        jo, to = jp.gen(seeds), tp.gen(seeds)
        for f in ("s_l", "v_l", "t_l", "s_r", "v_r", "t_r"):
            assert np.array_equal(getattr(to, f), getattr(jo, f)), f


def test_group_helpers_match():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    b = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    for group in GROUPS:
        for f in ("np_group_add", "np_group_sub"):
            assert np.array_equal(getattr(tgroups, f)(a, b, group),
                                  getattr(jgroups, f)(a, b, group))
        assert np.array_equal(tgroups.np_group_neg(a, group),
                              jgroups.np_group_neg(a, group))
        assert np.array_equal(tgroups.np_group_reduce(a, group),
                              jgroups.np_group_reduce(a, group))


@pytest.mark.parametrize("n_bytes", [2, 16])
@pytest.mark.parametrize("group", GROUPS)
def test_gen_batch_matches(n_bytes, group):
    rng = np.random.default_rng(10 + n_bytes + len(group))
    keys = _keys(rng)
    k_num = 3
    for bound in BOUNDS:
        alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
        betas = rng.integers(0, 256, (k_num, 16), dtype=np.uint8)
        s0s = t_random_s0s(k_num, 16, rng)
        jb = j_gen_batch(JPrg(16, keys), alphas, betas, s0s,
                         getattr(jspec.Bound, bound), group=group)
        tb = t_gen_batch(TPrg(16, keys), alphas, betas, s0s,
                         getattr(tspec.Bound, bound), group=group)
        for got, want in zip(_bundle_arrays(tb), _bundle_arrays(jb)):
            assert got.dtype == np.uint8
            assert np.array_equal(got, want)
        assert tb.group == jb.group == group


@pytest.mark.parametrize("group", GROUPS)
def test_eval_batch_np_matches_on_carried_bundle(group):
    """A dcf_tpu bundle carried across with KeyBundle.from_arrays evaluates
    identically in both packages' numpy oracles, shared and per-key
    points, with x = alpha planted."""
    rng = np.random.default_rng(20 + len(group))
    keys = _keys(rng)
    k_num, n_bytes, m = 2, 2, 37
    for bound in BOUNDS:
        alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
        jb = j_gen_batch(JPrg(16, keys), alphas,
                         rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
                         t_random_s0s(k_num, 16, rng),
                         getattr(jspec.Bound, bound), group=group)
        tb = KeyBundle.from_arrays(*_bundle_arrays(jb), group=jb.group)
        shared = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
        shared[0] = alphas[0]
        per_key = rng.integers(0, 256, (k_num, m, n_bytes), dtype=np.uint8)
        per_key[:, 0] = alphas
        for xs in (shared, per_key):
            for b in (0, 1):
                want = j_eval_np(JPrg(16, keys), b, jb.for_party(b), xs)
                got = t_eval_np(TPrg(16, keys), b, tb.for_party(b), xs)
                assert np.array_equal(got, want), (bound, b, xs.ndim)


def test_key_bundle_contract():
    rng = np.random.default_rng(4)
    keys = _keys(rng)
    tb = t_gen_batch(TPrg(16, keys),
                     rng.integers(0, 256, (2, 2), dtype=np.uint8),
                     rng.integers(0, 256, (2, 16), dtype=np.uint8),
                     t_random_s0s(2, 16, rng), tspec.Bound.LT_BETA)
    r = repr(tb)
    assert "redacted" in r and "K=2" in r and "n_bits=16" in r
    assert tb.s0s.tobytes().hex() not in r
    p1 = tb.for_party(1)
    assert p1.s0s.shape == (2, 1, 16)
    assert np.array_equal(p1.s0s[:, 0], tb.s0s[:, 1])
    with pytest.raises(ShapeError):
        p1.for_party(0)
    with pytest.raises(ValueError):
        tb.for_party(2)
    assert (tb.num_keys, tb.n_bits, tb.n_bytes, tb.lam) == (2, 16, 2, 16)
    # from_arrays copies, and refuses a value-changing cast.
    src = list(_bundle_arrays(tb))
    carried = KeyBundle.from_arrays(*src)
    src[1][0, 0, 0] ^= 1
    assert carried.cw_s[0, 0, 0] != src[1][0, 0, 0]
    with pytest.raises(ShapeError):
        KeyBundle.from_arrays(src[0].astype(np.int32), *src[1:])
    with pytest.raises(ShapeError):
        KeyBundle.from_arrays(src[0], src[1][:, :3], *src[2:])
    with pytest.raises(ShapeError):
        KeyBundle.from_arrays(*src, group="add32x")


def test_gen_batch_input_contract():
    rng = np.random.default_rng(5)
    prg = TPrg(16, _keys(rng))
    a = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    b = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    s0s = t_random_s0s(2, 16, rng)
    with pytest.raises(ShapeError, match="alphas"):
        t_gen_batch(prg, a.astype(np.int64), b, s0s, tspec.Bound.LT_BETA)
    with pytest.raises(ShapeError):
        t_gen_batch(prg, a, b[:1], s0s, tspec.Bound.LT_BETA)


def test_prepare_batch_pads_and_promotes():
    xs = np.arange(10, dtype=np.uint8).reshape(5, 2)
    out, shared, m = prepare_batch((3, 16), xs, lambda m: 8)
    assert shared and m == 5 and out.shape == (1, 8, 2)
    assert np.array_equal(out[0, :5], xs) and not out[0, 5:].any()
    with pytest.raises(ShapeError):
        prepare_batch((3, 16), np.zeros((2, 5, 2), np.uint8), lambda m: m)
    with pytest.raises(ShapeError):
        prepare_batch((3, 24), xs, lambda m: m)


def _port_sources():
    files = sorted((REPO / "dcf_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "chip_ab.py",
                    REPO / "chip_phase22.py", REPO / "chip_phase24.py",
                    REPO / "chip_gates.py", REPO / "bench_torch.py"]


def test_port_imports_neither_jax_nor_dcf_tpu():
    """AST scan of every module of the port (its C++ core's loader
    included), chip_smoke.py, chip_ab.py, chip_phase22.py,
    chip_phase24.py, chip_gates.py and bench_torch.py: no ``import
    jax``/``from jax`` and nothing of ``dcf_tpu`` (whose ``__init__``
    imports jax)."""
    files = _port_sources()
    assert len(files) > 15
    scanned = {str(f.relative_to(REPO)) for f in files}
    for sub in ("protocols/dpf.py", "workloads/pir.py", "workloads/core.py",
                "testing/faults.py", "backends/evalall.py",
                "ops/evalall_expand.py", "ops/pir_answer.py",
                "ops/keygen_walk.py", "ops/keylanes_eval.py",
                "backends/device_gen.py", "backends/keylanes_backend.py",
                "protocols/combine.py", "native/__init__.py",
                "protocols/oracle.py", "protocols/keygen.py",
                "protocols/ic.py", "protocols/mic.py",
                "protocols/piecewise.py", "protocols/fixedpoint.py",
                "protocols/__init__.py", "spec.py", "keys.py", "api.py",
                "serve/edge.py", "serve/router.py", "serve/health.py",
                "serve/shardmap.py", "serve/meshgroup.py",
                "serve/replicate.py", "serve/loadgen.py",
                "serve/service.py", "serve/membership.py",
                "serve/capacity.py", "testing/lockwatch.py", "errors.py",
                "cli.py", "entry.py", "utils/provision.py",
                "parallel/__init__.py", "parallel/_compat.py",
                "parallel/mesh.py", "parallel/sharded.py",
                "parallel/mesh_eval.py"):
        assert f"dcf_tpu_torch/{sub}" in scanned
    assert "bench_torch.py" in scanned and "chip_gates.py" in scanned
    assert "chip_phase24.py" in scanned
    banned = ("jax", "jaxlib", "dcf_tpu")
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path.name}:{node.lineno} {name}")
    assert offenders == []


def test_chip_ab_cases_are_built_kernels():
    """Every case of chip_ab.py names a kernel source that ``_build``
    builds."""
    import sys

    from dcf_tpu_torch import _build

    sys.path.insert(0, str(REPO))
    try:
        import chip_ab
    finally:
        sys.path.remove(str(REPO))
    assert chip_ab.CASES
    assert {src for src, _ in chip_ab.CASES.values()} <= set(_build.KERNELS)
    assert all(callable(case) for _, case in chip_ab.CASES.values())


def _public_names(module) -> set:
    """A package's top-level names: what ``__all__`` lists, or else
    every public non-module attribute, plus ``__version__``."""
    import inspect

    names = set(getattr(module, "__all__", ()))
    if not names:
        names = {n for n, v in vars(module).items()
                 if not n.startswith("_") and not inspect.ismodule(v)}
    if hasattr(module, "__version__"):
        names.add("__version__")
    return names


#: ``dcf_tpu.serve`` names whose modules are still queued (ROADMAP.md):
#: none since the membership and capacity controllers were ported.
SERVE_QUEUED: set = set()


def test_top_level_and_serve_names_include_dcf_tpus():
    """A caller that swaps ``import dcf_tpu`` for ``import
    dcf_tpu_torch`` finds every top-level name, and every
    ``dcf_tpu.serve`` name but those of modules still queued; each
    exported name resolves."""
    import dcf_tpu
    import dcf_tpu.serve as jserve

    import dcf_tpu_torch
    import dcf_tpu_torch.serve as tserve

    assert _public_names(dcf_tpu) - _public_names(dcf_tpu_torch) == set()
    assert dcf_tpu_torch.__version__ == dcf_tpu.__version__
    assert set(jserve.__all__) - set(tserve.__all__) == SERVE_QUEUED
    for mod in (dcf_tpu_torch, tserve):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
    import dcf_tpu_torch.testing as ttesting

    assert set(ttesting.lockwatch.__all__) == {
        "LockWatch", "WatchedLock", "WatchedRLock", "arm", "disarm"}


def test_dcflint_reports_no_violations_in_the_port():
    """``tools.dcflint`` over the port, read-only: typed errors or marked
    API edges, no unmarked wall-clock reads or OS-entropy seeds, no
    unmarked blanket handlers."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "tools.dcflint", "dcf_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "dcflint OK under dcf_tpu_torch" in out.stdout


def _repaired_sites():
    """(name, dcf_tpu call, port call) pairs: one repaired site each of
    spec.py, api.py, workloads/pir.py and protocols/piecewise.py, fed the
    same bad input."""
    import dcf_tpu
    from dcf_tpu.protocols import piecewise as jpw
    from dcf_tpu.workloads import pir as jpir

    import dcf_tpu_torch
    from dcf_tpu_torch.protocols import piecewise as tpw
    from dcf_tpu_torch.workloads import pir as tpir

    ck = [bytes(32), bytes(32)]
    rec = np.zeros((32, 32), dtype=np.uint8)
    return [
        ("spec.check_group", lambda: jspec.check_group("add7", 16),
         lambda: tspec.check_group("add7", 16)),
        ("spec.aes256_expand_key", lambda: jspec.aes256_expand_key(b"x"),
         lambda: tspec.aes256_expand_key(b"x")),
        ("api.Dcf n_bytes", lambda: dcf_tpu.Dcf(0, 16, ck),
         lambda: dcf_tpu_torch.Dcf(0, 16, ck, device="cpu")),
        ("pir.PirServer party",
         lambda: jpir.PirServer(None, jpir.PirDatabase(rec, 5),
                                None).answer("q", 2),
         lambda: tpir.PirServer(None, tpir.PirDatabase(rec, 5, "cpu"),
                                None).answer("q", 2)),
        ("pir.PirServer retries",
         lambda: jpir.PirServer(None, None, None, retries=-1),
         lambda: tpir.PirServer(None, None, None, retries=-1)),
        ("piecewise.cuts", lambda: jpw.partition_intervals([], 16),
         lambda: tpw.partition_intervals([], 16)),
        ("piecewise.increasing",
         lambda: jpw.partition_intervals([5, 3], 16),
         lambda: tpw.partition_intervals([5, 3], 16)),
    ]


@pytest.mark.parametrize("idx", range(7))
def test_repaired_sites_raise_dcf_tpus_class(idx):
    name, ref, port = _repaired_sites()[idx]
    with pytest.raises(Exception) as want:
        ref()
    with pytest.raises(Exception) as got:
        port()
    assert type(got.value).__name__ == type(want.value).__name__, name
    assert isinstance(got.value, ValueError), name


#: dcf_tpu's three sharded routes to the from-root walk (its XLA byte
#: walk, its bitsliced core and its Pallas kernel) are one class of the
#: port's, as the module docstring of dcf_tpu_torch.parallel says.
PARALLEL_RENAMES = {"ShardedJaxBackend": "ShardedWalkBackend",
                    "ShardedBitslicedBackend": "ShardedWalkBackend",
                    "ShardedPallasBackend": "ShardedWalkBackend"}


def test_parallel_names_match_dcf_tpu():
    """Every public name of dcf_tpu.parallel has its counterpart in
    dcf_tpu_torch.parallel, under the documented renames."""
    import dcf_tpu.parallel as jpar

    import dcf_tpu_torch.parallel as tpar

    jnames = {n for n in dir(jpar) if not n.startswith("_")
              and (n.startswith("Sharded") or n.startswith("make_")
                   or n.startswith("Mesh"))}
    jnames.discard("mesh")  # the JAX package's submodule, not a name
    want = {PARALLEL_RENAMES.get(n, n) for n in jnames}
    assert want <= set(tpar.__all__), want - set(tpar.__all__)
    for name in tpar.__all__:
        assert getattr(tpar, name) is not None
