"""Two-process pod-mesh parity of the port: counterpart of
``tests/test_mesh_multiproc.py``.

Two OS processes join one ``torch.distributed`` group over ``gloo``
(``parallel._compat.distributed_initialize``, a free loopback port),
build the pod mesh (one CPU position each) and co-evaluate one batch:
each stages only its own slice of the points, the large-lambda hybrid
runs there (B4 + W1's plain versions), and the two-party count is the
one collective, an ``all_reduce`` SUM that must read 0 in both.  The
parent pins each process's share bytes against ``dcf_tpu``'s numpy
oracle and against the port's single-process
``ShardedLargeLambdaBackend`` over the same two positions, both parties,
at ``dcf_tpu``'s shape: lam = 64, a 16-bit domain, 70 points (35 a
process, padded), K in {1, 3}.

Unlike ``dcf_tpu``'s, this test runs in tier 1: its workers run torch on
the CPU, a few seconds each.  A group that cannot form fails the test;
every worker has a wall-clock limit of its own, so a hung rendezvous
fails it too and cannot hang the suite."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from tests.test_mesh_multiproc import material as j_material

from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.parallel import ShardedLargeLambdaBackend, make_mesh
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

LAM = 64
NB2 = 2   # 16-bit domain
M = 70    # 35 local points a process, padded per position
NPROC = 2
WORKER_TIMEOUT_S = 120

# The worker: argv port nproc pid outdir k_num.  It takes the key
# material from dcf_tpu's seed through its DCFK frame, written by the
# parent, asserts that the group-wide count reads 0, and leaves its
# local share bytes as .npy files.
WORKER = '''\
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
port, nproc, pid, outdir, k_num = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    int(sys.argv[5]))

import torch.distributed as dist

from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.parallel import MeshLargeLambdaBackend, make_pod_mesh
from dcf_tpu_torch.parallel._compat import (
    distributed_initialize, process_count, process_index)

distributed_initialize("127.0.0.1:" + port, nproc, pid, backend="gloo",
                       timeout_s=60)
try:
    distributed_initialize("127.0.0.1:" + port, nproc, pid)  # a no-op
    assert (process_index(), process_count()) == (pid, nproc)
    mat = np.load(os.path.join(outdir, "material_K%d.npz" % k_num))
    ck = [bytes(c) for c in mat["ck"]]
    bundle = KeyBundle.from_bytes(mat["frame"].tobytes())
    alphas, betas, xs = mat["alphas"], mat["betas"], mat["xs"]
    mesh = make_pod_mesh(device="cpu")
    assert mesh.shape == {"keys": 1, "points": nproc}, mesh.shape
    be = {b: MeshLargeLambdaBackend(LAM_BYTES, ck, mesh) for b in (0, 1)}
    m_local = xs.shape[0] // nproc
    xs_local = xs[pid * m_local:(pid + 1) * m_local]
    ys, staged = {}, None
    for b in (0, 1):
        be[b].put_bundle(bundle.for_party(b))
        if staged is None:
            staged = be[b].stage(xs_local)
        ys[b] = be[b].eval_staged(b, staged)
        np.save(os.path.join(outdir, "shares_K%d_b%d_p%d.npy"
                             % (k_num, b, pid)),
                be[b].staged_to_bytes(ys[b], staged["m"]))
    bad = int(be[0].points_mismatch_count(ys[0], ys[1], alphas, betas,
                                          staged))
    assert bad == 0, "pid %d: %d mismatching (key, point) pairs" % (
        pid, bad)
    moved = alphas.copy()
    moved[0] = 0xFF  # key 0's alpha at the top: its points above alpha count
    print("PARITY-OK pid=%d moved=%d" % (pid, int(
        be[0].points_mismatch_count(ys[0], ys[1], moved, betas, staged))),
        flush=True)
finally:
    dist.destroy_process_group()
'''.replace("LAM_BYTES", str(LAM))

# A worker that is alone in a group of two: its rendezvous must fail
# typed within its timeout.
LONELY = '''\
import sys

from dcf_tpu_torch.errors import BackendUnavailableError
from dcf_tpu_torch.parallel._compat import distributed_initialize

try:
    distributed_initialize("127.0.0.1:" + sys.argv[1], 2, 0,
                           backend="gloo", timeout_s=2)
except BackendUnavailableError as e:
    print("TYPED:", str(e)[:80], flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env.pop("DCF_CPU_DEVICES", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(procs) -> list:
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"mesh worker hung past {WORKER_TIMEOUT_S} s "
                            "(a peer likely died before the collective)")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _material(tmp_path: Path, k_num: int):
    ck, prg, alphas, betas, jbundle, xs = j_material(k_num)
    np.savez(tmp_path / f"material_K{k_num}.npz",
             ck=np.array([np.frombuffer(c, np.uint8) for c in ck]),
             frame=np.frombuffer(jbundle.to_bytes(), np.uint8),
             alphas=alphas, betas=betas, xs=xs)
    return ck, prg, alphas, betas, jbundle, xs


@pytest.mark.parametrize("k_num", [1, 3])
def test_two_process_mesh_parity(tmp_path, k_num):
    """One batch, two OS processes, one pod mesh: each process's slice is
    byte-identical to the numpy oracle and to the single-process sharded
    backend, both parties; the group-wide count read 0 in both workers
    (asserted there), and a moved alpha counts the same total in both."""
    ck, prg, alphas, betas, jbundle, xs = _material(tmp_path, k_num)
    script = tmp_path / "mesh_worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(NPROC), str(pid),
         str(tmp_path), str(k_num)],
        cwd=str(REPO), env=_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(NPROC)]
    outs = _run(procs)
    moved = set()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "PARITY-OK" in out, out
        moved.add(out.split("moved=")[1].split()[0])
    assert len(moved) == 1 and int(moved.pop()) > 0  # the same total

    bundle = KeyBundle.from_bytes(jbundle.to_bytes())
    single = ShardedLargeLambdaBackend(LAM, ck,
                                       make_mesh(shape=(1, NPROC),
                                                 device="cpu"))
    for b in (0, 1):
        parts = [np.load(tmp_path / f"shares_K{k_num}_b{b}_p{pid}.npy")
                 for pid in range(NPROC)]
        assert all(p.shape == (k_num, M // NPROC, LAM) for p in parts)
        got = np.concatenate(parts, axis=1)  # process order = points order
        assert np.array_equal(got, j_eval_np(prg, b, jbundle.for_party(b),
                                             xs)), f"party {b} vs numpy"
        single.put_bundle(bundle.for_party(b))
        staged = single.stage(xs)
        want = single.staged_to_bytes(single.eval_staged(b, staged),
                                      staged["m"])
        assert np.array_equal(got, want), f"party {b} vs single process"


def test_lonely_rendezvous_raises_typed(tmp_path):
    """A group of two that only one process joins fails within its
    timeout with ``BackendUnavailableError``, not a hang."""
    script = tmp_path / "lonely.py"
    script.write_text(LONELY)
    proc = subprocess.Popen([sys.executable, str(script),
                             str(_free_port())], cwd=str(REPO), env=_env(),
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    out = _run([proc])[0]
    assert proc.returncode == 0 and "TYPED:" in out, out
