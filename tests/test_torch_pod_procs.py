"""The port's multi-process pod (``dcf_tpu_torch.cli`` ``serve_host`` and
``pod_bench``) against ``dcf_tpu``'s (``dcf_tpu/cli.py:3202-5800``), on
the CPU with ``--device cpu``.

- the same bad argv exits non-zero in both packages with ``dcf_tpu``'s
  message, the port's before it picks a device;
- a port ``serve_host`` process (``--backend cpu``, the C++ core)
  restores a store ``dcf_tpu``'s ``KeyStore`` wrote and answers both
  parties byte-equal to ``dcf_tpu``'s numpy oracle through a ``dcf_tpu``
  ``EdgeClient``; beside it a ``dcf_tpu`` ``serve_host`` process on its
  ``numpy`` facade, the two behind the port's ``DcfRouter`` as one pod;
  on SIGTERM both drain, exit 0, remove their ready files and leave
  final snapshots with the same keys;

``tests/test_torch_pod_bench.py`` runs ``pod_bench``'s scenarios end to
end.  Every process a test starts is stopped by it; every wait is
bounded."""

from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from dcf_tpu import cli as jcli
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.ops.prg import HirosePrgNp as JHirosePrgNp
from dcf_tpu.serve import EdgeClient as JEdgeClient
from dcf_tpu.serve import KeyStore as JKeyStore
from dcf_tpu.spec import Bound as JBound

from dcf_tpu_torch import cli as tcli
from dcf_tpu_torch.serve import DcfRouter, ShardSpec
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 2026
NB, LAM = 16, 16
N_KEYS = 4
WAIT_S = 120.0


# -- flag validation: the same bad argv in both packages ---------------------

BAD_ARGV = [
    # tests/test_cli.py:454-469
    (["pod_bench", "--shards=1"], "shards"),
    (["pod_bench", "--backend=sharded"], "facade backends"),
    (["pod_bench", "--max-batch=64", "--min-req-points=200"],
     "request-size range"),
    (["serve_host"], "store-dir"),
    # :472-488
    (["pod_bench", "--partition", "--probe-interval=0"], "probe-interval"),
    (["pod_bench", "--partition", "--live-bundles=-1"], "live-bundles"),
    (["pod_bench", "--flap", "--shards=1"], "shards"),
    (["pod_bench", "--probe-interval=-1"], "probe-interval"),
    (["pod_bench", "--live-bundles=-1"], "live-bundles"),
    # :568-588
    (["pod_bench", "--surge", "--shards=1"], "--shards >= 2"),
    (["pod_bench", "--surge", "--standby-hosts=0"], "standby-hosts"),
    (["pod_bench", "--surge", "--probe-interval=0"], "probe-interval"),
    (["pod_bench", "--surge", "--reaction-bound=-1"], "reaction-bound"),
    (["pod_bench", "--surge", "--churn"], "separate"),
    (["pod_bench", "--surge", "--flap"], "separate"),
    # :628-648
    (["pod_bench", "--mesh", "--shards=1"], "shards >= 2"),
    (["pod_bench", "--mesh", "--surge"], "separate"),
    (["pod_bench", "--mesh", "--churn"], "separate"),
    (["pod_bench", "--mesh", "--partition"], "separate"),
    (["pod_bench", "--mesh", "--min-req-points=4096",
      "--max-req-points=128"], "ladder range"),
    # the churn scenario's own checks (dcf_tpu/cli.py:4068-4081)
    (["pod_bench", "--churn", "--shards=2"], "--churn needs --shards >= 3"),
    (["pod_bench", "--churn", "--eject-grace=0"], "eject-grace"),
]


@pytest.mark.parametrize("argv,match", BAD_ARGV,
                         ids=[" ".join(a) for a, _ in BAD_ARGV])
def test_pod_flag_validation_matches_dcf_tpu(argv, match, monkeypatch):
    """Both packages exit non-zero on the same argv with dcf_tpu's
    message; the port exits before it picks a device (so before any
    spawn or keygen)."""
    def no_work(args):
        raise AssertionError("the port started work on a bad argv")

    monkeypatch.setattr(tcli, "_dev", no_work)
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code not in (0, None)
        assert match in str(e.value.code), (main.__module__, e.value.code)


# -- shard processes of both packages ----------------------------------------

def _cipher_keys() -> list:
    """The cipher keys every serve_host derives from ``--seed``."""
    return jcli._cipher_keys(LAM, np.random.default_rng(SEED))


def _spawn(module: str, flags: list, tag: str, run_dir: pathlib.Path,
           env: dict) -> dict:
    """``python -m <module> serve_host`` on ``run_dir/<tag>``'s store."""
    ready = run_dir / f"ready-{tag}.json"
    metrics = run_dir / f"metrics-{tag}.json"
    err = run_dir / f"stderr-{tag}.log"
    with open(err, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", module, "serve_host", *flags,
             "--store-dir", str(run_dir / tag), "--ready-file", str(ready),
             "--metrics-file", str(metrics), "--seed", str(SEED),
             "--max-batch", "256"],
            cwd=REPO, env=env, stderr=fh)
    return {"proc": proc, "ready": ready, "metrics": metrics, "err": err}


def _stderr(shard: dict) -> str:
    return shard["err"].read_text()[-2000:]


def _wait_ready(shard: dict) -> dict:
    deadline = time.monotonic() + WAIT_S
    while not shard["ready"].exists():
        if shard["proc"].poll() is not None:
            raise AssertionError(
                f"serve_host exited rc={shard['proc'].returncode}: "
                f"{_stderr(shard)}")
        assert time.monotonic() < deadline, "serve_host never got ready"
        time.sleep(0.1)
    return json.loads(shard["ready"].read_text())


def _stop(shard: dict) -> int:
    proc = shard["proc"]
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(WAIT_S)
        raise


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """A store ``dcf_tpu``'s ``KeyStore`` wrote (N_KEYS bundles from
    ``dcf_tpu``'s host keygen, generations 1..N), copied to two shard
    processes: the port's ``serve_host --device cpu --backend cpu`` and
    ``dcf_tpu``'s ``serve_host --backend numpy``."""
    root = tmp_path_factory.mktemp("pod")
    rng = np.random.default_rng(SEED + 1)
    ck = _cipher_keys()
    bundles = {}
    for tag in ("port", "ref"):
        JKeyStore(str(root / tag))
    for i in range(N_KEYS):
        alphas = rng.integers(0, 256, (1, NB), dtype=np.uint8)
        betas = rng.integers(0, 256, (1, LAM), dtype=np.uint8)
        s0s = rng.integers(0, 256, (1, 2, LAM), dtype=np.uint8)
        kb = j_gen_batch(JHirosePrgNp(LAM, ck), alphas, betas, s0s,
                         JBound.LT_BETA)
        bundles[f"key-{i}"] = kb
        for tag in ("port", "ref"):
            JKeyStore(str(root / tag)).put(f"key-{i}", kb,
                                           generation=i + 1)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    shards = {
        "port": _spawn("dcf_tpu_torch.cli",
                       ["--device", "cpu", "--backend", "cpu"], "port",
                       root, env),
        "ref": _spawn("dcf_tpu.cli", ["--backend", "numpy"], "ref", root,
                      env),
    }
    try:
        for shard in shards.values():
            shard["doc"] = _wait_ready(shard)
        yield {"shards": shards, "bundles": bundles,
               "prg": JHirosePrgNp(LAM, ck), "rng": rng}
    finally:
        for shard in shards.values():
            if shard["proc"].poll() is None:
                shard["proc"].kill()
                shard["proc"].wait(WAIT_S)


def _oracle(pod, xs) -> dict:
    """``dcf_tpu``'s numpy oracle: {(key, party): share} at ``xs``."""
    return {(name, b): j_eval_np(pod["prg"], b, kb.for_party(b), xs)
            for name, kb in pod["bundles"].items() for b in (0, 1)}


def _direct_traffic(pod, tag: str, xs, want: dict) -> None:
    """Every key, both parties, straight to one shard through a
    ``dcf_tpu`` ``EdgeClient``: each share byte-equal to ``dcf_tpu``'s
    numpy oracle for that party."""
    doc = pod["shards"][tag]["doc"]
    with JEdgeClient(doc["host"], doc["port"], n_bytes=NB) as c:
        futs = {(name, b): c.submit(name, xs, b=b)
                for name in pod["bundles"] for b in (0, 1)}
        for k, fut in futs.items():
            assert np.array_equal(fut.result(timeout=WAIT_S), want[k]), (
                tag, k)


def test_port_shard_restores_dcf_tpu_store(pod):
    """The port's shard process restored every frame of the store
    ``dcf_tpu`` wrote and answers both parties byte-equal to
    ``dcf_tpu``'s oracle over ``dcf_tpu``'s client; the ``dcf_tpu``
    shard beside it does the same on the same points."""
    for tag in ("port", "ref"):
        doc = pod["shards"][tag]["doc"]
        assert doc["restored"] == N_KEYS and doc["quarantined"] == 0, doc
        assert doc["standby"] is False
        assert doc["pid"] == pod["shards"][tag]["proc"].pid
    xs = pod["rng"].integers(0, 256, (37, NB), dtype=np.uint8)
    want = _oracle(pod, xs)
    for tag in ("port", "ref"):
        _direct_traffic(pod, tag, xs, want)


def test_mixed_pod_behind_the_port_router(pod):
    """A ``dcf_tpu`` shard and a port shard on one ring behind the port's
    ``DcfRouter``: every key, both parties, byte-equal to the oracle,
    and each shard the owner of some key."""
    specs = [ShardSpec(tag, pod["shards"][tag]["doc"]["host"],
                       pod["shards"][tag]["doc"]["port"])
             for tag in ("port", "ref")]
    xs = pod["rng"].integers(0, 256, (50, NB), dtype=np.uint8)
    want = _oracle(pod, xs)
    router = DcfRouter(specs, n_bytes=NB)
    try:
        owners = {router.map.owner(n).host_id for n in pod["bundles"]}
        assert owners == {"port", "ref"}, owners
        futs = {(name, b): router.submit(name, xs, b=b)
                for name in pod["bundles"] for b in (0, 1)}
        for k, fut in futs.items():
            assert np.array_equal(fut.result(timeout=WAIT_S), want[k]), k
    finally:
        router.close()


def test_sigterm_drains_and_snapshot_keys_match_dcf_tpu(pod):
    """SIGTERM: both shards drain, exit 0, remove their ready files and
    leave a final snapshot; the port's has ``dcf_tpu``'s keys, key for
    key, after the same traffic."""
    xs = pod["rng"].integers(0, 256, (9, NB), dtype=np.uint8)
    want = _oracle(pod, xs)
    for tag in ("port", "ref"):
        _direct_traffic(pod, tag, xs, want)
    snaps = {}
    for tag in ("port", "ref"):
        shard = pod["shards"][tag]
        assert _stop(shard) == 0, _stderr(shard)
        assert not shard["ready"].exists()
        snaps[tag] = json.loads(shard["metrics"].read_text())
        assert snaps[tag]["serve_requests_total"] >= 4 * N_KEYS
        assert snaps[tag]["serve_batches_total"] > 0
    assert set(snaps["port"]) == set(snaps["ref"]), (
        set(snaps["port"]) ^ set(snaps["ref"]))
