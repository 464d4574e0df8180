"""The port's ``pod_bench`` scenarios end to end on the CPU (``--device
cpu --backend cpu``: shard processes on the port's C++ core), against
``dcf_tpu``'s (``dcf_tpu/cli.py:3587-5780``).

- the plain scenario (3 shard processes and the solo one, short legs):
  its routed parity gate, its open loop reconciled against the pod's
  rollup and its SIGKILL failover tally hold, and its line has
  ``dcf_tpu``'s ``RESULTS_pod`` keys, read from ``dcf_tpu/cli.py``;
- ``--churn``, ``--partition``, ``--flap``, ``--surge`` and ``--mesh``
  (``slow``, as ``dcf_tpu`` marks its own twins at
  ``tests/test_cli.py:491-692``), each line with its ``dcf_tpu``
  counterpart's keys.

A run fails on any gate but the throughput ones a test names: those
need cores this shared host does not give the shard processes."""

from __future__ import annotations

import ast
import json
import pathlib

import pytest

from dcf_tpu_torch import cli as tcli
from tests.torch_threads import few_cores, one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
COMMON = {"bench", "backend", "metric", "value", "unit", "device"}
PINNED = {"vs_baseline", "baseline"}


def _dcf_tpu_line_keys(func: str) -> set:
    """The keys of the ``extra`` dict ``dcf_tpu/cli.py``'s ``func``
    emits, as written there, plus the common keys and the port's
    ``device``; ``**res.latency_quantiles()`` stands for its p50/p90/p99
    keys, and a CPU line carries no pinned ratio."""
    tree = ast.parse((REPO / "dcf_tpu" / "cli.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    extra = next(n.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "extra"
                 and isinstance(n.value, ast.Dict))
    keys = set(COMMON)
    for k in extra.keys:
        if k is None:
            keys |= {"p50_s", "p90_s", "p99_s"}
        else:
            keys.add(k.value)
    return keys


def _run_pod_bench(capsys, argv: list, reported: str | None = None) -> dict:
    """One ``pod_bench`` run in process on the CPU: its one line.  A
    SystemExit is accepted only when every failure it names contains
    ``reported`` (a throughput gate this shared host cannot meet)."""
    try:
        tcli.main(["pod_bench", "--device", "cpu", "--backend", "cpu",
                   *argv])
    except SystemExit as e:
        failures = str(e.code).split(": ", 1)[-1].split("; ")
        assert reported and all(reported in f for f in failures), e.code
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["bench"] == "pod_bench" and rec["device"] == "cpu"
    assert rec["platform"] == "cpu" and not set(rec) & PINNED
    assert rec["repro"].startswith("python -m dcf_tpu_torch.cli pod_bench")
    return rec


def test_pod_bench_plain_scenario(capsys):
    """3 shard processes and the solo one: the routed parity gate (both
    parties, pod and solo), the open loop reconciled against the pod's
    rollup, the SIGKILL failover soak with every request accounted;
    ``dcf_tpu``'s ``RESULTS_pod`` keys.  ``pod_vs_single >= 2.2`` is not
    held here: the pod runs on three of the host's cores (``few_cores``,
    so that its shards leave the other test workers theirs), where the
    bench does not apply it; on a host that applies it, the shards
    share the cores with the other workers."""
    with few_cores(3):
        rec = _run_pod_bench(capsys, [
            "--shards=3", "--duration=4", "--bundles=3", "--live-bundles=2",
            "--max-batch=256", "--concurrency=3"],
            reported="single-shard leg")
    assert set(rec) == _dcf_tpu_line_keys("bench_pod"), (
        set(rec) ^ _dcf_tpu_line_keys("bench_pod"))
    assert rec["shards"] == 3 and rec["value"] > 0
    assert rec["soak_mismatches"] == 0
    assert rec["soak_unaccounted"] == 0
    assert rec["soak_refused_unhinted"] == 0
    assert rec["soak_sessions_ok"] >= 3 and rec["soak_critical_ok"] >= 1
    assert rec["failover_parity"] is True
    assert rec["generations_held"] is True
    assert rec["pod_quarantined"] == 0
    assert rec["open_loop_pod_reconciled"] is True
    assert rec["live_bundles"] == 2
    if rec["victim_live_keys"]:
        assert rec["critical_within_s"] is not None
        assert rec["down_observed"] is True


@pytest.mark.slow
def test_pod_bench_churn_scenario(capsys):
    rec = _run_pod_bench(capsys, [
        "--churn", "--shards=3", "--bundles=3", "--live-bundles=3",
        "--max-batch=256", "--eject-grace=1.5", "--probe-interval=0.2"])
    assert set(rec) == _dcf_tpu_line_keys("bench_pod_churn")
    assert rec["mode"] == "churn"
    assert rec["soak_mismatches"] == rec["soak_unaccounted"] == 0
    assert rec["soak_refused_unhinted"] == 0
    assert rec["digest_regressions"] == rec["lost_keys"] == 0
    assert rec["fence_held"] is True and rec["post_fence_parity"] is True
    assert rec["drained_exit_rc"] == 0 and rec["pod_quarantined"] == 0
    e1, e2, e3 = rec["epochs"]
    assert 1 <= e1 < e2 < e3
    for kind in ("eject", "join", "drain", "drain-complete"):
        assert kind in rec["membership_events"]
    assert rec["migrated_frames"] >= 1


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["partition", "flap"])
def test_pod_bench_selfheal_scenarios(mode, capsys):
    rec = _run_pod_bench(capsys, [
        f"--{mode}", "--shards=3", "--bundles=3", "--live-bundles=2",
        "--duration=4", "--max-batch=256"])
    assert set(rec) == _dcf_tpu_line_keys("bench_pod_selfheal")
    cycles = 3 if mode == "flap" else 1
    assert rec["mode"] == mode and rec["cycles"] == cycles
    assert rec["soak_mismatches"] == rec["soak_unaccounted"] == 0
    assert rec["soak_refused_unhinted"] == 0
    assert rec["down_seen"] == rec["up_recovered"] == cycles
    assert rec["digest_converged"] is True
    assert rec["digest_regressions"] == 0
    assert rec["fence_held"] is True and rec["post_heal_parity"] is True


@pytest.mark.slow
def test_pod_bench_surge_scenario(capsys):
    rec = _run_pod_bench(capsys, [
        "--surge", "--shards=2", "--standby-hosts=1", "--bundles=2",
        "--duration=8", "--max-batch=256"])
    assert set(rec) == _dcf_tpu_line_keys("bench_pod_surge")
    assert rec["mode"] == "surge"
    assert rec["reaction_s"] is not None
    assert rec["reaction_s"] <= rec["reaction_bound_s"]
    kinds = [k for k, _h, _e in rec["capacity_events"]]
    assert kinds.count("scale-out") >= 1 and kinds.count("scale-in") >= 1
    assert rec["lost_keys"] == rec["digest_regressions"] == 0
    assert rec["pod_critical_shed"] == 0 and rec["critical_hb_ok"] >= 1
    assert rec["osc_events"] == 0 and rec["osc_epoch_moved"] is False
    assert rec["post_shrink_parity"] is True
    assert len(rec["final_ring"]) == rec["shards"]


@pytest.mark.slow
def test_pod_bench_mesh_scenario(capsys):
    """Co-evaluation over 2 shard processes: parity (both modes, both
    parties), every co-evaluation accounted, no degrade; the crossover
    gate is not held on this shared host."""
    rec = _run_pod_bench(capsys, [
        "--mesh", "--shards=2", "--bundles=2", "--reps=3",
        "--max-batch=512", "--min-req-points=128",
        "--max-req-points=512"], reported="never beat route-mode")
    assert set(rec) == _dcf_tpu_line_keys("bench_pod_mesh")
    assert rec["mode"] == "mesh" and rec["mesh_workers"] == 2
    assert rec["mesh_degraded"] == 0
    assert rec["co_evals"] >= 2 * 2 + 2 * 3
    assert [r["points"] for r in rec["ladder"]] == [128, 512]
