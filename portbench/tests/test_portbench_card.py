"""On the card: every cell through the run's own command, with the
benchmark's window, comes out correct with its metrics; and the control
comes out not correct.  Skips on a host without a card.

    python3 -m pytest portbench/tests -m card
"""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import WORKLOADS


SECONDS = json.loads((harness.ROOT / "BENCHMARK.json").read_text())[
    "run_seconds"]


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload, traced):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str((1 << 31) + 99), "--seconds", str(SECONDS),
         "--trace", str(traced)], cwd=harness.ROOT, capture_output=True,
        text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["metrics"]
    if traced:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in r["metrics"].items()
                   if "roofline" in k)


@pytest.mark.card
def test_control_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", WORKLOADS[0],
         "--seconds", str(SECONDS), "--seeds", "5", "6", "7"],
        cwd=harness.ROOT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
