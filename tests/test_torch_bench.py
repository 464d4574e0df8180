"""The port's bench line, ``bench_torch.py``, on the CPU at M = 4096 points.

Run as a user runs it (``--device cpu``: the kernels' plain versions), it
prints exactly one JSON line on stdout with the line's fields and
``"device": "cpu"``, after both parity checks; a byte flipped in the
anchor, or in party 1's shares, makes it exit non-zero with no line."""

import json
import pathlib
import subprocess
import sys

import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
FIELDS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_band",
          "baseline", "parity", "device"}


def _bench():
    sys.path.insert(0, str(REPO))
    try:
        import bench_torch
    finally:
        sys.path.remove(str(REPO))
    return bench_torch


def test_bench_prints_one_parity_checked_line():
    """The prefix path at M = 4096 on the CPU: one JSON line on stdout,
    every field, the parity string, ``vs_baseline`` against the pinned
    rate; stderr shows both parity checks and the drift check."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py"), "--device", "cpu",
         "--points", "4096"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == FIELDS
    assert line["metric"] == "dcf_batch_eval_evals_per_sec_per_chip"
    assert line["device"] == "cpu"
    assert "prefix path" in line["unit"] and "host-clock" in line["unit"]
    assert line["parity"] == ("full (device, 4096 pts two-party, 0 "
                              "mismatches) + C++ 4096-pt anchor")
    pinned = json.loads((REPO / "benchmarks" / "cpu_baseline.json")
                        .read_text())["evals_per_sec"]
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / pinned, 2)
    lo, hi = line["vs_baseline_band"]
    assert lo <= line["vs_baseline"] <= hi
    assert "parity against the C++ core, first 4096 points: OK" \
        in proc.stderr
    assert "parity, two parties over all 4096 points: 0 mismatches" \
        in proc.stderr
    assert "drift check only" in proc.stderr


@pytest.mark.parametrize("where", ["anchor", "party 1"])
def test_bench_planted_flip_exits_nonzero(where, monkeypatch, capsys):
    """A byte flipped in the C++ anchor (or in party 1's shares) fails
    its parity check: main returns 1 and prints no line (the walk path,
    at M = 4096 on the CPU)."""
    from dcf_tpu_torch import native
    from dcf_tpu_torch.backends.walk_backend import WalkBackend

    if where == "anchor":
        real = native.NativeDcf.eval

        def flipped(self, b, bundle, xs, num_threads=None):
            ys = real(self, b, bundle, xs, num_threads)
            if xs.shape[0] == 4096 and num_threads is None:
                ys[0, 4095, 7] ^= 0x10
            return ys

        monkeypatch.setattr(native.NativeDcf, "eval", flipped)
    else:
        real = WalkBackend.eval_staged

        def flipped(self, b, staged):
            y = real(self, b, staged)
            if b == 1:
                y[0, 17, 3] ^= 1
            return y

        monkeypatch.setattr(WalkBackend, "eval_staged", flipped)
    bench = _bench()
    assert bench.main(["--device", "cpu", "--points", "4096", "--backend",
                       "walk"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "parity check failed" in out.err
    assert ("C++ core" if where == "anchor" else "1 two-party mismatches") \
        in out.err
