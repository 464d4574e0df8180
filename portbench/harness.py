"""One run of one cell: set-up, the measured window, the traced reading,
the comparison, and the result line.

The harness is driven by data.  ``BENCHMARK.json`` names each cell's
configuration and traffic mix; the configuration is the file the
benchmark names for it, and it names its plain reference
(``reference/<reference>.py``); the mix is ``traffic/<traffic>.json``,
and it names its driver (``drivers/<driver>.py``, see ``generator.py``);
each metric, end-to-end or per-layer, is read by ``metrics/<name>.py``.  A cell, a
driver, a reference or a metric is added by adding files and entries,
never by editing this one.

The window is a closed loop with one request in flight: it runs for
``seconds``; the request in flight when it ends is finished and counted,
and the window's time runs to its completion.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from portbench import check, roofline, trace
from portbench.generator import Cell

__all__ = ["ROOT", "load_cell", "run", "Window", "rate",
           "p95_nearest_rank", "metric_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of ``workload``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {', '.join(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Window:
    """What an untraced window left, for the readers of the end-to-end
    metrics: the evaluations its finished requests completed, its start
    and end on the host's clock, every request's latency in seconds, and
    the run's set-up time."""

    evals: int
    start: float
    end: float
    latencies: list
    setup_s: float


def rate(evals: int, start: float, end: float) -> float:
    """Evaluations per second over the whole window."""
    return evals / (end - start)


def p95_nearest_rank(latencies: list) -> float:
    """The 95th percentile by nearest rank: the value at rank
    ceil(0.95 N) of the sorted latencies."""
    ordered = sorted(latencies)
    return ordered[-(-95 * len(ordered) // 100) - 1]


def metric_reader(name: str):
    """The ``read`` of ``metrics/<name>.py``: of a ``Window`` for an
    end-to-end metric, of ``trace.Records`` for a per-layer one.  A name
    may hold dots (``B3_roofline.api``), so the file is loaded by its
    path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _window(cell: Cell, seconds: float):
    """The measured window: (latencies, samples, failed, start, end,
    the indices of its requests)."""
    latencies, samples, failed = [], [], 0
    first = cell.calls
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        try:
            i, out = cell.request()
        except Exception:  # a failed request is counted, and the loop goes on
            if not failed:
                log("portbench: request %d failed:\n%s"
                    % (cell.calls - 1 - first, traceback.format_exc()))
            failed += 1
            i, out = cell.calls - 1, None
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        r = i - first
        if out is not None and cell.sampled(r):
            samples.append(cell.sample(r, i, out))
        del out
        if t1 >= deadline:
            return latencies, samples, failed, start, t1, range(first,
                                                                cell.calls)
        cell.advance(i)


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device: str = "cuda", overrides: dict | None = None,
        fault=None, control: bool = False) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``overrides`` ({"config": {...}, "traffic": {...}}), ``fault`` and
    ``control`` are for the tests and the control run only."""
    bench, _, config, traffic = load_cell(workload)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    t_inputs = time.perf_counter()
    cell = Cell(config, traffic, seed, device=device, trace=traced,
                fault=fault)
    t_setup = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - t_start
    phases = {"start and imports": t_inputs - t_start,
              "inputs from the seed": t_setup - t_inputs,
              **cell.setup_phases}
    log(f"portbench: {workload} seed {seed}: set-up {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()) + ")")

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        with cell.span("warmup"):  # the profiler's own first-call cost
            cell.warm()
    try:
        latencies, samples, failed, w0, w1, calls = _window(cell, seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    attempted = len(latencies)

    dev = {"platform": "gpu" if device != "cpu" else "cpu"}
    if device != "cpu":
        import torch

        dev.update(kind=torch.cuda.get_device_name(0), count=1,
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated(0)))
    else:
        dev.update(kind="cpu", count=1, memory_peak_bytes=0)
    for s in samples:
        if s.got is not None and not isinstance(s.got, np.ndarray):
            s.got = s.got.cpu().numpy()
    done = (attempted - failed) * cell.evals_per_request
    log(f"portbench: window {w1 - w0:.3f} s, {attempted} requests, "
        f"{done / (w1 - w0):.6g} evals/s, p95 "
        f"{1e3 * p95_nearest_rank(latencies):.4f} ms; fresh points "
        f"between requests {1e3 * cell.advance_s / attempted:.4f} ms a "
        "request")
    if traced:
        geometry = cell.driver.geometry(cell)
        points = cell.driver.points_summary(cell, calls)
    cell.close()

    metrics, breakdown = {}, None
    if not traced:
        win = Window(done, w0, w1, latencies, setup_s)
        for m in bench["end_to_end"]:
            if _applies(m, workload):
                metrics[m["name"]] = {"value": metric_reader(m["name"])(win),
                                      "unit": m["unit"]}
    else:
        ops, spans, skew = trace.records_from_profile(prof)
        log(f"portbench: device timestamps {skew / 1e6:+.3f} ms from their "
            "launches at the least; moved onto the host's clock")
        rec = trace.Records(
            ops, spans, requests=attempted, points=points,
            geometry=geometry,
            peaks=(roofline.peaks_for(dev["kind"]) if device != "cpu"
                   else None))
        for m in bench["per_layer"]:
            if _applies(m, workload):
                v = metric_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        w = trace.window(rec)
        busy = trace.busy_ns(rec)
        if w is not None:
            dev["busy_s"] = (busy or 0) / 1e9
            dev["window_s"] = (w[1] - w[0]) / 1e9
        breakdown = trace.breakdown(rec)

    checks = check.compare(cell, samples, failed,
                           int(traffic["min_compared"]), control=control)
    result = {"correct": check.limits_hold(checks),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
