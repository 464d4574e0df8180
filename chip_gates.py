"""Looks into the two throughput gates of the port's bench CLI that
``chip_smoke.py`` phase 23 reports and does not require, on one GPU:
``serve_bench --skew``'s cached frontier leg against its cold leg, and
``edge_bench``'s wire path against the in-process rate.

    python3 chip_gates.py            # both, RUNS times each
    python3 chip_gates.py skew 3     # one of them, 3 times

Each run calls ``dcf_tpu_torch.cli.main`` in process at the CLI's
defaults (``--duration 6``), with two probes around it: every closed-loop
segment's kernel B2 and B3 launches, rate and latency, and the wall time
of every prefix frontier build, host-returned and synchronised.  The edge
runs come in pairs, at the interpreter's default switch interval (5 ms)
and at 0.5 ms.  Prints the card's name and power limit, one JSON line a
run and a line of its segments; exits non-zero without CUDA.  The CLI's
own gates are reported on the run's line, not raised.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

RUNS = 2
SKEW = ["serve_bench", "--backend", "prefix", "--skew", "1.1",
        "--duration", "6"]
EDGE = ["edge_bench", "--backend", "prefix", "--duration", "6"]
KEEP = ("value", "inprocess_evals_per_sec", "wire_vs_inprocess",
        "cold_frontier_evals_per_sec", "cached_vs_cold", "frontier_hit_rate",
        "frontier_misses", "cached_key_stagings", "cold_key_stagings",
        "b2_launches_cached_leg", "b2_launches_cold_leg", "p50_s", "p90_s")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_gates: no CUDA device", file=sys.stderr)
        return 1
    from dcf_tpu_torch import _build, cli
    from dcf_tpu_torch.backends import prefix_backend
    from dcf_tpu_torch.ops.prefix_eval import prefix_eval
    from dcf_tpu_torch.ops.tree_expand import tree_expand_levels

    which = argv[0] if argv else "both"
    runs = int(argv[1]) if len(argv) > 1 else RUNS
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(f"build {_build.build():.1f} s", flush=True)

    from dcf_tpu_torch.serve import loadgen

    segments, builds = [], []
    real_loop = loadgen.closed_loop

    def counted_loop(svc, *args, **kw):
        b2, b3 = tree_expand_levels.launches, prefix_eval.launches
        res = real_loop(svc, *args, **kw)
        segments.append({
            "service": id(svc) % 10007, "wire": kw.get("clients") is not None,
            "B2": tree_expand_levels.launches - b2,
            "B3": prefix_eval.launches - b3,
            "evals_per_sec": round(res.throughput, 1),
            **res.latency_quantiles()})
        return res

    real_build = prefix_backend.PrefixBackend._build_frontier_tables

    def timed_build(self, b):
        t0 = time.perf_counter()
        out = real_build(self, b)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        builds.append((t1 - t0, time.perf_counter() - t0))
        return out

    loadgen.closed_loop = counted_loop
    prefix_backend.PrefixBackend._build_frontier_tables = timed_build

    def run(bench_argv, switch=0.005):
        segments.clear()
        builds.clear()
        sys.setswitchinterval(switch)
        out, err = io.StringIO(), io.StringIO()
        code = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                cli.main(bench_argv)
        except SystemExit as e:
            code = e.code
        finally:
            sys.setswitchinterval(0.005)
        rec = json.loads(out.getvalue().splitlines()[-1])
        row = {"argv": " ".join(bench_argv), "switch_s": switch,
               "exit": str(code), "s": round(time.perf_counter() - t0, 1),
               **{k: rec[k] for k in KEEP if k in rec}}
        if builds:
            host = sorted(t for t, _ in builds)
            synced = sorted(t for _, t in builds)
            row.update(frontier_builds=len(builds),
                       build_ms_median=round(host[len(host) // 2] * 1e3, 2),
                       build_ms_synced_median=round(
                           synced[len(synced) // 2] * 1e3, 2))
        print(json.dumps(row), flush=True)
        print("  segments " + json.dumps(segments), flush=True)

    for _ in range(runs):
        if which in ("both", "skew"):
            run(SKEW)
        if which in ("both", "edge"):
            run(EDGE)
            run(EDGE, switch=0.0005)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
