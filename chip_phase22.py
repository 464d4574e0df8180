"""Runs phase 22 of ``chip_smoke.py`` (the pod's control plane and the
lam >= 48 handoff) alone on one GPU, once for each HOGS argument, each run
beside that many busy host processes, to check that the phase's gates hold
on a host whose cores are shared.

    python3 chip_phase22.py 0 8 16

Builds the kernels the phase runs, then for each argument starts that many
processes that spin until the run ends, calls
``chip_smoke.control_plane_phase`` with launch counters of its own, and
stops them.  Prints the card's name and power limit, the phase's lines, one
line a run, and a JSON line of the runs; exits non-zero without CUDA or when
a run failed.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import sys
import time
import traceback

import chip_smoke

# The sources of the kernels phase 22 launches (B1, B2, B3, B5a, B5b, W1,
# G1, B7a, W2).
SOURCES = ("walk_eval", "tree_expand", "prefix_eval", "hybrid_state",
           "hybrid_prefix", "wide_xor", "keygen_walk", "keygen_wide")


def spin(stop) -> None:
    while not stop.is_set():
        pass


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase22: no CUDA device", file=sys.stderr)
        return 1
    from dcf_tpu_torch import _build
    from dcf_tpu_torch.ops.hybrid_prefix import (
        hybrid_prefix_eval, narrow_frontier)
    from dcf_tpu_torch.ops.keygen_walk import (
        keygen_dcf16, keygen_narrow, keygen_wide_tail)
    from dcf_tpu_torch.ops.prefix_eval import prefix_eval
    from dcf_tpu_torch.ops.tree_expand import tree_expand_levels
    from dcf_tpu_torch.ops.walk_eval import walk_eval
    from dcf_tpu_torch.ops.wide_tail import wide_tail

    hogs_per_run = [int(a) for a in argv] or [0]
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card, flush=True)
    build_s = _build.build(SOURCES)
    print(f"build {build_s:.1f} s", flush=True)
    counters = {"B1": walk_eval, "B2": tree_expand_levels, "B3": prefix_eval,
                "B5a": narrow_frontier, "B5b": hybrid_prefix_eval,
                "W1": wide_tail, "G1": keygen_dcf16, "B7a": keygen_narrow,
                "W2": keygen_wide_tail}

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def take_counts(name: str, want: dict) -> dict:
        ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
        for k, n in want.items():
            if ran.get(k) != n:
                raise RuntimeError(f"{name}: kernel {k} launched "
                                   f"{ran.get(k, 0)} times, expected {n}")
        return ran

    runs = []
    for hogs in hogs_per_run:
        stop = mp.Event()
        procs = [mp.Process(target=spin, args=(stop,)) for _ in range(hogs)]
        for p in procs:
            p.start()
        t0 = time.perf_counter()
        try:
            out = chip_smoke.control_plane_phase(card, reset_counts,
                                                 take_counts)
            run = {"hogs": hogs, "ok": True, "out": out}
        except Exception as e:  # a failed run is reported, then the next
            traceback.print_exc()
            run = {"hogs": hogs, "ok": False, "error": str(e)}
        finally:
            stop.set()
            for p in procs:
                p.join()
        run["seconds"] = time.perf_counter() - t0
        runs.append(run)
        print(f"chip_phase22: {hogs} busy processes: "
              f"{'passed' if run['ok'] else 'FAILED'} in "
              f"{run['seconds']:.1f} s [{card}]", flush=True)
    print(json.dumps({"runs": runs, "card": card}, default=str), flush=True)
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
