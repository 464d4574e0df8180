"""Runs phase 24 of ``chip_smoke.py`` (``pod_bench``'s scenarios, each shard
a process of its own) alone on one GPU, and can also run ``pod_bench
--surge`` at ``dcf_tpu``'s own admission bound and bundle count, which
phase 24 changes, to report what that scenario does on the card.

    python3 chip_phase24.py                      # every group of phase 24
    python3 chip_phase24.py prefix mesh          # the groups holding these runs
    python3 chip_phase24.py --surge-default      # phase 24, then the default surge
    python3 chip_phase24.py --surge-default none # the default surge alone

Builds every kernel first (as ``pod_bench``'s parent does on the card, so
that the runs of a group do not build at once), opens a CUDA context as
the smoke has by then, and calls ``chip_smoke.pod_phase`` on the groups of
``chip_smoke.POD_GROUPS`` that hold a named run (all of them when none is
named).  The default surge (``--surge --backend prefix --duration 8``, the
bound 4096 points, 4 bundles) is not held: its exit code, its failure
message and its line's numbers are printed.  Prints the card's name and
power limit, the phase's lines, and a JSON line of the results; exits
non-zero without CUDA or when the phase failed.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
import traceback

import chip_smoke

#: ``pod_bench --surge`` with dcf_tpu's defaults but the leg length phase
#: 24 cuts (``--duration`` 30 s to 8 s).
SURGE_DEFAULT = ["--surge", "--backend", "prefix", "--duration", "8"]


def surge_default(card: str) -> dict:
    """Run ``SURGE_DEFAULT`` on the card and report it without holding
    it: exit code, the bench's failure message, and its line's surge
    numbers."""
    repo = os.path.dirname(os.path.abspath(__file__))
    run = chip_smoke._start_pod_run("surge_default", SURGE_DEFAULT, repo)
    proc, watch = run["proc"], run["watch"]
    try:
        proc.wait(chip_smoke.POD_RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        watch.stop()
        for r in run["readers"]:
            r.join(60)
        for _tag, pid in watch.shards:
            try:
                os.kill(pid, 9)
            except ProcessLookupError:
                pass
        shutil.rmtree(run["root"], ignore_errors=True)
    for _t, line in run["err"]:
        print(f"  surge_default: {line}", flush=True)
    failure = next((line for _t, line in reversed(run["err"])
                    if line.startswith("pod_bench:")), "")
    rec = {}
    for _t, line in run["out"]:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
    keys = ("value", "unit", "calibrated_rps", "offered_rps", "reaction_s",
            "capacity_events", "shed", "failed")
    return {"argv": SURGE_DEFAULT, "rc": proc.returncode,
            "failure": failure,
            "seconds": round(time.perf_counter() - run["t0"], 1),
            "shards_seen": len(watch.shards),
            **{k: rec[k] for k in keys if k in rec}}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase24: no CUDA device", file=sys.stderr)
        return 1
    from dcf_tpu_torch import _build

    with_surge = "--surge-default" in argv
    names = [a for a in argv if a != "--surge-default"]
    groups = tuple(g for g in chip_smoke.POD_GROUPS
                   if not names or any(n in names for n, _a in g))
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card, flush=True)
    print(f"build {_build.build():.1f} s", flush=True)
    torch.zeros(1, device="cuda")  # this process's context, as in the smoke
    result, ok = {"card": card}, True
    t0 = time.perf_counter()
    if groups:
        try:
            result["phase24"] = chip_smoke.pod_phase(card, groups)
        except Exception as e:  # reported, then the default surge
            traceback.print_exc()
            result["phase24"] = {"error": str(e)}
            ok = False
        result["phase24_s"] = round(time.perf_counter() - t0, 1)
        print(f"chip_phase24: {len(groups)} groups "
              f"{'passed' if ok else 'FAILED'} in {result['phase24_s']} s "
              f"[{card}]", flush=True)
    if with_surge:
        result["surge_default"] = surge_default(card)
        print(f"chip_phase24: default surge {result['surge_default']} "
              f"[{card}]", flush=True)
    print(json.dumps(result, default=str), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
