"""Readings of the comparison's control on the card.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> <n> <n> ...

runs the cell at its own size, one seed after another in this process,
with the sampled answers replaced by the control's (``check.py``: the
``control`` of the configuration's reference in the program's place; for
``reference/dcf_ref.py``, AES-256 cut to ``CONTROL_ROUNDS`` rounds), and
prints each seed's numbers and whether the run came out correct.  ``--program`` reads the program's own
shares instead, for the lower readings on many seeds in one process.
Exits 0 where every control run came out not correct (every program run
correct with ``--program``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    want = bool(args.program)
    ok = True
    for seed in args.seeds:
        r = harness.run(args.workload, seed, args.seconds, False,
                        t_start=time.perf_counter(),
                        control=not args.program)
        ok &= r["correct"] is want
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": not args.program,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
