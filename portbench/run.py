"""The benchmark of the PyTorch and CUDA port (``dcf_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on this machine's card and prints one
JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, the numbers compared
with their limits, which also end standard error.

It exits non-zero and prints no result where CUDA is not available or
the card count is short of the cell's, where the program is not beside
it, and where JAX or the JAX package was loaded in this process once the
window has closed.  The kernels build into the program's own cache
inside the checkout (``dcf_tpu_torch/_build/``), so only a checkout's
first run compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "dcf_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``dcf_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    _, cell, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available; the benchmark runs on the "
              "card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} card(s), "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; the port "
              "must run without JAX", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        print(f"check {name}: {c['value']} (limit {limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
