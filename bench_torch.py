"""Flagship bench line of the PyTorch/CUDA port: DCF batch-eval throughput
of one GPU, parity-checked.

    python3 bench_torch.py                      # on the card
    python3 bench_torch.py --backend walk       # kernel B1 instead
    python3 bench_torch.py --device cpu --points 4096

Workload, as ``bench.py`` (its lines 45-50 and 111-119): seed 2026, one
DCF key, an N = 16-byte domain (n = 128 levels), lam = 16, XOR group,
``LT_BETA``; 2^20 random points, party 0.  The key is made by the port's
C++ core (``dcf_tpu_torch.native.NativeDcf.gen_batch``).

Path: the port's ``prefix`` backend (``backends.prefix_backend``; kernel
B3 over the staged points, gathering each point's carry from the key's
frontier that kernel B2 builds at the party's first ``eval_staged``), or
``--backend walk`` (kernel B1 from the root).  There is no fallback
chain: a failing path raises and the script exits non-zero.

Clock: the points are staged on the card, two untimed ``eval_staged``
calls follow (the first builds the frontier, so B2 stays off the clock,
as in ``bench.py``), then 20 calls of ``eval_staged`` are timed one by
one with CUDA events on a synchronised card; the value is M over their
median.  On ``--device cpu`` the same code runs the kernels' plain
PyTorch versions and times two calls on the host clock: a rehearsal of
the code, whose line says ``"device": "cpu"`` and is no device figure.

Parity gates the line; either failure exits non-zero and prints no line:
a full two-party ``points_mismatch_count`` over every point (party 1 on a
second backend instance) must be 0, and party 0's first 4096 points
(``M_PARITY``) must equal the port's C++ core byte for byte.

Baseline: ``vs_baseline`` divides by the pinned single-core C++ rate of
``benchmarks/cpu_baseline.json`` (a missing file raises).  The in-run
single-core rate of the C++ core at 2^13 points is printed on stderr as a
drift check only.

Prints exactly one JSON line on stdout; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 2026
LAM = 16
N_BYTES = 16  # n = 128 levels
M_MAIN = 1 << 20  # points of the timed batch
M_CPU = 1 << 13  # points of the in-run single-core drift check
M_PARITY = 4096  # points held against the C++ core
SAMPLES = 20  # timed eval_staged calls on the card (2 on the CPU)
BASELINE = ROOT / "benchmarks" / "cpu_baseline.json"


class ParityError(RuntimeError):
    """A parity gate of the bench failed: the line is not printed."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pinned_baseline() -> dict:
    """The pinned single-core C++ rate; raises if the file is missing."""
    with open(BASELINE) as f:
        pinned = json.load(f)
    return {"evals_per_sec": float(pinned["evals_per_sec"]),
            "date": pinned["date"]}


def run(device: str = "cuda", points: int = M_MAIN,
        backend: str = "prefix") -> dict:
    """The bench: returns the JSON line's fields.  Raises ``ParityError``
    when a parity gate fails, and whatever the path raises."""
    import torch

    from dcf_tpu_torch.backends._common import resolve_device
    from dcf_tpu_torch.backends.prefix_backend import PrefixBackend
    from dcf_tpu_torch.backends.walk_backend import WalkBackend
    from dcf_tpu_torch.cli import card_label, device_samples
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.spec import Bound

    cls = {"prefix": PrefixBackend, "walk": WalkBackend}[backend]
    if points < 32 or points % 32:
        raise ValueError("points must be a positive multiple of 32")
    dev = resolve_device(device)
    samples = SAMPLES if dev.type == "cuda" else 2
    card = card_label(dev)
    log(f"device: {card}; torch {torch.__version__}")
    baseline = pinned_baseline()

    rng = np.random.default_rng(SEED)
    cipher_keys = [rng.bytes(32), rng.bytes(32)]
    native = NativeDcf(LAM, cipher_keys)
    log(f"native core: AES-NI={native.has_aesni}")
    alphas = rng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
    betas = rng.integers(0, 256, (1, LAM), dtype=np.uint8)
    bundle = native.gen_batch(alphas, betas, random_s0s(1, LAM, rng),
                              Bound.LT_BETA)
    xs = rng.integers(0, 256, (points, N_BYTES), dtype=np.uint8)

    m_cpu = min(points, M_CPU)
    cpu_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        native.eval(0, bundle, xs[:m_cpu], num_threads=1)
        cpu_times.append(time.perf_counter() - t0)
    inrun = m_cpu / float(np.median(cpu_times))
    log(f"C++ core, one thread, {m_cpu} points (median of 3): {inrun:,.0f} "
        f"evals/s, {inrun / baseline['evals_per_sec'] - 1:+.1%} against the "
        f"pinned {baseline['evals_per_sec']:,.1f} (drift check only)")
    m_par = min(points, M_PARITY)
    want = native.eval(0, bundle, xs[:m_par])[0]

    be0 = cls(LAM, cipher_keys, device=dev)
    be0.put_bundle(bundle.for_party(0))
    t0 = time.perf_counter()
    staged = be0.stage(xs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"stage {points} points: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    y0 = be0.eval_staged(0, staged)  # builds the prefix frontier
    got = be0.staged_to_bytes(y0, m_par)[0]
    log(f"first eval_staged (untimed; the frontier build included): "
        f"{time.perf_counter() - t0:.3f} s")
    if not np.array_equal(got, want):
        bad = int(np.flatnonzero((got != want).any(-1))[0])
        raise ParityError(f"party 0 differs from the C++ core on the first "
                          f"{m_par} points (first at point {bad})")
    log(f"parity against the C++ core, first {m_par} points: OK")
    y0 = be0.eval_staged(0, staged)
    be1 = cls(LAM, cipher_keys, device=dev)
    be1.put_bundle(bundle.for_party(1))
    y1 = be1.eval_staged(1, staged)  # the staged points serve both parties
    mism = int(be0.points_mismatch_count(y0, y1, alphas[0].tobytes(),
                                         betas[0].tobytes(), staged))
    log(f"parity, two parties over all {points} points: {mism} mismatches")
    if mism:
        raise ParityError(f"{mism} two-party mismatches over {points} "
                          "points")
    del y1, be1

    times = np.array(device_samples(lambda: be0.eval_staged(0, staged),
                                    samples, dev))
    med = float(np.median(times))
    mad = float(np.median(np.abs(times - med)))
    rate = points / med
    log(f"eval_staged samples (ms): "
        + " ".join(f"{t * 1e3:.3f}" for t in times)
        + f"; median {med * 1e3:.3f} +- MAD {mad * 1e3:.3f} ms -> "
        f"{rate:,.0f} evals/s [{card}]")
    pinned = baseline["evals_per_sec"]
    path = ("prefix path: kernel B3 over staged points, B2's frontier "
            "built before the clock" if backend == "prefix"
            else "walk path: kernel B1 from the root over staged points")
    clock = ("CUDA-event" if dev.type == "cuda" else "host-clock, plain "
             "PyTorch versions on the CPU")
    return {
        "metric": "dcf_batch_eval_evals_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": (f"evals/s (n=128, lam=16B, 1 key x {points} points, party "
                 f"0, {path}; median of {samples} {clock} samples of "
                 "eval_staged)"),
        "vs_baseline": round(rate / pinned, 2),
        "vs_baseline_band": [round(points / (med + mad) / pinned, 2),
                             round(points / max(med - mad, 1e-12) / pinned,
                                   2)],
        "baseline": (f"pinned {pinned} evals/s ({baseline['date']}, "
                     "benchmarks/cpu_baseline.json: the C++ core, one "
                     "thread, AES-NI)"),
        "parity": (f"full (device, {points} pts two-party, 0 mismatches) + "
                   f"C++ {m_par}-pt anchor"),
        "device": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--points", type=int, default=M_MAIN)
    ap.add_argument("--backend", default="prefix", choices=("prefix", "walk"))
    args = ap.parse_args(argv)
    try:
        line = run(args.device, args.points, args.backend)
    except ParityError as e:
        log(f"bench_torch: parity check failed: {e}")
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
