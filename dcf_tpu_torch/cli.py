"""Benchmark CLI of the PyTorch/CUDA port: the counterpart of
``dcf_tpu/cli.py``, every subcommand.

Each bench prints one human line on stderr and one JSON line on stdout,
parity-gated: a failing gate exits non-zero.  The subcommands, flags,
defaults and validation messages are ``dcf_tpu``'s:

- ``dcf``             single ``gen`` + single-point ``eval``, N=16, lam=16
- ``dcf_batch_eval``  batch eval (``--domain-bytes 4`` for the literal
                      n=32 shape, ``--keys`` for a key axis)
- ``dcf_large_lambda`` lam=16384 (or ``--lam``), ``hybrid`` with
                      ``--prefix-levels``
- ``secure_relu``     BASELINE.json config 5 (``--device-gen``: keygen G1,
                      eval B8 and the two-party count on the card)
- ``full_domain``     BASELINE.json config 3 (``tree``: B2 + B2f + the count)
- ``serve_bench``, ``edge_bench``, ``mic_bench``, ``gate_bench``,
  ``chaos_bench``, ``keyfactory_bench``: the serving tier in process
- ``keygen_bench``    keygen on the card (B7a + W2) at lam 128 and 256
- ``pir_bench``       2-server PIR (B6 t-only + P1)
- ``baseline``        all five BASELINE.json configurations, 8 lines
- ``serve_host``      one pod shard process: a ``DcfService`` warm-restored
                      from ``--store-dir`` behind an ``EdgeServer``
- ``pod_bench``       N ``serve_host`` processes behind a ``DcfRouter``:
                      the plain scenario, ``--partition`` / ``--flap``,
                      ``--churn``, ``--surge`` and ``--mesh``

Usage::

    python -m dcf_tpu_torch.cli dcf_batch_eval --backend prefix --points 1048576
    python -m dcf_tpu_torch.cli baseline
    python -m dcf_tpu_torch.cli dcf --backend numpy --device cpu
    python -m dcf_tpu_torch.cli pod_bench --backend prefix --shards 3

Backends: ``cpu`` (the port's C++ core, all threads), ``cpu1`` (one
thread), ``numpy`` (the oracle), ``walk`` (kernel B1; E1 at lam = 32),
``prefix`` (B2 builds a key's frontier, B3 walks the rest), ``keylanes``
(B8, many keys in lanes), ``hybrid`` (B4 + W1, or B5a + B5b + W1 with
``--prefix-levels``; lam >= 48) and ``tree`` (full_domain only).
``dcf_tpu``'s ``pallas``, ``jax`` and ``bitsliced`` compute the from-root
walk, which is ``walk`` here; each exits non-zero before any work.

A device mesh (``dcf_tpu_torch.parallel``): ``sharded`` and
``sharded-pallas`` run the sharded walk (B1) over ``--mesh KxP`` (every
card on the points axis by default); on ``secure_relu`` ``sharded`` is
the walk over a keys mesh and ``sharded-pallas`` B8 sharded
(``ShardedKeyLanesBackend``); ``--mesh KxP`` switches ``prefix``,
``hybrid`` and ``tree`` to their sharded classes.  ``DCF_CPU_DEVICES=N``
runs the CLI on N CPU positions (``--device cpu`` and a CPU mesh of N
positions, ``dcf_tpu``'s virtual-device mode).  Bare ``--mesh`` on
``pod_bench`` is its co-evaluation scenario over shard processes.
A pod's shards are processes of their own (``python -m
dcf_tpu_torch.cli serve_host``, spawned by ``pod_bench`` on its
``--device``): on the card each holds a CUDA context, and the parent
builds every kernel before the first spawn.

``--device`` picks the card (``cuda``, the default) or the CPU, where
the kernels' plain PyTorch versions run: a rehearsal of the code, whose
line says ``"device": "cpu"`` and carries no ``vs_baseline``.  There is
no fallback: ``--device cuda`` on a host without CUDA exits non-zero.
On the card every line's ``"device"`` is the card's name and power limit
as ``nvidia-smi`` gives them.

Clocks: staged evaluations are timed one ``eval_staged`` a sample with
CUDA events on a synchronised card (``bench_torch.py``'s clock), the
frontier built before the clock; whole pipelines (keygen, serving legs,
PIR batches) on the host clock with the card synchronised before and
after each sample.  ``--profile DIR`` writes a ``torch.profiler`` trace
of the timed region.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from dcf_tpu_torch.gen import random_s0s
from dcf_tpu_torch.spec import Bound

BACKENDS = ("cpu", "cpu1", "numpy", "walk", "prefix", "keylanes")
#: dcf_tpu's backend names that compute the from-root walk on the TPU.
WALK_ALIASES = ("pallas", "jax", "bitsliced")
#: dcf_tpu's mesh-sharded backends: the multi-GPU slice.
SHARDED = ("sharded", "sharded-pallas")
#: The multi-process pod benches: a shard process, and the bench that
#: spawns them.
POD_BENCHES = ("serve_host", "pod_bench")
#: The facade backends a shard process serves.
POD_BACKENDS = ("cpu", "numpy", "walk", "prefix")
#: The lam = 16 facade backends the serving benches drive.
SERVE_BACKENDS = ("numpy", "walk", "prefix")
#: The key count of the pinned keygen denominator (CPU_BASELINE.md).
KEYGEN_PIN_K = 64
PLAIN_NOTE = (" [no card in this run: the kernels' plain PyTorch versions "
              "on the CPU, disclosed]")

# The line's "device": set once per run by _dev (the card's name and
# power limit, or "cpu").
_CARD = {"label": "cpu"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _parse_mesh(spec: str):
    """'4x2' -> (4, 2); '' -> None (auto factorization)."""
    if not spec:
        return None
    try:
        k, p = spec.lower().split("x")
        return (int(k), int(p))
    except ValueError:
        raise SystemExit(f"--mesh wants KxP (e.g. 4x2), got {spec!r}")


def _mesh(args, dev, shape=None):
    """The run's device mesh over the run's device type: ``shape``, else
    ``--mesh KxP``, else ``make_mesh``'s factorization of every card (or
    CPU position).  A mesh the host cannot hold exits non-zero with
    ``make_mesh``'s text ("requested 4 devices, have 1")."""
    from dcf_tpu_torch.parallel import make_mesh

    try:
        mesh = make_mesh(shape=shape or _parse_mesh(args.mesh),
                         device=dev.type)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh or shape}: {e}")
    log(f"mesh: {mesh.shape}")
    return mesh


def _cipher_keys(lam: int, rng) -> list[bytes]:
    """The reference contract count 2*(lam/16), floored at 18 for lam >= 32
    (any such shape touches cipher index 17 — reference-inexecutable lams
    48..128 run here as extensions and need the extra keys)."""
    n_keys = max(2, 2 * (lam // 16))
    if lam >= 32:
        n_keys = max(n_keys, 18)
    return [rng.bytes(32) for _ in range(n_keys)]


def card_label(dev) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``"cpu"``."""
    import subprocess

    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = out.strip().splitlines()
    idx = dev.index or 0
    return lines[idx] if idx < len(lines) else lines[0]


def _dev(args):
    """The run's ``torch.device`` from ``--device`` (``provision.
    select_device``), chosen once, after a bench's own flag checks and
    before its first work.  No CUDA under ``--device cuda`` exits
    non-zero: nothing runs on the CPU unasked.  On the card, every
    kernel is built here (``provision.enable_kernel_cache``), so no timed
    leg pays for an nvcc run."""
    dev = getattr(args, "_device_obj", None)
    if dev is not None:
        return dev
    from dcf_tpu_torch.errors import BackendUnavailableError
    from dcf_tpu_torch.utils import provision

    try:
        dev = provision.select_device(getattr(args, "device", "cuda"))
        secs = provision.enable_kernel_cache() if dev.type == "cuda" else 0
    except BackendUnavailableError as e:
        raise SystemExit(f"--device {args.device}: {e}")
    if secs:
        log(f"built the CUDA kernels into {provision.repo_cache_dir()} "
            f"({secs:.1f} s)")
    args._device_obj = dev
    _CARD["label"] = card_label(dev)
    return dev


def _platform(dev) -> tuple[str, bool]:
    """(platform, interpreted) for a line: ``cuda`` runs the kernels;
    ``cpu`` runs their plain versions, disclosed like ``dcf_tpu``'s
    interpreter runs."""
    return ("cuda", False) if dev.type == "cuda" else ("cpu", True)


def _sync(dev) -> None:
    if dev is not None and dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _make_evaluator(backend: str, lam: int, cipher_keys, native, args=None,
                    dev=None):
    """Returns (eval_fn, backend_obj_or_None) where eval_fn(b, bundle_party,
    xs) -> uint8 [K, M, lam].  The backend object is None for host paths;
    benches use it to reach the staged protocol where one exists."""
    if backend in ("cpu", "cpu1"):
        threads = 1 if backend == "cpu1" else None

        def run(b, bundle, xs):
            return native.eval(b, bundle, xs, num_threads=threads)

        return run, None
    if backend == "numpy":
        from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
        from dcf_tpu_torch.ops.prg import HirosePrgNp

        prg = HirosePrgNp(lam, cipher_keys)
        return (lambda b, bundle, xs: eval_batch_np(prg, b, bundle, xs),
                None)
    if backend == "hybrid":
        # --prefix-levels=k > 0: the top k narrow-walk levels are expanded
        # once per (key, party) as a frontier (B5a) and only n-k levels
        # are walked per point (B5b); 0 walks from the root (B4).
        from dcf_tpu_torch.backends.large_lambda import LargeLambdaBackend

        plev = int(getattr(args, "prefix_levels", 0) or 0) if args else 0
        if args is not None and getattr(args, "mesh", ""):
            from dcf_tpu_torch.parallel import ShardedLargeLambdaBackend

            be = ShardedLargeLambdaBackend(lam, cipher_keys, _mesh(args, dev),
                                           prefix_levels=plev)
        else:
            be = LargeLambdaBackend(lam, cipher_keys, prefix_levels=plev,
                                    device=dev)
    elif backend == "walk":
        from dcf_tpu_torch.backends.walk_backend import WalkBackend

        be = WalkBackend(lam, cipher_keys, device=dev)
    elif backend == "keylanes":
        from dcf_tpu_torch.backends.keylanes_backend import KeyLanesBackend

        be = KeyLanesBackend(lam, cipher_keys, device=dev)
    elif backend == "prefix":
        # The prefix depth tracks the batch size (dcf_tpu's rule): one
        # level past log2(M), at least 6, capped at MAX_PREFIX_LEVELS; the
        # frontier is key material built before the clock.
        from dcf_tpu_torch.backends.prefix_backend import (
            MAX_PREFIX_LEVELS,
            PrefixBackend,
        )

        pts = (getattr(args, "points", 0) or 100_000) if args else 100_000
        klev = max(6, min(MAX_PREFIX_LEVELS, pts.bit_length()))
        if args is not None and getattr(args, "mesh", ""):
            # Single key: a 1xN points mesh (ShardedPrefixBackend).
            from dcf_tpu_torch.parallel import ShardedPrefixBackend

            be = ShardedPrefixBackend(lam, cipher_keys, _mesh(args, dev),
                                      prefix_levels=klev)
        else:
            be = PrefixBackend(lam, cipher_keys, prefix_levels=klev,
                               device=dev)
    elif backend in SHARDED:
        # dcf_tpu's two sharded routes to the from-root walk (its
        # bitsliced and Pallas cores) are the one sharded walk here.  The
        # criterion benches are single-key: every device on points.
        from dcf_tpu_torch.parallel import ShardedWalkBackend, make_mesh

        shape = _parse_mesh(getattr(args, "mesh", "") if args else "")
        if shape is None:
            shape = (1, make_mesh(device=dev.type).size)
        be = ShardedWalkBackend(lam, cipher_keys, _mesh(args, dev, shape))
    else:
        # api-edge: CLI backend-name contract
        raise ValueError(f"unknown backend {backend!r}")

    def run(b, bundle, xs):
        return be.eval(b, xs, bundle=bundle)

    return run, be


def device_samples(fn, reps: int, dev, profile: str = "") -> list[float]:
    """Seconds of each of ``reps`` calls of ``fn``, the card synchronised
    before each: CUDA events on the card (``bench_torch.py``'s clock),
    the host clock on the CPU."""
    import torch

    samples = []
    with _Profiler(profile, dev):
        for _ in range(max(reps, 1)):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                fn()
                stop.record()
                torch.cuda.synchronize(dev)
                samples.append(start.elapsed_time(stop) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                samples.append(time.perf_counter() - t0)
    return samples


def _median_mad(samples) -> tuple[float, float]:
    arr = np.array(samples)
    med = float(np.median(arr))
    return med, float(np.median(np.abs(arr - med)))


def _timed_staged(be, xs, reps: int, profile: str, dev):
    """Shared staged-bench timing (``bench_torch.py``'s methodology): the
    points are staged on the device (untimed, criterion-setup analog),
    two untimed ``eval_staged`` calls follow (the first builds a
    frontier where the backend has one, so B2 / B5a stay off the clock),
    then ``reps`` calls are timed one by one.  Returns (per-eval median,
    MAD, samples, unit)."""
    staged = be.stage(xs)
    for _ in range(2):
        be.eval_staged(0, staged)
    _sync(dev)
    ss = device_samples(lambda: be.eval_staged(0, staged), reps, dev,
                         profile)
    dt, mad = _median_mad(ss)
    clock = ("CUDA-event" if dev.type == "cuda"
             else "host-clock, plain PyTorch versions on the CPU")
    return (dt, mad, ss,
            f"evals/s (staged, results device-resident; median of "
            f"{len(ss)} {clock} samples of eval_staged)")


class _Profiler:
    """Optional ``torch.profiler`` trace around the timed region
    (``--profile DIR``: a Chrome trace, ``DIR/trace.json``)."""

    def __init__(self, trace_dir: str, dev=None):
        self.trace_dir = trace_dir
        self.dev = dev
        self._prof = None

    def __enter__(self):
        if self.trace_dir:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev is not None and self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import os

            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            log(f"profiler trace written to {path}")
        return False


def _timed(fn, reps: int, profile: str = "", dev=None):
    """Criterion-grade sampling: ``reps`` timed samples (caller warmed up),
    median +- MAD, on the host clock with the card synchronised before
    and after each sample.  Returns (median_s, mad_s, samples)."""
    samples = []
    with _Profiler(profile, dev):
        for _ in range(max(reps, 1)):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            samples.append(time.perf_counter() - t0)
    med, mad = _median_mad(samples)
    return med, mad, samples


def _load_pinned(baseline_path: str | None = None) -> dict | None:
    """Resolve + load benchmarks/cpu_baseline.json (read-only; the ONE
    loader the pinned-ratio helpers share); None when the file is absent
    or corrupt, so the caller omits vs_baseline instead of aborting."""
    import os

    path = baseline_path or os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "cpu_baseline.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


_PLAIN_NUMERATOR = ("; plain-version numerator (no card in this run) — "
                    "run the committed repro on a card for a real ratio")


def _pinned_ratio(nb: int, k: int, rate: float,
                  interpreted: bool = False,
                  baseline_path: str | None = None,
                  lam: int = 16, keygen: bool = False) -> dict:
    """vs_baseline against the pinned per-shape single-core CPU anchor
    (benchmarks/cpu_baseline.json): the flagship N=16 pin, the config-2
    literal n=32 entry, or the lam=128/256/16384 entries.  Empty
    otherwise (no silent in-run fallback), and empty for ``interpreted``
    runs.  ``keygen=True``: ``rate`` is keys/s against the pinned
    single-core numpy ``gen_batch`` denominator ``keygen.lam{lam}``, only
    at the pin's own key count, kept for interpreted runs with the
    numerator disclosed.  Same rules as ``dcf_tpu``'s helper."""
    if keygen:
        pinned = _load_pinned(baseline_path)
        if pinned is None:
            return {}
        entry = pinned.get("keygen", {}).get(f"lam{lam}")
        if not entry or k != entry.get("keys"):
            return {}
        note = _PLAIN_NUMERATOR if interpreted else ""
        return {"vs_baseline": round(rate / entry["keys_per_sec"], 2),
                "baseline": f"pinned single-core numpy gen_batch "
                            f"keygen.lam{lam} K={k} "
                            f"({entry['keys_per_sec']:,.1f} keys/s, "
                            f"CPU_BASELINE.md protocol{note})"}
    if k != 1 or interpreted:
        return {}
    pinned = _load_pinned(baseline_path)
    if pinned is None:
        return {}
    if lam != 16:
        tag = {128: "lam128", 256: "lam256", 16384: "lam16384"}.get(lam, "")
        entry = pinned.get("shapes", {}).get(tag) if tag else None
    else:
        entry, tag = ((pinned, "flagship") if nb == 16 else
                      (pinned.get("shapes", {}).get("n32"), "n32")
                      if nb == 4 else (None, ""))
    if not entry:
        return {}
    note = "; flagship-ratio transferred pin" if entry.get("anchor") else ""
    return {"vs_baseline": round(rate / entry["evals_per_sec"], 2),
            "baseline": f"pinned single-core {tag} "
                        f"({entry['evals_per_sec']:,.0f} evals/s, "
                        f"CPU_BASELINE.md protocol{note})"}


def _emit(name: str, backend: str, metric: str, value: float, unit: str,
          med_s: float | None = None, mad_s: float | None = None,
          samples: int | None = None, extra_fields: dict | None = None):
    """Log the human line and print the JSON line.  The line carries the
    run's ``"device"``; a CPU run's carries no ``vs_baseline`` (its
    numerator is the plain versions, not a device figure)."""
    extra = dict(extra_fields or {})
    if _CARD["label"] == "cpu":
        extra.pop("vs_baseline", None)
        extra.pop("baseline", None)
    if med_s is not None:
        extra = {"median_s": round(med_s, 6), "mad_s": round(mad_s or 0, 6),
                 "samples": samples, **extra}
        log(f"{name}[{backend}]: {value:,.1f} {unit} "
            f"(median {med_s * 1e3:.3f} ms +- MAD {(mad_s or 0) * 1e3:.3f} ms, "
            f"{samples} samples) [{_CARD['label']}]")
    else:
        log(f"{name}[{backend}]: {value:,.1f} {unit} [{_CARD['label']}]")
    print(
        json.dumps(
            {"bench": name, "backend": backend, "metric": metric,
             "value": round(value, 1), "unit": unit, **extra,
             "device": _CARD["label"]}
        ),
        flush=True,
    )


def _full_device_parity(args, be, lam, ck, native, bundle, alphas, betas,
                        xs, dev) -> None:
    """Full on-device two-party parity for staged backends: every staged
    point's reconstruction is checked against the comparison function on
    the device (``points_mismatch_count``, every key); the C++ anchor the
    caller already ran remains the cross-implementation gate.  No-op for
    backends without the staged counter."""
    if be is None or not hasattr(be, "points_mismatch_count") \
            or not hasattr(be, "stage"):
        return
    _run1, be1 = _make_evaluator(args.backend, lam, ck, native, args, dev)
    st = be.stage(xs)
    y0 = be.eval_staged(0, st)
    be1.put_bundle(bundle.for_party(1))
    y1 = be1.eval_staged(1, st)
    single = alphas.shape[0] == 1
    mism = int(be.points_mismatch_count(
        y0, y1, alphas[0].tobytes() if single else alphas,
        betas[0].tobytes() if single else betas, st))
    if mism:
        raise SystemExit(
            f"full on-device parity: {mism} mismatching points")
    log(f"parity: full (device, {alphas.shape[0]} keys x all "
        f"{xs.shape[0]} pts, two-party): 0 mismatches")


def bench_dcf(args) -> None:
    """Single gen + single-point eval latency (benches/dcf.rs analog)."""
    from dcf_tpu_torch.native import NativeDcf

    if args.backend in SHARDED:
        raise SystemExit(
            "dcf is a single-point latency bench; sharding one point over "
            "a mesh is meaningless — use any single-device backend")
    dev = _dev(args)
    lam, nb = 16, 16
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
    betas = rng.integers(0, 256, (1, lam), dtype=np.uint8)
    s0s = random_s0s(1, lam, rng)

    gen_s, gen_mad, gs = _timed(
        lambda: native.gen_batch(alphas, betas, s0s, Bound.LT_BETA), args.reps
    )
    _emit("dcf_gen", "cpu", "gen_latency_us", gen_s * 1e6, "us",
          gen_s, gen_mad, len(gs))

    bundle = native.gen_batch(alphas, betas, s0s, Bound.LT_BETA)
    run, _ = _make_evaluator(args.backend, lam, ck, native, args, dev)
    xs = rng.integers(0, 256, (1, nb), dtype=np.uint8)
    k0 = bundle.for_party(0)
    run(0, k0, xs)  # warmup (ships the key image)
    ev_s, ev_mad, es = _timed(lambda: run(0, k0, xs), args.reps,
                              args.profile, dev)
    _emit("dcf_eval_1pt", args.backend, "eval_latency_us", ev_s * 1e6, "us",
          ev_s, ev_mad, len(es))


def bench_batch(args) -> None:
    """Batch eval throughput (benches/dcf_batch_eval.rs analog).

    --domain-bytes picks the input width: 16 (the reference bench's
    N=16-byte domain, 128 levels — the default and the flagship number)
    or 4 (BASELINE.json config 2's literal "n=32" wording).  The staged
    backends are timed as ``bench_torch.py`` times them: the median of
    CUDA-event samples of ``eval_staged``, the prefix frontier built
    before the clock.
    """
    from dcf_tpu_torch.native import NativeDcf

    dev = _dev(args)
    lam = 16
    nb = args.domain_bytes or 16
    m = args.points or 100_000
    k = args.keys or 1  # the reference bench is K=1; K>1 records the
    # walk's key-axis scaling (shared point batch)
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    alphas = rng.integers(0, 256, (k, nb), dtype=np.uint8)
    betas = rng.integers(0, 256, (k, lam), dtype=np.uint8)
    bundle = native.gen_batch(
        alphas, betas, random_s0s(k, lam, rng), Bound.LT_BETA)
    xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
    run, be = _make_evaluator(args.backend, lam, ck, native, args, dev)
    k0 = bundle.for_party(0)
    if args.check:
        m_chk = min(m, 2048)
        y = run(0, k0, xs[:m_chk])
        want = native.eval(0, bundle, xs[:m_chk])
        if not np.array_equal(y, want):  # every key's shares, not key 0
            raise SystemExit("parity mismatch vs C++")
        log(f"parity vs C++ core: OK ({k} keys x first {m_chk} pts)")
        _full_device_parity(args, be, lam, ck, native, bundle,
                            alphas, betas, xs, dev)
    if be is not None and hasattr(be, "stage"):
        be.put_bundle(k0)
        dt, mad, ss, unit = _timed_staged(be, xs, args.reps, args.profile,
                                          dev)
    else:
        run(0, k0, xs)  # warmup
        dt, mad, ss = _timed(lambda: run(0, k0, xs), args.reps,
                             args.profile, dev)
        unit = "evals/s"
    name = args.backend if k == 1 else f"{args.backend} (K={k})"
    if args.mesh:
        name += f" --mesh={args.mesh}"  # a sharded run must say so
    _emit("dcf_batch_eval", name, "evals_per_sec",
          k * m / dt, unit, dt, mad, len(ss),
          extra_fields=_pinned_ratio(nb, k, k * m / dt))


def bench_large_lambda(args) -> None:
    """Large-range eval, lam=16384 (benches/dcf_large_lambda.rs analog).

    --backend=hybrid: the narrow walk + GF(2)-affine split (B4 + W1; with
    --prefix-levels k, B5a's frontier + B5b + W1).  --lam picks the range
    size: 16384 (the reference bench's shape) or e.g. 256 (BASELINE.json
    config 4).  --keys runs K keys over the shared point batch.
    """
    from dcf_tpu_torch.native import NativeDcf

    lam, nb = args.lam or 16384, 16
    if lam < 48 or lam % 16:
        raise SystemExit(
            f"--lam must be a multiple of 16 >= 48 for the large-lambda "
            f"bench, got {lam}")
    m = args.points or 10_000
    k = args.keys or 1
    if args.backend in ("prefix", "keylanes", "walk", *SHARDED):
        raise SystemExit(f"{args.backend} backend is lam=16 only; "
                         "use hybrid/cpu")
    dev = _dev(args)
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    log(f"gen (lam={lam}, {2 * (lam // 16)} ciphers, {k} keys) ...")
    alphas = rng.integers(0, 256, (k, nb), dtype=np.uint8)
    betas = rng.integers(0, 256, (k, lam), dtype=np.uint8)
    bundle = native.gen_batch(
        alphas, betas, random_s0s(k, lam, rng), Bound.LT_BETA)
    xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
    run, be = _make_evaluator(args.backend, lam, ck, native, args, dev)
    k0 = bundle.for_party(0)
    if args.check:
        # The C++ byte anchor on a small slice (a full batch at
        # lam=16384 is 160 MB a key); the full batch is then verified on
        # the device, both parties.
        y = run(0, k0, xs[:64])
        want = native.eval(0, bundle, xs[:64])
        if not np.array_equal(y[:, :64], want):
            raise SystemExit("parity mismatch vs C++")
        log(f"parity vs C++ core: OK ({k} keys x first 64 pts)")
        _full_device_parity(args, be, lam, ck, native, bundle,
                            alphas, betas, xs, dev)
    if be is not None and hasattr(be, "stage"):
        be.put_bundle(k0)
        dt, mad, ss, unit = _timed_staged(be, xs, args.reps, args.profile,
                                          dev)
    else:
        run(0, k0, xs)  # warmup
        dt, mad, ss = _timed(lambda: run(0, k0, xs), args.reps,
                             args.profile, dev)
        unit = "evals/s"
    name = args.backend if k == 1 else f"{args.backend} (K={k})"
    _emit("dcf_large_lambda", name, "evals_per_sec",
          k * m / dt, unit, dt, mad, len(ss),
          extra_fields=_pinned_ratio(nb, k, k * m / dt, lam=lam))


def bench_secure_relu(args) -> None:
    """Many-keys x few-points workload (BASELINE.json config 5, scaled).

    Default path: C++ host keygen + kernel B1 for each party
    (``WalkBackend``) through ``workloads.secure_relu_eval``, the
    reconstruction streamed to the host over key chunks.  With ``--device-gen``: the whole
    pipeline on the device — keygen G1, B8 for both parties and the
    two-party count (``workloads.secure_relu_check_device``, the config-5
    pipeline).  ``--backend=keylanes``: host keygen, ``Dcf(backend=
    "keylanes")``, both parties staged with the count on the device.
    """
    lam, nb = 16, 16
    k = args.keys or 65_536
    m = args.points or 1_024
    if args.device_gen and args.backend != "cpu":
        raise SystemExit(
            "--device-gen is its own pipeline (device keygen + keylanes "
            "kernel); it does not combine with --backend")
    dev = _dev(args)
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    alphas = rng.integers(0, 256, (k, nb), dtype=np.uint8)
    betas = rng.integers(0, 256, (k, lam), dtype=np.uint8)
    s0s = random_s0s(k, lam, rng)
    xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)

    if args.device_gen:
        from dcf_tpu_torch.workloads import secure_relu_check_device

        def run():
            mism = secure_relu_check_device(lam, ck, alphas, betas, s0s, xs,
                                            device=dev)
            if mism:
                raise SystemExit(
                    f"secure_relu: {mism} reconstruction mismatches")

        run()  # warmup + correctness
        log(f"on-device verification: 0 mismatches of {k * m}")
        dt, mad, ss = _timed(run, args.reps, args.profile, dev)
        _emit("secure_relu", "device-gen+keylanes", "evals_per_sec",
              2 * k * m / dt, "evals/s (incl device keygen + verify)",
              dt, mad, len(ss))
        return

    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.workloads import secure_relu_eval

    native = NativeDcf(lam, ck)
    log(f"gen {k} keys ...")
    bundle = native.gen_batch(alphas, betas, s0s, Bound.LT_BETA)
    if args.backend == "keylanes":
        # Through the facade: Dcf(backend="keylanes") is the one-card
        # config-5 entry point; its smoke eval is the reachability check,
        # then the same backend instance is timed staged (the shared
        # two-party image ships once).
        from dcf_tpu_torch import Dcf

        dcf = Dcf(nb, lam, ck, backend="keylanes", device=dev)
        y_smoke = dcf.eval(0, bundle, xs[:2])
        assert y_smoke.shape == (k, 2, lam)
        be = dcf.eval_backend()
        log("constructed via the Dcf facade (backend='keylanes')")
        staged = be.stage(xs)
        y0 = be.eval_staged(0, staged)
        y1 = be.eval_staged(1, staged)
        mism = int(be.relu_mismatch_count(y0, y1, alphas, betas, staged))
        if mism:
            raise SystemExit(f"secure_relu: {mism} reconstruction mismatches")
        log(f"on-device verification: 0 mismatches of {k * m}")

        def run():
            be.eval_staged(0, staged)
            be.eval_staged(1, staged)

        dt, mad, ss = _timed(run, args.reps, args.profile, dev)
        _emit("secure_relu", "keylanes", "evals_per_sec",
              2 * k * m / dt, "evals/s (staged, results device-resident)",
              dt, mad, len(ss))
        return

    if args.backend == "sharded-pallas":
        # B8 sharded over the mesh (the path a pod runs for config 5):
        # the two-party image ships once, both parties walk it per rep,
        # the shares stay on the cards.
        from dcf_tpu_torch.parallel import ShardedKeyLanesBackend

        be = ShardedKeyLanesBackend(lam, ck, _mesh(args, dev))
        be.put_bundle(bundle)
        staged = be.stage(xs)
        y0 = be.eval_staged(0, staged)
        y1 = be.eval_staged(1, staged)
        mism = int(be.relu_mismatch_count(y0, y1, alphas, betas, staged))
        if mism:
            raise SystemExit(f"secure_relu: {mism} reconstruction mismatches")
        log(f"on-device verification: 0 mismatches of {k * m}")

        def run():
            be.eval_staged(0, staged)
            be.eval_staged(1, staged)

        dt, mad, ss = _timed(run, args.reps, args.profile, dev)
        _emit("secure_relu", "sharded-keylanes-pallas", "evals_per_sec",
              2 * k * m / dt, "evals/s (staged, results device-resident)",
              dt, mad, len(ss))
        return

    if args.backend == "sharded":
        # The walk over a keys mesh: the one multi-key CLI workload, where
        # mesh factorizations (8x1 / 4x2 / 2x4) are compared via --mesh.
        from dcf_tpu_torch.parallel import ShardedWalkBackend

        mesh = _mesh(args, dev)
        be0 = ShardedWalkBackend(lam, ck, mesh)
        be1 = ShardedWalkBackend(lam, ck, mesh)
        name = "sharded"
    else:
        from dcf_tpu_torch.backends.walk_backend import WalkBackend

        be0 = WalkBackend(lam, ck, device=dev)
        be1 = WalkBackend(lam, ck, device=dev)
        name = "walk"
    secure_relu_eval(be0, be1, bundle, xs)  # warmup
    dt, mad, ss = _timed(
        lambda: secure_relu_eval(be0, be1, bundle, xs), args.reps,
        args.profile, dev)
    # Two parties evaluated -> 2*K*M DCF evals.
    _emit("secure_relu", name, "evals_per_sec",
          2 * k * m / dt, "evals/s", dt, mad, len(ss))


def bench_full_domain(args) -> None:
    """Full-domain two-party reconstruction (BASELINE.json config 3).

    ``tree``: ``TreeFullDomain.check_device`` — B2 over the levels, B2f on
    the last ones, the count on the device; each sample is one check,
    timed with CUDA events, the counts summed on the device and fetched
    once.  ``walk``: points made on the device from an iota and walked
    from the root (B1), the count on the device.  Other backends use the
    host chunk loop.  The metric counts both parties' evals.
    """
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.workloads import (
        full_domain_check,
        full_domain_check_device,
    )

    lam = 16
    n_bits = args.n_bits or 24
    if n_bits % 8 != 0 or n_bits < 8:
        raise SystemExit(f"--n-bits must be a positive multiple of 8, "
                         f"got {n_bits} (domains are byte-granular, "
                         "SURVEY.md section 0)")
    if args.backend in ("keylanes", "hybrid"):
        raise SystemExit(f"full_domain runs tree, walk, prefix or a host "
                         f"backend, got {args.backend!r}")
    dev = _dev(args)
    nb = n_bits // 8
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    alpha = int(rng.integers(0, 1 << n_bits))
    beta = rng.bytes(lam)
    bundle = native.gen_batch(
        np.frombuffer(alpha.to_bytes(nb, "big"), dtype=np.uint8)[None],
        np.frombuffer(beta, dtype=np.uint8)[None],
        random_s0s(1, lam, rng),
        Bound.LT_BETA,
    )
    chunk = min(1 << 20, 1 << n_bits)
    if args.backend == "tree":
        # With --mesh the frontier splits over the mesh and each position
        # expands and checks its disjoint subtree.
        if args.mesh:
            from dcf_tpu_torch.parallel import ShardedTreeFullDomain

            fd = ShardedTreeFullDomain(lam, ck, _mesh(args, dev))
        else:
            from dcf_tpu_torch.backends.fulldomain import TreeFullDomain

            fd = TreeFullDomain(lam, ck, device=dev)
        if fd.check(bundle, alpha, beta, n_bits):  # warmup + correctness
            raise SystemExit("full_domain: reconstruction mismatches")
        log(f"full domain 2^{n_bits}: 0 mismatches")
        counts = []
        ss = device_samples(
            lambda: counts.append(fd.check_device(bundle, alpha, beta,
                                                  n_bits)),
            args.reps, dev, args.profile)
        if int(sum(counts)):
            raise SystemExit("full_domain: reconstruction mismatches")
        dt, mad = _median_mad(ss)
        unit = ("evals/s (median of CUDA-event samples of one two-party "
                "check)" if dev.type == "cuda" else "evals/s")
        _emit("full_domain", args.backend, "evals_per_sec",
              2 * (1 << n_bits) / dt, unit, dt, mad, len(ss))
        return
    if args.backend == "walk":
        from dcf_tpu_torch.backends.walk_backend import WalkBackend

        be0, be1 = (WalkBackend(lam, ck, device=dev),
                    WalkBackend(lam, ck, device=dev))
        be0.put_bundle(bundle.for_party(0))
        be1.put_bundle(bundle.for_party(1))

        def run():
            mism = full_domain_check_device(
                be0, be1, alpha, beta, n_bits, chunk=chunk)
            if mism:
                raise SystemExit(f"full_domain: {mism} mismatches")
    else:
        run0, _ = _make_evaluator(args.backend, lam, ck, native, args, dev)
        k0 = bundle.for_party(0)
        k1 = bundle.for_party(1)

        def run():
            mism = full_domain_check(
                lambda xs: run0(0, k0, xs), lambda xs: run0(1, k1, xs),
                alpha, beta, n_bits, chunk=chunk)
            if mism:
                raise SystemExit(f"full_domain: {mism} mismatches")

    run()  # warmup + correctness
    log(f"full domain 2^{n_bits}: 0 mismatches")
    dt, mad, ss = _timed(run, args.reps, args.profile, dev)
    _emit("full_domain", args.backend, "evals_per_sec",
          2 * (1 << n_bits) / dt, "evals/s", dt, mad, len(ss))


def _gen_serve_bundles(svc, native, rng, n_bundles, nb, lam,
                       durable: bool = False) -> dict:
    """``n_bundles`` fresh single-key two-party bundles, registered
    under ``key-<i>`` (the serve_bench/chaos_bench workload shape).
    ``durable=True`` writes each through the service's key store
    (chaos_bench --crash-restart)."""
    bundles = {}
    for i in range(n_bundles):
        alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
        betas = rng.integers(0, 256, (1, lam), dtype=np.uint8)
        b = native.gen_batch(alphas, betas, random_s0s(1, lam, rng),
                             Bound.LT_BETA)
        bundles[f"key-{i}"] = b
        svc.register_key(f"key-{i}", b, durable=durable)
    return bundles


def _serve_parity_gate(svc, native, bundles, rng, nb, *, points: int,
                       bench: str, tag: str = "",
                       priority: str = "normal",
                       timeout: float | None = None) -> None:
    """Every bundle, both parties, through the SERVICE, XOR
    reconstruction vs the C++ anchor (shared by serve_bench and
    chaos_bench)."""
    xs = rng.integers(0, 256, (points, nb), dtype=np.uint8)
    for name, bundle in bundles.items():
        f0 = svc.submit(name, xs, b=0, priority=priority)
        f1 = svc.submit(name, xs, b=1, priority=priority)
        svc.pump()
        want = native.eval(0, bundle, xs) ^ native.eval(1, bundle, xs)
        if not np.array_equal(f0.result(timeout) ^ f1.result(timeout),
                              want):
            where = f" ({tag})" if tag else ""
            raise SystemExit(
                f"{bench} parity mismatch vs C++ on {name}{where}")
    where = f" ({tag})" if tag else ""
    log(f"parity vs C++ core{where}: OK ({len(bundles)} bundles x "
        f"{points} pts, two-party)")


def _serve_backend(args, bench: str, cpu_means: str | None = None) -> str:
    """The lam = 16 facade backend a serving bench drives.  ``cpu``, the
    global argparse default, becomes ``cpu_means`` where the bench names
    one (as ``dcf_tpu``'s benches do), and is refused elsewhere."""
    backend = (cpu_means if args.backend == "cpu" and cpu_means
               else args.backend)
    if backend not in SERVE_BACKENDS:
        raise SystemExit(
            f"{bench} serves lam=16 single-device facade backends "
            f"({'/'.join(SERVE_BACKENDS)}), got {args.backend!r}")
    return backend


def _warm_ladder(svc, key_id, xs_warm, lo: int, hi: int,
                 parties=(0,)) -> None:
    """Serve one request of every padded batch size from ``lo`` up to
    ``hi`` (powers of two) before any clock runs."""
    m = lo
    while m <= hi:
        log(f"warming batch shape {m} ...")
        for b in parties:
            svc.submit(key_id, xs_warm[:m], b=b)
        svc.pump()
        m *= 2


def bench_serve(args) -> None:
    """Closed-loop load test of the online serving layer.

    Shape: the flagship N=16/lam=16 domain, ``--bundles`` registered
    single-key bundles, ``--concurrency`` closed-loop clients submitting
    ragged requests sized uniformly in [3/8, 1/2] of ``--max-batch`` by
    default for ``--duration`` seconds.  The line also records the
    staged-path equivalent: the same backend evaluating one staged
    ``--max-batch`` batch (CUDA-event samples of ``eval_staged``); the
    serving layer's overhead budget is ``serve_vs_staged``.  Parity is
    gated before timing against the C++ host core.

    ``--skew s`` switches the key choice to Zipf(s) and runs the cached
    vs cold frontier-cache legs interleaved at the same shape, seeds and
    device-byte budget (80% of the party-0 working set); with a
    frontier-capable backend the run fails unless the hit rate is >= 0.5
    and the cached leg beats the cold one.  ``--edge`` adds the same
    closed loop over the DCFE wire path.
    """
    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.ops.tree_expand import tree_expand_levels
    from dcf_tpu_torch.serve.batcher import next_pow2
    from dcf_tpu_torch.serve.loadgen import closed_loop

    lam, nb = 16, 16
    skew = _parse_skew(args.skew)  # bad flags fail fast
    # The skew curve is about the serve frontier cache: the argparse
    # default goes to the frontier-capable lam=16 backend.
    backend = _serve_backend(args, "serve_bench",
                             cpu_means="prefix" if skew > 0 else None)
    if args.edge and skew > 0:
        raise SystemExit(
            "serve_bench --edge is the wire-path comparison leg; the "
            "--skew frontier experiment already runs two legs — run "
            "them separately")
    max_batch = args.max_batch or ((1 << 10) if skew > 0 else (1 << 17))
    n_bundles = args.bundles or (8 if skew > 0 else 3)
    min_req = args.min_req_points or (max_batch * 3 // 8)
    max_req = args.max_req_points or (max_batch // 2)
    if not 1 <= min_req <= max_req:
        raise SystemExit(f"bad request-size range [{min_req}, {max_req}]")
    dev = _dev(args)
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    opts = None
    if backend == "prefix" and args.prefix_levels:
        opts = {"prefix_levels": args.prefix_levels}
    elif backend == "prefix" and skew > 0 and dev.type == "cpu":
        # The plain frontier build at the default depth 21 takes minutes
        # a (key, party) on the CPU; k = 10 keeps the experiment's churn.
        opts = {"prefix_levels": 10}
        log("no card: clamping the prefix frontier to prefix_levels=10 "
            "for the plain versions (override with --prefix-levels)")
    dcf = Dcf(nb, lam, ck, backend=backend, backend_opts=opts, device=dev)
    svc = dcf.serve(max_batch=max_batch,
                    max_delay_ms=args.max_delay_ms,
                    device_bytes_budget=args.device_bytes_budget)
    log(f"gen {n_bundles} bundles ...")
    bundles = _gen_serve_bundles(svc, native, rng, n_bundles, nb, lam)
    parity_pts = 128 if skew > 0 else 512
    _serve_parity_gate(svc, native, bundles, rng, nb, points=parity_pts,
                       bench="serve_bench")

    # Skew mode: a churn budget (80% of the party-0 working set), or the
    # LRU never evicts and the cached and cold legs coincide.
    budget = args.device_bytes_budget
    if skew > 0 and not budget:
        from dcf_tpu_torch.serve.registry import device_image_bytes

        per_img = device_image_bytes(svc.registry.resident("key-0", 0))
        fc = svc.frontier_cache
        n_fc = len(fc.lru_entries()) if fc is not None else 0
        per_frontier = fc.total_bytes() // n_fc if n_fc else 0
        budget = max(1, (per_img + per_frontier) * n_bundles * 4 // 5)
        log(f"skew mode: device_bytes_budget defaulted to {budget:,} B "
            f"(80% of the party-0 working set of {n_bundles} keys)")
    if skew > 0:
        svc.registry.device_bytes_budget = budget

    xs_warm = rng.integers(0, 256, (max_batch, nb), dtype=np.uint8)
    _warm_ladder(svc, "key-0", xs_warm, next_pow2(min_req), max_batch)
    platform, interp = _platform(dev)
    res_cold = cold_snap = wire_res = None
    if skew > 0:
        # The cold-frontier comparison leg: same backend, bundles,
        # budget, shape and seeds, frontier_cache=False; interleaved in 3
        # alternating segments a leg so host drift hits both legs alike.
        log("cold-frontier comparison service (frontier_cache=False) ...")
        svc_cold = dcf.serve(max_batch=max_batch,
                             max_delay_ms=args.max_delay_ms,
                             frontier_cache=False)
        for name, bundle in bundles.items():
            svc_cold.register_key(name, bundle)
        _serve_parity_gate(svc_cold, native, bundles, rng, nb,
                           points=parity_pts, bench="serve_bench",
                           tag="cold leg")
        svc_cold.registry.device_bytes_budget = budget
        _warm_ladder(svc_cold, "key-0", xs_warm, next_pow2(min_req),
                     max_batch)
        segs = 3
        seg_s = float(args.duration) / segs
        runs = {"cached": [], "cold": []}
        # Each leg's frontier builds, as kernel B2's launches while it
        # runs (the legs run one at a time; 0 without a card).
        b2 = {"cached": 0, "cold": 0}
        with svc, svc_cold:
            for i in range(2 * segs):
                leg, tgt = (("cached", svc) if i % 2 == 0
                            else ("cold", svc_cold))
                n0 = tree_expand_levels.launches
                # i // 2: both halves of a segment pair draw the SAME
                # seeded key/size streams.
                runs[leg].append(closed_loop(
                    tgt, sorted(bundles), duration_s=seg_s,
                    concurrency=args.concurrency,
                    min_points=min_req, max_points=max_req,
                    seed=args.seed + i // 2, skew=skew))
                b2[leg] += tree_expand_levels.launches - n0
        res = _merge_loadgen(runs["cached"])
        res_cold = _merge_loadgen(runs["cold"])
        snap = svc.metrics_snapshot()
        cold_snap = svc_cold.metrics_snapshot()
    else:
        with svc:
            res = closed_loop(
                svc, sorted(bundles), duration_s=float(args.duration),
                concurrency=args.concurrency,
                min_points=min_req, max_points=max_req,
                seed=args.seed, skew=skew)
            if args.edge:
                # The --edge leg: the same closed-loop shape over the
                # DCFE wire path, one TCP connection per client.
                from dcf_tpu_torch.serve.edge import EdgeServer

                with EdgeServer(svc) as edge_srv:
                    clients = _edge_clients(*edge_srv.address,
                                            args.concurrency, nb, "")
                    try:
                        wire_res = closed_loop(
                            svc, sorted(bundles),
                            duration_s=float(args.duration),
                            concurrency=args.concurrency,
                            min_points=min_req, max_points=max_req,
                            seed=args.seed, skew=skew,
                            clients=clients)
                    finally:
                        for c in clients:
                            c.close()
                log(f"edge leg: {wire_res.throughput:,.1f} evals/s "
                    f"over the wire vs {res.throughput:,.1f} "
                    "in-process")
        snap = svc.metrics_snapshot()

    # Staged-path equivalent: same backend, one staged max_batch batch.
    staged_rate = None
    be = dcf.new_eval_backend()
    if be is not None and hasattr(be, "stage"):
        be.put_bundle(bundles["key-0"].for_party(0))
        staged = be.stage(xs_warm)
        for _ in range(2):
            be.eval_staged(0, staged)
        ss = device_samples(lambda: be.eval_staged(0, staged), args.reps,
                             dev)
        dt, mad = _median_mad(ss)
        staged_rate = max_batch / dt
        log(f"staged-path rate at {max_batch} pts: {staged_rate:,.1f} "
            f"evals/s (median {dt * 1e3:.3f} ms +- {mad * 1e3:.3f} ms, "
            f"{len(ss)} samples)")

    extra = {
        "duration_s": round(res.duration_s, 3),
        "concurrency": args.concurrency,
        "max_batch": max_batch,
        "req_points": [min_req, max_req],
        "bundles": n_bundles,
        "requests_ok": res.requests_ok,
        "requests_shed": res.requests_shed,
        "requests_failed": res.requests_failed,
        **res.latency_quantiles(),
        "platform": platform,
        "interpreted": interp,
        "metrics_snapshot": snap,
    }
    if staged_rate is not None:
        extra["staged_path_evals_per_sec"] = round(staged_rate, 1)
        extra["serve_vs_staged"] = round(res.throughput / staged_rate, 3)
    if wire_res is not None:
        extra["wire_evals_per_sec"] = round(wire_res.throughput, 1)
        extra["wire_requests_ok"] = wire_res.requests_ok
        extra["wire_vs_inprocess"] = round(
            wire_res.throughput / max(res.throughput, 1e-9), 3)
    hit_rate = None
    if skew > 0:
        fr_hits = snap.get("serve_frontier_hits_total", 0)
        fr_misses = snap.get("serve_frontier_misses_total", 0)
        hit_rate = fr_hits / max(fr_hits + fr_misses, 1)
        log(f"frontier cache: {fr_hits} hits / {fr_misses} misses "
            f"(hit rate {hit_rate:.3f}); cached {res.throughput:,.1f} "
            f"vs cold {res_cold.throughput:,.1f} evals/s; B2 launches "
            f"(frontier builds): cached leg {b2['cached']}, cold leg "
            f"{b2['cold']}")
        extra.update({
            "skew": skew,
            "segments_per_leg": segs,
            "prefix_levels": getattr(dcf.eval_backend(0),
                                     "prefix_levels", 0),
            "frontier_hit_rate": round(hit_rate, 4),
            "frontier_hits": fr_hits,
            "frontier_misses": fr_misses,
            "frontier_evictions":
                snap.get("serve_frontier_evictions_total", 0),
            "device_bytes_budget_effective": budget,
            "cached_key_stagings": snap.get("serve_key_stagings_total",
                                            0),
            "cold_frontier_evals_per_sec": round(res_cold.throughput, 1),
            "cold_requests_ok": res_cold.requests_ok,
            "cold_key_stagings": cold_snap.get("serve_key_stagings_total",
                                               0),
            "cached_vs_cold": round(
                res.throughput / max(res_cold.throughput, 1e-9), 3),
            "b2_launches_cached_leg": b2["cached"],
            "b2_launches_cold_leg": b2["cold"],
        })
    extra.update(_serve_pinned_ratio(res.throughput, platform))
    unit = "evals/s (closed-loop served, party 0)"
    if interp:
        unit += PLAIN_NOTE
    _emit("serve_bench", backend, "evals_per_sec",
          res.throughput, unit, extra_fields=extra)

    # The skew-mode assertions, emitted-then-asserted: the line survives
    # a failure and the exit code makes the claim falsifiable.
    if skew > 0 and getattr(dcf.eval_backend(0), "prefix_levels", 0):
        failures = []
        if hit_rate < 0.5:
            failures.append(
                f"frontier hit-rate {hit_rate:.3f} < 0.5 — the cache is "
                "not amortizing under this skew/budget")
        if res.throughput <= res_cold.throughput:
            failures.append(
                f"cached leg ({res.throughput:,.1f} evals/s) did not "
                f"beat the cold-frontier leg ({res_cold.throughput:,.1f})"
                " at the same shape")
        if failures:
            raise SystemExit("serve_bench --skew: "
                             + "; ".join(failures))


def _merge_loadgen(rs):
    """Fold the per-segment ``LoadgenResult``s of one interleaved leg
    into a single total (rates are then points per SUMMED duration).
    Folds INTO ``rs[0]`` — callers hand over the segment list."""
    tot = rs[0]
    for r in rs[1:]:
        tot.duration_s += r.duration_s
        tot.requests_ok += r.requests_ok
        tot.points_ok += r.points_ok
        tot.requests_failed += r.requests_failed
        tot.requests_shed += r.requests_shed
        tot.latencies_s.extend(r.latencies_s)
        for cls, counts in r.by_class.items():
            for outcome, n in counts.items():
                tot.by_class.setdefault(
                    cls, {"ok": 0, "shed": 0, "failed": 0})[outcome] += n
    return tot


def _serve_pinned_ratio(rate: float, platform: str,
                        baseline_path: str | None = None) -> dict:
    """vs_baseline for serve_bench / edge_bench: the pinned single-core
    C++ flagship eval denominator (``benchmarks/cpu_baseline.json`` top
    level) with the serving platform disclosed.  Empty when no pin
    exists (no silent in-run fallback)."""
    pinned = _load_pinned(baseline_path)
    if pinned is None or "evals_per_sec" not in pinned:
        return {}
    return {"vs_baseline": round(rate / pinned["evals_per_sec"], 3),
            "baseline": f"pinned single-core flagship C++ eval "
                        f"({pinned['evals_per_sec']:,.0f} evals/s, "
                        f"CPU_BASELINE.md protocol; serving platform "
                        f"{platform})"}


def _edge_clients(host: str, port: int, n: int, nb: int,
                  tenant: str) -> list:
    """``n`` single-connection reconnecting pools (size=1 keeps the
    closed-loop one-connection-per-client shape)."""
    from dcf_tpu_torch.serve.edge import EdgeClientPool

    return [EdgeClientPool(host, port, n_bytes=nb, tenant=tenant,
                           size=1)
            for _ in range(n)]


def _edge_soak(addr, native, bundles, nb, *, conns: int,
               duration_s: float, tenant: str, seed: int,
               fault_every: int) -> dict:
    """The edge soak: ``conns`` concurrent connections, each a
    closed-loop session client evaluating BOTH parties of a ragged
    request and reconstructing, with an ``edge.read`` fault killing
    whichever connection owns every ``fault_every``-th server recv — dead
    connections reconnect, every delivered reconstruction is checked
    bit-exact against the C++ anchor, and every typed refusal must carry
    a retry-after hint."""
    import threading

    from dcf_tpu_torch.errors import QueueFullError
    from dcf_tpu_torch.serve.edge import EdgeClient
    from dcf_tpu_torch.testing import faults
    from dcf_tpu_torch.utils.benchtime import monotonic

    host, port = addr
    names = sorted(bundles)
    stats = {"sessions_ok": 0, "points_ok": 0, "mismatches": 0,
             "reconnects": 0, "refusals": 0, "refusals_hinted": 0,
             "other_failures": 0}
    lock = threading.Lock()
    stop = threading.Event()

    def client(i: int) -> None:
        rng = np.random.default_rng(seed + 101 * i)
        conn = None
        while not stop.is_set():
            if conn is None:
                try:
                    conn = EdgeClient(host, port, n_bytes=nb,
                                      tenant=tenant)
                except OSError:
                    continue  # server busy accepting; retry
            name = names[int(rng.integers(0, len(names)))]
            m = int(rng.integers(1, 257))
            xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
            try:
                f0 = conn.submit(name, xs, b=0)
                f1 = conn.submit(name, xs, b=1)
                got = f0.result(120) ^ f1.result(120)
            except QueueFullError as e:
                with lock:
                    stats["refusals"] += 1
                    if e.retry_after_s is not None:
                        stats["refusals_hinted"] += 1
                continue
            except Exception:  # fallback-ok: the injected edge.read
                # fault kills this client's connection typed; the soak
                # client reconnects — that recovery loop is under test.
                # Only a dead connection counts as a reconnect.
                if not conn.closed:
                    with lock:
                        stats["other_failures"] += 1
                    continue
                with lock:
                    stats["reconnects"] += 1
                try:
                    conn.close()
                except Exception:  # fallback-ok: best-effort teardown
                    pass
                conn = None
                continue
            want = native.eval(0, bundles[name], xs) ^ \
                native.eval(1, bundles[name], xs)
            with lock:
                if np.array_equal(got, want):
                    stats["sessions_ok"] += 1
                    stats["points_ok"] += m
                else:
                    stats["mismatches"] += 1
        if conn is not None:
            try:
                conn.close()
            except Exception:  # fallback-ok: best-effort teardown
                pass

    threads = [threading.Thread(target=client, args=(i,),
                                name=f"edge-soak-{i}", daemon=True)
               for i in range(conns)]
    fires = {"n": 0}

    def every_nth(*_args):
        fires["n"] += 1
        if fires["n"] % fault_every == 0:
            # dcflint: disable=typed-error this IS the fault-injection
            # handler (testing.faults raises InjectedFault by design)
            raise faults.InjectedFault(
                f"injected edge.read fault (fire #{fires['n']})")

    with faults.inject("edge.read", handler=every_nth):
        t0 = monotonic()
        for t in threads:
            t.start()
        while monotonic() - t0 < duration_s:
            stop.wait(0.05)
        stop.set()
        for t in threads:
            t.join()
    return stats


def bench_edge(args) -> None:
    """The network-edge bench: the zero-copy DCFE wire path vs the
    in-process serving rate, at the same shape (flagship N=16/lam=16).

    Legs: (1) parity gates, in process and over the wire, against the
    C++ anchor; (2) an ingest probe proving ``batcher.ingest_points`` is
    the only batcher feed on both paths; (3) in-process vs wire closed
    loops interleaved in 3 segments a leg (``wire_vs_inprocess`` must be
    >= 0.8); (4) an open-loop Poisson leg at 60% of the wire request
    rate, reconciled against the service metrics; (5) a refusal burst
    through the rate-limited BATCH tenant (every refusal hinted); (6) the
    8+-connection soak under a deterministic ``edge.read`` fault.  Emits
    one line, then applies the exit-code gates."""
    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.errors import QueueFullError
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.serve import TenantSpec
    from dcf_tpu_torch.serve import batcher as batcher_mod
    from dcf_tpu_torch.serve import service as service_mod
    from dcf_tpu_torch.serve.edge import EdgeServer
    from dcf_tpu_torch.serve.loadgen import closed_loop, open_loop

    lam, nb = 16, 16
    # "cpu", the argparse default, serves on the from-root walk.
    backend = _serve_backend(args, "edge_bench", cpu_means="walk")
    conns = args.connections
    if conns < 1:
        raise SystemExit(f"--connections must be >= 1, got {conns}")
    max_batch = args.max_batch or (1 << 14)
    min_req = args.min_req_points or (max_batch * 3 // 8)
    max_req = args.max_req_points or (max_batch // 2)
    if not 1 <= min_req <= max_req:
        raise SystemExit(f"bad request-size range [{min_req}, {max_req}]")
    dev = _dev(args)
    n_bundles = args.bundles or 3
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    dcf = Dcf(nb, lam, ck, backend=backend, device=dev)
    # Throughput and soak traffic ride "silver" (NORMAL, unlimited); the
    # refusal leg bursts through "bronze" (BATCH, rate-limited).
    bronze_rate = float(max_batch)
    svc = dcf.serve(
        max_batch=max_batch, max_delay_ms=args.max_delay_ms,
        tenants=(TenantSpec("gold", "critical"),
                 TenantSpec("silver", "normal"),
                 TenantSpec("bronze", "batch",
                            points_per_sec=bronze_rate,
                            burst_points=max_batch // 2)))
    log(f"gen {n_bundles} bundles ...")
    bundles = _gen_serve_bundles(svc, native, rng, n_bundles, nb, lam)
    _serve_parity_gate(svc, native, bundles, rng, nb, points=256,
                       bench="edge_bench", tag="in-process")

    # Every padded batch size the ragged legs and the soak (m in
    # [1, 256]) can produce, both parties.
    xs_warm = rng.integers(0, 256, (max_batch, nb), dtype=np.uint8)
    _warm_ladder(svc, "key-0", xs_warm, 1, max_batch, parties=(0, 1))
    platform, interp = _platform(dev)

    svc.start()
    edge = EdgeServer(svc).start()
    addr = edge.address
    log(f"edge listening on {addr[0]}:{addr[1]}")

    wire_gate = _edge_clients(*addr, 1, nb, "silver")[0]
    xs_gate = rng.integers(0, 256, (256, nb), dtype=np.uint8)
    for name, bundle in bundles.items():
        got = wire_gate.evaluate(name, xs_gate, b=0, timeout=300) ^ \
            wire_gate.evaluate(name, xs_gate, b=1, timeout=300)
        want = native.eval(0, bundle, xs_gate) ^ \
            native.eval(1, bundle, xs_gate)
        if not np.array_equal(got, want):
            raise SystemExit(
                f"edge_bench parity mismatch vs C++ on {name} (wire)")
    log(f"parity vs C++ core (wire): OK ({len(bundles)} bundles x "
        "256 pts, two-party)")

    # Ingest probe: one ingest_points call per request on both paths.
    real_ingest = batcher_mod.ingest_points
    probe = {"calls": 0}

    def counting_ingest(data, n_bytes, m=None):
        probe["calls"] += 1
        return real_ingest(data, n_bytes, m)

    service_mod.ingest_points = counting_ingest
    try:
        xs_probe = rng.integers(0, 256, (64, nb), dtype=np.uint8)
        for _ in range(4):
            svc.evaluate("key-0", xs_probe, timeout=120)
        for _ in range(4):
            wire_gate.evaluate("key-0", xs_probe, timeout=120)
    finally:
        service_mod.ingest_points = real_ingest
    ingest_single_feed = probe["calls"] == 8
    log(f"ingest probe: {probe['calls']} ingest_points calls for 8 "
        f"requests (single-feed={ingest_single_feed})")
    wire_gate.close()

    segs = 3
    seg_s = float(args.duration) / (2 * segs)
    clients = _edge_clients(*addr, conns, nb, "silver")
    runs = {"inproc": [], "wire": []}
    for i in range(2 * segs):
        leg = "inproc" if i % 2 == 0 else "wire"
        kw = dict(duration_s=seg_s, concurrency=conns,
                  min_points=min_req, max_points=max_req,
                  seed=args.seed + i // 2)
        if leg == "wire":
            kw["clients"] = clients
        runs[leg].append(closed_loop(svc, sorted(bundles), **kw))
    res_in = _merge_loadgen(runs["inproc"])
    res_wire = _merge_loadgen(runs["wire"])
    wire_vs_inprocess = res_wire.throughput / max(res_in.throughput,
                                                  1e-9)
    log(f"throughput: wire {res_wire.throughput:,.1f} vs in-process "
        f"{res_in.throughput:,.1f} evals/s "
        f"(wire_vs_inprocess={wire_vs_inprocess:.3f})")

    snap_before = svc.metrics_snapshot()
    wire_rps = res_wire.requests_ok / max(res_wire.duration_s, 1e-9)
    open_rate = max(0.6 * wire_rps, 1.0)
    res_open = open_loop(
        clients[0], sorted(bundles), rate_rps=open_rate,
        duration_s=min(float(args.duration) / 3, 10.0),
        min_points=min_req, max_points=max_req, seed=args.seed + 17)
    snap_after = svc.metrics_snapshot()
    open_reconciled = (
        res_open.sent == snap_after["serve_requests_total"]
        - snap_before["serve_requests_total"]
        and res_open.expired == snap_after["serve_deadline_expired_total"]
        - snap_before["serve_deadline_expired_total"])
    log(f"open-loop @ {open_rate:,.1f} req/s: ok={res_open.ok} "
        f"shed={res_open.shed} expired={res_open.expired} "
        f"{res_open.latency_quantiles()} (reconciled={open_reconciled})")
    for c in clients:
        c.close()

    # Refusal leg: the whole burst pipelined on one connection, so the
    # bucket sees it inside one refill window.
    bronze = _edge_clients(*addr, 1, nb, "bronze")[0]
    refusals = refusals_hinted = 0
    xs_burst = rng.integers(0, 256, (max_batch // 2, nb),
                            dtype=np.uint8)
    burst = [bronze.submit("key-0", xs_burst) for _ in range(6)]
    for f in burst:
        try:
            f.result(300)
        except QueueFullError as e:
            refusals += 1
            if e.retry_after_s is not None:
                refusals_hinted += 1
    bronze.close()
    log(f"refusal leg: {refusals} rate-limit refusals, "
        f"{refusals_hinted} carried retry_after_s")

    soak_s = max(float(args.duration) / 4, 3.0)
    soak = _edge_soak(addr, native, bundles, nb,
                      conns=max(conns, 8), duration_s=soak_s,
                      tenant="silver", seed=args.seed,
                      fault_every=25)
    log(f"soak: {soak}")

    snap = svc.metrics_snapshot()
    edge.close()
    svc.close()

    extra = {
        "duration_s": round(res_wire.duration_s, 3),
        "connections": conns,
        "max_batch": max_batch,
        "req_points": [min_req, max_req],
        "bundles": n_bundles,
        "segments_per_leg": segs,
        "wire_requests_ok": res_wire.requests_ok,
        "inprocess_evals_per_sec": round(res_in.throughput, 1),
        "wire_vs_inprocess": round(wire_vs_inprocess, 3),
        "ingest_single_feed": ingest_single_feed,
        "ingest_probe_calls": probe["calls"],
        **res_wire.latency_quantiles(),
        "open_loop_rate_rps": round(open_rate, 1),
        "open_loop_ok": res_open.ok,
        "open_loop_shed": res_open.shed,
        "open_loop_expired": res_open.expired,
        "open_loop_reconciled": open_reconciled,
        **{f"open_loop_{k}": v
           for k, v in res_open.latency_quantiles().items()},
        "refusals": refusals,
        "refusals_hinted": refusals_hinted,
        "soak_connections": max(conns, 8),
        "soak_sessions_ok": soak["sessions_ok"],
        "soak_mismatches": soak["mismatches"],
        "soak_reconnects": soak["reconnects"],
        "soak_refusals": soak["refusals"],
        "soak_refusals_hinted": soak["refusals_hinted"],
        "soak_other_failures": soak["other_failures"],
        "edge_frames_total": snap.get("edge_frames_total", 0),
        "edge_connection_errors_total":
            snap.get("edge_connection_errors_total", 0),
        "platform": platform,
        "interpreted": interp,
        "repro": (f"python -m dcf_tpu_torch.cli edge_bench "
                  f"--backend {backend} "
                  f"--duration {float(args.duration):g} "
                  f"--max-batch {max_batch} --connections {conns} "
                  f"--seed {args.seed}"),
    }
    extra.update(_serve_pinned_ratio(res_wire.throughput, platform))
    unit = "evals/s (closed-loop served over TCP, party 0)"
    if interp:
        unit += PLAIN_NOTE
    _emit("edge_bench", backend, "evals_per_sec",
          res_wire.throughput, unit, extra_fields=extra)

    failures = []
    if wire_vs_inprocess < 0.8:
        failures.append(
            f"wire path served {wire_vs_inprocess:.3f}x the in-process "
            "rate at the same shape (< 0.8: the zero-copy wire path is "
            "not holding)")
    if not ingest_single_feed:
        failures.append(
            f"ingest probe saw {probe['calls']} ingest_points calls "
            "for 8 requests — the bytes-ingest entry is not the only "
            "batcher feed")
    if soak["mismatches"]:
        failures.append(
            f"{soak['mismatches']} soak reconstructions mismatched the "
            "C++ anchor")
    if soak["sessions_ok"] < 8:
        failures.append(
            f"soak delivered only {soak['sessions_ok']} sessions")
    if soak["reconnects"] < 1:
        failures.append(
            "the injected edge.read fault never killed a connection — "
            "the soak did not exercise the failure path")
    if refusals < 1:
        failures.append("the refusal leg never saw a refusal")
    hinted_ok = (refusals_hinted == refusals and
                 soak["refusals_hinted"] == soak["refusals"])
    if not hinted_ok:
        failures.append(
            "a refusal reached a client WITHOUT a typed retry-after "
            f"hint (leg {refusals_hinted}/{refusals}, soak "
            f"{soak['refusals_hinted']}/{soak['refusals']})")
    if failures:
        raise SystemExit("edge_bench: " + "; ".join(failures))


def _protocols_pinned_ratio(m_int: int, rate: float,
                            baseline_path: str | None = None) -> dict:
    """vs_baseline for mic_bench: the pinned single-core numpy-oracle
    denominator (``benchmarks/cpu_baseline.json`` key
    ``protocols.mic_m{m}``) in served points/s at the same interval
    count.  Empty when no pin exists for this m."""
    pinned = _load_pinned(baseline_path)
    if pinned is None:
        return {}
    entry = pinned.get("protocols", {}).get(f"mic_m{m_int}")
    if not entry:
        return {}
    return {"vs_baseline": round(rate / entry["points_per_sec"], 2),
            "baseline": f"pinned single-core numpy-oracle mic_m{m_int} "
                        f"({entry['points_per_sec']:,.0f} points/s, "
                        "CPU_BASELINE.md protocol)"}


def bench_mic(args) -> None:
    """Closed-loop MIC serving bench: m intervals x M points.

    Registers one m-interval MIC protocol bundle (``Dcf.mic``: 2m
    interval-bound keys K-packed into one bundle) in a ``DcfService`` and
    drives it closed-loop; the service applies the per-interval combine.
    Parity is gated before timing against the numpy protocol oracle
    (``protocols.oracle.mic_oracle``).  The line records served
    points/s, the staged ``MicEvaluator`` equivalent and ``vs_baseline``
    against the pinned single-core numpy-oracle denominator.
    """
    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.protocols import MicEvaluator
    from dcf_tpu_torch.protocols.oracle import mic_oracle
    from dcf_tpu_torch.serve.batcher import next_pow2
    from dcf_tpu_torch.serve.loadgen import closed_loop

    lam, nb = 16, 16
    skew = _parse_skew(args.skew)  # validated and recorded (one key)
    backend = _serve_backend(args, "mic_bench")
    m_int = args.intervals or 8
    max_batch = args.max_batch or (1 << 14)
    min_req = args.min_req_points or (max_batch * 3 // 8)
    max_req = args.max_req_points or (max_batch // 2)
    if not 1 <= min_req <= max_req:
        raise SystemExit(f"bad request-size range [{min_req}, {max_req}]")
    dev = _dev(args)
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    dcf = Dcf(nb, lam, ck, backend=backend, device=dev)

    # m disjoint intervals: 2m sorted distinct bounds paired up.
    bounds = sorted(
        int.from_bytes(rng.integers(0, 256, nb, dtype=np.uint8).tobytes(),
                       "big")
        for _ in range(2 * m_int))
    if len(set(bounds)) != 2 * m_int:
        raise SystemExit(
            "mic_bench drew duplicate interval bounds; rerun with a "
            "different --seed")
    intervals = [(bounds[2 * i], bounds[2 * i + 1]) for i in range(m_int)]
    betas = rng.integers(0, 256, (m_int, lam), dtype=np.uint8)
    log(f"gen MIC bundle: {m_int} intervals -> {2 * m_int} K-packed keys")
    pb = dcf.mic(intervals, betas, rng=rng)

    svc = dcf.serve(max_batch=max_batch, max_delay_ms=args.max_delay_ms,
                    device_bytes_budget=args.device_bytes_budget)
    svc.register_key("mic-0", pb)

    xs_check = rng.integers(0, 256, (256, nb), dtype=np.uint8)
    f0 = svc.submit("mic-0", xs_check, b=0)
    f1 = svc.submit("mic-0", xs_check, b=1)
    svc.pump()
    want = mic_oracle(xs_check, intervals, betas)
    if not np.array_equal(f0.result() ^ f1.result(), want):
        raise SystemExit("mic_bench parity mismatch vs the numpy oracle")
    log(f"parity vs numpy oracle: OK ({m_int} intervals x 256 pts, "
        "two-party, served)")

    xs_warm = rng.integers(0, 256, (max_batch, nb), dtype=np.uint8)
    _warm_ladder(svc, "mic-0", xs_warm, next_pow2(min_req), max_batch)
    platform, interp = _platform(dev)
    with svc:
        res = closed_loop(
            svc, ["mic-0"], duration_s=float(args.duration),
            concurrency=args.concurrency,
            min_points=min_req, max_points=max_req, seed=args.seed,
            skew=skew)
    snap = svc.metrics_snapshot()

    # Staged equivalent: MicEvaluator (stage + eval_staged + the pair
    # combine on the device) on one max_batch batch.
    ev = MicEvaluator(dcf, pb, 0)
    ev.eval(xs_warm)  # warm the exact timed shape
    dt, mad, ss = _timed(lambda: ev.eval(xs_warm), args.reps, dev=dev)
    staged_rate = max_batch / dt
    log(f"staged MicEvaluator rate at {max_batch} pts: "
        f"{staged_rate:,.1f} points/s (median {dt * 1e3:.1f} ms +- "
        f"{mad * 1e3:.1f} ms, {len(ss)} samples)")

    extra = {
        "duration_s": round(res.duration_s, 3),
        "concurrency": args.concurrency,
        "skew": skew,
        "intervals": m_int,
        "max_batch": max_batch,
        "req_points": [min_req, max_req],
        "requests_ok": res.requests_ok,
        "requests_shed": res.requests_shed,
        "requests_failed": res.requests_failed,
        **res.latency_quantiles(),
        "platform": platform,
        "interpreted": interp,
        "staged_mic_points_per_sec": round(staged_rate, 1),
        "serve_vs_staged": round(res.throughput / staged_rate, 3),
        "metrics_snapshot": snap,
        **_protocols_pinned_ratio(m_int, res.throughput),
    }
    unit = (f"points/s (closed-loop served MIC, m={m_int}, party 0; "
            "each point yields all m interval rows)")
    if interp:
        unit += PLAIN_NOTE
    _emit("mic_bench", backend, "points_per_sec",
          res.throughput, unit, extra_fields=extra)


def _gates_pinned_ratio(tag: str, rate: float,
                        baseline_path: str | None = None) -> dict:
    """vs_baseline for gate_bench: the pinned single-core numpy
    gate-oracle denominator (``benchmarks/cpu_baseline.json`` key
    ``gates.<tag>``).  Empty when no pin exists for this tag."""
    pinned = _load_pinned(baseline_path)
    if pinned is None:
        return {}
    entry = pinned.get("gates", {}).get(tag)
    if not entry:
        return {}
    # 6 decimals: the clear-input oracle does no crypto at all, so the
    # served ratio can be tiny.
    return {"vs_baseline": round(rate / entry["points_per_sec"], 6),
            "baseline": f"pinned single-core numpy gate oracle "
                        f"gates.{tag} "
                        f"({entry['points_per_sec']:,.0f} points/s, "
                        "CPU_BASELINE.md protocol)"}


def bench_gates(args) -> None:
    """Served fixed-point gate bench: spline sigmoid + faithful
    truncation + signed comparison through ``GateServer``.

    One gate of each kind on the 16-bit fixed-point domain (f=8, the
    ``add16`` group) with fresh input masks, served by a ``DcfService``
    pair (full domain + the truncation gate's low-byte domain).  Every
    gate reconstructs bit-exactly against its clear-input numpy oracle
    before timing.  The timed legs measure party 0's served share rate
    per gate on one fixed batch; the sigmoid rate is the headline.
    """
    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.protocols import (
        gen_sigmoid_gate, gen_sign_gate, gen_trunc_gate,
        sigmoid_fixed_oracle, sign_oracle, trunc_oracle)
    from dcf_tpu_torch.protocols.fixedpoint import decode_lanes
    from dcf_tpu_torch.workloads import GateServer

    lam, nb, f_bits, group = 16, 2, 8, "add16"
    backend = _serve_backend(args, "gate_bench")
    dev = _dev(args)
    m_pieces = args.intervals or 8
    points = args.points or 4096
    n_total = 1 << (8 * nb)
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    dcf = Dcf(nb, lam, ck, backend=backend, device=dev)
    dcf_low = Dcf(1, lam, ck, backend=backend, device=dev)

    r_sig = int(rng.integers(0, n_total))
    r_tr = int(rng.integers(0, n_total))
    r_sgn = int(rng.integers(0, n_total))
    log(f"gen gates: sigmoid m={m_pieces} f={f_bits}, trunc f={f_bits}, "
        f"sign — {group} group, {8 * nb}-bit domain")
    sig = gen_sigmoid_gate(dcf, r_sig, rng, group, f=f_bits, m=m_pieces)
    tr = gen_trunc_gate(dcf, dcf_low, r_tr, f_bits, rng, group)
    sgn = gen_sign_gate(dcf, r_sgn, rng, group)

    max_batch = args.max_batch or (1 << 14)
    svc = dcf.serve(max_batch=max_batch, max_delay_ms=args.max_delay_ms,
                    device_bytes_budget=args.device_bytes_budget)
    svc_low = dcf_low.serve(max_batch=max_batch,
                            max_delay_ms=args.max_delay_ms)
    gs = GateServer(svc, svc_low)
    gs.register("sigmoid", sig)
    gs.register("trunc", tr)
    gs.register("sign", sgn)

    platform, interp = _platform(dev)
    with svc, svc_low:
        x_check = rng.integers(0, n_total, size=512, dtype=np.int64)
        got = decode_lanes(gs.reconstruct("sigmoid", x_check), group)
        want = sigmoid_fixed_oracle((x_check - r_sig) % n_total,
                                    sig.cuts, sig.values)
        if not np.array_equal(got, want):
            raise SystemExit(
                "gate_bench sigmoid parity mismatch vs the numpy oracle")
        got = decode_lanes(gs.reconstruct("trunc", x_check), group)
        if not np.array_equal(got, trunc_oracle(x_check, r_tr, f_bits,
                                                8 * nb)):
            raise SystemExit(
                "gate_bench trunc parity mismatch vs the numpy oracle")
        got = decode_lanes(gs.reconstruct("sign", x_check), group)
        if not np.array_equal(got, sign_oracle((x_check - r_sgn)
                                               % n_total, 8 * nb)):
            raise SystemExit(
                "gate_bench sign parity mismatch vs the numpy oracle")
        log("parity vs numpy gate oracles: OK (3 gates x 512 pts, "
            "two-party, served)")

        x_bench = rng.integers(0, n_total, size=points, dtype=np.int64)
        rates = {}
        meds = {}
        for gate_id in ("sigmoid", "trunc", "sign"):
            gs.eval_share(gate_id, 0, x_bench)  # warm the timed shape
            dt, mad, ss = _timed(
                lambda g=gate_id: gs.eval_share(g, 0, x_bench),
                args.reps, dev=dev)
            rates[gate_id] = points / dt
            meds[gate_id] = (dt, mad, len(ss))
            log(f"served {gate_id} gate: {rates[gate_id]:,.1f} points/s "
                f"(median {dt * 1e3:.1f} ms +- {mad * 1e3:.1f} ms, "
                f"{len(ss)} samples)")
    snap = svc.metrics_snapshot()

    extra = {
        "points": points,
        "pieces": m_pieces,
        "frac_bits": f_bits,
        "group": group,
        "domain_bits": 8 * nb,
        "max_batch": max_batch,
        "trunc_points_per_sec": round(rates["trunc"], 1),
        "sign_points_per_sec": round(rates["sign"], 1),
        "platform": platform,
        "interpreted": interp,
        "metrics_snapshot": snap,
        "repro": (f"python -m dcf_tpu_torch.cli gate_bench --backend "
                  f"{backend} --points {points} --intervals {m_pieces} "
                  f"--seed {args.seed}"),
        **_gates_pinned_ratio(f"sigmoid_m{m_pieces}", rates["sigmoid"]),
    }
    tr_pin = _gates_pinned_ratio("trunc", rates["trunc"])
    if tr_pin and not interp:
        extra["trunc_vs_baseline"] = tr_pin["vs_baseline"]
    unit = (f"points/s (served spline-sigmoid gate, party 0 share, "
            f"m={m_pieces} pieces, f={f_bits}, {group})")
    if interp:
        unit += PLAIN_NOTE
    dt, mad, n_samples = meds["sigmoid"]
    _emit("gate_bench", backend, "points_per_sec",
          rates["sigmoid"], unit, med_s=dt, mad_s=mad,
          samples=n_samples, extra_fields=extra)


def bench_keygen(args) -> None:
    """K-packed keygen on the card: closed-loop keys/s.

    For each lam in {128, 256} (or the single ``--lam``), generates fresh
    key batches back to back through ``gen.gen_on_device`` (kernel B7a's
    narrow walk + W2's wide tail) at K in {1, 8, 64, 2m}, the last leg
    the MIC packing through ``Dcf.mic(..., device=True)``.  Before timing
    the gate must pass: the device keys equal the host ``gen_batch``'s
    byte for byte, and both parties' numpy evaluations reconstruct the
    comparison function, x = alpha included.  The line records every leg,
    the host ``gen_batch`` rate at the pinned K and ``vs_baseline``
    against the pinned single-core numpy keygen denominator.  The port
    has no keygen fallback, so ``device_fallbacks`` is always 0.
    """
    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
    from dcf_tpu_torch.gen import gen_batch, gen_on_device
    from dcf_tpu_torch.ops.prg import HirosePrgNp

    nb = 16  # flagship domain: n = 128 walked levels per key
    lams = [args.lam] if args.lam else [128, 256]
    for lam in lams:
        if lam < 48 or lam % 16:
            raise SystemExit(
                f"keygen_bench drives the hybrid-family device keygen "
                f"(lam >= 48, a multiple of 16), got --lam={lam}")
    m_int = args.intervals or 8
    dev = _dev(args)
    platform, interp = _platform(dev)
    pinned_k = KEYGEN_PIN_K

    for lam in lams:
        rng = np.random.default_rng(args.seed)
        ck = _cipher_keys(lam, rng)
        prg = HirosePrgNp(lam, ck, warn=False)

        # -- reconstruction gate (before any timing) --------------------
        k_gate = 4
        alphas = rng.integers(0, 256, (k_gate, nb), dtype=np.uint8)
        betas = rng.integers(0, 256, (k_gate, lam), dtype=np.uint8)
        s0s = random_s0s(k_gate, lam, rng)
        dev_bundle = gen_on_device(lam, ck, alphas, betas, s0s,
                                   Bound.LT_BETA, device=dev)
        host_bundle = gen_batch(prg, alphas, betas, s0s, Bound.LT_BETA)
        if dev_bundle.to_bytes() != host_bundle.to_bytes():
            raise SystemExit(
                f"keygen_bench gate: device keys at lam={lam} are not "
                "byte-identical to the host gen_batch")
        xs = rng.integers(0, 256, (8, nb), dtype=np.uint8)
        xs[0] = alphas[0]  # exact boundary
        y0 = eval_batch_np(prg, 0, dev_bundle.for_party(0), xs)
        y1 = eval_batch_np(prg, 1, dev_bundle.for_party(1), xs)
        recon = y0 ^ y1
        for i in range(k_gate):
            a = alphas[i].tobytes()
            for j in range(xs.shape[0]):
                want = (betas[i].tobytes() if xs[j].tobytes() < a
                        else bytes(lam))
                if recon[i, j].tobytes() != want:
                    raise SystemExit(
                        f"keygen_bench gate: two-party reconstruction "
                        f"mismatch at lam={lam}, key {i}, point {j}")
        log(f"gate: device keys byte-identical to gen_batch AND "
            f"two-party reconstruction OK (lam={lam}, {k_gate} keys x "
            f"{xs.shape[0]} pts incl. x=alpha)")

        # -- closed-loop legs: fresh inputs per timed call ---------------
        k_sweep = ([args.keys] if args.keys
                   else [1, 8, pinned_k, 2 * m_int])
        legs = []
        for k_num in k_sweep:
            pool = [(rng.integers(0, 256, (k_num, nb), dtype=np.uint8),
                     rng.integers(0, 256, (k_num, lam), dtype=np.uint8),
                     random_s0s(k_num, lam, rng))
                    for _ in range(max(args.reps, 1) + 1)]
            it = iter(pool)

            def one_gen():
                al, be, ss = next(it)
                gen_on_device(lam, ck, al, be, ss, Bound.LT_BETA,
                              device=dev)

            one_gen()  # warm
            med, mad, samples = _timed(one_gen, args.reps, args.profile,
                                       dev)
            rate = k_num / med
            legs.append({"keys": k_num,
                         "keys_per_sec": round(rate, 1),
                         "median_s": round(med, 6),
                         "mad_s": round(mad, 6),
                         "samples": len(samples)})
            log(f"keygen lam={lam} K={k_num}: {rate:,.1f} keys/s "
                f"(median {med * 1e3:.1f} ms +- {mad * 1e3:.1f} ms)")

        # -- the MIC 2m packing leg through the facade ------------------
        dcf = Dcf(nb, lam, ck, backend="numpy", device=dev)
        bounds = sorted(
            int.from_bytes(
                rng.integers(0, 256, nb, dtype=np.uint8).tobytes(),
                "big")
            for _ in range(2 * m_int))
        intervals = [(bounds[2 * i], bounds[2 * i + 1])
                     for i in range(m_int)]
        mic_betas = rng.integers(0, 256, (m_int, lam), dtype=np.uint8)
        seeds = iter(range(max(args.reps, 1) + 1))

        def one_mic():  # fresh seeds per bundle
            dcf.mic(intervals, mic_betas,
                    rng=np.random.default_rng(next(seeds)), device=True)

        one_mic()  # warm
        med, mad, samples = _timed(one_mic, args.reps, args.profile, dev)
        mic_rate = 2 * m_int / med
        log(f"keygen lam={lam} MIC m={m_int} (K=2m={2 * m_int}): "
            f"{mic_rate:,.1f} keys/s (median {med * 1e3:.1f} ms)")

        # -- host companion at the pinned K ------------------------------
        al = rng.integers(0, 256, (pinned_k, nb), dtype=np.uint8)
        be = rng.integers(0, 256, (pinned_k, lam), dtype=np.uint8)
        ss = random_s0s(pinned_k, lam, rng)
        gen_batch(prg, al, be, ss, Bound.LT_BETA)  # warm
        hmed, _hm, _hs = _timed(
            lambda: gen_batch(prg, al, be, ss, Bound.LT_BETA), args.reps)
        host_rate = pinned_k / hmed

        pin_leg = next((leg for leg in legs
                        if leg["keys"] == pinned_k), None)
        head = pin_leg or legs[-1]  # headline = the pinned K shape
        extra = {
            "lam": lam,
            "n_bytes": nb,
            "device_fallbacks": 0,
            "legs": legs,
            "mic_intervals": m_int,
            "mic_keys_per_sec": round(mic_rate, 1),
            "host_gen_batch_keys_per_sec": round(host_rate, 1),
            "platform": platform,
            "interpreted": interp,
            "repro": (f"python -m dcf_tpu_torch.cli keygen_bench "
                      f"--lam {lam} --seed {args.seed}"),
            **(_pinned_ratio(nb, pinned_k, pin_leg["keys_per_sec"],
                             interpreted=interp, lam=lam, keygen=True)
               if pin_leg else {}),
        }
        unit = (f"keys/s (closed-loop device keygen, K={head['keys']}, "
                f"N={nb}B domain)")
        if interp:
            unit += PLAIN_NOTE
        _emit("keygen_bench", "device", "keys_per_sec",
              head["keys_per_sec"], unit, extra_fields=extra)


def _dpf_pinned_ratio(n_bits: int, rate: float,
                      interpreted: bool = False,
                      baseline_path: str | None = None) -> dict:
    """vs_baseline for pir_bench: the pinned single-core numpy EvalAll
    denominator (``dpf.evalall_n16``), rescaled by 2^16 / 2^n for the
    bench's other domains (EvalAll is linear in leaves); the rescale and
    the pin's one-party scope are disclosed.  Empty when no pin exists;
    kept for interpreted runs with the numerator disclosed."""
    pinned = _load_pinned(baseline_path)
    if pinned is None:
        return {}
    entry = pinned.get("dpf", {}).get("evalall_n16")
    if not entry:
        return {}
    denom = entry["queries_per_sec"] * (1 << 16) / (1 << n_bits)
    note = _PLAIN_NUMERATOR if interpreted else ""
    scale = (f" rescaled x 2^16/2^{n_bits} -> {denom:,.3f}"
             if n_bits != 16 else "")
    return {"vs_baseline": round(rate / denom, 2),
            "baseline": f"pinned single-core numpy EvalAll "
                        f"dpf.evalall_n16 "
                        f"({entry['queries_per_sec']:,.3f} queries/s, "
                        f"one party{scale}, "
                        f"CPU_BASELINE.md protocol{note})"}


def bench_pir(args) -> None:
    """2-server PIR serving bench: closed-loop queries/s.

    For each domain n in {14, 16, 18} (or the single ``--n-bits``): a
    fresh 2^n x 32 B database resident on the device (``PirDatabase``),
    a ``PirServer`` over a ``KeyRegistry``, both parties' answers per
    query batch — each a full-domain DPF EvalAll (kernel B6, t alone) and
    the selection inner product (kernel P1).  Before timing, probed
    records (the first and last among them) must reconstruct bit-exactly
    through the served path.  Timed legs register a fresh query bundle
    per call, off the clock.
    """
    ns = [args.n_bits] if args.n_bits else [14, 16, 18]
    for n in ns:
        if not 5 <= n <= 24:
            raise SystemExit(
                f"pir_bench serves 5 <= n <= 24 bit database domains "
                f"(one lane word to 16M records), got --n-bits={n}")
    if args.keys < 0:
        raise SystemExit(
            f"pir_bench --keys is the queries-per-batch count "
            f"(0 = 4), got {args.keys}")
    from dcf_tpu_torch.backends.evalall import DpfEvalAll
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.serve.registry import KeyRegistry
    from dcf_tpu_torch.workloads.pir import (
        PirDatabase,
        PirServer,
        pir_query_bundle,
        pir_reconstruct,
    )

    dev = _dev(args)
    lam = 32  # DPF_DEVICE_LAM: the two-block narrow kernel width
    record_bytes = 32
    k_num = args.keys or 4
    platform, interp = _platform(dev)
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    prg = HirosePrgNp(lam, ck, warn=False)
    evaluator = DpfEvalAll(lam, ck, device=dev)

    legs = []
    for n in ns:
        records = rng.integers(0, 256, (1 << n, record_bytes),
                               dtype=np.uint8)
        db = PirDatabase(records, n, device=dev)
        registry = KeyRegistry(None)
        server = PirServer(evaluator, db, registry)

        gate_idx = [0, (1 << n) - 1] + [
            int(x) for x in rng.integers(0, 1 << n, 4)]
        registry.register("gate", pir_query_bundle(
            prg, gate_idx, n, random_s0s(len(gate_idx), lam, rng)))
        got = pir_reconstruct(server.answer("gate", 0),
                              server.answer("gate", 1))
        for j, i in enumerate(gate_idx):
            if got[j].tobytes() != records[i].tobytes():
                raise SystemExit(
                    f"pir_bench gate: record {i} of the 2^{n} database "
                    "did not reconstruct bit-exactly through the "
                    "served path")
        log(f"gate: {len(gate_idx)} records (incl. first/last) "
            f"retrieved bit-exactly through the served path (n={n})")

        kids = []
        for q in range(max(args.reps, 1) + 1):
            kid = f"q{n}-{q}"
            registry.register(kid, pir_query_bundle(
                prg, rng.integers(0, 1 << n, k_num), n,
                random_s0s(k_num, lam, rng)))
            kids.append(kid)
        it = iter(kids)

        def one_batch():
            kid = next(it)
            pir_reconstruct(server.answer(kid, 0), server.answer(kid, 1))

        one_batch()  # warm
        med, mad, samples = _timed(one_batch, args.reps, args.profile, dev)
        rate = k_num / med
        legs.append({"n_bits": n,
                     "queries_per_sec": round(rate, 3),
                     "median_s": round(med, 6),
                     "mad_s": round(mad, 6),
                     "samples": len(samples),
                     "eval_faults": server.eval_faults,
                     **({} if interp else _dpf_pinned_ratio(n, rate))})
        log(f"pir n={n} K={k_num}: {rate:,.3f} queries/s "
            f"(median {med * 1e3:.1f} ms +- {mad * 1e3:.1f} ms, "
            "both parties served)")

    head = next((leg for leg in legs if leg["n_bits"] == 16), legs[-1])
    extra = {
        "lam": lam,
        "record_bytes": record_bytes,
        "keys": k_num,
        "queries_per_sec": head["queries_per_sec"],
        "legs": legs,
        "platform": platform,
        "interpreted": interp,
        "repro": (f"python -m dcf_tpu_torch.cli pir_bench "
                  f"--seed {args.seed}"),
        **{k: v for k, v in head.items()
           if k in ("vs_baseline", "baseline")},
    }
    unit = (f"queries/s (closed-loop 2-server PIR, both parties "
            f"served, 2^{head['n_bits']} x {record_bytes}B records)")
    if interp:
        unit += PLAIN_NOTE
    _emit("pir_bench", "device", "queries_per_sec",
          head["queries_per_sec"], unit, extra_fields=extra)


def bench_keyfactory(args) -> None:
    """Key-factory provisioning bench: does ahead-of-demand pooling take
    keygen off the registration clock?

    The flagship N=16-byte domain at ``--lam`` (default 128), a
    single-key-per-session pool refilled in ``--keys``-session device
    batches (default 64), served by a host-path facade (default
    ``numpy``).  Phases: (1) parity gates for a pool-hit key and a
    pool-exhaustion key (the miss counter pinned); (2) sustained
    publish-to-servable keys/s over ``--reps`` full refills of a durable
    pool; (3) registration latency, pool hit vs the synchronous mint (the
    run fails unless the hit is >= 10x faster); (4) session churn for
    ``--duration`` seconds.  ``--host-refill`` refills through the host
    keygen instead (an explicit host measurement).
    """
    import shutil
    import tempfile
    import warnings

    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.serve import PoolSpec
    from dcf_tpu_torch.serve.loadgen import session_churn
    from dcf_tpu_torch.utils.benchtime import monotonic

    nb = 16
    lam = args.lam or 128
    if lam < 16:
        raise SystemExit(
            f"keyfactory_bench wants lam >= 16, got --lam={lam}")
    backend = args.backend
    if backend == "cpu":
        # The bench measures provisioning through the host serve path.
        backend = "numpy"
        log("keyfactory_bench measures provisioning; defaulting "
            "--backend to numpy (the host serve path)")
    if backend not in ("numpy", "walk", "hybrid"):
        raise SystemExit(
            "keyfactory_bench serves through numpy/walk/hybrid, got "
            f"{backend!r}")
    if backend == "hybrid" and (lam < 48 or lam % 16):
        raise SystemExit(
            f"--backend=hybrid wants lam >= 48, a multiple of 16 "
            f"(got {lam})")
    if backend == "walk" and lam not in (16, 32):
        raise SystemExit(
            f"--backend=walk serves lam 16 and 32, got --lam={lam}")
    dev = _dev(args)
    refill_batch = args.keys or 64
    use_device = not args.host_refill
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcf = Dcf(nb, lam, ck, backend=backend, device=dev)
    platform, interp = _platform(dev)
    store_dir = args.store_dir or tempfile.mkdtemp(prefix="dcf-kf-")
    cleanup = not args.store_dir
    try:
        svc = dcf.serve(max_batch=256, store_dir=store_dir)
        alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
        betas = rng.integers(1, 256, (1, lam), dtype=np.uint8)

        def pool(name, **kw):
            base = dict(name=name, alphas=alphas, betas=betas,
                        device=use_device)
            return svc.add_pool(PoolSpec(**{**base, **kw}))

        # -- phase 1: parity gates (before any timing) ------------------
        pool("gate", target_depth=2, low_water=2, refill_batch=2)
        svc.keyfactory.pump()

        def gate(key_id, tag):
            xs = rng.integers(0, 256, (8, nb), dtype=np.uint8)
            xs[0] = alphas[0]  # exact boundary
            f0 = svc.submit(key_id, xs, b=0)
            f1 = svc.submit(key_id, xs, b=1)
            svc.pump()
            recon = f0.result() ^ f1.result()
            a = alphas[0].tobytes()
            for j in range(xs.shape[0]):
                want = (betas[0].tobytes() if xs[j].tobytes() < a
                        else bytes(lam))
                if recon[0, j].tobytes() != want:
                    raise SystemExit(
                        f"keyfactory_bench gate: two-party "
                        f"reconstruction mismatch on the {tag} path "
                        f"(lam={lam}, point {j})")

        snap0 = svc.metrics_snapshot()
        svc.register_key("gate-hit", pool="gate")
        gate("gate-hit", "pool-hit")
        while svc.keyfactory.depth("gate"):
            svc.register_key("gate-drain", pool="gate")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            svc.register_key("gate-miss", pool="gate")  # exhausted
        gate("gate-miss", "sync-fallback")
        snap1 = svc.metrics_snapshot()
        miss_delta = (snap1["keyfactory_pool_misses_total"]
                      - snap0.get("keyfactory_pool_misses_total", 0))
        if miss_delta != 1:
            raise SystemExit(
                "keyfactory_bench gate: the fallback leg recorded "
                f"{miss_delta} pool misses (want exactly 1) — the "
                "parity claim must name the path that served it")
        log(f"gate: pool-hit AND sync-fallback keys reconstruct "
            f"bit-exactly (lam={lam}, x=alpha included; fallback "
            f"counted)")

        # -- phase 2: sustained publish-to-servable ---------------------
        pool("supply", target_depth=refill_batch,
             low_water=refill_batch, refill_batch=refill_batch)
        svc.keyfactory.pump()  # warm
        fill_rates = []
        for _ in range(max(args.reps, 1)):
            while svc.keyfactory.depth("supply"):  # drain: all hits
                svc.register_key("supply-drain", pool="supply")
            # The drained claims' reclaim flip stays off the clock: the
            # line claims the publish rate (mint + one manifest flip).
            svc.keyfactory.reclaim_spent()
            _sync(dev)
            t0 = monotonic()
            svc.keyfactory.pump()  # mint + publish (one manifest flip)
            _sync(dev)
            dt = monotonic() - t0
            fill_rates.append(refill_batch / dt)
        keys_per_sec = float(np.median(fill_rates))
        log(f"publish-to-servable: {keys_per_sec:,.1f} keys/s sustained "
            f"(K={refill_batch} per batch, {len(fill_rates)} fills, "
            f"durable batched manifest flips)")

        # -- phase 3: registration latency, hit vs sync -----------------
        hit_n = min(100, refill_batch * 2)
        pool("sess", target_depth=max(hit_n, refill_batch),
             low_water=max(refill_batch // 2, 1),
             refill_batch=refill_batch)
        while svc.keyfactory.depth("sess") < hit_n:
            svc.keyfactory.pump()
        hit_lat = []
        for i in range(hit_n):
            t0 = monotonic()
            svc.register_key(f"lat-{i}", pool="sess")
            hit_lat.append(monotonic() - t0)
            svc.unregister_key(f"lat-{i}")
        pool("never-filled", target_depth=1, low_water=0,
             refill_batch=1)
        sync_n = max(args.reps * 4, 12)
        sync_lat = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i in range(sync_n):
                t0 = monotonic()
                svc.register_key(f"sync-{i}", pool="never-filled")
                sync_lat.append(monotonic() - t0)
                svc.unregister_key(f"sync-{i}")
        hit_med = float(np.median(hit_lat))
        sync_med = float(np.median(sync_lat))
        speedup = sync_med / max(hit_med, 1e-9)
        log(f"registration latency: pool hit {hit_med * 1e6:,.1f} us "
            f"vs synchronous keygen {sync_med * 1e6:,.1f} us "
            f"({speedup:,.1f}x) at the same (lam={lam}, K=1) shape")

        # -- phase 4: session churn -------------------------------------
        churn = None
        if args.duration > 0:
            with svc:  # worker + refill worker
                churn = session_churn(
                    svc, pool="sess", duration_s=float(args.duration),
                    concurrency=args.concurrency,
                    min_points=args.min_req_points or 8,
                    max_points=args.max_req_points or 64,
                    seed=args.seed)
            log(f"churn: {churn.sessions_ok} sessions in "
                f"{churn.duration_s:.1f}s "
                f"({churn.sessions_per_sec:,.1f} sessions/s, "
                f"{churn.sessions_failed} failed)")
        snap = svc.metrics_snapshot()
        hits = snap.get("keyfactory_pool_hits_total", 0)
        misses = snap.get("keyfactory_pool_misses_total", 0)

        extra = {
            "lam": lam,
            "n_bytes": nb,
            "refill_batch": refill_batch,
            "device_refill": use_device,
            "device_fallbacks": 0,
            "fills": len(fill_rates),
            "pool_hit_register_s": round(hit_med, 9),
            "sync_register_s": round(sync_med, 9),
            "pool_hit_speedup": round(speedup, 1),
            "pool_hits": hits,
            "pool_misses": misses,
            "pool_hit_rate": round(hits / max(hits + misses, 1), 4),
            "store_writes": snap.get("serve_store_writes_total", 0),
            "platform": platform,
            "interpreted": interp and use_device,
            "repro": (f"python -m dcf_tpu_torch.cli keyfactory_bench "
                      f"--lam {lam} --keys {refill_batch} "
                      f"--seed {args.seed}"),
            **_pinned_ratio(nb, refill_batch, keys_per_sec,
                            interpreted=interp and use_device, lam=lam,
                            keygen=True),
        }
        if churn is not None:
            extra.update({
                "churn_duration_s": round(churn.duration_s, 3),
                "churn_concurrency": args.concurrency,
                "churn_sessions_ok": churn.sessions_ok,
                "churn_sessions_failed": churn.sessions_failed,
                "churn_sessions_per_sec":
                    round(churn.sessions_per_sec, 2),
                **churn.register_quantiles(),
                **churn.session_quantiles(),
            })
        unit = (f"keys/s publish-to-servable (K={refill_batch} "
                f"{'device' if use_device else 'host'} batches, "
                f"durable, N={nb}B domain)")
        if interp and use_device:
            unit += PLAIN_NOTE
        _emit("keyfactory_bench", backend, "keys_per_sec", keys_per_sec,
              unit, extra_fields=extra)

        failures = []
        if speedup < 10:
            failures.append(
                f"pool-hit registration is only {speedup:.1f}x faster "
                "than the synchronous path (acceptance wants >= 10x)")
        if churn is not None and churn.sessions_ok == 0:
            failures.append("session churn completed zero sessions")
        if failures:
            raise SystemExit("keyfactory_bench: " + "; ".join(failures))
    finally:
        if cleanup:
            shutil.rmtree(store_dir, ignore_errors=True)


def _parse_skew(value, flag: str = "--skew") -> float:
    """Zipf-exponent validation shared by serve_bench / mic_bench /
    chaos_bench: reject a bad flag loudly, naming it, before any work.
    0 = uniform key choice; s > 0 weights the r-th registered key by
    1/r^s (``serve.loadgen``)."""
    try:
        s = float(value)
    except (TypeError, ValueError):
        raise SystemExit(
            f"{flag}: expected a Zipf exponent (a finite number >= 0, "
            f"0 = uniform), got {value!r}")
    if not math.isfinite(s) or s < 0.0:
        # NaN compares false to 0, so `s < 0` alone would let it through.
        raise SystemExit(
            f"{flag}: Zipf exponent must be finite and >= 0 "
            f"(0 = uniform), got {value!r}")
    return s


def _parse_priority_mix(spec: str) -> dict:
    """``critical=0.2,normal=0.5,batch=0.3`` -> weight dict, validated
    loudly (class names, parseable non-negative weights, no
    duplicates)."""
    from dcf_tpu_torch.serve.admission import parse_priority

    mix = {}
    for part in spec.split(","):
        name, _, w = part.partition("=")
        name = name.strip().lower()
        try:
            parse_priority(name)
            weight = float(w)
        except ValueError as e:
            raise SystemExit(
                f"--priority-mix: bad entry {part.strip()!r} ({e}); "
                "expected class=weight pairs, e.g. "
                "critical=0.2,normal=0.5,batch=0.3")
        if name in mix:
            raise SystemExit(
                f"--priority-mix: duplicate class {name!r}")
        if not math.isfinite(weight) or weight < 0.0:
            raise SystemExit(
                f"--priority-mix: weight for {name!r} must be a finite "
                f"non-negative number, got {w.strip()!r}")
        mix[name] = weight
    if sum(mix.values()) <= 0.0:
        raise SystemExit(
            "--priority-mix: weights sum to zero — at least one class "
            "needs positive weight, e.g. critical=0.2,normal=0.5")
    return mix


def _chaos_flags(args) -> tuple:
    """The fail-fast flag validation shared by chaos_bench's two
    scenarios.  Returns ``(backend, max_batch, min_req, max_req,
    window)``."""
    backend = _serve_backend(args, "chaos_bench")
    max_batch = args.max_batch or 256
    min_req = args.min_req_points or max(max_batch // 8, 1)
    max_req = args.max_req_points or (max_batch // 2)
    if not 1 <= min_req <= max_req:
        raise SystemExit(f"bad request-size range [{min_req}, {max_req}]")
    window = args.fault_window
    if window < 1:
        raise SystemExit(
            f"--fault-window must be >= 1 failing eval, got {window}")
    return backend, max_batch, min_req, max_req, window


def _chaos_keyfactory_kill(svc, rng, nb, lam) -> tuple:
    """chaos_bench --crash-restart --keyfactory, the pre-kill half:
    declare a pool, refill it durably, claim two sessions, then kill the
    next refill between its frame writes and the manifest flip (the
    armed ``store.manifest`` seam).  Returns ``(spec, pre_pool,
    claimed_ids)`` for the post-restart assertions."""
    import warnings

    from dcf_tpu_torch.serve import PoolSpec
    from dcf_tpu_torch.testing import faults

    alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
    betas = rng.integers(1, 256, (1, lam), dtype=np.uint8)
    spec = svc.add_pool(PoolSpec(
        name="chaos-pool", alphas=alphas, betas=betas,
        target_depth=6, low_water=6, refill_batch=3))
    svc.keyfactory.pump()
    pre_pool = svc.keyfactory.pool_manifest("chaos-pool")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.register_key("pool-sess-0", pool="chaos-pool")
        svc.register_key("pool-sess-1", pool="chaos-pool")
    claimed = set(pre_pool) - set(
        svc.keyfactory.pool_manifest("chaos-pool"))
    try:
        with faults.inject("store.manifest"):
            svc.keyfactory.pump()  # the refill batch writes its frames
            # and dies before the flip (contained, counted)
        raise SystemExit(
            "chaos_bench --keyfactory: the armed store.manifest fault "
            "never fired — the kill scenario did not run")
    except faults.InjectedFault:
        pass
    svc.keyfactory.close()
    return spec, pre_pool, claimed


def _chaos_crash_restart(args) -> None:
    """``chaos_bench --crash-restart``: durable keys serve mixed load
    under a ``serve.eval`` fault window, the service is killed mid-stage
    (closed without draining, requests in flight), and a fresh service on
    the same store directory restores.  Asserted: every durable key came
    back (zero re-keygen) with its generation, nothing was quarantined,
    and the restored registry serves bit-exact two-party reconstructions
    against the C++ core.  ``--keyfactory`` adds the pool scenario.
    Exit code != 0 on any violated assertion."""
    import shutil
    import tempfile

    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.serve.batcher import next_pow2
    from dcf_tpu_torch.serve.loadgen import closed_loop
    from dcf_tpu_torch.testing import faults

    lam, nb = 16, 16
    backend, max_batch, min_req, max_req, window = _chaos_flags(args)
    dev = _dev(args)
    n_bundles = args.bundles or 3
    store_dir = args.store_dir or tempfile.mkdtemp(prefix="dcf-chaos-")
    cleanup = not args.store_dir  # keep an operator-chosen dir around
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    dcf = Dcf(nb, lam, ck, backend=backend, device=dev)
    try:
        svc = dcf.serve(max_batch=max_batch,
                        max_delay_ms=args.max_delay_ms, retries=1,
                        breaker_failures=args.breaker_failures,
                        breaker_cooldown_s=args.breaker_cooldown,
                        store_dir=store_dir)
        bundles = _gen_serve_bundles(svc, native, rng, n_bundles, nb,
                                     lam, durable=True)
        gens_pre = {k: svc.registry.snapshot(k)[2] for k in bundles}
        m = next_pow2(min_req)
        while m <= max_batch:  # warm before timing anything
            svc.submit("key-0",
                       rng.integers(0, 256, (m, nb), dtype=np.uint8))
            svc.pump()
            m *= 2
        _serve_parity_gate(svc, native, bundles, rng, nb, points=64,
                           bench="chaos_bench", tag="pre-crash",
                           timeout=30)
        with faults.inject_schedule("serve.eval",
                                    window_evals=window) as sched:
            svc.start()
            res = closed_loop(
                svc, sorted(bundles), duration_s=float(args.duration),
                concurrency=args.concurrency,
                min_points=min_req, max_points=max_req, seed=args.seed)
            # The KILL: in-flight submits, then shutdown without drain.
            kill_futs = [svc.submit(
                k, rng.integers(0, 256, (min_req, nb), dtype=np.uint8))
                for k in sorted(bundles)]
            svc.close(drain=False)
        pool_state = None
        if args.keyfactory:
            pool_state = _chaos_keyfactory_kill(svc, rng, nb, lam)
        del svc  # abandoned, as a killed process would be

        # Warm restart: fresh facade state, same store directory.
        svc2 = dcf.serve(max_batch=max_batch, retries=1,
                         store_dir=store_dir)
        if pool_state is not None:
            svc2.add_pool(pool_state[0])  # declared before restore, so
            # restored pool frames adopt straight into the pool
        report = svc2.restore_keys()
        failures = []
        regen = sorted(set(bundles) - set(report.restored))
        if regen:
            failures.append(
                f"regen_count={len(regen)}: durable keys {regen} did "
                "not restore — keygen would have to re-run")
        if report.quarantined:
            failures.append(
                f"quarantined on restore: {sorted(report.quarantined)} "
                "— a kill must never leave a torn visible frame")
        gens_post = {k: svc2.registry.snapshot(k)[2]
                     for k in report.restored}
        if gens_post != {k: gens_pre[k] for k in gens_post}:
            failures.append(
                f"generations drifted across restart: {gens_pre} -> "
                f"{gens_post}")
        pool_extra = {}
        if pool_state is not None:
            spec, pre_pool, claimed = pool_state
            post_pool = svc2.keyfactory.pool_manifest(spec.name)
            want_pool = {k: g for k, g in pre_pool.items()
                         if k not in claimed}
            if post_pool != want_pool:
                failures.append(
                    f"pool supply drifted across restart: "
                    f"{sorted(want_pool)} -> {sorted(post_pool)} "
                    "(torn entries, lost generations, or resurrected "
                    "claims)")
            minted_post = svc2.metrics_snapshot().get(
                "keyfactory_minted_keys_total", 0)
            if minted_post:
                failures.append(
                    f"restore minted {minted_post} pool keys — "
                    "already-published supply must restore with ZERO "
                    "re-keygen")
            if not failures:
                # A restored pool entry must still serve bit-exactly.
                import warnings

                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    kb_pool = svc2.register_key("post-pool-sess",
                                                pool=spec.name)
                xs_p = rng.integers(0, 256, (32, nb), dtype=np.uint8)
                f0 = svc2.submit("post-pool-sess", xs_p, b=0)
                f1 = svc2.submit("post-pool-sess", xs_p, b=1)
                svc2.pump()
                want = (native.eval(0, kb_pool, xs_p)
                        ^ native.eval(1, kb_pool, xs_p))
                if not np.array_equal(f0.result(30) ^ f1.result(30),
                                      want):
                    failures.append(
                        "restored pool key served a wrong two-party "
                        "reconstruction vs the C++ core")
            pool_extra = {
                "pool_published": len(pre_pool),
                "pool_claimed_pre_kill": len(claimed),
                "pool_restored": len(post_pool),
            }
        if not failures:
            _serve_parity_gate(svc2, native, bundles, rng, nb,
                               points=64, bench="chaos_bench",
                               tag="post-restart", timeout=30)
        for line in failures:
            log(f"CRASH-RESTART FAIL: {line}")
        snap = svc2.metrics_snapshot()
        extra = {
            "scenario": "crash-restart",
            **pool_extra,
            "duration_s": round(res.duration_s, 3),
            "concurrency": args.concurrency,
            "max_batch": max_batch,
            "bundles": n_bundles,
            "fault_window": window,
            "fault_evals_failed": sched.failed,
            "requests_ok": res.requests_ok,
            "requests_failed": res.requests_failed,
            "killed_inflight": len(kill_futs),
            "regen_count": len(regen),
            "restored": len(report.restored),
            "quarantined": len(report.quarantined),
            "store_restored_total": snap.get(
                "serve_store_restored_total", 0),
            "assertions_failed": failures,
        }
        _emit("chaos_bench", backend, "restored_keys",
              float(len(report.restored)),
              "durable keys restored after the mid-stage kill",
              extra_fields=extra)
        if failures:
            raise SystemExit(
                f"chaos_bench --crash-restart: {len(failures)} "
                "durability assertions failed")
    finally:
        if cleanup:
            shutil.rmtree(store_dir, ignore_errors=True)


def bench_chaos(args) -> None:
    """Chaos harness for the serve resilience layer.

    A mixed-priority closed-loop load runs while a declarative fault
    schedule is armed at the ``serve.eval`` seam (fail the first
    ``--fault-window`` evals, then recover); then the metrics snapshot
    must show: the breaker opened and closed again (none left open),
    zero CRITICAL requests shed and BATCH shed first, and a fresh service
    serving bit-exact two-party reconstructions against the C++ core.
    Exit code != 0 on any violated assertion.  ``--crash-restart``
    switches to the durable-store scenario (``_chaos_crash_restart``).
    """
    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.serve.batcher import next_pow2
    from dcf_tpu_torch.serve.loadgen import closed_loop
    from dcf_tpu_torch.testing import faults

    if args.crash_restart:
        _chaos_crash_restart(args)
        return
    if args.keyfactory:
        raise SystemExit(
            "--keyfactory extends the durable-store scenario; pass it "
            "with --crash-restart")
    lam, nb = 16, 16
    backend, max_batch, min_req, max_req, window = _chaos_flags(args)
    mix = _parse_priority_mix(args.priority_mix)  # bad flags fail fast
    skew = _parse_skew(args.skew)
    dev = _dev(args)
    n_bundles = args.bundles or 2
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    native = NativeDcf(lam, ck)
    dcf = Dcf(nb, lam, ck, backend=backend, device=dev)
    svc = dcf.serve(max_batch=max_batch,
                    max_delay_ms=args.max_delay_ms,
                    retries=1,
                    breaker_failures=args.breaker_failures,
                    breaker_cooldown_s=args.breaker_cooldown,
                    # Generous on purpose: overload sheds must come from
                    # the brownout/breaker machinery under test.
                    max_queued_points=1 << 20)
    bundles = _gen_serve_bundles(svc, native, rng, n_bundles, nb, lam)

    # Warm the padded batch sizes BEFORE arming faults.
    m = next_pow2(min_req)
    while m <= max_batch:
        svc.submit("key-0", rng.integers(0, 256, (m, nb), dtype=np.uint8))
        svc.pump()
        m *= 2
    _serve_parity_gate(svc, native, bundles, rng, nb, points=64,
                       bench="chaos_bench", tag="pre-chaos",
                       priority="critical", timeout=30)

    with faults.inject_schedule("serve.eval",
                                window_evals=window) as sched:
        with svc:
            res = closed_loop(
                svc, sorted(bundles), duration_s=float(args.duration),
                concurrency=args.concurrency,
                min_points=min_req, max_points=max_req,
                seed=args.seed, priority_mix=mix, skew=skew)
        # ``with svc`` drains on exit: the snapshot is quiescent.
    snap = svc.metrics_snapshot()

    failures = []
    opened = snap.get("serve_breaker_transitions_total{to=open}", 0)
    closed = snap.get("serve_breaker_transitions_total{to=closed}", 0)
    if not sched.recovered:
        failures.append(
            f"fault window not consumed ({sched.failed}/{window} "
            "failing evals): raise --duration or lower --fault-window")
    if opened < 1:
        failures.append("breaker never opened under the fault window")
    if closed < 1:
        failures.append("breaker never closed after recovery")
    stuck = sorted(k for k, v in snap.items()
                   if k.startswith("serve_breaker_state{") and v)
    if stuck:
        failures.append(
            f"breaker(s) not closed after recovery: {', '.join(stuck)}")
    crit_shed = snap.get(
        "serve_shed_by_class_total{priority=critical}", 0)
    batch_shed = snap.get("serve_shed_by_class_total{priority=batch}", 0)
    if crit_shed:
        failures.append(f"{crit_shed} CRITICAL requests shed — shedding "
                        "must be lowest-class-first")
    if snap.get("serve_shed_total", 0) and not batch_shed:
        failures.append("the run shed load but no BATCH-class request "
                        "was shed — not lowest-class-first")
    for line in failures:
        log(f"CHAOS FAIL: {line}")

    # Post-recovery proof on a fresh service over the same facade.
    svc2 = dcf.serve(max_batch=max_batch, retries=1)
    for name, bundle in bundles.items():
        svc2.register_key(name, bundle)
    _serve_parity_gate(svc2, native, bundles, rng, nb, points=64,
                       bench="chaos_bench", tag="post-chaos",
                       priority="critical", timeout=30)

    extra = {
        "duration_s": round(res.duration_s, 3),
        "concurrency": args.concurrency,
        "max_batch": max_batch,
        "fault_window": window,
        "fault_evals_failed": sched.failed,
        "priority_mix": mix,
        "skew": skew,
        "requests_ok": res.requests_ok,
        "requests_shed": res.requests_shed,
        "requests_failed": res.requests_failed,
        "by_class": res.by_class,
        "breaker_opens": opened,
        "breaker_closes": closed,
        "brownout_refusals": snap.get("serve_brownout_refusals_total", 0),
        "metrics_snapshot": snap,
        "assertions_failed": failures,
    }
    _emit("chaos_bench", backend, "requests_ok",
          float(res.requests_ok),
          "requests served under the chaos schedule", extra_fields=extra)
    if failures:
        raise SystemExit(
            f"chaos_bench: {len(failures)} resilience assertions failed")


def bench_baseline(args) -> None:
    """All five BASELINE.json configs in one run, 8 lines (config 1 emits
    gen + 1-pt eval; configs 2 and 4 each run their literal wording and
    the reference-bench shape they cite).

    ``--full`` runs config 5 at its literal 10^6-key scale; without it
    secure_relu uses 2^18 keys.
    """
    import copy

    # An explicit --keys always wins; --full only raises the default.
    full_keys = args.keys or (1_000_000 if args.full else 1 << 18)
    specs = [
        ("1", "dcf", dict(backend="cpu")),
        # keys=1 pinned: an outer --keys (meant for config 5) must not
        # leak into the single-key prefix shapes.
        ("2 (flagship n=128 scale-up)", "dcf_batch_eval",
         dict(backend="prefix", points=1 << 20, keys=1)),
        ("2 (literal n=32)", "dcf_batch_eval",
         dict(backend="prefix", points=1 << 20, domain_bytes=4, keys=1)),
        ("3", "full_domain", dict(backend="tree", n_bits=24)),
        ("4 (reference bench lambda=16384)", "dcf_large_lambda",
         dict(backend="hybrid", points=10_000, keys=1)),
        ("4 (literal lambda=256)", "dcf_large_lambda",
         dict(backend="hybrid", points=10_000, keys=1, lam=256)),
        ("5", "secure_relu", dict(backend="cpu", device_gen=True,
                                  keys=full_keys,
                                  points=args.points or 1_024)),
    ]
    for cfg, name, over in specs:
        log(f"--- BASELINE config {cfg}: {name} {over} ---")
        a = copy.copy(args)
        for key, val in over.items():
            setattr(a, key, val)
        BENCHES[name](a)


# -- the multi-process pod: serve_host and pod_bench -------------------------


def _pod_backend(args) -> str:
    """The facade backend a shard process serves: ``numpy``, ``walk`` or
    ``prefix`` (lam = 16 and 32 as the facade allows them), or ``cpu``.
    ``cpu``, the global argparse default, is ``dcf_tpu``'s no-TPU
    serving default, its on-device bitsliced walk: on ``--device cuda``
    it becomes ``walk`` (B1), as in the serving benches, so a default
    run on the card serves through the kernel; only on ``--device cpu``
    does it stay the port's C++ core."""
    if args.backend not in POD_BACKENDS:
        raise SystemExit(
            f"serve_host/pod_bench serve single-device facade backends "
            f"({'/'.join(POD_BACKENDS)}), got {args.backend!r}")
    if args.backend == "cpu" and args.device != "cpu":
        return "walk"
    return args.backend


def _serve_host_facade(args):
    """The shard facade serve_host and pod_bench share
    (``dcf_tpu/cli.py:3202-3222``): flagship-shaped by default, cipher
    keys DERIVED from ``--seed`` — every process in a pod launched with
    the same seed/lam reconstructs the same cipher keys, which is what
    lets pod_bench provision bundles in the parent and have every shard
    serve them.  The device is picked here (``_dev``), after the
    caller's own flag checks: on the card that builds every kernel, so
    the parent builds them once before its first spawn and no shard
    starts an nvcc run of its own."""
    import dcf_tpu_torch

    lam = args.lam or 16
    nb = args.domain_bytes or 16
    backend = _pod_backend(args)
    dev = _dev(args)
    opts = None
    if backend == "prefix" and args.prefix_levels:
        opts = {"prefix_levels": args.prefix_levels}
    elif backend == "prefix" and dev.type == "cpu":
        # The plain frontier build at the default depth 21 takes minutes
        # a (key, party) on the CPU (serve_bench --skew's clamp).
        opts = {"prefix_levels": 10}
        log("no card: clamping the prefix frontier to prefix_levels=10 "
            "for the plain versions (override with --prefix-levels)")
    rng = np.random.default_rng(args.seed)
    ck = _cipher_keys(lam, rng)
    dcf = dcf_tpu_torch.Dcf(nb, lam, ck, backend=backend, backend_opts=opts,
                            device=dev)
    return dcf, lam, nb, backend, rng


def bench_serve_host(args) -> None:
    """One pod shard process (``dcf_tpu/cli.py:3225-3350``): the
    crash-safe, breaker-guarded single-host serving unit — ``DcfService``
    warm-started from its durable store + an ``EdgeServer`` — run as a
    long-lived process a router forwards DCFE frames to.

    Keys are provisioned through the shard's store (``--store-dir``):
    the operator (or pod_bench) writes DCFK frames there under ring
    placement — owner AND replica stores, generations preserved via
    ``KeyStore.replicate_to`` — and this process restores ALL of them
    at startup (``restore_keys()``), so a replica is warm the moment
    failover routes to it.  On the card the CUDA context is made before
    the shard says it is ready.  ``--ready-file`` receives a JSON line
    with the bound address once serving; ``--metrics-file`` is refreshed
    (atomic rename) every ~0.5s and at shutdown — the per-host
    snapshots ``pod_bench`` rolls up into the pod view.  Runs until
    SIGTERM/SIGINT (or until its parent exits — a shard orphaned by a
    dead launcher must not linger).  ``--tls-cert``/``--tls-key``
    (+ ``--tls-client-ca`` to pin the router) arm TLS on the edge
    socket.  ``--standby`` comes up provisioned-but-idle: it restores
    nothing, and the graceful join warms it.

    Graceful shutdown: SIGTERM/SIGINT stop the edge (no new frames),
    DRAIN the service (``close(drain=True)`` — queued requests are
    served, never failed), write one final metrics snapshot, and remove
    the ready file before exiting 0 — a PLANNED restart loses no
    accepted work and un-advertises itself.  SIGKILL remains the crash
    test: the failover/restore machinery owns that path."""
    import os
    import signal
    import threading

    from dcf_tpu_torch.serve import EdgeServer, RestoreReport

    if not args.store_dir:
        raise SystemExit(
            "serve_host needs --store-dir (the shard's durable key "
            "store; pod provisioning writes frames there)")
    dcf, lam, nb, backend, _rng = _serve_host_facade(args)
    knobs = {}
    if args.max_queued_points:
        # The surge scenario pins a small admission bound so sustained
        # overload becomes visible demand (sheds/brownout) within the
        # bench window instead of an invisible mile-deep queue.
        knobs["max_queued_points"] = args.max_queued_points
    svc = dcf.serve(max_batch=args.max_batch or (1 << 10),
                    max_delay_ms=args.max_delay_ms,
                    store_dir=args.store_dir,
                    tls_cert=args.tls_cert, tls_key=args.tls_key,
                    tls_client_ca=args.tls_client_ca, **knobs)
    if args.standby:
        # A standby host is provisioned-but-idle: it serves and probes,
        # but restores nothing at startup — the graceful join's
        # warm-before-admit pass ships it exactly the keys its ring
        # placement owes it WHEN the capacity controller admits it, so a
        # stale store left from a previous tour never races the
        # migration.
        report = RestoreReport()
        log(f"serve_host[{backend} lam={lam} nb={nb}]: STANDBY "
            "(restore skipped; the join warms this host)")
    else:
        report = svc.restore_keys()
        log(f"serve_host[{backend} lam={lam} nb={nb}]: restored "
            f"{len(report.restored)} keys "
            f"({len(report.quarantined)} quarantined)")
    if dcf.device.type == "cuda":
        # The shard's CUDA context, before it says it is ready: the
        # first routed request must not pay for it.
        import torch

        torch.zeros(1, device=dcf.device)
        torch.cuda.synchronize(dcf.device)
    svc.start()
    edge = EdgeServer(svc, host=args.bind, port=args.port).start()
    host, port = edge.address
    if args.ready_file:
        _flush_json(args.ready_file, {
            "host": host, "port": port, "pid": os.getpid(),
            "restored": len(report.restored),
            "quarantined": len(report.quarantined),
            "standby": bool(args.standby)})
    log(f"serve_host listening on {host}:{port} [{_CARD['label']}]")
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop.set())
    ppid = os.getppid()
    try:
        while not stop.is_set():
            stop.wait(0.5)
            if args.metrics_file:
                _flush_json(args.metrics_file, svc.metrics_snapshot())
            if os.getppid() != ppid:
                log("serve_host: parent exited; shutting down")
                break
    finally:
        # Ordered graceful teardown: listener first (no NEW connections
        # — live ones stay open so drained responses can still reach
        # their clients), then drain the service (queued requests
        # complete; frames arriving mid-drain are refused typed over the
        # still-open links), then the edge flushes each writer's backlog
        # before the hard close, and only THEN the final metrics
        # snapshot — it must include the drained work's counters.
        edge.stop_accepting()
        try:
            svc.close(drain=True)
        except Exception:  # fallback-ok: a failing drain (dying
            # store reclaim at shutdown) must not skip the snapshot
            # or the ready-file removal below
            log("serve_host: drain raised; exiting anyway")
        edge.close(drain_s=5.0)
        if args.metrics_file:
            try:
                _flush_json(args.metrics_file, svc.metrics_snapshot())
            except OSError:
                pass  # fallback-ok: dying disk at shutdown — the
                # periodic flush above already published a snapshot
        if args.ready_file:
            try:
                os.unlink(args.ready_file)
            except OSError:
                pass  # fallback-ok: never written, or already gone
    log("serve_host: stopped")


def _flush_json(path: str, doc: dict) -> None:
    """Write ``doc`` to ``path`` by atomic rename: readers only ever see
    a whole file."""
    import os

    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)


def _pod_rollup(metric_files: list) -> dict:
    """The pod view: per-host metrics snapshots (the serve_host
    ``--metrics-file`` JSON dumps) summed via
    ``serve.metrics.rollup_snapshots``.  Hosts that never wrote one
    (killed before the first flush) contribute nothing."""
    from dcf_tpu_torch.serve.metrics import rollup_snapshots

    snaps = []
    for path in metric_files:
        try:
            with open(path, encoding="utf-8") as fh:
                snaps.append(json.load(fh))
        except (OSError, ValueError):
            continue  # fallback-ok: a killed shard's file may be
            # absent; the rollup is over the hosts that reported
    return rollup_snapshots(snaps)


def _pod_root(args) -> tuple:
    """(root, keep): the pod's directory — its stores, ready and metrics
    files — ``--store-dir`` (kept) or a fresh temp dir (removed)."""
    import os
    import tempfile

    root = args.store_dir or tempfile.mkdtemp(prefix="dcf-pod-")
    os.makedirs(root, exist_ok=True)
    return root, bool(args.store_dir)


def _pod_provision(dcf, lam, nb, rng, root, shard_ids,
                   n_bundles: int, *, solo: bool = False) -> tuple:
    """The ONE provisioning block every pod scenario starts with: build
    the rendezvous ring over ``shard_ids``, open one ``KeyStore`` per
    shard under ``root``, mint ``n_bundles`` two-party bundles (on the
    facade's device: G1 on the card), and write each durably to its
    owner's store with ``replicate_to`` copies to its replicas — same
    bytes, same generation.  ``solo`` adds the single-shard comparison
    store holding everything (the ``bench_pod`` leg).  Returns
    ``(ring, stores, bundles, gens)``."""
    import os

    from dcf_tpu_torch.serve import KeyStore, ShardMap, ShardSpec

    ring = ShardMap([ShardSpec(s) for s in shard_ids])
    stores = {s: KeyStore(os.path.join(root, s)) for s in shard_ids}
    if solo:
        stores["solo"] = KeyStore(os.path.join(root, "solo"))
    bundles, gens = {}, {}
    for i in range(n_bundles):
        name = f"key-{i}"
        alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
        betas = rng.integers(0, 256, (1, lam), dtype=np.uint8)
        kb = dcf.gen(alphas, betas, rng=rng)
        bundles[name], gens[name] = kb, i + 1
        placed = ring.placement(name, replicas=1)
        stores[placed[0].host_id].put(name, kb, generation=gens[name])
        for rep in placed[1:]:
            stores[placed[0].host_id].replicate_to(
                stores[rep.host_id], name)
        if solo:
            stores["solo"].put(name, kb, generation=gens[name])
    return ring, stores, bundles, gens


def _pod_warmup(rng, nb: int, max_batch: int, plan) -> None:
    """The ONE warmup ladder every pod scenario runs: every padded pow-2
    batch shape on every process, both parties — ``plan`` is
    ``[(target, [key, ...]), ...]`` with one key per shard the ladder
    must reach — so no soak pays a shard's first staging of a shape."""
    xs_warm = rng.integers(0, 256, (max_batch, nb), dtype=np.uint8)
    m = 1
    while m <= max_batch:
        for target, keys in plan:
            for name in keys:
                target.evaluate(name, xs_warm[:m], b=0, timeout=300)
                target.evaluate(name, xs_warm[:m], b=1, timeout=300)
        m *= 2


def _pod_spawn(tag: str, store_dir: str, run_dir: str, args,
               standby: bool = False, extra=()) -> tuple:
    """Spawn one serve_host subprocess — ``python -m dcf_tpu_torch.cli
    serve_host`` on the parent's ``--device``, with this package's root
    first on its import path (a pod launched from an unpacked copy
    serves that copy) — and return (Popen, ready_path, metrics_path).
    ``standby``: launch it as a provisioned-but-idle standby host;
    ``extra``: additional serve_host flags (the surge scenario's queue
    bound)."""
    import os
    import subprocess

    import dcf_tpu_torch

    ready = os.path.join(run_dir, f"ready-{tag}.json")
    metrics = os.path.join(run_dir, f"metrics-{tag}.json")
    cmd = [sys.executable, "-m", "dcf_tpu_torch.cli", "serve_host",
           "--store-dir", store_dir, "--ready-file", ready,
           "--metrics-file", metrics, "--seed", str(args.seed),
           "--backend", _pod_backend(args), "--device", args.device,
           "--max-batch", str(args.max_batch or (1 << 10)),
           "--max-delay-ms", str(args.max_delay_ms)]
    if args.lam:
        cmd += ["--lam", str(args.lam)]
    if args.domain_bytes:
        cmd += ["--domain-bytes", str(args.domain_bytes)]
    if args.prefix_levels:
        cmd += ["--prefix-levels", str(args.prefix_levels)]
    if standby:
        cmd += ["--standby"]
    cmd += list(extra)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        dcf_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(cmd, env=env)
    return proc, ready, metrics


def _pod_wait_ready(procs: dict, timeout_s: float = 300.0) -> dict:
    """Block until every spawned shard wrote its ready file; returns
    ``{tag: ready_doc}``.  A shard that exits early (or the deadline)
    is a SystemExit — a half-up pod must not silently bench."""
    import os

    t0 = time.monotonic()
    ready: dict = {}
    while len(ready) < len(procs):
        for tag, (proc, rpath, _m) in procs.items():
            if tag in ready:
                continue
            if proc.poll() is not None:
                raise SystemExit(
                    f"pod_bench: shard {tag} exited rc={proc.returncode} "
                    "before becoming ready")
            if os.path.exists(rpath):
                with open(rpath, encoding="utf-8") as fh:
                    ready[tag] = json.load(fh)
        if len(ready) < len(procs):
            if time.monotonic() - t0 > timeout_s:
                raise SystemExit(
                    f"pod_bench: shards not ready after {timeout_s:.0f}s "
                    f"({sorted(ready)} of {sorted(procs)})")
            time.sleep(0.2)
    return ready


def _pod_router(specs, nb: int, probe_interval: float,
                backoff_s: float = 0.02, **kw):
    """The scenarios' self-healing router: fail-3/recover-2 probes every
    ``probe_interval`` seconds, reconnect backoff from ``backoff_s``
    (0.02 s in the self-healing scenarios, the router's 0.05 in the
    plain one) capped at half a second (``dcf_tpu``'s settings; the
    surge passes its own probe settings)."""
    from dcf_tpu_torch.serve import DcfRouter

    opts = dict(probe_interval_s=probe_interval, probe_timeout_s=5.0,
                probe_fail_n=3, probe_recover_m=2,
                reconnect_backoff_s=backoff_s,
                max_backoff_s=max(min(probe_interval, 0.5), backoff_s))
    opts.update(kw)
    return DcfRouter(specs, n_bytes=nb, **opts)


def _pod_specs(ready: dict, tags) -> tuple:
    """(ShardSpecs, {tag: (host, port)}) of ``tags`` from their ready
    documents."""
    from dcf_tpu_torch.serve import ShardSpec

    specs = [ShardSpec(t, ready[t]["host"], ready[t]["port"]) for t in tags]
    return specs, {t: (ready[t]["host"], ready[t]["port"]) for t in tags}


def _oracle_pair(prg, kb, xs) -> np.ndarray:
    """Both parties' numpy-oracle shares of ``kb`` at ``xs``, XORed."""
    from dcf_tpu_torch.backends.numpy_backend import eval_batch_np

    return eval_batch_np(prg, 0, kb.for_party(0), xs) ^ \
        eval_batch_np(prg, 1, kb.for_party(1), xs)


def _oracle_pairs(prg, bundles: dict, xs) -> dict:
    """``_oracle_pair`` of every bundle at the same ``xs``, as one numpy
    walk a party over the stacked keys: ``{name: [1, M, lam]}``."""
    from dcf_tpu_torch.keys import KeyBundle

    names = list(bundles)
    stacked = KeyBundle(*(np.concatenate([getattr(bundles[n], f)
                                          for n in names])
                          for f in ("s0s", "cw_s", "cw_v", "cw_t",
                                    "cw_np1")),
                        group=bundles[names[0]].group)
    both = _oracle_pair(prg, stacked, xs)
    return {n: both[i:i + 1] for i, n in enumerate(names)}


def _routed_pair(target, name: str, xs, **kw) -> np.ndarray:
    """Both parties' routed shares of key ``name`` at ``xs``, XORed."""
    return target.evaluate(name, xs, b=0, timeout=300, **kw) ^ \
        target.evaluate(name, xs, b=1, timeout=300, **kw)


def _pod_parity_gate(router, bundles, prg, xs, solo=None) -> None:
    """Every key, both parties, through ``router`` (and ``solo``, the
    plain scenario's single-shard router, where given), bit-exact vs the
    numpy oracle, or SystemExit."""
    want = _oracle_pairs(prg, bundles, xs)
    targets = {"pod": router} if solo is None else {"pod": router,
                                                    "solo": solo}
    for name in bundles:
        for via, target in targets.items():
            if not np.array_equal(_routed_pair(target, name, xs),
                                  want[name]):
                where = "" if solo is None else f" via {via}"
                raise SystemExit(f"pod_bench parity mismatch vs numpy "
                                 f"oracle on {name}{where}")


def _pod_wait_up(router, timeout_s: float = 60.0) -> None:
    """Start the prober and wait until it sees every shard UP."""
    from dcf_tpu_torch.serve.health import UP

    router.start_health()
    deadline = time.monotonic() + timeout_s
    while any(st != UP for st in router.health.states().values()):
        if time.monotonic() > deadline:
            raise SystemExit(
                f"pod_bench: prober never saw the pod UP "
                f"({router.health.states()})")
        time.sleep(0.05)


def _pod_teardown(closers, procs: dict, root: str, keep: bool) -> None:
    """Close the parent's routers and controllers, SIGTERM every shard
    still running (SIGKILL after 15 s) and reap it, and remove the pod's
    directory unless it was ``--store-dir``."""
    import shutil

    for obj in closers:
        if obj is None:
            continue
        try:
            obj.close()
        except Exception:  # fallback-ok: best-effort teardown
            pass
    for proc, _r, _m in procs.values():
        if proc.poll() is None:
            proc.terminate()
    for proc, _r, _m in procs.values():
        try:
            proc.wait(15)
        except Exception:  # fallback-ok: a shard that ignores SIGTERM
            # gets the hard kill
            proc.kill()
            proc.wait(15)
    if not keep:
        shutil.rmtree(root, ignore_errors=True)


class _PodLedger:
    """``conns`` closed-loop clients driving mixed CRITICAL/NORMAL
    two-party sessions through a pod router, every request accounted:
    completed bit-exact vs the numpy oracle, or refused typed WITH a
    ``retry_after_s`` hint (the router converts bare transport deaths
    into hinted ``CircuitOpenError`` refusals precisely so the ledger
    closes).  Anything else — an unhinted refusal, a mismatch, an
    untyped error — is counted for the caller's gate.  Client ``i``
    draws from ``seed + stride * i``; a session picks CRITICAL with
    probability ``critical`` and 1 to ``max_points`` points.  The key
    list is taken once, at construction."""

    def __init__(self, router, bundles: dict, prg, nb: int, *,
                 conns: int, seed: int, stride: int, critical: float,
                 max_points: int):
        import threading

        self.stats = {"sessions_ok": 0, "critical_ok": 0, "mismatches": 0,
                      "refused_hinted": 0, "refused_unhinted": 0,
                      "unaccounted": 0}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        names = sorted(bundles)

        def client(i: int) -> None:
            from dcf_tpu_torch.errors import DcfError

            rng = np.random.default_rng(seed + stride * i)
            while not self._stop.is_set():
                name = names[int(rng.integers(0, len(names)))]
                pr = "critical" if rng.random() < critical else "normal"
                m = int(rng.integers(1, max_points + 1))
                xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
                try:
                    f0 = router.submit(name, xs, b=0, priority=pr)
                    f1 = router.submit(name, xs, b=1, priority=pr)
                    got = f0.result(120) ^ f1.result(120)
                except DcfError as e:
                    hinted = getattr(e, "retry_after_s", None) is not None
                    self._count("refused_hinted" if hinted
                                else "refused_unhinted")
                    continue
                except Exception:  # fallback-ok: the gate's failure arm
                    # — anything untyped escaping the router is exactly
                    # what the soak exists to catch, counted and asserted
                    self._count("unaccounted")
                    continue
                if np.array_equal(got, _oracle_pair(prg, bundles[name], xs)):
                    self._count("sessions_ok",
                                "critical_ok" if pr == "critical" else None)
                else:
                    self._count("mismatches")

        self._threads = [threading.Thread(target=client, args=(i,),
                                          name=f"pod-soak-{i}", daemon=True)
                         for i in range(conns)]

    def _count(self, *keys) -> None:
        with self._lock:
            for k in keys:
                if k is not None:
                    self.stats[k] += 1

    def start(self) -> "_PodLedger":
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: float | None = None) -> dict:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        return self.stats


def _ledger_gates(stats: dict, *, min_sessions: int) -> list:
    """The soak's failures: an unclean ledger, or too few sessions."""
    failures = []
    if stats["mismatches"] or stats["unaccounted"] \
            or stats["refused_unhinted"]:
        failures.append(
            f"ledger not clean: {stats['mismatches']} mismatches, "
            f"{stats['unaccounted']} untyped, "
            f"{stats['refused_unhinted']} unhinted refusals")
    if stats["sessions_ok"] < min_sessions or stats["critical_ok"] < 1:
        failures.append(
            f"soak delivered only {stats['sessions_ok']} sessions "
            f"({stats['critical_ok']} CRITICAL)")
    return failures


def _ledger_fields(stats: dict) -> dict:
    """The soak's counts under the line's ``soak_*`` keys."""
    return {f"soak_{k}": v for k, v in stats.items()}


def _pod_soak(router, bundles, prg, nb, *, duration_s: float,
              conns: int, seed: int, kill_after_s: float,
              kill_fn) -> dict:
    """The kill-a-shard failover soak: a ``_PodLedger`` of ``conns``
    clients for ``duration_s`` seconds while ``kill_fn`` SIGKILLs one
    shard ``kill_after_s`` seconds in.  Returns the ledger's counts."""
    ledger = _PodLedger(router, bundles, prg, nb, conns=conns, seed=seed,
                        stride=211, critical=0.5, max_points=64).start()
    t0 = time.monotonic()
    killed = False
    while time.monotonic() - t0 < duration_s:
        if not killed and time.monotonic() - t0 >= kill_after_s:
            kill_fn()
            killed = True
        time.sleep(0.05)
    return ledger.stop()


def _pod_live_register(router, dcf, rng, lam, nb, count: int,
                       prefix: str = "live-key") -> tuple:
    """Register ``count`` LIVE (non-durable) keys through the router's
    REGISTER fan-out: the owner mints each generation, the replicas
    apply it preserved — the path whose survival the kill and partition
    soaks gate on.  Returns ``(bundles, generations)``."""
    live, live_gens = {}, {}
    for i in range(count):
        name = f"{prefix}-{i}"
        alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
        betas = rng.integers(0, 256, (1, lam), dtype=np.uint8)
        kb = dcf.gen(alphas, betas, rng=rng)
        live_gens[name] = router.register_key(name, kb)
        live[name] = kb
    return live, live_gens


def _pod_wire_digest(addr: tuple, nb: int) -> dict:
    """A shard's live ``{key_id: generation}`` digest over the wire
    (the DIGEST verb — generations only, no key material moves)."""
    from dcf_tpu_torch.serve import EdgeClient

    with EdgeClient(addr[0], addr[1], n_bytes=nb) as c:
        return c.pull_digest(timeout=60)


def _group_by_owner(ring, bundles) -> dict:
    """{owner_host_id: [key, ...]} over the ring's placements."""
    by_owner: dict = {}
    for name in bundles:
        by_owner.setdefault(ring.owner(name).host_id, []).append(name)
    return by_owner


def _pod_line(args, dev, backend: str, metric: str, rate: float,
              unit: str, extra: dict, argv: str) -> None:
    """Emit a pod scenario's line: its platform, the repro (this
    package's module, backend and device) and the unit's disclosure on
    a CPU run."""
    platform, interp = _platform(dev)
    extra["platform"] = platform
    extra["repro"] = (f"python -m dcf_tpu_torch.cli pod_bench {argv} "
                      f"--backend {backend} --device {args.device} "
                      f"--seed {args.seed}")
    if interp:
        unit += PLAIN_NOTE
    _emit("pod_bench", backend, metric, rate, unit, extra_fields=extra)


def bench_pod_selfheal(args) -> None:
    """``pod_bench --partition`` / ``--flap`` (``dcf_tpu/cli.py:3587-
    4004``): the partition-tolerance scenario.  N shard processes behind
    the self-healing router; durable keys provisioned through the stores
    (owner + replica, ``replicate_to``), live keys through the REGISTER
    fan-out; then a ``net.partition`` window (``--flap``: three windows)
    cuts the router<->victim link under 3-thread mixed CRITICAL/NORMAL
    load while the health prober runs.

    Emitted-then-asserted gates:

    * LEDGER: every request reconstructs bit-exact vs the numpy
      oracle or is refused typed WITH ``retry_after_s`` — zero
      mismatches, zero untyped, zero unhinted;
    * PROMOTION: the prober walks the victim to DOWN inside every cut
      window, and a NORMAL request for a victim-owned key then serves
      bit-exact from the promoted replica within about one probe
      interval of the DOWN transition;
    * HEALING: after every window the victim is re-admitted UP
      through the anti-entropy gate, its wire digest converges to the
      owners' generations (including a re-registration minted MID-cut
      on the reachable side), and generations never regress across
      cycles;
    * THE FENCE: a doctored old-generation REGISTER frame sent
      straight to the victim dies typed ``E_STALE`` and the key keeps
      serving the newer bits."""
    import os

    from dcf_tpu_torch.errors import StaleStateError
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.serve import EdgeClient
    from dcf_tpu_torch.serve.health import DOWN, UP
    from dcf_tpu_torch.testing import faults

    n_shards = args.shards
    if n_shards < 2:
        raise SystemExit(
            f"--shards must be >= 2 for the partition scenario, "
            f"got {n_shards}")
    if args.probe_interval <= 0:
        raise SystemExit(
            f"--probe-interval must be > 0, got {args.probe_interval}")
    if args.live_bundles < 0:
        raise SystemExit(
            f"--live-bundles must be >= 0, got {args.live_bundles}")
    dcf, lam, nb, backend, rng = _serve_host_facade(args)
    prg = HirosePrgNp(lam, dcf.cipher_keys)
    n_bundles = args.bundles or 4
    cycles = 3 if args.flap else 1
    mode = "flap" if args.flap else "partition"

    root, keep_dirs = _pod_root(args)
    shard_ids = [f"shard-{i}" for i in range(n_shards)]
    ring, stores, bundles, gens = _pod_provision(
        dcf, lam, nb, rng, root, shard_ids, n_bundles)
    procs: dict = {}
    router = None
    try:
        for tag in shard_ids:
            procs[tag] = _pod_spawn(tag, os.path.join(root, tag),
                                    root, args)
        ready = _pod_wait_ready(procs)
        pod_specs, addr_of = _pod_specs(ready, shard_ids)
        router = _pod_router(pod_specs, nb, args.probe_interval)
        live, live_gens = _pod_live_register(
            router, dcf, rng, lam, nb, args.live_bundles)
        bundles.update(live)
        gens.update(live_gens)
        log(f"provisioned {n_bundles} durable + {len(live)} live keys "
            f"over {n_shards} shards")

        xs_gate = rng.integers(0, 256, (64, nb), dtype=np.uint8)
        _pod_parity_gate(router, bundles, prg, xs_gate)
        log(f"routed parity vs numpy oracle: OK ({len(bundles)} keys)")

        by_owner = _group_by_owner(ring, bundles)
        max_batch = args.max_batch or (1 << 10)
        _pod_warmup(rng, nb, max_batch,
                    [(router, [keys[0] for keys in by_owner.values()])])
        log("warmup ladder done (all shards, both parties)")
        victim = max(by_owner, key=lambda s: len(by_owner[s]))
        # A key to register MID-cut: its owner stays reachable, its
        # replica is the cut victim — the heal must converge it.  The
        # name is always a FRESH one mined from the ring (placement is a
        # pure function, so the search is deterministic): the soak
        # clients snapshot their key list before it exists, so no client
        # ever oracles a key whose bundle this thread is swapping mid-cut.
        midcut_key = next(
            f"midcut-key-{i}" for i in range(100000)
            if ring.placement(f"midcut-key-{i}", replicas=1)[0]
            .host_id != victim
            and victim in {s.host_id for s in ring.placement(
                f"midcut-key-{i}", replicas=1)})
        victim_key = sorted(by_owner[victim])[0]

        _pod_wait_up(router)
        # The soak clients (the ledger accumulates across all cycles).
        ledger = _PodLedger(router, bundles, prg, nb, conns=3,
                            seed=args.seed, stride=311, critical=0.4,
                            max_points=32)
        t_soak0 = time.monotonic()
        ledger.start()
        # The cut window must fit several probe ROUNDS even on a loaded
        # host where a healthy shard's ping can take seconds — a window
        # shorter than fail_n rounds cannot demonstrate the DOWN walk,
        # it just measures CPU contention.
        cut_s = max(float(args.duration) / (3 * cycles),
                    6 * args.probe_interval, 10.0)
        down_seen = up_recovered = 0
        promoted_within: list = []
        digest_regressions = 0
        seen_gens: dict = {}
        try:
            for _cycle in range(cycles):
                t0 = time.monotonic()
                # The cut's end is set once the mid-cut registration has
                # been fanned out: cut_s after t0, or later where the
                # DOWN walk and the promotion outlast cut_s on a loaded
                # host — a registration after the heal would reach the
                # victim directly and leave anti-entropy nothing to pull.
                window = [t0, float("inf")]
                handler = faults.partition(
                    {(router.local_tag, victim)}, clock=time.monotonic,
                    window=window)
                with faults.inject("net.partition", handler=handler):
                    # Wait for the prober to mark the victim DOWN.
                    while time.monotonic() < t0 + cut_s:
                        if router.health.state(victim) == DOWN:
                            break
                        time.sleep(0.02)
                    if router.health.state(victim) == DOWN:
                        down_seen += 1
                        t_down = time.monotonic()
                        # Promotion: NORMAL traffic for a victim-owned
                        # key ROUTES to the replica (the submit returning
                        # un-refused IS the promotion — the timed claim
                        # is routing availability, not this host's eval
                        # speed) and serves bit-exact.
                        xs = rng.integers(0, 256, (4, nb), dtype=np.uint8)
                        try:
                            f0 = router.submit(victim_key, xs, b=0)
                            routed_s = time.monotonic() - t_down
                            f1 = router.submit(victim_key, xs, b=1)
                            got = f0.result(120) ^ f1.result(120)
                        except Exception:  # fallback-ok: a missing
                            # promotion fails the promoted_within gate
                            # below — counted, not fatal here
                            got = None
                        if got is not None and np.array_equal(
                                got, _oracle_pair(prg, bundles[victim_key],
                                                  xs)):
                            promoted_within.append(routed_s)
                    # Mint a NEWER generation on the reachable side
                    # mid-cut: the heal must converge it.
                    alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
                    betas = rng.integers(0, 256, (1, lam), dtype=np.uint8)
                    bundles[midcut_key] = dcf.gen(alphas, betas, rng=rng)
                    gens[midcut_key] = router.register_key(
                        midcut_key, bundles[midcut_key])
                    window[1] = max(t0 + cut_s, time.monotonic())
                    while time.monotonic() < window[1]:
                        time.sleep(0.05)
                # Healed: the prober must re-admit through the
                # anti-entropy gate.
                deadline = time.monotonic() + 60
                while router.health.state(victim) != UP:
                    if time.monotonic() > deadline:
                        break
                    time.sleep(0.05)
                if router.health.state(victim) == UP:
                    up_recovered += 1
                digest = _pod_wire_digest(addr_of[victim], nb)
                for k, g in digest.items():
                    if g < seen_gens.get(k, 0):
                        digest_regressions += 1
                    seen_gens[k] = max(g, seen_gens.get(k, 0))
        finally:
            stats = ledger.stop(60)
        soak_wall_s = time.monotonic() - t_soak0

        # Convergence: the victim holds the owners' generations for
        # every key the ring places on it.
        digest = _pod_wire_digest(addr_of[victim], nb)
        converged = all(
            digest.get(n) == gens[n] for n in sorted(bundles)
            if victim in {s.host_id
                          for s in ring.placement(n, replicas=1)})
        # The fence: a doctored OLD-generation frame at the victim.
        alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
        betas = rng.integers(0, 256, (1, lam), dtype=np.uint8)
        doctored = dcf.gen(alphas, betas, rng=rng)
        fence_held = False
        with EdgeClient(*addr_of[victim], n_bytes=nb) as c:
            try:
                c.register_frame(victim_key, doctored.to_bytes(),
                                 generation=gens[victim_key])
            except StaleStateError:
                fence_held = True
        xs_post = rng.integers(0, 256, (16, nb), dtype=np.uint8)
        post_parity = bool(np.array_equal(
            _routed_pair(router, victim_key, xs_post),
            _oracle_pair(prg, bundles[victim_key], xs_post)))
        log(f"soak: {stats}; down_seen={down_seen}/{cycles} "
            f"up_recovered={up_recovered}/{cycles} "
            f"converged={converged} fence_held={fence_held}")

        rsnap = router.metrics_snapshot()
        # The denominator is the MEASURED soak wall time (cut windows
        # + heal waits), not --duration: the cut floor and the gated
        # re-admission stretch the run, and sessions/s must not be
        # inflated by a denominator the soak outlived.
        rate = stats["sessions_ok"] / max(soak_wall_s, 1e-9)
        extra = {
            "mode": mode,
            "shards": n_shards,
            "bundles": n_bundles,
            "live_bundles": len(live),
            "cycles": cycles,
            "cut_s": round(cut_s, 3),
            "soak_wall_s": round(soak_wall_s, 3),
            "probe_interval_s": args.probe_interval,
            **_ledger_fields(stats),
            "down_seen": down_seen,
            "up_recovered": up_recovered,
            "promoted_serve_s": [round(s, 3) for s in promoted_within],
            "digest_converged": converged,
            "digest_regressions": digest_regressions,
            "fence_held": fence_held,
            "post_heal_parity": post_parity,
            "anti_entropy_runs": rsnap.get(
                "router_anti_entropy_runs_total", 0),
            "anti_entropy_frames": rsnap.get(
                "router_anti_entropy_frames_total", 0),
            "promoted_forwards": rsnap.get(
                "router_promoted_forwards_total", 0),
        }
        _pod_line(args, dcf.device, backend, "sessions_per_sec", rate,
                  f"sessions/s ({mode} soak, two-party, mixed priority)",
                  extra, f"--{mode} --shards {n_shards} "
                  f"--duration {float(args.duration):g} "
                  f"--bundles {n_bundles} "
                  f"--live-bundles {args.live_bundles}")

        failures = _ledger_gates(stats, min_sessions=3)
        if down_seen < cycles:
            failures.append(
                f"prober marked the victim DOWN in only {down_seen} "
                f"of {cycles} cut windows")
        if up_recovered < cycles:
            failures.append(
                f"victim re-admitted UP after only {up_recovered} of "
                f"{cycles} heals")
        if len(promoted_within) < down_seen:
            failures.append(
                "a victim-owned key did not serve NORMAL traffic from "
                "its promoted replica during a cut window")
        elif promoted_within and max(promoted_within) > max(
                args.probe_interval, 1.0) + 2.0:
            failures.append(
                f"promoted replica took {max(promoted_within):.2f}s "
                "after DOWN (> one probe interval + slack)")
        if not converged:
            failures.append(
                "the victim's digest did not converge to the owners' "
                "generations after the heal")
        if digest_regressions:
            failures.append(
                f"{digest_regressions} generation regressions across "
                "cycles")
        if not fence_held:
            failures.append(
                "a doctored old-generation frame was NOT fenced")
        if not post_parity:
            failures.append(
                "the fenced key stopped serving the newer bits")
        if extra["anti_entropy_runs"] < cycles:
            failures.append(
                f"anti-entropy ran only {extra['anti_entropy_runs']} "
                f"times for {cycles} heals")
        if extra["anti_entropy_frames"] < cycles:
            failures.append(
                f"anti-entropy pulled only "
                f"{extra['anti_entropy_frames']} frames — the mid-cut "
                f"registration ({midcut_key}) did not converge "
                "through the digest exchange")
        if failures:
            raise SystemExit("pod_bench: " + "; ".join(failures))
    finally:
        _pod_teardown([router], procs, root, keep_dirs)


def bench_pod_churn(args) -> None:
    """``pod_bench --churn`` (``dcf_tpu/cli.py:4005-4521``): the
    autonomous-membership scenario — kill -> auto-eject -> re-replication
    verified -> heal -> graceful re-join, plus a drain leg, under
    3-thread mixed load with the ledger running throughout.

    Phases:

    1. **provision + spawn** — durable keys ring-placed into owner +
       replica stores (``KeyStore.replicate_to``), live keys through
       the REGISTER fan-out, N ``serve_host`` subprocesses behind the
       self-healing router with a ``MembershipController`` owning the
       ring (``stores`` handed over for the durable migration half);
    2. **kill -> auto-eject** — one shard SIGKILLed; the prober walks
       it DOWN, the controller waits out ``--eject-grace`` and ejects:
       the ring shrinks, the epoch bumps, and every key the victim
       held is re-replicated to its new placement BEFORE the commit —
       verified over the wire DIGEST verb (live registries) and the
       stores (durable frames), generations preserved;
    3. **heal -> graceful re-join** — the victim process is respawned
       on its own store (warm restore) and re-admitted via
       ``controller.join``: warmed through the anti-entropy SYNC path
       against the prospective ring first, the epoch bumps again, and
       its digest converges before the first routed request lands;
    4. **drain** — a second shard is gracefully decommissioned:
       frames migrated, ring swapped (epoch bump), in-flight grace
       held, then the process SIGTERMed — which DRAINS and exits 0
       with its ready file removed;
    5. **the epoch fence** — a doctored STALE-epoch REQUEST frame
       sent straight to a shard dies typed ``E_EPOCH`` with a retry
       hint, and the key keeps serving the CURRENT ring's bits.

    Emitted-then-asserted gates: ledger clean (every request bit-exact
    vs the numpy oracle or refused typed WITH ``retry_after_s``), zero
    generation regressions across every observed digest, zero lost
    keys (every key still serves bit-exact after all three changes),
    eject/join/drain all committed with strictly-increasing epochs,
    the stale-epoch frame fenced, zero quarantines, and the drained
    shard exited 0."""
    import os
    import signal
    import socket as socket_mod
    import struct as struct_mod

    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.serve import (
        EdgeClient,
        MembershipController,
        ShardSpec,
    )
    from dcf_tpu_torch.serve.edge import (
        E_EPOCH,
        decode_response,
        encode_request,
    )

    n_shards = args.shards
    if n_shards < 3:
        raise SystemExit(
            f"--churn needs --shards >= 3 (the auto-eject must leave "
            f"a replicated ring), got {n_shards}")
    if args.probe_interval <= 0:
        raise SystemExit(
            f"--probe-interval must be > 0, got {args.probe_interval}")
    if args.eject_grace <= 0:
        raise SystemExit(
            f"--eject-grace must be > 0, got {args.eject_grace}")
    if args.live_bundles < 0:
        raise SystemExit(
            f"--live-bundles must be >= 0, got {args.live_bundles}")
    dcf, lam, nb, backend, rng = _serve_host_facade(args)
    prg = HirosePrgNp(lam, dcf.cipher_keys)
    n_bundles = args.bundles or 4

    root, keep_dirs = _pod_root(args)
    shard_ids = [f"shard-{i}" for i in range(n_shards)]
    ring, stores, bundles, gens = _pod_provision(
        dcf, lam, nb, rng, root, shard_ids, n_bundles)
    procs: dict = {}
    router = None
    controller = None
    try:
        for tag in shard_ids:
            procs[tag] = _pod_spawn(tag, os.path.join(root, tag),
                                    root, args)
        ready = _pod_wait_ready(procs)
        pod_specs, addr_of = _pod_specs(ready, shard_ids)
        router = _pod_router(pod_specs, nb, args.probe_interval)
        controller = MembershipController(
            router, stores=stores,
            eject_grace_s=float(args.eject_grace),
            drain_grace_s=1.0, min_hosts=2,
            poll_interval_s=min(args.probe_interval, 0.25))
        live, live_gens = _pod_live_register(
            router, dcf, rng, lam, nb, args.live_bundles)
        bundles.update(live)
        gens.update(live_gens)
        log(f"provisioned {n_bundles} durable + {len(live)} live keys "
            f"over {n_shards} shards")

        # Parity gate + warmup ladder (the soak must measure churn, not
        # a shard's first staging of a shape).
        xs_gate = rng.integers(0, 256, (64, nb), dtype=np.uint8)
        _pod_parity_gate(router, bundles, prg, xs_gate)
        by_owner = _group_by_owner(ring, bundles)
        max_batch = args.max_batch or (1 << 10)
        _pod_warmup(rng, nb, max_batch,
                    [(router, [keys[0] for keys in by_owner.values()])])
        log("routed parity + warmup ladder done")

        _pod_wait_up(router)
        controller.start()

        # The ledger (accumulates across every phase).
        ledger = _PodLedger(router, bundles, prg, nb, conns=3,
                            seed=args.seed, stride=401, critical=0.4,
                            max_points=32)
        t_soak0 = time.monotonic()
        ledger.start()

        seen_gens: dict = {}
        digest_regressions = 0

        def absorb_digest(digest: dict) -> None:
            nonlocal digest_regressions
            for k, g in digest.items():
                if g < seen_gens.get(k, 0):
                    digest_regressions += 1
                seen_gens[k] = max(g, seen_gens.get(k, 0))

        failures: list = []
        # ---- Phase 2: kill -> auto-eject ----------------------------
        victim = max(by_owner, key=lambda s: (
            len([n for n in by_owner[s] if n in live]),
            len(by_owner[s])))
        victim_keys = sorted(
            n for n in bundles
            if victim in ring.placement_ids(n, replicas=1))
        log(f"SIGKILL {victim} (holds {len(victim_keys)} keys); "
            f"auto-eject after {args.eject_grace:g}s of DOWN")
        procs[victim][0].send_signal(signal.SIGKILL)
        procs[victim][0].wait(30)  # reap before the respawn reuses
        # the procs slot (a SIGKILLed child exits immediately)
        deadline = time.monotonic() + 120
        while victim in router.map:
            if time.monotonic() > deadline:
                raise SystemExit(
                    "pod_bench: the controller never auto-ejected the "
                    f"killed shard (health={router.health.states()}, "
                    f"ring={router.map.host_ids()})")
            time.sleep(0.05)
        epoch_after_eject = router.ring_epoch
        eject_ring = router.map
        if epoch_after_eject < 1:
            failures.append("eject committed without an epoch bump")
        # Re-replication verified: every key the victim held is now
        # placed wholly on survivors — live registries over the wire
        # DIGEST verb, durable frames in the stores.
        survivor_digests = {s: _pod_wire_digest(addr_of[s], nb)
                            for s in eject_ring.host_ids()}
        for d in survivor_digests.values():
            absorb_digest(d)
        for name in victim_keys:
            for holder in eject_ring.placement_ids(name, replicas=1):
                if survivor_digests[holder].get(name) != gens[name]:
                    failures.append(
                        f"post-eject holder {holder} serves "
                        f"{name!r} at generation "
                        f"{survivor_digests[holder].get(name)} "
                        f"!= provisioned {gens[name]}")
                if name not in live \
                        and stores[holder].digest().get(name) \
                        != gens[name]:
                    failures.append(
                        f"post-eject store {holder} lacks durable "
                        f"{name!r} at generation {gens[name]}")
        lost = controller.lost_keys(exclude={victim})
        if lost:
            failures.append(f"keys lost after eject: {lost}")
        log(f"auto-eject OK: ring={eject_ring.host_ids()} "
            f"epoch={epoch_after_eject}")

        # ---- Phase 3: heal -> graceful re-join ----------------------
        try:
            os.unlink(procs[victim][1])  # the SIGKILL left the stale
            # ready file behind; the respawn must publish a fresh one
        except OSError:
            pass  # fallback-ok: already gone
        procs[victim] = _pod_spawn(victim, os.path.join(root, victim),
                                   root, args)
        rejoin_ready = _pod_wait_ready({victim: procs[victim]})
        spec = ShardSpec(victim, rejoin_ready[victim]["host"],
                         rejoin_ready[victim]["port"])
        addr_of[victim] = spec.address
        controller.join(spec)
        epoch_after_join = router.ring_epoch
        if epoch_after_join <= epoch_after_eject:
            failures.append("join committed without an epoch bump")
        if victim not in router.map:
            failures.append("join did not admit the healed shard")
        # Warmed-before-admitted: the rejoined shard's digest holds
        # every key the ring places on it, generations preserved.
        victim_digest = _pod_wire_digest(addr_of[victim], nb)
        absorb_digest(victim_digest)
        for name in sorted(bundles):
            placed = router.map.placement_ids(name, replicas=1)
            if victim in placed \
                    and victim_digest.get(name) != gens[name]:
                failures.append(
                    f"rejoined shard serves {name!r} at generation "
                    f"{victim_digest.get(name)} != {gens[name]}")
        log(f"graceful re-join OK: epoch={epoch_after_join}")

        # ---- Phase 4: drain ----------------------------------------
        drain_host = next(s for s in router.map.host_ids()
                          if s != victim)
        controller.drain(drain_host)
        epoch_after_drain = router.ring_epoch
        if epoch_after_drain <= epoch_after_join:
            failures.append("drain committed without an epoch bump")
        if drain_host in router.map:
            failures.append("drain left the host in the ring")
        deadline = time.monotonic() + 60
        while drain_host in controller.draining():
            if time.monotonic() > deadline:
                failures.append(
                    "the drain grace never completed (forget pending)")
                break
            time.sleep(0.05)
        drain_digests = {s: _pod_wire_digest(addr_of[s], nb)
                         for s in router.map.host_ids()}
        for d in drain_digests.values():
            absorb_digest(d)
        for name in sorted(bundles):
            for holder in router.map.placement_ids(name, replicas=1):
                if drain_digests[holder].get(name) != gens[name]:
                    failures.append(
                        f"post-drain holder {holder} serves {name!r} "
                        f"at {drain_digests[holder].get(name)} != "
                        f"{gens[name]}")
        lost = controller.lost_keys(exclude={drain_host})
        if lost:
            failures.append(f"keys lost after drain: {lost}")
        # The drained process: SIGTERM DRAINS and exits 0 with the ready
        # file removed (the graceful shutdown).
        procs[drain_host][0].send_signal(signal.SIGTERM)
        try:
            rc = procs[drain_host][0].wait(60)
        except Exception:  # fallback-ok: counted via the gate below
            rc = None
        if rc != 0:
            failures.append(
                f"drained shard exited rc={rc} on SIGTERM (graceful "
                "shutdown must exit 0)")
        if os.path.exists(procs[drain_host][1]):
            failures.append(
                "drained shard left its ready file behind")
        log(f"drain OK: ring={router.map.host_ids()} "
            f"epoch={epoch_after_drain} drained-exit rc={rc}")

        # ---- Phase 5: the epoch fence ------------------------------
        fence_target = router.map.host_ids()[0]
        # Make sure the target has adopted the CURRENT epoch (probes
        # disseminate it; one fenced ping is deterministic).
        with EdgeClient(*addr_of[fence_target], n_bytes=nb) as c:
            shard_epoch = c.ping_epoch(timeout=60,
                                       epoch=router.ring_epoch)
        stale = max(router.ring_epoch - 1, 1)
        fence_key = next(n for n in sorted(bundles)
                         if router.map.owner(n).host_id == fence_target)
        xs_f = rng.integers(0, 256, (4, nb), dtype=np.uint8)
        doctored = encode_request(991, "", fence_key, 0, 255, None,
                                  xs_f.data, nb, 4, epoch=stale)
        s = socket_mod.create_connection(addr_of[fence_target], timeout=60)
        try:
            s.sendall(doctored)
            s.shutdown(socket_mod.SHUT_WR)
            s.settimeout(60)
            data = b""
            while True:
                try:
                    chunk = s.recv(1 << 16)
                except OSError:
                    break
                if not chunk:
                    break
                data += chunk
        finally:
            s.close()
        fence_held = False
        off = 0
        while off < len(data):
            (blen,) = struct_mod.unpack_from("<I", data, off)
            decoded = decode_response(data[off + 4:off + 4 + blen])
            if decoded[0] == "error" and decoded[2] == E_EPOCH \
                    and decoded[3] is not None:
                fence_held = True
            off += 4 + blen
        if shard_epoch != router.ring_epoch:
            failures.append(
                f"shard epoch {shard_epoch} never converged to the "
                f"ring epoch {router.ring_epoch}")
        if not fence_held:
            failures.append(
                "a doctored stale-epoch frame was NOT refused E_EPOCH "
                "with a retry hint")
        # ...and the key keeps serving the CURRENT ring's bits.
        post_parity = bool(np.array_equal(
            _routed_pair(router, fence_key, xs_f),
            _oracle_pair(prg, bundles[fence_key], xs_f)))
        if not post_parity:
            failures.append(
                "the fenced key stopped serving the current ring's "
                "bits")

        stats = ledger.stop(60)
        soak_wall_s = time.monotonic() - t_soak0

        # Zero lost keys, globally: every key still serves bit-exact on
        # the final two-host ring.
        xs_post = rng.integers(0, 256, (8, nb), dtype=np.uint8)
        want = _oracle_pairs(prg, bundles, xs_post)
        for name in sorted(bundles):
            if not np.array_equal(_routed_pair(router, name, xs_post),
                                  want[name]):
                failures.append(
                    f"{name!r} no longer serves bit-exact after the "
                    "churn (lost or rolled back)")
        metric_files = [procs[s][2] for s in shard_ids]
        time.sleep(1.2)
        roll = _pod_rollup(metric_files)
        quarantined = roll.get("serve_store_quarantined_total", 0)
        kinds = [e.kind for e in controller.events()]

        rsnap = router.metrics_snapshot()
        rate = stats["sessions_ok"] / max(soak_wall_s, 1e-9)
        extra = {
            "mode": "churn",
            "shards": n_shards,
            "bundles": n_bundles,
            "live_bundles": len(live),
            "eject_grace_s": float(args.eject_grace),
            "probe_interval_s": args.probe_interval,
            "soak_wall_s": round(soak_wall_s, 3),
            **_ledger_fields(stats),
            "epochs": [epoch_after_eject, epoch_after_join,
                       epoch_after_drain],
            "membership_events": kinds,
            "digest_regressions": digest_regressions,
            "fence_held": fence_held,
            "post_fence_parity": post_parity,
            "drained_exit_rc": rc,
            "migrated_frames": rsnap.get(
                "membership_migrated_frames_total", 0),
            "durable_replications": rsnap.get(
                "membership_durable_replications_total", 0),
            "lost_keys": rsnap.get("membership_lost_keys_total", 0),
            "pod_quarantined": quarantined,
        }
        _pod_line(args, dcf.device, backend, "sessions_per_sec", rate,
                  "sessions/s (churn soak, two-party, mixed priority)",
                  extra, f"--churn --shards {n_shards} "
                  f"--bundles {n_bundles} "
                  f"--live-bundles {args.live_bundles} "
                  f"--eject-grace {float(args.eject_grace):g}")

        failures += _ledger_gates(stats, min_sessions=3)
        if digest_regressions:
            failures.append(
                f"{digest_regressions} generation regressions across "
                "the churn")
        for want_kind in ("eject", "join", "drain", "drain-complete"):
            if want_kind not in kinds:
                failures.append(
                    f"no {want_kind!r} membership event was committed")
        if quarantined:
            failures.append(
                f"{quarantined} frames quarantined across the pod")
        if failures:
            raise SystemExit("pod_bench: " + "; ".join(failures))
    finally:
        _pod_teardown([controller, router], procs, root, keep_dirs)


def bench_pod_surge(args) -> None:
    """``pod_bench --surge`` (``dcf_tpu/cli.py:4522-5027``): the
    demand-driven autoscaling scenario — a Zipf-skewed open-loop RAMP
    schedule drives the pod into sustained pressure, the
    ``CapacityController`` admits a ``serve_host --standby`` process
    through the graceful join within the reaction bound, the post-surge
    idle window drains the least-loaded host back to standby, and a
    scripted oscillating-load leg (the ``capacity.decide`` seam) is
    pinned to ZERO ring churn.

    Phases:

    1. **provision + spawn** — durable keys ring-placed into the
       ``--shards`` ring stores; ``--standby-hosts`` extra
       ``serve_host --standby`` processes come up provisioned-but-idle
       (no restore: the join's warm-before-admit ships keys when — if
       — demand admits them); every shard takes a SMALL admission
       bound (``--max-queued-points``, default 4096 here) so overload
       becomes visible demand within the bench window;
    2. **surge** — a seeded open-loop ramp (``ramp up -> hold at a
       multiple of the calibrated closed-loop capacity -> fall
       quiet``) with Zipf key skew and a deadline on every request,
       while the main thread pumps the capacity controller on the
       injectable-clock tick (the deterministic driving mode — the
       same controller the ``start()`` worker would tick);
    3. **scale-out** — sustained pressure (queue fraction / brownout /
       shed deltas, aggregated via the metrics-rollup path) must admit
       a standby host within ``--reaction-bound`` seconds of the ramp
       start: epoch-fenced join, warm-before-admit;
    4. **scale-in** — the post-surge idle streak must drain the
       least-loaded host back to the standby pool (durable migration,
       deferred forget) once the cooldown clears;
    5. **oscillation** — a seam handler forces
       pressure/idle/pressure/idle... verdicts inside the hysteresis
       windows: the ring epoch must not move and zero scaling events
       may commit (the flap-damping acceptance).

    Emitted-then-asserted gates: scale-out within the reaction bound,
    scale-in committed (ring back to ``--shards``, standby pool
    refilled), zero lost keys, zero generation regressions across
    every observed digest, post-shrink two-party parity vs the numpy
    oracle on EVERY key, zero CRITICAL sheds across the pod rollup,
    strictly-increasing epochs across the scaling events, and the
    oscillation leg's zero-churn pin."""
    import os
    import threading

    from dcf_tpu_torch.errors import DcfError
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.serve import (
        CapacityController,
        KeyStore,
        MembershipController,
        ShardSpec,
    )
    from dcf_tpu_torch.serve.capacity import IDLE, PRESSURE, ForcedVerdict
    from dcf_tpu_torch.serve.loadgen import closed_loop, open_loop_ramp
    from dcf_tpu_torch.serve.metrics import labeled
    from dcf_tpu_torch.testing import faults

    n_shards = args.shards
    if n_shards < 2:
        raise SystemExit(
            f"--surge needs --shards >= 2 (scale-in must leave a "
            f"replicated ring), got {n_shards}")
    if args.standby_hosts < 1:
        raise SystemExit(
            f"--standby-hosts must be >= 1 (a surge with nothing to "
            f"admit gates nothing), got {args.standby_hosts}")
    if args.probe_interval <= 0:
        raise SystemExit(
            f"--probe-interval must be > 0, got {args.probe_interval}")
    if args.reaction_bound <= 0:
        raise SystemExit(
            f"--reaction-bound must be > 0, got {args.reaction_bound}")
    _pod_backend(args)
    n_bundles = args.bundles or 4
    n_standby = args.standby_hosts
    max_batch = args.max_batch or (1 << 10)
    min_req = args.min_req_points or (max_batch * 3 // 8)
    max_req = args.max_req_points or (max_batch // 2)
    if not 1 <= min_req <= max_req:
        raise SystemExit(
            f"bad request-size range [{min_req}, {max_req}]")
    qbound = args.max_queued_points or 4096
    skew = _parse_skew(args.skew) or 1.0
    dcf, lam, nb, backend, rng = _serve_host_facade(args)
    prg = HirosePrgNp(lam, dcf.cipher_keys)

    root, keep_dirs = _pod_root(args)
    shard_ids = [f"shard-{i}" for i in range(n_shards)]
    standby_ids = [f"standby-{i}" for i in range(n_standby)]
    ring, stores, bundles, gens = _pod_provision(
        dcf, lam, nb, rng, root, shard_ids, n_bundles)
    for tag in standby_ids:
        # Provisioned-but-empty: the graceful join's warm-before-admit
        # migration fills it IF demand ever admits the host.
        stores[tag] = KeyStore(os.path.join(root, tag))
    procs: dict = {}
    router = None
    mc = None
    cap = None
    try:
        qflags = ["--max-queued-points", str(qbound)]
        for tag in shard_ids:
            procs[tag] = _pod_spawn(tag, os.path.join(root, tag),
                                    root, args, extra=qflags)
        for tag in standby_ids:
            procs[tag] = _pod_spawn(tag, os.path.join(root, tag),
                                    root, args, standby=True,
                                    extra=qflags)
        ready = _pod_wait_ready(procs)
        for tag in standby_ids:
            if not ready[tag].get("standby") \
                    or ready[tag].get("restored"):
                raise SystemExit(
                    f"pod_bench: {tag} did not come up as an empty "
                    f"standby host ({ready[tag]})")
        pod_specs, addr_of = _pod_specs(ready, [*shard_ids, *standby_ids])
        # Condemnation-tolerant prober: the surge INTENDS to starve the
        # shards, and a shard walked DOWN mid-overload both kills the
        # demand signal (the router refuses its traffic) and trips the
        # eject_inflight rail — the scenario under test is capacity,
        # not death detection (that's --churn).
        router = _pod_router(pod_specs[:n_shards], nb, args.probe_interval,
                             probe_timeout_s=10.0, probe_fail_n=6,
                             probe_recover_m=1)
        mc = MembershipController(
            router, stores=stores,
            eject_grace_s=float(args.eject_grace),
            drain_grace_s=0.5, min_hosts=2,
            poll_interval_s=min(args.probe_interval, 0.25))
        tick = max(args.probe_interval, 0.25)
        cap = CapacityController(
            router, mc,
            standby=[(ShardSpec(t, *addr_of[t]), stores[t])
                     for t in standby_ids],
            interval_s=tick, scale_out_n=2, scale_in_m=3,
            cooldown_s=max(2 * tick, 1.0),
            min_hosts=n_shards, max_hosts=n_shards + n_standby,
            queue_pressure_fraction=0.5, queue_idle_fraction=0.05)
        log(f"pod up: ring={n_shards} standby={n_standby} "
            f"queue-bound={qbound} pts; capacity tick={tick:g}s "
            f"n={cap.scale_out_n} m={cap.scale_in_m} "
            f"cooldown={cap.cooldown_s:g}s")

        # Parity gate + warmup ladder (the surge must measure the
        # controller, not a shard's first staging of a shape).
        xs_gate = rng.integers(0, 256, (64, nb), dtype=np.uint8)
        _pod_parity_gate(router, bundles, prg, xs_gate)
        by_owner = _group_by_owner(ring, bundles)
        _pod_warmup(rng, nb, max_batch,
                    [(router, [keys[0] for keys in by_owner.values()])])
        _pod_wait_up(router)
        log("routed parity + warmup ladder done; prober UP")

        # Calibrate the pod's closed-loop capacity, then shape the
        # surge: ramp to 1.5x, hold at 2.5x (sustained pressure against
        # the small admission bound), fall quiet.
        cal = closed_loop(router, sorted(bundles),
                          duration_s=2.0, concurrency=args.concurrency,
                          min_points=min_req, max_points=max_req,
                          seed=args.seed + 3)
        base_rps = max(cal.requests_ok / max(cal.duration_s, 1e-9), 2.0)
        ramp_s = max(float(args.duration) / 5, 3.0)
        hold_s = max(float(args.duration) / 2, 6.0)
        segments = [(ramp_s, 1.5 * base_rps), (hold_s, 2.5 * base_rps),
                    (max(float(args.duration) / 6, 2.0), 0.0)]
        log(f"calibrated {base_rps:,.1f} req/s closed-loop; surge "
            f"schedule {[(round(d, 1), round(r, 1)) for d, r in segments]}")

        ramp_res: dict = {}

        def offer() -> None:
            # NORMAL/BATCH carry the overload: a CRITICAL request is
            # only ever shed when the queue holds too few lower-class
            # points to evict, so the zero-CRITICAL-shed gate is
            # exercised by the dedicated heartbeat stream below, not
            # by drowning CRITICAL in its own flood.
            ramp_res["res"] = open_loop_ramp(
                router, sorted(bundles), segments=segments,
                min_points=min_req, max_points=max_req,
                seed=args.seed + 17, skew=skew, deadline_ms=2000.0,
                priority_mix={"normal": 0.65, "batch": 0.35})

        ramp_thread = threading.Thread(target=offer, daemon=True,
                                       name="surge-ramp")
        cap_events: list = []
        hb_keys = sorted(bundles)
        hb_rng = np.random.default_rng(args.seed + 29)
        hb_futs: list = []
        hb_i = 0
        hb_refused_hinted = hb_refused_unhinted = 0
        t_surge0 = time.monotonic()
        ramp_thread.start()
        t_out = t_in = None
        # The elastic cycle: pump the controller (and the membership
        # poller) on the tick until the surge scaled out, the idle
        # window scaled back in, and the drain grace completed.
        cycle_deadline = t_surge0 + sum(d for d, _r in segments) + 240
        while time.monotonic() < cycle_deadline:
            cap.pump()
            mc.pump()
            cap_events += cap.events()
            if ramp_thread.is_alive():
                # The CRITICAL heartbeat: one small two-party session
                # per tick MUST ride out the surge — eviction clears
                # lower-class room for it, never the other way around.
                name = hb_keys[hb_i % len(hb_keys)]
                hb_i += 1
                xs_hb = hb_rng.integers(0, 256, (8, nb), dtype=np.uint8)
                try:
                    f0 = router.submit(name, xs_hb, b=0,
                                       priority="critical")
                    f1 = router.submit(name, xs_hb, b=1,
                                       priority="critical")
                    hb_futs.append((name, xs_hb, f0, f1))
                except DcfError as e:
                    if getattr(e, "retry_after_s", None) is not None:
                        hb_refused_hinted += 1
                    else:
                        hb_refused_unhinted += 1
            now = time.monotonic()
            if t_out is None and any(e.kind == "scale-out"
                                     for e in cap_events):
                t_out = now
                log(f"scale-out committed {now - t_surge0:,.1f}s into "
                    f"the surge (ring={router.map.host_ids()})")
            if t_in is None and any(e.kind == "scale-in"
                                    for e in cap_events):
                t_in = now
                log(f"scale-in committed {now - t_surge0:,.1f}s in "
                    f"(ring={router.map.host_ids()})")
            if t_out is not None and t_in is not None \
                    and not ramp_thread.is_alive() \
                    and not mc.draining():
                break
            time.sleep(tick)
        ramp_thread.join()
        res = ramp_res.get("res")
        if res is None:
            raise SystemExit("pod_bench: the surge schedule never "
                             "completed")
        cap_events += cap.events()
        reaction_s = (t_out - t_surge0) if t_out is not None else None
        drained_ids = {e.host_id for e in cap_events
                       if e.kind == "scale-in"}

        failures: list = []
        # Collect the CRITICAL heartbeats: every accepted one must
        # complete bit-exact vs the oracle, or fail typed WITH a hint
        # (a membership swap mid-flight is a hinted refusal, not a
        # loss); anything untyped fails the gate.
        hb_ok = hb_unaccounted = 0
        # One oracle walk a party over every heartbeat's points (the
        # stacked keys at the concatenated points): heartbeat i is key
        # name's row at points [8 i, 8 i + 8).
        hb_want = _oracle_pairs(
            prg, bundles, np.concatenate([h[1] for h in hb_futs])) \
            if hb_futs else {}
        for i, (name, xs_hb, f0, f1) in enumerate(hb_futs):
            try:
                got = f0.result(120) ^ f1.result(120)
            except DcfError as e:
                if getattr(e, "retry_after_s", None) is not None:
                    hb_refused_hinted += 1
                else:
                    hb_refused_unhinted += 1
                continue
            except Exception:  # fallback-ok: the gate's failure arm —
                # an untyped CRITICAL loss is what the stream hunts
                hb_unaccounted += 1
                continue
            if np.array_equal(got, hb_want[name][:, 8 * i:8 * i + 8]):
                hb_ok += 1
            else:
                hb_unaccounted += 1
        # Zero generation regressions + every placed holder serves the
        # provisioned generation, over the wire DIGEST verb.
        seen_gens = dict(gens)
        digest_regressions = 0
        for host_id in router.map.host_ids():
            digest = _pod_wire_digest(addr_of[host_id], nb)
            for k, g in digest.items():
                if g < seen_gens.get(k, 0):
                    digest_regressions += 1
                seen_gens[k] = max(g, seen_gens.get(k, 0))
            for name in sorted(bundles):
                if host_id in router.map.placement_ids(
                        name, replicas=1) \
                        and digest.get(name) != gens[name]:
                    failures.append(
                        f"post-cycle holder {host_id} serves {name!r} "
                        f"at generation {digest.get(name)} != "
                        f"provisioned {gens[name]}")
        lost = mc.lost_keys(exclude=drained_ids)

        # The oscillation leg: scripted pressure/idle flapping inside
        # the hysteresis windows must produce ZERO ring churn.
        osc_epoch0 = router.ring_epoch
        osc_n = {"n": 0}

        def osc(kind, verdict) -> None:
            osc_n["n"] += 1
            raise ForcedVerdict(PRESSURE if osc_n["n"] % 2 else IDLE)

        osc_ticks = 4 * max(cap.scale_out_n, cap.scale_in_m)
        with faults.inject("capacity.decide", handler=osc):
            for _ in range(osc_ticks):
                cap.pump()
        osc_events = cap.events()
        osc_epoch_moved = router.ring_epoch != osc_epoch0

        # Post-shrink parity: EVERY key, both parties, vs the oracle.
        xs_post = rng.integers(0, 256, (8, nb), dtype=np.uint8)
        post_parity = True
        want = _oracle_pairs(prg, bundles, xs_post)
        for name in sorted(bundles):
            if not np.array_equal(_routed_pair(router, name, xs_post),
                                  want[name]):
                post_parity = False
                failures.append(
                    f"{name!r} no longer serves bit-exact after the "
                    "elastic cycle (lost or rolled back)")
        metric_files = [procs[t][2] for t in [*shard_ids, *standby_ids]]
        time.sleep(1.2)
        roll = _pod_rollup(metric_files)
        critical_shed = roll.get(labeled(
            "serve_shed_by_class_total", priority="critical"), 0)

        rsnap = router.metrics_snapshot()
        epochs = [e.epoch for e in cap_events]
        rate = res.points_ok / max(res.duration_s, 1e-9)
        extra = {
            "mode": "surge",
            "shards": n_shards,
            "standby_hosts": n_standby,
            "bundles": n_bundles,
            "max_queued_points": qbound,
            "skew": skew,
            "calibrated_rps": round(base_rps, 1),
            "segments": [[round(d, 2), round(r, 1)]
                         for d, r in segments],
            "offered_rps": round(res.offered_rps, 1),
            "sent": res.sent,
            "ok": res.ok,
            "shed": res.shed,
            "expired": res.expired,
            "failed": res.failed,
            "reaction_s": (None if reaction_s is None
                           else round(reaction_s, 2)),
            "reaction_bound_s": float(args.reaction_bound),
            "capacity_events": [[e.kind, e.host_id, e.epoch]
                                for e in cap_events],
            "epochs": epochs,
            "final_ring": router.map.host_ids(),
            "standby_after": cap.standby(),
            "osc_ticks": osc_ticks,
            "osc_events": len(osc_events),
            "osc_epoch_moved": osc_epoch_moved,
            "digest_regressions": digest_regressions,
            "lost_keys": len(lost),
            "post_shrink_parity": post_parity,
            "pod_critical_shed": critical_shed,
            "critical_hb_ok": hb_ok,
            "critical_hb_refused_hinted": hb_refused_hinted,
            "critical_hb_refused_unhinted": hb_refused_unhinted,
            "critical_hb_unaccounted": hb_unaccounted,
            "capacity_skips": {
                k.split("reason=", 1)[1].rstrip("}"): v
                for k, v in rsnap.items()
                if k.startswith("capacity_skips_total{")},
            "scale_failures": rsnap.get(
                "capacity_scale_failures_total", 0),
            "probe_interval_s": args.probe_interval,
        }
        _pod_line(args, dcf.device, backend, "evals_per_sec", rate,
                  "evals/s (open-loop Zipf surge through the pod router, "
                  "party 0)", extra,
                  f"--surge --shards {n_shards} "
                  f"--standby-hosts {n_standby} --bundles {n_bundles} "
                  f"--duration {float(args.duration):g}")

        # Emitted-then-asserted, chaos_bench style.
        if t_out is None:
            failures.append(
                "sustained pressure never admitted a standby host "
                f"(skips={extra['capacity_skips']})")
        elif reaction_s > float(args.reaction_bound):
            failures.append(
                f"scale-out took {reaction_s:.1f}s from the ramp "
                f"start (> the {float(args.reaction_bound):g}s "
                "reaction bound)")
        if t_in is None:
            failures.append(
                "the post-surge idle window never drained a host "
                "back to standby")
        if len(router.map) != n_shards:
            failures.append(
                f"the ring ended at {len(router.map)} hosts, not the "
                f"{n_shards} it started with")
        if len(cap.standby()) != n_standby:
            failures.append(
                f"the standby pool ended at {cap.standby()}, not "
                f"{n_standby} host(s)")
        if any(b <= a for a, b in zip(epochs, epochs[1:])):
            failures.append(
                f"scaling epochs not strictly increasing: {epochs}")
        if lost:
            failures.append(f"keys lost across the cycle: {lost}")
        if digest_regressions:
            failures.append(
                f"{digest_regressions} generation regressions across "
                "the cycle")
        if critical_shed:
            failures.append(
                f"{critical_shed} CRITICAL sheds across the pod "
                "(CRITICAL must ride out a surge)")
        if hb_ok < 1 or hb_unaccounted or hb_refused_unhinted:
            failures.append(
                f"CRITICAL heartbeat stream not clean through the "
                f"surge: {hb_ok} bit-exact, {hb_unaccounted} "
                f"unaccounted, {hb_refused_unhinted} refusals without "
                "retry_after_s")
        if osc_events or osc_epoch_moved:
            failures.append(
                f"the oscillating-load leg moved the ring: "
                f"{len(osc_events)} events, epoch_moved="
                f"{osc_epoch_moved} (flap damping failed)")
        if res.sent < 10:
            failures.append(
                f"the surge offered only {res.sent} requests (the "
                "schedule never stressed the pod)")
        if failures:
            raise SystemExit("pod_bench: " + "; ".join(failures))
    finally:
        _pod_teardown([cap, mc, router], procs, root, keep_dirs)


def bench_pod_mesh(args) -> None:
    """``pod_bench --mesh`` (``dcf_tpu/cli.py:5028-5285``): route-mode
    vs co-evaluate on the SAME pod, recording the dispatch crossover.

    Route-mode sends one batch to one host (its key's owner walks all
    ``m`` points); co-evaluate scatters the same batch's 32-aligned
    point slices over EVERY mesh worker through the zero-copy DCFE
    relay and gathers the share slices back in plan order — the wall
    clock for one big batch is the slowest slice, not the whole walk.
    The crossover batch size (where co-evaluate first beats route-mode)
    is what the router's ``co_eval_min_points`` threshold should be set
    to on a given pod, so this bench measures and EMITS it.

    Legs, in order:

    1. **provision** — ``--bundles`` two-party bundles written durably
       to EVERY shard's store (mesh-wide residency: a co-evaluated key
       must be resident on all workers);
    2. **spawn** — ``--shards`` serve_host subprocesses warm-restore
       ALL keys; the parent builds a route-only router
       (``co_eval="never"``) and a mesh router (``co_eval="always"``,
       group formed over the full ring) over the identical pod;
    3. **parity gate** — every key, both parties: the co-evaluated
       reconstruction is bit-exact vs route-mode AND the numpy oracle
       (scatter/gather must be invisible in the bytes);
    4. **crossover ladder** — interleaved route/co-eval segments (one
       ``--reps``-sampled leg pair per rung) over a geometric batch
       ladder; per rung the median single-batch wall time becomes
       evals/s per mode, and the crossover is the smallest rung where
       co-evaluate wins;
    5. **health check** — zero ``router_mesh_degraded_total`` (a
       degrade mid-bench means the ladder silently measured route-mode
       twice), co_evals accounted.

    The crossover gate applies only when the host offers the pod
    parallelism co-evaluation exists to exploit (>= shards + 1 CPUs);
    on a smaller host the measured ladder is EMITTED with the gate
    recorded environment-gated.  Emits one ``RESULTS_mesh`` line."""
    import os
    import statistics

    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.serve import DcfRouter

    n_shards = args.shards
    if n_shards < 2:
        raise SystemExit(
            f"--mesh needs --shards >= 2 (co-evaluating over one "
            f"worker IS route-mode), got {n_shards}")
    _pod_backend(args)
    n_bundles = args.bundles or 4
    max_batch = args.max_batch or (1 << 10)
    base = args.min_req_points or 128
    top = args.max_req_points or (1 << 13)
    if not 1 <= base <= top:
        raise SystemExit(f"bad ladder range [{base}, {top}]")
    reps = max(args.reps, 3)
    dcf, lam, nb, backend, rng = _serve_host_facade(args)
    prg = HirosePrgNp(lam, dcf.cipher_keys)

    root, keep_dirs = _pod_root(args)
    shard_ids = [f"shard-{i}" for i in range(n_shards)]

    # Leg 1: provision, then replicate every key to EVERY shard.
    ring, stores, bundles, gens = _pod_provision(
        dcf, lam, nb, rng, root, shard_ids, n_bundles)
    for name in bundles:
        placed = {s.host_id for s in ring.placement(name, replicas=1)}
        owner = ring.owner(name).host_id
        for tag in shard_ids:
            if tag not in placed:
                stores[owner].replicate_to(stores[tag], name)
    log(f"provisioned {n_bundles} keys mesh-wide "
        f"(every key on all {n_shards} shards)")

    procs: dict = {}
    routers: list = []
    try:
        for tag in shard_ids:
            procs[tag] = _pod_spawn(tag, os.path.join(root, tag),
                                    root, args)
        ready = _pod_wait_ready(procs)
        for tag, doc in ready.items():
            if doc["restored"] != n_bundles or doc["quarantined"]:
                raise SystemExit(
                    f"pod_bench --mesh: shard {tag} restored "
                    f"{doc['restored']}/{n_bundles} keys "
                    f"({doc['quarantined']} quarantined)")
        pod_specs, _addr = _pod_specs(ready, shard_ids)
        route_router = DcfRouter(pod_specs, n_bytes=nb, co_eval="never")
        mesh_router = DcfRouter(pod_specs, n_bytes=nb, co_eval="always")
        mesh_router.set_mesh()
        routers = [route_router, mesh_router]

        # Leg 3: parity gate (both parties, both modes, numpy oracle).
        xs_gate = rng.integers(0, 256, (3 * 32 + 7, nb), dtype=np.uint8)
        oracle = _oracle_pairs(prg, bundles, xs_gate)
        for name in bundles:
            want = oracle[name]
            if not np.array_equal(_routed_pair(mesh_router, name, xs_gate),
                                  want):
                raise SystemExit(
                    f"pod_bench --mesh: co-evaluated parity mismatch "
                    f"vs numpy oracle on {name}")
            if not np.array_equal(
                    _routed_pair(route_router, name, xs_gate), want):
                raise SystemExit(
                    f"pod_bench --mesh: route-mode parity mismatch "
                    f"vs numpy oracle on {name}")
        log(f"co-evaluated parity vs route-mode + numpy oracle: OK "
            f"({n_bundles} keys x {xs_gate.shape[0]} pts, two-party)")

        # Warm every padded batch shape on every worker, both dispatch
        # modes, up to the ladder top (first stagings stay out of the
        # timed region).
        rungs = []
        m = base
        while m < top:
            rungs.append(m)
            m *= 4
        rungs.append(top)
        key0 = sorted(bundles)[0]
        _pod_warmup(rng, nb, top,
                    [(route_router,
                      [names[0] for names in _group_by_owner(
                          ring, bundles).values()]),
                     (mesh_router, [key0])])
        log(f"warmup ladder done (route + co-eval, top={top})")

        # Leg 4: the crossover ladder — interleaved route/co-eval
        # segments per rung, median single-batch wall time.
        ladder = []
        crossover = None
        for m in rungs:
            xs_m = rng.integers(0, 256, (m, nb), dtype=np.uint8)
            times: dict = {"route": [], "coeval": []}
            for rep in range(reps):
                for leg, target in (("route", route_router),
                                    ("coeval", mesh_router)):
                    name = sorted(bundles)[rep % n_bundles]
                    t0 = time.monotonic()
                    target.evaluate(name, xs_m, b=0, timeout=300)
                    times[leg].append(time.monotonic() - t0)
            route_rate = m / statistics.median(times["route"])
            coeval_rate = m / statistics.median(times["coeval"])
            ladder.append({"points": m,
                           "route_evals_per_sec": round(route_rate, 1),
                           "coeval_evals_per_sec": round(coeval_rate, 1)})
            if crossover is None and coeval_rate >= route_rate:
                crossover = m
            log(f"ladder m={m}: route {route_rate:,.1f} vs co-eval "
                f"{coeval_rate:,.1f} evals/s")

        top_rung = ladder[-1]
        coeval_vs_route = (top_rung["coeval_evals_per_sec"]
                           / max(top_rung["route_evals_per_sec"], 1e-9))
        cpus = len(os.sched_getaffinity(0))
        gate_applies = cpus >= n_shards + 1
        snap = mesh_router.metrics_snapshot()
        co_evals = snap.get("router_co_evals_total", 0)
        degraded = snap.get("router_mesh_degraded_total", 0)
        log(f"crossover: {crossover} pts "
            f"(coeval_vs_route@top={coeval_vs_route:.3f}, cpus={cpus}, "
            f"gate {'applies' if gate_applies else 'environment-gated'})")

        extra = {
            "mode": "mesh",
            "shards": n_shards,
            "bundles": n_bundles,
            "mesh_workers": len(mesh_router.mesh_group),
            "ladder": ladder,
            "crossover_points": crossover,
            "coeval_vs_route_at_top": round(coeval_vs_route, 3),
            "co_evals": co_evals,
            "mesh_degraded": degraded,
            "reps": reps,
            "max_batch": max_batch,
            "crossover_gate": (
                "applies (co-evaluate must win by the top rung)"
                if gate_applies else
                f"environment-gated: {cpus} CPU(s) visible for "
                f"{n_shards} shard processes + router — the scattered "
                "slices serialize onto the same core, so co-evaluate "
                "pays its relay overhead with no parallel payback; "
                f"the committed repro on a >= {n_shards + 1}-core "
                "host (or a card) is the gate"),
        }
        extra.update(_serve_pinned_ratio(
            top_rung["coeval_evals_per_sec"], _platform(dcf.device)[0]))
        _pod_line(args, dcf.device, backend, "evals_per_sec",
                  top_rung["coeval_evals_per_sec"],
                  "evals/s (one co-evaluated batch spanning every "
                  "worker, top rung, party 0)", extra,
                  f"--mesh --shards {n_shards} --bundles {n_bundles} "
                  f"--reps {reps} --max-req-points {top}")

        # Emitted-then-asserted.  Warmup co-evals ride on top of the
        # accounted ones, so the counter may only disagree upward.
        failures = []
        if co_evals < 2 * n_bundles + len(rungs) * reps:
            failures.append(
                f"router_co_evals_total={co_evals} does not cover the "
                f"{2 * n_bundles + len(rungs) * reps} accounted "
                "co-evaluated dispatches")
        if degraded:
            failures.append(
                f"{degraded} co-evaluations degraded to route-mode "
                "mid-bench (the ladder measured route twice)")
        if gate_applies and crossover is None:
            failures.append(
                f"co-evaluate never beat route-mode by the top rung "
                f"({top} pts) with {cpus} CPUs for {n_shards} workers")
        if failures:
            raise SystemExit("pod_bench --mesh: " + "; ".join(failures))
    finally:
        _pod_teardown(routers, procs, root, keep_dirs)


def bench_pod(args) -> None:
    """The pod-scale serving bench (``dcf_tpu/cli.py:5294-5780``): N
    localhost shard PROCESSES behind the zero-copy DCFE router, vs the
    same workload on one shard, at the same shape/seeds.  On the card
    every shard process holds its own CUDA context.

    Legs, in order:

    1. **provision** — ``--bundles`` two-party bundles placed by the
       rendezvous ring; each key's DCFK frame is written durably to
       its owner's store and replicated to its replica's
       (``KeyStore.replicate_to``, generations preserved), plus ALL
       keys into a solo host's store (the single-shard leg);
    2. **spawn** — ``--shards`` + 1 ``serve_host`` subprocesses warm-
       restore their stores and listen; the parent builds one pod
       router (N-ring) and one solo router (1-ring) so BOTH legs run
       the identical two-hop wire path;
    3. **routed parity gate** — every key, both parties, through the
       pod router and the solo router, bit-exact vs the numpy oracle;
    4. **throughput** — interleaved closed-loop segments (3 per leg,
       shared seeds) solo vs pod; the headline is the pod leg, the
       gate is ``pod_vs_single >= 2.2`` — applied when the host
       actually offers the pod parallelism (>= shards+1 CPUs); on a
       smaller host the measured ratio is EMITTED with the gate
       recorded environment-gated;
    5. **open-loop reconciliation** — a Poisson leg whose
       sent/expired/per-class-shed counts reconcile against the POD
       rollup (``loadgen.reconcile_against_rollup`` over the summed
       per-host snapshots);
    6. **kill-a-shard failover soak** — one shard SIGKILLed mid-load;
       every request completes bit-exact or is refused typed WITH
       ``retry_after_s``; afterwards every key the victim owned still
       serves CRITICAL traffic bit-exact from its replica, the
       replica store holds the provisioned generations, and the pod
       rollup shows ZERO quarantines.

    ``--live-bundles`` NON-durable keys are registered through the
    router's REGISTER fan-out on top of the durable ones, the health
    prober runs through every leg, and the kill soak additionally gates
    that the victim's live keys serve CRITICAL bit-exact from the
    promoted replica within about one probe interval of the SIGKILL —
    zero re-keygen, generations preserved on the replica's live registry
    (checked over the wire via the DIGEST verb).

    Any non-empty ``--mesh`` runs the co-evaluation crossover scenario
    instead (``bench_pod_mesh``), ``--surge`` the autoscaling one
    (``bench_pod_surge``), ``--churn`` the membership one
    (``bench_pod_churn``), ``--partition`` / ``--flap`` the
    partition-tolerance one (``bench_pod_selfheal``).

    Emits one ``RESULTS_pod`` line, then applies the exit gates."""
    if getattr(args, "mesh", ""):
        if args.surge or args.churn or args.partition or args.flap:
            raise SystemExit(
                "--mesh and --surge/--churn/--partition/--flap are "
                "separate scenarios; pick one")
        return bench_pod_mesh(args)
    if args.surge:
        if args.churn or args.partition or args.flap:
            raise SystemExit(
                "--surge and --churn/--partition/--flap are separate "
                "scenarios; pick one")
        return bench_pod_surge(args)
    if args.churn:
        if args.partition or args.flap:
            raise SystemExit(
                "--churn and --partition/--flap are separate "
                "scenarios; pick one")
        return bench_pod_churn(args)
    if args.partition or args.flap:
        return bench_pod_selfheal(args)

    import os
    import signal

    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.serve.loadgen import (
        closed_loop,
        open_loop,
        reconcile_against_rollup,
    )

    n_shards = args.shards
    if n_shards < 2:
        raise SystemExit(
            f"--shards must be >= 2 (a pod of one is the solo leg), "
            f"got {n_shards}")
    if args.probe_interval <= 0:
        raise SystemExit(
            f"--probe-interval must be > 0, got {args.probe_interval}")
    if args.live_bundles < 0:
        raise SystemExit(
            f"--live-bundles must be >= 0, got {args.live_bundles}")
    _pod_backend(args)
    max_batch = args.max_batch or (1 << 10)
    min_req = args.min_req_points or (max_batch * 3 // 8)
    max_req = args.max_req_points or (max_batch // 2)
    if not 1 <= min_req <= max_req:
        raise SystemExit(
            f"bad request-size range [{min_req}, {max_req}]")
    dcf, lam, nb, backend, rng = _serve_host_facade(args)
    prg = HirosePrgNp(lam, dcf.cipher_keys)
    platform = _platform(dcf.device)[0]
    n_bundles = args.bundles or 8
    conns = args.concurrency

    root, keep_dirs = _pod_root(args)
    shard_ids = [f"shard-{i}" for i in range(n_shards)]

    # Leg 1: provision (the shared block — ``solo`` adds the
    # single-shard comparison store holding everything).
    ring, stores, bundles, gens = _pod_provision(
        dcf, lam, nb, rng, root, shard_ids, n_bundles, solo=True)
    by_owner = _group_by_owner(ring, bundles)
    log(f"provisioned {n_bundles} keys over {n_shards} shards "
        f"(+ solo): " + ", ".join(
            f"{s}:{len(by_owner.get(s, []))}" for s in shard_ids))

    # Leg 2: spawn the shard processes.
    procs: dict = {}
    routers: list = []
    try:
        for tag in [*shard_ids, "solo"]:
            procs[tag] = _pod_spawn(tag, os.path.join(root, tag),
                                    root, args)
        ready = _pod_wait_ready(procs)
        for tag, doc in ready.items():
            want = n_bundles if tag == "solo" else len(
                {k for k in bundles
                 if tag in {s.host_id
                            for s in ring.placement(k, replicas=1)}})
            if doc["restored"] != want or doc["quarantined"]:
                raise SystemExit(
                    f"pod_bench: shard {tag} restored "
                    f"{doc['restored']}/{want} keys "
                    f"({doc['quarantined']} quarantined)")
        pod_specs, addr_of = _pod_specs(ready, shard_ids)
        router = _pod_router(pod_specs, nb, args.probe_interval,
                             backoff_s=0.05)
        solo_specs, _ = _pod_specs(ready, ["solo"])
        solo = _pod_router(solo_specs, nb, args.probe_interval,
                           backoff_s=0.05)
        routers = [router, solo]

        # Live (NON-durable) keys through the REGISTER fan-out — owner
        # mints, replica applies, generations preserved; registered on
        # the solo ring too so both throughput legs serve the identical
        # key set.
        live, live_gens = _pod_live_register(
            router, dcf, rng, lam, nb, args.live_bundles)
        for name, kb in live.items():
            solo.register_key(name, kb)
        bundles.update(live)
        for name in live:
            by_owner.setdefault(ring.owner(name).host_id, []).append(name)
        log(f"registered {len(live)} live (non-durable) keys through "
            "the router fan-out")

        # Leg 3: routed parity gate (both parties, numpy oracle).
        xs_gate = rng.integers(0, 256, (128, nb), dtype=np.uint8)
        _pod_parity_gate(router, bundles, prg, xs_gate, solo=solo)
        log(f"routed parity vs numpy oracle: OK ({n_bundles} keys x "
            "128 pts, two-party, pod + solo)")

        _pod_warmup(rng, nb, max_batch,
                    [(router, [names[0] for names in by_owner.values()]),
                     (solo, ["key-0"])])
        log("warmup ladder done (all shards + solo, both parties)")
        router.start_health()  # the control plane runs from here on

        # Leg 4: interleaved solo vs pod closed-loop segments.
        segs = 3
        seg_s = max(float(args.duration) / (2 * segs), 1.0)
        runs: dict = {"solo": [], "pod": []}
        for i in range(2 * segs):
            leg = "solo" if i % 2 == 0 else "pod"
            res = closed_loop(
                solo if leg == "solo" else router, sorted(bundles),
                duration_s=seg_s, concurrency=conns,
                min_points=min_req, max_points=max_req,
                seed=args.seed + i // 2)
            runs[leg].append(res)
        res_solo = _merge_loadgen(runs["solo"])
        res_pod = _merge_loadgen(runs["pod"])
        pod_vs_single = res_pod.throughput / max(res_solo.throughput,
                                                 1e-9)
        cpus = len(os.sched_getaffinity(0))
        gate_applies = cpus >= n_shards + 1
        log(f"throughput: pod {res_pod.throughput:,.1f} vs solo "
            f"{res_solo.throughput:,.1f} evals/s "
            f"(pod_vs_single={pod_vs_single:.3f}, cpus={cpus}, "
            f"gate {'applies' if gate_applies else 'environment-gated'})"
            f" [{_CARD['label']}]")

        # Leg 5: open-loop reconciliation against the POD rollup.
        metric_files = [procs[s][2] for s in shard_ids]
        time.sleep(1.2)  # quiesce past a metrics-flush interval
        roll_before = _pod_rollup(metric_files)
        open_rate = max(
            0.6 * res_pod.requests_ok / max(res_pod.duration_s, 1e-9),
            1.0)
        res_open = open_loop(
            router, sorted(bundles), rate_rps=open_rate,
            duration_s=min(float(args.duration) / 3, 10.0),
            min_points=min_req, max_points=max_req,
            seed=args.seed + 17)
        time.sleep(1.2)
        roll_after = _pod_rollup(metric_files)
        recon = reconcile_against_rollup(res_open, roll_before,
                                         roll_after)
        log(f"open-loop @ {open_rate:,.1f} req/s: ok={res_open.ok} "
            f"shed={res_open.shed} expired={res_open.expired} "
            f"pod-reconciled={recon['reconciled']}")

        # Leg 6: kill-a-shard failover soak.  The victim owns keys —
        # preferring a shard that owns LIVE (non-durable) ones, whose
        # survival on the replica is the acceptance — and its replicas
        # must pick CRITICAL traffic up.
        victim = max(by_owner, key=lambda s: (
            len([n for n in by_owner[s] if n in live]),
            len(by_owner[s])))
        victim_keys = sorted(by_owner[victim])
        victim_live_keys = sorted(n for n in victim_keys if n in live)
        kill_stats: dict = {"critical_within_s": None}
        xs_kill = rng.integers(0, 256, (8, nb), dtype=np.uint8)
        # The oracle's shares before the clock: the window measures the
        # replica, not the numpy walk.
        want_kill = (_oracle_pair(prg, live[victim_live_keys[0]], xs_kill)
                     if victim_live_keys else None)

        def kill_victim() -> None:
            log(f"soak: SIGKILL {victim} (owner of "
                f"{len(victim_keys)} keys, {len(victim_live_keys)} "
                "live)")
            procs[victim][0].send_signal(signal.SIGKILL)
            if not victim_live_keys:
                return
            # CRITICAL traffic for a victim-owned NON-durable key serves
            # bit-exact from the replica within about one probe interval
            # of the kill (per-request failover does not even wait for
            # the prober's DOWN).
            name = victim_live_keys[0]
            t0 = time.monotonic()
            while time.monotonic() - t0 < 30:
                try:
                    got = _routed_pair(router, name, xs_kill,
                                       priority="critical")
                except Exception:  # fallback-ok: the window between
                    # SIGKILL landing and the replica serving IS the
                    # measurement — keep trying until the deadline
                    time.sleep(0.02)
                    continue
                if np.array_equal(got, want_kill):
                    kill_stats["critical_within_s"] = \
                        time.monotonic() - t0
                return

        soak_s = max(float(args.duration) / 4, 4.0)
        soak = _pod_soak(router, bundles, prg, nb,
                         duration_s=soak_s, conns=max(conns, 4),
                         seed=args.seed, kill_after_s=soak_s / 3,
                         kill_fn=kill_victim)
        log(f"soak: {soak} critical_within_s="
            f"{kill_stats['critical_within_s']}")

        # Post-soak: every victim-owned key still serves CRITICAL
        # bit-exact from its replica; durable keys' replica STORES hold
        # the provisioned generation, live keys' replica LIVE registries
        # hold the owner-minted one (checked over the wire — zero
        # re-keygen either way: the parity proves the replica serves
        # the same pre-minted bits).
        failover_parity = True
        generations_held = True
        # By now the prober has marked the victim DOWN, so NORMAL
        # traffic is served via promotion too — exercised below.
        deadline = time.monotonic() + 60
        while router.health.state(victim) != "down" \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        down_observed = router.health.state(victim) == "down"
        xs_post = rng.integers(0, 256, (16, nb), dtype=np.uint8)
        want = _oracle_pairs(prg, {n: bundles[n] for n in victim_keys},
                             xs_post)
        rep_digests: dict = {}
        for name in victim_keys:
            pr = "critical" if name not in live else "normal"
            failover_parity &= bool(np.array_equal(
                _routed_pair(router, name, xs_post, priority=pr),
                want[name]))
            rep = next(s.host_id
                       for s in ring.placement(name, replicas=1)[1:])
            if name in live:
                if rep not in rep_digests:
                    rep_digests[rep] = _pod_wire_digest(addr_of[rep], nb)
                generations_held &= (
                    rep_digests[rep].get(name) == live_gens[name])
            else:
                generations_held &= (
                    stores[rep].generation_of(name) == gens[name])
        log(f"post-kill: replica parity={failover_parity}, "
            f"generations_held={generations_held}, "
            f"down_observed={down_observed}")
        time.sleep(1.2)
        roll_final = _pod_rollup(metric_files)
        quarantined = roll_final.get("serve_store_quarantined_total", 0)

        rsnap = router.metrics_snapshot()
        extra = {
            "shards": n_shards,
            "bundles": n_bundles,
            "duration_s": round(res_pod.duration_s
                                + res_solo.duration_s, 3),
            "max_batch": max_batch,
            "req_points": [min_req, max_req],
            "concurrency": conns,
            "segments_per_leg": segs,
            "single_shard_evals_per_sec": round(res_solo.throughput, 1),
            "pod_vs_single": round(pod_vs_single, 3),
            "throughput_gate": (
                "applies (>= 2.2x required)" if gate_applies else
                f"environment-gated: {cpus} CPU(s) visible for "
                f"{n_shards} shard processes + router — aggregate "
                "CPU throughput cannot exceed 1x here; the committed "
                "repro on a >= "
                f"{n_shards + 1}-core host (or a card) is the gate"),
            **res_pod.latency_quantiles(),
            "open_loop_rate_rps": round(open_rate, 1),
            "open_loop_ok": res_open.ok,
            "open_loop_pod_reconciled": recon["reconciled"],
            **_ledger_fields(soak),
            "failover_parity": failover_parity,
            "generations_held": generations_held,
            "live_bundles": len(live),
            "victim_live_keys": len(victim_live_keys),
            "critical_within_s": (
                None if kill_stats["critical_within_s"] is None
                else round(kill_stats["critical_within_s"], 3)),
            "probe_interval_s": args.probe_interval,
            "down_observed": down_observed,
            "promoted_forwards": rsnap.get(
                "router_promoted_forwards_total", 0),
            "pod_quarantined": quarantined,
            "router_failovers": rsnap.get("router_failovers_total", 0),
            "router_suspect_refusals": rsnap.get(
                "router_suspect_refusals_total", 0),
            "pod_requests_total": roll_final.get(
                "serve_requests_total", 0),
        }
        extra.update(_serve_pinned_ratio(res_pod.throughput, platform))
        _pod_line(args, dcf.device, backend, "evals_per_sec",
                  res_pod.throughput,
                  "evals/s (closed-loop served through the pod router, "
                  "party 0)", extra,
                  f"--shards {n_shards} "
                  f"--duration {float(args.duration):g} "
                  f"--max-batch {max_batch} --concurrency {conns}")

        # Emitted-then-asserted, chaos_bench style.
        failures = []
        if gate_applies and pod_vs_single < 2.2:
            failures.append(
                f"pod served {pod_vs_single:.3f}x the single-shard "
                "leg at the same shape/seeds (< 2.2 with the host "
                "parallelism to do better)")
        if soak["mismatches"] or soak["unaccounted"] \
                or soak["refused_unhinted"]:
            failures.append(
                f"failover soak left requests unaccounted: "
                f"{soak['mismatches']} mismatches, "
                f"{soak['unaccounted']} untyped failures, "
                f"{soak['refused_unhinted']} refusals without "
                "retry_after_s")
        if soak["sessions_ok"] < conns or soak["critical_ok"] < 1:
            failures.append(
                f"soak delivered only {soak['sessions_ok']} sessions "
                f"({soak['critical_ok']} CRITICAL)")
        if not failover_parity:
            failures.append(
                "a victim-owned key did not serve bit-exact from its "
                "replica after the kill")
        if not generations_held:
            failures.append(
                "a replica lost its provisioned generation (store or "
                "live registry)")
        if victim_live_keys:
            within = kill_stats["critical_within_s"]
            if within is None:
                failures.append(
                    "CRITICAL traffic for a victim-owned LIVE key "
                    "never served from the replica after the kill")
            elif within > max(2 * args.probe_interval, 3.0):
                failures.append(
                    f"CRITICAL live-key failover took {within:.2f}s "
                    "(> ~one probe interval with scheduling slack)")
            if not down_observed:
                failures.append(
                    "the prober never marked the SIGKILLed victim "
                    "DOWN")
        if quarantined:
            failures.append(
                f"{quarantined} frames quarantined across the pod")
        if not recon["reconciled"]:
            failures.append(
                f"open-loop counts did not reconcile against the pod "
                f"rollup ({recon})")
        if failures:
            raise SystemExit("pod_bench: " + "; ".join(failures))
    finally:
        _pod_teardown(routers, procs, root, keep_dirs)


BENCHES = {
    "dcf": bench_dcf,
    "dcf_batch_eval": bench_batch,
    "dcf_large_lambda": bench_large_lambda,
    "secure_relu": bench_secure_relu,
    "full_domain": bench_full_domain,
    "serve_bench": bench_serve,
    "edge_bench": bench_edge,
    "mic_bench": bench_mic,
    "gate_bench": bench_gates,
    "chaos_bench": bench_chaos,
    "keygen_bench": bench_keygen,
    "pir_bench": bench_pir,
    "keyfactory_bench": bench_keyfactory,
    "serve_host": bench_serve_host,
    "pod_bench": bench_pod,
}


def _refuse_later_slices(args) -> None:
    """dcf_tpu's routes the port does not take exit non-zero before any
    work, naming what to use; a malformed device mesh too (the pod
    benches' ``--mesh`` is their co-evaluation scenario, not a mesh
    shape)."""
    if args.bench not in POD_BENCHES:
        _parse_mesh(args.mesh)
    if args.backend in WALK_ALIASES:
        raise SystemExit(
            f"--backend={args.backend} is dcf_tpu's from-root walk on the "
            "TPU; the port's from-root walk kernel is --backend walk")


def _force_cpu_positions(args) -> None:
    """``DCF_CPU_DEVICES=N`` runs the CLI on N CPU positions: the device
    is the CPU (the kernels' plain versions; every line says
    ``"device": "cpu"``) and a mesh has up to N positions
    (``parallel.make_mesh``), ``dcf_tpu``'s virtual-device mode."""
    import os

    from dcf_tpu_torch.parallel.mesh import CPU_DEVICES_ENV

    n = os.environ.get(CPU_DEVICES_ENV)
    if n:
        args.device = "cpu"
        log(f"forced {n} CPU positions ({CPU_DEVICES_ENV})")


def _add_pod_flags(p) -> None:
    """serve_host's and pod_bench's own flags, with dcf_tpu's names,
    defaults and meanings."""
    p.add_argument("--shards", type=int, default=3,
                   help="pod_bench: localhost shard processes in the "
                        "pod ring (>= 2; the solo comparison leg is "
                        "spawned on top)")
    p.add_argument("--live-bundles", type=int, default=4,
                   help="pod_bench: LIVE (non-durable) keys registered "
                        "through the router's REGISTER fan-out on top "
                        "of the --bundles durable ones (the kill and "
                        "partition soaks prove they survive their "
                        "owner's death on the replica)")
    p.add_argument("--partition", action="store_true",
                   help="pod_bench: the partition-tolerance scenario — "
                        "a net.partition window isolates one shard "
                        "under load; every request completes bit-exact "
                        "or is refused typed with retry_after_s, "
                        "promoted replicas serve, and the anti-entropy "
                        "gate converges the digest on heal")
    p.add_argument("--flap", action="store_true",
                   help="pod_bench: the partition scenario with three "
                        "cut/heal cycles — generations must be "
                        "monotone across every flap")
    p.add_argument("--churn", action="store_true",
                   help="pod_bench: the autonomous-membership scenario "
                        "— SIGKILL one shard, auto-eject with every "
                        "frame re-replicated, a warm re-join, a "
                        "graceful drain (SIGTERM exits 0), and a "
                        "stale-epoch frame refused E_EPOCH")
    p.add_argument("--surge", action="store_true",
                   help="pod_bench: the demand-driven autoscaling "
                        "scenario — an open-loop Zipf ramp must admit a "
                        "--standby host within --reaction-bound "
                        "seconds, the idle tail drains one back, and an "
                        "oscillating-load leg is pinned to zero churn")
    p.add_argument("--standby-hosts", type=int, default=1,
                   help="pod_bench --surge: provisioned-but-idle "
                        "serve_host --standby processes declared to "
                        "the capacity controller's standby pool")
    p.add_argument("--reaction-bound", type=float, default=30.0,
                   help="pod_bench --surge: max seconds from the ramp "
                        "start to the scale-out commit")
    p.add_argument("--eject-grace", type=float, default=3.0,
                   help="pod_bench --churn: seconds a shard must stay "
                        "DOWN before the membership controller "
                        "auto-ejects it")
    p.add_argument("--probe-interval", type=float, default=0.25,
                   help="pod_bench: health-prober probe interval in "
                        "seconds (fail-3/recover-2 hysteresis rides "
                        "on it)")
    p.add_argument("--bind", default="127.0.0.1",
                   help="serve_host: address to bind the DCFE edge on")
    p.add_argument("--port", type=int, default=0,
                   help="serve_host: edge port (0 = pick a free one; "
                        "the bound port lands in --ready-file)")
    p.add_argument("--standby", action="store_true",
                   help="serve_host: come up provisioned but EMPTY — "
                        "skip the store restore; the capacity "
                        "controller's graceful join ships keys "
                        "warm-before-admit")
    p.add_argument("--max-queued-points", type=int, default=0,
                   help="serve_host: admission-queue bound in points "
                        "(0 = the ServeConfig default; pod_bench "
                        "--surge pins 4096)")
    p.add_argument("--ready-file", default="",
                   help="serve_host: write a JSON {host, port, pid, "
                        "restored, quarantined, standby} document here "
                        "(atomic rename) once serving")
    p.add_argument("--metrics-file", default="",
                   help="serve_host: refresh this JSON metrics snapshot "
                        "every ~0.5s and at shutdown (atomic rename)")
    p.add_argument("--tls-cert", default="",
                   help="serve_host: PEM certificate arming TLS on the "
                        "edge socket (needs --tls-key)")
    p.add_argument("--tls-key", default="",
                   help="serve_host: PEM private key for --tls-cert")
    p.add_argument("--tls-client-ca", default="",
                   help="serve_host: PEM CA bundle; when set, only "
                        "clients presenting a cert signed by it may "
                        "connect")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m dcf_tpu_torch.cli",
        description="DCF benchmark CLI of the PyTorch/CUDA port "
                    "(reference criterion-bench analogs)",
    )
    p.add_argument("bench", choices=(*BENCHES, "all", "baseline"))
    p.add_argument("--backend", default="cpu",
                   choices=(*BACKENDS, "tree", "hybrid", *WALK_ALIASES,
                            *SHARDED),
                   help="'tree' (full_domain only): the tree expansion; "
                        "'hybrid' (dcf_large_lambda only): narrow walk + "
                        "GF(2)-affine wide part")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the CPU, where the "
                        "kernels' plain PyTorch versions run")
    p.add_argument("--points", type=int, default=0,
                   help="batch size (0 = bench default)")
    p.add_argument("--keys", type=int, default=0,
                   help="key count for secure_relu / dcf_large_lambda "
                        "(0 = bench default); keygen_bench: replace "
                        "the K sweep with this single K; "
                        "keyfactory_bench: the per-refill session "
                        "batch (0 = 64, the pinned keygen-baseline K); "
                        "pir_bench: queries per batch (0 = 4)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=2026)
    p.add_argument("--check", action="store_true",
                   help="verify parity vs the C++ core before timing")
    p.add_argument("--mesh", default="", nargs="?", const="pod",
                   help="mesh shape KxP (e.g. 4x2) for the sharded "
                        "backends; with --backend=hybrid, prefix or tree "
                        "it switches to their mesh-sharded variants; bare "
                        "--mesh on pod_bench runs the co-evaluation "
                        "crossover scenario")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the timed region")
    p.add_argument("--n-bits", type=int, default=0,
                   help="domain bits for full_domain (0 = 24); "
                        "pir_bench: a single database domain "
                        "(0 = the {14, 16, 18} sweep)")
    p.add_argument("--lam", type=int, default=0,
                   help="range bytes for dcf_large_lambda (0 = 16384; "
                        "256 = BASELINE config 4) / keygen_bench "
                        "(0 = both 128 and 256) / keyfactory_bench "
                        "(0 = 128)")
    p.add_argument("--prefix-levels", type=int, default=0,
                   help="dcf_large_lambda --backend=hybrid: expand the "
                        "top k narrow-walk levels once per (key, party) "
                        "as a cached frontier and walk only n-k levels "
                        "per point (0 = from-root walk)")
    p.add_argument("--domain-bytes", type=int, default=0,
                   help="input width for dcf_batch_eval (0 = 16)")
    p.add_argument("--device-gen", action="store_true",
                   help="secure_relu: device keygen + keylanes path")
    p.add_argument("--duration", type=float, default=30.0,
                   help="serve_bench: closed-loop load duration, seconds")
    p.add_argument("--concurrency", type=int, default=4,
                   help="serve_bench: closed-loop client threads")
    p.add_argument("--max-batch", type=int, default=0,
                   help="serve_bench: service micro-batch cap in points "
                        "(power of two; 0 = 2^17)")
    p.add_argument("--bundles", type=int, default=0,
                   help="serve_bench: registered key bundles (0 = 3)")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="serve_bench: micro-batch coalescing delay")
    p.add_argument("--device-bytes-budget", type=int, default=0,
                   help="serve_bench: LRU device-residency budget "
                        "(0 = uncapped)")
    p.add_argument("--edge", action="store_true",
                   help="serve_bench: also drive the same closed-loop "
                        "shape over the DCFE wire path and record "
                        "wire_vs_inprocess on the line")
    p.add_argument("--connections", type=int, default=8,
                   help="edge_bench: concurrent TCP connections for "
                        "the wire legs (the soak always uses >= 8)")
    p.add_argument("--min-req-points", type=int, default=0,
                   help="serve_bench/mic_bench: request-size range lower "
                        "bound (0 = 3/8 of --max-batch)")
    p.add_argument("--max-req-points", type=int, default=0,
                   help="serve_bench/mic_bench: request-size range upper "
                        "bound (0 = half of --max-batch)")
    p.add_argument("--skew", default="0",
                   help="serve_bench/mic_bench/chaos_bench: Zipf "
                        "exponent for key choice (0 = uniform; "
                        "serve_bench --skew also runs the cold-frontier "
                        "comparison leg)")
    p.add_argument("--intervals", type=int, default=0,
                   help="mic_bench/keygen_bench/gate_bench: interval or "
                        "piece count m (0 = 8)")
    p.add_argument("--fault-window", type=int, default=24,
                   help="chaos_bench: serve.eval evals to fail before "
                        "the injected backend recovers (retries count)")
    p.add_argument("--priority-mix",
                   default="critical=0.2,normal=0.5,batch=0.3",
                   help="chaos_bench: per-request priority-class "
                        "weights, e.g. critical=0.2,normal=0.5,"
                        "batch=0.3")
    p.add_argument("--breaker-failures", type=int, default=3,
                   help="chaos_bench: consecutive failed attempts "
                        "that open a (key, backend-family) breaker")
    p.add_argument("--breaker-cooldown", type=float, default=0.25,
                   help="chaos_bench: seconds an open breaker waits "
                        "before its half-open probe")
    p.add_argument("--crash-restart", action="store_true",
                   help="chaos_bench: run the durable-store scenario "
                        "instead — durable keys, a mid-stage kill, "
                        "warm restart, bit-exact post-restart parity "
                        "vs the C++ core with zero re-keygen")
    p.add_argument("--store-dir", default="",
                   help="chaos_bench --crash-restart / "
                        "keyfactory_bench: durable key store directory "
                        "(default: a fresh temp dir, removed "
                        "afterwards; an explicit dir is kept)")
    p.add_argument("--host-refill", action="store_true",
                   help="keyfactory_bench: refill pools through the "
                        "host keygen instead of the device")
    p.add_argument("--keyfactory", action="store_true",
                   help="chaos_bench --crash-restart: also run the "
                        "key-factory pool scenario")
    p.add_argument("--full", action="store_true",
                   help="baseline: run config 5 at the literal 10^6-key "
                        "scale")
    # serve_host and pod_bench's own flags are theirs alone: the other
    # benches refuse them (dcf_tpu's parser takes them everywhere and
    # ignores them).
    known, _ = p.parse_known_args(argv)
    if known.bench in POD_BENCHES:
        _add_pod_flags(p)
    args = p.parse_args(argv)
    _force_cpu_positions(args)
    _refuse_later_slices(args)
    if args.backend == "tree" and args.bench not in ("full_domain",
                                                     "baseline"):
        raise SystemExit(
            "--backend=tree is the full-domain tree evaluator; it only "
            "applies to the full_domain bench (and baseline)")
    if args.backend == "hybrid" and args.bench not in (
            "dcf_large_lambda", "keyfactory_bench", "baseline"):
        raise SystemExit(
            "--backend=hybrid is the large-lambda evaluator; it only "
            "applies to the dcf_large_lambda and keyfactory_bench "
            "benches (and baseline)")
    if args.prefix_levels and args.backend not in ("hybrid", "prefix"):
        raise SystemExit(
            "--prefix-levels configures the prefix-shared narrow walk; "
            "use it with --backend=hybrid (dcf_large_lambda) or "
            "--backend=prefix (serve_bench --skew frontier depth)")
    if args.bench == "baseline":
        bench_baseline(args)
        return
    for name in BENCHES if args.bench == "all" else [args.bench]:
        if args.bench == "all" and name in ("serve_bench", "edge_bench",
                                            "mic_bench", "chaos_bench",
                                            "pod_bench"):
            log(f"skipping {name} (a timed load test, not a "
                "criterion analog; run it explicitly)")
            continue
        if args.bench == "all" and name == "serve_host":
            log("skipping serve_host (a long-lived shard process, "
                "not a bench; run it explicitly)")
            continue
        if args.bench == "all" and name in ("keygen_bench",
                                            "keyfactory_bench",
                                            "pir_bench"):
            log(f"skipping {name} (device-kernel harness with its "
                "own backend routing; run it explicitly)")
            continue
        if args.bench == "all" and name == "dcf_large_lambda" and \
                args.backend in ("walk", "prefix", "keylanes", *SHARDED):
            log("skipping dcf_large_lambda (lam=16-only backend)")
            continue
        if args.bench == "all" and name == "dcf" and \
                args.backend in SHARDED:
            log("skipping dcf (single-point bench, not shardable)")
            continue
        BENCHES[name](args)


if __name__ == "__main__":
    main()
