"""Chip smoke run of the PyTorch/CUDA port (``dcf_tpu_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. build kernels B1-B5b and W1 from ``dcf_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and print the build seconds and
   ptxas' register and spill counts;
3. hold each kernel byte for byte against its plain PyTorch version on the
   card, at 2^16 points: B1-B3 (B2 from level 6 to 21) over both parties,
   all four output groups, both bounds, and B1 with 3 keys and per-key
   points; B4 + W1 and B5a + B5b (k = 16) + W1 at lam = 256 over both
   parties and both bounds, and B4 + W1 with 3 keys; x = alpha and
   alpha +- 1 planted throughout;
4. the main paths through the port's ``Dcf`` facade, one key, n = 128,
   2^20 random shared points, XOR group, host keygen: lam = 16 through
   ``walk`` (B1) and ``prefix`` (B2 + B3); lam = 256 (BASELINE.json config
   4) through ``auto`` = ``hybrid`` from the root (B4 + W1) and hybrid with
   ``prefix_levels=20`` (B5a + B5b + W1).  For each: both parties over the
   same staged points, the full on-device two-party reconstruction (0
   mismatches), the first 1024 points against the port's numpy oracle,
   the launch counts (each path from counts set to 0), the median
   ``eval_staged`` time;
5. the reference crate's own large-lambda shape (lam = 16384, 10,000
   points) from the root: 0 mismatches, the first 64 points against the
   oracle, and W1 (whose columns tile over the grid here) against its
   plain version;
6. each kernel held byte for byte against its plain version at its main
   path's shapes (2^20 points; B2 levels 6 to 21, B5a k = 20), and its
   time there beside its plain version's and its bound; W1 also beside
   ``torch._int_mm``, the library's integer product, whose parity is
   checked against W1's output;
7. the hybrid prefix depth on the card: B5a and B5b called directly at
   k = 16..24 on the lam = 256 main inputs, each result equal to the
   from-root walk's, and B5b's time per walked level beside B4's.

The next to last line is one JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or run from a
directory that does not hold the package, it exits non-zero and prints no
result.  Only torch and numpy are used (no JAX, nothing of ``dcf_tpu``).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 2026
N_BYTES = 16  # n = 128 levels
M_CHECK = 1 << 16  # points per kernel-vs-plain check
M_MAIN = 1 << 20  # points of the main path
M_ANCHOR = 1024  # points held against the numpy oracle
HOST_LEVELS = 6  # k0 of the frontier
LAM_WIDE = 256  # BASELINE.json config 4
K_CHECK = 16  # hybrid frontier depth of the 2^16-point checks
K_HYBRID = 20  # hybrid frontier depth of the main path (the clamp)
K_SWEEP = range(16, 25)  # hybrid frontier depths timed in phase 7
LAM_CRATE = 16384  # the reference crate's benches/dcf_large_lambda.rs
M_CRATE = 10_000
M_CRATE_ANCHOR = 64
REPEATS = 10  # timed eval_staged repeats per backend
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
LOOKUP_LANES = 32  # shared-memory words served per SM per clock
INT8_OPS_PER_S = 1.979e15  # H100 SXM published dense int8 tensor rate


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, and
    what the last call returned."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import dcf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not here ({e})",
              file=sys.stderr)
        return 1
    from dcf_tpu_torch import Bound, Dcf, _build
    from dcf_tpu_torch.backends.fulldomain import tree_expand_np
    from dcf_tpu_torch.backends.large_lambda import wide_affine_batch_np
    from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.keys import KeyBundle
    from dcf_tpu_torch.ops.hybrid_prefix import (
        hybrid_prefix_eval, hybrid_prefix_eval_plain, narrow_frontier,
        narrow_frontier_plain)
    from dcf_tpu_torch.ops.narrow_walk import (
        NARROW, narrow_aes_image, narrow_walk, narrow_walk_plain,
        unpack_traj_plain)
    from dcf_tpu_torch.ops.prefix_eval import (
        frontier_index_plain, frontier_table, prefix_eval, prefix_eval_plain)
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.tree_expand import (
        tree_expand, tree_expand_level, tree_expand_level_plain)
    from dcf_tpu_torch.ops.walk_eval import (
        aes_image, walk_bits_plain, walk_eval, walk_eval_plain)
    from dcf_tpu_torch.ops.wide_tail import wide_tail, wide_tail_plain
    from dcf_tpu_torch.spec import GROUPS

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 1: the card ---------------------------------------------------
    card = nvidia_smi("name,power.limit")
    log(card)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lookups_per_s = sms * LOOKUP_LANES * clock_mhz * 1e6
    log(f"phase 1 card: {torch.cuda.get_device_name(0)}, {sms} SMs, "
        f"max SM clock {clock_mhz:.0f} MHz, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # -- phase 2: build --------------------------------------------------------
    build_s = _build.build()
    ptxas = {k: (re.findall(r"Used (\d+) registers", _build.build_log(k)),
                 re.findall(r"(\d+) bytes spill stores", _build.build_log(k)))
             for k in _build.KERNELS}
    log(f"phase 2 build: {build_s:.2f} s for {len(_build.KERNELS)} kernels; "
        "(registers, spill-store bytes) per instantiation (B1-B3: xor, "
        f"add8, add16, add32 in some order): {ptxas}")

    # -- phase 3: each kernel against its plain version --------------------------
    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    aes = torch.from_numpy(aes_image(ck[0])).to(dev)
    max_err = {k: 0 for k in ("B1", "B2", "B3", "B4", "B5a", "B5b", "W1")}

    def same(kernel: str, what: str, got, want) -> None:
        err = int((got.int() - want.int()).abs().max().item()) \
            if got.shape == want.shape else -1
        max_err[kernel] = max(max_err[kernel], err)
        if err != 0:
            raise RuntimeError(f"{kernel} {what}: kernel disagrees with its "
                               f"plain version (max abs err {err})")

    def planted_points(alpha: np.ndarray, m: int) -> np.ndarray:
        xs = rng.integers(0, 256, (m, N_BYTES), dtype=np.uint8)
        a = int.from_bytes(alpha.tobytes(), "big")
        for j, x in enumerate((a, a - 1, a + 1)):
            xs[j] = np.frombuffer((x % (1 << 8 * N_BYTES)).to_bytes(
                N_BYTES, "big"), dtype=np.uint8)
        return xs

    def on_card(kb: KeyBundle, width: int = 16) -> dict:
        return {
            name: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for name, a in (("s0", kb.s0s[:, 0, :width]),
                            ("cw_s", kb.cw_s[..., :width]),
                            ("cw_v", kb.cw_v[..., :width]),
                            ("cw_t", kb.cw_t),
                            ("cw_np1", kb.cw_np1[:, :width]))}

    def host_frontier(kb: KeyBundle, b: int):
        return tuple(torch.from_numpy(a).to(dev)
                     for a in tree_expand_np(prg, kb, b, HOST_LEVELS))

    def table_of(kb: KeyBundle, b: int, k: int) -> torch.Tensor:
        t = on_card(kb)
        s, v, tt = tree_expand(aes, t["cw_s"][0], t["cw_v"][0], t["cw_t"][0],
                               *host_frontier(kb, b), k0=HOST_LEVELS, k1=k,
                               group=kb.group)
        return frontier_table(s, v, tt)

    def keys(k_num: int, group: str, bound: Bound):
        alphas = rng.integers(0, 256, (k_num, N_BYTES), dtype=np.uint8)
        return alphas, gen_batch(
            prg, alphas, rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
            random_s0s(k_num, 16, rng), bound, group=group)

    t0 = time.perf_counter()
    k_full = 21
    for group in GROUPS:
        for bound in Bound:
            alphas, bundle = keys(1, group, bound)
            xs = torch.from_numpy(
                planted_points(alphas[0], M_CHECK)[None]).to(dev)
            for b in (0, 1):
                t = on_card(bundle.for_party(b))
                args = (aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"],
                        t["cw_np1"], xs)
                same("B1", f"{group} {bound.name} party {b}",
                     walk_eval(*args, b=b, group=group),
                     walk_eval_plain(*args, b=b, group=group))
                table = table_of(bundle.for_party(b), b, k_full)
                pargs = (aes, table, t["cw_s"], t["cw_v"], t["cw_t"],
                         t["cw_np1"], xs)
                neg = bool(b) and group != "xor"
                same("B3", f"{group} {bound.name} party {b}",
                     prefix_eval(*pargs, k=k_full, negate=neg, group=group),
                     prefix_eval_plain(*pargs, k=k_full, negate=neg,
                                       group=group))
    log(f"phase 3 B1, B3: byte-identical to their plain versions over 4 "
        f"groups x 2 bounds x 2 parties at {M_CHECK} points "
        f"({time.perf_counter() - t0:.1f} s)")

    alphas, bundle = keys(3, "add16", Bound.GT_BETA)
    xs3 = np.stack([planted_points(a, M_CHECK) for a in alphas])
    xs3 = torch.from_numpy(xs3).to(dev)
    for b in (0, 1):
        t = on_card(bundle.for_party(b))
        args = (aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"],
                xs3)
        same("B1", f"K=3 per-key party {b}",
             walk_eval(*args, b=b, group="add16"),
             walk_eval_plain(*args, b=b, group="add16"))
    log("phase 3 B1: K=3 keys with per-key points byte-identical, both "
        "parties")

    t0 = time.perf_counter()
    for group in GROUPS:
        _, bundle = keys(1, group, Bound.LT_BETA)
        for b in (0, 1):
            kb = bundle.for_party(b)
            t = on_card(kb)
            s, v, tt = host_frontier(kb, b)
            got = tree_expand(aes, t["cw_s"][0], t["cw_v"][0], t["cw_t"][0],
                              s, v, tt, k0=HOST_LEVELS, k1=k_full,
                              group=group)
            for i in range(HOST_LEVELS, k_full):
                s, v, tt = tree_expand_level_plain(
                    aes, t["cw_s"][0, i], t["cw_v"][0, i], t["cw_t"][0, i],
                    s, v, tt, group=group)
            for name, g_, w_ in zip("svt", got, (s, v, tt)):
                same("B2", f"{group} party {b} {name}", g_, w_)
    log(f"phase 3 B2: levels {HOST_LEVELS}..{k_full - 1} byte-identical to "
        f"the plain version over 4 groups x 2 parties "
        f"({time.perf_counter() - t0:.1f} s)")

    # The large-lambda kernels at lam = 256: B4 + W1 from the root, and
    # B5a + B5b + W1 from a depth-K_CHECK frontier, against their plain
    # versions; W1 gets each walk's own trajectories.
    wck = [rng.bytes(32) for _ in range(2 * (LAM_WIDE // 16))]
    wprg = HirosePrgNp(LAM_WIDE, wck)
    waes = torch.from_numpy(narrow_aes_image(wck[0], wck[17])).to(dev)

    def wide_keys(k_num: int, bound: Bound):
        alphas = rng.integers(0, 256, (k_num, N_BYTES), dtype=np.uint8)
        return alphas, gen_batch(
            wprg, alphas,
            rng.integers(0, 256, (k_num, LAM_WIDE), dtype=np.uint8),
            random_s0s(k_num, LAM_WIDE, rng), bound)

    def wide_of(kb: KeyBundle):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in wide_affine_batch_np(kb))

    def check_w1(what: str, y, traj, yp, trajp, wide) -> None:
        same("W1", what, wide_tail(y, traj, *wide),
             wide_tail_plain(yp, trajp, *wide))

    t0 = time.perf_counter()
    for bound in Bound:
        alphas, bundle = wide_keys(1, bound)
        xs = torch.from_numpy(
            planted_points(alphas[0], M_CHECK)[None]).to(dev)
        for b in (0, 1):
            kb = bundle.for_party(b)
            t = on_card(kb, 32)
            wide = wide_of(kb)
            what = f"lam={LAM_WIDE} {bound.name} party {b}"
            nargs = (waes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"],
                     t["cw_np1"], xs)
            y, traj = narrow_walk(*nargs, b=b, lam=LAM_WIDE)
            yp, trajp = narrow_walk_plain(*nargs, b=b, lam=LAM_WIDE)
            same("B4", what + " y[:32]", y[..., :32], yp[..., :32])
            same("B4", what + " trajectory", traj, trajp)
            check_w1(what + " from B4", y, traj, yp, trajp, wide)
            fargs = (waes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"])
            rows, words = narrow_frontier(*fargs, k=K_CHECK, b=b)
            rowsp, wordsp = narrow_frontier_plain(*fargs, k=K_CHECK, b=b)
            same("B5a", what + " rows", rows, rowsp)
            same("B5a", what + " words", words, wordsp)
            pargs = (waes, rows, words, t["cw_s"], t["cw_v"], t["cw_t"],
                     t["cw_np1"], xs)
            y2, traj2 = hybrid_prefix_eval(*pargs, k=K_CHECK, lam=LAM_WIDE)
            y2p, traj2p = hybrid_prefix_eval_plain(*pargs, k=K_CHECK,
                                                   lam=LAM_WIDE)
            same("B5b", what + " y[:32]", y2[..., :32], y2p[..., :32])
            same("B5b", what + " trajectory", traj2, traj2p)
            check_w1(what + " from B5b", y2, traj2, y2p, traj2p, wide)
            if not torch.equal(y2, y):
                raise RuntimeError(f"{what}: the prefix path's shares differ "
                                   "from the from-root path's")
    alphas, bundle = wide_keys(3, Bound.GT_BETA)
    xs = torch.from_numpy(planted_points(alphas[0], M_CHECK)[None]).to(dev)
    for b in (0, 1):
        kb = bundle.for_party(b)
        t = on_card(kb, 32)
        nargs = (waes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"],
                 t["cw_np1"], xs)
        y, traj = narrow_walk(*nargs, b=b, lam=LAM_WIDE)
        yp, trajp = narrow_walk_plain(*nargs, b=b, lam=LAM_WIDE)
        same("B4", f"K=3 party {b} y[:32]", y[..., :32], yp[..., :32])
        same("B4", f"K=3 party {b} trajectory", traj, trajp)
        check_w1(f"K=3 party {b}", y, traj, yp, trajp, wide_of(kb))
    log(f"phase 3 B4, W1, B5a, B5b: byte-identical to their plain versions "
        f"at lam={LAM_WIDE}, {M_CHECK} points, 2 bounds x 2 parties (B5a/B5b "
        f"at k={K_CHECK}, prefix shares equal to from-root shares), and B4 + "
        f"W1 with K=3 ({time.perf_counter() - t0:.1f} s)")

    # -- phase 4: the main paths through the facade --------------------------------
    counters = {"B1": walk_eval, "B2": tree_expand_level, "B3": prefix_eval,
                "B4": narrow_walk, "B5a": narrow_frontier,
                "B5b": hybrid_prefix_eval, "W1": wide_tail}
    launches = {k: 0 for k in counters}
    main_ms = {}
    main_inputs = {}
    paths = (("walk", 16, "walk", None, ("B1",)),
             ("prefix", 16, "prefix", None, ("B2", "B3")),
             ("hybrid", LAM_WIDE, "auto", None, ("B4", "W1")),
             ("hybrid prefix", LAM_WIDE, "hybrid",
              {"prefix_levels": K_HYBRID}, ("B5a", "B5b", "W1")))
    for name, lam, backend, opts, want_kernels in paths:
        mrng = np.random.default_rng(SEED + 1)
        mck = [mrng.bytes(32) for _ in range(max(2, 2 * (lam // 16)))]
        alphas = mrng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
        betas = mrng.integers(0, 256, (1, lam), dtype=np.uint8)
        xs = mrng.integers(0, 256, (M_MAIN, N_BYTES), dtype=np.uint8)
        for fn in counters.values():
            fn.launches = 0
        dcf = Dcf(N_BYTES, lam, mck, backend=backend, backend_opts=opts)
        bundle = dcf.gen(alphas, betas, rng=mrng)
        anchors = [dcf.eval(b, bundle, xs[:M_ANCHOR]) for b in (0, 1)]
        bes = [dcf.eval_backend(b) for b in (0, 1)]
        staged = bes[0].stage(xs)
        ys = [bes[b].eval_staged(b, staged) for b in (0, 1)]
        mism = int(bes[0].points_mismatch_count(
            ys[0], ys[1], alphas[0].tobytes(), betas[0].tobytes(), staged))
        torch.cuda.synchronize()
        ran = {k: fn.launches for k, fn in counters.items()}
        if mism != 0:
            raise RuntimeError(f"{name}: {mism} two-party mismatches over "
                               f"{M_MAIN} points")
        mprg = HirosePrgNp(lam, mck)
        for b in (0, 1):
            want = eval_batch_np(mprg, b, bundle.for_party(b),
                                 xs[:M_ANCHOR])
            staged_bytes = bes[b].staged_to_bytes(ys[b], M_ANCHOR)
            if not (np.array_equal(anchors[b], want)
                    and np.array_equal(staged_bytes, want)):
                raise RuntimeError(f"{name}: party {b} differs from the "
                                   f"numpy oracle on the first {M_ANCHOR} "
                                   "points")
            if tuple(ys[b].shape) != (1, M_MAIN, lam):
                raise RuntimeError(f"{name}: shares of shape "
                                   f"{tuple(ys[b].shape)}")
        for k in want_kernels:
            if ran[k] == 0:
                raise RuntimeError(f"{name}: kernel {k} never launched on "
                                   "the main path")
            launches[k] += ran[k]
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bes[0].eval_staged(0, staged)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        main_ms[name] = float(np.median(times)) * 1e3
        log(f"phase 4 {name} (lam={lam}, backend={dcf.backend_name}, "
            f"opts={opts}): 0 mismatches over {M_MAIN} points (two parties, "
            f"on the card); first {M_ANCHOR} points equal the numpy oracle; "
            f"launches {ran}; eval_staged median {main_ms[name]:.3f} ms = "
            f"{M_MAIN / main_ms[name] * 1e3:,.0f} evals/s over {REPEATS} "
            f"repeats [{card}]")
        main_inputs[name] = (bundle.for_party(0), staged["xs"], bes[0].aes)

    # -- phase 5: the reference crate's large-lambda shape ----------------------------
    t0 = time.perf_counter()
    crng = np.random.default_rng(SEED + 2)
    cck = [crng.bytes(32) for _ in range(2 * (LAM_CRATE // 16))]
    alphas = crng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
    betas = crng.integers(0, 256, (1, LAM_CRATE), dtype=np.uint8)
    xs = planted_points(alphas[0], M_CRATE)
    dcf = Dcf(N_BYTES, LAM_CRATE, cck)
    bundle = dcf.gen(alphas, betas, rng=crng)
    bes = [dcf.eval_backend(b) for b in (0, 1)]
    for b in (0, 1):
        bes[b].put_bundle(bundle.for_party(b))
    staged = bes[0].stage(xs)
    ys = [bes[b].eval_staged(b, staged) for b in (0, 1)]
    mism = int(bes[0].points_mismatch_count(
        ys[0], ys[1], alphas[0].tobytes(), betas[0].tobytes(), staged))
    if mism != 0:
        raise RuntimeError(f"lam={LAM_CRATE}: {mism} two-party mismatches")
    cprg = HirosePrgNp(LAM_CRATE, cck)
    for b in (0, 1):
        want = eval_batch_np(cprg, b, bundle.for_party(b),
                             xs[:M_CRATE_ANCHOR])
        if not np.array_equal(bes[b].staged_to_bytes(ys[b], M_CRATE_ANCHOR),
                              want):
            raise RuntimeError(f"lam={LAM_CRATE}: party {b} differs from "
                               f"the numpy oracle on the first "
                               f"{M_CRATE_ANCHOR} points")
    kb = bundle.for_party(0)
    t = on_card(kb, 32)
    y, traj = narrow_walk(bes[0].aes, t["s0"], t["cw_s"], t["cw_v"],
                          t["cw_t"], t["cw_np1"], staged["xs"], b=0,
                          lam=LAM_CRATE)
    wide = wide_of(kb)
    yp = y.clone()
    check_w1(f"lam={LAM_CRATE}", y, traj, yp, traj, wide)
    w1_crate_ms, _ = cuda_ms(lambda: wide_tail(y, traj, *wide), 10)
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bes[0].eval_staged(0, staged)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    crate_ms = float(np.median(times)) * 1e3
    log(f"phase 5 lam={LAM_CRATE}, {M_CRATE} points (backend "
        f"{dcf.backend_name}, from the root): 0 mismatches, first "
        f"{M_CRATE_ANCHOR} points equal the numpy oracle, W1 over "
        f"{-(-(LAM_CRATE - 32) // 128)} column tiles byte-identical to its "
        f"plain version; eval_staged median {crate_ms:.3f} ms = "
        f"{M_CRATE / crate_ms * 1e3:,.0f} evals/s over {REPEATS} repeats, "
        f"W1 alone {w1_crate_ms:.3f} ms ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")

    # -- phase 6: kernel times at the main paths' shapes ----------------------------
    # Each kernel is also held against its plain version on these inputs,
    # so max_abs_err covers the shape the kernel is timed at.
    #
    # Each bound counts the AES blocks the function needs on this run's
    # points, 14 rounds x 16 table lookups a block.  A walk follows one
    # child per level.  At lam = 16 a left turn needs E(s) and E(~s), a
    # right turn only E(~s) (for t_r; its s and v are copies of s and ~s).
    # The narrow walk's left turn needs E0(sa) and E0(~sa), its right turn
    # E0(~sa), E17(sb) and E17(~sb).  A full expansion (B2, B5a) needs
    # every block of each parent once.
    def right_turns(xs: torch.Tensor, lo: int, hi: int) -> int:
        return int(walk_bits_plain(xs)[..., lo:hi].sum(dtype=torch.int64))

    kb, xs, _ = main_inputs["walk"]
    t = on_card(kb)
    args = (aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"], xs)
    n = 8 * N_BYTES
    b1_ms, got = cuda_ms(lambda: walk_eval(*args, b=0, group="xor"), 10)
    b1_plain, want = cuda_ms(
        lambda: walk_eval_plain(*args, b=0, group="xor"), 1)
    same("B1", f"main shape {tuple(xs.shape)}", got, want)
    b1_lookups = (2 * M_MAIN * n - right_turns(xs, 0, n)) * 14 * 16
    b1_bytes = M_MAIN * N_BYTES + M_MAIN * 16 + n * 34 + 32 + 496

    kb, xs, _ = main_inputs["prefix"]
    t = on_card(kb)
    s, v, tt = host_frontier(kb, 0)
    targs = (aes, t["cw_s"][0], t["cw_v"][0], t["cw_t"][0])
    b2_ms, got = cuda_ms(lambda: tree_expand(*targs, s, v, tt, k0=HOST_LEVELS,
                                             k1=k_full, group="xor"), 10)

    def tree_plain():
        st = (s, v, tt)
        for i in range(HOST_LEVELS, k_full):
            st = tree_expand_level_plain(
                aes, t["cw_s"][0, i], t["cw_v"][0, i], t["cw_t"][0, i], *st,
                group="xor")
        return st

    b2_plain, want = cuda_ms(tree_plain, 1)
    for name, g_, w_ in zip("svt", got, want):
        same("B2", f"main shape, levels {HOST_LEVELS}..{k_full - 1} {name}",
             g_, w_)
    parents = (1 << k_full) - (1 << HOST_LEVELS)
    b2_lookups = parents * 2 * 14 * 16
    # The function's bytes: the level-k0 nodes read once, the level-k1
    # nodes written once (33 bytes a node), the CWs and the cipher image.
    # This design also writes and reads back every level between them
    # (b2_level_bytes), which a fused build would not have to.
    b2_bytes = ((1 << HOST_LEVELS) + (1 << k_full)) * 33 \
        + (k_full - HOST_LEVELS) * 34 + 496
    b2_level_bytes = 3 * parents * 33 + (k_full - HOST_LEVELS) * (34 + 496)

    table = table_of(kb, 0, k_full)
    pargs = (aes, table, t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"], xs)
    b3_ms, got = cuda_ms(lambda: prefix_eval(*pargs, k=k_full, negate=False,
                                             group="xor"), 10)
    b3_plain, want = cuda_ms(lambda: prefix_eval_plain(
        *pargs, k=k_full, negate=False, group="xor"), 1)
    same("B3", f"main shape {tuple(xs.shape)}", got, want)
    rows = int(torch.unique(frontier_index_plain(xs[0], k_full)).numel())
    b3_lookups = (2 * M_MAIN * (n - k_full)
                  - right_turns(xs, k_full, n)) * 14 * 16
    b3_bytes = M_MAIN * N_BYTES + rows * 32 + M_MAIN * 16 \
        + (n - k_full) * 34 + 16 + 496
    log(f"phase 6: B1, B2, B3 byte-identical to their plain versions at the "
        f"main path's shapes; B2's per-level traffic in this design is "
        f"{b2_level_bytes} bytes ({b2_level_bytes / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms at {HBM_BYTES_PER_S:.3e} B/s), its function's bytes "
        f"{b2_bytes}")

    # The large-lambda kernels at the lam = 256 main path's shape: one key,
    # 2^20 shared points, the frontier at k = K_HYBRID.
    kb, xs, maes = main_inputs["hybrid"]
    t = on_card(kb, 32)
    nt = -(-(n + 1) // 32)  # trajectory words per point
    nargs = (maes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"], xs)
    b4_ms, (y, traj) = cuda_ms(
        lambda: narrow_walk(*nargs, b=0, lam=LAM_WIDE), 10)
    b4_plain, (yp, trajp) = cuda_ms(
        lambda: narrow_walk_plain(*nargs, b=0, lam=LAM_WIDE), 1)
    same("B4", "main shape y[:32]", y[..., :32], yp[..., :32])
    same("B4", "main shape trajectory", traj, trajp)
    b4_lookups = (2 * M_MAIN * n + right_turns(xs, 0, n)) * 14 * 16
    b4_bytes = M_MAIN * (N_BYTES + 32 + 4 * nt) + n * 66 + 64 + 736

    wide = wide_of(kb)
    wd = LAM_WIDE - 32
    w1_ms, got = cuda_ms(lambda: wide_tail(y, traj, *wide), 10)
    w1_plain, want = cuda_ms(lambda: wide_tail_plain(yp, trajp, *wide), 1)
    same("W1", "main shape", got, want)
    set_bits = int(unpack_traj_plain(traj, n + 1).sum().item())
    w1_reads = set_bits * (wd // 4)
    w1_bytes = M_MAIN * (4 * nt + wd) + (n + 2) * wd
    # W1's bound is its bytes.  Two operation counts are printed as design
    # figures only: the shared-memory words this kernel reads (w1_reads),
    # and the int8 tensor-core operations of the product with every bit
    # unpacked to a byte (w1_int8_ops).  Neither is the function's floor:
    # a b1 MMA (AND + POPC) needs 8 times fewer operand bytes, and its rate
    # is not in the published table.
    w1_int8_ops = 2 * M_MAIN * (n + 1) * 8 * wd

    # The library's product: torch._int_mm (int8 x int8 -> int32) of the
    # unpacked trajectory bits and W's bits (column-major), the inner size
    # padded to a multiple of 8.  The low bit of each sum, packed and XORed
    # with const, is W1's output; the one call is timed.
    n1p = -(-(n + 1) // 8) * 8
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    t8 = torch.zeros((M_MAIN, n1p), dtype=torch.int8, device=dev)
    t8[:, :n + 1] = unpack_traj_plain(traj[0], n + 1)
    w8 = torch.zeros((8 * wd, n1p), dtype=torch.int8, device=dev)
    w8[:, :n + 1] = ((wide[1][0].unsqueeze(-1) >> shifts) & 1).reshape(
        n + 1, 8 * wd).t()
    w1_lib, acc = cuda_ms(lambda: torch._int_mm(t8, w8.t()), 10)
    parity = (acc & 1).to(torch.uint8).view(M_MAIN, wd, 8)
    del acc
    lib_y = (parity << shifts).sum(-1).to(torch.uint8) ^ wide[0][0]
    if not torch.equal(lib_y, got[0, :, NARROW:]):
        raise RuntimeError("W1: torch._int_mm's parity differs from W1")
    del t8, w8, parity, lib_y

    fargs = (maes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"])
    b5a_ms, (rows_t, words_t) = cuda_ms(
        lambda: narrow_frontier(*fargs, k=K_HYBRID, b=0), 10)
    b5a_plain, (rowsp, wordsp) = cuda_ms(
        lambda: narrow_frontier_plain(*fargs, k=K_HYBRID, b=0), 1)
    same("B5a", "main shape rows", rows_t, rowsp)
    same("B5a", "main shape words", words_t, wordsp)
    nodes = 1 << K_HYBRID
    b5a_lookups = (nodes - 1) * 4 * 14 * 16
    b5a_bytes = nodes * 68 + K_HYBRID * 66 + 32 + 736

    pargs = (maes, rows_t, words_t, t["cw_s"], t["cw_v"], t["cw_t"],
             t["cw_np1"], xs)
    b5b_ms, (y2, traj2) = cuda_ms(
        lambda: hybrid_prefix_eval(*pargs, k=K_HYBRID, lam=LAM_WIDE), 10)
    b5b_plain, (y2p, traj2p) = cuda_ms(
        lambda: hybrid_prefix_eval_plain(*pargs, k=K_HYBRID, lam=LAM_WIDE),
        1)
    same("B5b", "main shape y[:32]", y2[..., :32], y2p[..., :32])
    same("B5b", "main shape trajectory", traj2, traj2p)
    used = int(torch.unique(frontier_index_plain(xs[0], K_HYBRID)).numel())
    b5b_lookups = (2 * M_MAIN * (n - K_HYBRID)
                   + right_turns(xs, K_HYBRID, n)) * 14 * 16
    b5b_bytes = M_MAIN * (N_BYTES + 32 + 4 * nt) + used * 68 \
        + (n - K_HYBRID) * 66 + 32 + 736
    log(f"phase 6: B4, W1, B5a, B5b byte-identical to their plain versions "
        f"at the lam={LAM_WIDE} main path's shapes; W1 read {set_bits} set "
        f"trajectory bits of {M_MAIN * (n + 1)}; B5b gathered {used} of "
        f"{nodes} frontier rows")

    def bound(lookups: int, nbytes: int) -> tuple[float, str]:
        ops_ms = lookups / lookups_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms \
            else (bytes_ms, "bytes")

    rows_out = []
    for kid, src, rep, ms, plain, lk, nb in (
            ("B1", "walk_eval", "dcf_tpu/ops/pallas_eval.py:164", b1_ms,
             b1_plain, b1_lookups, b1_bytes),
            ("B2", "tree_expand", "dcf_tpu/ops/pallas_tree.py:92", b2_ms,
             b2_plain, b2_lookups, b2_bytes),
            ("B3", "prefix_eval", "dcf_tpu/ops/pallas_prefix.py:125", b3_ms,
             b3_plain, b3_lookups, b3_bytes),
            ("B4", "narrow_walk", "dcf_tpu/ops/pallas_narrow.py:170", b4_ms,
             b4_plain, b4_lookups, b4_bytes),
            ("B5a", "hybrid_state", "dcf_tpu/ops/pallas_hybrid_prefix.py:81",
             b5a_ms, b5a_plain, b5a_lookups, b5a_bytes),
            ("B5b", "hybrid_prefix",
             "dcf_tpu/ops/pallas_hybrid_prefix.py:160", b5b_ms, b5b_plain,
             b5b_lookups, b5b_bytes),
            ("W1", "wide_xor", "dcf_tpu/backends/large_lambda.py:203", w1_ms,
             w1_plain, 0, w1_bytes)):
        b_ms, b_by = bound(lk, nb)
        lib = w1_lib if kid == "W1" else None
        rows_out.append({
            "name": f"{kid} {src}", "route": "cuda",
            "source": f"dcf_tpu_torch/csrc/{src}.cu", "replaces": rep,
            "launches": launches[kid], "max_abs_err": max_err[kid],
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib})
        log(f"phase 6 {kid}: {ms:.3f} ms (plain {plain:.1f} ms, bound "
            f"{b_ms:.3f} ms by {b_by}: {lk:.3e} table lookups at "
            f"{lookups_per_s:.3e}/s, {nb} bytes at {HBM_BYTES_PER_S:.3e} B/s;"
            f" {b_ms / ms:.1%} of bound) [{card}]")
    log(f"phase 6 W1 design figures: {w1_reads:.3e} shared-memory word "
        f"reads ({w1_reads / lookups_per_s * 1e3:.3f} ms at "
        f"{lookups_per_s:.3e}/s); as an int8 tensor-core product "
        f"{w1_int8_ops:.3e} operations ({w1_int8_ops / INT8_OPS_PER_S * 1e3:.3f}"
        f" ms at {INT8_OPS_PER_S:.3e}/s); torch._int_mm "
        f"[{M_MAIN}x{n1p}] x [{n1p}x{8 * wd}] {w1_lib:.3f} ms, its parity "
        f"equal to W1's output [{card}]")

    # -- phase 7: the hybrid prefix depth on the card -------------------------------
    # B5a and B5b at depths beyond the facade's clamp, called directly on
    # the lam = 256 main inputs; every result equals the from-root walk's.
    for k in K_SWEEP:
        fr_ms, (rows_k, words_k) = cuda_ms(
            lambda k=k: narrow_frontier(*fargs, k=k, b=0), 1)
        pk = (maes, rows_k, words_k, t["cw_s"], t["cw_v"], t["cw_t"],
              t["cw_np1"], xs)
        ev_ms, (yk, trk) = cuda_ms(
            lambda k=k: hybrid_prefix_eval(*pk, k=k, lam=LAM_WIDE), 5)
        if not (torch.equal(yk[..., :NARROW], y[..., :NARROW])
                and torch.equal(trk, traj)):
            raise RuntimeError(f"phase 7 k={k}: the prefix walk differs "
                               "from the from-root walk")
        used_k = int(torch.unique(frontier_index_plain(xs[0], k)).numel())
        log(f"phase 7 k={k}: frontier {(rows_k.numel() + words_k.numel())}"
            f" bytes built by B5a in {fr_ms:.3f} ms; B5b {ev_ms:.3f} ms over "
            f"{n - k} walked levels = {ev_ms / (n - k) * 1e3:.2f} us a level "
            f"(B4 {b4_ms / n * 1e3:.2f}), {used_k} rows gathered; equal to "
            f"the from-root walk [{card}]")
        del rows_k, words_k, yk, trk
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
        "interpreter started the script's main")

    print(json.dumps({"kernels": rows_out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
