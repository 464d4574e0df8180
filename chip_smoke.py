"""Chip smoke run of the PyTorch/CUDA port (``dcf_tpu_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. build kernels B1-B3 from ``dcf_tpu_torch/csrc`` with nvcc, one process
   per source, and print the build seconds and ptxas' register counts;
3. hold each kernel byte for byte against its plain PyTorch version on the
   card, at 2^16 points (B2 from level 6 to 21): both parties, all four
   output groups, both bounds (B1, B3), x = alpha and alpha +- 1 planted;
   and B1 with 3 keys and per-key points;
4. the main path through the port's ``Dcf`` facade, for ``walk`` (B1) and
   ``prefix`` (B2 + B3): one key, n = 128, lam = 16, 2^20 random points,
   XOR group, host keygen; both parties over the same staged points; the
   full on-device two-party reconstruction (0 mismatches); the first 1024
   points against the port's numpy oracle; the launch counts; the median
   ``eval_staged`` time;
5. each kernel held byte for byte against its plain version at the main
   path's shapes (2^20 points; B2 from level 6 to 21), and its time there
   beside its plain version's and its bound.

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
REPEATS = 10  # timed eval_staged repeats per backend
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
LOOKUP_LANES = 32  # shared-memory words served per SM per clock


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
    from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.keys import KeyBundle
    from dcf_tpu_torch.ops.prefix_eval import (
        frontier_index_plain, frontier_table, prefix_eval, prefix_eval_plain)
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.tree_expand import (
        tree_expand, tree_expand_level, tree_expand_level_plain)
    from dcf_tpu_torch.ops.walk_eval import aes_image, walk_eval, walk_eval_plain
    from dcf_tpu_torch.spec import GROUPS

    dev = torch.device("cuda")

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
    regs = {k: re.findall(r"Used (\d+) registers", _build.build_log(k))
            for k in _build.KERNELS}
    log(f"phase 2 build: {build_s:.2f} s for {len(_build.KERNELS)} kernels; "
        "registers per instantiation (xor, add8, add16, add32 in some "
        f"order): {regs}")

    # -- phase 3: each kernel against its plain version --------------------------
    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    aes = torch.from_numpy(aes_image(ck[0])).to(dev)
    max_err = {"B1": 0, "B2": 0, "B3": 0}

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

    def on_card(kb: KeyBundle) -> dict:
        return {
            name: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for name, a in (("s0", kb.s0s[:, 0, :]), ("cw_s", kb.cw_s),
                            ("cw_v", kb.cw_v), ("cw_t", kb.cw_t),
                            ("cw_np1", kb.cw_np1))}

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

    # -- phase 4: the main path through the facade ---------------------------------
    counters = {"B1": walk_eval, "B2": tree_expand_level, "B3": prefix_eval}
    launches = {}
    main_ms = {}
    main_inputs = {}
    for name, want_kernels in (("walk", ("B1",)), ("prefix", ("B2", "B3"))):
        mrng = np.random.default_rng(SEED + 1)
        mck = [mrng.bytes(32), mrng.bytes(32)]
        alphas = mrng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
        betas = mrng.integers(0, 256, (1, 16), dtype=np.uint8)
        xs = mrng.integers(0, 256, (M_MAIN, N_BYTES), dtype=np.uint8)
        for fn in counters.values():
            fn.launches = 0
        dcf = Dcf(N_BYTES, 16, mck, backend=name)
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
        mprg = HirosePrgNp(16, mck)
        for b in (0, 1):
            want = eval_batch_np(mprg, b, bundle.for_party(b),
                                 xs[:M_ANCHOR])
            staged_bytes = bes[b].staged_to_bytes(ys[b], M_ANCHOR)
            if not (np.array_equal(anchors[b], want)
                    and np.array_equal(staged_bytes, want)):
                raise RuntimeError(f"{name}: party {b} differs from the "
                                   f"numpy oracle on the first {M_ANCHOR} "
                                   "points")
            if tuple(ys[b].shape) != (1, M_MAIN, 16):
                raise RuntimeError(f"{name}: shares of shape "
                                   f"{tuple(ys[b].shape)}")
        for k in want_kernels:
            if ran[k] == 0:
                raise RuntimeError(f"{name}: kernel {k} never launched on "
                                   "the main path")
            launches[k] = ran[k]
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bes[0].eval_staged(0, staged)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        main_ms[name] = float(np.median(times)) * 1e3
        log(f"phase 4 {name}: 0 mismatches over {M_MAIN} points (two "
            f"parties, on the card); first {M_ANCHOR} points equal the "
            f"numpy oracle; launches {ran}; eval_staged median "
            f"{main_ms[name]:.3f} ms = {M_MAIN / main_ms[name] * 1e3:,.0f} "
            f"evals/s over {REPEATS} repeats [{card}]")
        main_inputs[name] = (bundle.for_party(0), staged["xs"])

    # -- phase 5: kernel times at the main path's shapes ----------------------------
    # Each kernel is also held against its plain version on these inputs,
    # so max_abs_err covers the shape the kernel is timed at.
    kb, xs = main_inputs["walk"]
    t = on_card(kb)
    args = (aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"], xs)
    n = 8 * N_BYTES
    b1_ms, got = cuda_ms(lambda: walk_eval(*args, b=0, group="xor"), 10)
    b1_plain, want = cuda_ms(
        lambda: walk_eval_plain(*args, b=0, group="xor"), 1)
    same("B1", f"main shape {tuple(xs.shape)}", got, want)
    b1_lookups = M_MAIN * n * 2 * 14 * 16
    b1_bytes = M_MAIN * N_BYTES + M_MAIN * 16 + n * 34 + 32 + 496

    kb, xs = main_inputs["prefix"]
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
    b3_lookups = M_MAIN * (n - k_full) * 2 * 14 * 16
    b3_bytes = M_MAIN * N_BYTES + rows * 32 + M_MAIN * 16 \
        + (n - k_full) * 34 + 16 + 496
    log(f"phase 5: B1, B2, B3 byte-identical to their plain versions at the "
        f"main path's shapes; B2's per-level traffic in this design is "
        f"{b2_level_bytes} bytes ({b2_level_bytes / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms at {HBM_BYTES_PER_S:.3e} B/s), its function's bytes "
        f"{b2_bytes}")

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
             b3_plain, b3_lookups, b3_bytes)):
        b_ms, b_by = bound(lk, nb)
        rows_out.append({
            "name": f"{kid} {src}", "route": "cuda",
            "source": f"dcf_tpu_torch/csrc/{src}.cu", "replaces": rep,
            "launches": launches[kid], "max_abs_err": max_err[kid],
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
        log(f"phase 5 {kid}: {ms:.3f} ms (plain {plain:.1f} ms, bound "
            f"{b_ms:.3f} ms by {b_by}: {lk:.3e} table lookups at "
            f"{lookups_per_s:.3e}/s, {nb} bytes) [{card}]")

    print(json.dumps({"kernels": rows_out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
