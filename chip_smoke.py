"""Chip smoke run of the PyTorch/CUDA port (``dcf_tpu_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. build every kernel (B1-B8, B2f, G1, G2, W1, W2, P1, E1: thirteen
   sources) from
   ``dcf_tpu_torch/csrc`` with nvcc, one process per source, all at once,
   and print the build seconds and ptxas' register and spill counts (on a
   line of their own, by kernel function, for B8, B4, B1, B3, B6, B5b, G1,
   B7a, B7b, B5a, B2, B2f, E1 and G2, the kernels on the banked AES);
3. hold each kernel byte for byte against its plain PyTorch version on the
   card, at 2^16 points: B1-B3 (B2 from level 6 to 21) over both parties,
   all four output groups, both bounds, and B1 with 3 keys and per-key
   points; B2 also in launches of depth 1, 2 and 3 and over spans of 7 and
   5 levels (cut 1 + 3 + 3 and 2 + 3), four groups, both parties; B4 + W1
   and B5a + B5b (k = 16, 20) + W1 at lam = 256 over both parties and
   both bounds, and B4 + W1 with 3 keys; x = alpha and alpha +- 1 planted
   throughout;
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
   path's shapes (2^20 points; B2 levels 6 to 20, after two untimed calls;
   B5a k = 20), and its time there beside its plain version's and its
   bound (B5a's also as device and host time a call apart); W1 also beside
   ``torch._int_mm``, the library's integer product, whose parity is
   checked against W1's output, and beside three design figures: the
   bit walk's shared-memory reads, the int8 tensor-core product's
   operations and its own table reads; B4, B5b, B1 and B3 also beside the
   AES lookups their designs compute per lookup their bounds count, on
   the run's own turns;
7. the hybrid prefix depth on the card: B5a and B5b called directly at
   k = 16..24 on the lam = 256 main inputs, each result equal to the
   from-root walk's, B5a's device and host time a call, and B5b's time per
   walked level beside B4's;
8. the full-domain kernels against their plain versions at n = 16: B6
   (K = 3, from level 6, the leaf correction, both parties: one level a
   launch to full depth and to the prefix depth 13, and 1-3 levels a
   launch as ``evalall_expand`` cuts them, to full depth and to 14, the
   last launch also writing t alone, packed, as for PIR; and t alone from
   the roots to depths 1-8), B2f (both bounds, both parties, the last 1,
   2 and 3 levels a launch) and P1 (K = 3, 32-byte records, B6's own
   packed words; and K = 1, 5, 9 at R = 4, 36, 528);
9. full-domain evaluation, lam = 16, n = 24 (BASELINE.json config 3), both
   bounds: ``TreeFullDomain.check`` (B2 + B2f) gives 0, and 7 for
   alpha + 7; beside it the per-point ``full_domain_check_device`` over two
   ``WalkBackend``s (B1) gives 0; both timed;
10. DPF EvalAll, lam = 32, n = 24, K = 4, keys from ``Dcf.dpf``:
    ``DpfEvalAll.check`` (B6) gives 0, a tampered alpha is counted, and
    the first 4096 leaves and the leaf at bitreverse(alpha) of
    ``Dcf.eval_all`` (by default on the card, from the roots) equal
    ``dpf_eval_points`` on the host;
11. 2-server PIR through ``PirServer`` (B6 + P1), 32-byte records, at
    n = 14, 16, 18 and 24 (2^24 records, 512 MiB on the card): queries
    from ``Dcf.pir_query``, registered as DCFK frames; records 0, 2^n - 1
    and four random ones reconstruct bit-exactly from both parties'
    answers; then queries/s with K = 4 and a fresh bundle per call, the
    evaluator's default (no level on the host), and at n = 24 once more
    with the top 6 levels on the host;
12. B6, B2f and P1 against their plain versions at those paths' shapes
    (n = 24; B6 both parties, and its t-only words; P1 on those words;
    B2f's launch as ``tree_expand_device`` makes it, the last
    ``FINAL_LEVELS`` levels), their times and bounds, and B2 on the full
    domain's levels from 6 to B2f's, held against its plain version for
    both bounds' keys and timed after two untimed calls (B2f and P1 too);
    P1 also beside
    ``torch._int_mm`` on the selection and the database unpacked to bits,
    whose parity is checked against P1;
    each B6 launch the paths of phases 10-11 make (a level and 1-3 levels
    deep) and B1 a launch at the per-point full domain's shape (n = 24,
    2^20 points), each beside its bound: with B1 at the walk path's two
    shapes and B2 at the prefix path's (phase 6), the script ends by
    printing launches x (ms - bound) of B1, B2 and B6 on each path;
13. the keygen kernels against their plain versions, K = 4096, both
    bounds: G1 (lam = 16) and B7a (lam = 256) at n = 128, B7b (lam = 32)
    at n = 24; W2 on B7a's outputs at lam = 256, K = 4096 and at
    lam = 16384, K = 64, both bounds, every byte of cw_s, cw_v and
    cw_np1;
14. keygen at its full shapes, timed (G1 after two untimed calls, so that
    its 4.4 GB of outputs are not allocated inside the timed window), the
    first 1024 keys of each held
    against the numpy ``gen_batch`` / ``dpf_gen_batch``: G1 at 10^6 keys;
    B7a and W2, its wide tail, at lam = 256, K = 2^16 and at
    lam = 16384, K = 64 (all 64 keys; B7a there also against its plain
    version), every byte of the keys; B7b at n = 24, K = 2^16 (after two
    untimed calls);
15. B8 against its plain version, both bounds, both parties: at
    K = 1024 keys x 1024 points, at K = 4099 x 1000 (a group of 3 keys
    past the last full one, and points that do not divide among a block's
    warps) and at n = 256, K = 100 x 40 (levels past the 160 staged in
    shared memory read from the key rows); and B1 at K = 65,537 keys x 64
    points (two launches of at most 65,535 keys) against its plain
    version;
16. keygen through the facade (``Dcf.gen`` at lam = 16, 256 and 16384,
    ``Dcf.dpf`` at lam = 32; the first 64 keys against the numpy oracle),
    then BASELINE.json config 5 at full size: ``secure_relu_check_device``
    over 10^6 keys x 1024 shared points, n = 128, both parties (G1, B8
    twice and the count per chunk of 2^17 keys): 0 mismatches; the first
    chunk's shares recounted give 0, and >= 1 with alpha_0 moved by one;
    the first 64 keys' shares at the first 32 points equal the numpy
    oracle; wall time and evals/s; B8 timed on the first chunk's inputs.
    The keygen rows' plain times are taken at the check shapes (phase 13,
    and K = 64 at lam = 16384), B8's at K = 1024 x 1024: the rows say so
    in ``shape`` and ``plain_shape``.  W2's rows are bound by bytes;
17. ``bench_torch.run()``, the port's bench line, at full size (the
    prefix path, 2^20 points, its full two-party check and its 4096-point
    anchor against the C++ core: a parity failure fails the smoke), its
    JSON line logged; then the C++ core's ``NativeDcf.gen_batch`` against
    the numpy ``gen_batch``, 64 keys at lam = 16 and 256, both bounds;
18. the interval protocols and fixed-point gates (``protocols``): B1 at
    n = 8 and 16 and B2 + B3 at n = 16 (k = 8) and n = 128 (k = 17), each
    with K = 16 keys at shared points (the 2m bound keys of an 8-interval
    MIC), in xor, add16 and add32, both bounds and parties, x = alpha and
    alpha +- 1 planted, against their plain versions at 2^16 points, and
    ``PrefixBackend``'s own depth, B2 launches and cached frontier; MIC
    at mic_bench's shape (n = 128, 8 intervals from a seed, one wrapping,
    one with q = 2^128, 2^20 shared points, XOR, and the same intervals
    in add16 at 2^20 - 5 points): ``Dcf.mic(device=True)`` (G1) against
    the host walk's frame, ``walk`` and ``prefix``, both parties,
    ``eval_mic`` and ``MicEvaluator`` (the pair combine on the card, an
    XOR or a lane add) giving the same bytes, ``mic_oracle`` on the
    first 2^16 points, a count of every point on the card against an
    indicator computed there from the points' bytes (0), party 0's times
    and the staged combine's; the gates at gate_bench's shape (n = 16, f = 8,
    add16, 8 sigmoid pieces, 2^20 masked inputs): sign, truncation (its
    low half on an n = 8 walk) and sigmoid on ``walk``, sign and sigmoid
    on ``prefix``, every output against its oracle, party 0's times; then
    B1, B2, B3 and G1 at those paths' shapes, timed, held against their
    plain versions, and added to the kernels' line;
19. DCF at lam = 32 on the card: E1 against its plain version at 2^16
    points, n = 16 and 128, all four groups, both bounds and parties, 3
    keys at shared and at per-key points, x = alpha and alpha +- 1
    planted, root seeds with the PRG's masked bit set; G2 against its
    plain version at K = 4096, n = 128, both bounds, every byte; the
    facade ``Dcf(16, 32)`` (``auto`` = ``walk``), one key, n = 128, 2^20
    random shared points, in XOR (keys from G2) and add32 (host keys):
    both parties over the same staged points, 0 mismatches on the card,
    the first 1024 points against the numpy oracle, the keys against
    ``gen_batch``, the median ``eval_staged`` time; E1 at that shape
    beside its bound, its plain version and B4's time in this run; G2 at
    K = 2^16, n = 128 after two untimed calls, its first 1024 keys
    against ``gen_batch``; the per-point full domain at n = 24 over two
    lam = 32 ``WalkBackend``s, both bounds: 0, and 7 for alpha + 7; MIC
    at n = 128, 8 intervals, 2^16 shared points: ``Dcf.mic(device=True)``
    (G2) against the host walk's frame, ``MicEvaluator`` on lam = 32
    walk backends in XOR and add32 against ``mic_oracle``.

Launches are counted per path: the counts are set to 0 just before one
run of a path and read just after it, before any timed repeat, and held
against the number that run must make (phases 9-11, 16, 18 and 19; phase 4's run
is both parties' anchor and staged evaluations).  The next to last line is one JSON
object with every kernel's numbers, ``launches`` the sum over those single
runs and ``launches_by_path`` each of them; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or run from a directory
that does not hold the package, it exits non-zero and prints no result.
Only torch and numpy are used (no JAX, nothing of ``dcf_tpu``).
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
N_CHECK = 16  # domain bits of the full-domain kernel-vs-plain checks
N_FULL = 24  # domain bits of the full-domain, DPF and top PIR paths
K_DPF = 4  # DPF keys (PIR queries) per batch
RECORD_BYTES = 32  # PIR record width
PIR_BITS = (14, 16, 18, N_FULL)  # PIR database domains
PIR_REPS = 5  # timed PIR batches per domain
M_LEAVES = 4096  # leading leaves held against the per-point host walk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
LOOKUP_LANES = 32  # shared-memory words served per SM per clock
LOOKUPS_BLOCK = 14 * 16  # T-table lookups of one AES-256 block
# ... of bit 0 alone (a walk's t bit): 12 full rounds, the 4 lookups of
# round 13's column that feeds byte 0, and byte 0's S-box lookup
LOOKUPS_T_BIT = 12 * 16 + 4 + 1
# ... of a DPF tree's parent (kernel B6): E0(s_b0) and E17(s_b1) in full,
# E0(~s_b0) to its t bit
LOOKUPS_DPF_NODE = 2 * LOOKUPS_BLOCK + LOOKUPS_T_BIT
# ... where only the leaves' t bits are read (a PIR selection): block 1
# feeds neither a child's block 0 nor a t bit, so E17 is not needed;
# a parent needs E0(s_b0) and E0(~s_b0)'s t bit, one on the last level the
# two t bits alone
LOOKUPS_DPF_T_NODE = LOOKUPS_BLOCK + LOOKUPS_T_BIT
LOOKUPS_DPF_T_LEAF = 2 * LOOKUPS_T_BIT
INT8_OPS_PER_S = 1.979e15  # H100 SXM published dense int8 tensor rate
K_KEYGEN_CHECK = 4096  # keys of the keygen kernel-vs-plain checks
K_ANCHOR = 1024  # keys held against the numpy keygen oracle
N_DPF_KEYGEN = 24  # DPF keygen depth (the PIR domain)
K_RELU = 10**6  # BASELINE.json config 5: 10^6 keys x 1024 shared points
M_RELU = 1024
K_RELU_ANCHOR = 64  # config-5 keys held against the numpy oracle ...
M_RELU_ANCHOR = 32  # ... at these leading points
K_WIDE_KEYGEN = 1 << 16  # B7a's and W2's timed shape at lam = 256 (B7b's
                         # at n = 24)
K_CRATE_KEYGEN = 64  # B7a's and W2's timed shape at lam = 16384
K_B8_CHECK = 1024  # B8 kernel-vs-plain keys, at M_RELU points
K_B8_TAIL, M_B8_TAIL = 4099, 1000  # B8 with a partial group and odd points
K_B8_DEEP, M_B8_DEEP, N_B8_DEEP = 100, 40, 256  # B8 past its staged levels
K_MIC = 16  # the 2m bound keys of an 8-interval MIC, packed on the K axis
K_CAP = 65537  # B1 beyond the 65,535-block grid axis ...
M_CAP = 64  # ... at these points


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def pair_lookups_computed(bits) -> int:
    """The AES table lookups B1's and B3's design computes
    (``walk_level_pair`` in ``csrc/aes_banked.cuh``) on points whose walk
    bits over the walked levels are ``bits`` (uint8 [M, L], one key): the
    points in warp units of 64, a unit's points past the last repeating
    the last one, lane l walking points l and 32 + l; at a level, each of
    the two point slots computes E(s) and E(~s) on all 32 lanes where one
    of its 32 points turns left, else bit 0 of E(~s)."""
    import torch

    pad = -bits.shape[0] % 64
    if pad:
        bits = torch.cat([bits, bits[-1:].expand(pad, -1)])
    any_left = (bits.reshape(-1, 2, 32, bits.shape[1]) == 0).any(2)
    return 32 * int(torch.where(any_left, 2 * LOOKUPS_BLOCK,
                                LOOKUPS_T_BIT).sum())


def ptxas_functions(log: str) -> dict:
    """ptxas' (registers, spill-store bytes) of each kernel function in a
    build log, by its name (a template's integer and bool arguments in
    brackets)."""
    out = {}
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores"
            r".*?Used (\d+) registers", log, re.S):
        mangled, i, names = m.group(1), 2, []
        if mangled.startswith("_ZN"):
            i = 3
        while i < len(mangled) and mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            names.append(mangled[j:j + int(mangled[i:j])])
            i = j + int(mangled[i:j])
        arg = re.match(r"(?:E)?I((?:L[ib]\d+E)+)E", mangled[i:])
        name = names[-1] + (
            "<" + ",".join(re.findall(r"L[ib](\d+)E", arg.group(1))) + ">"
            if arg else "")
        out[name] = (int(m.group(3)), int(m.group(2)))
    return out


def device_host_ms(fn, reps: int) -> tuple[float, float]:
    """Device and host ms a call of ``fn`` apart: the device's, by CUDA
    events around ``reps`` calls enqueued behind a long sleep of the card
    (so that it never waits for the host); the host's, wall time over
    ``reps`` calls that do not wait for the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, host


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
    from dcf_tpu_torch.backends.evalall import (
        DpfEvalAll, bitrev, dpf_tree_expand_np)
    from dcf_tpu_torch.backends.fulldomain import (
        TreeFullDomain, tree_expand_np)
    from dcf_tpu_torch.backends.large_lambda import wide_affine_batch_np
    from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
    from dcf_tpu_torch.backends.walk_backend import WalkBackend
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.keys import KeyBundle
    from dcf_tpu_torch.ops._launch import launch_depths
    from dcf_tpu_torch.ops.evalall_expand import (
        evalall_expand, evalall_expand_level, evalall_expand_level_plain)
    from dcf_tpu_torch.ops.hybrid_prefix import (
        frontier_launches, hybrid_prefix_eval, hybrid_prefix_eval_plain,
        narrow_frontier, narrow_frontier_plain)
    from dcf_tpu_torch.ops.narrow_walk import (
        NARROW, NARROW_AES_BYTES, narrow_aes_image, narrow_walk,
        narrow_walk_plain, unpack_traj_plain)
    from dcf_tpu_torch.ops.prefix_eval import (
        frontier_index_plain, frontier_table, prefix_eval, prefix_eval_plain)
    from dcf_tpu_torch.ops.pir_answer import (
        pack_selection, pir_answer, pir_answer_plain, unpack_selection)
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.tree_expand import (
        FINAL_LEVELS, tree_expand, tree_expand_final,
        tree_expand_final_plain, tree_expand_level_plain, tree_expand_levels)
    from dcf_tpu_torch.ops.walk32_eval import walk32_eval, walk32_eval_plain
    from dcf_tpu_torch.ops.walk_eval import (
        aes_image, walk_bits_plain, walk_eval, walk_eval_plain)
    from dcf_tpu_torch.ops.wide_tail import wide_tail, wide_tail_plain
    from dcf_tpu_torch.protocols.dpf import (
        decode_proto_frame, dpf_eval_points)
    from dcf_tpu_torch.spec import GROUPS
    from dcf_tpu_torch.backends._common import points_mismatch_count
    from dcf_tpu_torch.ops.keygen_walk import (
        MODE_B7A, MODE_B7B, MODE_G1, MODE_G2, keygen_dcf16, keygen_dcf32,
        keygen_dpf, keygen_narrow, keygen_walk_plain, keygen_wide_tail,
        keygen_wide_tail_plain)
    from dcf_tpu_torch.ops.keylanes_eval import (
        keylanes_eval, keylanes_eval_plain)
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch
    from dcf_tpu_torch.backends.prefix_backend import PrefixBackend
    from dcf_tpu_torch.protocols import MicEvaluator, mic_oracle
    from dcf_tpu_torch.protocols import fixedpoint as fp
    from dcf_tpu_torch.protocols.combine import staged_pair_combine
    from dcf_tpu_torch.protocols.keygen import interval_session_material
    from dcf_tpu_torch.utils.groups import group_width, np_group_add
    from dcf_tpu_torch.workloads.core import (
        full_domain_check_device, secure_relu_check_device)
    from dcf_tpu_torch.workloads.pir import (
        PirDatabase, PirServer, pir_reconstruct)

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
    banked = {"keylanes_eval": "B8", "narrow_walk": "B4",
              "walk_eval": "B1", "prefix_eval": "B3",
              "evalall_expand": "B6", "hybrid_prefix": "B5b",
              "keygen_walk": "G1, B7a, B7b, G2", "hybrid_state": "B5a",
              "tree_expand": "B2, B2f", "walk32_eval": "E1"}
    log("phase 2 the kernels on the banked AES, (registers, spill-store "
        "bytes) by kernel function: " + "; ".join(
            f"{kid} {src} {ptxas_functions(_build.build_log(src))}"
            for src, kid in banked.items())
        + " (keygen_walk's keygen_banked_kernel<0> is G1, <1> B7a, <2> "
        "B7b, <3> G2; tree_expand's tree_expand_kernel<GW,D,0> B2, <0,D,1> "
        "B2f; walk32_eval_kernel<GW> E1)")

    # -- phase 3: each kernel against its plain version --------------------------
    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    aes = torch.from_numpy(aes_image(ck[0])).to(dev)
    max_err = {k: 0 for k in ("B1", "B2", "B3", "B4", "B5a", "B5b", "W1",
                              "B6", "B2f", "P1", "G1", "B7a", "B7b", "B8",
                              "W2", "E1", "G2")}

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
            cws = (t["cw_s"][0], t["cw_v"][0], t["cw_t"][0])
            plain = {HOST_LEVELS: host_frontier(kb, b)}  # level -> nodes
            for i in range(HOST_LEVELS, k_full):
                plain[i + 1] = tree_expand_level_plain(
                    aes, *(c[i] for c in cws), *plain[i], group=group)
            # The main span (five launches of 3), spans of 7 and 5 levels
            # (cut 1 + 3 + 3 and 2 + 3), and single launches of depth 1-3.
            runs = [(f"levels {HOST_LEVELS}..{k1 - 1}", k1, tree_expand(
                aes, *cws, *plain[HOST_LEVELS], k0=HOST_LEVELS, k1=k1,
                group=group)) for k1 in (k_full, HOST_LEVELS + 7,
                                         HOST_LEVELS + 5)]
            runs += [(f"one launch {lvl}+{d}", lvl + d, tree_expand_levels(
                aes, *cws, *plain[lvl], level=lvl, depth=d, group=group))
                for lvl, d in ((HOST_LEVELS, 1), (HOST_LEVELS, 2),
                               (HOST_LEVELS, 3), (12, 3))]
            for what, k1, got in runs:
                for name, g_, w_ in zip("svt", got, plain[k1]):
                    same("B2", f"{group} party {b} {what} {name}", g_, w_)
    log(f"phase 3 B2: levels {HOST_LEVELS}..{k_full - 1}, spans of 7 and 5 "
        f"levels and single launches of depth 1, 2 and 3 byte-identical to "
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
            for k in (K_CHECK, K_HYBRID):
                at = f"{what} k={k}"
                rows, words = narrow_frontier(*fargs, k=k, b=b)
                rowsp, wordsp = narrow_frontier_plain(*fargs, k=k, b=b)
                same("B5a", at + " rows", rows, rowsp)
                same("B5a", at + " words", words, wordsp)
                pargs = (waes, rows, words, t["cw_s"], t["cw_v"],
                         t["cw_t"], t["cw_np1"], xs)
                y2, traj2 = hybrid_prefix_eval(*pargs, k=k, lam=LAM_WIDE)
                y2p, traj2p = hybrid_prefix_eval_plain(*pargs, k=k,
                                                       lam=LAM_WIDE)
                same("B5b", at + " y[:32]", y2[..., :32], y2p[..., :32])
                same("B5b", at + " trajectory", traj2, traj2p)
                check_w1(at + " from B5b", y2, traj2, y2p, traj2p, wide)
                if not torch.equal(y2, y):
                    raise RuntimeError(f"{at}: the prefix path's shares "
                                       "differ from the from-root path's")
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
        f"at k={K_CHECK} and {K_HYBRID}, prefix shares equal to from-root "
        f"shares), and B4 + "
        f"W1 with K=3 ({time.perf_counter() - t0:.1f} s)")

    # -- phase 4: the main paths through the facade --------------------------------
    counters = {"B1": walk_eval, "B2": tree_expand_levels, "B3": prefix_eval,
                "B4": narrow_walk, "B5a": narrow_frontier,
                "B5b": hybrid_prefix_eval, "W1": wide_tail,
                "B6": evalall_expand_level, "B2f": tree_expand_final,
                "P1": pir_answer, "G1": keygen_dcf16, "B7a": keygen_narrow,
                "B7b": keygen_dpf, "B8": keylanes_eval,
                "W2": keygen_wide_tail, "E1": walk32_eval,
                "G2": keygen_dcf32}
    launches = {k: {} for k in counters}  # kernel -> {path: launches}
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
            launches[k][name] = ran[k]
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
        f"{-(-(LAM_CRATE - 32) // 256)} column tiles byte-identical to its "
        f"plain version; eval_staged median {crate_ms:.3f} ms = "
        f"{M_CRATE / crate_ms * 1e3:,.0f} evals/s over {REPEATS} repeats, "
        f"W1 alone {w1_crate_ms:.3f} ms ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")

    # -- phase 6: kernel times at the main paths' shapes ----------------------------
    # Each kernel is also held against its plain version on these inputs,
    # so max_abs_err covers the shape the kernel is timed at.
    #
    # Each bound counts the AES table lookups the function needs on this
    # run's points.  A walk follows one child per level.  At lam = 16 a
    # left turn needs E(s) and E(~s), a right turn only t_r, bit 0 of
    # E(~s) (its s and v are copies of s and ~s).  The narrow walk's left
    # turn needs E0(sa) and E0(~sa), its right turn E17(sb), E17(~sb) and
    # t_r, bit 0 of E0(~sa).  A full expansion (B2, B5a) needs every block
    # of each parent once.
    def walk_lookups(xs: torch.Tensor, lo: int, hi: int, left: int,
                     right: int) -> int:
        """Lookups of a walk over xs's points through levels lo..hi-1 at
        ``left`` lookups a left turn and ``right`` a right turn."""
        bits = walk_bits_plain(xs)[..., lo:hi]
        rights = int(bits.sum(dtype=torch.int64))
        return left * (bits.numel() - rights) + right * rights

    lam16_turns = (2 * LOOKUPS_BLOCK, LOOKUPS_T_BIT)
    narrow_turns = (2 * LOOKUPS_BLOCK, 2 * LOOKUPS_BLOCK + LOOKUPS_T_BIT)

    kb, xs, _ = main_inputs["walk"]
    t = on_card(kb)
    args = (aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"], xs)
    n = 8 * N_BYTES
    b1_ms, got = cuda_ms(lambda: walk_eval(*args, b=0, group="xor"), 10)
    b1_plain, want = cuda_ms(
        lambda: walk_eval_plain(*args, b=0, group="xor"), 1)
    same("B1", f"main shape {tuple(xs.shape)}", got, want)
    b1_lookups = walk_lookups(xs, 0, n, *lam16_turns)
    b1_computed = pair_lookups_computed(walk_bits_plain(xs)[0])
    b1_bytes = M_MAIN * N_BYTES + M_MAIN * 16 + n * 34 + 32 + 496
    # The walk path's other two B1 launches: the anchors, 1024 points.
    xa = xs[:, :M_ANCHOR].contiguous()
    b1a_ms, _ = cuda_ms(lambda: walk_eval(*args[:-1], xa, b=0, group="xor"),
                        10)
    b1a_work = (walk_lookups(xa, 0, n, *lam16_turns),
                M_ANCHOR * (N_BYTES + 16) + n * 34 + 32 + 496)

    kb, xs, _ = main_inputs["prefix"]
    t = on_card(kb)
    s, v, tt = host_frontier(kb, 0)
    targs = (aes, t["cw_s"][0], t["cw_v"][0], t["cw_t"][0])

    def b2_prefix():
        return tree_expand(*targs, s, v, tt, k0=HOST_LEVELS, k1=k_full,
                           group="xor")

    held = b2_prefix()  # two untimed calls, the first's outputs alive, so
    b2_prefix()  # that no allocation falls into the timed window
    b2_ms, got = cuda_ms(b2_prefix, 10)
    del held

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
    b2_lookups = parents * 2 * LOOKUPS_BLOCK
    # The function's bytes: the level-k0 nodes read once, the level-k1
    # nodes written once (33 bytes a node), the CWs and the cipher image.
    # This design also writes and reads back the levels where one launch
    # ends and the next begins (b2_level_bytes).
    b2_bytes = ((1 << HOST_LEVELS) + (1 << k_full)) * 33 \
        + (k_full - HOST_LEVELS) * 34 + 496
    b2_cut = launch_depths(HOST_LEVELS, k_full)
    b2_level_bytes = sum(((1 << i) + (1 << (i + d))) * 33 + d * 34 + 496
                         for i, d in b2_cut)

    table = table_of(kb, 0, k_full)
    pargs = (aes, table, t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"], xs)
    b3_ms, got = cuda_ms(lambda: prefix_eval(*pargs, k=k_full, negate=False,
                                             group="xor"), 10)
    b3_plain, want = cuda_ms(lambda: prefix_eval_plain(
        *pargs, k=k_full, negate=False, group="xor"), 1)
    same("B3", f"main shape {tuple(xs.shape)}", got, want)
    rows = int(torch.unique(frontier_index_plain(xs[0], k_full)).numel())
    b3_lookups = walk_lookups(xs, k_full, n, *lam16_turns)
    b3_computed = pair_lookups_computed(walk_bits_plain(xs)[0, :, k_full:])
    b3_bytes = M_MAIN * N_BYTES + rows * 32 + M_MAIN * 16 \
        + (n - k_full) * 34 + 16 + 496
    log(f"phase 6: B1, B2, B3 byte-identical to their plain versions at the "
        f"main path's shapes; B2's launches {b2_cut} move "
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
    b4_lookups = walk_lookups(xs, 0, n, *narrow_turns)
    b4_bytes = M_MAIN * (N_BYTES + 32 + 4 * nt) + n * 66 + 64 + 736
    # What B4's and B5b's design computes: three full blocks a lane and
    # level in a warp (32 consecutive points) where some lane turns right,
    # two where none does.
    warp_right = walk_bits_plain(xs)[0].view(M_MAIN // 32, 32, n).any(1)

    def narrow_computed(lo: int) -> int:
        right = warp_right[:, lo:]
        return 32 * (2 * right.numel() + int(right.sum())) * LOOKUPS_BLOCK

    b4_computed = narrow_computed(0)

    wide = wide_of(kb)
    wd = LAM_WIDE - 32
    w1_ms, got = cuda_ms(lambda: wide_tail(y, traj, *wide), 10)
    w1_plain, want = cuda_ms(lambda: wide_tail_plain(yp, trajp, *wide), 1)
    same("W1", "main shape", got, want)
    set_bits = int(unpack_traj_plain(traj, n + 1).sum().item())
    w1_reads = set_bits * (wd // 4)
    w1_bytes = M_MAIN * (4 * nt + wd) + (n + 2) * wd
    # W1's bound is its bytes.  Three operation counts are printed as
    # design figures only: the shared-memory words the first design's bit
    # walk read (w1_reads, one a set bit and column word), the int8
    # tensor-core operations of the product with every bit unpacked to a
    # byte (w1_int8_ops), and the bytes this design's table lookups read
    # (w1_table_bytes: 16 a point, group of five bits and 16-byte chunk), at
    # 128 bytes a clock and SM.  None is the function's floor: a b1 MMA
    # (AND + POPC) needs 8 times fewer operand bytes, and its rate is not
    # in the published table.
    w1_int8_ops = 2 * M_MAIN * (n + 1) * 8 * wd
    w1_table_bytes = M_MAIN * -(-(n + 1) // 5) * wd
    w1_table_ms = w1_table_bytes / (sms * 128 * clock_mhz * 1e6) * 1e3

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
    b5a_dev, b5a_host = device_host_ms(
        lambda: narrow_frontier(*fargs, k=K_HYBRID, b=0), 10)
    nodes = 1 << K_HYBRID
    b5a_lookups = (nodes - 1) * 4 * LOOKUPS_BLOCK
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
    b5b_lookups = walk_lookups(xs, K_HYBRID, n, *narrow_turns)
    b5b_computed = narrow_computed(K_HYBRID)
    b5b_bytes = M_MAIN * (N_BYTES + 32 + 4 * nt) + used * 68 \
        + (n - K_HYBRID) * 66 + 32 + 736
    log(f"phase 6: B4, W1, B5a, B5b byte-identical to their plain versions "
        f"at the lam={LAM_WIDE} main path's shapes; W1 read {set_bits} set "
        f"trajectory bits of {M_MAIN * (n + 1)}; B5b gathered {used} of "
        f"{nodes} frontier rows; B5a k={K_HYBRID} a call: device "
        f"{b5a_dev:.4f} ms, host {b5a_host:.4f} ms, "
        f"{1 + len(frontier_launches(K_HYBRID)[1])} launches [{card}]")

    def bound(lookups: int, nbytes: int) -> tuple[float, str]:
        ops_ms = lookups / lookups_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms \
            else (bytes_ms, "bytes")

    rows_out = []

    def add_row(phase: str, kid: str, src: str, rep: str, ms: float,
                plain: float, lk: int, nb: int, lib=None, label: str = "",
                **extra) -> None:
        b_ms, b_by = bound(lk, nb)
        rows_out.append({
            "name": f"{kid} {src}{label}", "route": "cuda",
            "source": f"dcf_tpu_torch/csrc/{src}.cu", "replaces": rep,
            "launches": 0, "launches_by_path": {},
            "max_abs_err": max_err[kid],
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, **extra})
        log(f"{phase} {kid}{label}: {ms:.3f} ms (plain {plain:.1f} ms, bound "
            f"{b_ms:.3f} ms by {b_by}: {lk:.3e} table lookups at "
            f"{lookups_per_s:.3e}/s, {nb} bytes at {HBM_BYTES_PER_S:.3e} B/s;"
            f" {b_ms / ms:.1%} of bound) [{card}]")

    for row in (
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
             w1_plain, 0, w1_bytes, w1_lib)):
        add_row("phase 6", *row)
    b5a_row = next(r for r in rows_out if r["name"].startswith("B5a "))
    b5a_row["device_ms_a_call"], b5a_row["host_ms_a_call"] = \
        b5a_dev, b5a_host
    w1_row = next(r for r in rows_out if r["name"].startswith("W1 "))
    w1_row["table_read_floor_ms"] = w1_table_ms
    for kid, computed, needed in (("B4", b4_computed, b4_lookups),
                                  ("B5b", b5b_computed, b5b_lookups),
                                  ("B1", b1_computed, b1_lookups),
                                  ("B3", b3_computed, b3_lookups)):
        row = next(r for r in rows_out if r["name"].startswith(f"{kid} "))
        row["lookups_computed_per_needed"] = computed / needed
        log(f"phase 6 {kid} design: {computed:.3e} lookups computed, "
            f"{computed / needed:.3f}x the {needed:.3e} its bound counts")
    log(f"phase 6 W1 design figures: the bit walk's {w1_reads:.3e} "
        f"shared-memory word reads ({w1_reads / lookups_per_s * 1e3:.3f} ms "
        f"at {lookups_per_s:.3e}/s); this design's table reads "
        f"{w1_table_bytes:.3e} bytes ({w1_table_ms:.3f} ms at "
        f"{sms * 128 * clock_mhz * 1e6:.3e} B/s); as an int8 tensor-core "
        f"product "
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
        fr_dev, fr_host = device_host_ms(
            lambda k=k: narrow_frontier(*fargs, k=k, b=0), 5)
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
            f" bytes built by B5a in {fr_ms:.3f} ms (a call: device "
            f"{fr_dev:.4f} ms, host {fr_host:.4f} ms; bound "
            f"{((1 << k) - 1) * 4 * LOOKUPS_BLOCK / lookups_per_s * 1e3:.4f}"
            f" ms); B5b {ev_ms:.3f} ms over "
            f"{n - k} walked levels = {ev_ms / (n - k) * 1e3:.2f} us a level "
            f"(B4 {b4_ms / n * 1e3:.2f}), {used_k} rows gathered; equal to "
            f"the from-root walk [{card}]")
        del rows_k, words_k, yk, trk
    del y, traj, yp, trajp, y2, traj2, y2p, traj2p, rows_t, words_t, table
    torch.cuda.empty_cache()

    # -- phase 8: the full-domain kernels against their plain versions ----------------
    t0 = time.perf_counter()
    dck = [rng.bytes(32) for _ in range(18)]  # ciphers 0 and 17 are used
    dprg = HirosePrgNp(32, dck, warn=False)
    daes = torch.from_numpy(narrow_aes_image(dck[0], dck[17])).to(dev)

    def to_dev(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    dcf_chk = Dcf(N_CHECK // 8, 32, dck)
    dbundle = dcf_chk.dpf(
        rng.integers(0, 256, (3, N_CHECK // 8), dtype=np.uint8),
        rng.integers(0, 256, (3, 32), dtype=np.uint8), rng=rng)
    dcw = to_dev(dbundle.cw_s, dbundle.cw_t, dbundle.cw_np1)
    t_words = {}
    for b in (0, 1):
        # One level a launch to full depth and to the prefix depth 13, and
        # the launches evalall_expand makes to depths 16 and 14 (depths 1,
        # 3, 3, 3 and 2, 3, 3).
        for depth, steps in (
                (N_CHECK, [(i, 1) for i in range(HOST_LEVELS, N_CHECK)]),
                (13, [(i, 1) for i in range(HOST_LEVELS, 13)]),
                (N_CHECK, launch_depths(HOST_LEVELS, N_CHECK)),
                (14, launch_depths(HOST_LEVELS, 14))):
            st = to_dev(*dpf_tree_expand_np(dprg, dbundle.for_party(b), b,
                                            HOST_LEVELS))
            for i, d in steps:
                np1 = dcw[2] if i + d == depth else None
                got = evalall_expand_level(daes, dcw[0], dcw[1], *st,
                                           level=i, depth=d, cw_np1=np1)
                want = evalall_expand_level_plain(
                    daes, dcw[0], dcw[1], *st, level=i, depth=d, cw_np1=np1)
                what = (f"n={N_CHECK} K=3 party {b} depth {depth} levels "
                        f"{i}..{i + d - 1}")
                same("B6", what + " s", got[0], want[0])
                same("B6", what + " t", got[1], want[1])
                if np1 is not None:  # the PIR selection: t alone, packed
                    no_y = evalall_expand_level(
                        daes, dcw[0], dcw[1], *st, level=i, depth=d,
                        cw_np1=np1, want_y=False)
                    if no_y[0] is not None:
                        raise RuntimeError("B6: want_y=False returned y")
                    same("B6", what + " t words without y", no_y[1],
                         evalall_expand_level_plain(
                             daes, dcw[0], dcw[1], *st, level=i, depth=d,
                             cw_np1=np1, want_y=False)[1])
                    if depth == N_CHECK:
                        t_words[b] = no_y[1]
                st = got
        # The t-only tree from the roots to depths 1-8: its last launch
        # has fewer than 32 parents a key up to depth 7 (each set bit an
        # atomicOr into a word that directions share), 32 at depth 8 (a
        # ballot a word).
        root = to_dev(*dpf_tree_expand_np(dprg, dbundle.for_party(b), b, 0))
        for k1 in range(1, 9):
            got = evalall_expand(daes, *dcw, *root, k0=0, k1=k1, want_y=False)
            st = root
            for i, d in launch_depths(0, k1):
                st = evalall_expand_level_plain(
                    daes, dcw[0], dcw[1], *st, level=i, depth=d,
                    cw_np1=dcw[2] if i + d == k1 else None,
                    want_y=i + d < k1)
            same("B6", f"n={N_CHECK} K=3 party {b} levels 0..{k1 - 1} t "
                 "words without y", got[1], st[1])
    for bnd in Bound:
        kb2 = gen_batch(
            prg, rng.integers(0, 256, (1, N_CHECK // 8), dtype=np.uint8),
            rng.integers(0, 256, (1, 16), dtype=np.uint8),
            random_s0s(1, 16, rng), bnd)
        c = to_dev(kb2.cw_s[0], kb2.cw_v[0], kb2.cw_t[0], kb2.cw_np1[0])
        for b in (0, 1):
            # The leaf launch of the last 1, 2 and 3 levels (FINAL_LEVELS
            # picks the full domain's).
            for fl in range(1, 4):
                st = to_dev(*tree_expand_np(prg, kb2.for_party(b), b,
                                            HOST_LEVELS))
                st = tree_expand(aes, c[0], c[1], c[2], *st,
                                 k0=HOST_LEVELS, k1=N_CHECK - fl,
                                 group="xor")
                last = (aes, *(x[N_CHECK - fl:] for x in c[:3]), c[3], *st)
                same("B2f", f"n={N_CHECK} {bnd.name} party {b} last {fl} "
                     "levels", tree_expand_final(*last),
                     tree_expand_final_plain(*last))
    db_chk = torch.from_numpy(rng.integers(
        0, 256, (1 << N_CHECK, RECORD_BYTES), dtype=np.uint8)).to(dev)
    for b in (0, 1):
        same("P1", f"n={N_CHECK} K=3 R={RECORD_BYTES} party {b}",
             pir_answer(t_words[b], db_chk),
             pir_answer_plain(t_words[b], db_chk))
    # P1's 4-byte chunks (R = 4, 36), column groups past 32 chunks
    # (R = 528), K past a pass of 4 and of 8 keys, a last tile past N.
    for k_num, n_rows, r in ((1, 1000, 4), (5, 4096, 36), (9, 4096, 528)):
        dbx = torch.from_numpy(rng.integers(0, 256, (n_rows, r),
                                            dtype=np.uint8)).to(dev)
        wx = pack_selection(torch.from_numpy(rng.integers(
            0, 2, (k_num, n_rows), dtype=np.uint8)).to(dev))
        same("P1", f"K={k_num} N={n_rows} R={r}", pir_answer(wx, dbx),
             pir_answer_plain(wx, dbx))
    del db_chk, dbx, wx, t_words, st, got, want
    log(f"phase 8 B6, B2f, P1: byte-identical to their plain versions at "
        f"n={N_CHECK} (B6 K=3, levels {HOST_LEVELS}.. with the leaf "
        f"correction, one level a launch to depths {N_CHECK} and 13 and "
        f"1-3 levels a launch to depths {N_CHECK} and 14, the last also "
        f"without y, its t bits packed, and t alone from the roots to "
        f"depths 1-8, 2 parties; B2f 2 bounds x 2 parties x the last 1-3 "
        f"levels a launch; P1 K=3, {RECORD_BYTES}-byte records, B6's "
        f"packed words, and K=1, 5, 9 at R=4, 36, 528) "
        f"({time.perf_counter() - t0:.1f} s)")

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def take_counts(name: str, want: dict) -> dict:
        """The launches of the one run of path ``name`` since
        ``reset_counts``, held against ``want`` (kernel -> the count that
        run must make) and kept under the path's name."""
        ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
        for k, n_want in want.items():
            if ran.get(k) != n_want:
                raise RuntimeError(
                    f"{name}: kernel {k} launched {ran.get(k, 0)} times on "
                    f"one run of the path, expected {n_want}")
            launches[k][name] = n_want
        return ran

    def wall_ms(fn, reps: int) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        return float(np.median(times)) * 1e3

    # -- phase 9: full-domain evaluation, lam = 16, n = 24 ------------------------------
    frng = np.random.default_rng(SEED + 3)
    fck = [frng.bytes(32), frng.bytes(32)]
    fdcf = Dcf(N_FULL // 8, 16, fck, backend="walk")
    tree = TreeFullDomain(16, fck, host_levels=HOST_LEVELS)
    fd_keys = []  # (bound, party 0's key) for phase 12
    for bnd in Bound:
        gt = bnd is Bound.GT_BETA
        alpha = int(frng.integers(8, (1 << N_FULL) - 8))
        beta = frng.integers(0, 256, (1, 16), dtype=np.uint8)
        bundle = fdcf.gen(np.frombuffer(
            alpha.to_bytes(N_FULL // 8, "big"), dtype=np.uint8)[None].copy(),
            beta, rng=frng, bound=bnd)
        beta = beta[0].tobytes()
        # One check is both parties: B2 for levels k0.. above the last
        # FINAL_LEVELS, one B2f launch for those.
        reset_counts()
        clean = tree.check(bundle, alpha, beta, N_FULL, gt)
        ran_tree = take_counts(
            f"full domain tree n={N_FULL}",
            {"B2": 2 * len(launch_depths(HOST_LEVELS,
                                         N_FULL - FINAL_LEVELS)),
             "B2f": 2})
        tampered = tree.check(bundle, alpha + 7, beta, N_FULL, gt)
        if clean != 0 or tampered != 7:
            raise RuntimeError(
                f"full domain {bnd.name}: TreeFullDomain.check gave {clean} "
                f"(want 0) and {tampered} for alpha + 7 (want 7)")
        tree_ms = wall_ms(
            lambda: tree.check(bundle, alpha, beta, N_FULL, gt), 5)
        bes = [WalkBackend(16, fck) for _ in (0, 1)]
        for b in (0, 1):
            bes[b].put_bundle(bundle.for_party(b))
        reset_counts()
        walked = full_domain_check_device(bes[0], bes[1], alpha, beta,
                                          N_FULL, gt)
        ran_walk = take_counts(f"full domain walk n={N_FULL}",
                               {"B1": 2 * ((1 << N_FULL) >> 20)})
        if walked != 0:
            raise RuntimeError(f"full domain {bnd.name}: the per-point walk "
                               f"counted {walked} mismatches")
        walk_ms = wall_ms(lambda: full_domain_check_device(
            bes[0], bes[1], alpha, beta, N_FULL, gt), 3)
        log(f"phase 9 full domain lam=16 n={N_FULL} {bnd.name}: "
            f"TreeFullDomain.check 0 mismatches over 2^{N_FULL} leaves, 7 for "
            f"alpha + 7 (launches {ran_tree}); full_domain_check_device over "
            f"two WalkBackends 0 mismatches (launches {ran_walk}); both "
            f"parties and the count on the card: tree median "
            f"{tree_ms:.3f} ms of 5, per-point walk median {walk_ms:.3f} ms "
            f"of 3 = {walk_ms / tree_ms:.2f}x the tree [{card}]")
        fd_keys.append((bnd.name, bundle.for_party(0)))
    fd_inputs = (fd_keys, tree)
    del bes

    # -- phase 10: DPF EvalAll, lam = 32, n = 24, K = 4 ----------------------------------
    t0 = time.perf_counter()
    prng = np.random.default_rng(SEED + 4)
    pck = [prng.bytes(32) for _ in range(18)]
    pprg = HirosePrgNp(32, pck, warn=False)
    pdcf = Dcf(N_FULL // 8, 32, pck)
    alphas = [int(a) for a in prng.integers(0, 1 << N_FULL, K_DPF)]
    alpha_bytes = np.array([list(a.to_bytes(N_FULL // 8, "big"))
                            for a in alphas], dtype=np.uint8)
    betas = prng.integers(0, 256, (K_DPF, 32), dtype=np.uint8)
    dbundle = pdcf.dpf(alpha_bytes, betas, rng=prng)
    evaluator = DpfEvalAll(32, pck, host_levels=HOST_LEVELS)
    reset_counts()
    clean = evaluator.check(dbundle, alphas, betas, N_FULL)
    ran_check = take_counts(
        f"DpfEvalAll.check n={N_FULL} K={K_DPF}",
        {"B6": 2 * len(launch_depths(HOST_LEVELS, N_FULL))})
    # Which B6 levels each path expands (parties, first, end, whether its
    # last launch writes y), in the launches of launch_depths: their times
    # come from phase 12.
    b6_spans = {f"DpfEvalAll.check n={N_FULL} K={K_DPF}":
                (2, HOST_LEVELS, N_FULL, True),
                f"Dcf.eval_all n={N_FULL} K={K_DPF}": (1, 0, N_FULL, True)}
    moved = list(alphas)
    moved[1] ^= 1
    tampered = evaluator.check(dbundle, moved, betas, N_FULL)
    if clean != 0 or tampered != 2:
        raise RuntimeError(
            f"DPF EvalAll: check gave {clean} (want 0) and {tampered} for one "
            "moved alpha (want 2: its old leaf and its new one)")
    dpf_check_ms = wall_ms(
        lambda: evaluator.check(dbundle, alphas, betas, N_FULL), 3)
    hits = [bitrev(a, N_FULL) for a in alphas]
    lead = np.array([bitrev(p, N_FULL) for p in range(M_LEAVES)])
    xs_lead = np.stack([(lead >> sh) & 0xFF
                        for sh in range(N_FULL - 8, -8, -8)],
                       axis=1).astype(np.uint8)
    for b in (0, 1):
        # The facade's default: kernel B6 on its device, the card, from
        # the roots.
        reset_counts()
        y_all, t_all = pdcf.eval_all(b, dbundle)
        ran_all = take_counts(f"Dcf.eval_all n={N_FULL} K={K_DPF}",
                              {"B6": len(launch_depths(0, N_FULL))})
        if y_all.shape != (K_DPF, 1 << N_FULL, 32) \
                or t_all.shape != (K_DPF, 1 << N_FULL):
            raise RuntimeError(f"eval_all: shapes {y_all.shape}, "
                               f"{t_all.shape}")
        want = dpf_eval_points(pprg, dbundle, b, np.concatenate(
            [xs_lead, alpha_bytes]))
        ok = np.array_equal(y_all[:, :M_LEAVES], want[:, :M_LEAVES]) and all(
            np.array_equal(y_all[k, hits[k]], want[k, M_LEAVES + k])
            for k in range(K_DPF))
        if not ok:
            raise RuntimeError(f"eval_all: party {b}'s leaves differ from "
                               "dpf_eval_points")
        del y_all, t_all
    log(f"phase 10 DPF EvalAll lam=32 n={N_FULL} K={K_DPF}: DpfEvalAll.check "
        f"0 mismatches over {K_DPF} x 2^{N_FULL} leaves, 2 for one moved "
        f"alpha; Dcf.eval_all (by default on the card): first {M_LEAVES} "
        f"leaves and the "
        f"leaf at bitreverse(alpha) of each key equal dpf_eval_points, both "
        f"parties; launches of one check {ran_check}, of one party's "
        f"eval_all {ran_all}; check (both parties and the count) median "
        f"{dpf_check_ms:.3f} ms of 3 ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")

    # -- phase 11: 2-server PIR through PirServer ---------------------------------------
    class Registry:
        """Key frames by id: what ``PirServer`` snapshots from."""

        def __init__(self):
            self.keys = {}

        def register(self, key_id: str, frame: bytes) -> None:
            self.keys[key_id] = (decode_proto_frame(frame), None, 1)

        def snapshot(self, key_id: str):
            return self.keys[key_id]

    # Every leg runs the evaluator's default, the whole tree on the card;
    # the top domain again with HOST_LEVELS levels on the host, to show
    # what the host's numpy levels cost.
    evaluator0 = DpfEvalAll(32, pck)
    pir_inputs = None
    for n_db in PIR_BITS:
        t0 = time.perf_counter()
        records = prng.integers(0, 256, (1 << n_db, RECORD_BYTES),
                                dtype=np.uint8)
        db = PirDatabase(records, n_db)
        client = Dcf((n_db + 7) // 8, 32, pck)
        setup_s = time.perf_counter() - t0
        for ev in (evaluator0, evaluator) if n_db == N_FULL \
                else (evaluator0,):
            registry = Registry()
            server = PirServer(ev, db, registry)
            gate = [0, (1 << n_db) - 1] + [
                int(x) for x in prng.integers(0, 1 << n_db, 4)]
            registry.register("gate", client.pir_query(
                gate, rng=prng, n_bits=n_db).to_bytes())
            # One batch served to both parties: each runs B6 from level k0
            # to the database's depth, then P1 once.
            reset_counts()
            got = pir_reconstruct(server.answer("gate", 0),
                                  server.answer("gate", 1))
            k0 = min(ev.host_levels, n_db - 1)
            ran = take_counts(
                f"PIR n={n_db} host_levels={ev.host_levels}",
                {"B6": 2 * len(launch_depths(k0, n_db)), "P1": 2})
            b6_spans[f"PIR n={n_db} host_levels={ev.host_levels}"] = (
                2, k0, n_db, False)
            for j, i in enumerate(gate):
                if got[j].tobytes() != records[i].tobytes():
                    raise RuntimeError(
                        f"PIR gate: record {i} of the 2^{n_db} database did "
                        "not reconstruct bit-exactly through PirServer")
            reg_ms, batch_ms, stage_ms = [], [], []
            for q in range(PIR_REPS + 1):
                t1 = time.perf_counter()
                query = client.pir_query(
                    prng.integers(0, 1 << n_db, K_DPF), rng=prng,
                    n_bits=n_db)
                registry.register(f"q{q}", query.to_bytes())
                reg_ms.append((time.perf_counter() - t1) * 1e3)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pir_reconstruct(server.answer(f"q{q}", 0),
                                server.answer(f"q{q}", 1))
                batch_ms.append((time.perf_counter() - t1) * 1e3)
                # The host's share of a batch: both parties' top levels by
                # numpy and the key image shipped, timed again on its own.
                ev.invalidate()
                t1 = time.perf_counter()
                ev._staged_for(registry.snapshot(f"q{q}")[0], n_db)
                torch.cuda.synchronize()
                stage_ms.append((time.perf_counter() - t1) * 1e3)
            med = float(np.median(batch_ms[1:]))
            log(f"phase 11 PIR n={n_db}, host_levels={ev.host_levels}, "
                f"{1 << n_db} records x {RECORD_BYTES} B "
                f"({db.rows.numel() / 2**20:.1f} MiB on the card, set up in "
                f"{setup_s:.2f} s): gate records {gate} reconstruct "
                f"bit-exactly from both parties' answers; K={K_DPF} queries "
                f"a batch, a fresh registered bundle per call, both parties "
                f"served: median {med:.3f} ms of {PIR_REPS} = "
                f"{K_DPF / med * 1e3:,.1f} queries/s (first batch "
                f"{batch_ms[0]:.3f} ms); of a batch, the host's top levels "
                f"and key shipping take {np.median(stage_ms):.3f} ms; off "
                f"the clock, client keygen and registration "
                f"{np.median(reg_ms):.3f} ms; eval_faults "
                f"{server.eval_faults}; launches of the gate batch {ran} "
                f"[{card}]")
            if server.eval_faults:
                raise RuntimeError(f"PIR n={n_db}: {server.eval_faults} "
                                   "served attempts failed")
            if n_db == N_FULL and ev is evaluator:
                pir_inputs = (db, registry.snapshot("q0")[0])
            del server
        del db, records
    del evaluator0

    # -- phase 12: B6, B2, B2f and P1 at those paths' shapes --------------------------------
    db, query = pir_inputs
    kb = query.for_party(0)
    cw3 = evaluator._stage_cw(kb)
    front = evaluator._frontier(kb, 0, HOST_LEVELS)
    b6_ms, (y6, t6) = cuda_ms(lambda: evalall_expand(
        evaluator.aes, *cw3, *front, k0=HOST_LEVELS, k1=N_FULL), 5)

    def b6_plain_fn(st=front):
        for i in range(HOST_LEVELS, N_FULL):
            st = evalall_expand_level_plain(
                evaluator.aes, cw3[0], cw3[1], *st, level=i,
                cw_np1=cw3[2] if i == N_FULL - 1 else None)
        return st

    b6_plain, (y6p, t6p) = cuda_ms(b6_plain_fn, 1)
    same("B6", f"main shape K={K_DPF} n={N_FULL} party 0 y", y6, y6p)
    same("B6", f"main shape K={K_DPF} n={N_FULL} party 0 t", t6, t6p)
    # The PIR selection: the same tree, its last launch writing the t bits
    # alone, packed; P1 below reads these words.
    _, w6 = evalall_expand(evaluator.aes, *cw3, *front, k0=HOST_LEVELS,
                           k1=N_FULL, want_y=False)
    same("B6", f"main shape K={K_DPF} n={N_FULL} party 0 t words without y",
         w6, pack_selection(t6p))
    del y6, y6p, t6, t6p
    torch.cuda.empty_cache()
    front1 = evaluator._frontier(query.for_party(1), 1, HOST_LEVELS)
    got = evalall_expand(evaluator.aes, *cw3, *front1, k0=HOST_LEVELS,
                         k1=N_FULL)
    want = b6_plain_fn(front1)
    for name, g_, w_ in zip("yt", got, want):
        same("B6", f"main shape K={K_DPF} n={N_FULL} party 1 {name}", g_,
             w_)
    del front1, got, want, g_, w_
    torch.cuda.empty_cache()
    # A parent needs E0(s_b0) and E17(s_b1) in full and E0(~s_b0) to its t
    # bit (LOOKUPS_DPF_NODE); the function's bytes are the level-k0 nodes
    # read and the leaves written (33 bytes a node), the CWs and the cipher
    # image.  This design also writes and reads back the nodes between its
    # launches (launch_depths: up to 3 levels a launch kept in registers),
    # b6_launch_bytes in all.
    b6_parents = K_DPF * ((1 << N_FULL) - (1 << HOST_LEVELS))
    b6_lookups = b6_parents * LOOKUPS_DPF_NODE
    b6_bytes = K_DPF * ((1 << HOST_LEVELS) + (1 << N_FULL)) * 33 \
        + K_DPF * (N_FULL * 34 + 32) + 736
    b6_launch_bytes = sum(
        K_DPF * ((1 << lvl) + (1 << (lvl + d))) * 33
        for lvl, d in launch_depths(HOST_LEVELS, N_FULL))
    add_row("phase 12", "B6", "evalall_expand",
            "dcf_tpu/ops/pallas_evalall.py:75", b6_ms, b6_plain, b6_lookups,
            b6_bytes)
    log(f"phase 12 B6: its launches {launch_depths(HOST_LEVELS, N_FULL)} "
        f"(level, depth) read and write {b6_launch_bytes} bytes of nodes in "
        f"this design ({b6_launch_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at "
        f"{HBM_BYTES_PER_S:.3e} B/s; one level a launch: "
        f"{3 * b6_parents * 33} bytes)")
    # B6 a launch: each launch the paths make (a level L and a depth d,
    # launch_depths; a PIR path's last one writes t alone, and its bound
    # counts LOOKUPS_DPF_T_NODE / _LEAF), timed alone from the level-L
    # nodes of this expansion from the roots, beside its bound.  Every path's B6 launches are launches of such a tree (K = 4
    # keys): the launch (L, d) has K * 2^L parents whatever the depth of
    # the tree.  The leaf correction (8 XORs a node) is applied where
    # L + d = n or y is left out.  Two untimed calls first, so that the
    # allocator holds the outputs' memory.
    def path_launches(lo: int, hi: int, writes_y: bool):
        ld = launch_depths(lo, hi)
        return [(lvl, d, writes_y or j < len(ld) - 1)
                for j, (lvl, d) in enumerate(ld)]

    wanted = sorted({x for _, lo, hi, y_ in b6_spans.values()
                     for x in path_launches(lo, hi, y_)})
    st = evaluator._frontier(kb, 0, 0)
    b6_by_launch = {}
    for i in range(N_FULL):
        for lvl, d, y_ in (x for x in wanted if x[0] == i):
            np1 = cw3[2] if lvl + d == N_FULL or not y_ else None

            def launch(st=st, lvl=lvl, d=d, np1=np1, y_=y_):
                return evalall_expand_level(evaluator.aes, cw3[0], cw3[1],
                                            *st, level=lvl, depth=d,
                                            cw_np1=np1, want_y=y_)

            launch(), launch()
            ms_i, _ = cuda_ms(launch, 5)
            par = K_DPF << lvl
            on_last = par << (d - 1)  # parents on the launch's last level
            lookups = par * ((1 << d) - 1) * LOOKUPS_DPF_NODE if y_ else \
                (par * ((1 << (d - 1)) - 1) * LOOKUPS_DPF_T_NODE
                 + on_last * LOOKUPS_DPF_T_LEAF)
            b6_by_launch[(lvl, d, y_)] = (ms_i, bound(
                lookups, par * 33 + (par << d) * (33 if y_ else 1)
                + K_DPF * d * 34 + 736)[0])
            del launch, _
        st = evalall_expand_level(evaluator.aes, cw3[0], cw3[1], *st,
                                  level=i)
    del st
    torch.cuda.empty_cache()
    b6_row = next(r for r in rows_out if r["name"].startswith("B6 "))

    def launch_name(lvl: int, d: int, y_: bool) -> str:
        return f"{lvl}+{d}" + ("" if y_ else " t only")

    b6_row["ms_by_launch"] = {launch_name(*x): m_ for x, (m_, _) in
                              b6_by_launch.items()}
    b6_row["bound_ms_by_launch"] = {launch_name(*x): b_ for x, (_, b_) in
                                    b6_by_launch.items()}
    log("phase 12 B6 a launch, by level L and depth d (K=4 x 2^L parents; "
        "ms, bound ms): " + ", ".join(
            f"{launch_name(*x)}: {m_:.4f}, {b_:.4f}"
            for x, (m_, b_) in b6_by_launch.items()) + f" [{card}]")

    pir_answer(w6, db.rows)  # two untimed calls, as chip_ab.py's turns
    pir_answer(w6, db.rows)
    p1_ms, a1 = cuda_ms(lambda: pir_answer(w6, db.rows), 10)
    p1_plain, a1p = cuda_ms(lambda: pir_answer_plain(w6, db.rows), 1)
    same("P1", f"main shape K={K_DPF} n={N_FULL} R={RECORD_BYTES}", a1, a1p)
    # The function's bytes: the database, the packed selection words (one
    # bit a key and record) and the answers.
    p1_bytes = db.rows.numel() + 4 * w6.numel() + a1.numel()
    # The library's product: torch._int_mm (int8 x int8 -> int32) of the t
    # bits, padded to 32 rows (it wants more than 16), and the database
    # unpacked to one int8 per bit, column-major: 8 times the database's
    # bytes.  The low bit of each sum, packed, is P1's answer.
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    n_rec = db.num_records
    t8 = torch.zeros((32, n_rec), dtype=torch.int8, device=dev)
    t8[:K_DPF] = unpack_selection(w6, n_rec)
    db8 = torch.empty((8 * RECORD_BYTES, n_rec), dtype=torch.int8, device=dev)
    step = 1 << 20
    for lo in range(0, n_rec, step):
        db8[:, lo:lo + step] = ((db.rows[lo:lo + step].unsqueeze(-1)
                                 >> shifts) & 1).reshape(
            -1, 8 * RECORD_BYTES).t()
    p1_lib, acc = cuda_ms(lambda: torch._int_mm(t8, db8.t()), 5)
    parity = (acc[:K_DPF] & 1).to(torch.uint8).view(K_DPF, RECORD_BYTES, 8)
    if not torch.equal((parity << shifts).sum(-1).to(torch.uint8), a1):
        raise RuntimeError("P1: torch._int_mm's parity differs from P1")
    del t8, db8, acc, parity
    torch.cuda.empty_cache()
    add_row("phase 12", "P1", "pir_answer", "dcf_tpu/workloads/pir.py:110",
            p1_ms, p1_plain, 0, p1_bytes, p1_lib)
    log(f"phase 12 P1: torch._int_mm [32x{n_rec}] x [{n_rec}x"
        f"{8 * RECORD_BYTES}] on the database unpacked to "
        f"{8 * db.rows.numel()} bytes {p1_lib:.3f} ms, its parity equal to "
        f"P1's answer; P1 reads the selection as {4 * w6.numel()} bytes "
        f"of packed words [{card}]")
    del w6, db, a1, a1p

    fd_keys, tree = fd_inputs
    fd_end = N_FULL - FINAL_LEVELS  # B2 to here, B2f the rest
    fd_span = f"levels {HOST_LEVELS}..{fd_end - 1} of n={N_FULL}"

    def b2_fd_plain(cw, nodes):
        for i in range(HOST_LEVELS, fd_end):
            nodes = tree_expand_level_plain(tree.aes, cw[0][i], cw[1][i],
                                            cw[2][i], *nodes, group="xor")
        return nodes

    # B2 over the full-domain path's launches, for each bound's key, held
    # against its plain version level by level before B2f reads its nodes.
    for bname, kb in fd_keys:
        cw4 = tree._stage_cw(kb)
        front = tree._frontier(kb, 0, HOST_LEVELS)
        st = tree_expand(tree.aes, *cw4[:3], *front, k0=HOST_LEVELS,
                         k1=fd_end, group="xor")
        for name, g_, w_ in zip("svt", st, b2_fd_plain(cw4, front)):
            same("B2", f"full domain {fd_span} {bname} party 0 {name}", g_,
                 w_)
        del st, g_, w_

    def b2_full_domain():
        return tree_expand(tree.aes, *cw4[:3], *front, k0=HOST_LEVELS,
                           k1=fd_end, group="xor")

    held = b2_full_domain()  # two untimed calls, the first's outputs
    b2_full_domain()  # alive: levels 21-22 allocate about 400 MB
    b2fd_ms, st = cuda_ms(b2_full_domain, 5)
    del held
    for name, g_, w_ in zip("svt", st, b2_fd_plain(cw4, front)):
        same("B2", f"full domain {fd_span} {bname} party 0, timed {name}",
             g_, w_)
    del g_, w_
    # B2f's launch: the last FINAL_LEVELS levels from B2's nodes, as
    # tree_expand_device makes it; its bound counts every parent of them.
    last = (tree.aes, *(x[fd_end:] for x in cw4[:3]), cw4[3], *st)
    tree_expand_final(*last)  # two untimed calls: the leaves' 256 MiB
    tree_expand_final(*last)
    b2f_ms, yf = cuda_ms(lambda: tree_expand_final(*last), 10)
    b2f_plain, yfp = cuda_ms(lambda: tree_expand_final_plain(*last), 1)
    same("B2f", f"main shape, levels {fd_end}..{N_FULL - 1} of n={N_FULL}",
         yf, yfp)
    b2f_parents = (1 << N_FULL) - (1 << fd_end)
    b2f_lookups = b2f_parents * 2 * LOOKUPS_BLOCK
    b2f_bytes = (1 << fd_end) * 33 + (1 << N_FULL) * 16 \
        + FINAL_LEVELS * 34 + 16 + 496
    add_row("phase 12", "B2f", "tree_expand", "dcf_tpu/ops/pallas_tree.py:149",
            b2f_ms, b2f_plain, b2f_lookups, b2f_bytes)
    fd_parents = (1 << fd_end) - (1 << HOST_LEVELS)
    b2fd_bound = bound(
        fd_parents * 2 * LOOKUPS_BLOCK,
        ((1 << HOST_LEVELS) + (1 << fd_end)) * 33
        + (fd_end - HOST_LEVELS) * 34 + 496)[0]
    b2_row = next(r for r in rows_out if r["name"].startswith("B2 "))
    b2_row["ms_full_domain"], b2_row["bound_ms_full_domain"] = \
        b2fd_ms, b2fd_bound
    # Each launch of that span alone, after two untimed calls.
    b2_by_launch, nodes = {}, front
    for lvl, d in launch_depths(HOST_LEVELS, fd_end):
        def one(lvl=lvl, d=d, nodes=nodes):
            return tree_expand_levels(tree.aes, *cw4[:3], *nodes, level=lvl,
                                      depth=d, group="xor")

        nxt = one()
        one()
        ms_i, _ = cuda_ms(one, 5)
        par = 1 << lvl
        b2_by_launch[f"{lvl}+{d}"] = (ms_i, bound(
            par * ((1 << d) - 1) * 2 * LOOKUPS_BLOCK,
            (par + (par << d)) * 33 + d * 34 + 496)[0])
        nodes = nxt
    del nodes, nxt, one, _
    b2_row["ms_by_launch_full_domain"] = {k: m_ for k, (m_, _) in
                                          b2_by_launch.items()}
    b2_row["bound_ms_by_launch_full_domain"] = {
        k: b_ for k, (_, b_) in b2_by_launch.items()}
    log(f"phase 12 B2 on the full-domain path: levels {HOST_LEVELS}.."
        f"{fd_end - 1} ({fd_parents} parents, launches "
        f"{launch_depths(HOST_LEVELS, fd_end)}) byte-identical to "
        f"tree_expand_level_plain for {len(fd_keys)} bounds' keys; "
        f"{b2fd_ms:.3f} ms after "
        f"two untimed calls, lookup bound {b2fd_bound:.3f} ms; with B2f "
        f"one party's 2^{N_FULL} leaves take {b2fd_ms + b2f_ms:.3f} ms; a "
        f"launch, level L + depth d (ms, bound ms): " + ", ".join(
            f"{k}: {m_:.4f}, {b_:.4f}" for k, (m_, b_) in
            b2_by_launch.items()) + f" [{card}]")
    del st, yf, yfp, last
    # B1 a launch on the per-point full-domain path: one chunk of 2^20
    # domain values of the n = 24 key (its 32 launches have this shape).
    t24 = on_card(kb)
    vals = np.arange(1 << 20, dtype=np.uint32)
    xs24 = torch.from_numpy(np.stack(
        [(vals >> 16) & 0xFF, (vals >> 8) & 0xFF, vals & 0xFF],
        axis=1).astype(np.uint8)[None]).to(dev)
    args24 = (tree.aes, t24["s0"], t24["cw_s"], t24["cw_v"], t24["cw_t"],
              t24["cw_np1"], xs24)
    b1c_ms, got = cuda_ms(lambda: walk_eval(*args24, b=0, group="xor"), 10)
    same("B1", f"n={N_FULL} chunk of 2^20 points", got,
         walk_eval_plain(*args24, b=0, group="xor"))
    b1c_needed = walk_lookups(xs24, 0, N_FULL, *lam16_turns)
    b1c_bound = bound(
        b1c_needed,
        (1 << 20) * (N_FULL // 8 + 16) + N_FULL * 34 + 32 + 496)[0]
    b1c_design = pair_lookups_computed(walk_bits_plain(xs24)[0]) / b1c_needed
    b1_row = next(r for r in rows_out if r["name"].startswith("B1 "))
    b1_row["ms_full_domain_chunk"] = b1c_ms
    b1_row["bound_ms_full_domain_chunk"] = b1c_bound
    b1_row["lookups_computed_per_needed_full_domain_chunk"] = b1c_design
    log(f"phase 12 B1 a launch on the per-point full-domain path (n="
        f"{N_FULL}, one key, 2^20 points): {b1c_ms:.3f} ms, bound "
        f"{b1c_bound:.3f} ms; its design computes {b1c_design:.3f}x the "
        f"lookups the bound counts [{card}]")
    del t24, xs24, args24, got
    # -- phase 13: the keygen kernels against their plain versions ---------------------
    # G1 (lam = 16), B7a (lam = 256) at n = 128 and B7b (lam = 32) at
    # n = 24, K = 4096 keys a run, both bounds; B7a is held on the bytes it
    # writes (the narrow 32 of each row, cw_t and the trajectories), W2 on
    # B7a's outputs over every byte of the rows it completes, here and at
    # lam = 16384, K = 64.
    t0 = time.perf_counter()
    krng = np.random.default_rng(SEED + 5)
    gck = [krng.bytes(32) for _ in range(2 * (LAM_CRATE // 16))]
    g_aes = torch.from_numpy(aes_image(gck[0])).to(dev)
    n_aes = torch.from_numpy(narrow_aes_image(gck[0], gck[17])).to(dev)

    def key_inputs(k_num: int, n_bytes: int, lam: int):
        return tuple(torch.from_numpy(a).to(dev) for a in (
            krng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8),
            krng.integers(0, 256, (k_num, lam), dtype=np.uint8),
            random_s0s(k_num, lam, krng)))

    def narrow_of(out):
        cw_s, cw_v, cw_t, np1, traj = out
        return (cw_s[..., :NARROW], cw_v[..., :NARROW], cw_t,
                np1[:, :NARROW], traj)

    def wide_check(what: str, out, ins, lt: bool) -> float:
        """W2 on B7a's outputs ``out`` against its plain version, each on
        its own copy of them, every byte; returns the plain version's
        ms."""
        cw_s, cw_v, _, np1, traj = out
        mine = [t.clone() for t in (cw_s, cw_v, np1)]
        keygen_wide_tail(*mine, traj, *ins, lt=lt)
        plain = [t.clone() for t in (cw_s, cw_v, np1)]
        p_ms, _ = cuda_ms(lambda: keygen_wide_tail_plain(
            *plain, traj, *ins, lt=lt), 1)
        for name, g_, w_ in zip(("cw_s", "cw_v", "cw_np1"), mine, plain):
            same("W2", f"{what} {name}", g_, w_)
        return p_ms

    kg_plain = {}
    for bnd in Bound:
        lt = bnd is Bound.LT_BETA
        for kid, mode, n_bytes, lam, fn, aes_k, names in (
                ("G1", MODE_G1, N_BYTES, 16, keygen_dcf16, g_aes,
                 ("cw_s", "cw_v", "cw_t", "cw_np1")),
                ("B7a", MODE_B7A, N_BYTES, LAM_WIDE, keygen_narrow, n_aes,
                 ("cw_s", "cw_v", "cw_t", "cw_np1", "traj")),
                ("B7b", MODE_B7B, N_DPF_KEYGEN // 8, 32, keygen_dpf, n_aes,
                 ("cw_s", "cw_t", "cw_np1"))):
            ins = key_inputs(K_KEYGEN_CHECK, n_bytes, lam)
            kw = {} if mode == MODE_B7B else {"lt": lt}
            got = fn(aes_k, *ins, **kw)
            p_ms, want = cuda_ms(lambda: keygen_walk_plain(
                aes_k, *ins, mode=mode, lt=lt), 1)
            if lt:
                kg_plain[kid] = p_ms
            if mode == MODE_B7A:
                w_ms = wide_check(f"K={K_KEYGEN_CHECK} lam={lam} "
                                  f"{bnd.name}", got, ins, lt)
                if lt:
                    kg_plain[f"W2 lam={lam}"] = w_ms
                got, want = narrow_of(got), narrow_of(want)
            for name, g_, w_ in zip(names, got, want):
                same(kid, f"K={K_KEYGEN_CHECK} lam={lam} {bnd.name} "
                     f"{name}", g_, w_)
        ins = key_inputs(K_CRATE_KEYGEN, N_BYTES, LAM_CRATE)
        w_ms = wide_check(f"K={K_CRATE_KEYGEN} lam={LAM_CRATE} {bnd.name}",
                          keygen_narrow(n_aes, *ins, lt=lt), ins, lt)
        if lt:
            kg_plain[f"W2 lam={LAM_CRATE}"] = w_ms
    del got, want, ins
    log(f"phase 13 G1, B7a, B7b, W2: byte-identical to their plain versions, "
        f"K={K_KEYGEN_CHECK} keys, 2 bounds (G1 lam=16 and B7a + W2 lam="
        f"{LAM_WIDE} at n={8 * N_BYTES}, B7b lam=32 at n={N_DPF_KEYGEN}; W2 "
        f"also at lam={LAM_CRATE}, K={K_CRATE_KEYGEN}); "
        f"plain versions at LT_BETA: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in kg_plain.items())
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 14: keygen at its full shapes: numpy anchors and times -------------------
    # G1 at config 5's 10^6 keys; B7a and W2, its wide tail, at lam = 256,
    # K = 2^16 and at lam = 16384, K = 64; B7b at n = 24, K = 2^16.  The
    # first 1024 keys of each (all 64 at lam = 16384) equal the numpy
    # gen_batch / dpf_gen_batch, every byte of the key.
    t0 = time.perf_counter()

    def host(*tensors):
        return tuple(t.cpu().numpy() for t in tensors)

    def anchor(kid: str, what: str, got: dict, want) -> None:
        for name, g_ in got.items():
            if not np.array_equal(g_, getattr(want, name)):
                raise RuntimeError(f"{kid} {what}: {name} differs from the "
                                   "numpy oracle")

    ins = key_inputs(K_RELU, N_BYTES, 16)
    # Two untimed calls first: each call allocates 4.4 GB of keys, which
    # the allocator then holds for the timed ones.
    keygen_dcf16(g_aes, *ins, lt=True), keygen_dcf16(g_aes, *ins, lt=True)
    g1_ms, out = cuda_ms(lambda: keygen_dcf16(g_aes, *ins, lt=True), 3)
    k_a = K_ANCHOR
    anchor("G1", f"K={K_RELU}", dict(zip(
        ("cw_s", "cw_v", "cw_t", "cw_np1"), host(*(o[:k_a] for o in out)))),
        gen_batch(HirosePrgNp(16, gck[:2]),
                  *host(*(a[:k_a] for a in ins)), Bound.LT_BETA))
    g1_lookups = K_RELU * n * 2 * 2 * LOOKUPS_BLOCK
    g1_bytes = K_RELU * (N_BYTES + 16 + 32) + K_RELU * (n * 34 + 16)
    del ins, out

    b7a = {}
    for lam, k_num, reps in ((LAM_WIDE, K_WIDE_KEYGEN, 5),
                             (LAM_CRATE, K_CRATE_KEYGEN, 5)):
        ins = key_inputs(k_num, N_BYTES, lam)
        # Two calls' outputs alive at once first, as in the timed loop, so
        # that no allocation falls into it.
        held = keygen_narrow(n_aes, *ins, lt=True)
        keygen_narrow(n_aes, *ins, lt=True)
        del held
        ms, out = cuda_ms(lambda: keygen_narrow(n_aes, *ins, lt=True), reps)
        tail_ms, _ = cuda_ms(lambda: keygen_wide_tail(
            out[0], out[1], out[3], out[4], *ins, lt=True), 5)
        k_a = min(K_ANCHOR, k_num)
        anchor("B7a", f"lam={lam} K={k_num}", dict(zip(
            ("cw_s", "cw_v", "cw_t", "cw_np1"),
            host(*(o[:k_a] for o in out[:4])))),
            gen_batch(HirosePrgNp(lam, gck[:2 * (lam // 16)]),
                      *host(*(a[:k_a] for a in ins)), Bound.LT_BETA))
        if lam == LAM_CRATE:  # the plain version at this (small) shape
            p_ms, want = cuda_ms(lambda: keygen_walk_plain(
                n_aes, *ins, mode=MODE_B7A, lt=True), 1)
            got = keygen_narrow(n_aes, *ins, lt=True)
            for name, g_, w_ in zip(("cw_s", "cw_v", "cw_t", "cw_np1",
                                     "traj"), narrow_of(got),
                                    narrow_of(want)):
                same("B7a", f"lam={lam} K={k_num} {name}", g_, w_)
        else:
            p_ms = kg_plain["B7a"]
        wd = lam - NARROW
        b7a[lam] = dict(
            ms=ms, tail_ms=tail_ms, plain=p_ms, k=k_num,
            tail_plain=kg_plain[f"W2 lam={lam}"],
            lookups=k_num * n * 2 * 4 * LOOKUPS_BLOCK,
            bytes=k_num * (N_BYTES + 3 * NARROW)
            + k_num * (n * (2 * NARROW + 4) + NARROW),
            # W2 reads alpha, the trajectories, beta's and the seeds' wide
            # bytes, and writes the wide bytes of cw_s, cw_v and cw_np1.
            tail_bytes=k_num * (n // 8 + 2 * n + 3 * wd)
            + k_num * (2 * n + 1) * wd)
        log(f"phase 14 B7a lam={lam} K={k_num}: {ms:.3f} ms (plain "
            f"{p_ms:.1f} ms at K={K_KEYGEN_CHECK if lam == LAM_WIDE else k_num}"
            f"), W2, its wide tail ({n} levels over [{k_num}, {wd}] bytes), "
            f"{tail_ms:.3f} ms; first {k_a} keys equal the numpy gen_batch, "
            f"every byte [{card}]")
        del ins, out

    ins = key_inputs(K_WIDE_KEYGEN, N_DPF_KEYGEN // 8, 32)
    held = keygen_dpf(n_aes, *ins)  # two calls' keys allocated first
    keygen_dpf(n_aes, *ins)
    del held
    b7b_ms, out = cuda_ms(lambda: keygen_dpf(n_aes, *ins), 5)
    anchor("B7b", f"n={N_DPF_KEYGEN} K={K_WIDE_KEYGEN}", dict(zip(
        ("cw_s", "cw_t", "cw_np1"), host(*(o[:K_ANCHOR] for o in out)))),
        dpf_gen_batch(HirosePrgNp(32, gck[:18], warn=False),
                      *host(*(a[:K_ANCHOR] for a in ins))))
    # A party's level needs E0(s_b0) and E17(s_b1) in full and E0(~s_b0)
    # to its t bit, as a DPF tree's parent (kernel B6).
    b7b_lookups = K_WIDE_KEYGEN * N_DPF_KEYGEN * 2 * LOOKUPS_DPF_NODE
    b7b_bytes = K_WIDE_KEYGEN * (N_DPF_KEYGEN // 8 + 3 * 32) \
        + K_WIDE_KEYGEN * (N_DPF_KEYGEN * 34 + 32)
    del ins, out
    log(f"phase 14 G1 K={K_RELU}: {g1_ms:.3f} ms; B7b n={N_DPF_KEYGEN} "
        f"K={K_WIDE_KEYGEN}: {b7b_ms:.3f} ms; first {K_ANCHOR} keys of each "
        f"equal the numpy oracle ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 15: B8 against its plain version; B1 beyond 65,535 keys -------------------
    t0 = time.perf_counter()
    xs_r = torch.from_numpy(krng.integers(
        0, 256, (1, M_RELU, N_BYTES), dtype=np.uint8)).to(dev)
    for bnd in Bound:
        ins = key_inputs(K_B8_CHECK, N_BYTES, 16)
        img = keygen_dcf16(g_aes, *ins, lt=bnd is Bound.LT_BETA)
        for b in (0, 1):
            args = (g_aes, ins[2], *img, xs_r)
            b8_plain, want = cuda_ms(
                lambda: keylanes_eval_plain(*args, b=b), 1)
            same("B8", f"K={K_B8_CHECK} M={M_RELU} {bnd.name} party {b}",
                 keylanes_eval(*args, b=b), want)
    del img, want
    # A partial last group (4099 = 128 x 32 + 3 keys) and points that do
    # not divide among a block's 16 warps.
    xs_tail = torch.from_numpy(krng.integers(
        0, 256, (1, M_B8_TAIL, N_BYTES), dtype=np.uint8)).to(dev)
    for bnd in Bound:
        ins = key_inputs(K_B8_TAIL, N_BYTES, 16)
        img = keygen_dcf16(g_aes, *ins, lt=bnd is Bound.LT_BETA)
        for b in (0, 1):
            args = (g_aes, ins[2], *img, xs_tail)
            same("B8", f"K={K_B8_TAIL} M={M_B8_TAIL} {bnd.name} party {b}",
                 keylanes_eval(*args, b=b), keylanes_eval_plain(*args, b=b))
    del img, ins, xs_tail
    # n = 256: levels 160.. are read from the key rows, not staged (host
    # keys, so that this check does not rest on G1 at this depth).
    nb_deep = N_B8_DEEP // 8
    d_alphas = krng.integers(0, 256, (K_B8_DEEP, nb_deep), dtype=np.uint8)
    xs_deep = krng.integers(0, 256, (M_B8_DEEP, nb_deep), dtype=np.uint8)
    xs_deep[0] = d_alphas[0]
    xs_deep = torch.from_numpy(xs_deep[None]).to(dev)
    for bnd in Bound:
        kb = gen_batch(HirosePrgNp(16, gck[:2]), d_alphas, krng.integers(
            0, 256, (K_B8_DEEP, 16), dtype=np.uint8),
            random_s0s(K_B8_DEEP, 16, krng), bnd)
        args = (g_aes, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in (kb.s0s, kb.cw_s, kb.cw_v, kb.cw_t,
                                   kb.cw_np1)), xs_deep)
        for b in (0, 1):
            same("B8", f"n={N_B8_DEEP} K={K_B8_DEEP} M={M_B8_DEEP} "
                 f"{bnd.name} party {b}", keylanes_eval(*args, b=b),
                 keylanes_eval_plain(*args, b=b))
    del args, xs_deep
    ins = key_inputs(K_CAP, N_BYTES, 16)
    img = keygen_dcf16(g_aes, *ins, lt=True)
    xs_c = torch.from_numpy(krng.integers(
        0, 256, (1, M_CAP, N_BYTES), dtype=np.uint8)).to(dev)
    args = (g_aes, ins[2][:, 0].contiguous(), *img, xs_c)
    walk_eval.launches = 0
    got = walk_eval(*args, b=0, group="xor")
    cap_launches = walk_eval.launches
    same("B1", f"K={K_CAP} x {M_CAP} points", got,
         walk_eval_plain(*args, b=0, group="xor"))
    if cap_launches != 2:
        raise RuntimeError(f"B1 at K={K_CAP}: {cap_launches} launches, want "
                           "2 key slices")
    del ins, img, args, got
    log(f"phase 15 B8: byte-identical to its plain version at K={K_B8_CHECK}"
        f" x {M_RELU} points (its plain version {b8_plain:.1f} ms there), at "
        f"K={K_B8_TAIL} x {M_B8_TAIL} and at n={N_B8_DEEP}, K={K_B8_DEEP} x "
        f"{M_B8_DEEP}, each 2 bounds x 2 parties; B1 at K={K_CAP} keys x {M_CAP} points "
        f"({cap_launches} launches of at most 65,535 keys) byte-identical to "
        f"its plain version ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 16: keygen through the facade; config 5 at full size ------------------------
    # Each keygen path is one facade call on the card, its first 64 keys
    # held against the numpy oracle.
    t0 = time.perf_counter()
    kg_paths = (
        (f"Dcf.gen lam=16 K={K_KEYGEN_CHECK}", 16, N_BYTES, K_KEYGEN_CHECK,
         "gen", {"G1": 1}),
        (f"Dcf.gen lam={LAM_WIDE} K={K_ANCHOR}", LAM_WIDE, N_BYTES, K_ANCHOR,
         "gen", {"B7a": 1, "W2": 1}),
        (f"Dcf.gen lam={LAM_CRATE} K={K_CRATE_KEYGEN}", LAM_CRATE, N_BYTES,
         K_CRATE_KEYGEN, "gen", {"B7a": 1, "W2": 1}),
        (f"Dcf.dpf lam=32 n={N_DPF_KEYGEN} K={K_KEYGEN_CHECK}", 32,
         N_DPF_KEYGEN // 8, K_KEYGEN_CHECK, "dpf", {"B7b": 1}))
    kg_ms = {}
    for name, lam, n_bytes, k_num, method, want_launches in kg_paths:
        kck = gck[:max(18, 2 * (lam // 16))]
        client = Dcf(n_bytes, lam, kck)
        a = krng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
        bt = krng.integers(0, 256, (k_num, lam), dtype=np.uint8)
        s0 = random_s0s(k_num, lam, krng)
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = getattr(client, method)(a, bt, s0s=s0)
        kg_ms[name] = (time.perf_counter() - t1) * 1e3
        take_counts(name, want_launches)
        kprg = HirosePrgNp(lam, kck, warn=False)
        want = (gen_batch(kprg, a[:64], bt[:64], s0[:64], Bound.LT_BETA)
                if method == "gen" else dpf_gen_batch(kprg, a[:64], bt[:64],
                                                      s0[:64]))
        for field in ("cw_s", "cw_t", "cw_np1") + (
                ("cw_v",) if method == "gen" else ()):
            if not np.array_equal(getattr(got, field)[:64],
                                  getattr(want, field)):
                raise RuntimeError(f"{name}: {field} of the first 64 keys "
                                   "differs from the numpy oracle")
    log(f"phase 16 keygen through the facade, host clock, keys fetched to "
        f"host bundles: " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                      kg_ms.items())
        + f"; first 64 keys of each equal the numpy oracle [{card}]")

    # BASELINE.json config 5: 10^6 keys x 1024 shared points, lam = 16,
    # n = 128, both parties, keygen, evaluation and the count on the card.
    rrng = np.random.default_rng(SEED + 6)
    rck = [rrng.bytes(32), rrng.bytes(32)]
    r_alphas = rrng.integers(0, 256, (K_RELU, N_BYTES), dtype=np.uint8)
    r_betas = rrng.integers(0, 256, (K_RELU, 16), dtype=np.uint8)
    r_s0s = random_s0s(K_RELU, 16, rrng)
    r_xs = rrng.integers(0, 256, (M_RELU, N_BYTES), dtype=np.uint8)
    for j, d in enumerate((0, -1, 1)):  # x = alpha, alpha - 1, alpha + 1
        a = int.from_bytes(r_alphas[j].tobytes(), "big") + d
        r_xs[j] = np.frombuffer((a % (1 << 8 * N_BYTES)).to_bytes(
            N_BYTES, "big"), dtype=np.uint8)
    kept = {}

    def keep_first(lo, hi, y0, y1, be) -> None:
        if lo == 0:
            kept["chunk"] = (hi, y0, y1)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mism = secure_relu_check_device(16, rck, r_alphas, r_betas, r_s0s, r_xs,
                                    on_chunk=keep_first)
    relu_s = time.perf_counter() - t1  # the count's fetch synchronised
    relu_peak = torch.cuda.max_memory_allocated()
    n_chunks = -(-K_RELU // (1 << 17))
    ran_relu = take_counts(f"secure ReLU config 5 K={K_RELU} M={M_RELU}",
                           {"G1": n_chunks, "B8": 2 * n_chunks})
    if mism != 0:
        raise RuntimeError(f"config 5: {mism} mismatches over {K_RELU} keys "
                           f"x {M_RELU} points")
    hi0, y0c, y1c = kept.pop("chunk")
    if tuple(y0c.shape) != (hi0, M_RELU, 16):
        raise RuntimeError(f"config 5: chunk shares of shape {y0c.shape}")
    xs_t = torch.from_numpy(r_xs[None].copy()).to(dev)
    moved = r_alphas[:hi0].copy()
    a0 = int.from_bytes(moved[0].tobytes(), "big")
    moved[0] = np.frombuffer(((a0 + 1) % (1 << 8 * N_BYTES)).to_bytes(
        N_BYTES, "big"), dtype=np.uint8)
    recount = int(points_mismatch_count(y0c, y1c, r_alphas[:hi0],
                                        r_betas[:hi0], xs_t, 16, "xor"))
    control = int(points_mismatch_count(y0c, y1c, moved, r_betas[:hi0],
                                        xs_t, 16, "xor"))
    if recount != 0 or control < 1:
        raise RuntimeError(f"config 5 control: the first chunk recounts "
                           f"{recount} (want 0) and {control} with alpha_0 "
                           "moved (want >= 1)")
    rprg = HirosePrgNp(16, rck)
    kb = gen_batch(rprg, r_alphas[:K_RELU_ANCHOR], r_betas[:K_RELU_ANCHOR],
                   r_s0s[:K_RELU_ANCHOR], Bound.LT_BETA)
    for b, yc in ((0, y0c), (1, y1c)):
        want = eval_batch_np(rprg, b, kb.for_party(b), r_xs[:M_RELU_ANCHOR])
        if not np.array_equal(
                yc[:K_RELU_ANCHOR, :M_RELU_ANCHOR].cpu().numpy(), want):
            raise RuntimeError(f"config 5: party {b}'s shares of the first "
                               f"{K_RELU_ANCHOR} keys differ from the numpy "
                               "oracle")
    # B8 timed on the first chunk's inputs; its shares equal the run's.
    r_aes = torch.from_numpy(aes_image(rck[0])).to(dev)
    ins = tuple(torch.from_numpy(np.ascontiguousarray(a[:hi0])).to(dev)
                for a in (r_alphas, r_betas, r_s0s))
    img = keygen_dcf16(r_aes, *ins, lt=True)
    b8_ms, got = cuda_ms(lambda: keylanes_eval(r_aes, ins[2], *img, xs_t,
                                               b=0), 2)
    if not torch.equal(got, y0c):
        raise RuntimeError("B8: a repeat of the first chunk's party-0 "
                           "evaluation differs from the run's shares")
    b8_lookups = hi0 * walk_lookups(xs_t, 0, n, *lam16_turns)
    b8_bytes = M_RELU * N_BYTES + hi0 * (n * 34 + 32 + 16) \
        + hi0 * M_RELU * 16
    del kept, y0c, y1c, got, img, ins
    torch.cuda.empty_cache()
    log(f"phase 16 secure ReLU (BASELINE.json config 5): {K_RELU} keys x "
        f"{M_RELU} shared points, lam=16, n={n}, both parties, "
        f"workloads.secure_relu_check_device (G1 + B8 x 2 + the count per "
        f"chunk of {hi0} keys, on the card): 0 mismatches; the first chunk "
        f"recounts 0, and {control} with alpha_0 moved by one; the first "
        f"{K_RELU_ANCHOR} keys' shares at the first {M_RELU_ANCHOR} points "
        f"equal the numpy oracle; wall {relu_s:.3f} s = "
        f"{2 * K_RELU * M_RELU / relu_s:,.0f} evals/s (both parties, keygen "
        f"and the check included), peak device memory "
        f"{relu_peak / 2**30:.2f} GiB; launches {ran_relu}; B8 alone on one "
        f"chunk {b8_ms:.3f} ms ({time.perf_counter() - t0:.1f} s) [{card}]")

    add_row("phase 16", "G1", "keygen_walk",
            "dcf_tpu/backends/device_gen.py:70", g1_ms, kg_plain["G1"],
            g1_lookups, g1_bytes, shape=f"K={K_RELU} n={n} lam=16",
            plain_shape=f"K={K_KEYGEN_CHECK}")
    for lam, r in b7a.items():
        add_row("phase 16", "B7a", "keygen_walk",
                "dcf_tpu/ops/pallas_keygen.py:153", r["ms"], r["plain"],
                r["lookups"], r["bytes"], label=f" lam={lam}",
                shape=f"K={r['k']} n={n} lam={lam}",
                plain_shape=f"K={K_KEYGEN_CHECK if lam == LAM_WIDE else r['k']}")
    for lam, r in b7a.items():
        add_row("phase 16", "W2", "keygen_wide",
                "dcf_tpu/ops/pallas_keygen.py:214", r["tail_ms"],
                r["tail_plain"], 0, r["tail_bytes"], label=f" lam={lam}",
                shape=f"K={r['k']} n={n} lam={lam}",
                plain_shape=f"K={K_KEYGEN_CHECK if lam == LAM_WIDE else r['k']}")
    add_row("phase 16", "B7b", "keygen_walk",
            "dcf_tpu/ops/pallas_keygen.py:540", b7b_ms, kg_plain["B7b"],
            b7b_lookups, b7b_bytes,
            shape=f"K={K_WIDE_KEYGEN} n={N_DPF_KEYGEN} lam=32",
            plain_shape=f"K={K_KEYGEN_CHECK}")
    add_row("phase 16", "B8", "keylanes_eval",
            "dcf_tpu/ops/pallas_keylanes.py:113", b8_ms, b8_plain,
            b8_lookups, b8_bytes, shape=f"K={hi0} M={M_RELU} n={n}",
            plain_shape=f"K={K_B8_CHECK} M={M_RELU}")

    # -- phase 17: the bench line, and the C++ core's keys -------------------------------
    # bench_torch.py's run at full size on the card (the prefix path, 2^20
    # points, its two parity gates); its launches are held to be on B2 and
    # B3 but are no path's count (a timed loop).  Then the C++ core's keys
    # against the numpy gen_batch on this machine.
    t0 = time.perf_counter()
    import bench_torch
    from dcf_tpu_torch.native import NativeDcf

    reset_counts()
    line = bench_torch.run()
    ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if set(ran) != {"B2", "B3"}:
        raise RuntimeError(f"bench_torch launched {ran}, want B2 and B3 "
                           "alone")
    log("phase 17 bench_torch line: " + json.dumps(line))
    nrng = np.random.default_rng(SEED + 7)
    for lam in (16, LAM_WIDE):
        nck = [nrng.bytes(32) for _ in range(max(2, 2 * (lam // 16)))]
        core = NativeDcf(lam, nck)
        kprg = HirosePrgNp(lam, nck, warn=False)
        for bnd in Bound:
            a, bt, s0 = (nrng.integers(0, 256, (K_RELU_ANCHOR, N_BYTES),
                                       dtype=np.uint8),
                         nrng.integers(0, 256, (K_RELU_ANCHOR, lam),
                                       dtype=np.uint8),
                         random_s0s(K_RELU_ANCHOR, lam, nrng))
            got = core.gen_batch(a, bt, s0, bnd)
            want = gen_batch(kprg, a, bt, s0, bnd)
            for field in ("cw_s", "cw_v", "cw_t", "cw_np1"):
                if not np.array_equal(getattr(got, field),
                                      getattr(want, field)):
                    raise RuntimeError(
                        f"NativeDcf.gen_batch lam={lam} {bnd.name}: {field} "
                        "differs from the numpy gen_batch")
    log(f"phase 17 bench_torch: parity gates passed, {line['value']:,.1f} "
        f"evals/s = {line['vs_baseline']}x the pinned CPU rate, launches "
        f"{ran}; NativeDcf.gen_batch (AES-NI={core.has_aesni}) equals the "
        f"numpy gen_batch, {K_RELU_ANCHOR} keys at lam=16 and {LAM_WIDE}, 2 "
        f"bounds ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 18: the interval protocols and fixed-point gates on the card ------------
    # Part 1 holds the kernels against their plain versions at the protocol
    # shapes (16 keys packed on the K axis, n = 8, 16 and 128), so that a
    # shape fault shows as a kernel mismatch before any protocol runs.
    t0 = time.perf_counter()
    prng = np.random.default_rng(SEED + 8)
    pck = [prng.bytes(32), prng.bytes(32)]
    pprg = HirosePrgNp(16, pck)
    paes = torch.from_numpy(aes_image(pck[0])).to(dev)
    pgroups = ("xor", "add16", "add32")

    def proto_keys(n_bytes: int, group: str, bnd: Bound):
        alphas = prng.integers(0, 256, (K_MIC, n_bytes), dtype=np.uint8)
        return alphas, gen_batch(
            pprg, alphas, prng.integers(0, 256, (K_MIC, 16), dtype=np.uint8),
            random_s0s(K_MIC, 16, prng), bnd, group=group)

    def planted_all(alphas: np.ndarray, m: int) -> torch.Tensor:
        """Staged points [1, m, nb]: x = alpha - 1, alpha, alpha + 1 of
        every key first, then random ones."""
        nb = alphas.shape[1]
        xs = prng.integers(0, 256, (m, nb), dtype=np.uint8)
        vals = [int.from_bytes(a.tobytes(), "big") + d
                for a in alphas for d in (-1, 0, 1)]
        for j, x in enumerate(vals):
            xs[j] = np.frombuffer((x % (1 << 8 * nb)).to_bytes(nb, "big"),
                                  dtype=np.uint8)
        return torch.from_numpy(xs[None]).to(dev)

    def host_frontiers(kprg, kb: KeyBundle, b: int) -> list:
        """Each key's level-6 nodes for party b (the host levels)."""
        return [tuple(torch.from_numpy(a).to(dev) for a in tree_expand_np(
            kprg, KeyBundle(s0s=kb.s0s[i:i + 1], cw_s=kb.cw_s[i:i + 1],
                            cw_v=kb.cw_v[i:i + 1], cw_t=kb.cw_t[i:i + 1],
                            cw_np1=kb.cw_np1[i:i + 1], group=kb.group),
            b, HOST_LEVELS)) for i in range(kb.num_keys)]

    def stacked_table(k_aes, t: dict, tops: list, k: int, group: str,
                      kernel: bool) -> torch.Tensor:
        """The keys' frontier tables at depth k, stacked: B2's launches
        as ``tree_expand`` cuts them, or its plain version a level at a
        time."""
        tables = []
        for i, nodes in enumerate(tops):
            cws = (t["cw_s"][i], t["cw_v"][i], t["cw_t"][i])
            if kernel:
                nodes = tree_expand(k_aes, *cws, *nodes, k0=HOST_LEVELS,
                                    k1=k, group=group)
            else:
                for lvl in range(HOST_LEVELS, k):
                    nodes = tree_expand_level_plain(
                        k_aes, *(c[lvl] for c in cws), *nodes, group=group)
            tables.append(frontier_table(*nodes))
        return torch.cat(tables)

    for n_bytes in (1, 2):
        for group in pgroups:
            for bnd in Bound:
                alphas, bundle = proto_keys(n_bytes, group, bnd)
                xs = planted_all(alphas, M_CHECK)
                for b in (0, 1):
                    t = on_card(bundle.for_party(b))
                    args = (paes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"],
                            t["cw_np1"], xs)
                    same("B1", f"n={8 * n_bytes} K={K_MIC} {group} "
                         f"{bnd.name} party {b}",
                         walk_eval(*args, b=b, group=group),
                         walk_eval_plain(*args, b=b, group=group))
    b2_cuts = {}
    for n_bytes, k in ((2, 8), (N_BYTES, 17)):
        for group in pgroups:
            for bnd in Bound:
                alphas, bundle = proto_keys(n_bytes, group, bnd)
                xs = planted_all(alphas, M_CHECK)
                for b in (0, 1):
                    kb = bundle.for_party(b)
                    t = on_card(kb)
                    tops = host_frontiers(pprg, kb, b)
                    what = (f"n={8 * n_bytes} K={K_MIC} k={k} {group} "
                            f"{bnd.name} party {b}")
                    table = stacked_table(paes, t, tops, k, group, True)
                    same("B2", what, table,
                         stacked_table(paes, t, tops, k, group, False))
                    pargs = (paes, table, t["cw_s"], t["cw_v"], t["cw_t"],
                             t["cw_np1"], xs)
                    neg = bool(b) and group != "xor"
                    same("B3", what,
                         prefix_eval(*pargs, k=k, negate=neg, group=group),
                         prefix_eval_plain(*pargs, k=k, negate=neg,
                                           group=group))
                if group != "xor" or bnd is not Bound.LT_BETA:
                    continue
                # The backend's own depth, launches and cached frontier
                # agree with the k held above.
                be = PrefixBackend(16, pck, device=dev)
                be.put_bundle(bundle.for_party(1))
                reset_counts()
                cached = be._frontier_tables(1)
                b2_cuts[k] = tree_expand_levels.launches
                want_b2 = K_MIC * len(launch_depths(HOST_LEVELS, k))
                if be._k() != k or b2_cuts[k] != want_b2 \
                        or not torch.equal(cached, table):
                    raise RuntimeError(
                        f"PrefixBackend at n={8 * n_bytes}, K={K_MIC}: "
                        f"k={be._k()} (want {k}), {b2_cuts[k]} B2 launches "
                        f"(want {want_b2}), cached frontier equal: "
                        f"{torch.equal(cached, table)}")
    log(f"phase 18 B1 at n=8 and 16, B2 + B3 at n=16 (k=8) and n=128 "
        f"(k=17), K={K_MIC} keys with shared points, {len(pgroups)} groups "
        f"x 2 bounds x 2 parties at {M_CHECK} points: byte-identical to "
        f"their plain versions; PrefixBackend's depth, cached frontier and "
        f"B2 launches a party agree ({b2_cuts}) "
        f"({time.perf_counter() - t0:.1f} s)")

    # Part 2: MIC at mic_bench's shape, 8 intervals (16 keys), n = 128,
    # 2^20 shared points: keygen on the card (G1) against the host walk,
    # then walk and prefix, both parties, the facade and the staged
    # evaluator, held against each other, the oracle and a count on the
    # card.
    t0 = time.perf_counter()
    mrng = np.random.default_rng(SEED + 9)
    mck = [mrng.bytes(32), mrng.bytes(32)]
    top = 1 << (8 * N_BYTES)
    cuts = sorted({int.from_bytes(mrng.bytes(16), "big")
                   for _ in range(14)})
    intervals = [(cuts[2 * i], cuts[2 * i + 1]) for i in range(6)]
    intervals += [(cuts[13], cuts[12]), (cuts[12], top)]  # wrap, q = N
    m_int = len(intervals)
    betas = mrng.integers(0, 256, (m_int, 16), dtype=np.uint8)
    xs_np = mrng.integers(0, 256, (M_MAIN, N_BYTES), dtype=np.uint8)
    edges = sorted({(x + d) % top for pq in intervals for x in pq
                    for d in (-1, 0)})
    for j, x in enumerate(edges):
        xs_np[j] = np.frombuffer(x.to_bytes(N_BYTES, "big"), dtype=np.uint8)
    dcf_w = Dcf(N_BYTES, 16, mck, backend="walk")
    dcf_p = Dcf(N_BYTES, 16, mck, backend="prefix")
    reset_counts()
    pb = dcf_w.mic(intervals, betas, rng=np.random.default_rng(SEED + 10),
                   device=True)
    torch.cuda.synchronize()
    take_counts("mic_keygen", {"G1": 1})
    pb_host = dcf_w.mic(intervals, betas,
                        rng=np.random.default_rng(SEED + 10), device=False)
    if pb.to_bytes() != pb_host.to_bytes():
        raise RuntimeError("Dcf.mic(device=True): the G1 bundle's frame "
                           "differs from the host walk's")
    # The same intervals and betas in add16: the lane-add combine on the
    # card.  2^20 - 5 points, not a whole number of point tiles, so pad
    # points are combined and then dropped.
    pb16 = dcf_w.mic(intervals, betas, rng=np.random.default_rng(SEED + 12),
                     group="add16")
    m16 = M_MAIN - 5
    first = M_CHECK
    want_first = mic_oracle(xs_np[:first], intervals, betas)

    def mic_count(ys: list, masks: list, staged: dict, gw: int) -> int:
        """Staged points whose reconstruction from both parties' combined
        shares (uint8 [m, M_pad, 16] on the card) and combine masks
        (uint8 [m, 16]), in the group of lane width ``gw`` (0 = XOR),
        differs from beta_i 1[x in interval_i], over the real points."""
        def lanes(a: torch.Tensor) -> torch.Tensor:
            """uint8 [..., 16] -> int64 little-endian gw-bit lanes."""
            w = gw // 8
            v = a.long().unflatten(-1, (-1, w))
            return (v << (8 * torch.arange(w, device=dev))).sum(-1)

        x = staged["xs"]
        ms = [torch.from_numpy(mk).to(dev)[:, None, :] for mk in masks]
        if gw == 0:
            recon = (ys[0] ^ ms[0] ^ ys[1] ^ ms[1]).long()
        else:
            recon = sum(lanes(a) for a in (*ys, *ms)) & ((1 << gw) - 1)
        recon = recon[:, :staged["m"]]
        bt = torch.from_numpy(betas).to(dev)
        bt = bt.long() if gw == 0 else lanes(bt)
        bad = torch.zeros((), dtype=torch.int64, device=dev)

        def below(v: int) -> torch.Tensor:
            """1[x < v] of the staged points, from their big-endian bytes
            compared a byte at a time, most significant first."""
            if v == top:
                return torch.ones(x.shape[1], dtype=torch.bool, device=dev)
            lt = torch.zeros(x.shape[1], dtype=torch.bool, device=dev)
            eq = torch.ones_like(lt)
            for j, a_j in enumerate(v.to_bytes(N_BYTES, "big")):
                col = x[0, :, j]
                lt |= eq & (col < a_j)
                eq &= col == a_j
            return lt

        for i, (p, q) in enumerate(intervals):
            lp, lq = below(p), below(q)
            inside = (~lp & lq) if p <= q else (~lp | lq)
            inside = inside[:staged["m"]]
            want = torch.where(inside[:, None], bt[i],
                               torch.zeros_like(bt[i]))
            bad += (recon[i] != want).any(-1).sum()
        return int(bad)

    mic_out, mic_ms, mic_counts, mic_parts = {}, {}, {}, {}
    mic_launches = {"walk": {"B1": 2}, "prefix": {
        "B2": 2 * K_MIC * len(launch_depths(HOST_LEVELS, 17)), "B3": 2}}
    for name, dcf, kpb, where, mp in (
            ("mic_walk", dcf_w, pb, "walk", M_MAIN),
            ("mic_prefix", dcf_p, pb, "prefix", M_MAIN),
            ("mic_add16_walk", dcf_w, pb16, "walk", m16),
            ("mic_add16_prefix", dcf_p, pb16, "prefix", m16)):
        group = kpb.group
        gw = group_width(group)
        xs_run = xs_np[:mp]
        reset_counts()
        evs = [MicEvaluator(dcf, kpb, b) for b in (0, 1)]
        ys = [ev.eval(xs_run) for ev in evs]
        torch.cuda.synchronize()
        take_counts(name, mic_launches[where])
        for b in (0, 1):
            if not np.array_equal(dcf.eval_mic(b, kpb, xs_run), ys[b]):
                raise RuntimeError(f"{name}: party {b}'s facade eval_mic "
                                   "differs from MicEvaluator")
        if not np.array_equal(
                np_group_add(ys[0], ys[1], group)[:, :first], want_first):
            raise RuntimeError(f"{name}: the reconstruction differs from "
                               f"mic_oracle on the first {first} points")
        mic_out[name] = ys
        staged = evs[0].backend.stage(xs_run)
        dev_ys = [staged_pair_combine(ev.backend.eval_staged(b, staged),
                                      group) for b, ev in enumerate(evs)]
        mic_counts[name] = mic_count(
            dev_ys, [kpb.masks_for(b) for b in (0, 1)], staged, gw)
        if mic_counts[name]:
            raise RuntimeError(f"{name}: {mic_counts[name]} (interval, "
                               f"point) pairs of {mp} points differ on "
                               "the card")
        be0 = evs[0].backend
        y_dev = be0.eval_staged(0, staged)
        comb_ms, y_comb = cuda_ms(lambda: staged_pair_combine(y_dev, group),
                                  10)
        y_host = be0.staged_to_bytes(y_comb, mp)
        mic_ms[name] = (wall_ms(lambda: evs[0].eval(xs_run), REPEATS),
                        wall_ms(lambda: dcf.eval_mic(0, kpb, xs_run),
                                REPEATS),
                        comb_ms, mp)
        # Where MicEvaluator.eval's time goes: staging the points, the
        # kernels, the combine, the fetch and the host mask.
        mic_parts[name] = {
            "stage": wall_ms(lambda: be0.stage(xs_run), 5),
            "eval_staged": cuda_ms(lambda: be0.eval_staged(0, staged),
                                   5)[0],
            "combine": comb_ms,
            "fetch": wall_ms(lambda: be0.staged_to_bytes(y_comb, mp), 5),
            "host mask": wall_ms(lambda: np_group_add(
                y_host, kpb.masks_for(0)[:, None, :], group), 5)}
        del staged, dev_ys, y_dev, y_comb, y_host
    for w_, p_ in (("mic_walk", "mic_prefix"),
                   ("mic_add16_walk", "mic_add16_prefix")):
        if not all(np.array_equal(a, c) for a, c in zip(
                mic_out[w_], mic_out[p_])):
            raise RuntimeError(f"MIC: the {w_} and {p_} paths differ")
    del mic_out
    log(f"phase 18 MIC (mic_bench's shape): lam=16, n=128, m={m_int} "
        f"intervals ({K_MIC} keys, one wraparound, one with q=2^128), "
        f"{M_MAIN} shared points in XOR and {m16} in add16: "
        f"Dcf.mic(device=True) (G1) frame "
        f"equals the host walk's; walk and prefix, both parties, eval_mic "
        f"and MicEvaluator give the same bytes; the first {first} points "
        f"equal mic_oracle; 0 mismatches over all points on the card "
        f"({mic_counts}); party 0, median of {REPEATS}: " + "; ".join(
            f"{nm} MicEvaluator.eval {ev_ms:.1f} ms = "
            f"{mp / ev_ms * 1e3:,.0f} points/s, eval_mic {fa_ms:.1f} ms "
            f"= {mp / fa_ms * 1e3:,.0f} points/s, staged combine "
            f"{c_ms:.3f} ms (CUDA events)"
            for nm, (ev_ms, fa_ms, c_ms, mp) in mic_ms.items())
        + "; MicEvaluator.eval's parts, ms (host clock, eval_staged and "
        "the combine by CUDA events): " + json.dumps(
            {nm: {k: round(v, 3) for k, v in parts.items()}
             for nm, parts in mic_parts.items()})
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # Part 3: the gates at gate_bench's shape, a 16-bit domain, f = 8,
    # add16, m = 8 sigmoid pieces, 2^20 masked inputs (one activation
    # layer), every output held against its oracle.
    t0 = time.perf_counter()
    grng = np.random.default_rng(SEED + 11)
    gck = [grng.bytes(32), grng.bytes(32)]
    g_w = Dcf(2, 16, gck, backend="walk")
    g_p = Dcf(2, 16, gck, backend="prefix")
    g_low = Dcf(1, 16, gck, backend="walk")
    gn = 1 << 16
    x_hat = grng.integers(0, gn, M_MAIN, dtype=np.int64)
    x_hat[:8] = [0, 1, gn - 1, gn // 2, gn // 2 - 1, 255, 256, 257]
    r_sign, r_trunc, r_sig = (int(v) for v in grng.integers(0, gn, 3))
    gates = {}  # name -> (party gates, share fn, oracle, facades)
    for fac, where in ((g_w, "walk"), (g_p, "prefix")):
        sg = fp.gen_sign_gate(fac, r_sign, grng, "add16")
        gates[f"sign {where}"] = (
            [sg.for_party(b) for b in (0, 1)],
            lambda b, g, f=fac: fp.eval_sign_share(f, b, g, x_hat),
            fp.sign_oracle((x_hat - r_sign) % gn, 16))
        if fac is g_w:
            tg = fp.gen_trunc_gate(fac, g_low, r_trunc, 8, grng, "add16")
            gates["trunc walk"] = (
                [tg.for_party(b) for b in (0, 1)],
                lambda b, g: fp.eval_trunc_share(g_w, g_low, b, g, x_hat),
                fp.trunc_oracle(x_hat, r_trunc, 8, 16))
        sig = fp.gen_sigmoid_gate(fac, r_sig, grng, "add16", f=8, m=8)
        gates[f"sigmoid {where}"] = (
            [sig.for_party(b) for b in (0, 1)],
            lambda b, g, f=fac: fp.eval_sigmoid_share(f, b, g, x_hat),
            fp.sigmoid_fixed_oracle((x_hat - r_sig) % gn, sig.cuts,
                                    sig.values))
    gate_ms, gate_eval_ms = {}, {}
    for path, where, want_launches in (
            ("gates_walk", "walk", {"B1": 8}),
            ("gates_prefix", "prefix",
             {"B2": 2 * (2 + 2 * 8) * len(launch_depths(HOST_LEVELS, 8)),
              "B3": 4})):
        reset_counts()
        outs = {}
        for name, (gp, share, _) in gates.items():
            if name.endswith(where):
                outs[name] = [share(b, gp[b]) for b in (0, 1)]
        torch.cuda.synchronize()
        take_counts(path, want_launches)
        for name, ys in outs.items():
            got = fp.gate_reconstruct(ys[0], ys[1], "add16")
            bad = int((got != gates[name][2]).sum())
            if bad:
                raise RuntimeError(f"gate {name}: {bad} of {M_MAIN} inputs "
                                   "differ from the oracle")
            gp, share, _ = gates[name]
            share(0, gp[0])  # ships this gate's keys to party 0's slot
            gate_ms[name] = wall_ms(lambda: share(0, gp[0]), REPEATS)
            if not name.startswith("trunc"):
                # The facade's eval alone (staging, the kernels and the
                # fetch of the 2m keys' shares); the rest is host numpy.
                fac = g_w if name.endswith("walk") else g_p
                gate_eval_ms[name] = wall_ms(lambda: fac.eval(
                    0, gp[0].pb.keys, fp.points_of(x_hat, 2)), REPEATS)
    log(f"phase 18 gates (gate_bench's shape): lam=16, n=16, f=8, add16, "
        f"m=8 sigmoid pieces, {M_MAIN} masked inputs: sign, trunc (its low "
        f"half on an n=8 walk) and sigmoid on walk, sign and sigmoid on "
        f"prefix equal sign_oracle / trunc_oracle / sigmoid_fixed_oracle on "
        f"every input; party 0's share, median of {REPEATS}: " + "; ".join(
            f"{nm} {ms:.1f} ms = {M_MAIN / ms * 1e3:,.0f} points/s"
            + (f" (the facade's eval {gate_eval_ms[nm]:.1f} ms of it)"
               if nm in gate_eval_ms else "")
            for nm, ms in gate_ms.items())
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # The kernels at these paths' shapes, each held against its plain
    # version there (its plain time at the 2^16-point check shape).
    t0 = time.perf_counter()
    kb_mic = pb.keys.for_party(0)
    sig_w = gates["sigmoid walk"][0][0].pb.keys
    trunc_low = gates["trunc walk"][0][0].pb_low.keys
    xs_mic = torch.from_numpy(xs_np[None]).to(dev)
    xs16 = torch.from_numpy(fp.points_of(x_hat, 2)[None]).to(dev)
    xs8 = torch.from_numpy(fp.points_of(x_hat, 1)[None]).to(dev)
    walk_cases = (
        (f" MIC K={K_MIC} n=128", kb_mic, xs_mic, mck),
        (f" sigmoid K={K_MIC} n=16 add16", sig_w, xs16, gck),
        (" trunc low K=2 n=8 add16", trunc_low, xs8, gck))
    for label, kb, xs_d, key in walk_cases:
        t = on_card(kb)
        k_aes = torch.from_numpy(aes_image(key[0])).to(dev)
        args = (k_aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"],
                t["cw_np1"])
        nn = kb.n_bits
        walk_eval(*args, xs_d, b=0, group=kb.group)
        ms, got = cuda_ms(lambda: walk_eval(*args, xs_d, b=0,
                                            group=kb.group), 10)
        xc = xs_d[:, :M_CHECK].contiguous()
        plain, want = cuda_ms(lambda: walk_eval_plain(
            *args, xc, b=0, group=kb.group), 1)
        same("B1", label, got[:, :M_CHECK], want)
        add_row("phase 18", "B1", "walk_eval",
                "dcf_tpu/ops/pallas_eval.py:164", ms, plain,
                kb.num_keys * walk_lookups(xs_d, 0, nn, *lam16_turns),
                M_MAIN * (nn // 8) + kb.num_keys * (
                    M_MAIN * 16 + nn * 34 + 32) + 496, label=label,
                shape=f"K={kb.num_keys} M={M_MAIN} n={nn} {kb.group}",
                plain_shape=f"M={M_CHECK}")
    prefix_cases = ((f" MIC K={K_MIC} k=17", kb_mic, xs_mic, mck, 17),
                    (f" sigmoid K={K_MIC} n=16 k=8 add16", sig_w, xs16, gck,
                     8))
    for label, kb, xs_d, key, k in prefix_cases:
        t = on_card(kb)
        k_aes = torch.from_numpy(aes_image(key[0])).to(dev)
        tops = host_frontiers(HirosePrgNp(16, key), kb, 0)

        def build(kernel: bool):
            return stacked_table(k_aes, t, tops, k, kb.group, kernel)

        build(True), build(True)
        b2ms, table = cuda_ms(lambda: build(True), 5)
        b2plain, table_p = cuda_ms(lambda: build(False), 1)
        same("B2", label, table, table_p)
        parents = kb.num_keys * ((1 << k) - (1 << HOST_LEVELS))
        add_row("phase 18", "B2", "tree_expand",
                "dcf_tpu/ops/pallas_tree.py:92", b2ms, b2plain,
                parents * 2 * LOOKUPS_BLOCK,
                kb.num_keys * (((1 << HOST_LEVELS) + (1 << k)) * 33
                               + (k - HOST_LEVELS) * 34) + 496, label=label,
                shape=f"K={kb.num_keys} levels {HOST_LEVELS}..{k - 1} "
                f"{kb.group}, a party's frontier, "
                f"{K_MIC * len(launch_depths(HOST_LEVELS, k))} launches")
        pargs = (k_aes, table, t["cw_s"], t["cw_v"], t["cw_t"],
                 t["cw_np1"])
        nn = kb.n_bits
        ms, got = cuda_ms(lambda: prefix_eval(
            *pargs, xs_d, k=k, negate=False, group=kb.group), 10)
        xc = xs_d[:, :M_CHECK].contiguous()
        plain, want = cuda_ms(lambda: prefix_eval_plain(
            *pargs, xc, k=k, negate=False, group=kb.group), 1)
        same("B3", label, got[:, :M_CHECK], want)
        add_row("phase 18", "B3", "prefix_eval",
                "dcf_tpu/ops/pallas_prefix.py:125", ms, plain,
                kb.num_keys * walk_lookups(xs_d, k, nn, *lam16_turns),
                M_MAIN * (nn // 8) + table.numel() + kb.num_keys * (
                    M_MAIN * 16 + (nn - k) * 34 + 16) + 496, label=label,
                shape=f"K={kb.num_keys} M={M_MAIN} n={nn} k={k} {kb.group}",
                plain_shape=f"M={M_CHECK}")
        del table, table_p, got, want
    mic_alphas, mic_key_betas, _ = interval_session_material(
        intervals, betas, N_BYTES)
    g_ins = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (mic_alphas, mic_key_betas, pb.keys.s0s))
    m_aes = torch.from_numpy(aes_image(mck[0])).to(dev)
    keygen_dcf16(m_aes, *g_ins, lt=True), keygen_dcf16(m_aes, *g_ins, lt=True)
    g1m_ms, out = cuda_ms(lambda: keygen_dcf16(m_aes, *g_ins, lt=True), 10)
    g1m_plain, want = cuda_ms(lambda: keygen_walk_plain(
        m_aes, *g_ins, mode=MODE_G1, lt=True), 1)
    for name, g_, w_ in zip(("cw_s", "cw_v", "cw_t", "cw_np1"), out, want):
        same("G1", f"MIC K={K_MIC} {name}", g_, w_)
    add_row("phase 18", "G1", "keygen_walk",
            "dcf_tpu/backends/device_gen.py:70", g1m_ms, g1m_plain,
            K_MIC * 128 * 2 * 2 * LOOKUPS_BLOCK,
            K_MIC * (N_BYTES + 16 + 32) + K_MIC * (128 * 34 + 16),
            label=f" MIC K={K_MIC}", shape=f"K={K_MIC} n=128 lam=16")
    log(f"phase 18: B1, B2, B3 and G1 at the protocol paths' shapes "
        f"byte-identical to their plain versions ({time.perf_counter() - t0:.1f} s)")

    # -- phase 19: DCF at lam = 32 on the card (E1, G2) ---------------------------------
    # E1 and G2 against their plain versions; then the facade at lam = 32
    # (auto = walk) on the main path's shape in XOR and add32, G2 timed,
    # the per-point full domain over two lam = 32 WalkBackends, and MIC on
    # them.  Root seeds of every key but the first have the PRG's masked
    # bit (bit 0 of byte 31, in block 1) set.
    t0 = time.perf_counter()
    wrng = np.random.default_rng(SEED + 13)
    wck = [wrng.bytes(32) for _ in range(18)]
    w_prg = HirosePrgNp(32, wck, warn=False)
    w_aes = torch.from_numpy(narrow_aes_image(wck[0], wck[17])).to(dev)

    def keys32(k_num: int, n_bytes: int, group: str, bnd: Bound):
        alphas = wrng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
        s0s = random_s0s(k_num, 32, wrng)
        s0s[1:, :, 31] |= 1
        return alphas, gen_batch(
            w_prg, alphas, wrng.integers(0, 256, (k_num, 32), dtype=np.uint8),
            s0s, bnd, group=group)

    def planted32(alphas: np.ndarray, rows: int, m: int) -> torch.Tensor:
        """uint8 [rows, m, nb] random points on the card with x = alpha
        and alpha +- 1 of every key planted in every row."""
        nb = alphas.shape[1]
        xs = wrng.integers(0, 256, (rows, m, nb), dtype=np.uint8)
        for j, a in enumerate(alphas):
            a = int.from_bytes(a.tobytes(), "big")
            for d in (-1, 0, 1):
                xs[:, 3 * j + d + 1] = np.frombuffer(
                    ((a + d) % (1 << 8 * nb)).to_bytes(nb, "big"), np.uint8)
        return torch.from_numpy(xs).to(dev)

    for n_bytes in (2, N_BYTES):
        for group in GROUPS:
            for bnd in Bound:
                alphas, kb = keys32(3, n_bytes, group, bnd)
                for rows in (1, 3):  # shared points, per-key points
                    xs_c = planted32(alphas, rows, M_CHECK)
                    for b in (0, 1):
                        t = on_card(kb.for_party(b), NARROW)
                        args = (w_aes, t["s0"], t["cw_s"], t["cw_v"],
                                t["cw_t"], t["cw_np1"], xs_c)
                        same("E1", f"n={8 * n_bytes} {group} {bnd.name} "
                             f"Kx={rows} b={b}",
                             walk32_eval(*args, b=b, group=group),
                             walk32_eval_plain(*args, b=b, group=group))
    for bnd in Bound:
        lt = bnd is Bound.LT_BETA
        ins = key_inputs(K_KEYGEN_CHECK, N_BYTES, 32)
        got = keygen_dcf32(w_aes, *ins, lt=lt)
        g2_plain, want = cuda_ms(lambda: keygen_walk_plain(
            w_aes, *ins, mode=MODE_G2, lt=lt), 1)
        if lt:
            kg_plain_g2 = g2_plain
        for name, g_, w_ in zip(("cw_s", "cw_v", "cw_t", "cw_np1"), got,
                                want):
            same("G2", f"K={K_KEYGEN_CHECK} {bnd.name} {name}", g_, w_)
    del got, want, ins
    log(f"phase 19 E1: byte-identical to its plain version at {M_CHECK} "
        "points, n=16 and 128, 4 groups x 2 bounds x 2 parties, 3 keys at "
        "shared and at per-key points, x = alpha and alpha +- 1 planted, "
        "the masked bit set in the root seeds; G2: byte-identical at "
        f"K={K_KEYGEN_CHECK}, n=128, 2 bounds, every byte of cw_s, cw_v, "
        f"cw_t and cw_np1 ({time.perf_counter() - t0:.1f} s)")

    # The main path at lam = 32 through the facade.
    t0 = time.perf_counter()
    w32_ms, w32_main = {}, {}
    xs_w = wrng.integers(0, 256, (M_MAIN, N_BYTES), dtype=np.uint8)
    for group in ("xor", "add32"):
        name = f"lam32 walk {group}"
        alphas = wrng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
        betas = wrng.integers(0, 256, (1, 32), dtype=np.uint8)
        dcf32 = Dcf(N_BYTES, 32, wck)
        if dcf32.backend_name != "walk":
            raise RuntimeError(f"Dcf(lam=32) picked {dcf32.backend_name}")
        reset_counts()
        bundle = dcf32.gen(alphas, betas, rng=wrng, group=group)
        anchors = [dcf32.eval(b, bundle, xs_w[:M_ANCHOR]) for b in (0, 1)]
        bes = [dcf32.eval_backend(b) for b in (0, 1)]
        staged = bes[0].stage(xs_w)
        ys = [bes[b].eval_staged(b, staged) for b in (0, 1)]
        torch.cuda.synchronize()
        take_counts(name, {"E1": 4, **({"G2": 1} if group == "xor" else {})})
        mism = int(bes[0].points_mismatch_count(
            ys[0], ys[1], alphas[0].tobytes(), betas[0].tobytes(), staged))
        if mism != 0:
            raise RuntimeError(f"{name}: {mism} two-party mismatches over "
                               f"{M_MAIN} points")
        host_kb = gen_batch(w_prg, alphas, betas, bundle.s0s,
                            Bound.LT_BETA, group=group)
        if host_kb.to_bytes() != bundle.to_bytes():
            raise RuntimeError(f"{name}: Dcf.gen differs from gen_batch")
        for b in (0, 1):
            want = eval_batch_np(w_prg, b, bundle.for_party(b),
                                 xs_w[:M_ANCHOR])
            if not (np.array_equal(anchors[b], want) and np.array_equal(
                    bes[b].staged_to_bytes(ys[b], M_ANCHOR), want)):
                raise RuntimeError(f"{name}: party {b} differs from the "
                                   f"numpy oracle on the first {M_ANCHOR} "
                                   "points")
            if tuple(ys[b].shape) != (1, M_MAIN, 32):
                raise RuntimeError(f"{name}: shares of shape "
                                   f"{tuple(ys[b].shape)}")
        w32_ms[group] = wall_ms(lambda: bes[0].eval_staged(0, staged),
                                REPEATS)
        w32_main[group] = (bundle.for_party(0), staged["xs"])
        log(f"phase 19 {name} (Dcf(n=128, lam=32), backend "
            f"{dcf32.backend_name}): 0 mismatches over {M_MAIN} points (two "
            f"parties, on the card); the first {M_ANCHOR} points equal the "
            f"numpy oracle; the keys equal gen_batch's; eval_staged median "
            f"{w32_ms[group]:.3f} ms = {M_MAIN / w32_ms[group] * 1e3:,.0f} "
            f"evals/s over {REPEATS} repeats [{card}]")
        del bes, staged, ys

    # E1 at the path's shape (one key, 2^20 points, n = 128, party 0),
    # beside its plain version there and B4's time in this run (phase 6).
    kb0, xs0 = w32_main["xor"]
    t = on_card(kb0, NARROW)
    e1_args = (w_aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"],
               t["cw_np1"], xs0)
    walk32_eval(*e1_args, b=0, group="xor")
    e1_ms, got = cuda_ms(lambda: walk32_eval(*e1_args, b=0, group="xor"), 10)
    e1_plain, want = cuda_ms(lambda: walk32_eval_plain(
        *e1_args, b=0, group="xor"), 1)
    same("E1", f"M={M_MAIN} n=128 xor", got, want)
    kb_a, xs_a = w32_main["add32"]
    t = on_card(kb_a, NARROW)
    a_args = (w_aes, t["s0"], t["cw_s"], t["cw_v"], t["cw_t"], t["cw_np1"],
              xs_a)
    e1_add_ms, _ = cuda_ms(lambda: walk32_eval(*a_args, b=1, group="add32"),
                           10)
    del got, want
    e1_lookups = walk_lookups(xs0, 0, 128, *narrow_turns)
    e1_bytes = M_MAIN * (N_BYTES + NARROW) + 128 * (2 * NARROW + 2) \
        + 2 * NARROW + NARROW_AES_BYTES

    # G2 at K = 2^16, n = 128, after two untimed calls.
    ins = key_inputs(K_WIDE_KEYGEN, N_BYTES, 32)
    held = keygen_dcf32(w_aes, *ins, lt=True)
    keygen_dcf32(w_aes, *ins, lt=True)
    del held
    g2_ms, out = cuda_ms(lambda: keygen_dcf32(w_aes, *ins, lt=True), 5)
    anchor("G2", f"K={K_WIDE_KEYGEN}", dict(zip(
        ("cw_s", "cw_v", "cw_t", "cw_np1"),
        host(*(o[:K_ANCHOR] for o in out)))),
        gen_batch(w_prg, *host(*(a[:K_ANCHOR] for a in ins)),
                  Bound.LT_BETA))
    # A party's level needs E0 and E17 on (s, ~s): four blocks.
    g2_lookups = K_WIDE_KEYGEN * 128 * 2 * 4 * LOOKUPS_BLOCK
    g2_bytes = K_WIDE_KEYGEN * (N_BYTES + 3 * 32) \
        + K_WIDE_KEYGEN * (128 * 66 + 32)
    del ins, out
    log(f"phase 19 E1 at one key, n=128, {M_MAIN} points: {e1_ms:.3f} ms in "
        f"XOR, {e1_add_ms:.3f} ms in add32 (party 1), B4 at lam=256 in "
        f"this run {b4_ms:.3f} ms; G2 K={K_WIDE_KEYGEN} n=128: "
        f"{g2_ms:.3f} ms, the first {K_ANCHOR} keys equal gen_batch "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")

    # The per-point full domain at lam = 32 (config 3's n = 24).
    t0 = time.perf_counter()
    fdcf32 = Dcf(N_FULL // 8, 32, wck)
    for bnd in Bound:
        gt = bnd is Bound.GT_BETA
        alpha = int(wrng.integers(8, (1 << N_FULL) - 8))
        beta = wrng.integers(0, 256, (1, 32), dtype=np.uint8)
        bundle = fdcf32.gen(np.frombuffer(
            alpha.to_bytes(N_FULL // 8, "big"), dtype=np.uint8)[None].copy(),
            beta, rng=wrng, bound=bnd)
        bes = [WalkBackend(32, wck) for _ in (0, 1)]
        for b in (0, 1):
            bes[b].put_bundle(bundle.for_party(b))
        beta = beta[0].tobytes()
        reset_counts()
        clean = full_domain_check_device(bes[0], bes[1], alpha, beta,
                                         N_FULL, gt)
        take_counts(f"full domain walk lam=32 n={N_FULL}",
                    {"E1": 2 * ((1 << N_FULL) >> 20)})
        moved = full_domain_check_device(bes[0], bes[1], alpha + 7, beta,
                                         N_FULL, gt)
        if clean != 0 or moved != 7:
            raise RuntimeError(
                f"full domain lam=32 {bnd.name}: full_domain_check_device "
                f"gave {clean} (want 0) and {moved} for alpha + 7 (want 7)")
        fd_ms = wall_ms(lambda: full_domain_check_device(
            bes[0], bes[1], alpha, beta, N_FULL, gt), 3)
        log(f"phase 19 full domain lam=32 n={N_FULL} {bnd.name}: "
            f"full_domain_check_device over two WalkBackends 0 mismatches "
            f"over 2^{N_FULL} points, 7 for alpha + 7; median {fd_ms:.3f} "
            f"ms of 3 [{card}]")
        del bes

    # MIC at lam = 32: 8 intervals from a seed, n = 128, 2^16 shared
    # points; XOR keys from G2 against the host walk's frame, and the same
    # intervals in add32 from the host walk; MicEvaluator (the pair
    # combine on the card) against mic_oracle.
    top = 1 << (8 * N_BYTES)
    cuts = sorted({int.from_bytes(wrng.bytes(16), "big") for _ in range(14)})
    ivs = [(cuts[2 * i], cuts[2 * i + 1]) for i in range(6)]
    ivs += [(cuts[13], cuts[12]), (cuts[12], top)]
    mbetas = wrng.integers(0, 256, (len(ivs), 32), dtype=np.uint8)
    xs_m = wrng.integers(0, 256, (M_CHECK, N_BYTES), dtype=np.uint8)
    edges = sorted({(x + d) % top for pq in ivs for x in pq for d in (-1, 0)})
    for j, x in enumerate(edges):
        xs_m[j] = np.frombuffer(x.to_bytes(N_BYTES, "big"), dtype=np.uint8)
    mdcf = Dcf(N_BYTES, 32, wck)
    reset_counts()
    pb32 = mdcf.mic(ivs, mbetas, rng=np.random.default_rng(SEED + 14),
                    device=True)
    torch.cuda.synchronize()
    take_counts("mic32_keygen", {"G2": 1})
    if pb32.to_bytes() != mdcf.mic(ivs, mbetas,
                                   rng=np.random.default_rng(SEED + 14),
                                   device=False).to_bytes():
        raise RuntimeError("Dcf.mic(device=True) at lam=32: the G2 "
                           "bundle's frame differs from the host walk's")
    want_mic = mic_oracle(xs_m, ivs, mbetas)
    for name, kpb in (("mic32_walk", pb32), ("mic32_add32_walk", mdcf.mic(
            ivs, mbetas, rng=np.random.default_rng(SEED + 15),
            group="add32"))):
        reset_counts()
        evs = [MicEvaluator(mdcf, kpb, b) for b in (0, 1)]
        ys = [ev.eval(xs_m) for ev in evs]
        torch.cuda.synchronize()
        take_counts(name, {"E1": 2})
        if not np.array_equal(np_group_add(ys[0], ys[1], kpb.group),
                              want_mic):
            raise RuntimeError(f"{name}: the reconstruction differs from "
                               f"mic_oracle over {M_CHECK} points")
    log(f"phase 19 MIC at lam=32: n=128, {len(ivs)} intervals (one "
        f"wraparound, one with q=2^128), {M_CHECK} shared points: "
        "Dcf.mic(device=True) (G2) frame equals the host walk's; "
        "MicEvaluator on lam=32 walk backends, XOR and add32, both parties, "
        f"equals mic_oracle ({time.perf_counter() - t0:.1f} s) [{card}]")
    add_row("phase 19", "E1", "walk32_eval",
            "dcf_tpu/backends/jax_bitsliced.py:98", e1_ms, e1_plain,
            e1_lookups, e1_bytes, shape=f"K=1 M={M_MAIN} n=128 lam=32 xor",
            add32_ms=e1_add_ms, b4_ms_this_run=b4_ms)
    add_row("phase 19", "G2", "keygen_walk",
            "dcf_tpu/backends/device_gen.py:70", g2_ms,
            kg_plain_g2, g2_lookups, g2_bytes,
            shape=f"K={K_WIDE_KEYGEN} n=128 lam=32",
            plain_shape=f"K={K_KEYGEN_CHECK}")

    # launches x (time - bound) of B1 and B6 on each path, from their
    # per-launch times at each path's shapes (phases 6 and 12).
    b1a_bound = bound(*b1a_work)[0]
    b1_row["loss_ms_by_path"] = {
        "walk": 2 * (b1a_ms - b1a_bound) + 2 * (b1_ms - b1_row["bound_ms"]),
        f"full domain walk n={N_FULL}": 32 * (b1c_ms - b1c_bound)}
    b1_row["ms_anchor_1024"], b1_row["bound_ms_anchor_1024"] = \
        b1a_ms, b1a_bound
    b6_row["loss_ms_by_path"] = {
        path: k * sum(b6_by_launch[x][0] - b6_by_launch[x][1]
                      for x in path_launches(lo, hi, y_))
        for path, (k, lo, hi, y_) in b6_spans.items()}
    # B2: a frontier build (levels 6..20) per party on the prefix path, a
    # full-domain span (levels 6..fd_end - 1) per party in
    # TreeFullDomain.check.
    b2_row["loss_ms_by_path"] = {
        "prefix": launches["B2"]["prefix"] // len(b2_cut)
        * (b2_ms - b2_row["bound_ms"]),
        f"full domain tree n={N_FULL}": 2 * (b2fd_ms - b2fd_bound)}
    # G1 in runs of 10^6 keys: config 5's chunks hold 10^6 keys, and the
    # keygen shape of phase 14 is one such run.
    g1_row = next(r for r in rows_out if r["name"].startswith("G1 "))
    g1_row["loss_ms_by_path"] = {
        f"secure ReLU config 5 K={K_RELU}": g1_ms - g1_row["bound_ms"],
        f"keygen K={K_RELU}": g1_ms - g1_row["bound_ms"]}
    log(f"launches x (ms - bound) by path [{card}]: B1 "
        + json.dumps(b1_row["loss_ms_by_path"]) + f" (the walk path's "
        f"anchors, 1024 points: {b1a_ms:.4f} ms, bound {b1a_bound:.4f}); B2 "
        + json.dumps(b2_row["loss_ms_by_path"]) + "; B6 "
        + json.dumps(b6_row["loss_ms_by_path"]) + "; G1, in runs of "
        f"{K_RELU} keys, " + json.dumps(g1_row["loss_ms_by_path"]))

    # Each path was run once between reset_counts and take_counts;
    # "launches" is the sum over those single runs.
    for row in rows_out:
        by_path = launches[row["name"].split()[0]]
        if not by_path:
            raise RuntimeError(f"{row['name']}: on no main path")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
        "interpreter started the script's main")

    print(json.dumps({"kernels": rows_out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
