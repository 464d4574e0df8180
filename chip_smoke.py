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
    walk backends in XOR and add32 against ``mic_oracle``;
20. the serving tier (``serving_phase``): ``Dcf.serve`` at serve_bench's
    shape (``dcf_tpu/cli.py:918-1130``: n = 128, lam = 16, 3 single-key
    bundles from the C++ core, max_batch 2^17, max_delay 5 ms) on
    ``prefix`` and ``walk``: a parity gate (512 points a bundle, both
    parties through the service, against the C++ core), the batch-shape
    ladder, a 5 s closed loop of 4 clients with requests of 3/8 to 1/2
    of max_batch (reconciled against the service's metrics, 0 failed),
    its evals/s, p50/p99, occupancy, ``serve_stage_s`` / ``serve_eval_s``
    and ``serve_vs_staged`` against one staged 2^17-point batch; the
    frontier cache under churn (serve_bench --skew 1.1: 8 bundles on
    ``prefix`` at k = 21, max_batch 2^10, the budget at 80% of the
    party-0 working set, a cached and a cold leg interleaved in 3
    segments each): hit rate >= 0.5, ``cached_vs_cold`` printed;
    ``device_image_bytes`` plus the frontier cache against
    ``torch.cuda.memory_allocated``'s delta of one staging (walk,
    prefix), within 512 B a tensor; a lam = 16 key-factory pool (G1) and
    a claimed key served, and a claim from an empty pool minted by one
    G1 launch; durable keys restored by a new service, byte
    for byte; lam = 256 ``hybrid`` with ``prefix_levels=20`` (B5a + B5b
    + W1 through the frontier cache), ``keylanes`` with 1024 keys (B8),
    ``attach_pir`` over 2^20 32-byte records (B6 + P1) and the
    ``GateServer``'s sign and truncation at gate_bench's shape (2^16
    masked inputs) against their oracles; paths ``serve_prefix``,
    ``serve_walk``, ``serve_keyfactory``, ``serve_keyfactory_miss``,
    ``serve_hybrid_prefix``,
    ``serve_keylanes``, ``serve_pir`` and ``serve_gates_walk`` in
    ``launches_by_path``, each one ``pump()``-driven run;
21. the network edge and the pod router (``edge_pod_phase``).  (a) The
    edge at edge_bench's shape (``dcf_tpu/cli.py:1440-1500``: ``Dcf(16,
    16)``, 3 C++-core bundles, max_batch 2^14, requests of 3/8 to 1/2 of
    it, 8 connections, tenants gold (CRITICAL), silver (NORMAL) and
    bronze (BATCH at 2^14 points/s, burst 2^13)) on ``prefix`` and
    ``walk``: the two-party reconstruction of 256 points a bundle over
    the wire against the C++ core; interleaved closed loops in process
    and over the wire on the same service (2 segments of each), their
    evals/s, p50/p99 and ``wire_vs_inprocess`` (reported beside
    ``dcf_tpu``'s 0.8 gate, not gated); a bronze burst whose every
    refusal carries ``retry_after_s``; on ``prefix`` a TLS leg with
    parity and an open loop at half the wire leg's request rate,
    reconciled against the service's metrics.  (b) The pod at
    pod_bench's shape: 3 shards (``prefix``, max_batch 2^10) behind their
    own ``EdgeServer``s on the card, a ``DcfRouter`` with one replica,
    keys registered through it; routed two-party shares through the
    router's door against the C++ core; a closed loop through the door
    beside one solo shard (``pod_vs_solo``, not gated); co-evaluation
    (``set_mesh`` over the 3 shards, 2^10-point batches) equal to
    route-mode; and a failover loop in which one shard's ``EdgeServer``
    closes: its CRITICAL traffic is served by the replica and served +
    refused typed = sent.  Every leg without an injected fault reads 0
    on ``edge_connection_errors_total``, ``edge_wire_errors_total``,
    ``router_mesh_degraded_total`` and each shard's
    ``router_suspected_total``.  Paths ``edge_prefix``, ``edge_walk``,
    ``pod_prefix`` and ``pod_mesh`` in ``launches_by_path``, each one
    ``pump()``-driven run;
22. the pod's control plane and the lam >= 48 handoff
    (``control_plane_phase``).  (a) Membership, ``pod_bench --churn``'s
    scenario in process: 4 ``prefix`` shards behind their own
    ``EdgeServer``s, a ``DcfRouter`` (one replica, prober every 0.25 s),
    a started ``MembershipController`` (eject grace 1.0 s, cut from
    ``dcf_tpu``'s 3.0 for time; drain grace 0.5 s; min_hosts 2), 12 keys
    registered through the router, half of them also durable in
    ``KeyStore``s; 3 clients of mixed CRITICAL / NORMAL requests
    throughout.  One shard's edge closes: the eject commits after the
    grace, and the DIGEST verb shows its keys on their new placement; the
    shard comes back empty behind a new edge and ``join`` warms it before
    admitting it; a second shard drains.  Gates: served + refused typed =
    sent, 0 mismatches against the C++ core, zero lost keys, zero
    generation regressions, strictly increasing epochs, a doctored
    stale-epoch frame refused ``E_EPOCH``.  (b) Capacity, ``pod_bench
    --surge``'s scenario in process: 3 ``prefix`` shards and a standby
    (admission bound 4096 points), a ``CapacityController`` configured as
    ``dcf_tpu/cli.py:4666-4672``, a 2 s calibrating closed loop, then
    ``open_loop_ramp`` with Zipf skew 1.1 at 1.5x the calibrated rate for
    3 s, 2.5x for 6 s and 0 for 2 s, the controller pumped on the main
    thread with a CRITICAL heartbeat: scale-out within 30 s, scale-in back
    to 3 hosts, 0 CRITICAL sheds, every key two-party equal after the
    shrink, and a forced oscillation through ``capacity.decide`` with the
    ring epoch unmoved.  (c) ``session_churn`` for 3 s over a lam = 16
    pool refilled by G1 on a started ``walk`` service, every session's
    shares held to its function.  (d) A lam = 256 ``hybrid`` service
    (``prefix_levels=20``) whose pool B7a + W2 refill: a claimed key
    stages from its device planes (the registry's
    ``stagings_from_planes``), byte-equal to the same bundle staged from
    the host and to the C++ core; register-to-first-share with and
    without the planes.  On every leg the fault counters read 0
    (``edge_connection_errors_total``, ``edge_wire_errors_total``,
    ``router_mesh_degraded_total``, ``membership_change_failures_total``,
    ``capacity_scale_failures_total``, ``serve_batch_failures_total``,
    ``serve_retries_total``, and each shard's ``router_suspected_total``
    but the victim's; under the surge's deliberate overload a shard's
    suspicions must each be one of its own full-queue refusals).  Paths
    ``membership_prefix``, ``capacity_prefix``, ``churn_keyfactory`` and
    ``serve_handoff`` in ``launches_by_path``, each one run with no other
    traffic;
23. the bench CLI and the entry point (``cli_phase``): ``cli.main(argv)``
    in process, stdout captured, for ``baseline`` (8 lines, config 5 at
    2^18 keys x 1024 points), ``dcf_batch_eval --backend walk --points
    1048576 --check``, ``dcf_large_lambda --backend hybrid --lam 256
    --points 1048576 --prefix-levels 20 --check``, ``keygen_bench``,
    ``pir_bench --n-bits 24``, ``mic_bench --backend walk``,
    ``gate_bench --backend walk``, ``serve_bench --backend prefix --skew
    1.1`` and ``serve_bench --backend prefix --edge`` (``dcf_tpu``
    refuses the two flags together), ``edge_bench --backend prefix``,
    ``chaos_bench --backend walk``, ``chaos_bench --backend walk
    --crash-restart --keyfactory`` and ``keyfactory_bench``, at the
    reference's widths with ``--duration`` and ``--reps`` cut as
    ``CLI_RUNS`` lists.  Each must exit 0 and print its lines (its own
    parity gates passed), each line its bench's keys, a positive value
    and the card's name; the one exception is an exit whose only failure
    is one of the two throughput gates ``CLI_REPORTED`` names, which is
    logged.  The ``baseline`` flagship line (config 2, n = 128) lies
    within 10% of phase 17's ``bench_torch`` line.  One subprocess runs
    ``python -m dcf_tpu_torch.cli dcf --backend walk``; ``entry()``'s
    ``fn(*example_args)`` equals B1's plain version byte for byte.  Paths
    ``cli_<name>`` in ``launches_by_path``: a run of fixed repetitions
    makes exactly the launches ``CLI_RUNS`` gives it, a closed-loop
    serving leg at least one launch of each kernel it names (its count
    follows its duration); ``cli_entry`` exactly one B1 launch;
24. the multi-process pod (``pod_phase``): ``python -m dcf_tpu_torch.cli
    pod_bench --device cuda`` as ``POD_GROUPS`` lists it, each shard a
    ``serve_host`` process of its own on the card: the plain scenario on
    ``prefix`` (B2 + B3 in the shards, G1 in the parent) and on the
    default ``--backend`` (``walk`` on the card, B1; its line must name
    ``walk``), ``--partition``, ``--flap``, ``--churn``, ``--surge`` and
    ``--mesh``, at ``dcf_tpu``'s widths with leg lengths cut.  Each run
    must exit 0 with one line (its own parity, tally, key-loss,
    generation and epoch gates passed), the card's name on it; the one
    exception is an exit whose only failure is one of the throughput
    gates ``POD_REPORTED`` names, which is logged.  Each shard (pid from
    its ready file) holds the card's device file open while it serves,
    each shard's final snapshot counts batches (its requests, points and
    mean occupancy are logged), and no shard outlives its run; a run's
    directory goes whatever its verdict.  The shards' launches happen in their own
    processes, outside this script's counters: phase 24 adds no path to
    ``launches_by_path``.  Each run's line is logged, and its output
    written to ``chiprun_out/phase24_pod.log``;
25. the multi-device tier (``mesh_phase``, ``dcf_tpu_torch.parallel``).
    (a) ``make_mesh()`` on the card (one position on one H100) and every
    sharded class at the main paths' widths (n = 128, 2^20 points): the
    walk at lam = 16 (B1) and 32 (E1) with 4 keys, prefix (B2 + B3, k =
    21), the hybrid at lam = 256 with 2 keys from the root (B4 + W1) and
    with ``prefix_levels=20`` (B5a + B5b + W1), config 5's shape on
    ``ShardedKeyLanesBackend`` (2^18 G1 keys x 1024 points, B8, the
    moved-alpha control >= 1), the full domain at n = 24 (B2 + B2f) and
    DPF EvalAll at n = 24, K = 4 (B6); both parties' shares equal to the
    unsharded backends' in the same call, compared block by block on the
    card, 0 two-party mismatches, the full-domain counts 0 clean and the
    unsharded count with a flipped beta bit.  (b) The same at the same
    widths on virtual meshes over ``cuda:0``, shaped by path as
    ``dcf_tpu`` does (``MESH_VIRTUAL``: prefix 1 x 4, the keyed walks and
    keylanes 4 x 1, the hybrids and both full-domain trees 2 x 2).  Each
    (a) and (b) run is a path of ``launches_by_path`` (``mesh <path>
    KxP``), its launches exact; each logs one ``eval_staged`` (or check)
    wall beside the unsharded one.  (c) The pod mesh:
    ``MeshLargeLambdaBackend`` at lam = 256 over 2^20 points in two
    processes on the card over ``gloo`` (2^19 points each) and in one
    process over ``nccl`` (NCCL refuses two ranks on one card), each
    slice's bytes equal to the unsharded result's by digest, the
    group-wide count 0 in every process.  (d) The CLI: ``dcf_batch_eval
    --backend sharded-pallas --check``, ``secure_relu --backend
    sharded-pallas --mesh 1x1``, ``full_domain --backend tree --mesh
    1x1``, ``dcf_large_lambda --lam 256 --prefix-levels 20 --mesh 1x1
    --check``, each exiting 0 with its gates held and its line naming the
    card (paths ``cli_mesh_<name>``); ``--mesh 2x2`` on one card exits
    non-zero with "requested 4 devices, have 1"; each run's launches
    exact.  Last, alone, ``entry.dryrun_multichip(4)`` exits 0: a
    subprocess runs every sharded class on a 2 x 2 mesh over ``cuda:0``
    (and a 1 x 4 one for prefix), the kernels themselves.

Launches are counted per path: the counts are set to 0 just before one
run of a path and read just after it, before any timed repeat, and held
against the number that run must make (phases 9-11, 16, 18-23 and 25; phase 4's run
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
import warnings

import numpy as np

SEED = 2026
N_BYTES = 16  # n = 128 levels
M_CHECK = 1 << 16  # points per kernel-vs-plain check
M_MAIN = 1 << 20  # points of the main path
M_ANCHOR = 1024  # points held against the numpy oracle
HOST_LEVELS = 6  # k0 of the frontier
LAM_WIDE = 256  # BASELINE.json config 4
K_CHECK = 16  # hybrid frontier depth of the kernel-vs-plain checks
K_HYBRID = 20  # hybrid frontier depth of the main path (the clamp)
K_SWEEP = range(16, 25)  # hybrid frontier depths timed in phase 7
LAM_CRATE = 16384  # the reference crate's benches/dcf_large_lambda.rs
M_CRATE = 10_000
M_CRATE_ANCHOR = 64
REPEATS = 5  # timed repeats per backend (10 before phase 25)
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
# B8 with a partial group and points that do not divide among a block's
# 16 warps.  200 points leave 8 over, as 1000 would, and spare about 22 s
# of B8's plain version, whose time grows with keys x points here.
K_B8_TAIL, M_B8_TAIL = 4099, 200
K_B8_DEEP, M_B8_DEEP, N_B8_DEEP = 100, 40, 256  # B8 past its staged levels
K_MIC = 16  # the 2m bound keys of an 8-interval MIC, packed on the K axis
K_CAP = 65537  # B1 beyond the 65,535-block grid axis ...
M_CAP = 64  # ... at these points
SERVE_MAX_BATCH = 1 << 17  # serve_bench's defaults (dcf_tpu/cli.py)
SERVE_DELAY_MS = 5.0
SERVE_BUNDLES = 3
SERVE_DURATION_S = 5.0  # each closed loop (10 s before phase 25)
SERVE_CONCURRENCY = 4
SERVE_PARITY = 512  # points per bundle in the parity gate
SKEW = 1.1  # serve_bench --skew 1.1: Zipf key choice ...
SKEW_BUNDLES = 8
SKEW_MAX_BATCH = 1 << 10
SKEW_SEGMENTS = 3  # ... cached and cold legs interleaved, 3 segments each
SKEW_SEGMENT_S = 2.0
SKEW_PARITY = 128
GATE_INPUTS = 1 << 16  # masked inputs of the served gates
PIR_SERVE_BITS = 20  # 2^20 32-byte records behind attach_pir
K_KEYLANES_SERVE = 1024
M_SERVE_SMALL = 4096  # points a party of the hybrid case
EDGE_MAX_BATCH = 1 << 14  # edge_bench's defaults (dcf_tpu/cli.py)
EDGE_CONNS = 8
EDGE_PARITY = 256  # points per bundle in the wire parity gates
EDGE_SEGMENTS = 2  # in-process and wire closed loops, interleaved ...
EDGE_SEGMENT_S = 1.5  # ... this long each
EDGE_OPEN_S = 2.0  # the open-loop leg
WIRE_GATE = 0.8  # dcf_tpu's edge_bench gate on wire_vs_inprocess
POD_SHARDS = 3  # pod_bench's shape
POD_MAX_BATCH = 1 << 10
POD_LOOP_S = 3.0  # each closed loop, pod and solo
POD_FAILOVER_S = (1.0, 2.0)  # the failover loop: before and after the kill
MEMBER_SHARDS = 4  # phase 22 (a): pod_bench --churn's pod, in process
MEMBER_KEYS = 12  # half of them durable in KeyStores
PROBE_INTERVAL_S = 0.25  # the router's prober (dcf_tpu/cli.py:6015)
EJECT_GRACE_S = 1.0  # dcf_tpu's default is 3.0: cut for time
DRAIN_GRACE_S = 0.5
CAP_SHARDS = 3  # phase 22 (b): pod_bench --surge's pod, plus one standby
CAP_KEYS = 8
CAP_QUEUE_POINTS = 4096  # the surge's small admission bound (cli.py:4538)
CAP_REACTION_S = 30.0  # dcf_tpu's scale-out reaction bound
CHURN_POOL = 64  # phase 22 (c): the lam = 16 pool's depth
CHURN_S = 3.0
CHURN_CONCURRENCY = 4


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


def serving_phase(card: str, reset_counts, take_counts) -> dict:
    """Phase 20: the serving tier (``dcf_tpu_torch.serve``) on the card.

    ``reset_counts`` / ``take_counts(path, want)`` are main's launch
    counters: each ``serve_*`` path is one deterministic run driven by
    ``pump()`` (or, for the gate server, one request a component on
    started services) between them.  Every check raises.  Returns the
    numbers the phase logged."""
    import shutil
    import tempfile

    import torch

    from dcf_tpu_torch import Bound, Dcf
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.ops._launch import launch_depths
    from dcf_tpu_torch.ops.hybrid_prefix import frontier_launches
    from dcf_tpu_torch.protocols import fixedpoint as fp
    from dcf_tpu_torch.protocols import mic_oracle
    from dcf_tpu_torch.serve import PoolSpec
    from dcf_tpu_torch.serve.batcher import next_pow2
    from dcf_tpu_torch.serve.loadgen import (
        closed_loop, reconcile_against_rollup)
    from dcf_tpu_torch.serve.registry import device_image_bytes
    from dcf_tpu_torch.workloads import GateServer
    from dcf_tpu_torch.workloads.pir import PirDatabase, pir_reconstruct

    srng = np.random.default_rng(SEED + 20)
    ck = [srng.bytes(32), srng.bytes(32)]
    native = NativeDcf(16, ck)
    out = {}

    def gen_keys(n: int) -> dict:
        """serve_bench's bundles: single keys from the C++ core."""
        keys = {}
        for i in range(n):
            alphas = srng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
            betas = srng.integers(0, 256, (1, 16), dtype=np.uint8)
            keys[f"key-{i}"] = native.gen_batch(
                alphas, betas, random_s0s(1, 16, srng), Bound.LT_BETA)
        return keys

    def both(svc, key_id, xs):
        futs = [svc.submit(key_id, xs, b=b) for b in (0, 1)]
        svc.pump()
        return [f.result(60) for f in futs]

    def parity(svc, keys, points, path=None, want=None) -> None:
        """Every bundle, both parties through the service, the XOR
        reconstruction against the C++ core; the first bundle's run is
        the counted one when ``path`` is given."""
        xs = srng.integers(0, 256, (points, N_BYTES), dtype=np.uint8)
        bad = 0
        for j, (name, kb) in enumerate(keys.items()):
            if path and j == 0:
                reset_counts()
            y0, y1 = both(svc, name, xs)
            if path and j == 0:
                torch.cuda.synchronize()
                take_counts(path, want)
            ref = native.eval(0, kb, xs) ^ native.eval(1, kb, xs)
            bad += int(((y0 ^ y1) != ref).any(-1).sum())
        if bad:
            raise RuntimeError(f"serving parity: {bad} of {len(keys)} x "
                               f"{points} reconstructions differ from the "
                               "C++ core")

    def hist_mean(snap, name):
        return snap[f"{name}_sum"] / max(snap[f"{name}_count"], 1)

    def occupancy_mean(snap):
        return hist_mean(snap, "serve_batch_occupancy")

    b2_party = len(launch_depths(HOST_LEVELS, 21))  # the prefix depth

    # Case 1: closed loop at serve_bench's shape on prefix and walk.
    min_req, max_req = SERVE_MAX_BATCH * 3 // 8, SERVE_MAX_BATCH // 2
    for backend, want in (
            ("prefix", {"B2": 2 * b2_party, "B3": 2}),
            ("walk", {"B1": 2})):
        t0 = time.perf_counter()
        dcf = Dcf(N_BYTES, 16, ck, backend=backend)
        svc = dcf.serve(max_batch=SERVE_MAX_BATCH,
                        max_delay_ms=SERVE_DELAY_MS)
        keys = gen_keys(SERVE_BUNDLES)
        for name, kb in keys.items():
            svc.register_key(name, kb)
        parity(svc, keys, SERVE_PARITY, f"serve_{backend}", want)
        xs_warm = srng.integers(0, 256, (SERVE_MAX_BATCH, N_BYTES),
                                dtype=np.uint8)
        m = next_pow2(min_req)
        while m <= SERVE_MAX_BATCH:  # the batch-shape ladder
            svc.submit("key-0", xs_warm[:m])
            svc.pump()
            m *= 2
        before = svc.metrics_snapshot()
        with svc:
            res = closed_loop(svc, sorted(keys), duration_s=SERVE_DURATION_S,
                              concurrency=SERVE_CONCURRENCY,
                              min_points=min_req, max_points=max_req,
                              seed=SEED)
        snap = svc.metrics_snapshot()
        rec = reconcile_against_rollup(res, before, snap)
        if res.requests_failed or not rec["reconciled"] or not res.points_ok:
            raise RuntimeError(
                f"serving {backend}: {res.requests_failed} failed requests, "
                f"{res.requests_ok} ok, reconciliation {rec}")
        # The staged path of the same backend: one max_batch batch.
        be = dcf.new_eval_backend()
        be.put_bundle(keys["key-0"].for_party(0))
        staged = be.stage(xs_warm)
        be.eval_staged(0, staged)
        staged_ms, _ = cuda_ms(lambda: be.eval_staged(0, staged), REPEATS)
        staged_rate = SERVE_MAX_BATCH / staged_ms * 1e3
        q = res.latency_quantiles()
        d_snap = {k: snap[k] - before.get(k, 0) for k in (
            "serve_stage_s_sum", "serve_stage_s_count", "serve_eval_s_sum",
            "serve_eval_s_count", "serve_batch_occupancy_sum",
            "serve_batch_occupancy_count", "serve_batches_total")}
        out[f"closed loop {backend}"] = row = {
            "evals_per_s": res.throughput, "requests_ok": res.requests_ok,
            "requests_failed": res.requests_failed,
            "requests_shed": res.requests_shed,
            "p50_ms": q["p50_s"] * 1e3, "p99_ms": q["p99_s"] * 1e3,
            "occupancy_mean": d_snap["serve_batch_occupancy_sum"]
            / max(d_snap["serve_batch_occupancy_count"], 1),
            "batches": d_snap["serve_batches_total"],
            "stage_ms_mean": d_snap["serve_stage_s_sum"]
            / max(d_snap["serve_stage_s_count"], 1) * 1e3,
            "eval_ms_mean": d_snap["serve_eval_s_sum"]
            / max(d_snap["serve_eval_s_count"], 1) * 1e3,
            "staged_ms": staged_ms, "staged_evals_per_s": staged_rate,
            "serve_vs_staged": res.throughput / staged_rate,
            "reconciled": rec["reconciled"]}
        for h in ("serve_stage_s", "serve_eval_s"):
            # The run's histogram: cumulative counts at or below each
            # bound (seconds), this loop's batches only.
            row[h] = dict(zip(
                [str(x) for x in snap[f"{h}_bounds"]] + ["inf"],
                [n - n0 for n, n0 in zip(snap[f"{h}_buckets"],
                                         before[f"{h}_buckets"])]))
        log(f"phase 20 closed loop {backend}: Dcf(16, 16), "
            f"serve(max_batch={SERVE_MAX_BATCH}, max_delay_ms="
            f"{SERVE_DELAY_MS}), {SERVE_BUNDLES} C++-core bundles, parity "
            f"{SERVE_PARITY} points a bundle, both parties, 0 mismatches "
            f"against the C++ core; {SERVE_CONCURRENCY} clients x "
            f"{SERVE_DURATION_S} s, requests of {min_req}-{max_req} points: "
            f"{res.throughput:,.1f} evals/s, {res.requests_ok} requests ok, "
            f"0 failed, {res.requests_shed} shed, p50 {row['p50_ms']:.2f} "
            f"ms, p99 {row['p99_ms']:.2f} ms, {row['batches']} batches, "
            f"mean occupancy {row['occupancy_mean']:.3f}, mean "
            f"serve_stage_s {row['stage_ms_mean']:.2f} ms, mean "
            f"serve_eval_s {row['eval_ms_mean']:.2f} ms (cumulative "
            f"histograms, s: stage {row['serve_stage_s']}, eval "
            f"{row['serve_eval_s']}); staged path "
            f"(eval_staged of one {SERVE_MAX_BATCH}-point batch, CUDA "
            f"events) {staged_ms:.3f} ms = {staged_rate:,.0f} evals/s, "
            f"serve_vs_staged {row['serve_vs_staged']:.3f}; reconciled "
            f"against the metrics ({time.perf_counter() - t0:.1f} s) "
            f"[{card}]")
        del svc, be, staged, dcf

    # Case 2: the frontier cache under churn (serve_bench --skew 1.1).
    t0 = time.perf_counter()
    dcf = Dcf(N_BYTES, 16, ck, backend="prefix")
    keys = gen_keys(SKEW_BUNDLES)
    legs = {}
    for leg, cache in (("cached", True), ("cold", False)):
        svc = dcf.serve(max_batch=SKEW_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS,
                        frontier_cache=cache)
        for name, kb in keys.items():
            svc.register_key(name, kb)
        parity(svc, keys, SKEW_PARITY)
        legs[leg] = svc
    res_img = legs["cached"].registry.resident("key-0", 0)
    fc = legs["cached"].frontier_cache
    per_frontier = fc.total_bytes() // max(len(fc.lru_entries()), 1)
    budget = max(1, (device_image_bytes(res_img) + per_frontier)
                 * SKEW_BUNDLES * 4 // 5)
    for svc in legs.values():
        svc.registry.device_bytes_budget = budget
    runs = {"cached": [], "cold": []}
    snaps0 = {leg: svc.metrics_snapshot() for leg, svc in legs.items()}
    lo, hi = SKEW_MAX_BATCH * 3 // 8, SKEW_MAX_BATCH // 2
    with legs["cached"], legs["cold"]:
        for i in range(2 * SKEW_SEGMENTS):
            leg = "cached" if i % 2 == 0 else "cold"
            runs[leg].append(closed_loop(
                legs[leg], sorted(keys), duration_s=SKEW_SEGMENT_S,
                concurrency=SERVE_CONCURRENCY, min_points=lo, max_points=hi,
                seed=SEED + i // 2, skew=SKEW))
    rate = {leg: sum(r.points_ok for r in rs) / sum(r.duration_s
                                                     for r in rs)
            for leg, rs in runs.items()}
    failed = sum(r.requests_failed for rs in runs.values() for r in rs)
    snap = legs["cached"].metrics_snapshot()
    hits = snap["serve_frontier_hits_total"] \
        - snaps0["cached"]["serve_frontier_hits_total"]
    misses = snap["serve_frontier_misses_total"] \
        - snaps0["cached"]["serve_frontier_misses_total"]
    hit_rate = hits / max(hits + misses, 1)
    cold_stagings = legs["cold"].metrics_snapshot()[
        "serve_key_stagings_total"] - snaps0["cold"][
        "serve_key_stagings_total"]
    out["frontier churn"] = {
        "hit_rate": hit_rate, "hits": hits, "misses": misses,
        "cached_evals_per_s": rate["cached"],
        "cold_evals_per_s": rate["cold"],
        "cached_vs_cold": rate["cached"] / rate["cold"],
        "budget_bytes": budget,
        "evictions": snap["serve_evictions_total"],
        "frontier_evictions": snap["serve_frontier_evictions_total"],
        "cold_stagings": cold_stagings}
    if failed or hit_rate < 0.5:
        raise RuntimeError(f"frontier churn: {failed} failed requests, hit "
                           f"rate {hit_rate:.3f} (want >= 0.5)")
    log(f"phase 20 frontier cache under churn (serve_bench --skew {SKEW}): "
        f"prefix at k=21, {SKEW_BUNDLES} bundles, max_batch "
        f"{SKEW_MAX_BATCH}, budget {budget:,} B (80% of the party-0 working "
        f"set), cached and cold legs interleaved, {SKEW_SEGMENTS} x "
        f"{SKEW_SEGMENT_S} s each: hit rate {hit_rate:.3f} ({hits} hits, "
        f"{misses} misses), cached {rate['cached']:,.0f} evals/s, cold "
        f"{rate['cold']:,.0f}, cached_vs_cold "
        f"{rate['cached'] / rate['cold']:.3f} (not gated: a timing ratio); "
        f"{snap['serve_evictions_total']} residency and "
        f"{snap['serve_frontier_evictions_total']} frontier evictions, "
        f"cold leg {cold_stagings} stagings, 0 failed "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")
    del legs, svc, res_img, fc, dcf

    # Case 3: the registry's byte count against the allocator's.
    t0 = time.perf_counter()
    kb = gen_keys(1)["key-0"]
    img = {}
    for backend in ("walk", "prefix"):
        svc = Dcf(N_BYTES, 16, ck, backend=backend).serve()
        svc.register_key("k", kb)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        be = svc.registry.resident("k", 0)
        torch.cuda.synchronize()
        delta = torch.cuda.memory_allocated() - a0
        tensors = [be.aes, *be._bundle_dev.values()]
        if svc.frontier_cache is not None:
            tensors += [e.tables for e in svc.frontier_cache._entries.values()]
        counted = device_image_bytes(be) + svc.frontier_cache.total_bytes()
        if sum(t.nbytes for t in tensors) != counted or not (
                counted <= delta <= counted + 512 * len(tensors)):
            raise RuntimeError(
                f"device_image_bytes {backend}: counted {counted} B, the "
                f"staging allocated {delta} B over {len(tensors)} tensors")
        img[backend] = (counted, delta, len(tensors))
        del svc, be
    out["image bytes"] = img
    log("phase 20 device_image_bytes (+ the frontier cache's bytes) against "
        "torch.cuda.memory_allocated's delta of one staging, within 512 B a "
        "tensor: " + "; ".join(f"{k} {c:,} B counted, {d:,} B allocated, "
                               f"{n} tensors" for k, (c, d, n) in img.items())
        + f" ({time.perf_counter() - t0:.1f} s)")

    # Case 4: the key factory mints on the card (G1), a claim serves.
    t0 = time.perf_counter()
    svc = Dcf(N_BYTES, 16, ck, backend="walk").serve()
    alphas = srng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
    betas = srng.integers(0, 256, (1, 16), dtype=np.uint8)
    svc.add_pool(PoolSpec(name="relu", alphas=alphas, betas=betas,
                          target_depth=8, low_water=2, refill_batch=8))
    xs = srng.integers(0, 256, (M_ANCHOR, N_BYTES), dtype=np.uint8)
    xs[0] = alphas[0]
    reset_counts()
    report = svc.keyfactory.pump()
    kb = svc.register_key("sess", pool="relu")
    y0, y1 = both(svc, "sess", xs)
    torch.cuda.synchronize()
    take_counts("serve_keyfactory", {"G1": 1, "B1": 2})
    inside = np.array([x.tobytes() < alphas[0].tobytes() for x in xs])
    want = np.where(inside[:, None], betas, 0).astype(np.uint8)
    ref = native.eval(0, kb, xs) ^ native.eval(1, kb, xs)
    if report.minted != {"relu": 8} or not np.array_equal((y0 ^ y1)[0], want) \
            or not np.array_equal(y0 ^ y1, ref):
        raise RuntimeError(f"key factory: minted {report.minted}; the "
                           "claimed key does not reconstruct its function")
    # An empty pool's claim mints synchronously, on the card too.
    svc.add_pool(PoolSpec(name="miss", alphas=alphas, betas=betas,
                          target_depth=8, low_water=0, refill_batch=8))
    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        kb = svc.register_key("miss", pool="miss")
    y0, y1 = both(svc, "miss", xs)
    torch.cuda.synchronize()
    take_counts("serve_keyfactory_miss", {"G1": 1, "B1": 2})
    ref = native.eval(0, kb, xs) ^ native.eval(1, kb, xs)
    if svc.metrics_snapshot()["keyfactory_pool_misses_total"] != 1 \
            or not caught or not np.array_equal((y0 ^ y1)[0], want) \
            or not np.array_equal(y0 ^ y1, ref):
        raise RuntimeError("key factory: the empty pool's synchronous "
                           "mint does not reconstruct its function")
    log(f"phase 20 key factory: a lam=16 pool refilled by G1 (8 sessions "
        f"in one launch), one claim registered and served to both parties "
        f"at {M_ANCHOR} points, and a claim from an empty pool minted by "
        f"one G1 launch: equal to the pool's function and to the C++ "
        f"core ({time.perf_counter() - t0:.1f} s)")
    del svc

    # Case 5: durable keys survive the service.
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="dcf-store-")
    try:
        dcf = Dcf(N_BYTES, 16, ck, backend="prefix")
        kb = gen_keys(1)["key-0"]
        top = 1 << 8 * N_BYTES
        ivs = [(top // 5, top // 3), (5, top - 1)]
        mbetas = srng.integers(0, 256, (2, 16), dtype=np.uint8)
        pb = dcf.mic(ivs, mbetas, rng=srng, device=True)
        xs = srng.integers(0, 256, (M_ANCHOR, N_BYTES), dtype=np.uint8)
        first = dcf.serve(store_dir=store)
        first.register_key("k", kb, durable=True)
        first.register_key("m", pb, durable=True)
        before = {k: both(first, k, xs) for k in ("k", "m")}
        first.close()
        second = Dcf(N_BYTES, 16, ck, backend="prefix").serve(
            store_dir=store)
        report = second.restore_keys()
        after = {k: both(second, k, xs) for k in ("k", "m")}
        if report.restored != {"k": 1, "m": 2} or report.quarantined \
                or any(not np.array_equal(a, b) for k in before
                       for a, b in zip(before[k], after[k])) \
                or not np.array_equal(before["m"][0] ^ before["m"][1],
                                      mic_oracle(xs, ivs, mbetas)):
            raise RuntimeError(f"durable restore: {report}; the restored "
                               "service's shares differ from the first's")
        del first, second
    finally:
        shutil.rmtree(store, ignore_errors=True)
    log(f"phase 20 durability: a plain and a MIC key registered durable on "
        f"prefix, the service closed, a new one restored them "
        f"({report.restored}) and served both parties' shares byte for "
        f"byte equal to the first's ({time.perf_counter() - t0:.1f} s)")

    # Case 6a: lam = 256, hybrid with prefix_levels=20 (B5a + B5b + W1).
    t0 = time.perf_counter()
    hck = [srng.bytes(32) for _ in range(32)]
    hdcf = Dcf(N_BYTES, LAM_WIDE, hck, backend="hybrid",
               backend_opts={"prefix_levels": K_HYBRID})
    hkb = hdcf.gen(srng.integers(0, 256, (1, N_BYTES), dtype=np.uint8),
                   srng.integers(0, 256, (1, LAM_WIDE), dtype=np.uint8),
                   rng=srng)
    svc = hdcf.serve(max_batch=M_SERVE_SMALL)
    svc.register_key("h", hkb)
    xs = srng.integers(0, 256, (M_SERVE_SMALL, N_BYTES), dtype=np.uint8)
    reset_counts()
    y0, y1 = both(svc, "h", xs)
    torch.cuda.synchronize()
    b5a_party = 1 + len(frontier_launches(K_HYBRID)[1])
    take_counts("serve_hybrid_prefix",
                {"B5a": 2 * b5a_party, "B5b": 2, "W1": 2})
    hnative = NativeDcf(LAM_WIDE, hck)
    snap = svc.metrics_snapshot()
    if not (np.array_equal(y0, hnative.eval(0, hkb, xs))
            and np.array_equal(y1, hnative.eval(1, hkb, xs))) \
            or snap["serve_frontier_misses_total"] != 2 \
            or snap["serve_frontier_hits_total"] != 2:
        raise RuntimeError("served hybrid: shares differ from the C++ core, "
                           "or the frontier cache was not consulted")
    log(f"phase 20 hybrid lam={LAM_WIDE} prefix_levels={K_HYBRID}: "
        f"{M_SERVE_SMALL} points a party through the service equal the C++ "
        f"core; the frontier cache built both parties' frontiers at stage "
        f"time (2 misses) and the evals gathered from it (2 hits) "
        f"({time.perf_counter() - t0:.1f} s)")
    del svc, hdcf

    # Case 6b: keylanes, one two-party image of 1024 keys (B8).
    t0 = time.perf_counter()
    kdcf = Dcf(N_BYTES, 16, ck, backend="keylanes")
    ka = srng.integers(0, 256, (K_KEYLANES_SERVE, N_BYTES), dtype=np.uint8)
    kbeta = srng.integers(0, 256, (K_KEYLANES_SERVE, 16), dtype=np.uint8)
    kkb = kdcf.gen(ka, kbeta, rng=srng)
    svc = kdcf.serve(max_batch=M_RELU)
    svc.register_key("relu", kkb)
    xs = srng.integers(0, 256, (M_RELU, N_BYTES), dtype=np.uint8)
    xs[:3] = ka[:3]
    reset_counts()
    y0, y1 = both(svc, "relu", xs)
    torch.cuda.synchronize()
    take_counts("serve_keylanes", {"B8": 2})
    lt = np.zeros((K_KEYLANES_SERVE, M_RELU), dtype=bool)
    eq = np.ones_like(lt)
    for j in range(N_BYTES):
        xj, aj = xs[None, :, j], ka[:, j, None]
        lt |= eq & (xj < aj)
        eq &= xj == aj
    want = np.where(lt[..., None], kbeta[:, None, :], 0).astype(np.uint8)
    bad = int(((y0 ^ y1) != want).any(-1).sum())
    if bad:
        raise RuntimeError(f"served keylanes: {bad} mismatches")
    log(f"phase 20 keylanes: K={K_KEYLANES_SERVE} keys (G1) in one "
        f"two-party image, {M_RELU} shared points, both parties through the "
        f"service: 0 mismatches ({time.perf_counter() - t0:.1f} s)")
    del svc, kdcf

    # Case 6c: PIR through attach_pir (B6 + P1).
    t0 = time.perf_counter()
    pck = [srng.bytes(32) for _ in range(18)]
    pdcf = Dcf((PIR_SERVE_BITS + 7) // 8, 32, pck)
    records = srng.integers(0, 256, (1 << PIR_SERVE_BITS, RECORD_BYTES),
                            dtype=np.uint8)
    svc = pdcf.serve()
    svc.attach_pir(PirDatabase(records, PIR_SERVE_BITS))
    idx = [0, (1 << PIR_SERVE_BITS) - 1] + [
        int(i) for i in srng.integers(0, 1 << PIR_SERVE_BITS, K_DPF - 2)]
    svc.register_key("q", pdcf.pir_query(idx, rng=srng,
                                         n_bits=PIR_SERVE_BITS))
    reset_counts()
    a0, a1 = (svc.submit("q", np.zeros((1, pdcf.n_bytes), np.uint8),
                         b=b).result(60) for b in (0, 1))
    torch.cuda.synchronize()
    take_counts("serve_pir", {
        "B6": 2 * len(launch_depths(0, PIR_SERVE_BITS)), "P1": 2})
    if not np.array_equal(pir_reconstruct(a0[:, 0], a1[:, 0]),
                          records[idx]):
        raise RuntimeError("served PIR: the records do not reconstruct")
    log(f"phase 20 PIR through attach_pir: 2^{PIR_SERVE_BITS} records x "
        f"{RECORD_BYTES} B, K={K_DPF} queries (records {idx}) reconstruct "
        f"bit-exactly from both parties' served answers "
        f"({time.perf_counter() - t0:.1f} s)")
    del svc, pdcf, records

    # Case 6d: the gate server at gate_bench's shape (n = 16, f = 8, add16).
    t0 = time.perf_counter()
    g_w = Dcf(2, 16, ck, backend="walk")
    g_low = Dcf(1, 16, ck, backend="walk")
    svcs = [f.serve(max_batch=GATE_INPUTS).start() for f in (g_w, g_low)]
    try:
        gs = GateServer(*svcs)
        r_sign, r_trunc = (int(v) for v in srng.integers(0, 1 << 16, 2))
        gs.register("sign", fp.gen_sign_gate(g_w, r_sign, srng, "add16"))
        gs.register("trunc", fp.gen_trunc_gate(g_w, g_low, r_trunc, 8, srng,
                                               "add16"))
        x_hat = srng.integers(0, 1 << 16, GATE_INPUTS, dtype=np.int64)
        x_hat[:4] = [0, 1, (1 << 16) - 1, 1 << 15]
        reset_counts()
        sign = fp.decode_lanes(gs.reconstruct("sign", x_hat), "add16")
        trunc = fp.decode_lanes(gs.reconstruct("trunc", x_hat), "add16")
        torch.cuda.synchronize()
        take_counts("serve_gates_walk", {"B1": 2 + 4})
        if not (np.array_equal(sign, fp.sign_oracle(
                (x_hat - r_sign) % (1 << 16), 16))
                and np.array_equal(trunc, fp.trunc_oracle(
                    x_hat, r_trunc, 8, 16))):
            raise RuntimeError("served gates differ from their oracles")
    finally:
        for s in svcs:
            s.close()
    log(f"phase 20 GateServer (gate_bench's shape: n=16, f=8, add16) on "
        f"walk: sign and truncation of {GATE_INPUTS} masked inputs through "
        f"two started services equal sign_oracle and trunc_oracle "
        f"({time.perf_counter() - t0:.1f} s)")
    return out


def edge_pod_phase(card: str, reset_counts, take_counts) -> dict:
    """Phase 21: the network edge and the pod router
    (``dcf_tpu_torch.serve.edge``, ``router``) on the card.

    ``reset_counts`` / ``take_counts(path, want)`` are main's launch
    counters: each counted path is one run whose service is driven by
    ``pump()`` here, after its requests crossed the wire.  Every check
    raises.  Returns the numbers the phase logged."""
    import threading

    import torch

    from dcf_tpu_torch import Bound, Dcf
    from dcf_tpu_torch.errors import DcfError, QueueFullError
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.ops._launch import launch_depths
    from dcf_tpu_torch.serve import (
        DcfRouter, EdgeClient, EdgeServer, ShardMap, ShardSpec, TenantSpec,
        rollup_snapshots)
    from dcf_tpu_torch.serve.batcher import next_pow2
    from dcf_tpu_torch.serve.loadgen import (
        LoadgenResult, closed_loop, open_loop, reconcile_against_rollup)

    srng = np.random.default_rng(SEED + 21)
    ck = [srng.bytes(32), srng.bytes(32)]
    native = NativeDcf(16, ck)
    tls_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "tls")
    b2_party = len(launch_depths(HOST_LEVELS, 21))  # the prefix depth
    out = {}

    def gen_keys(n: int, prefix: str) -> dict:
        """edge_bench's bundles: single keys from the C++ core."""
        keys = {}
        for i in range(n):
            alphas = srng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
            betas = srng.integers(0, 256, (1, 16), dtype=np.uint8)
            keys[f"{prefix}-{i}"] = native.gen_batch(
                alphas, betas, random_s0s(1, 16, srng), Bound.LT_BETA)
        return keys

    def wait_queued(svc, points: int) -> None:
        deadline = time.perf_counter() + 60
        while svc.queue.points < points:
            if time.perf_counter() > deadline:
                raise RuntimeError(f"{points} points never reached the "
                                   f"queue ({svc.queue.points})")
            time.sleep(0.001)

    def check_pair(y0, y1, kb, xs, what: str) -> None:
        ref = native.eval(0, kb, xs) ^ native.eval(1, kb, xs)
        bad = int(((y0 ^ y1) != ref).any(-1).sum())
        if bad:
            raise RuntimeError(f"{what}: {bad} of {xs.shape[0]} two-party "
                               "reconstructions differ from the C++ core")

    def wire_pair(client, name, kb, points: int, what: str) -> None:
        xs = srng.integers(0, 256, (points, N_BYTES), dtype=np.uint8)
        y0, y1 = (client.evaluate(name, xs, b=b, timeout=60) for b in (0, 1))
        check_pair(y0, y1, kb, xs, what)

    def fault_free(snaps, what: str, shards=()) -> None:
        """The fault counters of a leg without an injected fault."""
        bad = {}
        for snap in snaps:
            names = ["edge_connection_errors_total", "edge_wire_errors_total",
                     "router_mesh_degraded_total"] + [
                f"router_suspected_total{{shard={h}}}" for h in shards]
            bad.update({k: snap[k] for k in names if snap.get(k, 0)})
        if bad:
            raise RuntimeError(f"{what}: fault counters moved {bad}")

    def merged(runs) -> LoadgenResult:
        res = LoadgenResult(duration_s=sum(r.duration_s for r in runs))
        for r in runs:
            res.requests_ok += r.requests_ok
            res.points_ok += r.points_ok
            res.requests_failed += r.requests_failed
            res.requests_shed += r.requests_shed
            res.latencies_s += r.latencies_s
        return res

    def rate_row(res: LoadgenResult) -> dict:
        q = res.latency_quantiles()
        return {"evals_per_s": res.throughput,
                "requests_ok": res.requests_ok,
                "requests_shed": res.requests_shed,
                "p50_ms": q["p50_s"] * 1e3, "p99_ms": q["p99_s"] * 1e3}

    def loop(svc, snap_fn, keys, **kw) -> LoadgenResult:
        """One closed loop, held to 0 failed and reconciled."""
        before = snap_fn()
        res = closed_loop(svc, sorted(keys), **kw)
        rec = reconcile_against_rollup(res, before, snap_fn())
        if res.requests_failed or not res.points_ok or not rec["reconciled"]:
            raise RuntimeError(f"closed loop: {res.requests_failed} failed, "
                               f"{res.requests_ok} ok, reconciliation {rec}")
        return res

    # (a) The edge at edge_bench's shape, on prefix and walk.
    min_req, max_req = EDGE_MAX_BATCH * 3 // 8, EDGE_MAX_BATCH // 2
    tenants = (TenantSpec("gold", "critical"), TenantSpec("silver", "normal"),
               TenantSpec("bronze", "batch",
                          points_per_sec=float(EDGE_MAX_BATCH),
                          burst_points=EDGE_MAX_BATCH // 2))
    for backend, want in (("prefix", {"B2": 2 * b2_party, "B3": 2}),
                          ("walk", {"B1": 2})):
        t0 = time.perf_counter()
        svc = Dcf(N_BYTES, 16, ck, backend=backend).serve(
            max_batch=EDGE_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS,
            tenants=tenants)
        keys = gen_keys(SERVE_BUNDLES, "key")
        for name, kb in keys.items():
            svc.register_key(name, kb)
        edge = EdgeServer(svc).start()
        addr = edge.address
        # The counted run: key-0's two parties over the wire, the service
        # pumped here once both requests are queued.
        xs = srng.integers(0, 256, (EDGE_PARITY, N_BYTES), dtype=np.uint8)
        with EdgeClient(*addr, n_bytes=N_BYTES, tenant="silver") as c:
            reset_counts()
            futs = [c.submit("key-0", xs, b=b) for b in (0, 1)]
            wait_queued(svc, 2 * EDGE_PARITY)
            svc.pump()
            torch.cuda.synchronize()
            take_counts(f"edge_{backend}", want)
            check_pair(*(f.result(60) for f in futs), keys["key-0"], xs,
                       f"edge {backend} wire parity")
        xs_warm = srng.integers(0, 256, (EDGE_MAX_BATCH, N_BYTES),
                                dtype=np.uint8)
        m = next_pow2(min_req)
        while m <= EDGE_MAX_BATCH:  # the batch-shape ladder
            svc.submit("key-0", xs_warm[:m])
            svc.pump()
            m *= 2
        svc.start()
        clients = [EdgeClient(*addr, n_bytes=N_BYTES, tenant="silver")
                   for _ in range(EDGE_CONNS)]
        for name, kb in keys.items():
            wire_pair(clients[0], name, kb, EDGE_PARITY,
                      f"edge {backend} wire parity {name}")
        runs = {"inproc": [], "wire": []}
        for i in range(2 * EDGE_SEGMENTS):
            leg = "wire" if i % 2 else "inproc"
            runs[leg].append(loop(
                svc, svc.metrics_snapshot, keys,
                duration_s=EDGE_SEGMENT_S, concurrency=EDGE_CONNS,
                min_points=min_req, max_points=max_req, seed=SEED + i // 2,
                clients=clients if leg == "wire" else None))
        res_in, res_wire = merged(runs["inproc"]), merged(runs["wire"])
        fault_free([svc.metrics_snapshot()], f"edge {backend} closed loops")
        row = {"inproc": rate_row(res_in), "wire": rate_row(res_wire),
               "wire_vs_inprocess": res_wire.throughput / res_in.throughput}
        row["wire_gate_met"] = row["wire_vs_inprocess"] >= WIRE_GATE
        # The bronze burst: pipelined on one connection, inside one refill
        # window of the BATCH tenant's bucket.
        xs_burst = srng.integers(0, 256, (EDGE_MAX_BATCH // 2, N_BYTES),
                                 dtype=np.uint8)
        with EdgeClient(*addr, n_bytes=N_BYTES, tenant="bronze") as bronze:
            burst = [bronze.submit("key-0", xs_burst) for _ in range(6)]
            refused = hinted = 0
            for f in burst:
                try:
                    f.result(60)
                except QueueFullError as e:
                    refused += 1
                    hinted += e.retry_after_s is not None
        if not refused or hinted != refused:
            raise RuntimeError(f"edge {backend} bronze burst: {refused} "
                               f"refusals, {hinted} with retry_after_s")
        row["bronze_refused"], row["bronze_hinted"] = refused, hinted
        if backend == "prefix":
            tls = EdgeServer(svc, tls_cert=os.path.join(tls_dir, "server.pem"),
                             tls_key=os.path.join(tls_dir, "server.key")
                             ).start()
            with EdgeClient(*tls.address, n_bytes=N_BYTES, tenant="silver",
                            tls=True, tls_ca=os.path.join(tls_dir, "ca.pem")
                            ) as c:
                for name, kb in keys.items():
                    wire_pair(c, name, kb, EDGE_PARITY,
                              f"edge TLS parity {name}")
            tls.close()
            wire_rps = res_wire.requests_ok / res_wire.duration_s
            before = svc.metrics_snapshot()
            res_open = open_loop(
                clients[0], sorted(keys), rate_rps=0.5 * wire_rps,
                duration_s=EDGE_OPEN_S, min_points=min_req,
                max_points=max_req, seed=SEED + 17)
            rec = reconcile_against_rollup(res_open, before,
                                           svc.metrics_snapshot())
            if res_open.failed or not res_open.ok or not rec["reconciled"]:
                raise RuntimeError(f"edge open loop: {res_open.failed} "
                                   f"failed, {res_open.ok} ok, {rec}")
            q = res_open.latency_quantiles()
            row["open_loop"] = {
                "offered_rps": res_open.offered_rps, "sent": res_open.sent,
                "ok": res_open.ok, "shed": res_open.shed,
                "expired": res_open.expired, "p50_ms": q["p50_s"] * 1e3,
                "p99_ms": q["p99_s"] * 1e3, "reconciled": rec["reconciled"]}
        for c in clients:
            c.close()
        edge.close()
        svc.close()
        fault_free([svc.metrics_snapshot()], f"edge {backend}")
        row["seconds"] = time.perf_counter() - t0
        out[f"edge {backend}"] = row
        log(f"phase 21 edge {backend}: Dcf(16, 16), serve(max_batch="
            f"{EDGE_MAX_BATCH}), {SERVE_BUNDLES} C++-core bundles, wire parity "
            f"{EDGE_PARITY} points a bundle, two-party, 0 mismatches"
            + (" (and over TLS)" if backend == "prefix" else "")
            + f"; {EDGE_CONNS} clients, {EDGE_SEGMENTS} x {EDGE_SEGMENT_S} s a "
            f"leg, requests of {min_req}-{max_req} points: in process "
            f"{row['inproc']['evals_per_s']:,.1f} evals/s (p50 "
            f"{row['inproc']['p50_ms']:.2f} ms, p99 "
            f"{row['inproc']['p99_ms']:.2f} ms), over the wire "
            f"{row['wire']['evals_per_s']:,.1f} evals/s (p50 "
            f"{row['wire']['p50_ms']:.2f} ms, p99 {row['wire']['p99_ms']:.2f}"
            f" ms), wire_vs_inprocess {row['wire_vs_inprocess']:.3f} "
            f"(dcf_tpu's gate {WIRE_GATE}: "
            f"{'met' if row['wire_gate_met'] else 'not met'}); bronze burst "
            f"{refused} refusals, {hinted} hinted"
            + (f"; open loop {json.dumps(row['open_loop'])}"
               if backend == "prefix" else "")
            + f"; 0 connection and wire errors ({row['seconds']:.1f} s) "
            f"[{card}]")

    # (b) The pod at pod_bench's shape: 3 prefix shards on the card.
    t0 = time.perf_counter()
    pmin, pmax = POD_MAX_BATCH * 3 // 8, POD_MAX_BATCH // 2
    svcs, edges, specs = [], [], []
    for i in range(POD_SHARDS):
        svc = Dcf(N_BYTES, 16, ck, backend="prefix").serve(
            max_batch=POD_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS)
        edge = EdgeServer(svc).start()
        svcs.append(svc)
        edges.append(edge)
        specs.append(ShardSpec(f"shard-{i}", *edge.address))
    ring = ShardMap(specs)
    host_ids = ring.host_ids()

    def svc_of(host_id: str):
        return svcs[host_ids.index(host_id)]

    def pod_snaps() -> list:
        return [s.metrics_snapshot() for s in svcs] + [
            router.metrics_snapshot()]

    def rollup() -> dict:
        return rollup_snapshots([s.metrics_snapshot() for s in svcs])

    router = DcfRouter(ring, n_bytes=N_BYTES, replicas=1,
                       co_eval_min_points=POD_MAX_BATCH)
    keys = gen_keys(SERVE_BUNDLES, "pod")
    for name, kb in keys.items():
        gen = router.register_key(name, kb)
        for h in ring.placement_ids(name, 1):
            if svc_of(h).replication_digest().get(name) != gen:
                raise RuntimeError(f"pod: {name} not on {h} at generation "
                                   f"{gen}")
    router.start()
    door = router.address
    xs = srng.integers(0, 256, (EDGE_PARITY, N_BYTES), dtype=np.uint8)
    owner = svc_of(ring.owner("pod-0").host_id)
    with EdgeClient(*door, n_bytes=N_BYTES) as c:
        reset_counts()
        futs = [c.submit("pod-0", xs, b=b) for b in (0, 1)]
        wait_queued(owner, 2 * EDGE_PARITY)
        owner.pump()
        torch.cuda.synchronize()
        take_counts("pod_prefix", {"B2": 2 * b2_party, "B3": 2})
        check_pair(*(f.result(60) for f in futs), keys["pod-0"], xs,
                   "pod routed parity")
    # Co-evaluation, counted: one 2^10-point batch a party scattered over
    # the 3 shards, each pumped here once its slices are queued.
    group = router.set_mesh()
    kb_mesh = gen_keys(1, "mesh")["mesh-0"]
    router.register_mesh_key("mesh-0", kb_mesh)
    plan = group.plan(POD_MAX_BATCH)
    xs = srng.integers(0, 256, (POD_MAX_BATCH, N_BYTES), dtype=np.uint8)
    reset_counts()
    futs = [router.submit("mesh-0", xs, b=b) for b in (0, 1)]
    for sl in plan:
        wait_queued(svc_of(sl.host_id), 2 * sl.count)
    for sl in plan:
        svc_of(sl.host_id).pump()
    torch.cuda.synchronize()
    take_counts("pod_mesh", {"B2": 2 * len(plan) * b2_party,
                             "B3": 2 * len(plan)})
    y_mesh = [f.result(60) for f in futs]
    check_pair(*y_mesh, kb_mesh, xs, "pod co-evaluation")
    for s in svcs:
        s.start()
    router.co_eval = "never"
    y_route = [router.evaluate("mesh-0", xs, b=b, timeout=60)
               for b in (0, 1)]
    router.co_eval = "auto"
    if not all(np.array_equal(a, r) for a, r in zip(y_mesh, y_route)):
        raise RuntimeError("pod: co-evaluated shares differ from route-mode's")
    co_ms = {}
    for mode in ("auto", "never"):  # co-evaluated, then routed: timed
        router.co_eval = mode
        t1 = time.perf_counter()
        for b in (0, 1, 0, 1):
            router.evaluate("mesh-0", xs, b=b, timeout=60)
        co_ms[mode] = (time.perf_counter() - t1) / 4 * 1e3
    router.co_eval = "auto"
    snap = router.metrics_snapshot()
    if snap["router_co_evals_total"] != 6:
        raise RuntimeError(f"pod: {snap['router_co_evals_total']} "
                           "co-evaluations, expected 6")
    with EdgeClient(*door, n_bytes=N_BYTES) as c:
        for name, kb in keys.items():
            wire_pair(c, name, kb, EDGE_PARITY, f"pod door parity {name}")
    door_clients = [EdgeClient(*door, n_bytes=N_BYTES)
                    for _ in range(EDGE_CONNS)]
    res_pod = loop(router, rollup, keys, duration_s=POD_LOOP_S,
                   concurrency=EDGE_CONNS, min_points=pmin, max_points=pmax,
                   seed=SEED + 21, clients=door_clients)
    for c in door_clients:
        c.close()
    fault_free(pod_snaps(), "pod closed loop and co-evaluation", host_ids)
    router.health.pump()
    loads = {h: (None if s is None else s.queue_points / s.queue_limit)
             for h, s in router.health.loads().items()}
    if set(router.health.states().values()) != {"up"}:
        raise RuntimeError(f"pod: health {router.health.states()}")
    # One solo shard at the same shape, its own edge, the same loop.
    solo = Dcf(N_BYTES, 16, ck, backend="prefix").serve(
        max_batch=POD_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS)
    for name, kb in keys.items():
        solo.register_key(name, kb)
    solo.start()
    solo_edge = EdgeServer(solo).start()
    solo_clients = [EdgeClient(*solo_edge.address, n_bytes=N_BYTES)
                    for _ in range(EDGE_CONNS)]
    res_solo = loop(solo, solo.metrics_snapshot, keys, duration_s=POD_LOOP_S,
                    concurrency=EDGE_CONNS, min_points=pmin, max_points=pmax,
                    seed=SEED + 21, clients=solo_clients)
    for c in solo_clients:
        c.close()
    solo_edge.close()
    solo.close()
    fault_free([solo.metrics_snapshot()], "solo shard")
    # Failover: one shard's edge closes in the middle of a loop of mixed
    # CRITICAL / NORMAL requests through the router, its health prober
    # running.
    victim = ring.owner("pod-0").host_id
    tally = {"sent": 0, "served": 0, "refused": 0, "untyped": 0,
             "mismatch": 0, "critical_failover_served": 0}
    lock = threading.Lock()
    stop = threading.Event()
    killed = threading.Event()

    def client(i: int) -> None:
        crng = np.random.default_rng(SEED + 210 + i)
        names = sorted(keys)
        while not stop.is_set():
            name = names[int(crng.integers(0, len(names)))]
            pri = "critical" if crng.random() < 0.5 else "normal"
            b = int(crng.integers(0, 2))
            pts = crng.integers(0, 256, (int(crng.integers(pmin, pmax + 1)),
                                         N_BYTES), dtype=np.uint8)
            after = killed.is_set()
            with lock:
                tally["sent"] += 1
            try:
                y = router.evaluate(name, pts, b=b, timeout=60, priority=pri)
            except DcfError as e:
                with lock:
                    tally["refused" if e.retry_after_s is not None
                          else "untyped"] += 1
                continue
            except Exception:  # counted: the check below fails on any
                with lock:
                    tally["untyped"] += 1
                continue
            ok = np.array_equal(y, native.eval(b, keys[name], pts))
            with lock:
                tally["served" if ok else "mismatch"] += 1
                if ok and after and pri == "critical" and \
                        ring.owner(name).host_id == victim:
                    tally["critical_failover_served"] += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(4)]
    router.start_health()  # the prober walks the dead shard DOWN
    for t in threads:
        t.start()
    time.sleep(POD_FAILOVER_S[0])
    edges[host_ids.index(victim)].close()
    killed.set()
    time.sleep(POD_FAILOVER_S[1])
    stop.set()
    for t in threads:
        t.join(120)
    snap = router.metrics_snapshot()
    tally["router_failovers_total"] = snap["router_failovers_total"]
    tally["router_promoted_forwards_total"] = snap[
        "router_promoted_forwards_total"]
    tally["victim_health"] = router.health.state(victim)
    if (tally["untyped"] or tally["mismatch"]
            or tally["served"] + tally["refused"] != tally["sent"]
            or not tally["critical_failover_served"]
            or not (tally["router_failovers_total"]
                    + tally["router_promoted_forwards_total"])
            or any(t.is_alive() for t in threads)):
        raise RuntimeError(f"pod failover: {tally}")
    router.close()
    for e in edges:
        e.close()
    for s in svcs:
        s.close()
    pod_rate = res_pod.throughput
    out["pod"] = row = {
        "pod": rate_row(res_pod), "solo": rate_row(res_solo),
        "pod_vs_solo": pod_rate / res_solo.throughput,
        "co_eval_ms": co_ms["auto"], "route_ms": co_ms["never"],
        "queue_fraction_after_loop": loads, "failover": tally,
        "seconds": time.perf_counter() - t0}
    log(f"phase 21 pod: {POD_SHARDS} prefix shards (max_batch "
        f"{POD_MAX_BATCH}) behind their own EdgeServers, DcfRouter with 1 "
        f"replica, {SERVE_BUNDLES} keys registered through it on owner and "
        f"replica; door parity {EDGE_PARITY} points a key, two-party, 0 "
        f"mismatches; co-evaluation of {POD_MAX_BATCH}-point batches over "
        f"{len(plan)} shards equal to route-mode ({co_ms['auto']:.2f} ms a "
        f"batch, routed {co_ms['never']:.2f} ms); closed loop through the "
        f"door, {EDGE_CONNS} clients x {POD_LOOP_S} s, requests of "
        f"{pmin}-{pmax} points: {pod_rate:,.1f} evals/s (p50 "
        f"{row['pod']['p50_ms']:.2f} ms, p99 {row['pod']['p99_ms']:.2f} ms); "
        f"one solo shard {res_solo.throughput:,.1f} evals/s: pod_vs_solo "
        f"{row['pod_vs_solo']:.3f}; 0 connection, wire, suspect and degrade "
        f"counts; failover (edge of {victim} closed after "
        f"{POD_FAILOVER_S[0]} s): {json.dumps(tally)} "
        f"({row['seconds']:.1f} s) [{card}]")
    return out


def control_plane_phase(card: str, reset_counts, take_counts) -> dict:
    """Phase 22: the pod's control plane (``dcf_tpu_torch.serve.
    membership``, ``capacity``, ``loadgen``'s ramp and session churn) and
    the key factory's staged-plane handoff at lam = 256, on the card.

    ``reset_counts`` / ``take_counts(path, want)`` are main's launch
    counters: each counted path is one run with no other traffic.  Every
    check raises.  Returns the numbers the phase logged."""
    import shutil
    import socket
    import struct
    import tempfile
    import threading

    import torch

    from dcf_tpu_torch import Bound, Dcf
    from dcf_tpu_torch.errors import DcfError
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.native import NativeDcf
    from dcf_tpu_torch.ops._launch import launch_depths
    from dcf_tpu_torch.ops.hybrid_prefix import frontier_launches
    from dcf_tpu_torch.serve import (
        CapacityController, DcfRouter, EdgeClient, EdgeServer, KeyStore,
        MembershipController, PoolSpec, ShardMap, ShardSpec,
        rollup_snapshots)
    from dcf_tpu_torch.serve.capacity import IDLE, PRESSURE, ForcedVerdict
    from dcf_tpu_torch.serve.edge import (
        E_EPOCH, decode_response, encode_request)
    from dcf_tpu_torch.serve.loadgen import (
        closed_loop, open_loop_ramp, session_churn)
    from dcf_tpu_torch.serve.metrics import labeled
    from dcf_tpu_torch.testing import faults

    srng = np.random.default_rng(SEED + 22)
    ck = [srng.bytes(32), srng.bytes(32)]
    native = NativeDcf(16, ck)
    b2_party = len(launch_depths(HOST_LEVELS, 21))  # the prefix depth
    pmin, pmax = POD_MAX_BATCH * 3 // 8, POD_MAX_BATCH // 2
    out = {}

    def gen_keys(n: int, prefix: str) -> dict:
        keys = {}
        for i in range(n):
            alphas = srng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
            betas = srng.integers(0, 256, (1, 16), dtype=np.uint8)
            keys[f"{prefix}-{i}"] = native.gen_batch(
                alphas, betas, random_s0s(1, 16, srng), Bound.LT_BETA)
        return keys

    def check_pair(y0, y1, kb, xs, what: str) -> None:
        ref = native.eval(0, kb, xs) ^ native.eval(1, kb, xs)
        bad = int(((y0 ^ y1) != ref).any(-1).sum())
        if bad:
            raise RuntimeError(f"{what}: {bad} of {xs.shape[0]} two-party "
                               "reconstructions differ from the C++ core")

    def routed_parity(router, keys, what: str) -> None:
        xs = srng.integers(0, 256, (64, N_BYTES), dtype=np.uint8)
        for name, kb in sorted(keys.items()):
            check_pair(*(router.evaluate(name, xs, b=b, timeout=60)
                         for b in (0, 1)), kb, xs, f"{what} {name}")

    def fault_free(router, svcs, what: str, shards=(),
                   overload: bool = False) -> dict:
        """The fault counters of a leg: none may have moved, a failing
        or retried batch on a shard included.  Under a deliberate
        overload (``overload``) a shard that refuses a request at a full
        queue is marked suspect by the router's design (``E_QUEUE_FULL``
        indicts the shard); there each shard's suspicions must be
        accounted for by its own submit-time refusals instead.  Returns
        the suspicions by shard."""
        names = ["edge_connection_errors_total", "edge_wire_errors_total",
                 "router_mesh_degraded_total",
                 "membership_change_failures_total",
                 "capacity_scale_failures_total",
                 "serve_batch_failures_total", "serve_retries_total"]
        rsnap = router.metrics_snapshot()
        bad = {}
        for snap in [rsnap] + [svc.metrics_snapshot()
                               for svc in svcs.values()]:
            bad.update({k: snap[k] for k in names if snap.get(k, 0)})
        suspected = {h: rsnap.get(f"router_suspected_total{{shard={h}}}", 0)
                     for h in shards}
        for h, n in suspected.items():
            snap = svcs[h].metrics_snapshot()
            refused = snap.get("serve_shed_total", 0) \
                - snap.get("serve_queue_evicted_total", 0)
            if n and (not overload or n > refused):
                bad[f"router_suspected_total{{shard={h}}}"] = (n, refused)
        if bad:
            raise RuntimeError(f"{what}: fault counters moved {bad}")
        return suspected

    def wire_digest(addr) -> dict:
        with EdgeClient(*addr, n_bytes=N_BYTES) as c:
            return c.pull_digest(60)

    def peer_epoch(addr) -> int:
        with EdgeClient(*addr, n_bytes=N_BYTES) as c:
            return c.ping_epoch(60)

    def stale_frame_refused(addr, name: str, epoch: int) -> None:
        """A doctored REQUEST one epoch behind dies E_EPOCH."""
        xs = srng.integers(0, 256, (2, N_BYTES), dtype=np.uint8)
        wire = encode_request(7, "default", name, 0, 1, None, xs.tobytes(),
                              N_BYTES, 2, epoch=epoch)
        s = socket.create_connection(addr, timeout=60)
        data = b""
        try:
            s.sendall(wire)
            s.shutdown(socket.SHUT_WR)
            while True:
                chunk = s.recv(1 << 16)
                if not chunk:
                    break
                data += chunk
        finally:
            s.close()
        (body_len,) = struct.unpack_from("<I", data, 0)
        frame = decode_response(data[4:4 + body_len])
        if frame[:3] != ("error", 7, E_EPOCH):
            raise RuntimeError(f"a stale-epoch frame (epoch {epoch}) to "
                               f"{addr} was answered {frame[:3]}")

    def counted_route(router, path: str) -> None:
        """One fresh key through the router, both parties, the only
        traffic: its owner stages it (B2 a party) and evaluates (B3)."""
        kb = gen_keys(1, f"count-{path}")[f"count-{path}-0"]
        name = f"count-{path}"
        router.register_key(name, kb)
        xs = srng.integers(0, 256, (pmax, N_BYTES), dtype=np.uint8)
        torch.cuda.synchronize()
        reset_counts()
        ys = [router.evaluate(name, xs, b=b, timeout=60) for b in (0, 1)]
        torch.cuda.synchronize()
        take_counts(path, {"B2": 2 * b2_party, "B3": 2})
        check_pair(*ys, kb, xs, f"{path} counted run")

    def prefix_shard(**knobs):
        return Dcf(N_BYTES, 16, ck, backend="prefix").serve(
            max_batch=POD_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS, **knobs)

    def provision(router, stores, keys: dict, durable: set) -> dict:
        """Keys registered through the router (owner mints, the REGISTER
        fan-out reaches the replica); the durable ones also published in
        their placement's stores at the same generation."""
        gens = {}
        for name, kb in sorted(keys.items()):
            gens[name] = router.register_key(name, kb)
            if name in durable:
                owner, replica = [s.host_id for s in
                                  router.map.placement(name, 1)]
                stores[owner].put(name, kb, generation=gens[name])
                stores[owner].replicate_to(stores[replica], name)
        return gens

    tmp = tempfile.mkdtemp(prefix="dcf-pod-")
    try:
        # (a) Membership: pod_bench --churn's scenario, in process.
        t0 = time.perf_counter()
        svcs, edges, stores, specs = {}, {}, {}, []
        for i in range(MEMBER_SHARDS):
            h = f"shard-{i}"
            svcs[h] = prefix_shard().start()
            edges[h] = EdgeServer(svcs[h]).start()
            stores[h] = KeyStore(os.path.join(tmp, "member", h))
            specs.append(ShardSpec(h, *edges[h].address))
        router = DcfRouter(ShardMap(specs), n_bytes=N_BYTES, replicas=1,
                           probe_interval_s=PROBE_INTERVAL_S)
        keys = gen_keys(MEMBER_KEYS, "pod")
        durable = set(sorted(keys)[:MEMBER_KEYS // 2])
        gens = provision(router, stores, keys, durable)
        routed_parity(router, keys, "membership parity")
        router.start_health()
        ctrl = MembershipController(
            router, stores=stores, eject_grace_s=EJECT_GRACE_S,
            drain_grace_s=DRAIN_GRACE_S, min_hosts=2,
            poll_interval_s=0.1).start()
        victim = router.map.owner("pod-0").host_id
        second = next(h for h in router.map.host_ids() if h != victim)
        tally = {"sent": 0, "served": 0, "refused": 0, "untyped": 0,
                 "mismatch": 0}
        lock = threading.Lock()
        stop = threading.Event()

        def client(i: int) -> None:
            crng = np.random.default_rng(SEED + 220 + i)
            names = sorted(keys)
            while not stop.is_set():
                name = names[int(crng.integers(0, len(names)))]
                pri = "critical" if crng.random() < 0.5 else "normal"
                b = int(crng.integers(0, 2))
                pts = crng.integers(0, 256, (int(crng.integers(
                    pmin, pmax + 1)), N_BYTES), dtype=np.uint8)
                with lock:
                    tally["sent"] += 1
                try:
                    y = router.evaluate(name, pts, b=b, timeout=60,
                                        priority=pri)
                except DcfError as e:
                    with lock:
                        tally["refused" if e.retry_after_s is not None
                              else "untyped"] += 1
                    continue
                except Exception:  # counted: the gate fails on any
                    with lock:
                        tally["untyped"] += 1
                    continue
                ok = np.array_equal(y, native.eval(b, keys[name], pts))
                with lock:
                    tally["served" if ok else "mismatch"] += 1

        def wait_until(pred, what: str, limit_s: float = 60.0) -> float:
            t1 = time.perf_counter()
            while not pred():
                if time.perf_counter() - t1 > limit_s:
                    raise RuntimeError(f"membership: timed out waiting "
                                       f"for {what}")
                time.sleep(0.005)
            return time.perf_counter()

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        held = {name for name in keys
                if victim in router.map.placement_ids(name, 1)}
        t_close = time.perf_counter()
        edges[victim].close()
        t_commit = wait_until(lambda: victim not in router.map, "the eject")
        eject_s = t_commit - t_close
        # Right after the commit, over the DIGEST verb: every key the
        # victim held is on its new placement at its generation.
        for name in sorted(held):
            for h in router.map.placement_ids(name, 1):
                got = wire_digest(router.map.get(h).address).get(name)
                if got != gens[name]:
                    raise RuntimeError(f"eject: {name} on {h} at generation "
                                       f"{got}, registered {gens[name]}")
        converge_s = wait_until(lambda: all(
            peer_epoch(router.map.get(h).address) == router.ring_epoch
            for h in router.map.host_ids()), "epoch convergence", 10.0) \
            - t_commit
        # The victim's process comes back empty behind a new edge; the
        # join warms it before admitting it.
        svcs[victim].close()
        svcs[victim] = prefix_shard().start()
        edges[victim] = EdgeServer(svcs[victim]).start()
        t1 = time.perf_counter()
        ctrl.join(ShardSpec(victim, *edges[victim].address),
                  store=stores[victim])
        join_s = time.perf_counter() - t1
        time.sleep(0.5)
        t1 = time.perf_counter()
        ctrl.drain(second)
        drain_s = time.perf_counter() - t1
        drain_done_s = wait_until(lambda: not ctrl.draining(),
                                  "the drain's forget") - t1
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(120)
        events = ctrl.events()
        ctrl.close()
        kinds = [e.kind for e in events]
        epochs = [e.epoch for e in events if e.kind != "drain-complete"]
        if kinds != ["eject", "join", "drain", "drain-complete"] \
                or epochs != sorted(set(epochs)) or epochs[0] < 1:
            raise RuntimeError(f"membership events {kinds}, epochs {epochs}")
        if tally["untyped"] or tally["mismatch"] \
                or tally["served"] + tally["refused"] != tally["sent"] \
                or any(t.is_alive() for t in threads):
            raise RuntimeError(f"membership loop: {tally}")
        for h in (victim, router.map.host_ids()[-1]):
            stale_frame_refused(router.map.get(h).address, "pod-0",
                                router.ring_epoch - 1)
        regressions = 0
        for h in router.map.host_ids():
            digest = wire_digest(router.map.get(h).address)
            regressions += sum(1 for k, g in digest.items()
                               if g < gens.get(k, 0))
            for name in keys:
                if h in router.map.placement_ids(name, 1) \
                        and digest.get(name) != gens[name]:
                    raise RuntimeError(f"membership: {h} holds {name} at "
                                       f"{digest.get(name)}, registered "
                                       f"{gens[name]}")
        lost = ctrl.lost_keys(exclude={second})
        if regressions or lost:
            raise RuntimeError(f"membership: {regressions} generation "
                               f"regressions, lost keys {lost}")
        routed_parity(router, keys, "membership parity after the changes")
        fault_free(router, svcs, "membership",
                   [h for h in router.map.host_ids() if h != victim])
        counted_route(router, "membership_prefix")
        snap = router.metrics_snapshot()
        row = {"eject_to_commit_s": eject_s, "epoch_converged_s": converge_s,
               "join_s": join_s, "drain_s": drain_s,
               "drain_complete_s": drain_done_s, "loop": tally,
               "events": [[e.kind, e.host_id, e.epoch, e.migrated]
                          for e in events],
               "durable_replications": snap[
                   "membership_durable_replications_total"],
               "migrated_frames": snap["membership_migrated_frames_total"],
               "lost_keys": 0, "generation_regressions": 0,
               "seconds": time.perf_counter() - t0}
        out["membership"] = row
        router.close()
        for e in edges.values():
            e.close()
        for s in svcs.values():
            s.close()
        log(f"phase 22 membership: {MEMBER_SHARDS} prefix shards behind their "
            f"own EdgeServers, DcfRouter (1 replica, prober every "
            f"{PROBE_INTERVAL_S} s), MembershipController (eject grace "
            f"{EJECT_GRACE_S} s, drain grace {DRAIN_GRACE_S} s, min_hosts 2), "
            f"{MEMBER_KEYS} keys ({len(durable)} durable in KeyStores); 3 "
            f"clients of mixed CRITICAL / NORMAL throughout: edge of {victim} "
            f"closed -> eject committed in {eject_s:.3f} s (its keys on their "
            f"new placement at their generations by DIGEST; the pod on the "
            f"epoch {converge_s:.3f} s later); rejoined warm in "
            f"{join_s:.3f} s; {second} drained in {drain_s:.3f} s, forgotten "
            f"{drain_done_s:.3f} s after; events {row['events']}; loop "
            f"{json.dumps(tally)}; 0 lost keys, 0 generation regressions, "
            f"stale-epoch frames refused E_EPOCH; fault counters 0 "
            f"({row['seconds']:.1f} s) [{card}]")

        # (b) Capacity: pod_bench --surge's scenario, in process.
        t0 = time.perf_counter()
        svcs, edges, stores = {}, {}, {}
        for i in range(CAP_SHARDS + 1):
            h = f"cap-{i}"
            svcs[h] = prefix_shard(max_queued_points=CAP_QUEUE_POINTS).start()
            edges[h] = EdgeServer(svcs[h]).start()
            stores[h] = KeyStore(os.path.join(tmp, "capacity", h))
        standby = f"cap-{CAP_SHARDS}"
        ring = ShardMap([ShardSpec(h, *edges[h].address) for h in svcs
                         if h != standby])
        router = DcfRouter(ring, n_bytes=N_BYTES, replicas=1,
                           probe_interval_s=PROBE_INTERVAL_S,
                           probe_timeout_s=10.0, probe_fail_n=6,
                           probe_recover_m=1, reconnect_backoff_s=0.02,
                           max_backoff_s=PROBE_INTERVAL_S)
        keys = gen_keys(CAP_KEYS, "surge")
        gens = provision(router, stores, keys, set(keys))
        mc = MembershipController(router, stores=stores, eject_grace_s=3.0,
                                  drain_grace_s=DRAIN_GRACE_S, min_hosts=2,
                                  poll_interval_s=PROBE_INTERVAL_S)
        tick = PROBE_INTERVAL_S
        cap = CapacityController(
            router, mc, standby=[(ShardSpec(standby, *edges[standby].address),
                                  stores[standby])],
            interval_s=tick, scale_out_n=2, scale_in_m=3,
            cooldown_s=max(2 * tick, 1.0), min_hosts=CAP_SHARDS,
            max_hosts=CAP_SHARDS + 1, queue_pressure_fraction=0.5,
            queue_idle_fraction=0.05)
        routed_parity(router, keys, "capacity parity")
        router.start_health()
        deadline = time.perf_counter() + 60
        while set(router.health.states().values()) != {"up"}:
            if time.perf_counter() > deadline:
                raise RuntimeError(f"capacity: health "
                                   f"{router.health.states()}")
            time.sleep(0.02)
        cal = closed_loop(router, sorted(keys), duration_s=2.0,
                          concurrency=EDGE_CONNS, min_points=pmin,
                          max_points=pmax, seed=SEED + 23)
        base_rps = max(cal.requests_ok / cal.duration_s, 2.0)
        segments = [(3.0, 1.5 * base_rps), (6.0, 2.5 * base_rps), (2.0, 0.0)]
        ramp = {}

        def offer() -> None:
            ramp["res"] = open_loop_ramp(
                router, sorted(keys), segments=segments, min_points=pmin,
                max_points=pmax, seed=SEED + 24, skew=SKEW,
                deadline_ms=2000.0,
                priority_mix={"normal": 0.65, "batch": 0.35})

        ramp_thread = threading.Thread(target=offer, daemon=True)
        hb_rng = np.random.default_rng(SEED + 25)
        hb, cap_events, hb_refused = [], [], 0
        t_surge = time.perf_counter()
        ramp_thread.start()
        t_out = t_in = None
        # The reference's bound on the whole cycle (cli.py:4751).
        cycle_deadline = t_surge + sum(d for d, _ in segments) + 240
        timeline = []  # one entry a tick, for the failure message
        n_seen = 0
        while time.perf_counter() < cycle_deadline:
            verdict = cap.pump()
            mc.pump()
            cap_events += cap.events()
            timeline.append(
                f"{time.perf_counter() - t_surge:.2f}:"
                + (f"{verdict.kind[0]}{verdict.queue_fraction:.2f}"
                   f"/s{verdict.shed_delta}" if verdict else "frozen")
                + f"/r{len(router.map)}"
                + ("" if ramp_thread.is_alive() else "/done"))
            if ramp_thread.is_alive():
                name = sorted(keys)[len(hb) % len(keys)]
                xs_hb = hb_rng.integers(0, 256, (8, N_BYTES), dtype=np.uint8)
                try:
                    hb.append((name, xs_hb, *(router.submit(
                        name, xs_hb, b=b, priority="critical")
                        for b in (0, 1))))
                except DcfError as e:
                    if e.retry_after_s is None:
                        raise
                    hb_refused += 1
            now = time.perf_counter()
            if t_out is None and any(e.kind == "scale-out"
                                     for e in cap_events):
                t_out = now
            # The ramp's backlog can outlast its quiet segment, and a
            # slow host lets the pod look idle while the generator still
            # catches up: the pod may scale in, then out again, before
            # the load is over.  The cycle ends with the ring back at
            # its size after the ramp has drained; t_in is the last
            # scale-in, the one that brought it back.
            if len(cap_events) > n_seen:
                n_seen = len(cap_events)
                if cap_events[-1].kind == "scale-in":
                    t_in = now
            if t_out is not None and t_in is not None \
                    and not ramp_thread.is_alive() and not mc.draining() \
                    and len(router.map) == CAP_SHARDS:
                break
            time.sleep(tick)
        ramp_thread.join(120)
        res = ramp.get("res")
        if res is None or t_out is None or t_in is None \
                or len(router.map) != CAP_SHARDS:
            snap = router.metrics_snapshot()
            skips = {k: v for k, v in snap.items()
                     if k.startswith("capacity_skips_total")}
            ramp_seen = None if res is None else {
                "sent": res.sent, "ok": res.ok, "shed": res.shed,
                "expired": res.expired, "failed": res.failed,
                "seconds": res.duration_s, "by_class": res.by_class}
            raise RuntimeError(
                f"capacity: scale-out at {t_out}, scale-in at {t_in} "
                f"(surge at {t_surge}), ring {router.map.host_ids()}, "
                f"health {router.health.states()}, draining "
                f"{mc.draining()}, events {cap_events}, skips {skips}, "
                f"ramp {ramp_seen}; ticks (seconds into the surge: "
                f"Pressure/Idle/Steady, queue fraction, sheds, ring size) "
                f"{' '.join(timeline)}")
        reaction_s = t_out - t_surge
        if reaction_s > CAP_REACTION_S:
            raise RuntimeError(f"capacity: scale-out {reaction_s:.2f} s into "
                               f"the surge, over the {CAP_REACTION_S} s bound")
        hb_ok = 0
        for name, xs_hb, f0, f1 in hb:
            try:
                y0, y1 = f0.result(120), f1.result(120)
            except DcfError as e:
                if e.retry_after_s is None:
                    raise
                hb_refused += 1
                continue
            check_pair(y0, y1, keys[name], xs_hb, "capacity heartbeat")
            hb_ok += 1
        roll = rollup_snapshots([s.metrics_snapshot() for s in svcs.values()])
        critical_shed = roll.get(labeled("serve_shed_by_class_total",
                                         priority="critical"), 0)
        if critical_shed:
            raise RuntimeError(f"capacity: {critical_shed} CRITICAL sheds")
        routed_parity(router, keys, "capacity parity after the shrink")
        for h in router.map.host_ids():
            digest = wire_digest(router.map.get(h).address)
            for name in keys:
                if h in router.map.placement_ids(name, 1) \
                        and digest.get(name) != gens[name]:
                    raise RuntimeError(f"capacity: {h} holds {name} at "
                                       f"{digest.get(name)}")
        # The oscillation leg: a forced load walk, zero ring churn.
        epoch0, flips = router.ring_epoch, {"n": 0}

        def oscillate(kind, verdict):
            flips["n"] += 1
            raise ForcedVerdict(PRESSURE if flips["n"] % 2 else IDLE)

        with faults.inject("capacity.decide", handler=oscillate):
            for _ in range(4 * max(cap.scale_out_n, cap.scale_in_m)):
                cap.pump()
        if router.ring_epoch != epoch0 or cap.events():
            raise RuntimeError("capacity: the forced oscillation moved the "
                               "ring")
        suspected = fault_free(router, svcs, "capacity",
                               router.map.host_ids(), overload=True)
        counted_route(router, "capacity_prefix")
        snap = router.metrics_snapshot()
        q = res.latency_quantiles()
        row = {"calibrated_rps": base_rps,
               "segments": [[d, r] for d, r in segments],
               "sent": res.sent, "ok": res.ok, "shed": res.shed,
               "expired": res.expired, "failed": res.failed,
               "p50_ms": q.get("p50_s", 0) * 1e3,
               "p99_ms": q.get("p99_s", 0) * 1e3,
               "scale_out_s": reaction_s, "scale_in_s": t_in - t_surge,
               "events": [[e.kind, e.host_id, e.epoch] for e in cap_events],
               "heartbeats_ok": hb_ok, "heartbeats_refused": hb_refused,
               "critical_shed": 0,
               "ticks": snap["capacity_ticks_total"],
               "pressure_ticks": snap["capacity_pressure_ticks_total"],
               "idle_ticks": snap["capacity_idle_ticks_total"],
               "skips": {k.split("=")[1].rstrip("}"): v
                         for k, v in snap.items()
                         if k.startswith("capacity_skips_total{")},
               "oscillation_ticks": flips["n"],
               "suspect_refusals": snap.get(
                   "router_suspect_refusals_total", 0),
               "suspected_at_full_queue": suspected,
               "seconds": time.perf_counter() - t0}
        out["capacity"] = row
        router.close()
        for e in edges.values():
            e.close()
        for s in svcs.values():
            s.close()
        log(f"phase 22 capacity: {CAP_SHARDS} prefix shards + 1 standby "
            f"(max_queued_points {CAP_QUEUE_POINTS}), CapacityController "
            f"(tick {tick} s, n 2, m 3, cooldown {cap.cooldown_s} s, queue "
            f"pressure 0.5); calibrated {base_rps:,.1f} requests/s closed "
            f"loop; open_loop_ramp (Zipf {SKEW}) "
            f"{[(d, round(r, 1)) for d, r in segments]}: sent {res.sent}, ok "
            f"{res.ok}, shed {res.shed}, expired {res.expired}, p50 "
            f"{row['p50_ms']:.2f} ms, p99 {row['p99_ms']:.2f} ms; scale-out "
            f"{reaction_s:.3f} s into the surge (bound {CAP_REACTION_S} s), "
            f"back to {CAP_SHARDS} hosts by the scale-in at "
            f"{row['scale_in_s']:.3f} s, {len(cap_events)} ring changes "
            f"{row['events']}; {res.failed} requests failed (router "
            f"refusals at a suspect owner: {row['suspect_refusals']}); "
            f"{hb_ok} CRITICAL heartbeats served, {hb_refused} refused "
            f"typed, 0 CRITICAL sheds; every key two-party equal after the "
            f"shrink; {flips['n']} forced oscillating ticks, epoch unmoved; "
            f"skips {row['skips']}; suspicions {suspected}, each a shard's "
            f"own full-queue refusal; no failed batch "
            f"({row['seconds']:.1f} s) [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) Session churn over a lam = 16 pool refilled by G1.
    t0 = time.perf_counter()
    svc = Dcf(N_BYTES, 16, ck, backend="walk").serve(
        max_batch=POD_MAX_BATCH, max_delay_ms=1.0)
    alphas = srng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
    betas = srng.integers(0, 256, (1, 16), dtype=np.uint8)
    svc.add_pool(PoolSpec(name="sess", alphas=alphas, betas=betas,
                          target_depth=CHURN_POOL, low_water=CHURN_POOL // 4,
                          refill_batch=CHURN_POOL))
    xs = srng.integers(0, 256, (pmax, N_BYTES), dtype=np.uint8)
    xs[0] = alphas[0]
    reset_counts()
    svc.keyfactory.pump()
    svc.register_key("first", pool="sess")
    futs = [svc.submit("first", xs, b=b) for b in (0, 1)]
    svc.pump()
    y0, y1 = (f.result(60) for f in futs)
    torch.cuda.synchronize()
    take_counts("churn_keyfactory", {"G1": 1, "B1": 2})

    def function(points):
        inside = np.array([x.tobytes() < alphas[0].tobytes()
                           for x in points])
        return np.where(inside[:, None], betas, 0).astype(np.uint8)

    if not np.array_equal((y0 ^ y1)[0], function(xs)):
        raise RuntimeError("churn: the claimed key does not reconstruct "
                           "its function")
    svc.unregister_key("first")

    class Probe:
        """The service as ``session_churn`` sees it, keeping both
        parties' futures of each session for the parity gate."""

        n_bytes = N_BYTES

        def __init__(self):
            self.sessions = {}

        def register_key(self, key_id, pool=None, durable=False):
            return svc.register_key(key_id, pool=pool, durable=durable)

        def submit(self, key_id, points, b=0):
            fut = svc.submit(key_id, points, b=b)
            self.sessions.setdefault(key_id, [points, None, None])[1 + b] = fut
            return fut

        def unregister_key(self, key_id):
            svc.unregister_key(key_id)

    probe = Probe()
    svc.start()
    snap0 = svc.metrics_snapshot()
    res = session_churn(probe, pool="sess", duration_s=CHURN_S,
                        concurrency=CHURN_CONCURRENCY, min_points=pmin,
                        max_points=pmax, seed=SEED + 26)
    snap = svc.metrics_snapshot()
    svc.close()
    bad = sum(1 for points, f0, f1 in probe.sessions.values()
              if not np.array_equal((f0.result(60) ^ f1.result(60))[0],
                                    function(points)))
    hits = snap["keyfactory_pool_hits_total"] - snap0.get(
        "keyfactory_pool_hits_total", 0)
    misses = snap["keyfactory_pool_misses_total"] - snap0.get(
        "keyfactory_pool_misses_total", 0)
    if bad or res.sessions_failed or not res.sessions_ok \
            or hits + misses != res.sessions_ok \
            or len(probe.sessions) != res.sessions_ok:
        raise RuntimeError(f"churn: {bad} sessions off their function, "
                           f"{res.sessions_ok} ok, {res.sessions_failed} "
                           f"failed, {hits} hits + {misses} misses")
    rq = res.register_quantiles()
    sq = res.session_quantiles()
    out["churn"] = row = {
        "sessions": res.sessions_ok, "sessions_per_s": res.sessions_per_sec,
        "register_p50_ms": rq["register_p50_s"] * 1e3,
        "register_p99_ms": rq["register_p99_s"] * 1e3,
        "session_p50_ms": sq["session_p50_s"] * 1e3,
        "session_p99_ms": sq["session_p99_s"] * 1e3,
        "pool_hit_rate": hits / (hits + misses), "refills": snap[
            "keyfactory_refills_total"],
        "seconds": time.perf_counter() - t0}
    log(f"phase 22 session churn: Dcf(16, 16) walk, a pool of "
        f"{CHURN_POOL} sessions refilled by G1, {CHURN_CONCURRENCY} clients x "
        f"{CHURN_S} s, requests of {pmin}-{pmax} points a party: "
        f"{res.sessions_ok} sessions = {row['sessions_per_s']:,.1f}/s, "
        f"registration p50 {row['register_p50_ms']:.3f} ms, p99 "
        f"{row['register_p99_ms']:.3f} ms, session p50 "
        f"{row['session_p50_ms']:.2f} ms; pool hit rate "
        f"{row['pool_hit_rate']:.3f} ({hits} hits, {misses} misses, "
        f"{row['refills']} refills); every session's two shares "
        f"reconstruct its function ({row['seconds']:.1f} s) [{card}]")

    # (d) The staged-plane handoff: lam = 256 hybrid, prefix_levels=20.
    t0 = time.perf_counter()
    hck = [srng.bytes(32) for _ in range(32)]
    hdcf = Dcf(N_BYTES, LAM_WIDE, hck, backend="hybrid",
               backend_opts={"prefix_levels": K_HYBRID})
    svc = hdcf.serve(max_batch=M_SERVE_SMALL)
    halphas = srng.integers(0, 256, (1, N_BYTES), dtype=np.uint8)
    hbetas = srng.integers(0, 256, (1, LAM_WIDE), dtype=np.uint8)
    svc.add_pool(PoolSpec(name="wide", alphas=halphas, betas=hbetas,
                          target_depth=4, low_water=0, refill_batch=4))
    xs = srng.integers(0, 256, (M_SERVE_SMALL, N_BYTES), dtype=np.uint8)
    xs[0] = halphas[0]
    reg = svc.registry
    b5a_party = 1 + len(frontier_launches(K_HYBRID)[1])

    def first_share(key_id, **register) -> tuple:
        """Register, then party 0's share of ``xs``: (seconds, bundle,
        share)."""
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kb = svc.register_key(key_id, **register)
        fut = svc.submit(key_id, xs, b=0)
        svc.pump()
        y = fut.result(60)
        return time.perf_counter() - t1, kb, y

    reset_counts()
    svc.keyfactory.pump()
    kb = svc.register_key("w0", pool="wide")
    futs = [svc.submit("w0", xs, b=b) for b in (0, 1)]
    svc.pump()
    ys = [f.result(60) for f in futs]
    torch.cuda.synchronize()
    take_counts("serve_handoff", {"B7a": 1, "W2": 1, "B5a": 2 * b5a_party,
                                  "B5b": 2, "W1": 2})
    if (reg.stagings_from_planes, reg.stagings_from_bundle) != (2, 0):
        raise RuntimeError(
            f"handoff: a claimed lam={LAM_WIDE} key staged "
            f"{reg.stagings_from_planes} times from its planes and "
            f"{reg.stagings_from_bundle} from its host bundle (want 2, 0)")
    svc.register_key("w0-host", kb)
    futs = [svc.submit("w0-host", xs, b=b) for b in (0, 1)]
    svc.pump()
    ys_host = [f.result(60) for f in futs]
    hnative = NativeDcf(LAM_WIDE, hck)
    for b in (0, 1):
        if not (np.array_equal(ys[b], ys_host[b])
                and np.array_equal(ys[b], hnative.eval(b, kb, xs))):
            raise RuntimeError(f"handoff: party {b}'s shares from the "
                               "planes differ from the host bundle's or the "
                               "C++ core's")
    if not np.array_equal((ys[0] ^ ys[1])[0],
                          np.where(np.array([x.tobytes() < halphas[0].tobytes()
                                             for x in xs])[:, None],
                                   hbetas, 0).astype(np.uint8)):
        raise RuntimeError("handoff: the claimed key does not reconstruct "
                           "its function")
    times = {"planes": [], "host": []}
    for i, how in enumerate(("planes", "host", "host", "planes")):
        if how == "planes":
            dt, kb_i, y = first_share(f"wp{i}", pool="wide")
            last = kb_i
        else:
            dt, _, y = first_share(f"wh{i}", bundle=last)
        if not np.array_equal(y, hnative.eval(0, last, xs)):
            raise RuntimeError(f"handoff: {how} share differs")
        times[how].append(dt)
    if reg.stagings_from_planes != 4 or reg.stagings_from_bundle != 4:
        raise RuntimeError(f"handoff: stagings {reg.stagings_from_planes} "
                           f"from planes, {reg.stagings_from_bundle} from "
                           "bundles (want 4, 4)")
    out["handoff"] = row = {
        "register_to_first_share_ms_planes": [t * 1e3
                                              for t in times["planes"]],
        "register_to_first_share_ms_host": [t * 1e3 for t in times["host"]],
        "stagings_from_planes": reg.stagings_from_planes,
        "stagings_from_bundle": reg.stagings_from_bundle,
        "seconds": time.perf_counter() - t0}
    svc.close()
    log(f"phase 22 handoff: Dcf(16, {LAM_WIDE}) hybrid prefix_levels="
        f"{K_HYBRID}, a pool of 4 refilled by B7a + W2: the claimed key "
        f"staged from its device planes (2 stagings from planes, 0 from the "
        f"bundle), its {M_SERVE_SMALL} points a party equal to the same "
        f"bundle staged from the host and to the C++ core; register to first "
        f"share (party 0, B5a's frontier included) with planes "
        f"{', '.join(f'{t:.3f}' for t in row['register_to_first_share_ms_planes'])} "
        f"ms, from the host bundle "
        f"{', '.join(f'{t:.3f}' for t in row['register_to_first_share_ms_host'])} "
        f"ms ({row['seconds']:.1f} s) [{card}]")
    return out

#: Phase 23's subcommands: (path name, argv, launches, lines).  A run of
#: fixed repetitions names the launches it must make, kernel by kernel
#: (a dict); a closed-loop serving leg, whose launches follow its
#: duration, names the kernels it must launch at least once (a tuple).
#: Cuts from dcf_tpu's defaults: --duration 30 s to 3-6 s and --reps 3 to
#: 2 for keygen_bench and keyfactory_bench; the widths are the
#: reference's.
CLI_RUNS = (
    # Config 1 on the C++ core; config 2 (n = 128, n = 32) B2 25 a line:
    # its frontier, both parties, the check and two warm calls; config 3
    # B2 + B2f; config 4 (lam = 16384, 256) B4 + W1; config 5 G1 + B8.
    ("baseline", ["baseline"],
     {"B2": 50, "B3": 10, "B2f": 8, "B4": 10, "W1": 10, "G1": 8, "B8": 16},
     8),
    ("walk", ["dcf_batch_eval", "--backend", "walk", "--points", "1048576",
              "--check"], {"B1": 8}, 1),
    ("hybrid_prefix", ["dcf_large_lambda", "--backend", "hybrid", "--lam",
                       "256", "--points", "1048576", "--prefix-levels",
                       "20", "--check"], {"B5a": 18, "B5b": 8, "W1": 8}, 1),
    ("keygen", ["keygen_bench", "--reps", "2"], {"B7a": 32, "W2": 32}, 2),
    ("pir", ["pir_bench", "--n-bits", "24"], {"B6": 80, "P1": 10}, 1),
    ("mic", ["mic_bench", "--backend", "walk", "--duration", "3"],
     ("B1",), 1),
    ("gates", ["gate_bench", "--backend", "walk"], {"B1": 24}, 1),
    ("serve_skew", ["serve_bench", "--backend", "prefix", "--skew", "1.1",
                    "--duration", "6"], ("B2", "B3"), 1),
    ("serve_edge", ["serve_bench", "--backend", "prefix", "--edge",
                    "--duration", "3"], ("B2", "B3"), 1),
    ("edge", ["edge_bench", "--backend", "prefix", "--duration", "4"],
     ("B2", "B3"), 1),
    ("chaos", ["chaos_bench", "--backend", "walk", "--duration", "3"],
     ("B1",), 1),
    ("chaos_restart", ["chaos_bench", "--backend", "walk",
                       "--crash-restart", "--keyfactory", "--duration",
                       "3"], ("B1", "G1"), 1),
    ("keyfactory", ["keyfactory_bench", "--duration", "3", "--reps", "2"],
     ("B7a", "W2"), 1),
)
#: Two of dcf_tpu's throughput gates that phase 23 reports and does not
#: require, as phases 20 and 21 report the same two (ROADMAP.md records
#: the decision and the queued work): ``serve_bench --skew``'s cached leg
#: beating its cold-frontier leg, and ``edge_bench``'s wire path at >= 0.8
#: of the in-process rate.  On an H100 the port's wire path measured
#: 0.39-0.56 of that rate (PERF.md), and the cached leg fell behind the
#: cold one in some runs: at this budget its frontier cache builds about
#: as many frontiers as the cold leg does (the B2 launches of each leg
#: are logged), and the one-process edge shares the interpreter with its
#: clients.  The CLI still exits non-zero for them; the phase
#: accepts that exit only when every failure it names is this gate, and
#: holds the line and every other gate, parity included.
CLI_REPORTED = {"serve_skew": "did not beat the cold-frontier leg",
                "edge": "the zero-copy wire path is not holding"}
#: The keys every line of a bench carries on the card (dcf_tpu's, plus
#: the card's name).
CLI_KEYS = {"bench", "backend", "metric", "value", "unit", "device"}
FLAGSHIP_TOLERANCE = 0.10  # the baseline flagship line against phase 17


def cli_phase(card: str, reset_counts, take_at_least, take_counts,
              bench_line: dict) -> dict:
    """Phase 23: the port's bench CLI in process, its module entry in a
    subprocess, and ``entry()`` on the card.  Raises on any failure;
    returns the numbers the phase logged."""
    import contextlib
    import io

    import torch

    from dcf_tpu_torch import cli
    from dcf_tpu_torch.entry import entry
    from dcf_tpu_torch.ops.walk_eval import walk_eval_plain

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    logs = []
    result = {}
    for name, argv, kernels, n_lines in CLI_RUNS:
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        reset_counts()
        verdict = "passed"
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                cli.main(argv)
        except SystemExit as e:
            # "<bench>: <failure>; <failure>" — only a reported gate may
            # fail, and alone.
            failures = str(e.code).split(": ", 1)[-1].split("; ")
            if name not in CLI_REPORTED or not all(
                    CLI_REPORTED[name] in f for f in failures):
                raise RuntimeError(
                    f"phase 23 cli {' '.join(argv)}: exit {e.code}; stderr "
                    f"tail:\n{err.getvalue()[-3000:]}") from None
            verdict = f"reported, not met: {e.code}"
        ran = (take_counts(f"cli_{name}", kernels)
               if isinstance(kernels, dict)
               else take_at_least(f"cli_{name}", kernels))
        secs = time.perf_counter() - t0
        logs.append(f"$ python -m dcf_tpu_torch.cli {' '.join(argv)}\n"
                    + err.getvalue() + out.getvalue())
        lines = [json.loads(x) for x in out.getvalue().splitlines()]
        if len(lines) != n_lines:
            raise RuntimeError(f"phase 23 cli {name}: {len(lines)} lines, "
                               f"want {n_lines}")
        for rec in lines:
            missing = CLI_KEYS - set(rec)
            if missing or not rec["value"] > 0 or rec["device"] != card:
                raise RuntimeError(f"phase 23 cli {name}: bad line {rec} "
                                   f"(missing {missing})")
        if name == "serve_skew":
            rec = lines[0]
            if not rec["frontier_hit_rate"] >= 0.5:
                raise RuntimeError(f"phase 23 cli {name}: frontier hit "
                                   f"rate {rec['frontier_hit_rate']} < 0.5")
            verdict += (f"; cached_vs_cold {rec['cached_vs_cold']}, B2 "
                        f"launches cached leg "
                        f"{rec['b2_launches_cached_leg']}, cold leg "
                        f"{rec['b2_launches_cold_leg']}")
        result[name] = {"seconds": round(secs, 1), "launches": ran,
                        "gates": verdict,
                        "lines": [{k: rec[k] for k in
                                   ("bench", "backend", "value", "unit")}
                                  for rec in lines]}
        log(f"phase 23 cli {name} ({' '.join(argv)}): {len(lines)} "
            f"line(s), gates {verdict}, launches {ran}, {secs:.1f} s: "
            + "; ".join(f"{r['bench']}[{r['backend']}] {r['value']:,} "
                        f"{r['unit']}" for r in lines) + f" [{card}]")
        if name == "baseline":
            result["baseline_lines"] = lines
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase23_cli.log"), "w") as f:
            f.write("\n".join(logs))

    # The flagship line: baseline config 2 at n = 128 against phase 17.
    # Config 2's first line is the n = 128 shape, its second n = 32.
    flag = [r for r in result.pop("baseline_lines")
            if r["bench"] == "dcf_batch_eval"][0]
    ratio = flag["value"] / bench_line["value"]
    log(f"phase 23 flagship: baseline config 2 (n=128) {flag['value']:,} "
        f"evals/s against phase 17's bench_torch {bench_line['value']:,} "
        f"evals/s: ratio {ratio:.4f} [{card}]")
    if abs(ratio - 1) > FLAGSHIP_TOLERANCE:
        raise RuntimeError(f"phase 23: the baseline flagship line is "
                           f"{ratio:.3f}x phase 17's bench line")
    result["flagship_ratio"] = round(ratio, 4)

    # The module entry in its own process (the kernels already built).
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dcf_tpu_torch.cli", "dcf", "--backend",
         "walk"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or [json.loads(x)["bench"] for x in lines] \
            != ["dcf_gen", "dcf_eval_1pt"]:
        raise RuntimeError(f"phase 23 python -m dcf_tpu_torch.cli dcf: rc "
                           f"{proc.returncode}, stdout {proc.stdout!r}, "
                           f"stderr tail {proc.stderr[-2000:]!r}")
    result["module_entry_s"] = round(time.perf_counter() - t0, 1)
    log(f"phase 23 python -m dcf_tpu_torch.cli dcf --backend walk: exit 0, "
        f"{lines[1]} ({result['module_entry_s']} s)")

    # entry() on the card against B1's plain version on the same arrays.
    reset_counts()
    fn, example_args = entry()
    y = fn(*example_args)
    torch.cuda.synchronize()
    take_counts("cli_entry", {"B1": 1})
    want = walk_eval_plain(*example_args, b=0, group="xor")
    if not torch.equal(y, want):
        raise RuntimeError("phase 23 entry(): B1 differs from its plain "
                           "version")
    log(f"phase 23 entry(): fn(*example_args) {tuple(y.shape)} "
        f"{y.dtype} byte-identical to walk_eval_plain [{card}]")
    return result


#: Phase 24's runs of ``python -m dcf_tpu_torch.cli pod_bench`` on the card,
#: (name, argv), in groups: the runs of a group start together, and a
#: group starts when the one before it has ended.  The plain scenario on
#: ``prefix`` and ``--mesh`` run alone (their lines carry the door's rate,
#: ``pod_vs_single`` and the crossover ladder); the timer-bound scenarios
#: share the machine, and so do the plain scenario on ``walk`` (at short
#: legs, so that B1 runs in a shard too) and ``--surge``.  Widths are
#: dcf_tpu's defaults: Dcf(16, 16) (n = 128), 3 shards, max_batch 2^10,
#: the default ``--backend`` (``cpu``, which is ``walk`` on the card) in the
#: ``walk`` run,
#: requests of 3/8 to 1/2 of it, 8 bundles (plain) or 4 and 4 live ones,
#: the mesh ladder 128-8192 points.  Cuts from dcf_tpu's defaults: leg
#: lengths, --duration 30 s to 4 s (plain prefix), 2 s (plain walk) and
#: 8 s (surge: the ramp at its minimum 3 / 6 / 2 s); --eject-grace 3.0 s
#: to 1.5 s (churn); the cut windows of --partition and --flap floor at
#: 10 s whatever --duration says.  The surge's admission bound is 2048
#: points, not 4096: against shard processes on an H100 the parent's one
#: generator thread at 2.5x the calibrated rate never fills 4096 (no tick
#: of pressure, so no scale-out); and it has 8 bundles, not 4:
#: with key-0..3 the joined standby owns no key of the 4-host ring and
#: serves nothing.
POD_GROUPS = (
    (("prefix", ["--backend", "prefix", "--duration", "4"]),),
    (("mesh", ["--mesh", "--backend", "prefix"]),),
    (("partition", ["--partition", "--backend", "prefix"]),
     ("flap", ["--flap", "--backend", "prefix"]),
     ("churn", ["--churn", "--backend", "prefix", "--eject-grace", "1.5"])),
    (("walk", ["--duration", "2"]),
     ("surge", ["--surge", "--backend", "prefix", "--duration", "8",
                "--max-queued-points", "2048", "--bundles", "8"])),
)
#: dcf_tpu's two throughput gates of pod_bench that phase 24 reports and
#: does not require, as CLI_REPORTED does for phase 23 (ROADMAP.md Queue A
#: records them): pod_vs_single >= 2.2 and co-evaluation beating
#: route-mode by the ladder's top rung, both applied by the bench where the
#: host has shards + 1 CPUs.  The bench still exits non-zero for them; the
#: phase accepts that exit only when every failure it names is this gate.
POD_REPORTED = {"prefix": "the single-shard leg",
                "walk": "the single-shard leg",
                "mesh": "co-evaluate never beat route-mode"}
POD_RUN_TIMEOUT_S = 600


class _ShardWatch:
    """Polls a pod's directory while its ``pod_bench`` runs: every
    ``ready-<tag>.json`` a shard writes (its pid), whether that process
    holds the card's device file open (``/proc/<pid>/fd``), and the card's
    compute processes (``nvidia-smi --query-compute-apps=pid,
    used_memory``), so that each shard is seen holding a CUDA context
    while it serves."""

    def __init__(self, root: str):
        import threading

        self.root = root
        self.shards: dict = {}  # (tag, pid) -> first seen, s
        self.on_card: dict = {}  # pid -> largest used_memory seen, MiB
        self.holds_card: set = set()  # pids with /dev/nvidia<N> open
        # (ready shards, compute processes listed, their MiB) at the poll
        # with the most ready shards
        self.busiest = (0, 0, [])
        self.polls = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="shard-watch")

    def _poll(self) -> None:
        ready = 0
        for fname in os.listdir(self.root):
            if fname.startswith("ready-") and fname.endswith(".json"):
                try:
                    with open(os.path.join(self.root, fname)) as f:
                        pid = json.load(f)["pid"]
                except (OSError, ValueError, KeyError):
                    continue  # mid-rename or just removed: next poll
                ready += 1
                self.shards.setdefault((fname[6:-5], pid),
                                       time.perf_counter())
                if pid not in self.holds_card and _holds_card(pid):
                    self.holds_card.add(pid)
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60).stdout
        apps = [[x.strip() for x in line.split(",")]
                for line in out.strip().splitlines()]
        if ready > self.busiest[0] or (ready == self.busiest[0]
                                       and len(apps) > self.busiest[1]):
            self.busiest = (ready, len(apps),
                            sorted(int(m) for _p, m in apps if m.isdigit()))
        for pid, mem in apps:
            if pid.isdigit() and mem.isdigit():
                self.on_card[int(pid)] = max(int(mem),
                                             self.on_card.get(int(pid), 0))
        self.polls += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            self._poll()
            self._stop.wait(0.5)

    def start(self) -> "_ShardWatch":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(120)


def _holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a card's device file (``/dev/nvidia<N>``)
    open: the file a CUDA context maps."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            return True
    return False


def _stamped_lines(stream, sink: list) -> None:
    """Read ``stream`` to EOF into ``sink`` as (seconds, line) pairs."""
    for line in stream:
        sink.append((time.perf_counter(), line.rstrip("\n")))


def _start_pod_run(name: str, argv: list, repo: str) -> dict:
    """Start one ``pod_bench`` run on the card in a directory of its own,
    with its output read and its shards watched."""
    import tempfile
    import threading

    root = tempfile.mkdtemp(prefix=f"pod24-{name}-")
    cmd = [sys.executable, "-m", "dcf_tpu_torch.cli", "pod_bench", *argv,
           "--device", "cuda", "--store-dir", root]
    run = {"name": name, "argv": argv, "root": root, "cmd": cmd,
           "t0": time.perf_counter(), "out": [], "err": []}
    run["proc"] = subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
    run["readers"] = [
        threading.Thread(target=_stamped_lines, args=(stream, sink),
                         daemon=True)
        for stream, sink in ((run["proc"].stdout, run["out"]),
                             (run["proc"].stderr, run["err"]))]
    for r in run["readers"]:
        r.start()
    run["watch"] = _ShardWatch(root).start()
    return run


def _finish_pod_run(run: dict, card: str, pids_visible: bool,
                    out_dir: str, beside: list) -> dict:
    """Wait for a run started by ``_start_pod_run`` and hold it: its exit
    (only a ``POD_REPORTED`` gate may fail), its one line, every shard on
    the card and serving, no shard left running.  Its directory goes
    whatever the verdict.  Returns its numbers."""
    import shutil

    name, proc, watch = run["name"], run["proc"], run["watch"]
    try:
        proc.wait(POD_RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        watch.stop()
        for r in run["readers"]:
            r.join(60)
    try:
        return _hold_pod_run(run, card, pids_visible, out_dir, beside)
    finally:
        shutil.rmtree(run["root"], ignore_errors=True)


def _hold_pod_run(run: dict, card: str, pids_visible: bool, out_dir: str,
                  beside: list) -> dict:
    """The checks of ``_finish_pod_run`` on a run that has ended."""
    name, proc, watch = run["name"], run["proc"], run["watch"]
    t0 = run["t0"]
    secs = time.perf_counter() - t0
    err_lines, out_lines = run["err"], run["out"]
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase24_pod.log"), "a") as f:
            f.write(f"$ {' '.join(run['cmd'])}\n" + "".join(
                f"{t - t0:8.3f} {line}\n"
                for t, line in err_lines + out_lines))
    tail = "\n".join(line for _t, line in err_lines[-40:])
    # No shard outlives its pod_bench.
    alive = []
    for _tag, pid in watch.shards:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        alive.append(pid)
        os.kill(pid, 9)
    if alive:
        raise RuntimeError(f"phase 24 {name}: shard processes {alive} "
                           "outlived pod_bench")
    verdict = "passed"
    if proc.returncode != 0:
        # The bench's exit message, after its shards' last lines:
        # "pod_bench: <failure>; <failure>".
        failure = next((line for _t, line in reversed(err_lines)
                        if line.startswith(("pod_bench:",
                                            "pod_bench --mesh:"))), "")
        failures = failure.split(": ", 1)[-1].split("; ")
        if name not in POD_REPORTED or not failure or not all(
                POD_REPORTED[name] in f for f in failures):
            raise RuntimeError(f"phase 24 pod_bench {name}: exit "
                               f"{proc.returncode}; stderr tail:\n{tail}")
        verdict = f"reported, not met: {failure}"
    lines = [json.loads(line) for _t, line in out_lines]
    if len(lines) != 1:
        raise RuntimeError(f"phase 24 {name}: {len(lines)} lines; stderr "
                           f"tail:\n{tail}")
    rec = lines[0]
    missing = CLI_KEYS - set(rec)
    # Every run names its backend but ``walk``, which takes the default:
    # on the card that is B1's walk, never the host's C++ core.
    backend = (run["argv"][run["argv"].index("--backend") + 1]
               if "--backend" in run["argv"] else "walk")
    if missing or not rec["value"] > 0 or rec["device"] != card \
            or rec["platform"] != "cuda" or rec["backend"] != backend:
        raise RuntimeError(f"phase 24 {name}: bad line {rec} (missing "
                           f"{missing})")
    if any(rec.get(k) for k in ("soak_mismatches", "soak_unaccounted",
                                "soak_refused_unhinted")):
        raise RuntimeError(f"phase 24 {name}: the ledger is not clean: "
                           f"{rec}")
    # Each shard: its process held the card while it served, and its final
    # snapshot counts batches (with its requests, points, points a batch
    # against max_batch and the mean occupancy of the padded batch, over
    # the whole run: the reading behind the coalescing window).  nvidia-smi's count of compute processes is logged only:
    # the runs of a group share the card, and the machine names every
    # process pid 1, so the count cannot be matched to one run's shards.
    if not watch.shards:
        raise RuntimeError(f"phase 24 {name}: no shard ready file seen")
    shards, batching = {}, {}
    for tag, pid in sorted(watch.shards):
        if pid not in watch.holds_card or (
                pids_visible and pid not in watch.on_card):
            raise RuntimeError(
                f"phase 24 {name}: shard {tag} (pid {pid}) never seen "
                f"holding the card ({watch.polls} polls; device file open: "
                f"{pid in watch.holds_card}; nvidia-smi pids "
                f"{sorted(watch.on_card)})")
        with open(os.path.join(run["root"], f"metrics-{tag}.json")) as f:
            snap = json.load(f)
        batches = snap.get("serve_batches_total", 0)
        if not batches > 0:
            raise RuntimeError(f"phase 24 {name}: shard {tag} served no "
                               "batch")
        shards[f"{tag}:{pid}"] = batches
        occ_n = snap.get("serve_batch_occupancy_count", 0)
        batching[tag] = {
            "requests": snap.get("serve_requests_total", 0),
            "points": snap.get("serve_points_total", 0),
            "batches": batches,
            "points_per_batch": snap.get("serve_points_total", 0) / batches,
            "mean_occupancy": (snap["serve_batch_occupancy_sum"] / occ_n
                               if occ_n else None)}
    ready, apps, mib = watch.busiest
    stamps = {}
    for t, line in err_lines:
        for key, mark in (("kill", "SIGKILL "), ("ejected", "auto-eject OK")):
            if line.startswith(mark) and key not in stamps:
                stamps[key] = t
    entry = {"seconds": round(secs, 1), "gates": verdict,
             "value": rec["value"], "unit": rec["unit"],
             "shard_batches": shards, "shard_batching": batching,
             "compute_apps_with_shards_ready": [apps, ready],
             "compute_apps_MiB": mib}
    if beside:
        entry["beside"] = beside
    if "kill" in stamps and "ejected" in stamps:
        # The kill to the eject's log line: DOWN detection, the grace, the
        # migration, the commit and the survivors' digests.
        entry["kill_to_eject_logged_s"] = round(
            stamps["ejected"] - stamps["kill"], 3)
    for k in ("pod_vs_single", "single_shard_evals_per_sec", "p50_s",
              "p99_s", "critical_within_s", "soak_sessions_ok",
              "soak_refused_hinted", "reaction_s", "calibrated_rps",
              "offered_rps", "capacity_events", "crossover_points",
              "coeval_vs_route_at_top", "ladder", "promoted_serve_s",
              "epochs", "membership_events", "cut_s", "soak_wall_s",
              "pod_critical_shed", "critical_hb_ok", "shed", "failed"):
        if k in rec:
            entry[k] = rec[k]
    log(f"phase 24 pod_bench {name} ({' '.join(run['argv'])}"
        + (f"; beside {', '.join(beside)}" if beside else "")
        + f"): gates {verdict}; {rec['value']:,} {rec['unit']}; "
        f"{len(shards)} shard processes, each holding the card and "
        f"serving (batches {json.dumps(shards)}; requests, points, "
        f"batches and mean occupancy {json.dumps(batching)}; nvidia-smi "
        f"listed {apps} compute processes with {ready} shards of this run "
        f"ready, MiB {mib}); "
        f"{secs:.1f} s; the "
        "shards' launches run in their own processes, outside this "
        f"script's counters [{card}]")
    log(f"phase 24 RESULTS {name}: " + json.dumps(rec))
    return entry


def pod_phase(card: str, groups=POD_GROUPS) -> dict:
    """Phase 24: ``pod_bench``'s scenarios through ``python -m
    dcf_tpu_torch.cli`` on the card, each shard a process of its own.
    Raises on any failure but a ``POD_REPORTED`` gate; returns the
    numbers the phase logged."""
    import shutil

    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(repo, "chiprun_out")
    if os.path.isdir(out_dir):
        open(os.path.join(out_dir, "phase24_pod.log"), "w").close()
    # Does nvidia-smi name this process (a CUDA context since phase 1)?
    # Where the machine's PID namespace hides it, a shard's pid is held by
    # its open device file.
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout
    pids_visible = str(os.getpid()) in {
        line.split(",")[0].strip() for line in apps.strip().splitlines()}
    log(f"phase 24: nvidia-smi --query-compute-apps lists {apps.strip()!r}; "
        f"this process is pid {os.getpid()}, "
        + ("named there" if pids_visible else
           "not named there (the machine's PID namespace): a shard's pid is "
           "held by /proc/<pid>/fd holding /dev/nvidia<N>"))
    result = {}
    for group in groups:
        runs = [_start_pod_run(name, argv, repo) for name, argv in group]
        names = [r["name"] for r in runs]
        try:
            for run in runs:
                result[run["name"]] = _finish_pod_run(
                    run, card, pids_visible, out_dir,
                    [n for n in names if n != run["name"]])
        finally:
            for run in runs:
                if run["proc"].poll() is None:
                    run["proc"].kill()
                    run["proc"].wait(60)
                run["watch"].stop()
                shutil.rmtree(run["root"], ignore_errors=True)
    return result



#: Phase 25: the multi-device tier.  (a) every sharded class on the real
#: mesh (make_mesh(): one position on one H100) at the main paths' full
#: widths, byte-equal to the unsharded backends in the same call; (b) the
#: same widths on virtual meshes over one card, shaped by path as
#: dcf_tpu shapes them (prefix 1 x N, keylanes and the keyed walk N x 1,
#: the hybrid 2 x 2, the full-domain trees on all positions); (c) the pod
#: mesh in two processes over gloo and in one over nccl; (d) the CLI's
#: mesh routes and the dry run.
MESH_KEYS = 4  # keys of the walk paths (the keyed walk's 4 x 1 shards)
MESH_HYBRID_KEYS = 2  # keys of the hybrid paths (the 2 x 2 mesh's keys axis)
MESH_VIRTUAL = {"walk": (4, 1), "walk32": (4, 1), "prefix": (1, 4),
                "hybrid": (2, 2),
                "hybrid prefix": (2, 2), "keylanes": (4, 1),
                "full domain": (2, 2), "dpf": (2, 2)}
K_MESH_RELU = 1 << 18  # config 5's shape at baseline's default key count
MESH_WALL_REPS = 3
POD_NPROC = 2  # processes of the gloo pod mesh, each with half the points
POD_TIMEOUT_S = 300
#: The CLI's mesh routes and the launches one run of each makes on the
#: one card's 1 x 1 mesh, at the CLI's default ``--reps``.  One position
#: launches what the unsharded route does (phase 23 holds its walk and
#: hybrid lines to the same B1 and B5a / B5b / W1 counts); the tree's
#: B2 takes 5 launches (levels 6-20, three a launch) to each B2f.
MESH_CLI_RUNS = (
    ("sharded_pallas", ["dcf_batch_eval", "--backend", "sharded-pallas",
                        "--check"], {"B1": 8}),
    ("relu_sharded_pallas", ["secure_relu", "--backend", "sharded-pallas",
                             "--mesh", "1x1"], {"B8": 8}),
    ("tree_mesh", ["full_domain", "--backend", "tree", "--mesh", "1x1"],
     {"B2": 40, "B2f": 8}),
    ("hybrid_prefix_mesh", ["dcf_large_lambda", "--backend", "hybrid",
                            "--lam", str(LAM_WIDE), "--prefix-levels",
                            str(K_HYBRID), "--mesh", "1x1", "--check"],
     {"B5a": 18, "B5b": 8, "W1": 8}),
)


def _pod_material(m: int = M_MAIN, nb: int = N_BYTES):
    """The pod leg's seeded key (lam = 256, one key, n = 128, the host
    walk) and its ``m`` shared points: every process makes the same."""
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.spec import Bound

    rng = np.random.default_rng(SEED + 25)
    ck = [rng.bytes(32) for _ in range(2 * (LAM_WIDE // 16))]
    alphas = rng.integers(0, 256, (1, nb), dtype=np.uint8)
    betas = rng.integers(0, 256, (1, LAM_WIDE), dtype=np.uint8)
    bundle = gen_batch(HirosePrgNp(LAM_WIDE, ck, warn=False), alphas, betas,
                       random_s0s(1, LAM_WIDE, rng), Bound.LT_BETA)
    xs = rng.integers(0, 256, (m, nb), dtype=np.uint8)
    return ck, alphas, betas, bundle, xs


def _pod_mesh_worker(port: int, nproc: int, pid: int, backend: str,
                     device: str = "cuda", m: int = M_MAIN,
                     nb: int = N_BYTES) -> None:
    """One process of phase 25 (c): joins the group, evaluates its slice
    of the pod leg's points with ``MeshLargeLambdaBackend`` (B4 + W1),
    both parties, and prints one JSON line: the group-wide two-party
    count, the digest of each party's slice bytes, and the seconds of its
    legs."""
    import hashlib

    import torch
    import torch.distributed as dist

    from dcf_tpu_torch.parallel import MeshLargeLambdaBackend, make_pod_mesh
    from dcf_tpu_torch.parallel._compat import distributed_initialize

    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.set_device(0)
    distributed_initialize(f"127.0.0.1:{port}", nproc, pid, backend=backend,
                           timeout_s=120)
    try:
        t_init = time.perf_counter() - t0
        ck, alphas, betas, bundle, xs = _pod_material(m, nb)
        mesh = make_pod_mesh(device=device)
        m_local = xs.shape[0] // nproc
        xs_local = xs[pid * m_local:(pid + 1) * m_local]
        bes = [MeshLargeLambdaBackend(LAM_WIDE, ck, mesh) for _ in (0, 1)]
        for b in (0, 1):
            bes[b].put_bundle(bundle.for_party(b))
        staged = bes[0].stage(xs_local)
        if device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ys = [bes[b].eval_staged(b, staged) for b in (0, 1)]
        count = int(bes[0].points_mismatch_count(
            ys[0], ys[1], alphas, betas, staged))
        t_eval = time.perf_counter() - t1
        digests = [hashlib.sha256(bes[b].staged_to_bytes(
            ys[b], staged["m"]).tobytes()).hexdigest() for b in (0, 1)]
        print(json.dumps({"pid": pid, "backend": backend, "count": count,
                          "digests": digests, "mesh": mesh.shape,
                          "device": str(mesh.devices[0, pid]),
                          "init_s": round(t_init, 3),
                          "eval_and_count_s": round(t_eval, 3)}),
              flush=True)
    finally:
        dist.destroy_process_group()


def _start_pod_workers(nproc: int, backend: str, repo: str,
                       device: str = "cuda", m: int = M_MAIN,
                       nb: int = N_BYTES) -> list:
    """Start ``nproc`` ``_pod_mesh_worker`` processes, one group on a
    free loopback port; ``_pod_worker_lines`` collects them."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("DCF_CPU_DEVICES", None)
    return [subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke._pod_mesh_worker("
         f"{port}, {nproc}, {pid}, {backend!r}, {device!r}, {m}, {nb})"],
        cwd=repo, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(nproc)]


def _pod_worker_lines(procs: list) -> list:
    """Each worker's JSON line; a worker is killed at its time limit, a
    failed one raises, and none outlives the call."""
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=POD_TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"phase 25 pod worker exit "
                                   f"{p.returncode}: {err[-3000:]}")
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
    return lines


def _instances(mesh) -> int:
    """Backend instances a sharded class holds on ``mesh``: one a (key
    shard, distinct device), each building its own frontier."""
    return len({(i, d) for (i, _j), d in np.ndenumerate(mesh.devices)})


def mesh_phase(card: str, reset_counts, take_counts) -> dict:
    """Phase 25: the multi-device tier (``dcf_tpu_torch.parallel``) on the
    card, legs (a)-(d).  Raises on any failure; returns the numbers the
    phase logged.  ``entry.dryrun_multichip(4)`` runs last, alone: its
    subprocess would share the host and the card with the legs whose
    walls are logged."""
    import contextlib
    import hashlib
    import io

    import torch

    from dcf_tpu_torch import Bound, cli
    from dcf_tpu_torch.backends.evalall import DpfEvalAll
    from dcf_tpu_torch.backends.fulldomain import TreeFullDomain
    from dcf_tpu_torch.backends.keylanes_backend import KeyLanesBackend
    from dcf_tpu_torch.backends.large_lambda import LargeLambdaBackend
    from dcf_tpu_torch.backends.prefix_backend import PrefixBackend
    from dcf_tpu_torch.backends.walk_backend import WalkBackend
    from dcf_tpu_torch.gen import gen_batch, gen_on_device, random_s0s
    from dcf_tpu_torch.ops._launch import launch_depths
    from dcf_tpu_torch.ops.hybrid_prefix import frontier_launches
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.parallel import (
        Mesh, ShardedDpfEvalAll, ShardedKeyLanesBackend,
        ShardedLargeLambdaBackend, ShardedPrefixBackend,
        ShardedTreeFullDomain, ShardedWalkBackend, make_mesh)
    from dcf_tpu_torch.entry import dryrun_multichip
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch

    dev = torch.device("cuda", 0)
    repo = os.path.dirname(os.path.abspath(__file__))
    sync = torch.cuda.synchronize

    def wall_ms(fn, reps: int = MESH_WALL_REPS) -> float:
        times = []
        for _ in range(reps):
            sync()
            t1 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(times))

    real = make_mesh()
    if real.size != torch.cuda.device_count():
        raise RuntimeError(f"phase 25: make_mesh() {real} does not cover "
                           f"the {torch.cuda.device_count()} cards")
    n_real = real.size

    def virtual(shape):
        return Mesh([[dev] * shape[1] for _ in range(shape[0])])

    def same_blocks(what: str, y, ref, m: int) -> None:
        """Every real (key, point) of the sharded result ``y`` equals the
        unsharded ``ref`` [K, M_pad, lam], compared on the device."""
        k0 = 0
        for blks, r in zip(y.blocks, y.rows):
            p0 = 0
            for blk in blks:
                w = min(blk.shape[1], max(0, m - p0))
                if w and not torch.equal(
                        blk[:r, :w], ref[k0:k0 + r, p0:p0 + w].to(
                            blk.device)):
                    raise RuntimeError(f"phase 25 {what}: a shard differs "
                                       "from the unsharded result")
                p0 += blk.shape[1]
            k0 += r
        if k0 != ref.shape[0]:
            raise RuntimeError(f"phase 25 {what}: {k0} keys, want "
                               f"{ref.shape[0]}")

    rng = np.random.default_rng(SEED + 26)
    result = {}

    def keys_of(lam, k_num, ck):
        alphas = rng.integers(0, 256, (k_num, N_BYTES), dtype=np.uint8)
        betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
        bundle = gen_batch(HirosePrgNp(lam, ck, warn=False), alphas, betas,
                           random_s0s(k_num, lam, rng), Bound.LT_BETA)
        xs = rng.integers(0, 256, (M_MAIN, N_BYTES), dtype=np.uint8)
        xs[0] = alphas[0]  # x = alpha
        return alphas, betas, bundle, xs

    def staged_path(name, make_one, make_sharded, bundle, alphas, betas, xs,
                    want, k_num):
        """One staged path: the unsharded backends, then the real and the
        virtual mesh, both parties over one staged batch each, every
        block equal to the unsharded shares, 0 two-party mismatches; the
        launches of each mesh run counted; the walls of one eval_staged
        (party 0) side by side."""
        ones = [make_one() for _ in (0, 1)]
        for b in (0, 1):
            ones[b].put_bundle(bundle.for_party(b))
        st = ones[0].stage(xs)
        ref = [ones[b].eval_staged(b, st) for b in (0, 1)]
        single = k_num == 1
        a_, b_ = ((alphas[0].tobytes(), betas[0].tobytes()) if single
                  else (alphas, betas))
        if int(ones[0].points_mismatch_count(ref[0], ref[1], a_, b_, st)):
            raise RuntimeError(f"phase 25 {name}: the unsharded path "
                               "mismatches")
        res = {"unsharded_ms": wall_ms(lambda: ones[0].eval_staged(0, st))}
        for tag, mesh in (("real", real),
                          ("virtual", virtual(MESH_VIRTUAL[name]))):
            shape = tuple(mesh.devices.shape)
            bes = [make_sharded(mesh) for _ in (0, 1)]
            for b in (0, 1):
                bes[b].put_bundle(bundle.for_party(b))
            reset_counts()
            sst = bes[0].stage(xs)
            ys = [bes[b].eval_staged(b, sst) for b in (0, 1)]
            mism = int(bes[0].points_mismatch_count(ys[0], ys[1], a_, b_,
                                                    sst))
            sync()
            path = f"mesh {name} {shape[0]}x{shape[1]}"
            take_counts(path, want(shape, mesh))
            if mism:
                raise RuntimeError(f"phase 25 {path}: {mism} two-party "
                                   "mismatches")
            for b in (0, 1):
                same_blocks(f"{path} party {b}", ys[b], ref[b],
                            xs.shape[0])
            res[f"{tag} {shape[0]}x{shape[1]}_ms"] = wall_ms(
                lambda: bes[0].eval_staged(0, sst))
            del ys, bes, sst
        log(f"phase 25 {name}: K={k_num}, {xs.shape[0]} points, "
            f"n={8 * N_BYTES}, "
            "both parties byte-equal to the unsharded backend on every "
            "mesh, 0 two-party mismatches; one eval_staged wall (ms, "
            f"median of {MESH_WALL_REPS}): {json.dumps(res)} [{card}]")
        del ref, ones
        torch.cuda.empty_cache()
        return res

    t0 = time.perf_counter()
    wck = [rng.bytes(32) for _ in range(2 * (LAM_WIDE // 16))]
    ck16 = wck[:2]
    ck32 = wck[:18]
    # (a) + (b): the walk at lam = 16 and 32 (B1, E1), 4 keys.
    for name, lam, ck, kid in (("walk", 16, ck16, "B1"),
                               ("walk32", 32, ck32, "E1")):
        alphas, betas, bundle, xs = keys_of(lam, MESH_KEYS, ck)
        result[name] = staged_path(
            name, lambda: WalkBackend(lam, ck, device=dev),
            lambda mesh: ShardedWalkBackend(lam, ck, mesh), bundle, alphas,
            betas, xs, lambda shape, mesh: {kid: 2 * shape[0] * shape[1]},
            MESH_KEYS)
    # The prefix walk (B2 + B3), one key, k = 21: one frontier a distinct
    # device and party.
    alphas, betas, bundle, xs = keys_of(16, 1, ck16)
    n_b2 = len(launch_depths(HOST_LEVELS, min(21, 8 * N_BYTES - 8)))
    result["prefix"] = staged_path(
        "prefix", lambda: PrefixBackend(16, ck16, device=dev),
        lambda mesh: ShardedPrefixBackend(16, ck16, mesh), bundle, alphas,
        betas, xs,
        lambda shape, mesh: {"B2": 2 * n_b2 * _instances(mesh),
                             "B3": 2 * shape[0] * shape[1]}, 1)
    # The hybrid at lam = 256, 2 keys: from the root (B4 + W1) and with
    # prefix_levels = 20 (B5a + B5b + W1; k shrinks with the keys a
    # shard holds).
    alphas, betas, bundle, xs = keys_of(LAM_WIDE, MESH_HYBRID_KEYS, wck)
    result["hybrid"] = staged_path(
        "hybrid", lambda: LargeLambdaBackend(LAM_WIDE, wck, device=dev),
        lambda mesh: ShardedLargeLambdaBackend(LAM_WIDE, wck, mesh), bundle,
        alphas, betas, xs,
        lambda shape, mesh: {"B4": 2 * shape[0] * shape[1],
                             "W1": 2 * shape[0] * shape[1]},
        MESH_HYBRID_KEYS)

    def b5a_launches(shape, mesh):
        per = MESH_HYBRID_KEYS // shape[0]
        k = max(min(K_HYBRID, 8 * N_BYTES - 8,
                    20 - (per - 1).bit_length()), 5)
        builds = 2 * _instances(mesh)
        return {"B5a": builds * (1 + len(frontier_launches(k)[1])),
                "B5b": 2 * shape[0] * shape[1],
                "W1": 2 * shape[0] * shape[1]}

    result["hybrid prefix"] = staged_path(
        "hybrid prefix",
        lambda: LargeLambdaBackend(LAM_WIDE, wck, prefix_levels=K_HYBRID,
                                   device=dev),
        lambda mesh: ShardedLargeLambdaBackend(LAM_WIDE, wck, mesh,
                                               prefix_levels=K_HYBRID),
        bundle, alphas, betas, xs, b5a_launches, MESH_HYBRID_KEYS)
    del bundle, xs

    # Config 5's shape on B8: 2^18 keys (G1) x 1024 points.
    alphas = rng.integers(0, 256, (K_MESH_RELU, N_BYTES), dtype=np.uint8)
    betas = rng.integers(0, 256, (K_MESH_RELU, 16), dtype=np.uint8)
    kl_bundle = gen_on_device(16, ck16, alphas, betas,
                              random_s0s(K_MESH_RELU, 16, rng),
                              Bound.LT_BETA, device=dev)
    xs_kl = rng.integers(0, 256, (M_RELU, N_BYTES), dtype=np.uint8)
    one = KeyLanesBackend(16, ck16, device=dev)
    one.put_bundle(kl_bundle)
    st = one.stage(xs_kl)
    ref = [one.eval_staged(b, st) for b in (0, 1)]
    if int(one.relu_mismatch_count(ref[0], ref[1], alphas, betas, st)):
        raise RuntimeError("phase 25 keylanes: the unsharded path mismatches")
    kl_res = {"unsharded_ms": wall_ms(lambda: one.eval_staged(0, st), 1)}
    moved = alphas.copy()
    moved[0] = 0xFF  # key 0's alpha at the top: its points above alpha count
    for tag, mesh in (("real", real), ("virtual",
                                       virtual(MESH_VIRTUAL["keylanes"]))):
        shape = tuple(mesh.devices.shape)
        kl = ShardedKeyLanesBackend(16, ck16, mesh)
        kl.put_bundle(kl_bundle)
        reset_counts()
        sst = kl.stage(xs_kl)
        ys = [kl.eval_staged(b, sst) for b in (0, 1)]
        mism = int(kl.relu_mismatch_count(ys[0], ys[1], alphas, betas, sst))
        sync()
        path = f"mesh keylanes {shape[0]}x{shape[1]}"
        take_counts(path, {"B8": 2 * shape[0] * shape[1]})
        control = int(kl.relu_mismatch_count(ys[0], ys[1], moved, betas,
                                             sst))
        if mism or control < 1:
            raise RuntimeError(f"phase 25 {path}: {mism} mismatches (want "
                               f"0), the moved-alpha control {control} "
                               "(want >= 1)")
        for b in (0, 1):
            same_blocks(f"{path} party {b}", ys[b], ref[b], M_RELU)
        kl_res[f"{tag} {shape[0]}x{shape[1]}_ms"] = wall_ms(
            lambda: kl.eval_staged(0, sst), 1)
        kl_res[f"{tag} moved-alpha control"] = control
        del ys, kl, sst
    log(f"phase 25 keylanes: K={K_MESH_RELU} (G1) x {M_RELU} points, both "
        "parties byte-equal to KeyLanesBackend on every mesh, 0 "
        "mismatches, the moved-alpha control counted; one eval_staged "
        f"wall (ms): {json.dumps(kl_res)} [{card}]")
    result["keylanes"] = kl_res
    del ref, one, kl_bundle, st
    torch.cuda.empty_cache()

    # The full-domain tree (B2 + B2f, n = 24) and DPF EvalAll (B6, n = 24,
    # K = 4): 0 clean, and the unsharded count with a planted beta flip.
    fd_res = {}
    alpha = int(rng.integers(0, 1 << N_FULL))
    beta = rng.integers(0, 256, (1, 16), dtype=np.uint8)
    fb = gen_batch(HirosePrgNp(16, ck16), np.frombuffer(
        alpha.to_bytes(N_FULL // 8, "big"), dtype=np.uint8)[None].copy(),
        beta, random_s0s(1, 16, rng), Bound.LT_BETA)
    beta = beta[0].tobytes()
    wrong = bytes(x ^ 0x80 for x in beta)
    tree = TreeFullDomain(16, ck16, host_levels=HOST_LEVELS, device=dev)
    want_wrong = tree.check(fb, alpha, wrong, N_FULL)
    fd_res["unsharded_ms"] = wall_ms(
        lambda: tree.check_device(fb, alpha, beta, N_FULL))
    dpf_alphas = [int(a) for a in rng.integers(0, 1 << N_FULL, K_DPF)]
    dpf_betas = rng.integers(0, 256, (K_DPF, 32), dtype=np.uint8)
    db = dpf_gen_batch(
        HirosePrgNp(32, ck32, warn=False),
        np.array([list(a.to_bytes(N_FULL // 8, "big")) for a in dpf_alphas],
                 dtype=np.uint8), dpf_betas, random_s0s(K_DPF, 32, rng))
    bad_betas = dpf_betas.copy()
    bad_betas[1, 7] ^= 0x01
    ev = DpfEvalAll(32, ck32, device=dev)
    dpf_wrong = ev.check(db, dpf_alphas, bad_betas, N_FULL)
    ev.invalidate()
    dpf_res = {"unsharded_ms": wall_ms(
        lambda: ev.check_device(db, dpf_alphas, dpf_betas, N_FULL))}
    if ev.check(db, dpf_alphas, dpf_betas, N_FULL) or dpf_wrong < 1 \
            or tree.check(fb, alpha, beta, N_FULL) or want_wrong != alpha:
        raise RuntimeError("phase 25: the unsharded full-domain checks "
                           "disagree with the planted counts")
    for tag, mesh in (("real", real), ("virtual",
                                       virtual(MESH_VIRTUAL["full domain"]))):
        shape = tuple(mesh.devices.shape)
        p_total = shape[0] * shape[1]
        fd = ShardedTreeFullDomain(16, ck16, mesh)
        k0 = fd._k0(N_FULL)
        last = N_FULL - min(3, N_FULL - k0)
        reset_counts()
        clean = int(fd.check_device(fb, alpha, beta, N_FULL))
        sync()
        path = f"mesh full domain tree {shape[0]}x{shape[1]}"
        take_counts(path, {"B2": 2 * p_total * len(launch_depths(k0, last)),
                           "B2f": 2 * p_total})
        got_wrong = fd.check(fb, alpha, wrong, N_FULL)
        if clean or got_wrong != want_wrong:
            raise RuntimeError(f"phase 25 {path}: {clean} clean (want 0), "
                               f"{got_wrong} planted (want {want_wrong})")
        fd_res[f"{tag} {shape[0]}x{shape[1]}_ms"] = wall_ms(
            lambda: fd.check_device(fb, alpha, beta, N_FULL))
        sev = ShardedDpfEvalAll(32, ck32, mesh)
        k0 = sev._k0(N_FULL)
        reset_counts()
        clean = int(sev.check_device(db, dpf_alphas, dpf_betas, N_FULL))
        sync()
        path = f"mesh dpf evalall {shape[0]}x{shape[1]}"
        take_counts(path, {"B6": 2 * p_total * len(launch_depths(
            k0, N_FULL))})
        sev.invalidate()
        got = sev.check(db, dpf_alphas, bad_betas, N_FULL)
        if clean or got != dpf_wrong:
            raise RuntimeError(f"phase 25 {path}: {clean} clean (want 0), "
                               f"{got} planted (want {dpf_wrong})")
        sev.invalidate()
        dpf_res[f"{tag} {shape[0]}x{shape[1]}_ms"] = wall_ms(
            lambda: sev.check_device(db, dpf_alphas, dpf_betas, N_FULL))
        del fd, sev
    log(f"phase 25 full domain: lam=16, n={N_FULL} (B2 + B2f) 0 clean and "
        f"{want_wrong} with a flipped beta bit on every mesh, the "
        f"unsharded count; DPF EvalAll lam=32, n={N_FULL}, K={K_DPF} (B6) 0 "
        f"clean and {dpf_wrong} with a flipped beta bit; check walls (ms): "
        f"tree {json.dumps(fd_res)}, dpf {json.dumps(dpf_res)} [{card}]")
    result["full domain"], result["dpf"] = fd_res, dpf_res
    del tree, ev
    result["a_b_s"] = round(time.perf_counter() - t0, 1)

    # (c) The pod mesh: two processes over gloo, each half the points, and
    # one process over nccl; each slice's bytes equal the unsharded
    # result's (by digest), the group-wide count 0 in every process.
    t0 = time.perf_counter()
    ck, alphas, betas, bundle, xs = _pod_material(M_MAIN, N_BYTES)
    one = LargeLambdaBackend(LAM_WIDE, ck, device=dev)
    ref = []
    for b in (0, 1):
        one.put_bundle(bundle.for_party(b))
        ref.append(one.staged_to_bytes(one.eval_staged(b, one.stage(xs)),
                                       xs.shape[0]))
    pod_res = {}
    # The gloo pair and the nccl process run at once (three processes on
    # the card); NCCL needs the card.
    legs = [(POD_NPROC, "gloo"), (1, "nccl")]
    started = []
    try:
        for nproc, backend in legs:
            started.append(_start_pod_workers(nproc, backend, repo,
                                              dev.type, M_MAIN, N_BYTES))
        outs = [_pod_worker_lines(procs) for procs in started]
    finally:
        for procs in started:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(60)
    for (nproc, backend), lines in zip(legs, outs):
        m_local = xs.shape[0] // nproc
        for line in lines:
            pid = line["pid"]
            want = [hashlib.sha256(np.ascontiguousarray(
                r[:, pid * m_local:(pid + 1) * m_local]).tobytes())
                .hexdigest() for r in ref]
            if line["count"] != 0 or line["digests"] != want:
                raise RuntimeError(f"phase 25 pod mesh {backend} process "
                                   f"{pid}: count {line['count']}, digests "
                                   "equal to the unsharded slice: "
                                   f"{line['digests'] == want}")
        pod_res[f"{backend} x{nproc}"] = [
            {k: ln[k] for k in ("pid", "device", "init_s",
                                "eval_and_count_s")} for ln in lines]
    del ref, one
    pod_res["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"phase 25 pod mesh: MeshLargeLambdaBackend lam={LAM_WIDE}, "
        f"{xs.shape[0]} points: {POD_NPROC} processes on the card over gloo "
        f"({xs.shape[0] // POD_NPROC} points each) and one over nccl, every "
        "slice's bytes equal to the unsharded result's, the group-wide "
        f"count 0 in every process: {json.dumps(pod_res)} [{card}]")
    result["pod"] = pod_res

    # (d) The CLI's mesh routes on the card, each line's own gates held;
    # a mesh larger than the host exits non-zero with make_mesh's text;
    # then, alone, the dry run over four positions on the card exits 0.
    t0 = time.perf_counter()
    cli_res = {}
    for name, argv, want in MESH_CLI_RUNS:
        out, err = io.StringIO(), io.StringIO()
        t1 = time.perf_counter()
        reset_counts()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                cli.main(argv)
            except SystemExit as e:
                raise RuntimeError(
                    f"phase 25 cli {' '.join(argv)}: exit {e.code}; stderr "
                    f"tail:\n{err.getvalue()[-3000:]}") from None
        ran = take_counts(f"cli_mesh_{name}", want)
        (rec,) = [json.loads(x) for x in out.getvalue().splitlines()]
        if not rec["value"] > 0 or rec["device"] != card:
            raise RuntimeError(f"phase 25 cli {name}: bad line {rec}")
        cli_res[name] = {"backend": rec["backend"], "value": rec["value"],
                         "unit": rec["unit"], "launches": ran,
                         "seconds": round(time.perf_counter() - t1, 1)}
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            cli.main(["full_domain", "--backend", "tree", "--mesh",
                      f"{2 * n_real}x2"])
            code = 0
        except SystemExit as e:
            code = e.code
    want_text = f"requested {4 * n_real} devices, have {n_real}"
    if code in (0, None) or want_text not in str(code):
        raise RuntimeError(f"phase 25 cli --mesh {2 * n_real}x2: exit "
                           f"{code!r}, want a non-zero exit naming "
                           f"{want_text!r}")
    cli_res["oversized_mesh"] = str(code)
    cli_res["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"phase 25 cli: {json.dumps(cli_res)} [{card}]")
    t0 = time.perf_counter()
    dryrun_multichip(4)  # raises RuntimeError if its subprocess fails
    cli_res["dryrun_multichip_4_s"] = round(time.perf_counter() - t0, 1)
    log(f"phase 25 dryrun_multichip(4): exit 0 in "
        f"{cli_res['dryrun_multichip_4_s']} s, four positions over the "
        f"{n_real} card(s) (its OK lines above) [{card}]")
    result["cli"] = cli_res
    return result


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

    def take_at_least(name: str, kernels) -> dict:
        """The launches of one run of path ``name`` since
        ``reset_counts``: each kernel of ``kernels`` must have launched
        at least once; the run's counts are kept under the path's
        name."""
        ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
        for k in kernels:
            if not ran.get(k):
                raise RuntimeError(f"{name}: kernel {k} was not launched "
                                   f"(launches {ran})")
            launches[k][name] = ran[k]
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
    # version there (its plain time at the M_CHECK-point check shape).
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

    # MIC at lam = 32: 8 intervals from a seed, n = 128, M_CHECK shared
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

    # -- phase 20: the serving tier on the card --------------------------------------
    t0 = time.perf_counter()
    serving = serving_phase(card, reset_counts, take_counts)
    log(f"phase 20 serving: " + json.dumps(
        {k: v for k, v in serving.items() if k != "image bytes"})
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 21: the network edge and the pod router on the card ------------------
    t0 = time.perf_counter()
    edge_pod = edge_pod_phase(card, reset_counts, take_counts)
    log("phase 21 edge and pod: " + json.dumps(edge_pod)
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 22: the pod's control plane and the lam >= 48 handoff ----------------
    t0 = time.perf_counter()
    control = control_plane_phase(card, reset_counts, take_counts)
    log("phase 22 control plane: " + json.dumps(control)
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 23: the bench CLI and the entry point on the card --------------------
    t0 = time.perf_counter()
    cli_res = cli_phase(card, reset_counts, take_at_least, take_counts, line)
    log("phase 23 cli: " + json.dumps(
        {k: v["seconds"] if isinstance(v, dict) else v
         for k, v in cli_res.items()})
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 24: the multi-process pod on the card -----------------------------
    torch.cuda.empty_cache()  # the shard processes share the card
    t0 = time.perf_counter()
    pod_res = pod_phase(card)
    log("phase 24 pod: " + json.dumps(
        {k: v["seconds"] for k, v in pod_res.items()})
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

    # -- phase 25: the multi-device tier on the card ------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_res = mesh_phase(card, reset_counts, take_counts)
    log("phase 25 mesh: " + json.dumps(
        {k: v.get("seconds", v) if isinstance(v, dict) else v
         for k, v in mesh_res.items() if k in ("a_b_s", "pod", "cli")})
        + f" ({time.perf_counter() - t0:.1f} s) [{card}]")

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
