"""Times kernels of this tree against the same kernels of another checkout
of the repository, in turns, on one GPU.

    mkdir -p _archive/other && git archive <commit> | tar -x -C _archive/other
    python3 chip_ab.py _archive/other walk_eval prefix_eval

Each NAME is a case of ``CASES``: the kernel source of
``dcf_tpu_torch._build.KERNELS`` it builds (``keygen_walk`` holds G1, B7a,
B7b and G2), its inputs at the main path's shape, made from a seed, and the
call of its wrapper.  A turn is a process of its own that imports the
package of one tree, so the wrapper of that tree launches the kernel of
that tree, built from its sources into its own gitignored
``dcf_tpu_torch/_build/``: any checkout whose wrapper takes the same
arguments can be compared, also one that computes the function with torch
ops where this tree has a kernel (its build skips the sources it does
not have).  A tree with no such wrapper at all (one from before the
kernel's slice) cannot run the case: time it against a copy of this
tree, whose turns give the call's noise.  Both trees are built first, at
the same time.
The turns run other, this, this, other.  A turn calls the wrapper once
untimed, then twice more with the first's outputs alive, so that no
allocation falls into the timed calls, then times it with
``chip_smoke.cuda_ms`` (CUDA events), and
reports a digest of the outputs, which must be equal in all four turns.
That a kernel equals its plain version is ``chip_smoke.py``'s check, not
this script's.

Prints the card's name and power limit, ptxas' registers and spills of
each build, one line per kernel, and a JSON line.  Exits non-zero without
CUDA, on a name with no case, and when the trees' outputs differ.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from chip_smoke import cuda_ms, log, nvidia_smi

SEED = 2027
THIS = Path(__file__).resolve().parent


def case_keylanes_eval(torch, dev):
    """B8 at one chunk of BASELINE.json config 5: 2^17 keys (from G1) x
    1024 shared points, n = 128, party 0."""
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.ops.keygen_walk import keygen_dcf16
    from dcf_tpu_torch.ops.keylanes_eval import keylanes_eval
    from dcf_tpu_torch.ops.walk_eval import aes_image

    rng = np.random.default_rng(SEED)
    k_num, m = 1 << 17, 1024
    aes = torch.from_numpy(aes_image(rng.bytes(32))).to(dev)
    alphas, betas, s0s = (torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
        rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
        random_s0s(k_num, 16, rng)))
    img = keygen_dcf16(aes, alphas, betas, s0s, lt=True)
    xs = torch.from_numpy(rng.integers(0, 256, (1, m, 16),
                                       dtype=np.uint8)).to(dev)
    return (f"K={k_num} M={m} n=128", 1,
            lambda: (keylanes_eval(aes, s0s, *img, xs, b=0),))


def case_keygen_walk(torch, dev):
    """G1 at config 5's keygen shape: 10^6 lam = 16 DCF keys, n = 128,
    LT_BETA; every byte of the keys."""
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.ops.keygen_walk import keygen_dcf16
    from dcf_tpu_torch.ops.walk_eval import aes_image

    rng = np.random.default_rng(SEED)
    k_num = 10**6
    aes = torch.from_numpy(aes_image(rng.bytes(32))).to(dev)
    ins = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
        rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
        random_s0s(k_num, 16, rng)))
    return (f"K={k_num} n=128 lam=16", 5,
            lambda: keygen_dcf16(aes, *ins, lt=True))


def _keygen_wide_inputs(torch, dev, lam: int, k_num: int):
    """A seeded key set of width lam, n = 128, k_num keys, LT_BETA, on the
    card: B7a's aes image, (alphas, betas, s0s) and the shape's name."""
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image

    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    ins = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
        rng.integers(0, 256, (k_num, lam), dtype=np.uint8),
        random_s0s(k_num, lam, rng)))
    return aes, ins, f"K={k_num} n=128 lam={lam}"


def _keygen_narrow(torch, dev, lam: int, k_num: int, reps: int):
    """B7a: the narrow 32 bytes of each row, cw_t and the trajectories
    (the rest of its rows is W2's)."""
    from dcf_tpu_torch.ops.keygen_walk import keygen_narrow

    aes, ins, shape = _keygen_wide_inputs(torch, dev, lam, k_num)

    def call():
        cw_s, cw_v, cw_t, np1, traj = keygen_narrow(aes, *ins, lt=True)
        return cw_s[..., :32], cw_v[..., :32], cw_t, np1[:, :32], traj

    return shape, reps, call


def _keygen_wide(torch, dev, lam: int, k_num: int, reps: int):
    """W2 (B7a's wide tail) on B7a's outputs, in place: bytes 32..lam-1
    of cw_s, cw_v and cw_np1."""
    from dcf_tpu_torch.ops.keygen_walk import keygen_narrow, keygen_wide_tail

    aes, ins, shape = _keygen_wide_inputs(torch, dev, lam, k_num)
    cw_s, cw_v, _, np1, traj = keygen_narrow(aes, *ins, lt=True)

    def call():
        keygen_wide_tail(cw_s, cw_v, np1, traj, *ins, lt=True)
        return cw_s[..., 32:], cw_v[..., 32:], np1[:, 32:]

    return shape, reps, call


def case_keygen_narrow(torch, dev):
    """B7a at config 4's width: lam = 256, K = 2^16, n = 128."""
    return _keygen_narrow(torch, dev, 256, 1 << 16, 5)


def case_keygen_wide(torch, dev):
    """W2 at config 4's width: lam = 256, K = 2^16, n = 128."""
    return _keygen_wide(torch, dev, 256, 1 << 16, 5)


def case_keygen_narrow_crate(torch, dev):
    """B7a at the reference crate's width: lam = 16384, K = 64."""
    return _keygen_narrow(torch, dev, 16384, 64, 10)


def case_keygen_wide_crate(torch, dev):
    """W2 at the reference crate's width: lam = 16384, K = 64."""
    return _keygen_wide(torch, dev, 16384, 64, 10)


def case_keygen_dpf(torch, dev):
    """B7b at the PIR path's keygen shape: 2^16 lam = 32 DPF keys,
    n = 24; every byte of the keys."""
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.ops.keygen_walk import keygen_dpf
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image

    rng = np.random.default_rng(SEED)
    k_num, n = 1 << 16, 24
    ck = [rng.bytes(32) for _ in range(18)]
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    ins = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, (k_num, n // 8), dtype=np.uint8),
        rng.integers(0, 256, (k_num, 32), dtype=np.uint8),
        random_s0s(k_num, 32, rng)))
    return f"K={k_num} n={n} lam=32", 20, lambda: keygen_dpf(aes, *ins)


def case_keygen_dcf32(torch, dev):
    """G2 at the lam = 32 keygen shape: 2^16 lam = 32 DCF keys, n = 128,
    LT_BETA; every byte of the keys."""
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.ops.keygen_walk import keygen_dcf32
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image

    rng = np.random.default_rng(SEED)
    k_num = 1 << 16
    ck = [rng.bytes(32) for _ in range(18)]
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    ins = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, (k_num, 16), dtype=np.uint8),
        rng.integers(0, 256, (k_num, 32), dtype=np.uint8),
        random_s0s(k_num, 32, rng)))
    return (f"K={k_num} n=128 lam=32", 20,
            lambda: keygen_dcf32(aes, *ins, lt=True))


def case_walk32_eval(torch, dev):
    """E1 at the lam = 32 main path's shape: one key, n = 128, 2^20
    shared points, party 0, XOR."""
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.walk32_eval import walk32_eval
    from dcf_tpu_torch.spec import Bound

    rng = np.random.default_rng(SEED)
    m = 1 << 20
    ck = [rng.bytes(32) for _ in range(18)]
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    kb = gen_batch(HirosePrgNp(32, ck, warn=False),
                   rng.integers(0, 256, (1, 16), dtype=np.uint8),
                   rng.integers(0, 256, (1, 32), dtype=np.uint8),
                   random_s0s(1, 32, rng), Bound.LT_BETA).for_party(0)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        kb.s0s[:, 0], kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1,
        rng.integers(0, 256, (1, m, 16), dtype=np.uint8)))
    return (f"lam=32 n=128 K=1 M={m}", 10,
            lambda: (walk32_eval(aes, *args, b=0, group="xor"),))


def _config4(torch, dev):
    """BASELINE.json config 4's inputs on the card: one lam = 256 key
    (n = 128, party 0's narrow arrays) and 2^20 random shared points."""
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.spec import Bound

    rng = np.random.default_rng(SEED)
    lam, m = 256, 1 << 20
    ck = [rng.bytes(32) for _ in range(2 * (lam // 16))]
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    kb = gen_batch(HirosePrgNp(lam, ck),
                   rng.integers(0, 256, (1, 16), dtype=np.uint8),
                   rng.integers(0, 256, (1, lam), dtype=np.uint8),
                   random_s0s(1, lam, rng), Bound.LT_BETA)
    xs = rng.integers(0, 256, (1, m, 16), dtype=np.uint8)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        kb.s0s[:, 0, :32], kb.cw_s[..., :32], kb.cw_v[..., :32], kb.cw_t,
        kb.cw_np1[:, :32], xs))
    return aes, args, lam, m


def case_narrow_walk(torch, dev):
    """B4 at BASELINE.json config 4's shape: lam = 256, n = 128, one key,
    2^20 points, party 0; y[:32] and the trajectory words."""
    from dcf_tpu_torch.ops.narrow_walk import narrow_walk

    aes, args, lam, m = _config4(torch, dev)

    def call():
        y, traj = narrow_walk(aes, *args, b=0, lam=lam)
        return y[..., :32], traj

    return f"lam={lam} n=128 K=1 M={m}", 10, call


def case_hybrid_prefix(torch, dev):
    """B5b at config 4's shape from the k = 20 frontier that kernel B5a
    builds (the hybrid's prefix_levels=20 path): lam = 256, n = 128, one
    key, 2^20 points, party 0; y[:32] and the trajectory words."""
    from dcf_tpu_torch.ops.hybrid_prefix import (
        hybrid_prefix_eval, narrow_frontier)

    aes, (s0, cw_s, cw_v, cw_t, np1, xs), lam, m = _config4(torch, dev)
    k = 20
    rows, words = narrow_frontier(aes, s0, cw_s, cw_v, cw_t, k=k, b=0)

    def call():
        y, traj = hybrid_prefix_eval(aes, rows, words, cw_s, cw_v, cw_t,
                                     np1, xs, k=k, lam=lam)
        return y[..., :32], traj

    return f"lam={lam} n=128 K=1 M={m} k={k}", 10, call


def case_hybrid_state(torch, dev):
    """B5a at config 4's prefix depth: the k = 20 narrow frontier of its
    lam = 256 key (n = 128), party 0; rows and words."""
    from dcf_tpu_torch.ops.hybrid_prefix import narrow_frontier

    aes, (s0, cw_s, cw_v, cw_t, _, _), lam, _ = _config4(torch, dev)
    k = 20
    return (f"lam={lam} n=128 K=1 k={k}", 10,
            lambda: narrow_frontier(aes, s0, cw_s, cw_v, cw_t, k=k, b=0))


def case_evalall_expand(torch, dev, want_y: bool = True):
    """B6 at the DPF EvalAll and PIR shape: K = 4 lam = 32 DPF keys,
    n = 24, party 0, levels 6-23 from the host's level-6 frontier (the
    smoke's phase 12); the leaf shares and t bytes."""
    from dcf_tpu_torch.backends.evalall import dpf_tree_expand_np
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.ops.evalall_expand import evalall_expand
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch

    rng = np.random.default_rng(SEED)
    k_num, n, k0 = 4, 24, 6
    ck = [rng.bytes(32) for _ in range(18)]
    prg = HirosePrgNp(32, ck, warn=False)
    kb = dpf_gen_batch(prg, rng.integers(0, 256, (k_num, n // 8),
                                         dtype=np.uint8),
                       rng.integers(0, 256, (k_num, 32), dtype=np.uint8),
                       random_s0s(k_num, 32, rng)).for_party(0)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    on = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        kb.cw_s, kb.cw_t, kb.cw_np1, *dpf_tree_expand_np(prg, kb, 0, k0))]
    if not want_y:  # the selection alone
        return (f"K={k_num} n={n} levels {k0}-{n - 1} t only", 5,
                lambda: evalall_expand(aes, *on, k0=k0, k1=n,
                                       want_y=False)[1:])
    return (f"K={k_num} n={n} levels {k0}-{n - 1}", 5,
            lambda: evalall_expand(aes, *on, k0=k0, k1=n))


def case_evalall_expand_t(torch, dev):
    """B6 as a PIR server runs it: ``case_evalall_expand``'s tree, the
    last launch writing the leaves' t bits alone (packed words since
    PR 11, t bytes before); the selection."""
    return case_evalall_expand(torch, dev, want_y=False)


def _flagship(torch, dev):
    """The flagship batch eval's inputs (bench.py:1-31): one lam = 16 key
    (n = 128) and 2^20 random shared points on the card, and the numpy
    key bundle (party 0)."""
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.walk_eval import aes_image
    from dcf_tpu_torch.spec import Bound

    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    kb = gen_batch(prg, rng.integers(0, 256, (1, 16), dtype=np.uint8),
                   rng.integers(0, 256, (1, 16), dtype=np.uint8),
                   random_s0s(1, 16, rng), Bound.LT_BETA).for_party(0)
    xs = rng.integers(0, 256, (1, 1 << 20, 16), dtype=np.uint8)
    on = {name: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for name, a in (("s0", kb.s0s[:, 0]), ("cw_s", kb.cw_s),
                          ("cw_v", kb.cw_v), ("cw_t", kb.cw_t),
                          ("cw_np1", kb.cw_np1), ("xs", xs))}
    return prg, kb, torch.from_numpy(aes_image(ck[0])).to(dev), on


def case_walk_eval(torch, dev):
    """B1 at the flagship shape: one key, n = 128, 2^20 shared points,
    XOR, party 0."""
    from dcf_tpu_torch.ops.walk_eval import walk_eval

    _, _, aes, on = _flagship(torch, dev)
    args = (aes, on["s0"], on["cw_s"], on["cw_v"], on["cw_t"],
            on["cw_np1"], on["xs"])
    return ("K=1 M=1048576 n=128", 10,
            lambda: (walk_eval(*args, b=0, group="xor"),))


def case_prefix_eval(torch, dev):
    """B3 at the flagship shape from the k = 21 frontier (the prefix
    backend's depth at 2^20 points), built by B2 from the host's top 6
    levels: one key, n = 128, 2^20 shared points, XOR, party 0."""
    from dcf_tpu_torch.backends.fulldomain import tree_expand_np
    from dcf_tpu_torch.ops.prefix_eval import frontier_table, prefix_eval
    from dcf_tpu_torch.ops.tree_expand import tree_expand

    prg, kb, aes, on = _flagship(torch, dev)
    k0, k = 6, 21
    top = (torch.from_numpy(a).to(dev) for a in tree_expand_np(prg, kb, 0, k0))
    table = frontier_table(*tree_expand(
        aes, on["cw_s"][0], on["cw_v"][0], on["cw_t"][0], *top, k0=k0, k1=k,
        group="xor"))
    args = (aes, table, on["cw_s"], on["cw_v"], on["cw_t"], on["cw_np1"],
            on["xs"])
    return (f"K=1 M=1048576 n=128 k={k}", 10,
            lambda: (prefix_eval(*args, k=k, negate=False, group="xor"),))


def _wide_xor(torch, dev, lam: int, m: int, reps: int):
    """W1 on one seeded key's B4 trajectories at width lam, n = 128, m
    shared points, party 0, in place: bytes 32..lam-1 of the shares."""
    from dcf_tpu_torch.backends.large_lambda import wide_affine_batch_np
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image, narrow_walk
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.wide_tail import wide_tail
    from dcf_tpu_torch.spec import Bound

    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    kb = gen_batch(HirosePrgNp(lam, ck, warn=False),
                   rng.integers(0, 256, (1, 16), dtype=np.uint8),
                   rng.integers(0, 256, (1, lam), dtype=np.uint8),
                   random_s0s(1, lam, rng), Bound.LT_BETA).for_party(0)
    xs = rng.integers(0, 256, (1, m, 16), dtype=np.uint8)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        kb.s0s[:, 0, :32], kb.cw_s[..., :32], kb.cw_v[..., :32], kb.cw_t,
        kb.cw_np1[:, :32], xs))
    y, traj = narrow_walk(aes, *args, b=0, lam=lam)
    wide = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in wide_affine_batch_np(kb))

    def call():
        wide_tail(y, traj, *wide)
        return (y[..., 32:],)

    return f"lam={lam} n=128 K=1 M={m}", reps, call


def case_wide_xor(torch, dev):
    """W1 at BASELINE.json config 4's shape: lam = 256, 2^20 points."""
    return _wide_xor(torch, dev, 256, 1 << 20, 10)


def case_wide_xor_crate(torch, dev):
    """W1 at the reference crate's large-lambda shape: lam = 16384,
    10,000 points."""
    return _wide_xor(torch, dev, 16384, 10_000, 10)


def _tree_levels(torch, dev, n: int, k0: int, k1: int, reps: int):
    """B2 over levels k0..k1-1 of one seeded lam = 16 key (n levels, XOR,
    party 0) from the host's level-k0 nodes; s, v and t of level k1."""
    from dcf_tpu_torch.backends.fulldomain import tree_expand_np
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.tree_expand import tree_expand
    from dcf_tpu_torch.ops.walk_eval import aes_image
    from dcf_tpu_torch.spec import Bound

    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    kb = gen_batch(prg, rng.integers(0, 256, (1, n // 8), dtype=np.uint8),
                   rng.integers(0, 256, (1, 16), dtype=np.uint8),
                   random_s0s(1, 16, rng), Bound.LT_BETA).for_party(0)
    aes = torch.from_numpy(aes_image(ck[0])).to(dev)
    cws = [torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
           for a in (kb.cw_s, kb.cw_v, kb.cw_t)]
    top = [torch.from_numpy(a).to(dev) for a in tree_expand_np(prg, kb, 0, k0)]
    return (f"n={n} levels {k0}-{k1 - 1}", reps,
            lambda: tree_expand(aes, *cws, *top, k0=k0, k1=k1, group="xor"))


def case_tree_expand(torch, dev):
    """B2 on the flagship prefix path: the k = 21 frontier of a lam = 16,
    n = 128 key, levels 6-20 from the host's top 6."""
    return _tree_levels(torch, dev, 128, 6, 21, 10)


def case_tree_expand_fd(torch, dev):
    """B2 on BASELINE.json config 3's full domain: levels 6-22 of an
    n = 24 key, as the path ran them before PR 11 (B2f then took level
    23; since, B2 runs 6-20 and B2f 21-23)."""
    return _tree_levels(torch, dev, 24, 6, 23, 5)


def _tree_key(torch, dev, n: int, k0: int):
    """One seeded lam = 16 XOR key of n levels (party 0, LT_BETA) on the
    card: the aes image, cw_s, cw_v, cw_t [n, ...], cw_np1 [16] and the
    host's level-k0 nodes."""
    from dcf_tpu_torch.backends.fulldomain import tree_expand_np
    from dcf_tpu_torch.gen import gen_batch, random_s0s
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.ops.walk_eval import aes_image
    from dcf_tpu_torch.spec import Bound

    rng = np.random.default_rng(SEED)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    kb = gen_batch(prg, rng.integers(0, 256, (1, n // 8), dtype=np.uint8),
                   rng.integers(0, 256, (1, 16), dtype=np.uint8),
                   random_s0s(1, 16, rng), Bound.LT_BETA).for_party(0)
    aes = torch.from_numpy(aes_image(ck[0])).to(dev)
    cws = [torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
           for a in (kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)]
    top = [torch.from_numpy(a).to(dev) for a in tree_expand_np(prg, kb, 0, k0)]
    return aes, cws, top


def case_tree_expand_final(torch, dev):
    """B2f on BASELINE.json config 3's full domain: level 23 of an n = 24
    key and the leaf finalize, from the level-23 nodes that B2 builds
    (levels 6-22, outside the timed call); the 2^24 leaf shares.  The
    one-level launch every tree has (the path's since PR 11 takes levels
    21-23: ``tree_expand_device``)."""
    from dcf_tpu_torch.ops.tree_expand import tree_expand, tree_expand_final

    n, k0 = 24, 6
    aes, (cw_s, cw_v, cw_t, np1), top = _tree_key(torch, dev, n, k0)
    nodes = tree_expand(aes, cw_s, cw_v, cw_t, *top, k0=k0, k1=n - 1,
                        group="xor")
    return (f"n={n} level {n - 1}", 10,
            lambda: (tree_expand_final(aes, cw_s[n - 1], cw_v[n - 1],
                                       cw_t[n - 1], np1, *nodes),))


def case_tree_expand_device(torch, dev):
    """The full-domain expansion of config 3 on the card, B2 and B2f as
    ``tree_expand_device`` cuts them: levels 6-23 of an n = 24 key from
    the host's top 6; the 2^24 leaf shares."""
    from dcf_tpu_torch.ops.tree_expand import tree_expand_device

    n, k0 = 24, 6
    aes, cws, top = _tree_key(torch, dev, n, k0)
    return (f"n={n} levels {k0}-{n - 1}", 5,
            lambda: (tree_expand_device(aes, *cws, *top, k0=k0, n=n),))


def case_pir_answer(torch, dev):
    """P1 at the PIR path's top shape: K = 4 queries over 2^24 records of
    32 bytes, each party-0 selection share made by the tree's own B6
    (levels 6-23 from the host's level-6 frontier, t alone), so each tree
    reads the selection in the form its B6 writes and its P1 takes (t
    bytes or packed words); the K answer shares."""
    from dcf_tpu_torch.backends.evalall import dpf_tree_expand_np
    from dcf_tpu_torch.gen import random_s0s
    from dcf_tpu_torch.ops.evalall_expand import evalall_expand
    from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
    from dcf_tpu_torch.ops.pir_answer import pir_answer
    from dcf_tpu_torch.ops.prg import HirosePrgNp
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch

    rng = np.random.default_rng(SEED)
    k_num, n, k0, r = 4, 24, 6, 32
    ck = [rng.bytes(32) for _ in range(18)]
    prg = HirosePrgNp(32, ck, warn=False)
    kb = dpf_gen_batch(prg, rng.integers(0, 256, (k_num, n // 8),
                                         dtype=np.uint8),
                       rng.integers(0, 256, (k_num, 32), dtype=np.uint8),
                       random_s0s(k_num, 32, rng)).for_party(0)
    aes = torch.from_numpy(narrow_aes_image(ck[0], ck[17])).to(dev)
    on = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        kb.cw_s, kb.cw_t, kb.cw_np1, *dpf_tree_expand_np(prg, kb, 0, k0))]
    _, sel = evalall_expand(aes, *on, k0=k0, k1=n, want_y=False)
    db = torch.from_numpy(rng.integers(0, 256, (1 << n, r),
                                       dtype=np.uint8)).to(dev)
    return (f"K={k_num} N=2^{n} R={r}", 10, lambda: (pir_answer(sel, db),))


# case name -> (the kernel source it builds, its inputs and call)
CASES = {"keylanes_eval": ("keylanes_eval", case_keylanes_eval),
         "keygen_walk": ("keygen_walk", case_keygen_walk),
         "keygen_narrow": ("keygen_walk", case_keygen_narrow),
         "keygen_wide": ("keygen_wide", case_keygen_wide),
         "keygen_narrow_crate": ("keygen_walk", case_keygen_narrow_crate),
         "keygen_wide_crate": ("keygen_wide", case_keygen_wide_crate),
         "keygen_dpf": ("keygen_walk", case_keygen_dpf),
         "keygen_dcf32": ("keygen_walk", case_keygen_dcf32),
         "hybrid_state": ("hybrid_state", case_hybrid_state),
         "narrow_walk": ("narrow_walk", case_narrow_walk),
         "hybrid_prefix": ("hybrid_prefix", case_hybrid_prefix),
         "evalall_expand": ("evalall_expand", case_evalall_expand),
         "evalall_expand_t": ("evalall_expand", case_evalall_expand_t),
         "walk_eval": ("walk_eval", case_walk_eval),
         "walk32_eval": ("walk32_eval", case_walk32_eval),
         "prefix_eval": ("prefix_eval", case_prefix_eval),
         "wide_xor": ("wide_xor", case_wide_xor),
         "wide_xor_crate": ("wide_xor", case_wide_xor_crate),
         "tree_expand": ("tree_expand", case_tree_expand),
         "tree_expand_fd": ("tree_expand", case_tree_expand_fd),
         "tree_expand_final": ("tree_expand", case_tree_expand_final),
         "tree_expand_device": ("tree_expand", case_tree_expand_device),
         "pir_answer": ("pir_answer", case_pir_answer)}


def _package(root: str):
    """Import ``root``'s dcf_tpu_torch; returns its ``_build``."""
    sys.path.insert(0, root)
    from dcf_tpu_torch import _build

    if not Path(_build.__file__).resolve().is_relative_to(Path(root)):
        raise RuntimeError(f"imported {_build.__file__}, not {root}'s")
    return _build


def build(root: str, names: list[str]) -> int:
    """Build the kernel sources ``names`` that ``root`` has from its
    sources; print a JSON line of each one's ptxas (registers, spill-store
    bytes)."""
    import re

    _build = _package(root)
    names = [name for name in names if name in _build.KERNELS]
    _build.build(names)
    print(json.dumps({name: (
        re.findall(r"Used (\d+) registers", _build.build_log(name)),
        re.findall(r"(\d+) bytes spill stores", _build.build_log(name)))
        for name in names}), flush=True)
    return 0


def turn(root: str, name: str) -> int:
    """One timed turn of kernel ``name`` from ``root``'s package; prints a
    JSON line with the shape, the mean ms and the outputs' digest."""
    import torch

    _package(root)
    shape, reps, call = CASES[name][1](torch, torch.device("cuda"))
    digest = hashlib.sha256()
    for t in call():
        digest.update(t.contiguous().cpu().numpy().tobytes())
    held = call()  # two calls' outputs alive at once, as in the timed
    call()  # loop, so that the allocator holds their memory before it
    del held
    ms, _ = cuda_ms(call, reps)
    print(json.dumps({"shape": shape, "ms": ms, "reps": reps,
                      "digest": digest.hexdigest()}), flush=True)
    return 0


def _last_json(cmd: list[str], timeout: int) -> dict:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args[:1] == ["--build"]:
        return build(args[1], args[2:])
    if args[:1] == ["--turn"]:
        return turn(args[1], args[2])
    from dcf_tpu_torch._build import KERNELS

    names = args[1:]
    if not names or not torch.cuda.is_available() or any(
            name not in CASES or CASES[name][0] not in KERNELS
            for name in names):
        print(f"usage: chip_ab.py OTHER_CHECKOUT NAME... (NAME in "
              f"{sorted(CASES)}; on a machine with CUDA)", file=sys.stderr)
        return 1
    sources = sorted({CASES[name][0] for name in names})
    trees = {"other": str(Path(args[0]).resolve()), "this": str(THIS)}
    card = nvidia_smi("name,power.limit")
    log(card)
    me = [sys.executable, str(Path(__file__).resolve())]
    builds = {tree: subprocess.Popen([*me, "--build", root, *sources],
                                     stdout=subprocess.PIPE, text=True)
              for tree, root in trees.items()}
    for tree, proc in builds.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"building {trees[tree]} failed")
        log(f"{tree} tree {trees[tree]}: (registers, spill-store bytes) "
            f"{out.strip().splitlines()[-1]}")
    result = {"card": card, "other": trees["other"]}
    for name in names:
        runs = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            runs[tree].append(_last_json(
                [*me, "--turn", trees[tree], name], 900))
        every = runs["other"] + runs["this"]
        if len({r["digest"] for r in every}) != 1:
            raise RuntimeError(f"{name}: the trees' outputs differ")
        times = {tree: [r["ms"] for r in rs] for tree, rs in runs.items()}
        result[name] = dict(times, shape=every[0]["shape"],
                            reps=every[0]["reps"])
        log(f"{name} at {every[0]['shape']}: other {times['other']} ms, "
            f"this {times['this']} ms, outputs equal [{card}]")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
