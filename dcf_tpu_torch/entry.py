"""The port's single-card entry point: ``entry(device=None)``.

Counterpart of ``__graft_entry__.entry`` (its lines 10-59): the flagship
forward step, party 0's from-root walk (kernel B1, ``ops.walk_eval``) at
n = 128 levels, lam = 16, over two keys with per-key points, on staged
device arrays — bytes in, bytes out.  On the card each key walks 4096
points; on the CPU, where B1's plain PyTorch version runs, 64.

    python -m dcf_tpu_torch.entry              # on the card
    python -m dcf_tpu_torch.entry --device cpu

prints ``entry OK: <shape> <dtype>``.

``dryrun_multichip(n_devices)`` (``__graft_entry__.py:62-371``) runs
every mesh-sharded class of ``dcf_tpu_torch.parallel`` once over an
``n_devices`` mesh laid over the host's cards (``device="cpu"``: CPU
positions), each a two-party reconstruction on a tiny shape, and prints
one ``dryrun_multichip OK [Class]: ...`` line each:

    python -c "from dcf_tpu_torch.entry import dryrun_multichip; \
               dryrun_multichip(4)"
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from functools import partial

import numpy as np

from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.spec import Bound

__all__ = ["entry", "dryrun_multichip", "_make_workload"]

M_CARD = 4096  # points a key on the card
M_CPU = 64  # points a key on the CPU


def _make_workload(num_keys: int, n_bytes: int, lam: int, m: int,
                   seed: int = 0):
    """The seeded flagship workload, draw for draw
    ``__graft_entry__._make_workload``'s: (cipher_keys, prg, alphas,
    betas, bundle, xs), xs per-key points uint8 [K, m, n_bytes]."""
    rng = np.random.default_rng(seed)
    cipher_keys = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(lam, cipher_keys)
    alphas = rng.integers(0, 256, (num_keys, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (num_keys, lam), dtype=np.uint8)
    bundle = gen_batch(prg, alphas, betas, random_s0s(num_keys, lam, rng),
                       Bound.LT_BETA)
    xs = rng.integers(0, 256, (num_keys, m, n_bytes), dtype=np.uint8)
    return cipher_keys, prg, alphas, betas, bundle, xs


def entry(device=None):
    """(fn, example_args): party 0's B1 walk and its staged arguments.

    ``fn(*example_args)`` returns the shares uint8 [K, M_pad, 16] on the
    device (asynchronously on the card); ``example_args`` are the AES
    image, the key image (s0, cw_s, cw_v, cw_t, cw_np1) and the per-key
    points, all on ``device`` (the card unless the caller asks for
    ``"cpu"``)."""
    from dcf_tpu_torch.backends.walk_backend import WalkBackend
    from dcf_tpu_torch.ops.walk_eval import walk_eval
    from dcf_tpu_torch.utils.provision import select_device

    dev = select_device(device)
    lam, n_bytes, k_num = 16, 16, 2
    m = M_CARD if dev.type == "cuda" else M_CPU
    cipher_keys, _prg, _a, _b, bundle, xs = _make_workload(
        k_num, n_bytes, lam, m)
    backend = WalkBackend(lam, cipher_keys, device=dev)
    backend.put_bundle(bundle.for_party(0))
    staged = backend.stage(xs)
    img = backend._bundle_dev
    fn = partial(walk_eval, b=0, group=bundle.group)
    example_args = (backend.aes, img["s0"], img["cw_s"], img["cw_v"],
                    img["cw_t"], img["cw_np1"], staged["xs"])
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every sharded class over an ``n_devices`` mesh once, in a
    fresh subprocess.  On the card by default: the host's cards are laid
    over the positions in turn (``_dryrun_mesh``), so a one-card host
    repeats ``cuda:0`` and the kernels themselves run.  ``device="cpu"``,
    the default where ``DCF_CPU_DEVICES`` is set, runs ``n_devices`` CPU
    positions (the kernels' plain versions; ``provision.
    force_cpu_devices``).  Raises ``RuntimeError`` if the subprocess
    fails (no card, where the card was asked for, included) or runs past
    900 s."""
    from dcf_tpu_torch.parallel.mesh import CPU_DEVICES_ENV
    from dcf_tpu_torch.utils.provision import force_cpu_devices

    if device is None:
        device = "cpu" if os.environ.get(CPU_DEVICES_ENV) else "cuda"
    if device not in ("cuda", "cpu"):
        # api-edge: documented device-selection contract
        raise ValueError(f"the dry run runs on cuda or cpu, not {device!r}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        force_cpu_devices(env, n_devices)
    else:
        env.pop(CPU_DEVICES_ENV, None)
    code = ("from dcf_tpu_torch.entry import _dryrun_multichip_impl; "
            f"_dryrun_multichip_impl({int(n_devices)}, {device!r})")
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              env=env, timeout=900)
    except subprocess.TimeoutExpired:
        # dcflint: disable=typed-error __graft_entry__.dryrun_multichip's
        # contract: a failed dry run is a RuntimeError
        raise RuntimeError("multichip dryrun subprocess timed out (900s)")
    if proc.returncode != 0:
        # dcflint: disable=typed-error the same contract
        raise RuntimeError(
            f"multichip dryrun subprocess failed (rc={proc.returncode})")


def _dryrun_mesh(n_devices: int, cards, shape=None):
    """A mesh of ``n_devices`` positions (``make_mesh``'s factorization
    unless ``shape`` pins one) with the devices ``cards`` laid over them
    in turn, row by row: one card fills every position, as many cards as
    positions give each its own."""
    from dcf_tpu_torch.parallel.mesh import Mesh, mesh_shape

    rows, cols = mesh_shape(n_devices) if shape is None else shape
    return Mesh([[cards[(i * cols + j) % len(cards)] for j in range(cols)]
                 for i in range(rows)])


def _dryrun_fail(msg: str) -> None:
    # dcflint: disable=typed-error a dry run's verdict: its subprocess
    # exits non-zero with the message
    raise SystemExit(msg)


def _dryrun_multichip_impl(n_devices: int, device: str = "cuda") -> None:
    """The body of the dry run over ``n_devices`` positions of
    ``device``, the host's cards or CPU positions: the legs
    of ``__graft_entry__._dryrun_multichip_impl``, each an end-to-end
    two-party reconstruction on a tiny shape, with the port's classes:

    * ``ShardedWalkBackend`` (``dcf_tpu``'s ``ShardedJaxBackend``,
      ``ShardedBitslicedBackend`` and ``ShardedPallasBackend``): LT_BETA
      and GT_BETA at per-key points;
    * ``ShardedKeyLanesBackend``: a key count ragged against 32 keys a
      shard, ragged points;
    * ``ShardedLargeLambdaBackend`` at lam = 48, the hybrid's edge;
    * ``ShardedPrefixBackend`` on a 1 x n mesh, ragged points;
    * ``ShardedTreeFullDomain`` and ``ShardedDpfEvalAll``: 0 on the
      true beta, the exact count on a corrupted one;
    * the ``Dcf`` facade's mesh routing;
    * negative controls: one corrupted correction word must fail the
      walk's, keylanes' and prefix's reconstructions.

    A failed check exits the subprocess non-zero (``SystemExit``)."""
    import warnings

    from dcf_tpu_torch import Dcf
    from dcf_tpu_torch.keys import KeyBundle
    from dcf_tpu_torch.parallel import (
        ShardedDpfEvalAll,
        ShardedKeyLanesBackend,
        ShardedLargeLambdaBackend,
        ShardedPrefixBackend,
        ShardedTreeFullDomain,
        ShardedWalkBackend,
        make_mesh,
    )
    from dcf_tpu_torch.protocols.dpf import dpf_gen_batch
    from dcf_tpu_torch.spec import ReferenceContractWarning

    if device == "cpu":
        cards = make_mesh(n_devices, device="cpu").devices.reshape(-1)
    else:
        cards = make_mesh(device="cuda").devices.reshape(-1)
    mesh = _dryrun_mesh(n_devices, cards)
    ksize, psize = mesh.shape["keys"], mesh.shape["points"]
    lam, n_bytes = 16, 2
    k_num, m = 2 * ksize, 2 * psize
    rng = np.random.default_rng(1)
    cipher_keys, prg, alphas, betas, bundle, xs = _make_workload(
        k_num, n_bytes, lam, m, seed=1)
    gt_bundle = gen_batch(prg, alphas, betas, random_s0s(k_num, lam, rng),
                          Bound.GT_BETA)

    def check_recon(recon, xs_of, name, alphas_=None, betas_=None,
                    gt=False, lam_=lam, expect_bad=0):
        a_arr = alphas if alphas_ is None else alphas_
        b_arr = betas if betas_ is None else betas_
        bad = 0
        for i in range(a_arr.shape[0]):
            a = a_arr[i].tobytes()
            for j in range(recon.shape[1]):
                x = xs_of(i)[j].tobytes()
                hit = x > a if gt else x < a
                want = b_arr[i].tobytes() if hit else bytes(lam_)
                bad += recon[i, j].tobytes() != want
        if bad != expect_bad:
            _dryrun_fail(f"{name}: {bad} reconstruction mismatches "
                         f"(expected {expect_bad})")
        return bad

    pb = ShardedWalkBackend(lam, cipher_keys, mesh)
    for bnd, kb in ((Bound.LT_BETA, bundle), (Bound.GT_BETA, gt_bundle)):
        ys = {b: pb.eval(b, xs, bundle=kb.for_party(b)) for b in (0, 1)}
        check_recon(ys[0] ^ ys[1], lambda i: xs[i],
                    f"ShardedWalkBackend/{bnd.name}",
                    gt=bnd is Bound.GT_BETA)
    print(f"dryrun_multichip OK [ShardedWalkBackend]: mesh {mesh.shape}, "
          f"{k_num} keys x {m} points (per-key), LT_BETA and GT_BETA "
          "two-party reconstruction verified", flush=True)

    # Keys-in-lanes: a key count ragged against the 32-key words of
    # every shard (pad keys' shares dropped), ragged points.
    k_rag = 32 * ksize + 8
    a_kl = rng.integers(0, 256, (k_rag, n_bytes), dtype=np.uint8)
    b_kl = rng.integers(0, 256, (k_rag, lam), dtype=np.uint8)
    kl_bundle = gen_batch(prg, a_kl, b_kl, random_s0s(k_rag, lam, rng),
                          Bound.LT_BETA)
    m_kl = 2 * psize + 1
    xs_kl = rng.integers(0, 256, (m_kl, n_bytes), dtype=np.uint8)
    xs_kl[0] = a_kl[0]
    kl = ShardedKeyLanesBackend(lam, cipher_keys, mesh)
    kl.put_bundle(kl_bundle)
    staged = kl.stage(xs_kl)
    ys = {b: kl.staged_to_bytes(kl.eval_staged(b, staged), m_kl)
          for b in (0, 1)}
    check_recon(ys[0] ^ ys[1], lambda i: xs_kl, "ShardedKeyLanesBackend",
                alphas_=a_kl, betas_=b_kl)
    print(f"dryrun_multichip OK [ShardedKeyLanesBackend]: mesh "
          f"{mesh.shape}, {k_rag} keys (ragged vs {32 * ksize}-granule) x "
          f"{m_kl} points, LT_BETA two-party reconstruction verified",
          flush=True)

    # The large-lambda hybrid at lam = 48, the edge of its narrow walk +
    # affine wide part split.
    lam48 = 48
    ck48 = [rng.bytes(32) for _ in range(18)]  # cipher index 17 is used
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReferenceContractWarning)
        prg48 = HirosePrgNp(lam48, ck48)
        a48 = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
        b48 = rng.integers(0, 256, (k_num, lam48), dtype=np.uint8)
        h_bundle = gen_batch(prg48, a48, b48, random_s0s(k_num, lam48, rng),
                             Bound.LT_BETA)
        hb = ShardedLargeLambdaBackend(lam48, ck48, mesh)
    ys = {b: hb.eval(b, xs[0], bundle=h_bundle.for_party(b)) for b in (0, 1)}
    check_recon(ys[0] ^ ys[1], lambda i: xs[0], "ShardedLargeLambdaBackend",
                alphas_=a48, betas_=b48, lam_=lam48)
    print(f"dryrun_multichip OK [ShardedLargeLambdaBackend]: mesh "
          f"{mesh.shape}, {k_num} keys x {m} points, lam=48 (hybrid "
          "contract edge), LT_BETA two-party reconstruction verified",
          flush=True)

    # The prefix-shared walk on a 1 x n points mesh, ragged points.
    mesh_p = _dryrun_mesh(n_devices, cards, shape=(1, n_devices))
    a_pf = rng.integers(0, 256, (1, n_bytes), dtype=np.uint8)
    b_pf = rng.integers(0, 256, (1, lam), dtype=np.uint8)
    pf_bundle = gen_batch(prg, a_pf, b_pf, random_s0s(1, lam, rng),
                          Bound.LT_BETA)
    xs_pf = rng.integers(0, 256, (2 * n_devices + 1, n_bytes),
                         dtype=np.uint8)
    xs_pf[0] = a_pf[0]
    ys = {b: ShardedPrefixBackend(lam, cipher_keys, mesh_p,
                                  prefix_levels=6).eval(
        b, xs_pf, bundle=pf_bundle.for_party(b)) for b in (0, 1)}
    check_recon(ys[0] ^ ys[1], lambda i: xs_pf, "ShardedPrefixBackend",
                alphas_=a_pf, betas_=b_pf)
    print(f"dryrun_multichip OK [ShardedPrefixBackend]: mesh "
          f"{mesh_p.shape}, 1 key x {xs_pf.shape[0]} points (ragged), "
          "LT_BETA two-party reconstruction verified", flush=True)

    # Full-domain tree: 0 on the true beta and exactly alpha mismatches
    # on a corrupted one (the counter's own control).
    n_bits = 16
    alpha_fd = int(rng.integers(0, 1 << n_bits))
    beta_fd = rng.integers(0, 256, lam, dtype=np.uint8).tobytes()
    fd_bundle = gen_batch(
        prg, np.frombuffer(alpha_fd.to_bytes(2, "big"), dtype=np.uint8)[None],
        np.frombuffer(beta_fd, dtype=np.uint8)[None],
        random_s0s(1, lam, rng), Bound.LT_BETA)
    fd = ShardedTreeFullDomain(lam, cipher_keys, mesh)
    got = fd.check(fd_bundle, alpha_fd, beta_fd, n_bits)
    wrong = fd.check(fd_bundle, alpha_fd, bytes(b ^ 1 for b in beta_fd),
                     n_bits)
    if got != 0 or wrong != alpha_fd:
        _dryrun_fail(f"tree counter: {got} mismatches on the true beta, "
                     f"{wrong} on a corrupted one (want 0 and {alpha_fd})")
    print(f"dryrun_multichip OK [ShardedTreeFullDomain]: mesh {mesh.shape}, "
          f"full domain 2^{n_bits}, 0 mismatches; wrong-beta control "
          f"counted exactly {wrong}", flush=True)

    # DPF EvalAll: 0 on the true betas, 1 with one beta byte flipped.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReferenceContractWarning)
        prg32 = HirosePrgNp(32, ck48)
        ev = ShardedDpfEvalAll(32, ck48, mesh)
    # The smallest byte domain deep enough for the mesh's frontier split
    # (5 + log2 P host levels).
    nb_dpf = -(-(5 + (mesh.size - 1).bit_length()) // 8)
    a_dpf = [int(a) for a in rng.integers(0, 1 << 8 * nb_dpf, 2)]
    b_dpf = rng.integers(0, 256, (2, 32), dtype=np.uint8)
    dpf_bundle = dpf_gen_batch(
        prg32, np.array([list(a.to_bytes(nb_dpf, "big")) for a in a_dpf],
                        dtype=np.uint8),
        b_dpf, random_s0s(2, 32, rng))
    bad_b = b_dpf.copy()
    bad_b[0, 5] ^= 1
    got = ev.check(dpf_bundle, a_dpf, b_dpf, 8 * nb_dpf)
    ev.invalidate()
    wrong = ev.check(dpf_bundle, a_dpf, bad_b, 8 * nb_dpf)
    if got != 0 or wrong != 1:
        _dryrun_fail(f"DPF counter: {got} on the true betas, {wrong} with "
                     "one flipped (want 0 and 1)")
    print(f"dryrun_multichip OK [ShardedDpfEvalAll]: mesh {mesh.shape}, "
          f"2 keys over the full domain 2^{8 * nb_dpf}, 0 mismatches; a "
          "flipped beta byte counted exactly 1", flush=True)

    # The facade's mesh routing over the same workload.
    dcf = Dcf(n_bytes, lam, cipher_keys, mesh=mesh)
    check_recon(dcf.eval(0, bundle, xs[0]) ^ dcf.eval(1, bundle, xs[0]),
                lambda i: xs[0], "Dcf facade")
    print(f"dryrun_multichip OK [Dcf facade mesh={mesh.shape} -> "
          f"{dcf.backend_name}]: two-party reconstruction verified",
          flush=True)

    # Negative controls: key 0's level-0 cw_v corrupted on party 1's
    # image, which party 1 applies unconditionally (it starts with
    # t = 1), so every key-0 reconstruction must flip.
    def corrupt(kb: KeyBundle) -> KeyBundle:
        bad_v = kb.cw_v.copy()
        bad_v[0, 0, 0] ^= np.uint8(0xFF)
        return KeyBundle(s0s=kb.s0s, cw_s=kb.cw_s, cw_v=bad_v, cw_t=kb.cw_t,
                         cw_np1=kb.cw_np1)

    y0 = pb.eval(0, xs, bundle=bundle.for_party(0))
    y1c = pb.eval(1, xs, bundle=corrupt(bundle.for_party(1)))
    check_recon(y0 ^ y1c, lambda i: xs[i], "negative control", expect_bad=m)
    print(f"dryrun_multichip OK [negative control]: corrupted level-0 cw_v "
          f"detected ({m}/{k_num * m} reconstructions flagged, exactly "
          "key 0's points as predicted)", flush=True)

    klc = ShardedKeyLanesBackend(lam, cipher_keys, mesh)
    klc.put_bundle(corrupt(kl_bundle))
    staged_c = klc.stage(xs_kl)
    ys_c = {b: klc.staged_to_bytes(klc.eval_staged(b, staged_c), m_kl)
            for b in (0, 1)}
    check_recon(ys_c[0] ^ ys_c[1], lambda i: xs_kl,
                "negative control (keylanes)", alphas_=a_kl, betas_=b_kl,
                expect_bad=m_kl)
    print(f"dryrun_multichip OK [negative control keylanes]: corrupted "
          f"level-0 cw_v detected ({m_kl}/{k_rag * m_kl} reconstructions "
          "flagged, exactly key 0's points as predicted)", flush=True)

    y0_pf = ShardedPrefixBackend(lam, cipher_keys, mesh_p,
                                 prefix_levels=6).eval(
        0, xs_pf, bundle=pf_bundle.for_party(0))
    y1_pf = ShardedPrefixBackend(lam, cipher_keys, mesh_p,
                                 prefix_levels=6).eval(
        1, xs_pf, bundle=corrupt(pf_bundle.for_party(1)))
    m_pf = xs_pf.shape[0]
    check_recon(y0_pf ^ y1_pf, lambda i: xs_pf, "negative control (prefix)",
                alphas_=a_pf, betas_=b_pf, expect_bad=m_pf)
    print(f"dryrun_multichip OK [negative control prefix]: corrupted "
          f"level-0 cw_v detected through the cached frontier "
          f"({m_pf}/{m_pf} reconstructions flagged, every point as "
          "predicted)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    y = fn(*example_args)
    print(f"entry OK: {tuple(y.shape)} {y.dtype}", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
