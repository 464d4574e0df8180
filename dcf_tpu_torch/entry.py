"""The port's single-card entry point: ``entry(device=None)``.

Counterpart of ``__graft_entry__.entry`` (its lines 10-59): the flagship
forward step, party 0's from-root walk (kernel B1, ``ops.walk_eval``) at
n = 128 levels, lam = 16, over two keys with per-key points, on staged
device arrays — bytes in, bytes out.  On the card each key walks 4096
points; on the CPU, where B1's plain PyTorch version runs, 64.

    python -m dcf_tpu_torch.entry              # on the card
    python -m dcf_tpu_torch.entry --device cpu

prints ``entry OK: <shape> <dtype>``.  ``dryrun_multichip`` comes with the
multi-GPU slice (ROADMAP.md).
"""

from __future__ import annotations

import argparse
from functools import partial

import numpy as np

from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.spec import Bound

__all__ = ["entry", "_make_workload"]

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
