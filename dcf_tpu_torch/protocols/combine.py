"""Share-combine algebra for the protocol layer.

Counterpart of ``dcf_tpu/protocols/combine.py``.  Every interval protocol
reduces to the same local step: party b evaluates the 2m K-packed bound
keys, combines adjacent key pairs (interval i = keys 2i and 2i+1) and
folds in its per-interval combine mask.  In the XOR output group the
combine is XOR; in an additive group it is the per-lane mod-2^w add --
the keygen already folded the decomposition's minus sign into the key
betas (``keygen.interval_session_material``), so the combine is the same
uniform pairwise sum for every group and every bound.  The step is local
and linear, so it runs unchanged on host bytes or on the card: for the
staged backends it runs on the card before the shares are fetched,
halving the bytes brought back (2m keys in, m intervals out).

The port's staged shares are bytes, uint8 [K, M_pad, lam] on the card,
for every staged backend (walk, prefix, the large-lambda hybrid,
keylanes), not ``dcf_tpu``'s bit-major planes, so the staged combine is
one slice and an XOR or a lane add for all of them
(``ops.walk_eval.group_add_plain``): plain torch ops, as ``dcf_tpu`` does
this step in XLA outside its kernels.

``fire("protocols.combine", m, points)`` is the fault seam: it sits where
a combine-time failure (a bad mask shape, a dead device) would surface,
so the evaluators' error contracts are testable
(``dcf_tpu_torch.testing.faults``); the staged combine fires it with
``points = -1``.

``xor_reconstruct_stream`` is the two-party reconstruction streamed over
the key axis, the protocol layer's "both parties, K in chunks" primitive
that ``workloads.secure_relu_eval`` is a thin client of.  The name records
its XOR origin; it reconstructs in the bundle's group.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.walk_eval import group_add_plain
from dcf_tpu_torch.testing.faults import fire
from dcf_tpu_torch.utils.groups import group_width, np_group_add

__all__ = [
    "combine_pair_shares",
    "staged_pair_combine",
    "xor_reconstruct_stream",
]


def combine_pair_shares(y, masks_b: np.ndarray | None, group: str = "xor"):
    """Pairwise share combine on host bytes: y uint8 [2m, M, lam] ->
    [m, M, lam].  ``masks_b``: this party's uint8 [m, lam] combine mask
    (``ProtocolBundle.masks_for``), or None to skip the public
    correction."""
    if y.ndim != 3 or y.shape[0] % 2:
        raise ShapeError(
            f"expected [2m, M, lam] bound-key shares, got {y.shape}")
    fire("protocols.combine", y.shape[0] // 2, y.shape[1])
    y = np.asarray(y)
    yc = np_group_add(y[0::2], y[1::2], group)
    if masks_b is not None:
        _check_mask(masks_b, yc)
        yc = np_group_add(yc, masks_b[:, None, :], group)
    return yc


def _check_mask(masks_b: np.ndarray, yc) -> None:
    if masks_b.shape != (yc.shape[0], yc.shape[2]):
        raise ShapeError(
            f"combine mask must be [{yc.shape[0]}, {yc.shape[2]}], "
            f"got {masks_b.shape}")


def staged_pair_combine(y_dev, group: str = "xor"):
    """Pairwise combine of a staged backend's ``eval_staged`` output on
    its device, uint8 [2m, M_pad, lam] -> [m, M_pad, lam].  Every staged
    backend of the port returns that byte layout, so one slice and group
    add serves them all.  The pad points stay in and are dropped by
    ``staged_to_bytes`` after the combine.  The mask is not applied here:
    fold it in on the fetched bytes.  A mesh-sharded backend's output
    (``parallel.ShardedTensor``) combines shard by shard."""
    fire("protocols.combine", y_dev.shape[0] // 2, -1)
    if hasattr(y_dev, "pair_combine"):
        return y_dev.pair_combine(group)
    return group_add_plain(y_dev[0::2], y_dev[1::2], group_width(group))


def xor_reconstruct_stream(backend0, backend1, bundle: KeyBundle,
                           xs: np.ndarray,
                           key_chunk: int = 1 << 16) -> np.ndarray:
    """Two-party reconstruction of K keys at M shared points in the
    bundle's output group, streamed over the keys: uint8 [K, M, lam].

    ``backend0`` / ``backend1``: evaluators holding the two party roles,
    with ``eval(b, xs, bundle=party_bundle)`` (the walk and prefix
    backends).  Keys go through the device ``key_chunk`` at a time, so the
    whole key image never has to be resident at once."""
    k = bundle.num_keys
    m, lam = xs.shape[0], bundle.lam
    out = np.empty((k, m, lam), dtype=np.uint8)
    for lo in range(0, k, key_chunk):
        hi = min(k, lo + key_chunk)
        sub = KeyBundle(s0s=bundle.s0s[lo:hi], cw_s=bundle.cw_s[lo:hi],
                        cw_v=bundle.cw_v[lo:hi], cw_t=bundle.cw_t[lo:hi],
                        cw_np1=bundle.cw_np1[lo:hi], group=bundle.group)
        y0 = backend0.eval(0, xs, bundle=sub.for_party(0))
        y1 = backend1.eval(1, xs, bundle=sub.for_party(1))
        out[lo:hi] = np_group_add(np.asarray(y0), np.asarray(y1),
                                  bundle.group)
    return out
