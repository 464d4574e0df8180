"""The two-party reconstruction streamed over the key axis.

Counterpart of ``xor_reconstruct_stream`` in
``dcf_tpu/protocols/combine.py`` (its lines 142-173), the protocol layer's
"both parties, K in chunks" primitive that ``workloads.secure_relu_eval``
is a thin client of.  The name records its XOR origin; it reconstructs in
the bundle's group.  The rest of that module (the interval protocols'
pairwise combine and its fault seam) waits for ROADMAP.md slice 7.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.utils.groups import np_group_add

__all__ = ["xor_reconstruct_stream"]


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
