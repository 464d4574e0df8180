"""WalkBackend: DCF evaluation on the from-root walk kernels, B1 at
lam = 16 and E1 at lam = 32.

At lam = 16 the counterpart of ``PallasBackend`` in
``dcf_tpu/backends/pallas_backend.py``; at lam = 32 the counterpart of
``BitslicedBackend`` in ``dcf_tpu/backends/jax_bitsliced.py`` (its XLA
``eval_core_bitsliced``, which ``dcf_tpu``'s facade picks for
16 < lam < 48).  Both have the same staged API: ``put_bundle`` ships the
key image once, ``stage`` ships the points, ``eval_staged`` returns the
shares on the device, ``staged_to_bytes`` brings them to the host,
``eval`` does all of it bytes-in/bytes-out, and ``points_mismatch_count``
checks a two-party reconstruction on the device.  ``stage_range`` and
``mismatch_count`` are the per-point full-domain pair: consecutive points
made on the device, checked there against the plain comparison.

The key image is the bundle's own uint8 arrays (no plane layout), the
staged points are uint8 [Kx, M_pad, n/8], and the shares are uint8
[K, M_pad, lam].  The cipher image is cipher 0's at lam = 16
(``aes_image``), ciphers 0's and 17's at lam = 32 (``narrow_aes_image``).
Points pad to whole warps of 32; the pad points are genuine evaluations
of x = 0 and are dropped at ``staged_to_bytes``.  The backend runs on the
card unless it is built with ``device="cpu"``, where the kernel's plain
PyTorch version runs instead.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import (
    points_mismatch_count,
    prepare_batch,
    resolve_device,
    xor_mismatch_count,
)
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
from dcf_tpu_torch.ops.walk32_eval import walk32_eval
from dcf_tpu_torch.ops.walk_eval import aes_image, walk_eval
from dcf_tpu_torch.spec import hirose_used_cipher_indices
from dcf_tpu_torch.utils.tracing import span

__all__ = ["WalkBackend", "POINT_TILE"]

POINT_TILE = 32  # points pad to a multiple of one warp


class WalkBackend:
    """DCF evaluator running the from-root walk kernel (B1 at lam = 16, E1
    at lam = 32)."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], device=None):
        if lam not in (16, 32):
            # api-edge: constructor lam contract
            raise ValueError(
                f"WalkBackend supports lam=16 and lam=32 (got {lam}); "
                "lam >= 48 is the hybrid backend's (LargeLambdaBackend)")
        used = hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self.device = resolve_device(device)
        image = (aes_image(cipher_keys[used[0]]) if lam == 16 else
                 narrow_aes_image(*(cipher_keys[i] for i in used)))
        self.aes = torch.from_numpy(image).to(self.device)
        self._walk = walk_eval if lam == 16 else walk32_eval
        self._bundle_dev = None
        self._group = "xor"

    def put_bundle(self, bundle: KeyBundle) -> None:
        """Ship a party-restricted bundle's arrays to the device."""
        if bundle.lam != self.lam:
            raise ShapeError("bundle lam mismatch")
        if bundle.s0s.shape[1] != 1:
            raise ShapeError("put_bundle requires a party-restricted bundle")
        host = dict(s0=bundle.s0s[:, 0, :], cw_s=bundle.cw_s,
                    cw_v=bundle.cw_v, cw_t=bundle.cw_t, cw_np1=bundle.cw_np1)
        self._bundle_dev = {
            name: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for name, a in host.items()}
        self._group = bundle.group

    def _dims(self) -> tuple[int, int]:
        """(k_num, n_bits) of the on-device bundle; raises if absent."""
        if self._bundle_dev is None:
            raise StaleStateError(
                "no key bundle on device; call put_bundle first")
        return tuple(self._bundle_dev["cw_s"].shape[:2])

    def _prepare(self, xs) -> tuple[np.ndarray, int]:
        """Validate and pad xs: (xs padded [Kx, M_pad, nb], m)."""
        xs = np.asarray(xs)
        if xs.dtype != np.uint8:
            raise ShapeError(f"xs must be uint8, got {xs.dtype}")
        xs, _, m = prepare_batch(
            self._dims(), xs, lambda m: -(-m // POINT_TILE) * POINT_TILE)
        return xs, m

    def stage(self, xs) -> dict:
        """Ship xs to the device; returns the staged dict for
        ``eval_staged`` (outside any timed region)."""
        with span("stage"):
            xs, m = self._prepare(xs)
            if m == 0:
                raise ShapeError("cannot stage an empty batch")
            return {"xs": torch.from_numpy(xs).to(self.device), "m": m}

    def stage_range(self, start: int, count: int) -> dict:
        """Stage the consecutive points start..start+count-1 with no host
        to device transfer: the big-endian bytes are made on the device
        from an arange (the full-domain workload, BASELINE.json config
        3).  ``count`` must be a whole number of point tiles."""
        n = self._dims()[1]
        if count < 1 or count % POINT_TILE or start < 0 \
                or start + count > 1 << n:
            raise ShapeError(
                f"range [{start}, {start + count}) must be a whole number "
                f"of {POINT_TILE}-point tiles inside the 2^{n} domain")
        if n > 56:
            raise ShapeError(f"stage_range serves domains up to 56 bits, "
                             f"got {n}")
        idx = torch.arange(start, start + count, dtype=torch.int64,
                           device=self.device)
        shifts = torch.arange(n - 8, -8, -8, dtype=torch.int64,
                              device=self.device)
        xs = ((idx[:, None] >> shifts) & 0xFF).to(torch.uint8)
        return {"xs": xs[None].contiguous(), "m": count}

    def mismatch_count(self, y0: torch.Tensor, y1: torch.Tensor, alpha: int,
                       beta: bytes, start: int,
                       gt: bool = False) -> torch.Tensor:
        """Verification of a full-domain chunk on the device: the number
        of points of the staged range start..start+M-1 whose XOR
        reconstruction differs from ``beta if x < alpha else 0`` (``>``
        for gt).  y0/y1: both parties' ``eval_staged`` outputs over that
        range (single key).  Returns a device int64 scalar, so chunked
        callers can add up without a host round trip per chunk."""
        if y0.shape[0] != 1 or self._group != "xor":
            raise ShapeError("mismatch_count checks one XOR-group key")
        idx = torch.arange(start, start + y0.shape[1], dtype=torch.int64,
                           device=y0.device)
        inside = (idx > alpha) if gt else (idx < alpha)
        return xor_mismatch_count(y0[0], y1[0], inside, beta)

    def eval_staged(self, b: int, staged: dict) -> torch.Tensor:
        """Party ``b`` eval on staged points; returns the device-resident
        shares uint8 [K, M_pad, lam] (asynchronous on the card)."""
        with span("eval_staged"):
            self._dims()
            dev = self._bundle_dev
            return self._walk(self.aes, dev["s0"], dev["cw_s"], dev["cw_v"],
                              dev["cw_t"], dev["cw_np1"], staged["xs"],
                              b=int(b), group=self._group)

    def staged_to_bytes(self, y: torch.Tensor, m: int) -> np.ndarray:
        """``eval_staged`` output -> uint8 [K, m, lam] on the host."""
        with span("fetch"):
            return y[:, :m].cpu().numpy()

    def eval(self, b: int, xs, bundle: KeyBundle | None = None) -> np.ndarray:
        """Evaluate party ``b``; xs uint8 [M, n_bytes] or [K, M, n_bytes].
        Returns uint8 [K, M, lam]."""
        if bundle is not None:
            self.put_bundle(bundle)
        with span("stage"):
            xs, m = self._prepare(xs)
            if m == 0:
                return np.zeros((self._dims()[0], 0, self.lam),
                                dtype=np.uint8)
            staged = {"xs": torch.from_numpy(xs).to(self.device), "m": m}
        return self.staged_to_bytes(self.eval_staged(b, staged), m)

    def points_mismatch_count(self, y0, y1, alpha, beta, staged: dict,
                              gt: bool = False) -> torch.Tensor:
        """Two-party check on the device (``_common.points_mismatch_count``):
        the (key, point) pairs, pad points included, whose reconstruction
        in the bundle's group differs from ``beta if x < alpha else 0``
        (``>`` for gt)."""
        return points_mismatch_count(y0, y1, alpha, beta, staged["xs"],
                                     self.lam, self._group, gt)
