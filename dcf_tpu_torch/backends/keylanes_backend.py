"""KeyLanesBackend: many keys at few shared points on kernel B8 (lam = 16).

Counterpart of ``KeyLanesPallasBackend`` in
``dcf_tpu/backends/pallas_keylanes.py``.  The secure-ReLU pipeline
(BASELINE.json config 5) stays on the device from end to end: kernel G1
(``backends.device_gen.DeviceKeyGen``) writes the key image there, this
backend walks it with kernel B8, and ``relu_mismatch_count`` checks the
two-party XOR reconstruction against the plain comparison there too; the
host ships alphas, betas, seeds and points and reads one counter.

Unlike the one-party bundles of the other backends, the image here holds
both parties' seeds: the correction words are shared by the two parties
(the reference's src/lib.rs:269-272), and at 4.35 GB for 10^6 keys they
should exist once.  So ``put_bundle`` takes the two-party bundle and
``put_bundle_device`` G1's dict as it is, and ``eval_staged(b, ...)``
reads party b's seeds.  XOR group only, as in ``dcf_tpu``.

The JAX backend's tiling knobs (``m_tile``, ``kw_tile``, ``level_chunk``)
and its key-word padding have no counterpart: nothing is packed 32 keys to
a word.  The backend runs on the card unless built with ``device="cpu"``,
where the kernel's plain PyTorch version runs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import (
    points_mismatch_count,
    resolve_device,
    to_device,
)
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.keylanes_eval import keylanes_eval
from dcf_tpu_torch.ops.walk_eval import aes_image
from dcf_tpu_torch.spec import hirose_used_cipher_indices

__all__ = ["KeyLanesBackend"]

_IMAGE = ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1")


class KeyLanesBackend:
    """Many-keys DCF evaluator on kernel B8; both parties share one key
    image."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], device=None):
        if lam != 16:
            raise ValueError(
                f"KeyLanesBackend supports lam=16 only (got {lam})")
        used = hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self.device = resolve_device(device)
        self.aes = to_device(aes_image(cipher_keys[used[0]]), self.device)
        self._bundle_dev = None
        self._num_keys = 0

    def put_bundle(self, bundle: KeyBundle) -> None:
        """Ship the two-party host bundle (XOR group) to the device."""
        if bundle.lam != self.lam:
            raise ShapeError("bundle lam mismatch")
        if bundle.group != "xor":
            raise ShapeError(
                f"KeyLanesBackend is XOR-only; bundle has group "
                f"{bundle.group!r} (use the walk or prefix backends for "
                "additive groups)")
        if bundle.s0s.shape[1] != 2:
            raise ShapeError("KeyLanesBackend wants the full two-party bundle")
        dev = {name: to_device(getattr(bundle, name), self.device)
               for name in _IMAGE}
        dev["num_keys"] = bundle.num_keys
        self.put_bundle_device(dev)

    def put_bundle_device(self, dev: dict) -> None:
        """Adopt a key image already on the device, as
        ``DeviceKeyGen.gen`` returns it (s0s [K, 2, 16], cw_s / cw_v
        [K, n, 16], cw_t [K, n, 2], cw_np1 [K, 16], num_keys).  The tensors
        are used in place."""
        k_num = dev["num_keys"]
        for name in _IMAGE:
            t = dev[name]
            if t.device != self.aes.device or t.shape[0] != k_num:
                raise ShapeError(
                    f"{name} must hold {k_num} keys on {self.device}")
        if tuple(dev["s0s"].shape[1:]) != (2, self.lam):
            raise ShapeError("the key image must hold both parties' seeds")
        self._bundle_dev = {name: dev[name] for name in _IMAGE}
        self._num_keys = k_num

    @property
    def num_keys(self) -> int:
        self._dims()
        return self._num_keys

    def _dims(self) -> tuple[int, int]:
        """(k_num, n_bits) of the on-device image; raises if absent."""
        if self._bundle_dev is None:
            raise StaleStateError(
                "no key bundle on device; call put_bundle first")
        return tuple(self._bundle_dev["cw_s"].shape[:2])

    def stage(self, xs) -> dict:
        """Ship the shared points uint8 [M, n_bytes]; returns the staged
        dict for ``eval_staged``."""
        n = self._dims()[1]
        xs = np.asarray(xs)
        if xs.dtype != np.uint8 or xs.ndim != 2:
            raise ShapeError("the keylanes backend takes shared points, "
                             "uint8 [M, n_bytes]")
        if xs.shape[1] * 8 != n:
            raise ShapeError("xs width mismatch with bundle")
        return {"xs": to_device(xs[None], self.device), "m": xs.shape[0]}

    def eval_staged(self, b: int, staged: dict) -> torch.Tensor:
        """Party ``b``'s shares on the device: uint8 [K, M, 16]
        (asynchronous on the card)."""
        self._dims()
        d = self._bundle_dev
        return keylanes_eval(self.aes, d["s0s"], d["cw_s"], d["cw_v"],
                             d["cw_t"], d["cw_np1"], staged["xs"], b=int(b))

    def staged_to_bytes(self, y: torch.Tensor, m: int) -> np.ndarray:
        """``eval_staged`` output -> uint8 [K, m, 16] on the host."""
        return y[:, :m].cpu().numpy()

    def eval(self, b: int, xs, bundle: KeyBundle | None = None) -> np.ndarray:
        """Party ``b``'s shares at shared points xs uint8 [M, n_bytes]:
        uint8 [K, M, 16] on the host."""
        if bundle is not None:
            self.put_bundle(bundle)
        staged = self.stage(xs)
        return self.staged_to_bytes(self.eval_staged(b, staged),
                                    staged["m"])

    def relu_mismatch_count(self, y0: torch.Tensor, y1: torch.Tensor,
                            alphas: np.ndarray, betas: np.ndarray,
                            staged: dict) -> torch.Tensor:
        """Config 5's check on the device: the number of (key, point)
        pairs whose XOR reconstruction differs from ``beta_k if x_m <
        alpha_k else 0``.  y0/y1: both parties' ``eval_staged`` outputs
        over ``staged``; alphas uint8 [K, n_bytes] and betas uint8 [K, 16]
        of the image's keys.  Returns a device int64 scalar."""
        if alphas.shape[0] != self.num_keys:
            raise ShapeError(f"got {alphas.shape[0]} alphas for a bundle of "
                             f"{self.num_keys} keys")
        return points_mismatch_count(y0, y1, alphas, betas, staged["xs"],
                                     self.lam, "xor")
