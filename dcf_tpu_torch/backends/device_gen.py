"""Key generation on the card: DCF keys at lam = 16, 32 and >= 48, DPF
keys at lam = 32.

Counterparts of ``dcf_tpu/backends/device_gen.py`` (``DeviceKeyGen``, the
keys-in-lanes generator) and of the generator classes of
``dcf_tpu/ops/pallas_keygen.py`` (``PallasKeyGen`` and
``PallasDpfKeyGen``):

    DeviceKeyGen  lam = 16   kernel G1; ``gen`` leaves the key image on the
                  and 32     device, both parties' seeds included, in the
                             layout ``backends.keylanes_backend`` reads
                             (at lam = 32, kernel G2: B7a's expansion
                             with the lam = 32 PRG's mask, no trajectory)
    HybridKeyGen  lam >= 48  kernel B7a (the narrow 32 bytes and both
                             trajectories), then kernel W2, the GF(2) wide
                             tail (``ops.keygen_walk.keygen_wide_tail``),
                             on the device with no host round trip in
                             between
    DpfKeyGen     lam = 32   kernel B7b

Keygen is sequential over the n levels and independent across keys, so at
the secure-ReLU scale (10^6 keys) it belongs on the card: the host ships
alphas, betas and root seeds, and the correction words (4.35 GB for 10^6
keys at n = 128, lam = 16) are born on the device.  Every generator gives
the bytes the host ``gen.gen_batch`` / ``protocols.dpf.dpf_gen_batch``
give on the same inputs.  They run on the card unless built with
``device="cpu"``, where the kernels' plain versions run.

``HybridKeyGen.gen_with_planes_pair`` also hands back both parties'
narrow arrays as they lie on the device after B7a + W2 (the staged-plane
handoff of the key factory: ``LargeLambdaBackend.put_bundle(bundle,
dev_planes=...)`` stages them with no host round trip).  The layout is
this package's own: the arrays ``put_bundle(bundle)`` would ship from
the host bundle, byte for byte.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import resolve_device, to_device
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.gen import _check_gen_inputs
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.keygen_walk import (
    keygen_dcf16,
    keygen_dcf32,
    keygen_dpf,
    keygen_narrow,
    keygen_wide_tail,
)
from dcf_tpu_torch.ops.narrow_walk import NARROW, narrow_aes_image
from dcf_tpu_torch.ops.walk_eval import aes_image
from dcf_tpu_torch.spec import Bound, hirose_used_cipher_indices

__all__ = ["DeviceKeyGen", "HybridKeyGen", "DpfKeyGen"]


class _KeyGen:
    """The inputs' checks and shipping the three generators share."""

    lam: int
    device: torch.device

    def _ship(self, alphas, betas, s0s) -> tuple:
        _check_gen_inputs(alphas, betas, s0s, self.lam)
        if alphas.shape[0] < 1:
            raise ShapeError("keygen on the device wants at least one key")
        return tuple(to_device(a, self.device) for a in (alphas, betas, s0s))


class DeviceKeyGen(_KeyGen):
    """DCF keys at lam = 16 (kernel G1) and lam = 32 (kernel G2), left on
    the device."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], device=None):
        if lam not in (16, NARROW):
            # api-edge: constructor lam contract
            raise ValueError(
                f"DeviceKeyGen makes lam=16 and lam={NARROW} keys (got "
                f"{lam}); lam >= 48 is HybridKeyGen's")
        used = hirose_used_cipher_indices(lam, len(cipher_keys), warn=False)
        self.lam = lam
        self.device = resolve_device(device)
        image = (aes_image(cipher_keys[used[0]]) if lam == 16 else
                 narrow_aes_image(*(cipher_keys[i] for i in used)))
        self.aes = to_device(image, self.device)
        self._keygen = keygen_dcf16 if lam == 16 else keygen_dcf32

    def gen(self, alphas: np.ndarray, betas: np.ndarray, s0s: np.ndarray,
            bound: Bound) -> dict:
        """alphas uint8 [K, n_bytes], betas uint8 [K, lam], s0s uint8
        [K, 2, lam].  Returns the device key image: s0s [K, 2, lam] (both
        parties), cw_s / cw_v [K, n, lam], cw_t [K, n, 2], cw_np1 [K, lam]
        and num_keys, the arrays of the two-party ``KeyBundle``."""
        a, bt, s = self._ship(alphas, betas, s0s)
        cw_s, cw_v, cw_t, cw_np1 = self._keygen(
            self.aes, a, bt, s, lt=bound is Bound.LT_BETA)
        return dict(s0s=s, cw_s=cw_s, cw_v=cw_v, cw_t=cw_t, cw_np1=cw_np1,
                    num_keys=a.shape[0])

    @staticmethod
    def to_host_bundle(dev: dict) -> KeyBundle:
        """The device image as the two-party host ``KeyBundle``."""
        return KeyBundle(**{name: dev[name].cpu().numpy() for name in
                            ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1")})


class HybridKeyGen(_KeyGen):
    """DCF keys at lam >= 48 (a multiple of 16) on kernels B7a and W2 (the
    wide tail)."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], device=None):
        if lam < 48 or lam % 16:
            # api-edge: constructor lam contract
            raise ValueError(
                f"HybridKeyGen makes keys of lam >= 48, a multiple of 16 "
                f"(got {lam}); lam = 16 is DeviceKeyGen's")
        used = hirose_used_cipher_indices(lam, len(cipher_keys), warn=False)
        self.lam = lam
        self.device = resolve_device(device)
        self.aes = to_device(narrow_aes_image(
            cipher_keys[used[0]], cipher_keys[used[1]]), self.device)

    def gen(self, alphas: np.ndarray, betas: np.ndarray, s0s: np.ndarray,
            bound: Bound) -> KeyBundle:
        """alphas uint8 [K, n_bytes], betas uint8 [K, lam], s0s uint8
        [K, 2, lam].  Returns the two-party host ``KeyBundle``; the wide
        tail runs on the device after B7a, before the one copy to the
        host."""
        return DeviceKeyGen.to_host_bundle(
            self._gen_device(alphas, betas, s0s, bound))

    def _gen_device(self, alphas, betas, s0s, bound: Bound) -> dict:
        """B7a, then W2: the two-party key image on the device."""
        a, bt, s = self._ship(alphas, betas, s0s)
        lt = bound is Bound.LT_BETA
        cw_s, cw_v, cw_t, cw_np1, traj = keygen_narrow(self.aes, a, bt, s,
                                                       lt=lt)
        keygen_wide_tail(cw_s, cw_v, cw_np1, traj, a, bt, s, lt=lt)
        return dict(s0s=s, cw_s=cw_s, cw_v=cw_v, cw_t=cw_t, cw_np1=cw_np1)

    def gen_with_planes_pair(self, alphas: np.ndarray, betas: np.ndarray,
                             s0s: np.ndarray, bound: Bound
                             ) -> tuple[KeyBundle, dict]:
        """``gen`` plus both parties' narrow arrays left on the device:
        ``(bundle, {party: planes})``, ``planes`` the dict
        ``LargeLambdaBackend.put_bundle`` stages (``s0`` [K, 32], ``cw_s``
        / ``cw_v`` [K, n, 32], ``cw_t`` [K, n, 2], ``cw_np1`` [K, 32]).
        The correction words are the same for both parties: their arrays
        are shared by identity between the two dicts, so the pair holds
        one copy of them."""
        dev = self._gen_device(alphas, betas, s0s, bound)
        shared = dict(cw_s=dev["cw_s"][..., :NARROW].contiguous(),
                      cw_v=dev["cw_v"][..., :NARROW].contiguous(),
                      cw_t=dev["cw_t"].contiguous(),
                      cw_np1=dev["cw_np1"][:, :NARROW].contiguous())
        planes = {b: dict(s0=dev["s0s"][:, b, :NARROW].contiguous(),
                          **shared)
                  for b in (0, 1)}
        return DeviceKeyGen.to_host_bundle(dev), planes


class DpfKeyGen(_KeyGen):
    """DPF keys at lam = 32 on kernel B7b."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], device=None):
        if lam != NARROW:
            # api-edge: constructor lam contract
            raise ValueError(
                f"DpfKeyGen makes lam={NARROW} keys (two AES blocks), got "
                f"{lam}; other widths take the host dpf_gen_batch")
        used = hirose_used_cipher_indices(lam, len(cipher_keys), warn=False)
        self.lam = lam
        self.device = resolve_device(device)
        self.aes = to_device(narrow_aes_image(
            cipher_keys[used[0]], cipher_keys[used[1]]), self.device)

    def gen(self, alphas: np.ndarray, betas: np.ndarray, s0s: np.ndarray):
        """alphas uint8 [K, n_bytes], betas uint8 [K, 32], s0s uint8
        [K, 2, 32].  Returns the two-party host ``DpfBundle``."""
        from dcf_tpu_torch.protocols.dpf import DpfBundle

        a, bt, s = self._ship(alphas, betas, s0s)
        cw_s, cw_t, cw_np1 = keygen_dpf(self.aes, a, bt, s)
        return DpfBundle(s0s=s0s.copy(), cw_s=cw_s.cpu().numpy(),
                         cw_t=cw_t.cpu().numpy(), cw_np1=cw_np1.cpu().numpy())
