"""Hybrid large-lambda evaluator (lam >= 48): narrow walk + GF(2) wide tail.

Counterpart of ``dcf_tpu/backends/large_lambda.py``.  For lam >= 48 the
Hirose PRG encrypts only its first two 16-byte blocks (reference
src/prg.rs:48-56, the zip quirk); every later block is a copy of the seed
or its complement.  So the walk state beyond byte 32 evolves affinely in
the per-level gate bits, and x enters it only through them:

    y[32:] = const_b ^ XOR_k t_k * W[k]          (a GF(2) product)

with t_0 = b and t_n the bit that gates cw_np1.  An evaluation is then

  1. the NARROW 32-byte walk (kernel B4, ``ops.narrow_walk``; or, with
     ``prefix_levels``, kernels B5a + B5b, ``ops.hybrid_prefix``), which
     yields y[:32] and the trajectory t_0..t_n; the walk is the lam = 32
     walk without the final-bit mask, which lies in the wide part;
  2. the wide tail (kernel W1, ``ops.wide_tail``) over the trajectory.

``W`` (shared by the parties) and ``const`` (party b's: it follows from
b's wide seed) come from basis probing on the host
(``wide_affine_batch_np``), so no hand-derived coefficient formula can
rot.  Both are derived anew at each ``put_bundle`` and never reused across
parties.

The host half (``wide_affine_batch_np``, ``narrow_walk_np``; the node
enumeration is ``ops.hybrid_prefix.node_prefix_xs``) is this package's
own copy of the reference's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import (
    points_mismatch_count,
    prepare_batch,
    resolve_device,
)
from dcf_tpu_torch.backends.frontier import FrontierConsumerMixin
from dcf_tpu_torch.backends.walk_backend import POINT_TILE
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.hybrid_prefix import hybrid_prefix_eval, narrow_frontier
from dcf_tpu_torch.ops.narrow_walk import NARROW, narrow_aes_image, narrow_walk
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.ops.wide_tail import wide_tail
from dcf_tpu_torch.spec import hirose_used_cipher_indices
from dcf_tpu_torch.utils.tracing import span

__all__ = ["LargeLambdaBackend", "wide_affine_batch_np",
           "narrow_walk_np", "HYBRID_MAX_PREFIX_LEVELS", "NARROW"]

# The JAX package's clamp, measured on a TPU v5e: its XLA gather of 64-byte
# frontier rows slowed 4x at a 128 MB table, one level earlier than the
# lam = 16 frontier's 21.  Kept as it is.  On an H100 the in-kernel gather
# of B5b shows no such cliff through k = 24 (chip_smoke.py phase 7); there
# the frontier's size, 2^k x 68 bytes per (key, party), and B5a's build
# time are what a deeper clamp would cost.
HYBRID_MAX_PREFIX_LEVELS = 20


def _clear_masked(a: np.ndarray, lam: int) -> np.ndarray:
    """Clear the global bit 8*lam-1, which lies in the wide slice at wide
    byte lam-1-NARROW."""
    a = a.copy()
    a[..., lam - 1 - NARROW] &= np.uint8(0xFE)
    return a


def wide_affine_batch_np(bundle: KeyBundle):
    """Affine decomposition of the wide output, batched over keys.

    bundle: party-restricted, lam > 32, K keys.  Returns (const [K,
    lam-32], w [K, n+1, lam-32]) uint8 such that per key y[32:] = const ^
    XOR_k t_k * w[k], t_k the bit gating level k (t_0 = the party bit) and
    t_n the one gating cw_np1.  ``w`` is built from the shared correction
    words alone; ``const`` follows from this party's wide seed, so it is
    derived anew for each party-restricted bundle.  Found by running the
    wide recursion on the zero trajectory and the n+1 unit ones at once."""
    lam, n, k_num = bundle.lam, bundle.n_bits, bundle.num_keys
    if lam <= NARROW:
        # api-edge: the wide part's lam contract
        raise ValueError("wide part needs lam > 32")
    wd = lam - NARROW
    s0w = bundle.s0s[:, 0, NARROW:]
    cw_s_w = bundle.cw_s[:, :, NARROW:]
    cw_v_w = bundle.cw_v[:, :, NARROW:]
    np1w = bundle.cw_np1[:, NARROW:]

    nb = n + 2  # basis: [zero, e_0 .. e_n]
    t_basis = np.zeros((nb, n + 1), dtype=np.uint8)
    t_basis[1:] = np.eye(n + 1, dtype=np.uint8)
    s = np.broadcast_to(s0w[:, None, :], (k_num, nb, wd)).copy()
    v = np.zeros((k_num, nb, wd), dtype=np.uint8)
    for i in range(n):
        gate = t_basis[:, i][None, :, None]
        v ^= _clear_masked(s ^ 0xFF, lam) ^ cw_v_w[:, i][:, None, :] * gate
        s = _clear_masked(s, lam) ^ cw_s_w[:, i][:, None, :] * gate
    y = v ^ s ^ np1w[:, None, :] * t_basis[:, n][None, :, None]
    const = y[:, 0]
    return const, y[:, 1:] ^ const[:, None, :]


def narrow_walk_np(cipher_keys: Sequence[bytes], bundle: KeyBundle, b: int,
                   xs: np.ndarray):
    """Host oracle of the narrow walk for the bundle's first key: y32
    [M, 32] and the trajectory [M, n+1] (t[:, 0] = b, t[:, k] gates level
    k, t[:, n] gates cw_np1).  ``bundle``: party-restricted, full lam."""
    n = bundle.n_bits
    prg = HirosePrgNp(NARROW, cipher_keys, mask=False, warn=False)
    m = xs.shape[0]
    s = np.broadcast_to(bundle.s0s[0, 0, :NARROW], (m, NARROW)).copy()
    t = np.full(m, b, dtype=np.uint8)
    v = np.zeros((m, NARROW), dtype=np.uint8)
    traj = np.empty((m, n + 1), dtype=np.uint8)
    bits = np.unpackbits(xs, axis=1)  # MSB-first walk order
    for i in range(n):
        traj[:, i] = t
        p = prg.gen(s)
        cs = bundle.cw_s[0, i, :NARROW]
        cv = bundle.cw_v[0, i, :NARROW]
        ctl, ctr = bundle.cw_t[0, i]
        tc = t[:, None]
        xm = bits[:, i].astype(bool)
        v ^= np.where(xm[:, None], p.v_r, p.v_l) ^ cv * tc
        s = np.where(xm[:, None], p.s_r, p.s_l) ^ cs * tc
        t = np.where(xm, p.t_r, p.t_l) ^ (t & np.where(xm, ctr, ctl))
    traj[:, n] = t
    y32 = v ^ s ^ bundle.cw_np1[0, :NARROW] * t[:, None]
    return y32, traj


class LargeLambdaBackend(FrontierConsumerMixin):
    """DCF evaluator for lam >= 48 (a multiple of 16), XOR group, points
    shared by all keys.

    From the root, each eval runs kernel B4 then W1.  With
    ``prefix_levels`` (0, or >= 5) the top k levels of the narrow walk are
    walked once per (key image, party) for every node prefix (kernel B5a)
    and cached with the key image; each eval then runs B5b (gather, levels
    k..n-1) then W1.  Same staged API as ``WalkBackend``; the backend runs
    on the card unless built with ``device="cpu"``.
    """

    #: Read by the serving registry: ``put_bundle`` stages the key
    #: factory's device planes (``dev_planes``).
    accepts_dev_planes = True

    def __init__(self, lam: int, cipher_keys: Sequence[bytes],
                 prefix_levels: int = 0, device=None):
        if lam < 48 or lam % 16:
            # api-edge: constructor lam contract
            raise ValueError(
                "LargeLambdaBackend wants lam >= 48 (a multiple of 16); "
                "lam = 16 has the walk and prefix backends")
        if prefix_levels and prefix_levels < 5:
            # api-edge: constructor prefix_levels contract
            raise ValueError(
                "prefix_levels must be 0 (from the root) or >= 5, got "
                f"{prefix_levels}")
        used = hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self.device = resolve_device(device)
        self.prefix_levels = min(prefix_levels, HYBRID_MAX_PREFIX_LEVELS)
        self.aes = torch.from_numpy(narrow_aes_image(
            cipher_keys[used[0]], cipher_keys[used[1]])).to(self.device)
        self.invalidate_frontier()
        self._bundle = None
        self._dev = None
        self._wide = None

    def _dims(self) -> tuple[int, int]:
        """(k_num, n_bits) of the held bundle; raises if absent."""
        if self._bundle is None:
            raise StaleStateError(
                "no key bundle on device; call put_bundle first")
        return self._bundle.num_keys, self._bundle.n_bits

    def _k(self) -> int:
        """Effective prefix depth for the held bundle: at least 8 walked
        levels; the stacked table of K keys kept within
        2^HYBRID_MAX_PREFIX_LEVELS rows; floored at 5."""
        k_num, n = self._dims()
        k_cap = HYBRID_MAX_PREFIX_LEVELS - (k_num - 1).bit_length()
        return max(min(self.prefix_levels, n - 8, k_cap), 5)

    def put_bundle(self, bundle: KeyBundle,
                   dev_planes: dict | None = None) -> None:
        """Ship a party-restricted bundle's narrow arrays to the device.
        The wide tail's (const, W) follow lazily at the first eval.

        ``dev_planes``: this party's narrow arrays already on the device,
        from the on-device keygen
        (``HybridKeyGen.gen_with_planes_pair``): they are staged as they
        are, with no host round trip.  They must be the arrays this
        method would ship from ``bundle``; only the wide tail still
        reads the host bundle."""
        if bundle.lam != self.lam:
            raise ShapeError("bundle lam mismatch")
        if bundle.group != "xor":
            # The wide part is a GF(2) affine decomposition of the payload;
            # an additive payload does not factor through it.
            raise ShapeError(
                f"LargeLambdaBackend is XOR-only; bundle has group "
                f"{bundle.group!r}")
        if bundle.s0s.shape[1] != 1:
            raise ShapeError(
                "LargeLambdaBackend wants a party-restricted bundle")
        if self.prefix_levels and bundle.n_bits < 13:
            raise ShapeError(
                f"domain of {bundle.n_bits} levels is too shallow for "
                "prefix sharing (needs >= 5 frontier + 8 walked levels); "
                "use prefix_levels=0")
        host = dict(s0=bundle.s0s[:, 0, :NARROW], cw_s=bundle.cw_s[..., :NARROW],
                    cw_v=bundle.cw_v[..., :NARROW], cw_t=bundle.cw_t,
                    cw_np1=bundle.cw_np1[:, :NARROW])
        if dev_planes is not None:
            for name, a in host.items():
                t = dev_planes.get(name)
                if t is None or tuple(t.shape) != a.shape \
                        or t.dtype != torch.uint8 \
                        or t.device.type != self.device.type:
                    raise ShapeError(
                        f"dev_planes[{name!r}] is not the bundle's narrow "
                        f"array {a.shape} uint8 on {self.device}")
            self._dev = {name: dev_planes[name] for name in host}
        else:
            self._dev = {
                name: torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)
                for name, a in host.items()}
        self._bundle = bundle
        self._wide = None  # const is this party's: never reuse it
        self.invalidate_frontier()

    def _wide_staged(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(const [K, lam-32], W [K, n+1, lam-32]) on the device."""
        if self._wide is None:
            const, w = wide_affine_batch_np(self._bundle)
            self._wide = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (const, w))
        return self._wide

    def _build_frontier_tables(self, b: int):
        """Party ``b``'s frontier (rows [K * 2^k, 64], words [K * 2^k, 4])
        by kernel B5a; key material, off the eval clock.  All its levels
        are device levels."""
        dev = self._dev
        with span("frontier_device_levels"):
            return narrow_frontier(self.aes, dev["s0"], dev["cw_s"],
                                   dev["cw_v"], dev["cw_t"], k=self._k(),
                                   b=int(b))

    def stage(self, xs) -> dict:
        """Ship shared points uint8 [M, n_bytes] to the device, padded to
        whole warps (pad points are genuine evaluations of x = 0, dropped
        by ``staged_to_bytes``).  With ``prefix_levels`` the dict also
        records the geometry (k, n) it was staged for."""
        with span("stage"):
            xs = np.asarray(xs)
            if xs.dtype != np.uint8:
                raise ShapeError(f"xs must be uint8, got {xs.dtype}")
            if xs.ndim != 2:
                raise ShapeError(
                    "LargeLambdaBackend wants shared points [M, nb]")
            xs, _, m = prepare_batch(
                self._dims(), xs, lambda m: -(-m // POINT_TILE) * POINT_TILE)
            if m == 0:
                raise ShapeError("cannot stage an empty batch")
            staged = {"xs": torch.from_numpy(xs).to(self.device), "m": m}
            if self.prefix_levels:
                staged.update(k=self._k(), n=8 * xs.shape[-1])
            return staged

    def _check_staged_fresh(self, staged: dict) -> None:
        """Reject staged points cut for a prefix geometry (k, n) this
        backend no longer holds (a put_bundle that changed the key count
        or the domain).  Same-geometry re-ships stay valid, the other
        party's backend included."""
        if "k" not in staged:
            # api-edge: documented staged-protocol contract (a dict from
            # another backend's stage)
            raise ValueError("staged dict is not from a prefix-enabled "
                             "hybrid backend's stage")
        k_now, n_now = self._k(), self._dims()[1]
        if staged["k"] != k_now or staged["n"] != n_now:
            raise StaleStateError(
                f"staged points are stale: staged at prefix depth "
                f"k={staged['k']} over an n={staged['n']}-level domain, but "
                f"the backend now holds a bundle with k={k_now}, "
                f"n={n_now}; re-stage the points after put_bundle")

    def eval_staged(self, b: int, staged: dict) -> torch.Tensor:
        """Party ``b`` eval on staged points; returns the device-resident
        shares uint8 [K, M_pad, lam] (asynchronous on the card)."""
        with span("eval_staged"):
            self._dims()
            const, w = self._wide_staged()
            dev = self._dev
            if self.prefix_levels:
                self._check_staged_fresh(staged)
                rows, words = self._frontier_tables(b)
                y, traj = hybrid_prefix_eval(
                    self.aes, rows, words, dev["cw_s"], dev["cw_v"],
                    dev["cw_t"], dev["cw_np1"], staged["xs"], k=staged["k"],
                    lam=self.lam)
            else:
                y, traj = narrow_walk(
                    self.aes, dev["s0"], dev["cw_s"], dev["cw_v"],
                    dev["cw_t"], dev["cw_np1"], staged["xs"], b=int(b),
                    lam=self.lam)
            return wide_tail(y, traj, const, w)

    def staged_to_bytes(self, y: torch.Tensor, m: int) -> np.ndarray:
        """``eval_staged`` output -> uint8 [K, m, lam] on the host."""
        with span("fetch"):
            return y[:, :m].cpu().numpy()

    def eval(self, b: int, xs, bundle: KeyBundle | None = None) -> np.ndarray:
        """Evaluate party ``b`` on shared points xs uint8 [M, n_bytes].
        Returns uint8 [K, M, lam]."""
        if bundle is not None:
            self.put_bundle(bundle)
        staged = self.stage(xs)
        return self.staged_to_bytes(self.eval_staged(b, staged), staged["m"])

    def points_mismatch_count(self, y0, y1, alpha, beta, staged: dict,
                              gt: bool = False) -> torch.Tensor:
        """Two-party check on the device (``_common.points_mismatch_count``):
        the (key, point) pairs, pad points included, whose XOR
        reconstruction differs from ``beta if x < alpha else 0`` (``>``
        for gt)."""
        return points_mismatch_count(y0, y1, alpha, beta, staged["xs"],
                                     self.lam, "xor", gt)
