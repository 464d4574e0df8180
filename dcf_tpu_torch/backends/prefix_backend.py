"""PrefixBackend: batch eval with the shared top of the tree expanded once.

Counterpart of ``PrefixPallasBackend`` in
``dcf_tpu/backends/pallas_prefix.py``.  Same staged API as
``WalkBackend`` (lam = 16, shared points, K >= 1), but the top
``prefix_levels`` (k) levels of the GGM walk are expanded once per (key,
party) as a frontier table and cached with the key image: the host
expands the first ``host_levels`` (k0) levels (``tree_expand_np``), kernel
B2 doubles the nodes from level k0 to k on the card, and kernel B3 gathers
each point's carry from the table and walks the remaining n - k levels.
Work per batch drops from M*n to M*(n-k) + 2^(k+1) PRG calls; the
frontier is key material, built off the eval clock at the first
``eval_staged`` of each party.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends.frontier import FrontierConsumerMixin
from dcf_tpu_torch.backends.fulldomain import tree_expand_np
from dcf_tpu_torch.backends.walk_backend import WalkBackend
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prefix_eval import frontier_table, prefix_eval
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.ops.tree_expand import tree_expand
from dcf_tpu_torch.spec import ReferenceContractWarning
from dcf_tpu_torch.utils.tracing import span

__all__ = ["PrefixBackend", "MAX_PREFIX_LEVELS"]

# The JAX package's clamp, measured on a TPU v5e, where its XLA row gather
# slowed 4x at 2^22 total frontier rows (a 128 MB table).  Kept as it is
# for now; the H100's own limit (50 MB L2, 80 GB HBM) is still to be
# measured.
MAX_PREFIX_LEVELS = 21


class PrefixBackend(FrontierConsumerMixin, WalkBackend):
    """Prefix-shared DCF evaluator (lam = 16, shared points).

    ``prefix_levels`` picks k (clamped to n-8 and MAX_PREFIX_LEVELS, less
    ceil(log2 K) for K keys); the frontier of each party is built lazily
    on the first ``eval_staged(b, ...)`` and cached with the key image.
    Per-key point batches have no shared prefix to exploit and stay on
    ``WalkBackend``.
    """

    def __init__(self, lam: int, cipher_keys: Sequence[bytes],
                 prefix_levels: int = MAX_PREFIX_LEVELS,
                 host_levels: int = 6, device=None):
        super().__init__(lam, cipher_keys, device=device)
        if prefix_levels < host_levels:
            # api-edge: constructor prefix_levels contract
            raise ValueError(
                f"prefix_levels must be >= host_levels={host_levels}")
        if host_levels < 5:
            # api-edge: constructor host_levels contract
            raise ValueError("need at least 5 host levels")
        self.prefix_levels = min(prefix_levels, MAX_PREFIX_LEVELS)
        self.host_levels = host_levels
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ReferenceContractWarning)
            self._prg = HirosePrgNp(lam, cipher_keys)
        self.invalidate_frontier()
        self._bundle_host = None

    def _k(self) -> int:
        """Effective prefix depth for the held bundle: at least 8 walked
        levels (so the t stash always sits below one PRG call), and the
        stacked table of K keys kept within 2^MAX_PREFIX_LEVELS rows;
        floored at 5."""
        k_num, n = self._dims()
        k_cap = MAX_PREFIX_LEVELS - (k_num - 1).bit_length()
        return max(min(self.prefix_levels, n - 8, k_cap), 5)

    def put_bundle(self, bundle: KeyBundle) -> None:
        if 8 * bundle.n_bytes < self.host_levels + 8:
            raise ShapeError(
                f"domain of {8 * bundle.n_bytes} levels is too shallow "
                "for prefix sharing; use WalkBackend")
        super().put_bundle(bundle)
        self.invalidate_frontier()  # new key image: drop old frontiers
        self._bundle_host = bundle

    def _build_frontier_tables(self, b: int) -> torch.Tensor:
        """Party ``b``'s frontier table uint8 [K * 2^k, 32], per-key
        tables stacked: k0 levels on the host, k0..k with kernel B2."""
        k = self._k()
        k0 = min(self.host_levels, k)
        kb = self._bundle_host
        dev = self._bundle_dev
        tables = []
        for key in range(kb.num_keys):
            one = KeyBundle(
                s0s=kb.s0s[key:key + 1], cw_s=kb.cw_s[key:key + 1],
                cw_v=kb.cw_v[key:key + 1], cw_t=kb.cw_t[key:key + 1],
                cw_np1=kb.cw_np1[key:key + 1], group=kb.group)
            with span("frontier_host_levels"):
                s, v, t = (torch.from_numpy(a).to(self.device) for a in
                           tree_expand_np(self._prg, one, int(b), k0))
            with span("frontier_device_levels"):
                s, v, t = tree_expand(self.aes, dev["cw_s"][key],
                                      dev["cw_v"][key], dev["cw_t"][key], s,
                                      v, t, k0=k0, k1=k, group=self._group)
                tables.append(frontier_table(s, v, t))
        return tables[0] if len(tables) == 1 else torch.cat(tables)

    def stage(self, xs) -> dict:
        """Ship shared points [M, nb] to the device, tagged with the prefix
        geometry (k, n) they are staged for."""
        with span("stage"):
            xs, m = self._prepare(xs)
            if m == 0:
                raise ShapeError("cannot stage an empty batch")
            if xs.shape[0] != 1:
                raise ShapeError(
                    "PrefixBackend wants shared points [M, nb]; use "
                    "WalkBackend for per-key point batches")
            return {"xs": torch.from_numpy(xs).to(self.device), "m": m,
                    "k": self._k(), "n": 8 * xs.shape[-1]}

    def _check_staged_fresh(self, staged: dict) -> None:
        """Reject staged points cut for a bundle geometry this backend no
        longer holds.  A dict staged for one (k, n) stays valid for any
        bundle of the same geometry, the other party's backend included;
        a put_bundle that changed k (a different key count) or n would pair
        the points with the wrong frontier depth."""
        if "k" not in staged:
            # api-edge: documented staged-protocol contract (a non-prefix dict)
            raise ValueError("staged dict is not from a prefix backend's "
                             "stage")
        k_now, n_now = self._k(), self._dims()[1]
        if staged["k"] != k_now or staged["n"] != n_now:
            raise StaleStateError(
                f"staged points are stale: staged at prefix depth "
                f"k={staged['k']} over an n={staged['n']}-level domain, but "
                f"the backend now holds a bundle with k={k_now}, "
                f"n={n_now}; re-stage the points after put_bundle")

    def eval_staged(self, b: int, staged: dict) -> torch.Tensor:
        with span("eval_staged"):
            self._check_staged_fresh(staged)
            table = self._frontier_tables(b)
            dev = self._bundle_dev
            return prefix_eval(self.aes, table, dev["cw_s"], dev["cw_v"],
                               dev["cw_t"], dev["cw_np1"], staged["xs"],
                               k=staged["k"],
                               negate=bool(b) and self._group != "xor",
                               group=self._group)

    def eval(self, b: int, xs, bundle: KeyBundle | None = None) -> np.ndarray:
        """Bytes-in/bytes-out convenience path (shared points)."""
        if bundle is not None:
            self.put_bundle(bundle)
        xs = np.asarray(xs)
        if xs.ndim == 3:
            if xs.shape[0] != 1:
                raise ShapeError(
                    "PrefixBackend wants shared points; use WalkBackend for "
                    "per-key point batches")
            xs = xs[0]
        staged = self.stage(xs)
        return self.staged_to_bytes(self.eval_staged(b, staged),
                                    staged["m"])
