"""Tree (breadth-first) full-domain evaluation at lam = 16.

Counterpart of ``dcf_tpu/backends/fulldomain.py``.  The per-point check
(``workloads.core.full_domain_check_device``) walks every point's full
n-level path; ``TreeFullDomain`` expands the GGM tree once instead: the
host numpy walk (``tree_expand_np``) expands the small top (levels 0..k0,
2^k0 nodes), the frontier ships to the card, kernel B2
(``ops.tree_expand``) doubles the node arrays level by level and its
leaf-level form B2f writes the leaf shares.  PRG work drops from n * 2^n
to about 2^(n+1) calls.  The prefix backend uses ``tree_expand_np`` for
the top of its frontier too.

Leaves come out in bitreverse_n order (each level stores [lefts ;
rights]); the verifier computes each position's domain value
arithmetically, so nothing is gathered back to natural order.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import (
    StagedFrontierCache,
    bitrev_values,
    resolve_device,
    to_device,
    xor_mismatch_count,
)
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.ops.tree_expand import tree_expand_device
from dcf_tpu_torch.ops.walk_eval import aes_image
from dcf_tpu_torch.spec import (
    ReferenceContractWarning,
    hirose_used_cipher_indices,
)
from dcf_tpu_torch.utils.groups import bytes_of, lanes_of

__all__ = ["TreeFullDomain", "tree_expand_np", "leaf_mismatch_count"]


def tree_expand_np(prg: HirosePrgNp, bundle: KeyBundle, b: int,
                   levels: int):
    """Host breadth-first expansion of one party's key to ``levels`` deep.

    Returns (s [N, lam], v [N, lam], t [N]) with N = 2^levels in
    bitreverse order (position = sum of dir_i 2^i over the MSB-first walk
    directions): each level stores [all left children ; all right
    children].  Single key (the bundle's first).

    For additive groups the pushed-down value accumulator is the UNSIGNED
    per-lane sum; consumers apply the party sign once at their output.
    """
    group = bundle.group
    lam = bundle.lam
    s = bundle.s0s[:1, 0, :].copy()
    t = np.array([b], dtype=np.uint8)
    v = np.zeros((1, lam), dtype=np.uint8)
    for i in range(levels):
        p = prg.gen(s)
        cs = bundle.cw_s[0, i]
        cv = bundle.cw_v[0, i]
        ctl, ctr = bundle.cw_t[0, i]
        tc = t[:, None]
        s_l = p.s_l ^ cs * tc
        s_r = p.s_r ^ cs * tc
        if group == "xor":
            v_l = v ^ p.v_l ^ cv * tc
            v_r = v ^ p.v_r ^ cv * tc
        else:
            lv = lanes_of(v, group)
            cvg = lanes_of(np.ascontiguousarray(cv[None, :]), group) \
                * tc.astype(lv.dtype)
            v_l = bytes_of(lv + lanes_of(p.v_l, group) + cvg, group)
            v_r = bytes_of(lv + lanes_of(p.v_r, group) + cvg, group)
        t_l = p.t_l ^ (t & ctl)
        t_r = p.t_r ^ (t & ctr)
        s = np.concatenate([s_l, s_r])
        v = np.concatenate([v_l, v_r])
        t = np.concatenate([t_l, t_r])
    return s, v, t


class TreeFullDomain(StagedFrontierCache):
    """Full-domain evaluator and verifier on the tree kernels (lam = 16,
    one XOR-group key).

    ``host_levels`` is k0, the levels expanded on the host (capped at
    n - 1: the last level always runs on the device, where B2f finalizes
    it).  Repeated checks of the same bundle object reuse the shipped
    correction words and frontiers (``StagedFrontierCache``).
    """

    def __init__(self, lam: int, cipher_keys: Sequence[bytes],
                 host_levels: int = 6, device=None):
        if lam != 16:
            raise ValueError(f"TreeFullDomain supports lam=16 only, "
                             f"got {lam}")
        if host_levels < 0:
            raise ValueError(f"host_levels must be >= 0, got {host_levels}")
        used = hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self.host_levels = host_levels
        self.device = resolve_device(device)
        self.aes = to_device(aes_image(cipher_keys[used[0]]), self.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ReferenceContractWarning)
            self._prg = HirosePrgNp(lam, cipher_keys)

    @staticmethod
    def _check_xor(bundle: KeyBundle) -> None:
        # The leaf finalize (B2f) and the verifier reconstruct by XOR;
        # additive full-domain nodes come from tree_expand_np or
        # ops.tree_expand.tree_expand, which carry the group.
        if bundle.group != "xor":
            raise ShapeError(
                f"TreeFullDomain finalize is XOR-only; bundle has group "
                f"{bundle.group!r}")

    def _stage_cw(self, bundle: KeyBundle):
        """Ship the party-independent correction words of the first key:
        (cw_s [n, 16], cw_v [n, 16], cw_t [n, 2], cw_np1 [16])."""
        return tuple(to_device(a[0], self.device) for a in (
            bundle.cw_s, bundle.cw_v, bundle.cw_t, bundle.cw_np1))

    def _frontier(self, bundle: KeyBundle, b: int, k0: int):
        """Host-expand to level k0 and ship: (s [2^k0, 16], v, t)."""
        return tuple(to_device(a, self.device)
                     for a in tree_expand_np(self._prg, bundle, b, k0))

    def eval_party(self, b: int, bundle: KeyBundle, n_bits: int,
                   staged_cw=None, frontier=None) -> torch.Tensor:
        """Party ``b``'s full-domain leaf shares: a device tensor uint8
        [2^n_bits, 16] in bitreverse order.  ``bundle`` must be
        party-restricted (``for_party(b)``).  ``staged_cw`` / ``frontier``
        reuse earlier ``_stage_cw`` / ``_frontier`` results (the CW image
        is party-independent, the frontier per party)."""
        if bundle.n_bits != n_bits:
            raise ShapeError("bundle depth mismatch")
        self._check_xor(bundle)
        if bundle.s0s.shape[1] != 1:
            raise ShapeError("eval_party wants a party-restricted bundle")
        k0 = self._k0(n_bits)
        cw_s, cw_v, cw_t, cw_np1 = (
            staged_cw if staged_cw is not None else self._stage_cw(bundle))
        s, v, t = (frontier if frontier is not None
                   else self._frontier(bundle, b, k0))
        return tree_expand_device(self.aes, cw_s, cw_v, cw_t, cw_np1, s, v,
                                  t, k0=k0, n=n_bits)

    def _staged_for(self, bundle: KeyBundle, n_bits: int):
        self._check_xor(bundle)
        return super()._staged_for(bundle, n_bits)

    def check_device(self, bundle: KeyBundle, alpha: int, beta: bytes,
                     n_bits: int, gt: bool = False) -> torch.Tensor:
        """Two-party full-domain reconstruction against the plain
        comparison, all on the device; returns the number of mismatching
        leaves as a device int64 scalar (repeated checks can add up
        without a host round trip each).  ``bundle`` is the two-party
        bundle."""
        staged_cw, fronts, parts = self._staged_for(bundle, n_bits)
        y0 = self.eval_party(0, parts[0], n_bits, staged_cw, fronts[0])
        y1 = self.eval_party(1, parts[1], n_bits, staged_cw, fronts[1])
        return leaf_mismatch_count(y0, y1, int(alpha), beta, n_bits, gt)

    def check(self, bundle: KeyBundle, alpha: int, beta: bytes,
              n_bits: int, gt: bool = False) -> int:
        return int(self.check_device(bundle, alpha, beta, n_bits, gt))


def leaf_mismatch_count(y0: torch.Tensor, y1: torch.Tensor, alpha: int,
                        beta: bytes, n_bits: int,
                        gt: bool = False) -> torch.Tensor:
    """The number of leaves whose XOR reconstruction differs from ``beta
    if value < alpha else 0`` (``>`` for gt), where the leaf at position p
    of y0/y1 uint8 [2^n_bits, 16] holds domain value bitreverse_n(p).  A
    device int64 scalar."""
    value = bitrev_values(n_bits, y0.device)
    inside = (value > alpha) if gt else (value < alpha)
    return xor_mismatch_count(y0, y1, inside, beta)
