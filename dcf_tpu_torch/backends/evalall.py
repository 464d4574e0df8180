"""Full-domain DPF evaluation (EvalAll) at lam = 32: the PIR engine.

Counterpart of ``dcf_tpu/backends/evalall.py``.  ``backends.fulldomain``
expands the lam = 16 DCF tree; this is its DPF twin at the two-block
width: kernel B6 (``ops.evalall_expand``) doubles the node arrays level
by level from the roots (or from a frontier the host numpy walk,
``dpf_tree_expand_np``, expanded to level k0), applying the leaf
correction on the last one.  PRG work
drops from n * 2^n per-point walks to about 2^(n+1) level-order calls per
key, which is what makes 2-server PIR economic: every query touches the
whole database, so the cost per leaf is the cost of a query
(``workloads.pir`` reads ``eval_party``'s leaf t bits, packed, as the
selection-vector share).

Leaves come out in bitreverse_n order (each level stores [lefts ;
rights] per key); the verifier computes the position of alpha
arithmetically, so nothing is gathered back to natural order.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import (
    StagedFrontierCache,
    resolve_device,
    to_device,
)
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops.evalall_expand import evalall_expand
from dcf_tpu_torch.ops.narrow_walk import narrow_aes_image
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.protocols.dpf import DPF_DEVICE_LAM, DpfBundle
from dcf_tpu_torch.spec import (
    ReferenceContractWarning,
    hirose_used_cipher_indices,
)

__all__ = ["DpfEvalAll", "dpf_finalize_np", "dpf_tree_expand_np",
           "leaves_to_bytes", "bitrev"]


def bitrev(value: int, n_bits: int) -> int:
    """bitreverse_n of a Python int: the leaf position of a domain value
    (and back)."""
    return int(format(value, f"0{n_bits}b")[::-1], 2) if n_bits else 0


def dpf_tree_expand_np(prg: HirosePrgNp, bundle: DpfBundle, b: int,
                       levels: int):
    """Host breadth-first expansion of party ``b``'s K keys to ``levels``
    deep.

    Returns (s [K, N, lam], t [K, N]) with N = 2^levels in bitreverse
    order (position = sum of dir_i 2^i over the MSB-first walk
    directions).  It is the oracle the kernel is tested against and the
    portable EvalAll for any lam.
    """
    col = b if bundle.s0s.shape[1] == 2 else 0
    s = bundle.s0s[:, col, None, :].copy()  # [K, 1, lam]
    t = np.full((bundle.num_keys, 1), b, dtype=np.uint8)
    for i in range(levels):
        p = prg.gen(s)
        cs = bundle.cw_s[:, None, i, :]
        ctl = bundle.cw_t[:, None, i, 0]
        ctr = bundle.cw_t[:, None, i, 1]
        tc = t[..., None]
        s = np.concatenate([p.s_l ^ cs * tc, p.s_r ^ cs * tc], axis=1)
        t = np.concatenate([p.t_l ^ (t & ctl), p.t_r ^ (t & ctr)], axis=1)
    return s, t


def dpf_finalize_np(bundle: DpfBundle, s: np.ndarray,
                    t: np.ndarray) -> np.ndarray:
    """Leaf shares from a host expansion at full depth:
    ``y = s ^ cw_np1 * t``, uint8 [K, N, lam]."""
    return s ^ bundle.cw_np1[:, None, :] * t[..., None]


def leaves_to_bytes(y: torch.Tensor, t: torch.Tensor):
    """``eval_party``'s device outputs as host bytes: (y uint8 [K, N, 32],
    t uint8 [K, N]), leaf order unchanged (bitreverse_n).  The facade's
    fetch."""
    return y.cpu().numpy(), t.cpu().numpy()


class DpfEvalAll(StagedFrontierCache):
    """Full-domain K-packed DPF evaluator and verifier (lam = 32).

    The DPF twin of ``fulldomain.TreeFullDomain``: kernel B6 expands each
    key's tree level by level, finalizing in its last launch; the top
    ``host_levels`` levels may instead be expanded on the host.
    ``eval_party`` returns the leaf shares and the leaf t bytes, or the t
    bits alone, packed: the PIR selection-vector share.  Repeated calls on the same bundle object
    reuse the shipped CW image and frontiers (``StagedFrontierCache``; the
    PIR server's resident key).

    ``host_levels`` defaults to 0: the whole tree runs on the device, from
    the roots, and a fresh key costs no host PRG call (the numpy walk of
    the top levels took most of a 2^24-record PIR batch on an H100,
    PERF.md).  The leaves are the same bytes at any depth.  It is capped
    at depth - 1, so the last level always runs on the device.  The JAX
    package wants at least 5 host levels, one 32-node lane word of its
    plane layout; the byte-row layout here has no such floor, and any
    host_levels >= 0 is taken.
    """

    def __init__(self, lam: int, cipher_keys: Sequence[bytes],
                 host_levels: int = 0, device=None):
        if lam != DPF_DEVICE_LAM:
            raise ValueError(
                f"DpfEvalAll supports lam={DPF_DEVICE_LAM} only, got {lam}")
        if host_levels < 0:
            raise ValueError(f"host_levels must be >= 0, got {host_levels}")
        used = hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self.host_levels = host_levels
        self.device = resolve_device(device)
        self.aes = to_device(
            narrow_aes_image(cipher_keys[used[0]], cipher_keys[used[1]]),
            self.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ReferenceContractWarning)
            self._prg = HirosePrgNp(lam, cipher_keys)

    def _stage_cw(self, bundle: DpfBundle):
        """Ship the party-independent correction words once: (cw_s
        [K, n, 32], cw_t [K, n, 2], cw_np1 [K, 32])."""
        return tuple(to_device(a, self.device)
                     for a in (bundle.cw_s, bundle.cw_t, bundle.cw_np1))

    def _frontier(self, bundle: DpfBundle, b: int, k0: int):
        """Host-expand to level k0 and ship: (s [K, 2^k0, 32], t)."""
        return tuple(to_device(a, self.device)
                     for a in dpf_tree_expand_np(self._prg, bundle, b, k0))

    def eval_party(self, b: int, bundle: DpfBundle, n_bits: int,
                   staged_cw=None, frontier=None, want_y: bool = True):
        """Party ``b``'s full-domain leaves as device tensors ``(y uint8
        [K, 2^n_bits, 32], t uint8 [K, 2^n_bits])``, bitreverse_n order.
        ``bundle`` must be party-restricted (``for_party(b)``).
        ``staged_cw`` / ``frontier`` reuse earlier ``_stage_cw`` /
        ``_frontier`` results.  ``want_y=False`` returns ``(None,
        t_words)`` and writes no leaf share: the t bits packed, int32
        [K, ceil(2^n_bits / 32)] (the PIR server's selection, the
        reference's ``t_words``).

        ``n_bits < bundle.n_bits`` is a prefix evaluation: the walk stops
        at depth ``n_bits``, where the t bytes are the one-hot share of
        alpha's top ``n_bits`` bits, the PIR selection vector of a
        database whose domain need not be byte-granular (the wire format
        is; see ``workloads.pir.pir_query_bundle``).  y is the leaf share
        only at full depth (the leaf correction lands on inner seeds
        otherwise); prefix callers read only ``t``."""
        if not 1 <= n_bits <= bundle.n_bits:
            raise ShapeError(
                f"bundle walks {bundle.n_bits} levels, cannot evaluate "
                f"{n_bits} deep")
        if bundle.lam != self.lam:
            raise ShapeError(f"bundle lam {bundle.lam} is not {self.lam}")
        if bundle.s0s.shape[1] != 1:
            raise ShapeError("eval_party wants a party-restricted bundle")
        k0 = self._k0(n_bits)
        cw_s, cw_t, cw_np1 = (
            staged_cw if staged_cw is not None else self._stage_cw(bundle))
        s, t = (frontier if frontier is not None
                else self._frontier(bundle, b, k0))
        return evalall_expand(self.aes, cw_s, cw_t, cw_np1, s, t, k0=k0,
                              k1=n_bits, want_y=want_y)

    def check_device(self, bundle: DpfBundle, alphas, betas: np.ndarray,
                     n_bits: int) -> torch.Tensor:
        """Two-party full-domain reconstruction against the point
        function, all on the device; returns the number of mismatching
        leaves (over all keys and the whole 2^n_bits domain) as a device
        int64 scalar.  ``bundle`` is the two-party bundle at full depth;
        ``alphas`` the K point values (ints < 2^n_bits), ``betas`` uint8
        [K, 32]."""
        if n_bits != bundle.n_bits:
            raise ShapeError(
                f"the leaf shares exist only at full depth "
                f"{bundle.n_bits}, not at {n_bits}")
        staged_cw, fronts, parts = self._staged_for(bundle, n_bits)
        y0, _ = self.eval_party(0, parts[0], n_bits, staged_cw, fronts[0])
        y1, _ = self.eval_party(1, parts[1], n_bits, staged_cw, fronts[1])
        return dpf_leaf_mismatch_count(y0, y1, alphas, betas, n_bits)

    def check(self, bundle: DpfBundle, alphas, betas, n_bits: int) -> int:
        return int(self.check_device(bundle, alphas, betas, n_bits))


def dpf_leaf_mismatch_count(y0: torch.Tensor, y1: torch.Tensor, alphas,
                            betas: np.ndarray, n_bits: int) -> torch.Tensor:
    """The number of leaves of y0 ^ y1 (uint8 [K, 2^n_bits, 32],
    bitreverse order) that differ from the point function: beta_k at
    position bitreverse_n(alpha_k) of key k, zero everywhere else.  A
    device int64 scalar."""
    k_num = y0.shape[0]
    betas = np.asarray(betas, dtype=np.uint8)
    hits = [bitrev(int(a), n_bits) for a in np.asarray(alphas).reshape(-1)]
    if len(hits) != k_num or betas.shape != (k_num, y0.shape[2]):
        raise ShapeError(f"alphas/betas do not fit {k_num} keys")
    recon = y0 ^ y1
    nonzero = (recon.view(torch.int64) != 0).any(-1)  # [K, N]
    keys = torch.arange(k_num, device=y0.device)
    hit = torch.tensor(hits, dtype=torch.int64, device=y0.device)
    wrong_hit = (recon[keys, hit] != to_device(betas, y0.device)).any(-1)
    return nonzero.sum() - nonzero[keys, hit].sum() + wrong_hit.sum()
