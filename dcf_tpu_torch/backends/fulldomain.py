"""Host breadth-first expansion of the top of the GGM tree.

Counterpart of ``tree_expand_np`` in ``dcf_tpu/backends/fulldomain.py``
(its lines 45-87).  The prefix backend expands the tiny, irregular top
``host_levels`` of the tree here and ships that frontier to the card,
where kernel B2 (``ops.tree_expand``) doubles it level by level.  The
full-domain evaluator of that module is not part of this package yet.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.utils.groups import bytes_of, lanes_of

__all__ = ["tree_expand_np"]


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
