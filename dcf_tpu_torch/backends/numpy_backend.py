"""Vectorized numpy evaluation backend: the port's own host oracle.

Counterpart of ``dcf_tpu/backends/numpy_backend.py``.  Evaluates K keys x
M points in one level-synchronous sweep, all (key, point) pairs together
one level at a time.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.utils.groups import lanes_of, np_group_neg

__all__ = ["eval_batch_np"]


def eval_batch_np(
    prg: HirosePrgNp,
    b: int,
    bundle: KeyBundle,
    xs: np.ndarray,
) -> np.ndarray:
    """Evaluate party ``b``'s share of each key on each point.

    xs: uint8 [M, n_bytes] (shared by all keys) or [K, M, n_bytes].
    Returns uint8 [K, M, lam].

    Additive groups accumulate unsigned and party 1 negates once at the
    output edge, so reconstruction is always ``group_add(y0, y1)``.
    """
    k_num, n, lam = bundle.cw_s.shape
    group = bundle.group
    if xs.ndim == 2:
        xs = np.broadcast_to(xs, (k_num, *xs.shape))
    if xs.shape[0] != k_num or xs.shape[2] * 8 != n:
        raise ShapeError("xs shape mismatch with bundle")
    m = xs.shape[1]
    x_bits = np.unpackbits(xs, axis=2)  # MSB-first [K, M, n]

    s = np.broadcast_to(bundle.s0s[:, 0, None, :], (k_num, m, lam)).copy()
    t = np.full((k_num, m), np.uint8(b), dtype=np.uint8)
    v = np.zeros((k_num, m, lam), dtype=np.uint8)

    for i in range(n):
        p = prg.gen(s)
        t_mask = t[..., None]  # uint8 {0,1} [K, M, 1]
        cw_s = bundle.cw_s[:, None, i, :]  # [K, 1, lam]
        cw_v = bundle.cw_v[:, None, i, :]
        cw_tl = bundle.cw_t[:, None, i, 0]
        cw_tr = bundle.cw_t[:, None, i, 1]
        s_l = p.s_l ^ cw_s * t_mask
        s_r = p.s_r ^ cw_s * t_mask
        t_l = p.t_l ^ (t & cw_tl)
        t_r = p.t_r ^ (t & cw_tr)
        x_i = x_bits[:, :, i]  # [K, M], 1 -> right
        xb = x_i[..., None].astype(bool)
        if group == "xor":
            v ^= np.where(xb, p.v_r, p.v_l) ^ cw_v * t_mask
        else:
            v_hat = np.where(xb, p.v_r, p.v_l)
            lv = lanes_of(v, group)  # a view: updates v in place
            lv += lanes_of(v_hat, group)
            lv += (lanes_of(np.ascontiguousarray(cw_v), group)
                   * t_mask.astype(lv.dtype))
        s = np.where(xb, s_r, s_l)
        t = np.where(x_i.astype(bool), t_r, t_l)

    if group == "xor":
        return v ^ s ^ bundle.cw_np1[:, None, :] * t[..., None]
    lv = lanes_of(v, group)
    lv += lanes_of(np.ascontiguousarray(s), group)
    lv += (lanes_of(np.ascontiguousarray(bundle.cw_np1[:, None, :]), group)
           * t[..., None].astype(lv.dtype))
    return np_group_neg(v, group) if b else v
