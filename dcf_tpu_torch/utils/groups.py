"""Vectorized output-group arithmetic on payload byte arrays (numpy).

Counterpart of ``dcf_tpu/utils/groups.py``.  A payload axis of ``lam``
uint8 bytes is read as ``8*lam/w`` little-endian w-bit lanes (explicit
``<u{w/8}`` dtypes, so the view is byte-order-correct on any host) and
all arithmetic wraps mod 2^w per lane.  For XOR every helper degenerates
to ``^`` / identity.
"""

from __future__ import annotations

import numpy as np

from dcf_tpu_torch.spec import GROUP_WIDTH, check_group

__all__ = [
    "group_width",
    "lane_dtype",
    "lanes_of",
    "bytes_of",
    "np_group_add",
    "np_group_sub",
    "np_group_neg",
    "np_group_reduce",
]

_LANE_DTYPE = {"add8": np.dtype("<u1"), "add16": np.dtype("<u2"),
               "add32": np.dtype("<u4")}


def group_width(group: str) -> int:
    """Lane width of an additive group in bits; 0 for XOR."""
    return GROUP_WIDTH.get(group, 0)


def lane_dtype(group: str) -> np.dtype:
    """The little-endian unsigned lane dtype of an additive group."""
    return _LANE_DTYPE[group]


def lanes_of(a: np.ndarray, group: str) -> np.ndarray:
    """uint8 [..., lam] -> lane view [..., 8*lam/w] (copy-free when
    contiguous).  The trailing axis must be the payload byte axis."""
    return np.ascontiguousarray(a).view(_LANE_DTYPE[group])


def bytes_of(lanes: np.ndarray, group: str) -> np.ndarray:
    """Inverse of :func:`lanes_of`: lane array -> uint8 byte array."""
    return np.ascontiguousarray(lanes.astype(_LANE_DTYPE[group],
                                             copy=False)).view(np.uint8)


def np_group_add(a: np.ndarray, b: np.ndarray, group: str) -> np.ndarray:
    """Group add on uint8 payload arrays (trailing axis = bytes)."""
    if group == "xor":
        return a ^ b
    return bytes_of(lanes_of(a, group) + lanes_of(b, group), group)


def np_group_sub(a: np.ndarray, b: np.ndarray, group: str) -> np.ndarray:
    """Group subtract ``a - b`` on uint8 payload arrays."""
    if group == "xor":
        return a ^ b
    return bytes_of(lanes_of(a, group) - lanes_of(b, group), group)


def np_group_neg(a: np.ndarray, group: str) -> np.ndarray:
    """Group negation on uint8 payload arrays (identity for XOR)."""
    if group == "xor":
        return a
    return bytes_of(-lanes_of(a, group), group)


def np_group_reduce(rows: np.ndarray, group: str, axis: int = 0) -> np.ndarray:
    """Group sum-reduce over ``axis`` of a uint8 payload array stack."""
    if group == "xor":
        return np.bitwise_xor.reduce(rows, axis=axis)
    w = GROUP_WIDTH[group]
    check_group(group, rows.shape[-1])
    acc = lanes_of(rows, group).astype(np.uint64).sum(axis=axis)
    return bytes_of(acc & np.uint64((1 << w) - 1), group)
