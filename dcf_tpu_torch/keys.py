"""Key material: structure-of-arrays bundles.

Counterpart of ``KeyBundle`` in ``dcf_tpu/keys.py`` (its lines 145-244):
K stacked DCF keys, shared by both parties except for the starting seeds.

    s0s     uint8 [K, P, lam]   starting seeds (P = 2 from gen, 1 per party)
    cw_s    uint8 [K, n, lam]   correction-word seeds
    cw_v    uint8 [K, n, lam]   correction-word values
    cw_t    uint8 [K, n, 2]     (tl, tr) bits
    cw_np1  uint8 [K, lam]      final correction word

These arrays are also the device image: the port's backends ship them to
the card as they are.  ``KeyBundle.from_arrays`` takes the same five
arrays from any source (for instance the JAX package's bundle fields), so
both packages can evaluate the same keys.  The DCFK wire codec is not
part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.spec import check_group

__all__ = ["KeyBundle"]


@dataclass(frozen=True)
class KeyBundle:
    """K stacked DCF keys in structure-of-arrays layout."""

    s0s: np.ndarray  # uint8 [K, P, lam], P in {1, 2}
    cw_s: np.ndarray  # uint8 [K, n, lam]
    cw_v: np.ndarray  # uint8 [K, n, lam]
    cw_t: np.ndarray  # uint8 [K, n, 2]
    cw_np1: np.ndarray  # uint8 [K, lam]
    group: str = "xor"  # output group (spec.GROUPS)

    def __post_init__(self):
        for a in (self.s0s, self.cw_s, self.cw_v, self.cw_t, self.cw_np1):
            if not isinstance(a, np.ndarray) or a.dtype != np.uint8:
                raise ShapeError("all bundle arrays must be uint8 numpy "
                                 "arrays")
        if self.cw_s.ndim != 3:
            raise ShapeError("cw_s must be [K, n, lam]")
        k, n, lam = self.cw_s.shape
        try:
            check_group(self.group, lam)
        except ValueError as e:
            raise ShapeError(str(e)) from None
        if self.s0s.ndim != 3 or self.s0s.shape[0] != k \
                or self.s0s.shape[2] != lam:
            raise ShapeError("s0s shape mismatch")
        if self.s0s.shape[1] not in (1, 2):
            raise ShapeError("s0s party dimension must be 1 or 2")
        if self.cw_v.shape != (k, n, lam) or self.cw_t.shape != (k, n, 2):
            raise ShapeError("cw shape mismatch")
        if self.cw_np1.shape != (k, lam):
            raise ShapeError("cw_np1 shape mismatch")
        if n % 8 != 0:
            raise ShapeError("n must be a multiple of 8 bits")

    def __repr__(self) -> str:
        """Redacted: shapes/geometry only, never seed or CW bytes (the
        arrays are the key material)."""
        k, n, lam = self.cw_s.shape
        secret_bytes = sum(
            a.nbytes
            for a in (self.s0s, self.cw_s, self.cw_v, self.cw_t,
                      self.cw_np1))
        return (f"KeyBundle(K={k}, n_bits={n}, lam={lam}, "
                f"parties={self.s0s.shape[1]}, group={self.group}, "
                f"<{secret_bytes} key-material bytes redacted>)")

    @classmethod
    def from_arrays(cls, s0s, cw_s, cw_v, cw_t, cw_np1,
                    group: str = "xor") -> "KeyBundle":
        """Build a bundle from the five key arrays of another package or a
        wire decoder (array-likes, copied into fresh contiguous uint8
        arrays).  Only the dtype is enforced here, as uint8 without a
        value-changing cast; the shapes are checked like any bundle's."""
        arrays = []
        for name, a in (("s0s", s0s), ("cw_s", cw_s), ("cw_v", cw_v),
                        ("cw_t", cw_t), ("cw_np1", cw_np1)):
            a = np.asarray(a)
            if a.dtype != np.uint8:
                raise ShapeError(f"{name} must be uint8 (got {a.dtype})")
            arrays.append(np.array(a, dtype=np.uint8, order="C", copy=True))
        return cls(*arrays, group=group)

    @property
    def num_keys(self) -> int:
        return self.cw_s.shape[0]

    @property
    def n_bits(self) -> int:
        return self.cw_s.shape[1]

    @property
    def n_bytes(self) -> int:
        return self.cw_s.shape[1] // 8

    @property
    def lam(self) -> int:
        return self.cw_s.shape[2]

    def for_party(self, b: int) -> "KeyBundle":
        """Restrict to party ``b``'s starting seed (s0s[:, b:b+1])."""
        if self.s0s.shape[1] != 2:
            raise ShapeError("bundle already restricted to one party")
        if b not in (0, 1):
            raise ValueError(f"party must be 0 or 1, got {b}")
        return KeyBundle(
            s0s=self.s0s[:, b: b + 1].copy(),
            cw_s=self.cw_s,
            cw_v=self.cw_v,
            cw_t=self.cw_t,
            cw_np1=self.cw_np1,
            group=self.group,
        )
