"""Key material: structure-of-arrays bundles and the DCFK wire codec.

Counterpart of ``dcf_tpu/keys.py``: K stacked DCF keys, shared by both
parties except for the starting seeds.

    s0s     uint8 [K, P, lam]   starting seeds (P = 2 from gen, 1 per party)
    cw_s    uint8 [K, n, lam]   correction-word seeds
    cw_v    uint8 [K, n, lam]   correction-word values
    cw_t    uint8 [K, n, 2]     (tl, tr) bits
    cw_np1  uint8 [K, lam]      final correction word

These arrays are also the device image: the port's backends ship them to
the card as they are.  ``KeyBundle.from_arrays`` takes the same five
arrays from any source (for instance the JAX package's bundle fields), so
both packages can evaluate the same keys.

DCFK bytes on the wire (``to_bytes`` / ``from_bytes``; byte-identical to
the JAX package's frames in both directions):

    offset  size            field
    0       4               magic ``b"DCFK"``
    4       2               version (uint16 LE)
    6       2               P, parties stored (2 full bundle, 1 per party)
    8       4               K, number of keys (uint32 LE)
    12      4               n, tree depth in bits (uint32 LE)
    16      2               lam, range size in bytes (uint16 LE)
    [18     2               proto (version >= 3); 0 = plain bundle]
    [20     2               group code (version 4; ``spec.GROUP_CODE``)]
    ...     K*P*lam         s0s, C-order uint8
    ...     K*n*lam         cw_s
    ...     K*n*lam         cw_v
    ...     K*n*2           cw_t (tl, tr per level)
    ...     K*lam           cw_np1
    end-4   4               crc32 of all prior bytes (version >= 2)

XOR bundles write version 2, additive bundles version 4; versions 1 (no
CRC trailer) and 3 with proto = 0 are still read.  A version-3 or -4
frame with proto != 0 belongs to a protocol decoder
(``protocols.ProtocolBundle`` for proto = 1, ``protocols.dpf`` for
proto = 2) and is refused here.  Decoding is strict: the header is checked field by
field, every section must fit, the size must match exactly, and any
violation raises ``KeyFormatError`` naming the field.
"""

from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from dcf_tpu_torch import spec
from dcf_tpu_torch.errors import KeyFormatError, ShapeError
from dcf_tpu_torch.spec import (
    GROUP_CODE,
    GROUP_FROM_CODE,
    GROUP_WIDTH,
    check_group,
)

__all__ = ["KeyBundle"]

_MAGIC = b"DCFK"
_VERSION = 2
_HEADER = "<HHIIH"  # version, P, K, n, lam (after the 4-byte magic)
_HEADER_SIZE = 4 + struct.calcsize(_HEADER)
_CRC_SIZE = 4
_VERSION_PROTO = 3  # the v2 header plus a uint16 proto field
_HEADER3 = "<HHIIHH"
_HEADER3_SIZE = 4 + struct.calcsize(_HEADER3)
_VERSION_GROUP = 4  # the v3 header plus a uint16 output-group code
_HEADER4 = "<HHIIHHH"
_HEADER4_SIZE = 4 + struct.calcsize(_HEADER4)


def _decode_sections(data: bytes, sections, header_size: int,
                     crc_size: int, claims: str) -> dict[str, np.ndarray]:
    """The strict section decode shared by every DCFK reader of the port
    (``KeyBundle.from_bytes`` and ``protocols.dpf.DpfBundle.from_bytes``).

    ``sections``: ordered ``(name, shape)`` uint8 section table; ``claims``:
    the header's geometry rendered for error messages.  Bounds-checks
    every section against the frame before touching the payload (so a
    truncated frame names the field where it ran out), requires the total
    size to match exactly, verifies the CRC32 trailer when ``crc_size`` is
    nonzero, then returns the decoded arrays by name.
    """
    payload_end = len(data) - crc_size
    off = header_size
    for name, shape in sections:
        size = math.prod(shape)  # Python ints: no fixed-width overflow
        if off + size > payload_end:
            raise KeyFormatError(
                f"truncated frame: section {name!r} needs bytes "
                f"[{off}, {off + size}) but the payload ends at "
                f"{payload_end} (header claims {claims})")
        off += size
    if off != payload_end:
        raise KeyFormatError(
            f"oversized frame: {payload_end - off} trailing bytes after "
            f"section {sections[-1][0]!r} (corrupt header or concatenated "
            "frames)")
    if crc_size:
        (crc_stored,) = struct.unpack_from("<I", data, payload_end)
        # memoryview: hash in place, without a copy of the key image.
        crc_actual = zlib.crc32(memoryview(data)[:payload_end])
        if crc_stored != crc_actual:
            raise KeyFormatError(
                f"crc32 mismatch: trailer records {crc_stored:#010x}, "
                f"frame hashes to {crc_actual:#010x}; key material is "
                "corrupt")
    off = header_size
    arrays: dict[str, np.ndarray] = {}
    for name, shape in sections:
        size = math.prod(shape)
        arr = np.frombuffer(data, dtype=np.uint8, count=size, offset=off)
        arrays[name] = arr.reshape(shape).copy()
        off += size
    return arrays


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

    def level_major(self) -> dict[str, np.ndarray]:
        """The arrays with the level axis leading: contiguous ``s0``
        [K, lam] (party-restricted bundles only), ``cw_s`` / ``cw_v``
        [n, K, lam], ``cw_t`` [n, K, 2], ``cw_np1`` [K, lam]."""
        if self.s0s.shape[1] != 1:
            raise ShapeError("level_major requires a party-restricted bundle")
        return dict(
            s0=np.ascontiguousarray(self.s0s[:, 0, :]),
            cw_s=np.ascontiguousarray(self.cw_s.transpose(1, 0, 2)),
            cw_v=np.ascontiguousarray(self.cw_v.transpose(1, 0, 2)),
            cw_t=np.ascontiguousarray(self.cw_t.transpose(1, 0, 2)),
            cw_np1=np.ascontiguousarray(self.cw_np1),
        )

    # -- golden-model interop ------------------------------------------------

    @classmethod
    def from_shares(cls, shares: list[spec.Share],
                    group: str = "xor") -> "KeyBundle":
        """Stack ``spec.Share`` keys (all of one geometry) into a bundle."""
        k = len(shares)
        n = len(shares[0].cws)
        lam = len(shares[0].cw_np1)
        p = len(shares[0].s0s)
        s0s = np.zeros((k, p, lam), dtype=np.uint8)
        cw_s = np.zeros((k, n, lam), dtype=np.uint8)
        cw_v = np.zeros((k, n, lam), dtype=np.uint8)
        cw_t = np.zeros((k, n, 2), dtype=np.uint8)
        cw_np1 = np.zeros((k, lam), dtype=np.uint8)
        for i, sh in enumerate(shares):
            for j, s0 in enumerate(sh.s0s):
                s0s[i, j] = np.frombuffer(s0, dtype=np.uint8)
            for j, cw in enumerate(sh.cws):
                cw_s[i, j] = np.frombuffer(cw.s, dtype=np.uint8)
                cw_v[i, j] = np.frombuffer(cw.v, dtype=np.uint8)
                cw_t[i, j] = (cw.tl, cw.tr)
            cw_np1[i] = np.frombuffer(sh.cw_np1, dtype=np.uint8)
        return cls(s0s, cw_s, cw_v, cw_t, cw_np1, group)

    def to_shares(self) -> list[spec.Share]:
        """The bundle's keys as ``spec.Share`` objects."""
        out = []
        for i in range(self.num_keys):
            cws = tuple(
                spec.Cw(s=self.cw_s[i, j].tobytes(),
                        v=self.cw_v[i, j].tobytes(),
                        tl=bool(self.cw_t[i, j, 0]),
                        tr=bool(self.cw_t[i, j, 1]))
                for j in range(self.n_bits))
            out.append(spec.Share(
                s0s=tuple(s.tobytes() for s in self.s0s[i]), cws=cws,
                cw_np1=self.cw_np1[i].tobytes()))
        return out

    # -- codec ---------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Flat framed binary: header, the raw arrays, a CRC32 trailer.
        XOR bundles emit version-2 frames, additive bundles version-4
        frames whose header carries the group code."""
        k, p = self.s0s.shape[0], self.s0s.shape[1]
        if self.group == "xor":
            header = _MAGIC + struct.pack(
                _HEADER, _VERSION, p, k, self.n_bits, self.lam)
        else:
            header = _MAGIC + struct.pack(
                _HEADER4, _VERSION_GROUP, p, k, self.n_bits, self.lam, 0,
                GROUP_CODE[self.group])
        body = b"".join([header, self.s0s.tobytes(), self.cw_s.tobytes(),
                         self.cw_v.tobytes(), self.cw_t.tobytes(),
                         self.cw_np1.tobytes()])
        return body + struct.pack("<I", zlib.crc32(body))

    @classmethod
    def from_bytes(cls, data: bytes) -> "KeyBundle":
        """Strict bounds-checked DCFK decode of a plain bundle (versions
        1, 2, 3 with proto = 0, and 4).  Rejects truncated, oversized,
        corrupt and protocol frames with ``KeyFormatError`` naming the
        offending field."""
        if len(data) < 4 or data[:4] != _MAGIC:
            raise KeyFormatError(
                f"bad magic: expected {_MAGIC!r}, got {bytes(data[:4])!r} "
                "(not a DCFK key bundle)")
        if len(data) < _HEADER_SIZE:
            raise KeyFormatError(
                f"truncated header: frame is {len(data)} bytes, the DCFK "
                f"header needs {_HEADER_SIZE}")
        version, p, k, n, lam = struct.unpack_from(_HEADER, data, 4)
        header_size = _HEADER_SIZE
        group = "xor"
        if version == _VERSION_GROUP:
            if len(data) < _HEADER4_SIZE:
                raise KeyFormatError(
                    f"truncated header: frame is {len(data)} bytes, the "
                    f"DCFK v4 header needs {_HEADER4_SIZE}")
            version, p, k, n, lam, proto, group_code = struct.unpack_from(
                _HEADER4, data, 4)
            header_size = _HEADER4_SIZE
            if proto != 0:
                raise KeyFormatError(
                    f"frame carries protocol section {proto}; decode with "
                    "the dcf_tpu_torch.protocols bundle readers "
                    "(ProtocolBundle.from_bytes): reading it as a plain "
                    "bundle would misparse the sections")
            if group_code not in GROUP_FROM_CODE:
                raise KeyFormatError(
                    f"unknown output-group code {group_code} (this reader "
                    f"handles {sorted(GROUP_FROM_CODE)}); refusing to "
                    "guess a reconstruction group for key material")
            group = GROUP_FROM_CODE[group_code]
            if group != "xor" and (8 * lam) % GROUP_WIDTH[group]:
                raise KeyFormatError(
                    f"group {group!r} needs lam*8={8 * lam} divisible by "
                    f"{GROUP_WIDTH[group]}: corrupt or mismatched header "
                    "fields")
        elif version == _VERSION_PROTO:
            if len(data) < _HEADER3_SIZE:
                raise KeyFormatError(
                    f"truncated header: frame is {len(data)} bytes, the "
                    f"DCFK v3 header needs {_HEADER3_SIZE}")
            version, p, k, n, lam, proto = struct.unpack_from(
                _HEADER3, data, 4)
            header_size = _HEADER3_SIZE
            if proto == 2:  # protocols.dpf.PROTO_DPF, named literally to
                # keep this module free of the protocol layer
                raise KeyFormatError(
                    f"frame carries protocol section {proto} (DPF "
                    "point-function key, no cw_v); decode with "
                    "dcf_tpu_torch.protocols.dpf.DpfBundle.from_bytes: "
                    "reading it as a plain bundle would misparse the "
                    "sections")
            if proto != 0:
                raise KeyFormatError(
                    f"frame carries protocol section {proto} (interval "
                    "combine masks); decode with dcf_tpu_torch.protocols."
                    "ProtocolBundle.from_bytes: reading it as a plain "
                    "bundle would silently drop the public correction")
        elif version not in (1, _VERSION):
            raise KeyFormatError(
                f"unsupported version {version} (this reader handles "
                f"1..{_VERSION_GROUP})")
        if p not in (1, 2):
            raise KeyFormatError(f"parties field must be 1 or 2, got {p}")
        if n == 0 or n % 8:
            raise KeyFormatError(
                f"n field must be a positive multiple of 8 bits, got {n}")
        if lam == 0:
            raise KeyFormatError("lam field must be positive, got 0")
        sections = (
            ("s0s", (k, p, lam)),
            ("cw_s", (k, n, lam)),
            ("cw_v", (k, n, lam)),
            ("cw_t", (k, n, 2)),
            ("cw_np1", (k, lam)),
        )
        arrays = _decode_sections(
            data, sections, header_size,
            _CRC_SIZE if version >= 2 else 0,
            f"K={k}, P={p}, n={n}, lam={lam}")
        try:
            return cls(*(arrays[name] for name, _ in sections), group=group)
        except ShapeError as e:
            raise KeyFormatError(
                f"header fields do not describe a bundle: {e}") from None

    def save(self, path: str) -> None:
        """Write the bundle: an ``.npz`` of the arrays and the group code,
        or any other path as a DCFK frame."""
        if path.endswith(".npz"):
            np.savez(path, s0s=self.s0s, cw_s=self.cw_s, cw_v=self.cw_v,
                     cw_t=self.cw_t, cw_np1=self.cw_np1,
                     group=np.uint16(GROUP_CODE[self.group]))
        else:
            with open(path, "wb") as fh:
                fh.write(self.to_bytes())

    @classmethod
    def load(cls, path: str) -> "KeyBundle":
        """Read a bundle written by ``save`` (either package's)."""
        if path.endswith(".npz"):
            z = np.load(path)
            group = (GROUP_FROM_CODE[int(z["group"])]
                     if "group" in z.files else "xor")
            return cls(z["s0s"], z["cw_s"], z["cw_v"], z["cw_t"],
                       z["cw_np1"], group)
        with open(path, "rb") as fh:
            return cls.from_bytes(fh.read())
