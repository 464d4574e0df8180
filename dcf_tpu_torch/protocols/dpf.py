"""Distributed point functions: the GGM walk minus the comparison.

Counterpart of ``dcf_tpu/protocols/dpf.py`` (its lines 66-348).  A DPF key
for ``f(x) = beta * 1_{x == alpha}`` is a strict subset of the DCF key
material (Boyle et al., EUROCRYPT 2021, Fig. 1 against Fig. 3): the same
per-level seed and t-bit correction words steer the two parties' walks
apart exactly on the path to ``alpha``, and since a point function needs
no per-level value accumulation, the whole ``v`` column (``cw_v``, the
v half of every PRG call) drops out.  What remains per level is
``(s_cw, tl_cw, tr_cw)`` plus one leaf correction ``cw_np1 = s_a ^ s_b ^
beta``: off the special path the parties' states are equal (an XOR share
of 0), on it they differ by exactly ``beta`` after the leaf correction.
Reconstruction is XOR: ``y = y0 ^ y1``.

Wire format: DCFK version 3 with ``proto=PROTO_DPF``, the v2 sections
minus ``cw_v``, gated both ways: ``KeyBundle.from_bytes`` refuses a DPF
frame with a pointer here (a plain reader would take seed corrections for
``cw_v`` bytes), and ``DpfBundle.from_bytes`` refuses plain and interval
frames.  ``decode_proto_frame`` dispatches a typed v3 frame off the
header's proto field.  The frames are byte-identical to the JAX
package's in both directions.

The full-domain evaluator on the card is ``backends.evalall.DpfEvalAll``
(lam = ``DPF_DEVICE_LAM``), and ``dpf_gen_on_device`` makes keys there
(kernel B7b, ``backends.device_gen.DpfKeyGen``); the host paths here take
any lam.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

from dcf_tpu_torch.errors import KeyFormatError, ShapeError
from dcf_tpu_torch.gen import _check_gen_inputs, _sel
from dcf_tpu_torch.keys import (
    _CRC_SIZE,
    _HEADER3,
    _HEADER3_SIZE,
    _MAGIC,
    _VERSION_PROTO,
    _decode_sections,
)
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.protocols.keygen import PROTO_MIC, ProtocolBundle

__all__ = [
    "DPF_DEVICE_LAM",
    "DpfBundle",
    "PROTO_DPF",
    "PROTO_MIC",
    "decode_proto_frame",
    "dpf_eval_points",
    "dpf_gen_batch",
    "dpf_gen_on_device",
]

#: proto header value of DPF frames.  0 = plain DCF (KeyBundle), 1 = the
#: interval-containment family (``keygen.PROTO_MIC``).
PROTO_DPF = 2

#: the width of the full-domain kernel: two 16-byte AES blocks.
DPF_DEVICE_LAM = 32


def _check_v3_header(data: bytes) -> None:
    """The checks every typed-frame reader starts with: magic, a whole v3
    header, version 3."""
    if len(data) < 4 or data[:4] != _MAGIC:
        raise KeyFormatError(
            f"bad magic: expected {_MAGIC!r}, got {bytes(data[:4])!r} "
            "(not a DCFK frame)")
    if len(data) < _HEADER3_SIZE:
        raise KeyFormatError(
            f"truncated header: frame is {len(data)} bytes, the DCFK "
            f"v3 header needs {_HEADER3_SIZE}")
    version = struct.unpack_from("<H", data, 4)[0]
    if version != _VERSION_PROTO:
        raise KeyFormatError(
            f"version {version} frames carry no proto field; "
            "decode with KeyBundle.from_bytes")


@dataclass(frozen=True)
class DpfBundle:
    """K packed DPF keys: the DCF bundle minus the ``cw_v`` column.

    ``s0s``: uint8 [K, P, lam] starting seeds (P = 2 out of gen, P = 1
    after ``for_party``); ``cw_s``: uint8 [K, n, lam] per-level seed
    corrections; ``cw_t``: uint8 [K, n, 2] per-level (left, right) t-bit
    corrections; ``cw_np1``: uint8 [K, lam] leaf correction
    ``s_a ^ s_b ^ beta``.
    """

    s0s: np.ndarray
    cw_s: np.ndarray
    cw_t: np.ndarray
    cw_np1: np.ndarray

    # Non-zero: this bundle serializes as a typed v3 frame.
    WIRE_PROTO = PROTO_DPF

    def __post_init__(self):
        for name in ("s0s", "cw_s", "cw_t", "cw_np1"):
            a = getattr(self, name)
            if not isinstance(a, np.ndarray) or a.dtype != np.uint8:
                raise ShapeError(f"{name} must be a uint8 numpy array")
        k, p, lam = (self.s0s.shape if self.s0s.ndim == 3 else (0, 0, 0))
        if self.s0s.ndim != 3 or p not in (1, 2):
            raise ShapeError(
                f"s0s must be [K, parties(1|2), lam], got {self.s0s.shape}")
        if self.cw_s.ndim != 3 or self.cw_s.shape[::2] != (k, lam):
            raise ShapeError(
                f"cw_s must be [K={k}, n, lam={lam}], got {self.cw_s.shape}")
        n = self.cw_s.shape[1]
        if n == 0 or n % 8:
            raise ShapeError(
                f"depth must be a positive multiple of 8 bits, got {n}")
        if self.cw_t.shape != (k, n, 2):
            raise ShapeError(
                f"cw_t must be {(k, n, 2)}, got {self.cw_t.shape}")
        if self.cw_np1.shape != (k, lam):
            raise ShapeError(
                f"cw_np1 must be {(k, lam)}, got {self.cw_np1.shape}")

    def __repr__(self) -> str:
        """Redacted: geometry only (every section is key material)."""
        return (f"DpfBundle(K={self.num_keys}, n_bits={self.n_bits}, "
                f"lam={self.lam}, parties={self.s0s.shape[1]}, "
                "<key material redacted>)")

    @classmethod
    def from_arrays(cls, s0s, cw_s, cw_t, cw_np1) -> "DpfBundle":
        """Build a bundle from the four key arrays of another package or
        a wire decoder (array-likes, copied into fresh contiguous uint8
        arrays; a dtype other than uint8 is refused, never cast)."""
        arrays = []
        for name, a in (("s0s", s0s), ("cw_s", cw_s), ("cw_t", cw_t),
                        ("cw_np1", cw_np1)):
            a = np.asarray(a)
            if a.dtype != np.uint8:
                raise ShapeError(f"{name} must be uint8 (got {a.dtype})")
            arrays.append(np.array(a, dtype=np.uint8, order="C", copy=True))
        return cls(*arrays)

    @property
    def num_keys(self) -> int:
        return self.s0s.shape[0]

    @property
    def n_bits(self) -> int:
        return self.cw_s.shape[1]

    @property
    def n_bytes(self) -> int:
        return self.cw_s.shape[1] // 8

    @property
    def lam(self) -> int:
        return self.s0s.shape[2]

    def for_party(self, b: int) -> "DpfBundle":
        """Restrict to party ``b``'s seed column (the correction words
        are shared by both parties and stay whole)."""
        if b not in (0, 1):
            raise ValueError(f"party must be 0 or 1, got {b}")
        if self.s0s.shape[1] != 2:
            raise ShapeError("bundle is already party-restricted")
        return DpfBundle(
            s0s=self.s0s[:, b: b + 1].copy(), cw_s=self.cw_s,
            cw_t=self.cw_t, cw_np1=self.cw_np1)

    # -- codec (DCFK v3, proto=PROTO_DPF) -----------------------------------

    def to_bytes(self) -> bytes:
        """DCFK v3 frame: the v2 sections minus ``cw_v``, typed
        ``proto=PROTO_DPF``, with the CRC32 trailer."""
        k, p = self.s0s.shape[0], self.s0s.shape[1]
        header = _MAGIC + struct.pack(
            _HEADER3, _VERSION_PROTO, p, k, self.n_bits, self.lam,
            PROTO_DPF)
        body = b"".join([header, self.s0s.tobytes(), self.cw_s.tobytes(),
                         self.cw_t.tobytes(), self.cw_np1.tobytes()])
        return body + struct.pack("<I", zlib.crc32(body))

    @classmethod
    def from_bytes(cls, data: bytes) -> "DpfBundle":
        """Strict bounds-checked decode of a v3 DPF frame, with the same
        field-naming refusals as ``KeyBundle.from_bytes``.  Plain and
        interval frames are refused with a pointer at their decoder."""
        _check_v3_header(data)
        _, p, k, n, lam, proto = struct.unpack_from(_HEADER3, data, 4)
        if proto != PROTO_DPF:
            pointer = ("dcf_tpu_torch.protocols.ProtocolBundle.from_bytes"
                       if proto != 0 else "KeyBundle.from_bytes")
            raise KeyFormatError(
                f"proto field {proto} is not the point-function family "
                f"({PROTO_DPF}); decode with {pointer}")
        if p not in (1, 2):
            raise KeyFormatError(f"parties field must be 1 or 2, got {p}")
        if n == 0 or n % 8:
            raise KeyFormatError(
                f"n field must be a positive multiple of 8 bits, got {n}")
        if lam == 0:
            raise KeyFormatError("lam field must be positive, got 0")
        if k == 0:
            raise KeyFormatError(
                f"K field must be a positive key count, got {k}")
        sections = (
            ("s0s", (k, p, lam)),
            ("cw_s", (k, n, lam)),
            ("cw_t", (k, n, 2)),
            ("cw_np1", (k, lam)),
        )
        arrays = _decode_sections(
            data, sections, _HEADER3_SIZE, _CRC_SIZE,
            f"K={k}, P={p}, n={n}, lam={lam}")
        return cls(s0s=arrays["s0s"], cw_s=arrays["cw_s"],
                   cw_t=arrays["cw_t"], cw_np1=arrays["cw_np1"])


def decode_proto_frame(data: bytes):
    """Dispatch a typed DCFK v3 frame to its decoder off the header's
    proto field: ``PROTO_MIC`` -> ``ProtocolBundle``, ``PROTO_DPF`` ->
    ``DpfBundle``.  Plain frames (v1/v2, or v3 with proto = 0) are refused
    with a pointer at ``KeyBundle.from_bytes``."""
    _check_v3_header(data)
    proto = struct.unpack_from(_HEADER3, data, 4)[5]
    if proto == PROTO_MIC:
        return ProtocolBundle.from_bytes(data)
    if proto == PROTO_DPF:
        return DpfBundle.from_bytes(data)
    if proto == 0:
        raise KeyFormatError(
            "proto field 0 is a plain frame; decode with "
            "KeyBundle.from_bytes")
    raise KeyFormatError(
        f"unknown proto field {proto} (known: {PROTO_MIC}=MIC, "
        f"{PROTO_DPF}=DPF)")


# -- host keygen / eval -------------------------------------------------------


def dpf_gen_batch(prg: HirosePrgNp, alphas: np.ndarray, betas: np.ndarray,
                  s0s: np.ndarray) -> DpfBundle:
    """Generate K DPF keys at once (host numpy walk).

    alphas: uint8 [K, n_bytes]; betas: uint8 [K, lam]; s0s: uint8
    [K, 2, lam].  Returns a two-party ``DpfBundle``.  This is
    ``gen.gen_batch`` with the ``v`` accumulation deleted: the lose-side
    seed correction and the keep-side t-bit algebra are the same, and beta
    enters only through the leaf correction ``cw_np1 = s_a ^ s_b ^
    betas``.
    """
    lam = prg.lam
    _check_gen_inputs(alphas, betas, s0s, lam)
    k_num, n_bytes = alphas.shape
    n = 8 * n_bytes
    alpha_bits = np.unpackbits(alphas, axis=1)  # MSB-first [K, n]

    s_a = s0s[:, 0, :].copy()
    s_b = s0s[:, 1, :].copy()
    t_a = np.zeros(k_num, dtype=np.uint8)  # party 0 starts at t = 0
    t_b = np.ones(k_num, dtype=np.uint8)  # party 1 starts at t = 1

    cw_s = np.zeros((k_num, n, lam), dtype=np.uint8)
    cw_t = np.zeros((k_num, n, 2), dtype=np.uint8)

    for i in range(n):
        p0 = prg.gen(s_a)
        p1 = prg.gen(s_b)
        a_i = alpha_bits[:, i]  # 1 -> keep R / lose L
        lose_is_r = (a_i ^ 1).astype(np.uint8)
        s_cw = _sel(p0.s_l, p0.s_r, lose_is_r) ^ _sel(
            p1.s_l, p1.s_r, lose_is_r)
        tl_cw = p0.t_l ^ p1.t_l ^ a_i ^ 1
        tr_cw = p0.t_r ^ p1.t_r ^ a_i
        cw_s[:, i] = s_cw
        cw_t[:, i, 0] = tl_cw
        cw_t[:, i, 1] = tr_cw
        t_cw_keep = _sel(tl_cw, tr_cw, a_i)
        new_s_a = _sel(p0.s_l, p0.s_r, a_i) ^ s_cw * t_a[:, None]
        new_s_b = _sel(p1.s_l, p1.s_r, a_i) ^ s_cw * t_b[:, None]
        new_t_a = _sel(p0.t_l, p0.t_r, a_i) ^ (t_a & t_cw_keep)
        new_t_b = _sel(p1.t_l, p1.t_r, a_i) ^ (t_b & t_cw_keep)
        s_a, s_b, t_a, t_b = new_s_a, new_s_b, new_t_a, new_t_b

    cw_np1 = s_a ^ s_b ^ betas
    return DpfBundle(s0s=s0s.copy(), cw_s=cw_s, cw_t=cw_t, cw_np1=cw_np1)


def dpf_gen_on_device(lam: int, cipher_keys, alphas: np.ndarray,
                      betas: np.ndarray, s0s: np.ndarray,
                      device=None) -> DpfBundle:
    """Generate K DPF keys with the level walk on the card (kernel B7b;
    ``device="cpu"`` runs its plain version).  ``lam`` must be
    ``DPF_DEVICE_LAM`` (32, two AES blocks); other widths take the host
    ``dpf_gen_batch``.  Returns the two-party ``DpfBundle``, byte-identical
    to ``dpf_gen_batch`` on the same ``(alphas, betas, s0s)``.  A device
    failure raises (fault point ``keygen.device``): no fallback."""
    from dcf_tpu_torch.backends.device_gen import DpfKeyGen
    from dcf_tpu_torch.testing.faults import fire

    if lam != DPF_DEVICE_LAM:
        raise ValueError(
            f"DPF keygen on the device is for lam={DPF_DEVICE_LAM} (two AES "
            f"blocks), got {lam}; other widths take dpf_gen_batch")
    _check_gen_inputs(alphas, betas, s0s, lam)
    fire("keygen.device", alphas.shape[0], lam)
    return DpfKeyGen(lam, cipher_keys, device=device).gen(alphas, betas, s0s)


def dpf_eval_points(prg: HirosePrgNp, bundle: DpfBundle, b: int,
                    xs: np.ndarray) -> np.ndarray:
    """Party ``b``'s DPF shares at arbitrary points: uint8 [K, M, lam].

    The slow per-point reference walk (n PRG levels per point): the golden
    model the full-domain evaluators are checked against.  ``bundle`` may
    be two-party or party-restricted; ``b`` picks the seed column and the
    initial t bit either way.
    """
    if b not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {b}")
    xs = np.asarray(xs, dtype=np.uint8)
    if xs.ndim != 2 or 8 * xs.shape[1] != bundle.n_bits:
        raise ShapeError(
            f"xs must be [M, {bundle.n_bytes}] to match the bundle "
            f"depth, got {xs.shape}")
    k_num, m = bundle.num_keys, xs.shape[0]
    col = b if bundle.s0s.shape[1] == 2 else 0
    s = np.broadcast_to(
        bundle.s0s[:, col, None, :], (k_num, m, bundle.lam)).copy()
    t = np.full((k_num, m), b, dtype=np.uint8)
    xbits = np.unpackbits(xs, axis=1)  # MSB-first [M, n]
    for i in range(bundle.n_bits):
        p = prg.gen(s)
        right = np.broadcast_to(xbits[None, :, i], (k_num, m)).astype(bool)
        cs = bundle.cw_s[:, None, i, :]
        s = np.where(right[..., None], p.s_r, p.s_l) ^ cs * t[..., None]
        ct = np.where(right, bundle.cw_t[:, None, i, 1],
                      bundle.cw_t[:, None, i, 0])
        t = np.where(right, p.t_r, p.t_l) ^ (t & ct)
    return s ^ bundle.cw_np1[:, None, :] * t[..., None]
