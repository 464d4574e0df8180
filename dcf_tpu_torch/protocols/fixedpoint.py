"""Fixed-point gates over the additive output group.

Counterpart of ``dcf_tpu/protocols/fixedpoint.py``, byte-identical to it
from the same seeded generator (the draws happen in the same order).
The three gates — signed comparison, faithful truncation and
spline sigmoid — are all instances of ONE reduction, the masked-input
model standard in FSS-based secure computation (Boyle et al.'s gate
constructions): the dealer samples a secret mask ``r``, the parties
learn only the masked input ``x_hat = x + r mod 2^w`` (public), and
every secret predicate "x in [A, B)" becomes the PUBLIC-input predicate
"x_hat in [A + r, B + r) mod 2^w" — a wraparound interval, which the
protocol layer's IC/MIC machinery expresses natively (the combine-mask
correction absorbs the wrap).  So a gate is nothing but interval keys
with r-shifted bounds, evaluated in an additive output group so the
per-party outputs are ARITHMETIC shares that compose by lane addition:

* signed comparison (``gen_sign_gate``): x < 0 in w-bit two's
  complement iff x in [2^{w-1}, 2^w), i.e. x_hat in
  [2^{w-1} + r, r) mod 2^w — one IC bundle, nothing else.

* faithful truncation (``gen_trunc_gate``): with x = x_hat - r + 2^w c,
  c = [x_hat < r], and splitting low/high f-bit halves
  (x_hat = 2^f h + l, r = 2^f h_r + l_r):

      (x >> f)  =  h - h_r - [l < l_r] + 2^{w-f} c      (mod 2^w)

  ``h`` is public (party 0 contributes it), ``-h_r`` is dealt as
  additive scalar shares, and the two bracket terms are ICs over
  PREFIX intervals [0, l_r) (f-bit domain, payload -1) and [0, r)
  (full domain, payload +2^{w-f}) — prefix intervals because the
  mask r shifted them to start at 0.  f must be a multiple of 8:
  the DCF domain is byte-granular, so the low half must be a whole
  byte suffix of the point encoding.

* spline sigmoid (``gen_sigmoid_gate``): a piecewise-constant sigma
  table (``sigmoid_table``) is a MIC over a partition; shifting every
  cut by r keeps it a partition, and the group-sum reduce of the MIC
  rows telescopes to additive shares of the containing piece's value
  (``protocols.piecewise`` derivation).  The table itself is public.

Everything here is integer math on uint8 payload arrays — the dealer's
sigma table is computed with scalar ``math.exp`` and rounded to fixed
point before any ndarray exists, so no float dtype ever touches the
share paths.  Golden oracles (``sign_oracle`` / ``trunc_oracle`` /
``sigmoid_fixed_oracle``) compute the same functions on the CLEAR input,
vectorized; every gate test and the card check of ``chip_smoke.py``
compare reconstructions against them byte for byte.

The served form is ``workloads.gates.GateServer``, a client of the
serving tier (``serve.DcfService``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.protocols.keygen import ProtocolBundle
from dcf_tpu_torch.protocols.piecewise import partition_intervals
from dcf_tpu_torch.spec import GROUP_WIDTH, check_group
from dcf_tpu_torch.utils.groups import (
    bytes_of,
    lane_dtype,
    lanes_of,
    np_group_add,
    np_group_reduce,
)

__all__ = [
    "SignGate",
    "TruncGate",
    "SigmoidGate",
    "gen_sign_gate",
    "gen_trunc_gate",
    "gen_sigmoid_gate",
    "eval_sign_share",
    "eval_trunc_share",
    "eval_sigmoid_share",
    "encode_lanes",
    "decode_lanes",
    "points_of",
    "gate_reconstruct",
    "sigmoid_table",
    "sign_oracle",
    "trunc_oracle",
    "sigmoid_fixed_oracle",
]


# -- lane/point codecs -------------------------------------------------

def _additive(group: str, lam: int) -> int:
    """Validate an ADDITIVE group for a gate and return its width."""
    check_group(group, lam)
    if group == "xor":
        raise ShapeError(
            "fixed-point gates need an additive output group "
            "(add8/add16/add32); XOR shares have no carry to fold the "
            "gate algebra into")
    return GROUP_WIDTH[group]


def encode_lanes(vals, group: str, lam: int) -> np.ndarray:
    """Integers -> payload bytes, each value broadcast to EVERY w-bit
    lane of the lam-byte payload (so any single lane reconstructs the
    gate output; ``decode_lanes`` reads lane 0).

    ``vals``: int scalar or integer array [...]; values are reduced
    mod 2^w.  Returns uint8 [..., lam].  Rejects inexact dtypes — a
    rounded share is a silently-wrong share, so fixed-point encoding
    must happen BEFORE values enter this layer.
    """
    w = _additive(group, lam)
    vals = np.asarray(vals)
    if not np.issubdtype(vals.dtype, np.integer):
        raise ShapeError(
            f"encode_lanes wants integer values, got dtype {vals.dtype}; "
            "quantize to fixed point before encoding")
    n_lanes = 8 * lam // w
    lanes = (vals.astype(object) % (1 << w))  # exact for any int width
    lanes = np.asarray(lanes, dtype=np.uint64).astype(lane_dtype(group))
    lanes = np.broadcast_to(lanes[..., None],
                            vals.shape + (n_lanes,))
    return bytes_of(np.ascontiguousarray(lanes), group)


def decode_lanes(payload: np.ndarray, group: str) -> np.ndarray:
    """Payload bytes uint8 [..., lam] -> int64 lane-0 values [...].

    Gate outputs broadcast one value to every lane (``encode_lanes``),
    so lane 0 is the canonical read of a reconstruction."""
    return lanes_of(np.asarray(payload, dtype=np.uint8),
                    group)[..., 0].astype(np.int64)


def points_of(vals, n_bytes: int) -> np.ndarray:
    """Integers [M] -> big-endian evaluation points uint8 [M, n_bytes]
    (the DCF point encoding — MSB first, matching the spec walk)."""
    vals = np.asarray(vals)
    if not np.issubdtype(vals.dtype, np.integer):
        raise ShapeError(
            f"points_of wants integer inputs, got dtype {vals.dtype}")
    v = vals.astype(np.uint64) & np.uint64((1 << (8 * n_bytes)) - 1)
    shifts = np.arange(8 * (n_bytes - 1), -1, -8, dtype=np.uint64)
    return ((v[..., None] >> shifts) & np.uint64(0xFF)).astype(np.uint8)


def gate_reconstruct(y0: np.ndarray, y1: np.ndarray,
                     group: str) -> np.ndarray:
    """Group-add the two parties' gate shares and decode: int64 [...]."""
    return decode_lanes(np_group_add(y0, y1, group), group)


# -- signed comparison -------------------------------------------------

@dataclass(frozen=True)
class SignGate:
    """One signed-comparison gate: additive shares of
    ``beta * [x < 0]`` from the public masked input x_hat.

    Wraps the single r-shifted IC bundle; ``for_party`` restricts it
    for shipping (DCFK v4 on the wire via ``pb.to_bytes``)."""

    pb: ProtocolBundle

    @property
    def group(self) -> str:
        return self.pb.group

    def for_party(self, b: int) -> "SignGate":
        return SignGate(self.pb.for_party(b))


def gen_sign_gate(dcf, r: int, rng: np.random.Generator,
                  group: str, beta: int = 1) -> SignGate:
    """Dealer keygen for ``beta * [x < 0]`` under input mask ``r``.

    ``x < 0`` (two's complement, w = 8 * dcf.n_bytes) iff
    ``x_hat in [2^{w-1} + r, r) mod 2^w`` — one wraparound IC."""
    _additive(group, dcf.lam)
    n_total = 1 << (8 * dcf.n_bytes)
    p = ((n_total >> 1) + r) % n_total
    q = r % n_total
    beta_bytes = encode_lanes(beta, group, dcf.lam)
    return SignGate(dcf.interval(p, q, beta_bytes, rng=rng, group=group))


def eval_sign_share(dcf, b: int, gate: SignGate, x_hat) -> np.ndarray:
    """Party ``b``'s share uint8 [M, lam] of ``beta * [x < 0]``.

    ``x_hat``: PUBLIC masked inputs — int array [M] or pre-encoded
    points uint8 [M, n_bytes]."""
    xs = _as_points(x_hat, dcf.n_bytes)
    return dcf.eval_interval(b, gate.pb, xs)


def sign_oracle(x, n_bits: int) -> np.ndarray:
    """Clear-input oracle: int64 [M], 1 iff ``x`` is negative in
    n_bits-bit two's complement."""
    x = np.asarray(x, dtype=np.uint64) & np.uint64((1 << n_bits) - 1)
    return ((x >> np.uint64(n_bits - 1)) & np.uint64(1)).astype(np.int64)


# -- faithful truncation ----------------------------------------------

@dataclass(frozen=True)
class TruncGate:
    """One faithful-truncation gate: additive shares of
    ``((x_hat - r) mod 2^w) >> f``.

    ``pb_low`` lives on the f-bit domain (its facade has
    ``n_bytes = f // 8``), ``pb_wrap`` on the full domain;
    ``const_share`` holds BOTH parties' additive scalar shares of
    ``-(r >> f)`` until ``for_party`` restricts to one row (it is key
    material: one share reveals nothing, the pair reveals ``r >> f``,
    so the repr redacts it)."""

    pb_low: ProtocolBundle
    pb_wrap: ProtocolBundle
    const_share: np.ndarray     # uint8 [2, lam] dealer / [1, lam] party
    f: int
    party: int | None = None

    @property
    def group(self) -> str:
        return self.pb_wrap.group

    def __repr__(self) -> str:  # redacts const_share (key material)
        return (f"TruncGate(f={self.f}, group={self.group!r}, "
                f"party={self.party})")

    def for_party(self, b: int) -> "TruncGate":
        return TruncGate(self.pb_low.for_party(b),
                         self.pb_wrap.for_party(b),
                         self.const_share[b:b + 1].copy(), self.f, b)

    def const_for(self, b: int) -> np.ndarray:
        if self.party is not None:
            if b != self.party:
                raise ShapeError(
                    f"gate restricted to party {self.party}, asked "
                    f"for {b}")
            return self.const_share[0]
        return self.const_share[b]


def gen_trunc_gate(dcf, dcf_low, r: int, f: int,
                   rng: np.random.Generator, group: str) -> TruncGate:
    """Dealer keygen for faithful truncation by ``f`` bits.

    ``dcf``: full-domain facade (w = 8 * n_bytes must equal the group
    width — the 2^{w-f} wrap term is arithmetic mod 2^w);
    ``dcf_low``: facade over the low half, ``n_bytes = f // 8``,
    same lam.  ``f`` must be a whole number of bytes in (0, w)."""
    w = _additive(group, dcf.lam)
    if w != 8 * dcf.n_bytes:
        raise ShapeError(
            f"trunc gate needs group width == domain bits: group "
            f"{group} is {w}-bit but the domain is {8 * dcf.n_bytes}")
    if f % 8 != 0 or not 0 < f < w:
        raise ShapeError(
            f"f must be a positive multiple of 8 below {w} (the DCF "
            f"domain is byte-granular), got {f}")
    if dcf_low.n_bytes != f // 8 or dcf_low.lam != dcf.lam:
        raise ShapeError(
            f"dcf_low must have n_bytes == f//8 == {f // 8} and lam "
            f"== {dcf.lam}, got n_bytes={dcf_low.n_bytes} "
            f"lam={dcf_low.lam}")
    n_total = 1 << w
    r %= n_total
    l_r = r & ((1 << f) - 1)
    h_r = r >> f
    pb_low = dcf_low.interval(0, l_r, encode_lanes(-1, group, dcf.lam),
                              rng=rng, group=group)
    pb_wrap = dcf.interval(0, r, encode_lanes(1 << (w - f), group,
                                              dcf.lam),
                           rng=rng, group=group)
    c0 = int(rng.integers(0, n_total, dtype=np.uint64))
    const_share = np.stack([encode_lanes(c0, group, dcf.lam),
                            encode_lanes(-h_r - c0, group, dcf.lam)])
    return TruncGate(pb_low, pb_wrap, const_share, f)


def eval_trunc_share(dcf, dcf_low, b: int, gate: TruncGate,
                     x_hat) -> np.ndarray:
    """Party ``b``'s share uint8 [M, lam] of the faithful truncation.

    ``x_hat``: PUBLIC masked inputs, int array [M].  The low-half
    points are the trailing ``f // 8`` bytes of the big-endian
    encoding; the public ``x_hat >> f`` term is party 0's to add
    (adding it once, not half each, keeps everything integral)."""
    group = gate.group
    x_int = np.asarray(x_hat)
    xs = _as_points(x_int, dcf.n_bytes)
    xs_low = np.ascontiguousarray(xs[:, dcf.n_bytes - gate.f // 8:])
    y = dcf.eval_interval(b, gate.pb_wrap, xs)
    y = np_group_add(y, dcf_low.eval_interval(b, gate.pb_low, xs_low),
                     group)
    y = np_group_add(y, gate.const_for(b)[None, :], group)
    if b == 0:
        pub = _ints_of(xs, dcf.n_bytes) >> np.uint64(gate.f)
        y = np_group_add(
            y, encode_lanes(pub.astype(np.int64), group, dcf.lam),
            group)
    return y


def trunc_oracle(x_hat, r: int, f: int, n_bits: int) -> np.ndarray:
    """Clear oracle: int64 [M], ``((x_hat - r) mod 2^n_bits) >> f`` —
    the faithful (floor) truncation of the unmasked representative."""
    mask = np.uint64((1 << n_bits) - 1)
    x = (np.asarray(x_hat, dtype=np.uint64) -
         np.uint64(r % (1 << n_bits))) & mask
    return (x >> np.uint64(f)).astype(np.int64)


# -- spline sigmoid ----------------------------------------------------

@dataclass(frozen=True)
class SigmoidGate:
    """One spline-sigmoid gate: additive shares of the fixed-point
    sigma table value at the unmasked input.

    ``cuts``/``values`` are the PUBLIC table (kept for the oracle and
    for bench disclosure); the MIC bundle's intervals are the
    r-shifted partition, its payloads the table values."""

    pb: ProtocolBundle
    cuts: tuple
    values: np.ndarray          # int64 [m], public fixed-point table
    f: int

    @property
    def group(self) -> str:
        return self.pb.group

    def for_party(self, b: int) -> "SigmoidGate":
        return SigmoidGate(self.pb.for_party(b), self.cuts,
                           self.values, self.f)


def sigmoid_table(n_bits: int, f: int, m: int,
                  saturation: int = 8) -> tuple:
    """Public piecewise-constant sigma table in n_bits-bit two's
    complement fixed point with ``f`` fractional bits.

    ``m`` pieces (even, >= 4): one saturation piece per sign beyond
    ``+-saturation`` (real units) and ``(m - 2) / 2`` uniform interior
    pieces per sign on the active region, where sigma actually bends.
    Returns ``(cuts, values)``: strictly increasing unsigned
    breakpoints starting at 0 (``partition_intervals`` convention)
    and int64 [m] piece values ``round(sigma(mid) * 2^f)``, computed
    with SCALAR math and rounded before any array exists — no float
    ndarray on this path."""
    if m < 4 or m % 2:
        raise ShapeError(f"sigmoid_table wants even m >= 4, got {m}")
    if not 0 < f < n_bits:
        raise ShapeError(f"f must lie in (0, {n_bits}), got {f}")
    n_total = 1 << n_bits
    half = n_total >> 1
    c_fx = min(saturation << f, half - 1)  # active region edge
    k = (m - 2) // 2
    cuts = sorted({0, half}
                  | {(j * c_fx) // k for j in range(1, k + 1)}
                  | {n_total - c_fx + (j * c_fx) // k
                     for j in range(k)})
    if len(cuts) != m:
        raise ShapeError(
            f"m={m} pieces collapse on the {n_bits}-bit domain "
            f"(got {len(cuts)} distinct cuts); use fewer pieces or "
            "more bits")
    values = []
    for i, lo in enumerate(cuts):
        hi = cuts[i + 1] if i + 1 < len(cuts) else n_total
        mid = (lo + hi) // 2
        signed = mid - n_total if mid >= half else mid
        real = signed / (1 << f)           # scalar float, dealer-side
        sig = 1.0 / (1.0 + math.exp(-real))
        values.append(int(round(sig * (1 << f))))
    return cuts, np.asarray(values, dtype=np.int64)


def gen_sigmoid_gate(dcf, r: int, rng: np.random.Generator,
                     group: str, f: int, m: int = 16) -> SigmoidGate:
    """Dealer keygen for the spline sigmoid under input mask ``r``:
    MIC over the table partition with every cut shifted by ``r``
    (a shifted partition is still a partition; wraparound pieces are
    native to the interval convention)."""
    _additive(group, dcf.lam)
    n_bits = 8 * dcf.n_bytes
    n_total = 1 << n_bits
    cuts, values = sigmoid_table(n_bits, f, m)
    shifted = []
    for p, q in partition_intervals(list(cuts), n_bits):
        if (q - p) % n_total == 0 and p != q:   # full domain stays put
            shifted.append((0, n_total))
        else:
            shifted.append(((p + r) % n_total, (q + r) % n_total))
    betas = encode_lanes(values, group, dcf.lam)
    pb = dcf.mic(shifted, betas, rng=rng, group=group)
    return SigmoidGate(pb, tuple(cuts), values, f)


def eval_sigmoid_share(dcf, b: int, gate: SigmoidGate,
                       x_hat) -> np.ndarray:
    """Party ``b``'s share uint8 [M, lam] of ``table(x)``: group-sum
    reduce of the MIC rows (exactly one shifted piece fires per
    point, so the reduce telescopes — ``protocols.piecewise``)."""
    xs = _as_points(x_hat, dcf.n_bytes)
    rows = dcf.eval_mic(b, gate.pb, xs)
    return np_group_reduce(rows, gate.group, axis=0)


def sigmoid_fixed_oracle(x, cuts: Sequence[int],
                         values: np.ndarray) -> np.ndarray:
    """Clear oracle: int64 [M], the table value at UNMASKED ``x`` —
    piece i covers [cuts[i], cuts[i+1]) with the last wrapping to the
    domain top (cuts[0] == 0 makes that the plain suffix)."""
    idx = np.searchsorted(np.asarray(cuts, dtype=np.uint64),
                          np.asarray(x, dtype=np.uint64),
                          side="right") - 1
    return np.asarray(values, dtype=np.int64)[idx]


# -- internals ---------------------------------------------------------

def _as_points(x_hat, n_bytes: int) -> np.ndarray:
    """Accept int array [M] or pre-encoded points uint8 [M, n_bytes]."""
    x = np.asarray(x_hat)
    if x.ndim == 2 and x.dtype == np.uint8 and x.shape[1] == n_bytes:
        return x
    if x.ndim != 1:
        raise ShapeError(
            f"x_hat must be int [M] or uint8 [M, {n_bytes}], got "
            f"{x.dtype} {x.shape}")
    return points_of(x, n_bytes)


def _ints_of(xs: np.ndarray, n_bytes: int) -> np.ndarray:
    """Big-endian points uint8 [M, n_bytes] -> uint64 [M]."""
    shifts = np.arange(8 * (n_bytes - 1), -1, -8, dtype=np.uint64)
    return (xs.astype(np.uint64) << shifts).sum(axis=1,
                                                dtype=np.uint64)
