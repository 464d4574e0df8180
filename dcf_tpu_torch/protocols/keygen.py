"""Protocol-level key generation: interval bounds -> K-packed DCF keys.

Counterpart of ``dcf_tpu/protocols/keygen.py``, byte-identical to it:
the same alphas, key betas and combine masks from the same intervals, and
the same DCFK v3 / v4 frames in both directions.

An m-interval MIC needs one DCF key per interval BOUND — 2m keys.  The
structural observation this module is built on: those 2m keys are just
a K=2m batched keygen (one ``gen_batch`` call, the same host, C++ core
and card pipelines as plain DCF), and the resulting ``KeyBundle`` is
exactly the K-axis-packed image the batched walk kernels are fastest
at.  Key ``2i`` carries interval i's LOWER bound, key ``2i+1`` its
UPPER bound; both use ``betas[i]``.

XOR-group derivation (differs from the paper's additive-group IC, which
subtracts shares; here subtraction IS addition):

    x < p  implies  x < q   (for p <= q), so
    1_{p <= x < q} = 1_{x < q} XOR 1_{x < p}

and each one-sided bound b in [0, N] decomposes over an LT-bound DCF as

    1_{x < b} = DCF_{< b mod N}(x) XOR [b == N]

(the b == N case keys alpha=0, whose DCF is identically 0, and the
public bit supplies the constant 1).  A wraparound interval p > q
(``[p, N) ∪ [0, q)``) is the COMPLEMENT of ``[q, p)``, adding one more
public XOR of beta.  Folding the three public bits together:

    1_{(p,q)}(x) = DCF_{<q%N} XOR DCF_{<p%N} XOR pub * 1,
    pub = [p > q] ^ [p == N] ^ [q == N]

For GT-bound keys the same algebra runs on 1_{x >= b} = GT_{(b-1) mod N}
XOR [b == 0], giving pub = [p == 0] ^ [q == 0] ^ [p > q].

The public correction ``pub * beta`` is applied at share-combine time as
a per-interval mask carried by the bundle: party 0's mask is
``pub * beta`` and party 1's is zero (the party-0 public-correction
scheme; the wire format stores a mask PER PARTY, so a dealer who wants
beta hidden from party 0 outside the interval can XOR-share the
correction across both masks instead — the combine is symmetric).

Additive output groups (``group`` in ``spec.GROUPS``, mod-2^w lanes)
run the SAME decomposition with signs instead of parities:

    1_{(p,q)}(x) = DCF_{<q%N} - DCF_{<p%N} + pub * 1,
    pub = [q == N] - [p == N] + [p > q]  in {-1, 0, +1}

(GT: 1_{x>=p} - 1_{x>=q} with pub = [p == 0] - [q == 0] + [p > q]).
Rather than teach the combine a per-bound sign pattern, the MINUS is
folded into the key betas at keygen time: the subtracted bound's key
(LT: the lower key 2i; GT: the upper key 2i+1) is generated with
``-beta`` so the combine stays the uniform ``y[2i] + y[2i+1] + mask``
— the exact characteristic-2 degeneration of the XOR path, where
``-beta == beta`` and ``+`` is ``^``.  The mask is the group-encoded
``pub * beta`` (``-beta`` bytes when pub = -1), carried by party 0.

Wire format: DCFK version 3 — the v2 frame plus a ``proto`` header
field and a trailing protocol section (bound byte + combine masks),
version-gated: v1/v2 frames (and v3 frames with proto=0) still decode
as plain ``KeyBundle``; ``KeyBundle.from_bytes`` on a proto!=0 frame
refuses with a pointer here instead of silently dropping the masks.
Additive protocol bundles write version 4 (the v3 header plus the
``group`` code, mirroring the plain-bundle v4 gate): a v3-era reader
refuses them loudly instead of reconstructing in the wrong group.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from dcf_tpu_torch.errors import KeyFormatError, ShapeError
from dcf_tpu_torch.keys import (
    _CRC_SIZE,
    _HEADER3,
    _HEADER3_SIZE,
    _HEADER4,
    _HEADER4_SIZE,
    _MAGIC,
    _VERSION_GROUP,
    _VERSION_PROTO,
    KeyBundle,
    _decode_sections,
)
from dcf_tpu_torch.spec import (
    GROUP_CODE,
    GROUP_FROM_CODE,
    GROUP_WIDTH,
    Bound,
    check_group,
)
from dcf_tpu_torch.utils.groups import np_group_neg

__all__ = [
    "PROTO_MIC",
    "ProtocolBundle",
    "gen_interval_bundle",
    "interval_bound_alphas",
    "interval_session_material",
]

#: proto header values.  0 is reserved for "plain DCF" (decoded by
#: ``KeyBundle.from_bytes``); 1 is the interval-containment family (IC,
#: MIC, piecewise — all the same key structure, m intervals, 2m keys).
PROTO_MIC = 1

_BOUND_CODE = {Bound.LT_BETA: 0, Bound.GT_BETA: 1}
_BOUND_FROM = {v: k for k, v in _BOUND_CODE.items()}


def interval_bound_alphas(
    intervals: Sequence[tuple[int, int]], n_bytes: int,
    bound: Bound = Bound.LT_BETA, group: str = "xor",
) -> tuple[np.ndarray, np.ndarray]:
    """Intervals -> (alphas uint8 [2m, n_bytes], pub [m]).

    ``alphas[2i]``/``alphas[2i+1]`` are the DCF comparison points for
    interval i's lower/upper bound under ``bound``'s decomposition (see
    the module docstring); ``pub[i]`` is the public correction — a
    uint8 bit for the XOR group, a SIGNED int8 in {-1, 0, +1} for
    additive groups (same three indicator terms, summed instead of
    XORed; they never collide, so the sum stays in range and its parity
    IS the XOR bit).  The alphas are group-independent.  Shared by the
    host keygen below and any device-keygen caller
    (``gen.gen_on_device`` consumes these alphas as they are).
    """
    n_total = 1 << (8 * n_bytes)
    m = len(intervals)
    alphas = np.zeros((2 * m, n_bytes), dtype=np.uint8)
    signed = group != "xor"
    pub = np.zeros(m, dtype=np.int8 if signed else np.uint8)
    for i, (p, q) in enumerate(intervals):
        if not (0 <= p <= n_total and 0 <= q <= n_total):
            raise ValueError(
                f"interval {i} bounds must lie in [0, {n_total}], "
                f"got ({p}, {q})")
        if bound is Bound.LT_BETA:
            lo, hi = p % n_total, q % n_total
            pub[i] = ((q == n_total) - (p == n_total) + (p > q) if signed
                      else (p > q) ^ (p == n_total) ^ (q == n_total))
        else:
            lo, hi = (p - 1) % n_total, (q - 1) % n_total
            pub[i] = ((p == 0) - (q == 0) + (p > q) if signed
                      else (p == 0) ^ (q == 0) ^ (p > q))
        alphas[2 * i] = np.frombuffer(
            lo.to_bytes(n_bytes, "big"), dtype=np.uint8)
        alphas[2 * i + 1] = np.frombuffer(
            hi.to_bytes(n_bytes, "big"), dtype=np.uint8)
    return alphas, pub


@dataclass(frozen=True)
class ProtocolBundle:
    """An m-interval protocol key: 2m K-packed DCF keys + combine masks.

    ``keys``: the inner ``KeyBundle`` (K = 2m; two-party out of gen,
    party-restricted after ``for_party``).  ``combine_masks``: uint8
    [P, m, lam] — party b XORs ``combine_masks[b]`` onto its combined
    per-interval shares (``protocols.combine``); the default keygen puts
    the whole public correction in party 0's mask.  ``bound``: which
    DCF bound family the keys were generated under (the evaluators do
    not need it — the decomposition already absorbed it into the alphas
    and pub bits — but the wire format records it so a bundle is
    self-describing).
    """

    keys: KeyBundle
    combine_masks: np.ndarray  # uint8 [P, m, lam]
    bound: Bound = Bound.LT_BETA

    def __post_init__(self):
        k = self.keys.num_keys
        if k == 0 or k % 2:
            raise ShapeError(
                f"protocol bundles pack 2 DCF keys per interval; got "
                f"K={k}")
        p = self.keys.s0s.shape[1]
        want = (p, k // 2, self.keys.lam)
        if self.combine_masks.shape != want:
            raise ShapeError(
                f"combine_masks must be {want} (parties, intervals, "
                f"lam), got {self.combine_masks.shape}")
        if self.combine_masks.dtype != np.uint8:
            raise ShapeError("combine_masks must be uint8")
        if self.bound not in _BOUND_CODE:
            raise ShapeError(f"unknown bound {self.bound!r}")

    def __repr__(self) -> str:
        """Redacted: geometry only — the inner keys AND the masks are
        key material (a mask is ``pub*beta``: beta in the clear)."""
        return (f"ProtocolBundle(m={self.num_intervals}, "
                f"n_bits={self.keys.n_bits}, lam={self.lam}, "
                f"parties={self.combine_masks.shape[0]}, "
                f"bound={self.bound.value}, group={self.group}, "
                f"<key material redacted>)")

    @property
    def group(self) -> str:
        """The output group — carried by the inner keys (one source)."""
        return self.keys.group

    @property
    def num_intervals(self) -> int:
        return self.keys.num_keys // 2

    @property
    def lam(self) -> int:
        return self.keys.lam

    @property
    def n_bytes(self) -> int:
        return self.keys.n_bytes

    def masks_for(self, b: int) -> np.ndarray:
        """Party ``b``'s combine mask, uint8 [m, lam].  On a
        party-restricted bundle the single stored mask is returned
        (the restriction already chose the party)."""
        if self.combine_masks.shape[0] == 1:
            return self.combine_masks[0]
        if b not in (0, 1):
            raise ValueError(f"party must be 0 or 1, got {b}")
        return self.combine_masks[b]

    def for_party(self, b: int) -> "ProtocolBundle":
        """Restrict to party ``b``: the inner keys AND the mask."""
        return ProtocolBundle(
            keys=self.keys.for_party(b),
            combine_masks=self.combine_masks[b : b + 1].copy(),
            bound=self.bound,
        )

    # -- codec (DCFK v3 / v4) -----------------------------------------------

    def to_bytes(self) -> bytes:
        """DCFK v3 frame: v2's sections + proto field + protocol section
        (bound byte, combine masks) + CRC32 trailer.  Additive bundles
        write v4 (v3's header + the group code) — XOR frames stay
        byte-identical to earlier releases, and a pre-v4 reader refuses
        an additive frame typed instead of combining with XOR algebra."""
        k, p = self.keys.s0s.shape[0], self.keys.s0s.shape[1]
        if self.group == "xor":
            header = _MAGIC + struct.pack(
                _HEADER3, _VERSION_PROTO, p, k, self.keys.n_bits,
                self.keys.lam, PROTO_MIC)
        else:
            header = _MAGIC + struct.pack(
                _HEADER4, _VERSION_GROUP, p, k, self.keys.n_bits,
                self.keys.lam, PROTO_MIC, GROUP_CODE[self.group])
        body = b"".join([
            header,
            self.keys.s0s.tobytes(),
            self.keys.cw_s.tobytes(),
            self.keys.cw_v.tobytes(),
            self.keys.cw_t.tobytes(),
            self.keys.cw_np1.tobytes(),
            bytes([_BOUND_CODE[self.bound]]),
            self.combine_masks.tobytes(),
        ])
        return body + struct.pack("<I", zlib.crc32(body))

    @classmethod
    def from_bytes(cls, data: bytes) -> "ProtocolBundle":
        """Strict bounds-checked decode of a v3/v4 proto frame; the same
        field-naming rejection discipline as ``KeyBundle.from_bytes``.
        Plain frames (v1/v2, or v3 with proto=0) are refused with a
        pointer at ``KeyBundle.from_bytes`` — a protocol evaluator fed
        a maskless bundle would silently skip the public correction.
        v4 frames carry the output-group code; an unknown code is
        refused rather than guessed."""
        if len(data) < 4 or data[:4] != _MAGIC:
            raise KeyFormatError(
                f"bad magic: expected {_MAGIC!r}, got {bytes(data[:4])!r} "
                "(not a DCFK frame)")
        if len(data) < _HEADER3_SIZE:
            raise KeyFormatError(
                f"truncated header: frame is {len(data)} bytes, the DCFK "
                f"v3 header needs {_HEADER3_SIZE}")
        version, p, k, n, lam, proto = struct.unpack_from(_HEADER3, data, 4)
        header_size = _HEADER3_SIZE
        group = "xor"
        if version == _VERSION_GROUP:
            if len(data) < _HEADER4_SIZE:
                raise KeyFormatError(
                    f"truncated header: frame is {len(data)} bytes, the "
                    f"DCFK v4 header needs {_HEADER4_SIZE}")
            version, p, k, n, lam, proto, group_code = struct.unpack_from(
                _HEADER4, data, 4)
            header_size = _HEADER4_SIZE
            if group_code not in GROUP_FROM_CODE:
                raise KeyFormatError(
                    f"unknown output-group code {group_code} (this reader "
                    f"handles {sorted(GROUP_FROM_CODE)}); refusing to "
                    "guess a combine group for key material")
            group = GROUP_FROM_CODE[group_code]
            if group != "xor" and (8 * lam) % GROUP_WIDTH[group]:
                raise KeyFormatError(
                    f"group {group!r} needs lam*8={8 * lam} divisible by "
                    f"{GROUP_WIDTH[group]} — corrupt or mismatched "
                    "header fields")
        elif version != _VERSION_PROTO:
            raise KeyFormatError(
                f"version {version} frames carry no protocol section; "
                "decode with KeyBundle.from_bytes")
        if proto != PROTO_MIC:
            if proto == 2:  # protocols.dpf.PROTO_DPF (no import cycle)
                raise KeyFormatError(
                    f"proto field {proto} is a DPF point-function frame; "
                    "decode with dcf_tpu_torch.protocols.DpfBundle."
                    "from_bytes")
            raise KeyFormatError(
                f"proto field {proto} is not the interval-containment "
                f"family ({PROTO_MIC}); plain v3 frames (proto=0) decode "
                "with KeyBundle.from_bytes")
        if p not in (1, 2):
            raise KeyFormatError(f"parties field must be 1 or 2, got {p}")
        if n == 0 or n % 8:
            raise KeyFormatError(
                f"n field must be a positive multiple of 8 bits, got {n}")
        if lam == 0:
            raise KeyFormatError("lam field must be positive, got 0")
        if k == 0 or k % 2:
            raise KeyFormatError(
                f"K field must be a positive even key count (2 per "
                f"interval), got {k}")
        m = k // 2
        sections = (
            ("s0s", (k, p, lam)),
            ("cw_s", (k, n, lam)),
            ("cw_v", (k, n, lam)),
            ("cw_t", (k, n, 2)),
            ("cw_np1", (k, lam)),
            ("bound", (1,)),
            ("combine_masks", (p, m, lam)),
        )
        arrays = _decode_sections(
            data, sections, header_size, _CRC_SIZE,
            f"K={k}, P={p}, n={n}, lam={lam}")
        bound_code = int(arrays["bound"][0])
        if bound_code not in _BOUND_FROM:
            raise KeyFormatError(
                f"bound field must be 0 (LT) or 1 (GT), got {bound_code}")
        return cls(
            keys=KeyBundle(
                s0s=arrays["s0s"], cw_s=arrays["cw_s"],
                cw_v=arrays["cw_v"], cw_t=arrays["cw_t"],
                cw_np1=arrays["cw_np1"], group=group),
            combine_masks=arrays["combine_masks"],
            bound=_BOUND_FROM[bound_code],
        )


def gen_interval_bundle(
    gen_fn: Callable[[np.ndarray, np.ndarray, Bound], KeyBundle],
    intervals: Sequence[tuple[int, int]],
    betas: np.ndarray,
    n_bytes: int,
    bound: Bound = Bound.LT_BETA,
    group: str = "xor",
) -> ProtocolBundle:
    """Generate an m-interval protocol bundle through ``gen_fn``.

    ``gen_fn(alphas, betas, bound) -> KeyBundle`` is any K-batched DCF
    keygen — the facade's host path (the C++ core under
    ``backend="cpu"``, else ``gen.gen_batch``) or the walk on the card
    (``gen.gen_on_device``, kernel G1 at lam = 16 and G2 at lam = 32, what
    ``Dcf.mic(..., device=True)`` passes: the m-interval MIC's 2m bound keys are exactly the K-packed
    shape the keygen kernel scales with).  The 2m bound keys land in ONE K-packed
    bundle: interval i's shares are keys 2i (lower) and 2i+1 (upper),
    both carrying ``betas[i]`` (up to the additive sign fold — see
    ``interval_session_material``).  The pipelines are byte-identical,
    so the ``ProtocolBundle`` wire frame does not record which one ran.

    ``group``: the output group the KEYS must be generated in — the
    caller's ``gen_fn`` closure carries it to the keygen (the facade's
    ``_protocol_gen`` does); the mismatch check below catches a closure
    that dropped it, because an XOR-keyed bundle combined with additive
    algebra reconstructs noise.
    """
    betas = np.asarray(betas, dtype=np.uint8)
    m = len(intervals)
    if m == 0:
        raise ShapeError("need at least one interval")
    if betas.ndim != 2 or betas.shape[0] != m:
        raise ShapeError(f"betas must be [{m}, lam], got {betas.shape}")
    check_group(group, betas.shape[1])
    alphas, key_betas, masks = interval_session_material(
        intervals, betas, n_bytes, bound, group)
    keys = gen_fn(alphas, key_betas, bound)
    if keys.group != group:
        raise ShapeError(
            f"gen_fn produced a {keys.group!r}-group bundle for a "
            f"{group!r} protocol — the keygen closure must thread the "
            "group through (Dcf._protocol_gen does)")
    return ProtocolBundle(keys=keys, combine_masks=masks, bound=bound)


def interval_session_material(
    intervals: Sequence[tuple[int, int]],
    betas: np.ndarray,
    n_bytes: int,
    bound: Bound = Bound.LT_BETA,
    group: str = "xor",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ONE per-session MIC key-material derivation: intervals ->
    ``(alphas uint8 [2m, n_bytes], key_betas uint8 [2m, lam],
    combine_masks uint8 [2, m, lam])``.  Shared by
    ``gen_interval_bundle`` (host and card keygen) and, in ``dcf_tpu``,
    the key factory's batched refill, so the combine convention cannot
    fork between the two packages.

    For additive groups the subtracted bound's key betas are NEGATED
    (LT: lower keys ``2i``; GT: upper keys ``2i+1``) so the pairwise
    combine stays the uniform ``y[2i] + y[2i+1] + mask`` — see the
    module docstring.  The party-0 mask is the group-encoded
    ``pub * beta`` with pub in {-1, 0, +1}."""
    alphas, pub = interval_bound_alphas(intervals, n_bytes, bound, group)
    masks = np.zeros((2,) + betas.shape, dtype=np.uint8)
    if group == "xor":
        masks[0] = betas * pub[:, None]  # party-0 public correction
        return alphas, np.repeat(betas, 2, axis=0), masks
    masks[0][pub > 0] = betas[pub > 0]
    masks[0][pub < 0] = np_group_neg(betas[pub < 0], group)
    key_betas = np.repeat(betas, 2, axis=0).copy()
    neg_slot = 0 if bound is Bound.LT_BETA else 1
    key_betas[neg_slot::2] = np_group_neg(betas, group)
    return alphas, key_betas, masks
