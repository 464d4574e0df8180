"""The port's DPF layer and DCFK wire codec against dcf_tpu's, byte for
byte: ``dpf_gen_batch`` and ``dpf_eval_points`` on the same seeded numpy
inputs, DPF frames (v3, proto = 2) and plain ``KeyBundle`` frames (v1-v4)
written by one package and read by the other in both directions, the
cross-reader refusals, and the wire fuzz (seeded byte flips, truncation,
extension) against the port's two readers, which must die typed
``KeyFormatError``.  Tolerance: exact byte equality."""

import struct
import warnings
import zlib

import numpy as np
import pytest

from dcf_tpu import spec as jspec
from dcf_tpu.errors import KeyFormatError as JKeyFormatError
from dcf_tpu.gen import gen_batch as j_gen_batch
from dcf_tpu.keys import KeyBundle as JKeyBundle
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.protocols.dpf import DpfBundle as JDpfBundle
from dcf_tpu.protocols.dpf import dpf_eval_points as j_dpf_eval_points
from dcf_tpu.protocols.dpf import dpf_gen_batch as j_dpf_gen_batch
from dcf_tpu.protocols.keygen import ProtocolBundle as JProtocolBundle
from dcf_tpu.protocols.keygen import gen_interval_bundle

from dcf_tpu_torch import spec as tspec
from dcf_tpu_torch.errors import KeyFormatError, ShapeError
from dcf_tpu_torch.gen import gen_batch as t_gen_batch
from dcf_tpu_torch.gen import random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp as TPrg
from dcf_tpu_torch.protocols.dpf import (
    DPF_DEVICE_LAM,
    PROTO_DPF,
    DpfBundle,
    decode_proto_frame,
    dpf_eval_points,
    dpf_gen_batch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

DPF_FIELDS = ("s0s", "cw_s", "cw_t", "cw_np1")
KEY_FIELDS = ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1")
N_FLIPS = 200


def _ck(rng, lam):
    return [rng.bytes(32) for _ in range(18 if lam >= 32 else 2)]


def _prgs(lam, ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JPrg(lam, ck), TPrg(lam, ck)


def _dpf_inputs(seed, lam, n_bytes, k_num=3):
    rng = np.random.default_rng(seed)
    ck = _ck(rng, lam)
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, lam), dtype=np.uint8)
    return rng, ck, alphas, betas, random_s0s(k_num, lam, rng)


def _same_fields(a, b, fields):
    for f in fields:
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == np.uint8 and np.array_equal(got, want), f


@pytest.mark.parametrize("n_bytes", [1, 2])
@pytest.mark.parametrize("lam", [16, 32, 48])
def test_dpf_gen_batch_matches(lam, n_bytes):
    rng, ck, alphas, betas, s0s = _dpf_inputs(400 + lam + n_bytes, lam,
                                              n_bytes)
    jp, tp = _prgs(lam, ck)
    _same_fields(dpf_gen_batch(tp, alphas, betas, s0s),
                 j_dpf_gen_batch(jp, alphas, betas, s0s), DPF_FIELDS)


@pytest.mark.parametrize("lam", [16, 32])
def test_dpf_eval_points_matches_and_reconstructs(lam):
    rng, ck, alphas, betas, s0s = _dpf_inputs(410 + lam, lam, 2)
    jp, tp = _prgs(lam, ck)
    jb = j_dpf_gen_batch(jp, alphas, betas, s0s)
    tb = DpfBundle.from_arrays(*(getattr(jb, f) for f in DPF_FIELDS))
    xs = np.concatenate([alphas, rng.integers(0, 256, (9, 2),
                                              dtype=np.uint8)])
    ys = []
    for b in (0, 1):
        for bundle, jbundle in ((tb, jb), (tb.for_party(b),
                                           jb.for_party(b))):
            got = dpf_eval_points(tp, bundle, b, xs)
            assert np.array_equal(got, j_dpf_eval_points(jp, jbundle, b, xs))
        ys.append(got)
    recon = ys[0] ^ ys[1]
    for k in range(3):
        hit = (xs == alphas[k]).all(-1)
        assert np.array_equal(recon[k, hit], np.broadcast_to(
            betas[k], (hit.sum(), lam)))
        assert not recon[k, ~hit].any()


@pytest.mark.parametrize("parties", [2, 1])
@pytest.mark.parametrize("lam", [16, 32])
def test_dpf_frames_byte_identical_both_directions(lam, parties):
    rng, ck, alphas, betas, s0s = _dpf_inputs(420 + lam, lam, 2)
    jp, tp = _prgs(lam, ck)
    tb = dpf_gen_batch(tp, alphas, betas, s0s)
    jb = j_dpf_gen_batch(jp, alphas, betas, s0s)
    if parties == 1:
        tb, jb = tb.for_party(1), jb.for_party(1)
    frame = tb.to_bytes()
    assert frame == jb.to_bytes()
    assert frame[4] == 3 and struct.unpack_from("<H", frame, 18)[0] == 2
    _same_fields(JDpfBundle.from_bytes(frame), tb, DPF_FIELDS)  # port writes
    back = DpfBundle.from_bytes(jb.to_bytes())  # dcf_tpu writes
    _same_fields(back, jb, DPF_FIELDS)
    assert back.to_bytes() == frame
    assert isinstance(decode_proto_frame(frame), DpfBundle)
    assert (back.num_keys, back.n_bits, back.n_bytes, back.lam) == (
        3, 16, 2, lam)
    assert "redacted" in repr(back) and DpfBundle.WIRE_PROTO == PROTO_DPF


def _plain_pair(seed, group):
    rng = np.random.default_rng(seed)
    ck = _ck(rng, 16)
    alphas = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    s0s = random_s0s(2, 16, rng)
    jb = j_gen_batch(JPrg(16, ck), alphas, betas, s0s, jspec.Bound.LT_BETA,
                     group=group)
    tb = t_gen_batch(TPrg(16, ck), alphas, betas, s0s, tspec.Bound.LT_BETA,
                     group=group)
    return rng, jb, tb


def _reframe(frame: bytes, version: int) -> bytes:
    """A v2 frame's payload under a v1 (no trailer) or v3 proto = 0
    header."""
    _, p, k, n, lam = struct.unpack_from("<HHIIH", frame, 4)
    payload = frame[18:-4]
    if version == 1:
        return b"DCFK" + struct.pack("<HHIIH", 1, p, k, n, lam) + payload
    body = b"DCFK" + struct.pack("<HHIIHH", 3, p, k, n, lam, 0) + payload
    return body + struct.pack("<I", zlib.crc32(body))


@pytest.mark.parametrize("parties", [2, 1])
@pytest.mark.parametrize("group,version", [("xor", 2), ("add8", 4),
                                           ("add16", 4), ("add32", 4)])
def test_key_bundle_frames_byte_identical_both_directions(group, version,
                                                          parties):
    _, jb, tb = _plain_pair(430 + version + len(group), group)
    if parties == 1:
        jb, tb = jb.for_party(0), tb.for_party(0)
    frame = tb.to_bytes()
    assert frame == jb.to_bytes() and frame[4] == version
    got = JKeyBundle.from_bytes(frame)  # port writes, dcf_tpu reads
    _same_fields(got, tb, KEY_FIELDS)
    assert got.group == group
    back = KeyBundle.from_bytes(jb.to_bytes())  # and back
    _same_fields(back, jb, KEY_FIELDS)
    assert back.group == group and back.to_bytes() == frame


@pytest.mark.parametrize("version", [1, 3])
def test_key_bundle_reads_legacy_and_proto0_frames(version):
    _, jb, tb = _plain_pair(440, "xor")
    frame = _reframe(jb.to_bytes(), version)
    got, want = KeyBundle.from_bytes(frame), JKeyBundle.from_bytes(frame)
    _same_fields(got, want, KEY_FIELDS)
    _same_fields(got, tb, KEY_FIELDS)


@pytest.fixture(scope="module")
def frames():
    """One valid frame of each kind, from dcf_tpu's writers."""
    rng, jb, _ = _plain_pair(450, "xor")
    _, jb4, _ = _plain_pair(451, "add16")
    _, ck, alphas, betas, s0s = _dpf_inputs(452, 32, 2, k_num=2)
    jp, _ = _prgs(32, ck)
    ck16 = _ck(rng, 16)

    def gen_fn(al, key_betas, bound):
        return j_gen_batch(JPrg(16, ck16), al, key_betas,
                           random_s0s(al.shape[0], 16, rng), bound)

    mic = gen_interval_bundle(
        gen_fn, [(10, 60), (100, 200)],
        rng.integers(0, 256, (2, 16), dtype=np.uint8), 2)
    return {"v2": jb.to_bytes(), "v4": jb4.to_bytes(),
            "dpf": j_dpf_gen_batch(jp, alphas, betas, s0s).to_bytes(),
            "mic": mic.to_bytes()}


def test_cross_reader_refusals(frames):
    """Each reader refuses the other families' frames with a pointer at
    the right decoder, as dcf_tpu's readers do; ``decode_proto_frame``
    decodes dcf_tpu's MIC frame to a ``ProtocolBundle`` that re-encodes
    to the same bytes and equals dcf_tpu's."""
    with pytest.raises(KeyFormatError, match="DpfBundle"):
        KeyBundle.from_bytes(frames["dpf"])
    with pytest.raises(JKeyFormatError, match="DpfBundle"):
        JKeyBundle.from_bytes(frames["dpf"])
    with pytest.raises(KeyFormatError, match="protocol section"):
        KeyBundle.from_bytes(frames["mic"])
    with pytest.raises(KeyFormatError, match="KeyBundle.from_bytes"):
        DpfBundle.from_bytes(frames["v2"])
    with pytest.raises(KeyFormatError, match="KeyBundle.from_bytes"):
        DpfBundle.from_bytes(_reframe(frames["v2"], 3))
    with pytest.raises(KeyFormatError, match="ProtocolBundle"):
        DpfBundle.from_bytes(frames["mic"])
    mic = decode_proto_frame(frames["mic"])
    assert mic.to_bytes() == frames["mic"]
    jmic = JProtocolBundle.from_bytes(frames["mic"])
    assert mic.bound.value == jmic.bound.value and mic.group == jmic.group
    for f in KEY_FIELDS:
        assert np.array_equal(getattr(mic.keys, f), getattr(jmic.keys, f)), f
    assert np.array_equal(mic.combine_masks, jmic.combine_masks)
    with pytest.raises(KeyFormatError, match="KeyBundle.from_bytes"):
        decode_proto_frame(frames["v2"])
    with pytest.raises(KeyFormatError, match="plain frame"):
        decode_proto_frame(_reframe(frames["v2"], 3))
    unknown = bytearray(frames["dpf"])
    unknown[18] = 9
    with pytest.raises(KeyFormatError, match="unknown proto"):
        decode_proto_frame(bytes(unknown))
    with pytest.raises(KeyFormatError, match="magic"):
        decode_proto_frame(b"XXXX" + frames["dpf"][4:])


_READERS = {"v2": KeyBundle.from_bytes, "v4": KeyBundle.from_bytes,
            "dpf": DpfBundle.from_bytes}


def _typed(decode, mutated, what):
    try:
        decode(mutated)
    except KeyFormatError:
        return
    except BaseException as e:  # noqa: BLE001 - the point of the fuzz
        pytest.fail(f"{what} escaped the typed-error contract: "
                    f"{type(e).__name__}: {e}")
    pytest.fail(f"{what} decoded silently: corrupt key material accepted")


@pytest.mark.parametrize("kind", ["v2", "v4", "dpf"])
def test_wire_fuzz_byte_flips_rejected_typed(frames, kind):
    """Every seeded single-byte corruption of a valid frame dies
    ``KeyFormatError``: the CRC covers header and payload, and a flipped
    version moves the frame to a reader path whose exact-size arithmetic
    no longer fits."""
    frame, decode = frames[kind], _READERS[kind]
    decode(frame)
    rng = np.random.default_rng(0xF122 + len(kind))
    for off, xor in zip(rng.integers(0, len(frame), N_FLIPS),
                        rng.integers(1, 256, N_FLIPS)):
        buf = bytearray(frame)
        buf[int(off)] ^= int(xor)
        _typed(decode, bytes(buf), f"flip at {off} xor {xor:#04x}")


@pytest.mark.parametrize("kind", ["v2", "v4", "dpf"])
def test_wire_fuzz_truncation_and_extension_rejected_typed(frames, kind):
    frame, decode = frames[kind], _READERS[kind]
    rng = np.random.default_rng(0xF123)
    for cut in sorted({int(c) for c in rng.integers(0, len(frame), 25)}
                      | {0, 3, 17, len(frame) - 1}):
        _typed(decode, frame[:cut], f"truncation at {cut}")
    _typed(decode, frame + b"\x00", "extension")
    _typed(decode, frame + frame, "concatenation")


@pytest.mark.parametrize("kind", ["v2", "v4", "dpf", "mic"])
def test_wire_fuzz_cross_reader_flips_rejected_typed(frames, kind):
    """A frame of another family, pristine or corrupted, never decodes."""
    rng = np.random.default_rng(0xF124)
    frame = frames[kind]
    decoders = [d for name, d in (("dpf", KeyBundle.from_bytes),
                                  ("mic", KeyBundle.from_bytes),
                                  ("v2", DpfBundle.from_bytes),
                                  ("v4", DpfBundle.from_bytes),
                                  ("mic", DpfBundle.from_bytes))
                if name == kind]
    for decode in decoders:
        _typed(decode, frame, "pristine alien frame")
        for _ in range(40):
            buf = bytearray(frame)
            buf[int(rng.integers(0, len(frame)))] ^= int(rng.integers(1, 256))
            _typed(decode, bytes(buf), "corrupted alien frame")


def test_header_field_refusals_name_the_field(frames):
    def patched(frame, fmt, off, value):
        buf = bytearray(frame[:-4])
        struct.pack_into(fmt, buf, off, value)
        return bytes(buf) + struct.pack("<I", zlib.crc32(bytes(buf)))

    for frame, decode in ((frames["v2"], KeyBundle.from_bytes),
                          (frames["dpf"], DpfBundle.from_bytes)):
        with pytest.raises(KeyFormatError, match="parties"):
            decode(patched(frame, "<H", 6, 3))
        with pytest.raises(KeyFormatError, match="n field"):
            decode(patched(frame, "<I", 12, 12))
        with pytest.raises(KeyFormatError, match="lam field"):
            decode(patched(frame, "<H", 16, 0))
        with pytest.raises(KeyFormatError, match="truncated frame"):
            decode(patched(frame, "<I", 8, 1 << 30))
    with pytest.raises(KeyFormatError, match="K field"):
        DpfBundle.from_bytes(patched(frames["dpf"], "<I", 8, 0))
    with pytest.raises(KeyFormatError, match="unsupported version"):
        KeyBundle.from_bytes(patched(frames["v2"], "<H", 4, 7))
    with pytest.raises(KeyFormatError, match="group code"):
        KeyBundle.from_bytes(patched(frames["v4"], "<H", 20, 99))
    with pytest.raises(KeyFormatError, match="crc32"):
        KeyBundle.from_bytes(frames["v2"][:-1] + b"\x00"
                             if frames["v2"][-1] else
                             frames["v2"][:-1] + b"\x01")


def test_dpf_bundle_contract():
    _, ck, alphas, betas, s0s = _dpf_inputs(460, DPF_DEVICE_LAM, 2)
    _, tp = _prgs(DPF_DEVICE_LAM, ck)
    tb = dpf_gen_batch(tp, alphas, betas, s0s)
    p0 = tb.for_party(0)
    assert p0.s0s.shape == (3, 1, 32)
    with pytest.raises(ShapeError):
        p0.for_party(0)
    with pytest.raises(ValueError):
        tb.for_party(2)
    src = [getattr(tb, f).copy() for f in DPF_FIELDS]
    carried = DpfBundle.from_arrays(*src)
    src[1][0, 0, 0] ^= 1
    assert carried.cw_s[0, 0, 0] != src[1][0, 0, 0]  # a copy
    with pytest.raises(ShapeError):
        DpfBundle.from_arrays(src[0].astype(np.int32), *src[1:])
    with pytest.raises(ShapeError):
        DpfBundle.from_arrays(src[0], src[1][:, :5], *src[2:])
    with pytest.raises(ShapeError, match="alphas"):
        dpf_gen_batch(tp, alphas.astype(np.int64), betas, s0s)
    with pytest.raises(ShapeError):
        dpf_eval_points(tp, tb, 0, np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError):
        dpf_eval_points(tp, tb, 2, alphas)
