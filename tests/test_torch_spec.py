"""The port's golden model (``dcf_tpu_torch.spec``) against ``dcf_tpu.spec``
and against the port's numpy oracle, on the reference crate's vectors
(``tests/vectors.py``: its cipher keys, alphas, beta and PRG seed) and on
seeded random inputs; and the key-bundle interop that rides on it
(``KeyBundle.from_shares`` / ``to_shares`` / ``level_major`` / ``save`` /
``load``), both packages in both directions.  Tolerance: exact byte
equality."""

import numpy as np
import pytest

from dcf_tpu import spec as jspec
from dcf_tpu.keys import KeyBundle as JKeyBundle

from dcf_tpu_torch import spec as tspec
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
from dcf_tpu_torch.gen import gen_batch
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.vectors import ALPHAS, BETA, KEYS, PRG_SEED

BOUNDS = {"lt": (tspec.Bound.LT_BETA, jspec.Bound.LT_BETA),
          "gt": (tspec.Bound.GT_BETA, jspec.Bound.GT_BETA)}


def _seeds(i: int) -> list[bytes]:
    rng = np.random.default_rng(1300 + i)
    return [rng.bytes(16), rng.bytes(16)]


def _same_share(a, b) -> None:
    assert a.s0s == b.s0s and a.cw_np1 == b.cw_np1
    assert len(a.cws) == len(b.cws)
    for x, y in zip(a.cws, b.cws):
        assert (x.s, x.v, x.tl, x.tr) == (y.s, y.v, y.tl, y.tr)


def test_primitives_match():
    """AES-256 (the FIPS-197 vector and random blocks), the Hirose PRG on
    the reference's seed, and the byte-level group algebra."""
    rk = tspec.aes256_expand_key(bytes(range(32)))
    assert tspec.aes256_encrypt_block(
        rk, bytes.fromhex("00112233445566778899aabbccddeeff")) \
        == bytes.fromhex("8ea2b7ca516745bfeafc49904b496089")
    rng = np.random.default_rng(1301)
    for _ in range(4):
        key, block = rng.bytes(32), rng.bytes(16)
        assert tspec.aes256_encrypt_block(tspec.aes256_expand_key(key),
                                          block) \
            == jspec.aes256_encrypt_block(jspec.aes256_expand_key(key),
                                          block)
    for lam, keys in ((16, KEYS), (48, [rng.bytes(32) for _ in range(18)])):
        seed = (PRG_SEED * 3)[:lam]
        with pytest.warns(tspec.ReferenceContractWarning) if lam == 48 \
                else _no_warning():
            tp = tspec.HirosePrgSpec(lam, keys)
        with pytest.warns(jspec.ReferenceContractWarning) if lam == 48 \
                else _no_warning():
            jp = jspec.HirosePrgSpec(lam, keys)
        assert tp.gen(seed) == jp.gen(seed)
    a, b = rng.bytes(16), rng.bytes(16)
    assert tspec.xor_bytes(a, b, BETA) == jspec.xor_bytes(a, b, BETA)
    for group in tspec.GROUPS:
        assert tspec.group_add(a, b, group) == jspec.group_add(a, b, group)
        assert tspec.group_sub(a, b, group) == jspec.group_sub(a, b, group)
        assert tspec.group_neg(a, group) == jspec.group_neg(a, group)
    for w in (8, 16, 32):
        lanes = tspec.bytes_to_lanes(a, w)
        assert lanes == jspec.bytes_to_lanes(a, w)
        assert tspec.lanes_to_bytes([v - 5 for v in lanes], w) \
            == jspec.lanes_to_bytes([v - 5 for v in lanes], w)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("bound", ["lt", "gt"])
def test_gen_eval_on_reference_vectors(bound):
    """``spec.gen`` and ``eval_point`` of both packages on the reference
    crate's keys, alphas and beta (n = 128): the same keys, the same
    shares at every vector point, and the reconstruction the reference's
    own tests assert."""
    tb, jb = BOUNDS[bound]
    tprg, jprg = tspec.HirosePrgSpec(16, KEYS), jspec.HirosePrgSpec(16, KEYS)
    alpha = ALPHAS[2]
    seeds = _seeds(0)
    tk = tspec.gen(tprg, tspec.CmpFn(alpha, BETA), seeds, tb)
    jk = jspec.gen(jprg, jspec.CmpFn(alpha, BETA), seeds, jb)
    _same_share(tk, jk)
    for b in (0, 1):
        got = tspec.eval_batch(tprg, bool(b), tk.for_party(b), ALPHAS)
        assert got == jspec.eval_batch(jprg, bool(b), jk.for_party(b),
                                       ALPHAS)
    y0 = tspec.eval_batch(tprg, False, tk.for_party(0), ALPHAS)
    y1 = tspec.eval_batch(tprg, True, tk.for_party(1), ALPHAS)
    for x, a, c in zip(ALPHAS, y0, y1):
        inside = x < alpha if bound == "lt" else x > alpha
        assert tspec.xor_bytes(a, c) == (BETA if inside else bytes(16))


@pytest.mark.parametrize("group", ["xor", "add8", "add16", "add32"])
@pytest.mark.parametrize("bound", ["lt", "gt"])
def test_gen_matches_numpy_oracle(group, bound):
    """The golden model against the port's numpy ``gen_batch`` and
    ``eval_batch_np`` (and ``dcf_tpu.spec``), n = 16, three keys, both
    parties, the points around each alpha."""
    tb, jb = BOUNDS[bound]
    rng = np.random.default_rng(1302)
    alphas = rng.integers(0, 256, (3, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    s0s = rng.integers(0, 256, (3, 2, 16), dtype=np.uint8)
    tprg = tspec.HirosePrgSpec(16, KEYS)
    jprg = jspec.HirosePrgSpec(16, KEYS)
    shares = []
    for k in range(3):
        f = (alphas[k].tobytes(), betas[k].tobytes())
        seeds = [s0s[k, 0].tobytes(), s0s[k, 1].tobytes()]
        tk = tspec.gen(tprg, tspec.CmpFn(*f), seeds, tb, group)
        _same_share(tk, jspec.gen(jprg, jspec.CmpFn(*f), seeds, jb, group))
        shares.append(tk)
    bundle = KeyBundle.from_shares(shares, group)
    want = gen_batch(HirosePrgNp(16, KEYS), alphas, betas, s0s, tb,
                     group=group)
    for f in ("s0s", "cw_s", "cw_v", "cw_t", "cw_np1"):
        assert np.array_equal(getattr(bundle, f), getattr(want, f)), f
    a0 = int.from_bytes(alphas[0].tobytes(), "big")
    pts = sorted({(a0 + d) % 65536 for d in (-1, 0, 1)} | {0, 65535})
    xs = np.array([[x >> 8, x & 0xFF] for x in pts], dtype=np.uint8)
    prg_np = HirosePrgNp(16, KEYS)
    for b in (0, 1):
        y_np = eval_batch_np(prg_np, b, want.for_party(b), xs)
        for k in range(3):
            got = tspec.eval_batch(tprg, bool(b), shares[k].for_party(b),
                                   [x.tobytes() for x in xs], group)
            assert [bytes(r) for r in y_np[k]] == got


def test_share_repr_redacted():
    tk = tspec.gen(tspec.HirosePrgSpec(16, KEYS),
                   tspec.CmpFn(ALPHAS[0][:2], BETA), _seeds(1),
                   tspec.Bound.LT_BETA)
    text = repr(tk) + repr(tk.cws[0])
    assert "redacted" in text and repr(tk) == repr(
        jspec.gen(jspec.HirosePrgSpec(16, KEYS),
                  jspec.CmpFn(ALPHAS[0][:2], BETA), _seeds(1),
                  jspec.Bound.LT_BETA))
    for secret in (tk.s0s[0], tk.cw_np1, tk.cws[0].s, tk.cws[0].v):
        assert secret.hex() not in text and repr(secret) not in text


@pytest.mark.parametrize("group", ["xor", "add16"])
def test_bundle_interop(tmp_path, group):
    """``from_shares`` / ``to_shares`` round trips, ``level_major``, and
    ``save`` / ``load`` (npz and DCFK frame) read by the other package."""
    rng = np.random.default_rng(1303)
    alphas = rng.integers(0, 256, (2, 2), dtype=np.uint8)
    betas = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    s0s = rng.integers(0, 256, (2, 2, 16), dtype=np.uint8)
    tb = gen_batch(HirosePrgNp(16, KEYS), alphas, betas, s0s,
                   tspec.Bound.LT_BETA, group=group)
    jb = JKeyBundle(tb.s0s, tb.cw_s, tb.cw_v, tb.cw_t, tb.cw_np1, group)
    shares = tb.to_shares()
    for a, c in zip(shares, jb.to_shares()):
        _same_share(a, c)
    back = KeyBundle.from_shares(shares, group)
    assert back.to_bytes() == tb.to_bytes()
    tl, jl = tb.for_party(1).level_major(), jb.for_party(1).level_major()
    assert tl.keys() == jl.keys()
    for name in tl:
        assert np.array_equal(tl[name], jl[name]) \
            and tl[name].flags.c_contiguous, name
    with pytest.raises(Exception, match="party-restricted"):
        tb.level_major()
    for suffix in ("npz", "dcfk"):
        tp, jp = tmp_path / f"t.{suffix}", tmp_path / f"j.{suffix}"
        tb.save(str(tp))
        jb.save(str(jp))
        for loaded in (JKeyBundle.load(str(tp)), KeyBundle.load(str(jp)),
                       KeyBundle.load(str(tp))):
            assert loaded.group == group
            assert loaded.to_bytes() == tb.to_bytes()
