"""The plain reference against the port's own host oracle
(``Dcf(backend="numpy")``) and against the construction's definition, at
small sizes: both parties, x = alpha included."""

import numpy as np
import pytest

from portbench.reference import dcf_ref


def test_aes256_known_answer():
    # FIPS-197 appendix C.3.
    ct = dcf_ref.encrypt(dcf_ref.expand_key(bytes(range(32))),
                         np.frombuffer(bytes.fromhex(
                             "00112233445566778899aabbccddeeff"),
                             np.uint8)[None])
    assert bytes(ct[0]).hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_sbox_is_the_aes_sbox():
    from dcf_tpu_torch.spec import AES_SBOX

    assert bytes(dcf_ref.SBOX) == bytes(AES_SBOX)


def _inputs(n_bytes, k_num, m, seed):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32), rng.bytes(32)]
    alphas = rng.integers(0, 256, (k_num, n_bytes), dtype=np.uint8)
    betas = rng.integers(0, 256, (k_num, 16), dtype=np.uint8)
    s0s = rng.integers(0, 256, (k_num, 2, 16), dtype=np.uint8)
    xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
    # x = alpha and its neighbours, for every key
    for j, a in enumerate(alphas):
        v = int.from_bytes(a.tobytes(), "big")
        for d, i in zip((0, -1, 1), range(3 * j, 3 * j + 3)):
            xs[i] = np.frombuffer(((v + d) % (1 << 8 * n_bytes)).to_bytes(
                n_bytes, "big"), np.uint8)
    return keys, alphas, betas, s0s, xs


def _all_pairs(keys: dict, k_num: int, m: int):
    rows = np.repeat(np.arange(k_num), m)
    return {name: arr[rows] for name, arr in keys.items()}, np.tile(
        np.arange(m), k_num)


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("n_bytes", [2, 16])
def test_reference_matches_the_numpy_backend(n_bytes, party):
    from dcf_tpu_torch.api import Dcf

    k_num, m = 3, 40
    keys, alphas, betas, s0s, xs = _inputs(n_bytes, k_num, m, 100 + n_bytes)
    dcf = Dcf(n_bytes, 16, keys, backend="numpy", device="cpu")
    bundle = dcf.gen(alphas, betas, s0s=s0s, device=False)
    ref = dcf_ref.gen_keys(keys, alphas, betas, s0s)
    for name in ("cw_s", "cw_v", "cw_t", "cw_np1"):
        assert np.array_equal(ref[name], getattr(bundle, name)), name
    want = dcf.eval(party, bundle, xs)  # [K, M, 16]
    per_pair, pts = _all_pairs(ref, k_num, m)
    got = dcf_ref.eval_points(keys, party, per_pair, xs[pts])
    assert np.array_equal(got.reshape(k_num, m, 16), want)


def test_shares_reconstruct_the_comparison():
    k_num, m = 4, 50
    keys, alphas, betas, s0s, xs = _inputs(16, k_num, m, 7)
    ref = dcf_ref.gen_keys(keys, alphas, betas, s0s)
    per_pair, pts = _all_pairs(ref, k_num, m)
    y0 = dcf_ref.eval_points(keys, 0, per_pair, xs[pts])
    y1 = dcf_ref.eval_points(keys, 1, per_pair, xs[pts])
    rows = np.repeat(np.arange(k_num), m)
    want = dcf_ref.dcf_value(alphas[rows], betas[rows], xs[pts])
    assert np.array_equal(y0 ^ y1, want)
    assert (want != 0).any(axis=1).any() and (want == 0).all(axis=1).any()


def test_control_rounds_change_every_share():
    k_num, m = 2, 32
    keys, alphas, betas, s0s, xs = _inputs(16, k_num, m, 9)
    per_pair, pts = _all_pairs(dcf_ref.gen_keys(keys, alphas, betas, s0s),
                               k_num, m)
    bad, _ = _all_pairs(dcf_ref.gen_keys(keys, alphas, betas, s0s,
                                         rounds=10), k_num, m)
    good = dcf_ref.eval_points(keys, 0, per_pair, xs[pts])
    ctrl = dcf_ref.eval_points(keys, 0, bad, xs[pts], rounds=10)
    assert (good != ctrl).any(axis=1).all()


def test_expected_answers_each_query_by_its_keys_and_points():
    k_num, m = 5, 24
    keys, alphas, betas, s0s, xs = _inputs(16, k_num, m, 11)
    inputs = {"cipher_keys": keys, "party": 1, "bound": "LT_BETA",
              "group": "xor", "alphas": alphas, "betas": betas, "s0s": s0s}
    queries = [{"keys": np.array([1, 4]), "xs": xs[:10]},
               {"keys": np.array([4]), "xs": xs[10:]}]
    ref = dcf_ref.gen_keys(keys, alphas, betas, s0s)
    per_pair, pts = _all_pairs(ref, k_num, m)
    every = dcf_ref.eval_points(keys, 1, per_pair, xs[pts]).reshape(
        k_num, m, 16)
    a, b = dcf_ref.expected(inputs, queries)
    assert np.array_equal(a, every[[1, 4]][:, :10])
    assert np.array_equal(b, every[[4]][:, 10:])
    c, _ = dcf_ref.control(inputs, queries)
    assert (c != a).any(axis=-1).all()
    with pytest.raises(ValueError, match="LT_BETA over the XOR"):
        dcf_ref.expected({**inputs, "group": "add"}, queries)
