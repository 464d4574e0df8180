"""Batched key generation: the host numpy walk and the router to the card.

Counterpart of ``random_s0s``, ``gen_batch`` and ``gen_on_device`` in
``dcf_tpu/gen.py`` (its lines 60-190 and 230-357).  ``gen_batch`` processes
K comparison functions level by level with one batched PRG call per party
per level; ``gen_on_device`` runs the same walk on the card (kernel G1 at
lam = 16, G2 at lam = 32, kernels B7a and W2, the wide tail, at lam >= 48,
``backends.device_gen``) and gives the same bytes.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.spec import Bound, check_group
from dcf_tpu_torch.utils.groups import bytes_of, lanes_of

__all__ = ["gen_batch", "gen_on_device", "random_s0s"]


def random_s0s(num_keys: int, lam: int, rng: np.random.Generator) -> np.ndarray:
    """Sample the two random starting seeds per key: uint8 [K, 2, lam]."""
    return rng.integers(0, 256, size=(num_keys, 2, lam), dtype=np.uint8)


def _sel(left: np.ndarray, right: np.ndarray, take_right: np.ndarray) -> np.ndarray:
    """Per-key child selection; take_right is uint8 [K] broadcast over
    trailing dims."""
    cond = take_right.astype(bool).reshape(-1, *([1] * (left.ndim - 1)))
    return np.where(cond, right, left)


def _check_gen_inputs(alphas, betas, s0s, lam: int) -> None:
    """A non-uint8 or misshapen input dies as ``ShapeError`` naming the
    argument: key material is byte-exact and is never cast implicitly."""
    for name, arr in (("alphas", alphas), ("betas", betas), ("s0s", s0s)):
        if not isinstance(arr, np.ndarray) or arr.dtype != np.uint8:
            got = (arr.dtype if isinstance(arr, np.ndarray)
                   else type(arr).__name__)
            raise ShapeError(
                f"{name} must be a uint8 numpy array (got {got})")
    k_num = alphas.shape[0] if alphas.ndim == 2 else -1
    if alphas.ndim != 2 or alphas.shape[1] < 1:
        raise ShapeError(
            f"alphas must be [K, n_bytes], got {alphas.shape}")
    if betas.shape != (k_num, lam) or s0s.shape != (k_num, 2, lam):
        raise ShapeError("alphas/betas/s0s shape mismatch")


def gen_batch(
    prg: HirosePrgNp,
    alphas: np.ndarray,
    betas: np.ndarray,
    s0s: np.ndarray,
    bound: Bound,
    group: str = "xor",
) -> KeyBundle:
    """Generate K DCF keys at once.

    alphas: uint8 [K, n_bytes]; betas: uint8 [K, lam]; s0s: uint8 [K, 2, lam].
    Returns a two-party KeyBundle (s0s retained with P=2).

    ``group`` selects the output group; the tree walk (seeds, t-bits) is
    group-independent, the additive groups change only the value
    correction-word algebra (Boyle et al., Fig. 1), computed here in the
    little-endian lane domain.
    """
    lam = prg.lam
    check_group(group, lam)
    _check_gen_inputs(alphas, betas, s0s, lam)
    k_num, n_bytes = alphas.shape
    n = 8 * n_bytes
    additive = group != "xor"
    alpha_bits = np.unpackbits(alphas, axis=1)  # MSB-first [K, n]

    s_a = s0s[:, 0, :].copy()  # party 0 seeds [K, lam]
    s_b = s0s[:, 1, :].copy()  # party 1 seeds
    t_a = np.zeros(k_num, dtype=np.uint8)  # party 0 starts at t = 0
    t_b = np.ones(k_num, dtype=np.uint8)  # party 1 starts at t = 1
    v_alpha = np.zeros((k_num, lam), dtype=np.uint8)
    if additive:
        lanes = partial(lanes_of, group=group)
        va = lanes(v_alpha)  # lane-domain V_alpha accumulator
        betas_l = lanes(betas)

    cw_s = np.zeros((k_num, n, lam), dtype=np.uint8)
    cw_v = np.zeros((k_num, n, lam), dtype=np.uint8)
    cw_t = np.zeros((k_num, n, 2), dtype=np.uint8)

    for i in range(n):
        p0 = prg.gen(s_a)
        p1 = prg.gen(s_b)
        a_i = alpha_bits[:, i]  # 1 -> keep R / lose L
        lose_is_r = (a_i ^ 1).astype(np.uint8)
        s_cw = _sel(p0.s_l, p0.s_r, lose_is_r) ^ _sel(p1.s_l, p1.s_r, lose_is_r)
        # beta folds into v_cw when the lose side matches the bound:
        # LT_BETA on lose == L (a_i == 1), GT_BETA on lose == R (a_i == 0).
        beta_gate = a_i if bound is Bound.LT_BETA else (a_i ^ 1)
        if not additive:
            v_cw = (
                _sel(p0.v_l, p0.v_r, lose_is_r)
                ^ _sel(p1.v_l, p1.v_r, lose_is_r)
                ^ v_alpha
            )
            v_cw ^= betas * beta_gate[:, None]
            v_alpha ^= (_sel(p0.v_l, p0.v_r, a_i)
                        ^ _sel(p1.v_l, p1.v_r, a_i) ^ v_cw)
        else:
            # V_CW <- (-1)^{t1} * [Convert(v1_lose) - Convert(v0_lose)
            #                      - V_alpha + beta_gate * beta]
            sign = t_b.astype(bool)[:, None]
            vcw_l = (lanes(_sel(p1.v_l, p1.v_r, lose_is_r))
                     - lanes(_sel(p0.v_l, p0.v_r, lose_is_r)) - va
                     + betas_l * beta_gate[:, None].astype(betas_l.dtype))
            vcw_l = np.where(sign, -vcw_l, vcw_l)
            # V_alpha <- V_alpha - Convert(v1_keep) + Convert(v0_keep)
            #            + (-1)^{t1} * V_CW
            va = (va - lanes(_sel(p1.v_l, p1.v_r, a_i))
                  + lanes(_sel(p0.v_l, p0.v_r, a_i))
                  + np.where(sign, -vcw_l, vcw_l))
            v_cw = bytes_of(vcw_l, group)
        tl_cw = p0.t_l ^ p1.t_l ^ a_i ^ 1
        tr_cw = p0.t_r ^ p1.t_r ^ a_i
        cw_s[:, i] = s_cw
        cw_v[:, i] = v_cw
        cw_t[:, i, 0] = tl_cw
        cw_t[:, i, 1] = tr_cw
        t_cw_keep = _sel(tl_cw, tr_cw, a_i)
        new_s_a = _sel(p0.s_l, p0.s_r, a_i) ^ s_cw * t_a[:, None]
        new_s_b = _sel(p1.s_l, p1.s_r, a_i) ^ s_cw * t_b[:, None]
        new_t_a = _sel(p0.t_l, p0.t_r, a_i) ^ (t_a & t_cw_keep)
        new_t_b = _sel(p1.t_l, p1.t_r, a_i) ^ (t_b & t_cw_keep)
        s_a, s_b, t_a, t_b = new_s_a, new_s_b, new_t_a, new_t_b

    if not additive:
        cw_np1 = s_a ^ s_b ^ v_alpha
    else:
        # CW_{n+1} <- (-1)^{t1_n} * [Convert(s1_n) - Convert(s0_n) - V_alpha]
        last = lanes(s_b) - lanes(s_a) - va
        cw_np1 = bytes_of(
            np.where(t_b.astype(bool)[:, None], -last, last), group)
    return KeyBundle(
        s0s=s0s.copy(), cw_s=cw_s, cw_v=cw_v, cw_t=cw_t, cw_np1=cw_np1,
        group=group,
    )


def gen_on_device(
    lam: int,
    cipher_keys,
    alphas: np.ndarray,
    betas: np.ndarray,
    s0s: np.ndarray,
    bound: Bound,
    group: str = "xor",
    device=None,
) -> KeyBundle:
    """Generate K keys with the level walk on the card (``device``, the
    card unless the caller passes ``"cpu"``, where the kernels' plain
    versions run).  Returns the two-party ``KeyBundle``, byte-identical to
    ``gen_batch`` on the same ``(alphas, betas, s0s, bound)``.

    lam = 16 runs kernel G1 and lam = 32 kernel G2
    (``backends.device_gen.DeviceKeyGen``), lam >= 48 kernels B7a and W2
    (``HybridKeyGen``).  An additive ``group`` takes ``gen_batch`` on the
    host: no keygen kernel, in this package or in ``dcf_tpu``, has the
    signed lane algebra, and ``dcf_tpu`` routes it the same way.  A device
    failure raises (the ``keygen.device`` fault point sits in front of the
    kernels): there is no fallback to the host walk."""
    check_group(group, lam)
    _check_gen_inputs(alphas, betas, s0s, lam)
    if group != "xor":
        prg = HirosePrgNp(lam, cipher_keys, warn=False)
        return gen_batch(prg, alphas, betas, s0s, bound, group)
    from dcf_tpu_torch.backends.device_gen import DeviceKeyGen, HybridKeyGen
    from dcf_tpu_torch.testing.faults import fire

    fire("keygen.device", alphas.shape[0], lam)
    if lam < 48:
        kg = DeviceKeyGen(lam, cipher_keys, device=device)
        return kg.to_host_bundle(kg.gen(alphas, betas, s0s, bound))
    return HybridKeyGen(lam, cipher_keys, device=device).gen(
        alphas, betas, s0s, bound)


def gen_on_device_with_planes(
    lam: int,
    cipher_keys,
    alphas: np.ndarray,
    betas: np.ndarray,
    s0s: np.ndarray,
    bound: Bound,
    device=None,
) -> tuple[KeyBundle, dict | None]:
    """``gen_on_device`` (XOR group) plus the staged narrow image:
    ``(bundle, planes)``, ``planes`` ``{party: arrays on the device}``
    for both parties from the same B7a + W2 run
    (``backends.device_gen.HybridKeyGen.gen_with_planes_pair``).  The key
    factory hands the pair to the serving registry, so a claimed key's
    image stages with no host round trip.

    ``planes`` is None below lam = 48, where no hybrid staged layout
    exists.  There is no host fallback: a device failure raises, as in
    ``gen_on_device``."""
    _check_gen_inputs(alphas, betas, s0s, lam)
    if lam < 48:
        return gen_on_device(lam, cipher_keys, alphas, betas, s0s, bound,
                             device=device), None
    from dcf_tpu_torch.backends.device_gen import HybridKeyGen
    from dcf_tpu_torch.testing.faults import fire

    fire("keygen.device", alphas.shape[0], lam)
    return HybridKeyGen(lam, cipher_keys, device=device
                        ).gen_with_planes_pair(alphas, betas, s0s, bound)
