"""Kernel B3 (``csrc/prefix_eval.cu``, the slot-per-point schedule) on
the card: byte-identical to its plain version, ``prefix_eval_plain``, for
K = 3 stacked keys at frontier depths k = 8, 17 and 21 (n = 128), every
group, both parties, on m = 1, 65, 1000 and 2^20 + 7 random points (x =
alpha and alpha +- 1 of each key planted) and consecutive ones (a warp's
lanes turn alike at all but the last levels); and walks under 16 levels,
which go to the pair walk (n = 16 at k = 8, n = 32 at k = 17), beside a
24-level one (n = 32 at k = 8).  The host's slot harness in
``test_torch_csrc.py`` reads the table as BkLane, so only these tests
check BkWin's addressing (its second, rotated table and the 64 KB
boundary).  Skips on a host without a card; imports neither JAX nor the
test suite's conftest, so it runs on the card with:

    python3 -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_prefix_card.py
"""

import numpy as np
import pytest
import torch

from dcf_tpu_torch.backends.fulldomain import tree_expand_np
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prefix_eval import (
    frontier_table, prefix_eval, prefix_eval_plain)
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.ops.tree_expand import tree_expand
from dcf_tpu_torch.ops.walk_eval import aes_image
from dcf_tpu_torch.spec import Bound

GROUPS = ("xor", "add8", "add16", "add32")
K_NUM = 3
N_BYTES = 16
HOST_LEVELS = 6  # the prefix backend's host levels of a frontier
MS = (1, 65, 1000, (1 << 20) + 7)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this host has none")
    return torch.device("cuda")


def _points(rng, alphas, m: int, consecutive: bool,
            n_bytes: int = N_BYTES) -> np.ndarray:
    """uint8 [m, n_bytes]: consecutive points from a random start (mod
    2^n), or random ones with x = alpha - 1, alpha, alpha + 1 of each key
    first."""
    if consecutive:
        hi = rng.integers(0, 256, 8, dtype=np.uint8)
        lo = np.arange(m, dtype=np.uint64) + np.uint64(
            rng.integers(0, 1 << 62))
        full = np.concatenate(
            [np.broadcast_to(hi, (m, 8)),
             lo.astype(">u8").view(np.uint8).reshape(m, 8)], 1)
        return np.ascontiguousarray(full[:, 16 - n_bytes:])
    xs = rng.integers(0, 256, (m, n_bytes), dtype=np.uint8)
    vals = [int.from_bytes(a.tobytes(), "big") + d
            for a in alphas for d in (-1, 0, 1)]
    for j, x in enumerate(vals[:m]):
        xs[j] = np.frombuffer((x % (1 << 8 * n_bytes)).to_bytes(
            n_bytes, "big"), np.uint8)
    return xs


def _table(prg, aes, kb: KeyBundle, t: dict, b: int, k: int, group: str):
    """The keys' depth-k frontier tables, stacked: the host levels, then
    kernel B2's."""
    tables = []
    for i in range(K_NUM):
        one = KeyBundle(*(a[i:i + 1] for a in (
            kb.s0s, kb.cw_s, kb.cw_v, kb.cw_t, kb.cw_np1)), group=group)
        top = (torch.from_numpy(a).to(aes.device)
               for a in tree_expand_np(prg, one, b, HOST_LEVELS))
        tables.append(frontier_table(*tree_expand(
            aes, t["cw_s"][i], t["cw_v"][i], t["cw_t"][i], *top,
            k0=HOST_LEVELS, k1=k, group=group)))
    return torch.cat(tables)


def _check(card, seed: int, group: str, k: int, n_bytes: int) -> None:
    """B3 against prefix_eval_plain at n = 8 n_bytes, depth k: both
    parties, random and consecutive points, every m of MS."""
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32), rng.bytes(32)]
    prg = HirosePrgNp(16, ck)
    aes = torch.from_numpy(aes_image(ck[0])).to(card)
    bound = list(Bound)[(GROUPS.index(group) + k) % 2]
    alphas = rng.integers(0, 256, (K_NUM, n_bytes), dtype=np.uint8)
    bundle = gen_batch(prg, alphas,
                       rng.integers(0, 256, (K_NUM, 16), dtype=np.uint8),
                       random_s0s(K_NUM, 16, rng), bound, group=group)
    for b in (0, 1):
        kb = bundle.for_party(b)
        t = {name: torch.from_numpy(np.ascontiguousarray(a)).to(card)
             for name, a in (("cw_s", kb.cw_s), ("cw_v", kb.cw_v),
                             ("cw_t", kb.cw_t), ("cw_np1", kb.cw_np1))}
        table = _table(prg, aes, kb, t, b, k, group)
        neg = bool(b) and group != "xor"
        for consecutive in (False, True):
            for m in MS:
                xs = torch.from_numpy(_points(
                    rng, alphas, m, consecutive, n_bytes)[None]).to(card)
                args = (aes, table, t["cw_s"], t["cw_v"], t["cw_t"],
                        t["cw_np1"], xs)
                got = prefix_eval(*args, k=k, negate=neg, group=group)
                want = prefix_eval_plain(*args, k=k, negate=neg, group=group)
                assert torch.equal(got, want), (bound, b, m, consecutive)


@pytest.mark.card
@pytest.mark.parametrize("k", [8, 17, 21])
@pytest.mark.parametrize("group", GROUPS)
def test_prefix_eval_matches_plain_on_the_card(card, group, k):
    _check(card, 2400 + 10 * GROUPS.index(group) + k, group, k, N_BYTES)


@pytest.mark.card
@pytest.mark.parametrize("n_bytes, k", [(2, 8), (4, 17), (4, 8)])
@pytest.mark.parametrize("group", GROUPS)
def test_prefix_eval_short_walks_match_plain_on_the_card(card, group,
                                                         n_bytes, k):
    _check(card, 2500 + 10 * GROUPS.index(group) + k + n_bytes, group, k,
           n_bytes)
