"""The port's 2-server PIR path on the CPU against dcf_tpu's:
``pir_answer_share`` (kernel P1's plain version) on the same database and
selection shares (packed lane words, as both packages keep them),
``pir_query_bundle`` byte-identical, and the slice as a
whole: ``Dcf.pir_query`` -> ``PirServer.answer`` for both parties ->
``pir_reconstruct`` returns the records, at byte and non-byte domains,
with each party's answer share equal to the JAX server's (whose EvalAll
kernel runs in interpret mode); a ``serve.eval`` fault is retried, then
evicted.  Tolerance: exact byte equality."""

import warnings

import numpy as np
import pytest
import torch

from dcf_tpu.backends.evalall import DpfEvalAll as JDpfEvalAll
from dcf_tpu.ops.prg import HirosePrgNp as JPrg
from dcf_tpu.protocols.dpf import DpfBundle as JDpfBundle
from dcf_tpu.serve.registry import KeyRegistry
from dcf_tpu.utils.bits import pack_lanes
from dcf_tpu.workloads.pir import PirDatabase as JPirDatabase
from dcf_tpu.workloads.pir import PirServer as JPirServer
from dcf_tpu.workloads.pir import pir_answer_share as j_pir_answer_share
from dcf_tpu.workloads.pir import pir_query_bundle as j_pir_query_bundle

from dcf_tpu_torch import Dcf
from dcf_tpu_torch.backends.evalall import DpfEvalAll
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.ops.pir_answer import (
    pack_selection,
    pir_answer,
    pir_answer_plain,
    unpack_selection,
)
from dcf_tpu_torch.ops.prg import HirosePrgNp as TPrg
from dcf_tpu_torch.protocols.dpf import decode_proto_frame
from dcf_tpu_torch.spec import Bound
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.workloads.pir import (
    PirDatabase,
    PirServer,
    pir_answer_share,
    pir_query_bundle,
    pir_reconstruct,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

LAM = 32


@pytest.fixture(scope="module")
def ck():
    rng = np.random.default_rng(0x919)
    return [rng.bytes(32) for _ in range(18)]


@pytest.fixture(scope="module")
def prgs(ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JPrg(LAM, ck), TPrg(LAM, ck)


@pytest.fixture(scope="module")
def evaluators(ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JDpfEvalAll(LAM, ck, interpret=True),
                DpfEvalAll(LAM, ck, device="cpu"))


class Registry:
    """The least a ``PirServer`` asks of a registry: frames in, snapshots
    out."""

    def __init__(self):
        self.keys = {}

    def register(self, key_id, frame, generation=1):
        self.keys[key_id] = (decode_proto_frame(frame), None, generation)

    def snapshot(self, key_id):
        return self.keys[key_id]


def _records(rng, n_bits, record_bytes=8):
    return rng.integers(0, 256, (1 << n_bits, record_bytes), dtype=np.uint8)


@pytest.mark.parametrize("n_bits,record_bytes,k_num",
                         [(5, 4, 1), (8, 8, 3), (10, 32, 4), (9, 36, 9)])
def test_pir_answer_share_matches_dcf_tpu(n_bits, record_bytes, k_num):
    """The same database and the same selection shares, packed lane words
    int32 [K, 2^n / 32], through both packages' inner products (record
    bytes in leaf order here, bit planes there)."""
    rng = np.random.default_rng(700 + n_bits)
    records = _records(rng, n_bits, record_bytes)
    t = rng.integers(0, 2, (k_num, 1 << n_bits), dtype=np.uint8)
    words = pack_lanes(t[:, None, :]).view(np.int32)
    want = j_pir_answer_share(words, JPirDatabase(records, n_bits))
    db = PirDatabase(records, n_bits, device="cpu")
    tw = torch.from_numpy(np.ascontiguousarray(words[:, 0]))
    assert torch.equal(tw, pack_selection(torch.from_numpy(t)))
    before = pir_answer.launches
    got = pir_answer_share(tw, db)
    assert pir_answer.launches == before  # CPU: the plain version
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert torch.equal(pir_answer(tw, db.rows), pir_answer_plain(tw, db.rows))
    # A one-hot selection returns that row of the leaf-ordered database.
    one = torch.zeros((1, (1 << n_bits) // 32), dtype=torch.int32)
    one[0, 0] = 1 << 3
    assert np.array_equal(pir_answer_share(one, db)[0], db.rows[3].numpy())


@pytest.mark.parametrize("n_bits", [8, 9, 14])
def test_pir_query_bundle_matches(prgs, n_bits):
    rng = np.random.default_rng(710 + n_bits)
    idx = [0, (1 << n_bits) - 1, int(rng.integers(0, 1 << n_bits))]
    s0s = random_s0s(3, LAM, rng)
    tb = pir_query_bundle(prgs[1], idx, n_bits, s0s)
    jb = j_pir_query_bundle(prgs[0], idx, n_bits, s0s)
    assert tb.to_bytes() == jb.to_bytes()
    assert tb.n_bits == 8 * ((n_bits + 7) // 8)
    with pytest.raises(ValueError, match="outside the"):
        pir_query_bundle(prgs[1], [1 << n_bits], n_bits, s0s[:1])
    with pytest.raises(ValueError, match="outside the"):
        pir_query_bundle(prgs[1], [-1], n_bits, s0s[:1])


@pytest.mark.parametrize("n_bits", [8, 10, 5])
def test_slice_end_to_end_matches_dcf_tpu(ck, evaluators, n_bits):
    """Dcf.pir_query -> frames -> PirServer.answer x 2 -> pir_reconstruct
    at a byte domain (8) and non-byte domains (10, 5: prefix-depth
    evaluations of 16- and 8-bit keys); each party's answer share equals
    the JAX server's on the same frame and database."""
    rng = np.random.default_rng(720 + n_bits)
    records = _records(rng, n_bits)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        client = Dcf((n_bits + 7) // 8, LAM, ck, device="cpu")
    idx = [0, (1 << n_bits) - 1, 13, int(rng.integers(0, 1 << n_bits))]
    query = client.pir_query(idx, rng=np.random.default_rng(5),
                             n_bits=n_bits)
    again = client.pir_query(idx, rng=np.random.default_rng(5),
                             n_bits=n_bits)
    assert again.to_bytes() == query.to_bytes()  # reproducible from rng
    frame = query.to_bytes()
    j_eval, t_eval = evaluators
    registry = Registry()
    registry.register("q", frame)
    server = PirServer(t_eval, PirDatabase(records, n_bits, device="cpu"),
                       registry)
    j_registry = KeyRegistry(None)
    j_registry.register("q", JDpfBundle.from_bytes(frame))
    j_server = JPirServer(j_eval, JPirDatabase(records, n_bits), j_registry)
    shares = [server.answer("q", b) for b in (0, 1)]
    for b in (0, 1):
        assert shares[b].shape == (4, 8)
        assert np.array_equal(shares[b], j_server.answer("q", b)), b
    assert np.array_equal(pir_reconstruct(*shares), records[idx])
    # A repeated query rides the selection cache: no new evaluation.
    cached = server._sel[("q", 0)][1]
    assert np.array_equal(server.answer("q", 0), shares[0])
    assert server._sel[("q", 0)][1] is cached
    # A new generation of the key evicts it.
    registry.register("q", frame, generation=2)
    assert np.array_equal(server.answer("q", 0), shares[0])
    assert server._sel[("q", 0)][1] is not cached
    t_eval.invalidate()
    j_eval.invalidate()


@pytest.mark.parametrize("n_bits", [8, 3])
def test_server_caches_packed_selection_words(ck, evaluators, n_bits):
    """``PirServer``'s cache entry is the packed selection, int32
    [K, ceil(2^n / 32)] (one word at n = 3, the bits past the domain
    zero), one-hot across the parties at each key's leaf; the records
    reconstruct from it."""
    rng = np.random.default_rng(750 + n_bits)
    records = _records(rng, n_bits)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        client = Dcf(1, LAM, ck, device="cpu")
    idx = [0, (1 << n_bits) - 1, 5]
    registry = Registry()
    registry.register("q", client.pir_query(idx, rng=rng,
                                            n_bits=n_bits).to_bytes())
    server = PirServer(evaluators[1],
                       PirDatabase(records, n_bits, device="cpu"), registry)
    shares = [server.answer("q", b) for b in (0, 1)]
    assert np.array_equal(pir_reconstruct(*shares), records[idx])
    sel = [server._sel[("q", b)][1] for b in (0, 1)]
    for words in sel:
        assert words.dtype == torch.int32
        assert tuple(words.shape) == (len(idx), -(-(1 << n_bits) // 32))
    both = unpack_selection(sel[0] ^ sel[1], 32 * sel[0].shape[1])
    hits = [int(format(i, f"0{n_bits}b")[::-1], 2) for i in idx]
    want = torch.zeros_like(both)
    want[torch.arange(len(idx)), hits] = 1
    assert torch.equal(both, want)
    evaluators[1].invalidate()


def test_facade_pir_query_domain_contract(ck):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        client = Dcf(2, LAM, ck, device="cpu")
    assert client.pir_query([7]).n_bits == 16
    assert client.pir_query([7], n_bits=9).n_bits == 16
    for bad in (8, 17, 0):
        with pytest.raises(ValueError, match="n_bytes"):
            client.pir_query([0], n_bits=bad)
    with pytest.raises(ValueError, match="outside the"):
        client.pir_query([512], n_bits=9)


def test_eval_fault_retried_then_evicted(prgs, evaluators):
    """One faulted attempt is absorbed by the bounded retry, which first
    evicts the selection share and the evaluator's staged image; a window
    wider than the retry budget re-raises the cause, and the server serves
    again after it."""
    n = 8
    rng = np.random.default_rng(730)
    records = _records(rng, n)
    idx = [12, 200]
    registry = Registry()
    registry.register("q", pir_query_bundle(
        prgs[1], idx, n, random_s0s(2, LAM, rng)).to_bytes())
    t_eval = evaluators[1]
    server = PirServer(t_eval, PirDatabase(records, n, device="cpu"),
                       registry, retries=1)
    assert np.array_equal(
        pir_reconstruct(server.answer("q", 0), server.answer("q", 1)),
        records[idx])
    assert t_eval._cache is not None and ("q", 0) in server._sel
    fired = []

    def first_fire_fails(key_id, k_num):
        fired.append((key_id, k_num))
        return len(fired) > 1

    assert not faults.is_armed("serve.eval")
    with faults.inject("serve.eval",
                       handler=faults.fail_unless(first_fire_fails)):
        assert faults.is_armed("serve.eval")
        staged = t_eval._cache
        a0 = server.answer("q", 0)
        assert t_eval._cache is not staged  # evicted, then staged anew
    assert fired == [("q", 2), ("q", 2)] and server.eval_faults == 1
    assert np.array_equal(pir_reconstruct(a0, server.answer("q", 1)),
                          records[idx])
    with faults.inject("serve.eval"):
        with pytest.raises(faults.InjectedFault):
            server.answer("q", 0)
    assert server.eval_faults == 3  # both attempts of the budget
    assert ("q", 0) not in server._sel and t_eval._cache is None
    with faults.inject("serve.eval", exc=OSError("device lost")):
        with pytest.raises(OSError, match="device lost"):
            server.answer("q", 1)
    assert np.array_equal(
        pir_reconstruct(server.answer("q", 0), server.answer("q", 1)),
        records[idx])
    with pytest.raises(ValueError, match="unknown fault point"):
        with faults.inject("serve.evil"):
            pass
    t_eval.invalidate()


def test_server_and_database_refusals(prgs, evaluators, ck):
    rng = np.random.default_rng(740)
    good = _records(rng, 8, 4)
    with pytest.raises(ShapeError, match="uint8"):
        PirDatabase(good.astype(np.int32), 8, device="cpu")
    with pytest.raises(ShapeError, match="do not fill"):
        PirDatabase(good[:100], 8, device="cpu")
    with pytest.raises(ShapeError, match="multiple of 4"):
        PirDatabase(_records(rng, 8, 6), 8, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        PirDatabase(good[:1], 0, device="cpu")
    db9 = PirDatabase(_records(rng, 9, 4), 9, device="cpu")
    assert "n_bits=9" in repr(db9)
    registry = Registry()
    server = PirServer(evaluators[1], db9, registry)
    registry.register("shallow", pir_query_bundle(
        prgs[1], [3], 8, random_s0s(1, LAM, rng)).to_bytes())
    with pytest.raises(ShapeError, match="too shallow"):
        server.answer("shallow", 0)
    prg16 = TPrg(16, ck[:2])
    registry.keys["plain"] = (gen_batch(
        prg16, rng.integers(0, 256, (1, 2), dtype=np.uint8),
        rng.integers(0, 256, (1, 16), dtype=np.uint8),
        random_s0s(1, 16, rng), Bound.LT_BETA), None, 1)
    with pytest.raises(ShapeError, match="not the DpfBundle"):
        server.answer("plain", 0)
    with pytest.raises(ValueError, match="party"):
        server.answer("shallow", 2)
    with pytest.raises(ValueError, match="retries"):
        PirServer(evaluators[1], db9, registry, retries=-1)
    with pytest.raises(ShapeError, match="does not cover"):
        pir_answer_share(torch.zeros((1, 256), dtype=torch.uint8), db9)
    with pytest.raises(ShapeError, match="int32"):  # bytes, not words
        pir_answer_share(torch.zeros((1, 16), dtype=torch.uint8), db9)
    with pytest.raises(ShapeError):
        pir_reconstruct(np.zeros((2, 4), np.uint8), np.zeros((3, 4), np.uint8))
    with pytest.raises(ShapeError):
        pir_answer(torch.zeros((1, 512), dtype=torch.uint8),
                   torch.zeros((512, 6), dtype=torch.uint8))
