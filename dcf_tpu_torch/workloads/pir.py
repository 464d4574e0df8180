"""2-server PIR over DPF full-domain evaluation (EvalAll).

Counterpart of ``dcf_tpu/workloads/pir.py``.  The textbook construction
(Boyle-Gilboa-Ishai): a client who wants record ``alpha`` of a database
both servers hold splits a DPF for the point function ``f(alpha) = 1``
into two keys and sends one to each server.  Each server evaluates its
key over the whole domain (the leaf t bits are an XOR sharing of the
one-hot selection vector), takes the inner product with the database over
GF(2), and returns its ``record_bytes`` answer share.  The XOR of the two
shares is the record; each server saw only a pseudorandom key, so neither
learns ``alpha``.  Every query touches the whole database, which is why
the EvalAll kernel's cost per leaf is the cost of a query.

Layout: ``PirDatabase`` keeps the records as bytes in bitreverse_n order,
the order EvalAll emits leaves in, uint8 [2^n, record_bytes] on the
device.  A selection share is the leaves' t bits packed as the reference
packs them, int32 [K, ceil(2^n / 32)], bit p % 32 of word p // 32 the
leaf at position p.  That position and database row p refer to the same
domain point, so the inner product (kernel P1, ``ops.pir_answer``) is
the XOR of the rows whose t bit is set, with no gather anywhere, and the
hit at position bitreverse_n(alpha) selects exactly ``db[alpha]``.

Serving: ``PirServer`` snapshots DPF bundles from a registry, keeps the
staged key image and the selection shares resident across queries, and
answers per party behind the ``serve.eval`` fault seam with a bounded
retry: an injected fault evicts the staged state, which may be poisoned,
and the retry starts again from the registry snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from dcf_tpu_torch.backends._common import bitrev_values, resolve_device
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.ops.pir_answer import pir_answer
from dcf_tpu_torch.protocols.dpf import DpfBundle, dpf_gen_batch
from dcf_tpu_torch.testing.faults import fire

__all__ = [
    "PirDatabase",
    "PirServer",
    "pir_answer_share",
    "pir_query_alphas",
    "pir_query_bundle",
    "pir_reconstruct",
]


class PirDatabase:
    """The resident image of a 2^n-record database: the records permuted
    to bitreverse_n order, uint8 [2^n_bits, record_bytes] on ``device``
    (``rows``).  Made once and only read by queries.  The array the
    caller passed is not retained.

    ``record_bytes`` must be a multiple of 4 (kernel P1 reads 4-byte
    words, or 16-byte ones where it is a multiple of 16); pad the
    records otherwise.
    """

    def __init__(self, records: np.ndarray, n_bits: int, device=None):
        records = np.asarray(records)
        if records.dtype != np.uint8 or records.ndim != 2:
            raise ShapeError(
                f"records must be uint8 [num_records, record_bytes], got "
                f"{records.dtype} {records.shape}")
        if n_bits < 1:
            raise ValueError(f"n_bits={n_bits} must be >= 1")
        if records.shape[0] != 1 << n_bits:
            raise ShapeError(
                f"{records.shape[0]} records do not fill the 2^{n_bits} "
                "domain; pad with zero records: PIR touches every record, "
                "so the domain must be exact")
        if records.shape[1] < 4 or records.shape[1] % 4:
            raise ShapeError(
                f"record_bytes={records.shape[1]} must be a positive "
                "multiple of 4; pad the records")
        self.device = resolve_device(device)
        self.n_bits = int(n_bits)
        self.record_bytes = int(records.shape[1])
        self.num_records = int(records.shape[0])
        # Shipped in natural order and permuted on the device.
        natural = torch.from_numpy(np.ascontiguousarray(records)).to(
            self.device)
        self.rows = natural[bitrev_values(n_bits, self.device)].contiguous()

    def __repr__(self) -> str:
        return (f"PirDatabase(n_bits={self.n_bits}, "
                f"record_bytes={self.record_bytes})")


def pir_answer_share(t_words: torch.Tensor, db: PirDatabase) -> np.ndarray:
    """One party's answer shares from its selection-vector shares.

    ``t_words``: the leaf t bits packed, int32 [K, ceil(2^n / 32)], that
    ``DpfEvalAll.eval_party(..., want_y=False)`` returns (bitreverse
    order, as the database's rows), on the database's device.  The inner
    product over GF(2) runs there (kernel P1); only the K x record_bytes
    answer comes back.  uint8 [K, record_bytes].
    """
    words = -(-db.num_records // 32)
    if t_words.dim() != 2 or t_words.shape[1] != words:
        raise ShapeError(
            f"selection share of shape {tuple(t_words.shape)} does not "
            f"cover the database's {db.num_records} records ({words} "
            "packed words a key)")
    return pir_answer(t_words, db.rows).cpu().numpy()


def pir_query_bundle(prg, indices, n_bits: int, s0s: np.ndarray,
                     betas: np.ndarray | None = None) -> DpfBundle:
    """Client-side query keygen: one DPF key pair per record index.

    ``indices``: the K record indices to retrieve (each in [0,
    2^n_bits)); ``s0s`` uint8 [K, 2, lam]: fresh random root seeds, the
    client's secret randomness, supplied by the caller like all key
    material.  ``betas`` defaults to the all-ones payload; the answer
    path reads only the leaf t bits, so the payload never matters to
    retrieval.

    The DCFK wire domain is byte-granular but the database domain need
    not be: for ``n_bits`` that is not a multiple of 8 the key is
    generated over the next byte-granular domain with the index in the
    top ``n_bits`` (``alpha = index << pad``), and servers evaluate only
    ``n_bits`` levels deep: the depth-d t bits are the one-hot indicator
    of alpha's d-bit prefix, which is the selection vector
    (``DpfEvalAll.eval_party``'s prefix contract).
    """
    alphas = pir_query_alphas(indices, n_bits)
    if betas is None:
        betas = np.full((alphas.shape[0], s0s.shape[-1]), 0xFF,
                        dtype=np.uint8)
    return dpf_gen_batch(prg, alphas, betas, s0s)


def pir_query_alphas(indices, n_bits: int) -> np.ndarray:
    """The DPF points of ``pir_query_bundle``'s keys: uint8 [K, ceil(n_bits
    / 8)], each index in the top ``n_bits`` bits of the byte-granular key
    domain."""
    idx = [int(i) for i in np.asarray(indices).reshape(-1)]
    n_key = 8 * ((n_bits + 7) // 8)  # the wire (key) domain
    pad = n_key - n_bits
    for i in idx:
        if not 0 <= i < (1 << n_bits):
            raise ValueError(
                f"record index {i} outside the 2^{n_bits}-record database")
    return np.array(
        [list((i << pad).to_bytes(n_key // 8, "big")) for i in idx],
        dtype=np.uint8).reshape(len(idx), n_key // 8)


def pir_reconstruct(a0: np.ndarray, a1: np.ndarray) -> np.ndarray:
    """Client-side XOR reconstruction of the two answer shares."""
    if a0.shape != a1.shape:
        raise ShapeError(
            f"answer shares disagree on shape: {a0.shape} vs {a1.shape}")
    return (np.asarray(a0) ^ np.asarray(a1)).astype(np.uint8)


class PirServer:
    """One 2-server-PIR server.

    ``registry``: anything with ``snapshot(key_id) -> (bundle, protocol,
    generation)``.  The server serves both parties: ``answer(key_id, b)``
    returns party ``b``'s uint8 [K, record_bytes] answer shares.

    A PIR query has no input points, the key is the query, so the server
    keeps a full-domain evaluator (``backends.evalall.DpfEvalAll``) and
    caches each key's selection shares per (key_id, party, generation),
    as packed words (8 MiB for K = 4 keys at 2^24 records, as the
    reference caches its ``t_words``): repeated queries under the same
    key run only the inner product again.
    The ``serve.eval`` fault seam fires per attempt with a bounded retry;
    a faulted attempt evicts the selection cache entry and the
    evaluator's staged image before the retry starts again from the
    registry snapshot.
    """

    def __init__(self, evaluator, db: PirDatabase, registry, *,
                 retries: int = 1):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.evaluator = evaluator
        self.db = db
        self.registry = registry
        self.retries = int(retries)
        self.eval_faults = 0  # attempts lost behind the serve.eval seam
        self._sel: dict = {}  # (key_id, b) -> (generation, t_words)

    def _selection(self, key_id: str, b: int, bundle: DpfBundle,
                   generation: int) -> torch.Tensor:
        ent = self._sel.get((key_id, b))
        if ent is not None and ent[0] == generation:
            return ent[1]
        staged_cw, fronts, parts = self.evaluator._staged_for(
            bundle, self.db.n_bits)
        _, t_words = self.evaluator.eval_party(
            b, parts[b], self.db.n_bits, staged_cw, fronts[b], want_y=False)
        self._sel[(key_id, b)] = (generation, t_words)
        return t_words

    def answer(self, key_id: str, b: int) -> np.ndarray:
        """Party ``b``'s answer shares for the K queries registered under
        ``key_id``: uint8 [K, record_bytes]."""
        if b not in (0, 1):
            raise ValueError(f"party must be 0 or 1, got {b}")
        bundle, _protocol, generation = self.registry.snapshot(key_id)
        if not isinstance(bundle, DpfBundle):
            raise ShapeError(
                f"key {key_id!r} is a {type(bundle).__name__}, not the "
                "DpfBundle a PIR query needs; register the query through "
                "the DPF keygen path")
        if bundle.n_bits < self.db.n_bits:
            raise ShapeError(
                f"key {key_id!r} walks a {bundle.n_bits}-bit domain, too "
                f"shallow for 2^{self.db.n_bits} records (deeper keys are "
                f"fine: the selection vector is a depth-{self.db.n_bits} "
                "prefix evaluation)")
        last: Exception | None = None
        for _attempt in range(self.retries + 1):
            try:
                fire("serve.eval", key_id, bundle.num_keys)
                t_words = self._selection(key_id, b, bundle, generation)
                return pir_answer_share(t_words, self.db)
            except Exception as e:  # counted and bounded: the retry
                # follows, and exhaustion re-raises the last error
                last = e
                self.eval_faults += 1
                self._sel.pop((key_id, b), None)
                self.evaluator.invalidate()
        raise last  # retries exhausted, the typed cause intact
