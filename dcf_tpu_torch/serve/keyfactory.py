"""On-device key factory: ahead-of-demand keygen pools.

Counterpart of ``dcf_tpu/serve/keyfactory.py``.  Refills mint through
the port's ``gen.gen_on_device`` on the facade's device: kernel G1 at
lam = 16, G2 at lam = 32, B7a + W2 at lam >= 48 (their plain versions
on a ``device="cpu"`` facade).  Behind a lam >= 48 ``hybrid`` facade a
refill keeps both parties' narrow arrays on the card
(``gen.gen_on_device_with_planes``) and each pool entry carries its
slice of them: a claimed key's image stages through
``put_bundle(bundle, dev_planes=...)`` with no host round trip, and
the bytes served are the ones its bundle would give.

DCF keygen is the expensive offline phase of the protocol — and for
fresh-key-per-session traffic the serving tier used to pay it
synchronously inside every registration.  This module is the
provisioning pipeline that moves it off the registration clock:

* **Pools.**  A ``PoolSpec`` declares one class of pre-mintable keys —
  a FIXED comparison function (alphas/betas/bound for plain DCF, or a
  MIC interval set) whose per-session freshness lives entirely in the
  starting seeds.  Two sessions of the same pool evaluate the same
  f; their key material is independent because every minted bundle
  draws fresh OS-entropy seeds.  That is exactly the
  correlated-randomness dealer model: the function is public
  configuration, the shares are the secret, and shares can be minted
  before anyone asks.
* **Batched on-device minting.**  A refill packs ``refill_batch``
  sessions' keys onto the K axis of ONE device keygen call
  (``gen.gen_on_device`` — the walk's latency is per LEVEL, not per
  key, so B sessions cost one session's walk) and splits the result
  into per-session bundles.
* **Batched durable publish.**  With a ``KeyStore`` configured, every
  refill batch is published under the ``~pool/<name>/<seq>`` namespace
  through ``KeyStore.put_many`` — per-frame write-fsync-rename, ONE
  manifest flip for the whole batch.  A kill anywhere mid-refill
  leaves the previous manifest: old pool or new pool, never a torn
  one.  Entries become claimable only AFTER the flip
  (publish-to-servable ordering), so a claimed key is always a durable
  key.  Spent pool frames reclaim two ways.  A DURABLE claim folds
  the ``~pool/...`` delete into the SAME manifest flip that publishes
  the session frame (``KeyStore.put(..., drop=...)``): no crash
  window can leave both visible, so the same key material can never
  be claimed twice across a restart.  A NON-durable claim reclaims
  asynchronously (every claim nudges the worker; ``delete_many``, one
  flip per batch, also flushed at close and piggybacked on refills) —
  a crash inside that ~one-worker-tick window CAN resurrect a frame
  whose shares the dead session already received, i.e. a second
  session could be handed the same key material.  That residual
  window is deliberate: closing it would cost a per-claim fsync —
  comparable to the synchronous keygen the pool exists to avoid —
  and a session that needs the strict cross-crash no-reuse guarantee
  gets it for free by registering ``durable=True`` (the reclaim then
  rides the flip the durable registration pays anyway).
* **Claims.**  ``claim(pool)`` pops a pre-minted entry (a pool HIT:
  registration latency is a deque pop, not an n-level GGM walk).  On
  exhaustion it falls back to a SYNCHRONOUS single-session mint on the
  caller's clock — counted (``keyfactory_pool_misses_total``) and
  warned (``BackendFallbackWarning``), never silent — through the same
  keygen route as a refill: the facade's device unless the pool names
  the host walk (``PoolSpec(device=False)``).
* **Refill policy.**  The worker refills pools that fell below
  ``low_water`` back up to ``target_depth``, CRITICAL pools first
  (``serve.admission.Priority`` — ONE priority vocabulary, not a
  second policy), and under service brownout BATCH-priority pools are
  not refilled at all (pre-minting batch keys while the queue sheds is
  spending device time on the traffic being turned away).  Refills are
  gated by a per-pool circuit breaker (``serve.breaker.BreakerBoard``
  keyed ``(~pool/<name>, "keyfactory")`` on the factory's own board,
  so a dying keygen pipeline cannot also latch the SERVING brownout):
  repeated refill failures open it, claims drain the remaining pool /
  fall back counted, and the cooldown's half-open probe re-tests the
  pipeline.  The ``keyfactory.refill`` fault seam
  (``testing.faults``) fires at the head of each refill batch.
* **Warm restart.**  ``DcfService.restore_keys`` routes restored
  ``~pool/...`` frames back into their pools via ``adopt_restored``
  with generations preserved — zero re-keygen for already-published
  pool keys, the durable store's guarantee extended to the un-claimed
  half of the provisioning pipeline.  Restored entries carry no device
  planes and stage from the host bundle on first use.

Driving modes mirror ``DcfService``: ``start()`` spawns the worker
thread (nudged by claims that drop a pool below low water, backstopped
by ``refill_interval_s`` polling); ``pump()`` runs one refill sweep
inline — the deterministic mode tests and benches drive.

Metrics: ``keyfactory_pool_depth{pool=...}`` /
``keyfactory_pool_hits_total`` / ``keyfactory_pool_misses_total`` /
``keyfactory_minted_keys_total`` / ``keyfactory_published_total`` /
``keyfactory_refills_total`` / ``keyfactory_refill_failures_total`` /
``keyfactory_restored_total`` / ``keyfactory_spent_reclaimed_total``.
"""

from __future__ import annotations

import threading
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from dcf_tpu_torch.errors import BackendFallbackWarning, ShapeError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.serve.admission import Priority, parse_priority
from dcf_tpu_torch.serve.breaker import BreakerBoard
from dcf_tpu_torch.serve.metrics import Metrics, labeled
from dcf_tpu_torch.spec import Bound
from dcf_tpu_torch.testing.faults import fire

__all__ = ["PoolSpec", "KeyFactory", "POOL_NS", "pool_store_id",
           "parse_pool_store_id"]

#: Durable-store namespace for un-claimed pool frames.  ``~`` keeps the
#: namespace out of any sane caller-chosen key-id space and sorts after
#: letters, so pool frames cluster at the end of ``store.key_ids()``.
POOL_NS = "~pool/"


def pool_store_id(pool: str, seq: int) -> str:
    return f"{POOL_NS}{pool}/{seq}"


def parse_pool_store_id(key_id: str) -> tuple[str, int] | None:
    """``~pool/<name>/<seq>`` -> ``(name, seq)``; None for any other
    id (the service uses this to route restored frames)."""
    if not key_id.startswith(POOL_NS):
        return None
    pool, sep, seq = key_id[len(POOL_NS):].rpartition("/")
    if not sep or not pool or not seq.isdigit():
        return None
    return pool, int(seq)


@dataclass(frozen=True)
class PoolSpec:
    """One class of pre-mintable session keys (module docstring).

    ``alphas``/``betas``: the FIXED comparison function every session
    of this pool evaluates — uint8 [K, n_bytes] / [K, lam] for plain
    DCF pools (K keys per session, usually 1).  ``intervals``: set
    instead of ``alphas`` for MIC protocol pools — minted entries are
    then ``ProtocolBundle``s over these intervals with ``betas`` uint8
    [m, lam] per-interval outputs.  ``priority``: refill class under
    brownout (CRITICAL pools refill first; BATCH refill pauses).
    ``target_depth``/``low_water``: the refill hysteresis band;
    ``refill_batch``: sessions minted per device call (the K-axis
    packing the on-device keygen kernel scales with).  ``device``:
    None or True mints through ``gen.gen_on_device`` on the facade's
    device; False names the facade's host walk.
    """

    name: str
    betas: np.ndarray
    alphas: np.ndarray | None = None
    intervals: tuple = ()
    bound: Bound = Bound.LT_BETA
    priority: Priority = Priority.NORMAL
    target_depth: int = 64
    low_water: int = 16
    refill_batch: int = 32
    device: bool | None = None

    def __post_init__(self):
        if not self.name or "/" in self.name:
            # api-edge: the name seeds the ~pool/<name>/<seq> store ids
            raise ValueError(
                f"pool name must be non-empty and '/'-free, "
                f"got {self.name!r}")
        object.__setattr__(self, "priority",
                           parse_priority(self.priority))
        object.__setattr__(self, "intervals",
                           tuple(tuple(pq) for pq in self.intervals))
        if (self.alphas is None) == (not self.intervals):
            raise ShapeError(
                f"pool {self.name!r} wants exactly one of alphas "
                "(plain DCF) or intervals (MIC)")
        betas = np.asarray(self.betas, dtype=np.uint8)
        object.__setattr__(self, "betas", betas)
        if self.alphas is not None:
            alphas = np.asarray(self.alphas, dtype=np.uint8)
            object.__setattr__(self, "alphas", alphas)
            if alphas.ndim != 2 or betas.shape != (alphas.shape[0],
                                                   betas.shape[-1]):
                raise ShapeError(
                    f"pool {self.name!r}: alphas must be [K, n_bytes] "
                    f"with betas [K, lam], got {alphas.shape} / "
                    f"{betas.shape}")
        elif betas.ndim != 2 or betas.shape[0] != len(self.intervals):
            raise ShapeError(
                f"pool {self.name!r}: betas must be "
                f"[{len(self.intervals)}, lam], got {betas.shape}")
        if self.target_depth < 1:
            # api-edge: pool-depth contract
            raise ValueError("target_depth must be >= 1")
        if not 0 <= self.low_water <= self.target_depth:
            # api-edge: refill-hysteresis contract
            raise ValueError(
                f"low_water must be in [0, target_depth="
                f"{self.target_depth}], got {self.low_water}")
        if self.refill_batch < 1:
            # api-edge: refill-batch contract
            raise ValueError("refill_batch must be >= 1")

    @property
    def keys_per_session(self) -> int:
        return (self.alphas.shape[0] if self.alphas is not None
                else 2 * len(self.intervals))

    def __repr__(self) -> str:  # betas are secret function values
        return (f"PoolSpec(name={self.name!r}, "
                f"kind={'mic' if self.intervals else 'plain'}, "
                f"keys_per_session={self.keys_per_session}, "
                f"priority={self.priority.name}, "
                f"depth={self.target_depth}, low={self.low_water}, "
                f"batch={self.refill_batch}, <function redacted>)")


class _Minted:
    """One pool entry: a pre-minted two-party session key, its narrow
    arrays on the device (``{party: planes}``, or None), and its durable
    pool id + generation."""

    __slots__ = ("bundle", "protocol", "planes", "pool_id", "generation")

    def __init__(self, bundle: KeyBundle, protocol, planes, pool_id: str,
                 generation: int):
        self.bundle = bundle
        self.protocol = protocol
        self.planes = planes
        self.pool_id = pool_id
        self.generation = generation

    def __repr__(self) -> str:  # never key material — identity only
        return (f"_Minted(pool_id={self.pool_id!r}, "
                f"gen={self.generation}, "
                f"planes={self.planes is not None})")


class _Pool:
    """Spec + its entry deque + depth gauge (mutated under the factory
    lock only)."""

    __slots__ = ("spec", "entries", "seq", "depth_gauge")

    def __init__(self, spec: PoolSpec, depth_gauge):
        self.spec = spec
        # A deque, deliberately: claims pop the HEAD under the factory
        # lock on the registration hot path — a list's pop(0) would
        # shift O(depth) entries per claim.
        self.entries: deque[_Minted] = deque()
        self.seq = 0  # next ~pool/<name>/<seq>; advanced past restores
        self.depth_gauge = depth_gauge

    def __repr__(self) -> str:
        return f"_Pool({self.spec.name!r}, depth={len(self.entries)})"


@dataclass
class RefillReport:
    """One ``pump()`` sweep: per-pool minted counts and the pools a
    breaker or failure skipped (benches/tests read it; the worker
    ignores it)."""

    minted: dict = field(default_factory=dict)
    skipped: list = field(default_factory=list)
    failed: dict = field(default_factory=dict)


class KeyFactory:
    """Background ahead-of-demand keygen pools (module docstring).

    Construct through ``DcfService`` (which wires the store, metrics,
    clock and brownout signal); drive with ``start()``/``close()`` in
    production or ``pump()`` in tests and benches.
    """

    def __init__(self, dcf, *, registry, store=None,
                 metrics: Metrics | None = None, clock=None,
                 brownout=None, refill_interval_s: float = 0.05,
                 breaker_failures: int = 3,
                 breaker_cooldown_s: float = 5.0, rng=None):
        from dcf_tpu_torch.utils.benchtime import monotonic

        self._dcf = dcf
        self._registry = registry
        self._store = store
        self.metrics = metrics if metrics is not None else Metrics()
        self._clock = clock if clock is not None else monotonic
        self._brownout = brownout if brownout is not None else (
            lambda: False)
        self.refill_interval_s = float(refill_interval_s)
        # dcflint: disable=determinism fresh key seeds MUST be
        # unpredictable (OS entropy); tests pass rng= to reproduce
        self._rng = rng if rng is not None else np.random.default_rng()
        # A numpy Generator is NOT thread-safe, and its draws here are
        # KEY MATERIAL: the refill worker and caller-thread sync mints
        # must serialize on it, not race it.
        self._rng_lock = threading.Lock()
        # The factory's OWN breaker board: a dying keygen pipeline must
        # fail refills fast after the threshold, but must not count as
        # an open SERVING breaker (which would latch service brownout
        # and shed live traffic because provisioning is sick).
        self.breakers = BreakerBoard(
            failures_to_open=max(int(breaker_failures), 1),
            cooldown_s=breaker_cooldown_s, metrics=self.metrics,
            clock=self._clock)
        self._lock = threading.Lock()
        # One refill sweep at a time: pump() computes each pool's
        # deficit under _lock but mints outside it, so two concurrent
        # sweeps would each see the full deficit and overfill the pool
        # past target_depth (wasting device keygen and durable frames).
        self._pump_lock = threading.Lock()
        self._pools: dict[str, _Pool] = {}
        self._orphans: dict[str, list[_Minted]] = {}  # restored frames
        # whose pool spec is not declared yet; add_pool adopts them
        self._spent: list[str] = []  # claimed pool ids awaiting the
        # batched store reclaim (delete_many — one manifest flip)
        self._worker: threading.Thread | None = None
        self._wake = threading.Event()
        self._closed = False
        m = self.metrics
        self._c_hits = m.counter("keyfactory_pool_hits_total")
        self._c_misses = m.counter("keyfactory_pool_misses_total")
        self._c_minted = m.counter("keyfactory_minted_keys_total")
        self._c_published = m.counter("keyfactory_published_total")
        self._c_refills = m.counter("keyfactory_refills_total")
        self._c_refill_failures = m.counter(
            "keyfactory_refill_failures_total")
        self._c_restored = m.counter("keyfactory_restored_total")
        self._c_reclaimed = m.counter("keyfactory_spent_reclaimed_total")
        self._c_worker_errors = m.counter("keyfactory_worker_errors_total")

    def __repr__(self) -> str:
        return (f"KeyFactory(pools={sorted(self._pools)}, "
                f"durable={self._store is not None})")

    # -- pool management ----------------------------------------------------

    def add_pool(self, spec: PoolSpec) -> PoolSpec:
        """Declare a pool (idempotent for an identical spec is NOT
        supported — one name, one spec).  Validates the spec against
        the facade's geometry, adopts any restored-but-undeclared
        entries waiting under this name, and nudges the worker so the
        initial fill starts immediately."""
        lam, nb = self._dcf.lam, self._dcf.n_bytes
        if spec.betas.shape[-1] != lam:
            raise ShapeError(
                f"pool {spec.name!r}: betas lam {spec.betas.shape[-1]} "
                f"!= facade lam {lam}")
        if spec.alphas is not None and spec.alphas.shape[1] != nb:
            raise ShapeError(
                f"pool {spec.name!r}: alphas domain "
                f"{spec.alphas.shape[1]}B != facade domain {nb}B")
        with self._lock:
            if spec.name in self._pools:
                # api-edge: pool-name uniqueness contract
                raise ValueError(
                    f"pool {spec.name!r} already declared")
            pool = _Pool(spec, self.metrics.gauge(labeled(
                "keyfactory_pool_depth", pool=spec.name)))
            adopted = self._orphans.pop(spec.name, [])
            for minted in adopted:
                if self._adoptable(spec, minted):
                    pool.entries.append(minted)
                    pool.seq = max(
                        pool.seq,
                        parse_pool_store_id(minted.pool_id)[1] + 1)
                else:
                    self._spent.append(minted.pool_id)
            if self._store is not None:
                # A fresh process refilling an existing store must not
                # reuse live pool seqs (overwriting an unclaimed frame
                # wastes supply, even though put_many stays consistent).
                prefix = POOL_NS + spec.name + "/"
                for key_id in self._store.key_ids():
                    parsed = parse_pool_store_id(key_id)
                    if key_id.startswith(prefix) and parsed is not None:
                        pool.seq = max(pool.seq, parsed[1] + 1)
            self._pools[spec.name] = pool
            pool.depth_gauge.set(len(pool.entries))
        self._wake.set()
        return spec

    @staticmethod
    def _adoptable(spec: PoolSpec, minted: _Minted) -> bool:
        """A restored frame must still match its pool's declared
        geometry (a respec'd pool cannot serve old-shape supply)."""
        kb = minted.bundle
        return (kb.num_keys == spec.keys_per_session
                and kb.lam == spec.betas.shape[-1]
                and (minted.protocol is not None) == bool(spec.intervals))

    def pool_names(self) -> list[str]:
        with self._lock:
            return sorted(self._pools)

    def depth(self, pool: str) -> int:
        with self._lock:
            return len(self._require(pool).entries)

    def pool_manifest(self, pool: str) -> dict:
        """``{pool_id: generation}`` of the current entries (tests pin
        restored generations with it)."""
        with self._lock:
            return {m.pool_id: m.generation
                    for m in self._require(pool).entries}

    def _require(self, pool: str) -> _Pool:
        p = self._pools.get(pool)
        if p is None:
            # api-edge: unknown-pool lookup contract at the serve edge
            raise ValueError(
                f"no key pool declared under {pool!r} "
                f"(declared: {sorted(self._pools)})")
        return p

    # -- claims -------------------------------------------------------------

    def claim(self, pool: str) -> _Minted:
        """A fresh session key from ``pool``: the pre-minted head entry
        (pool HIT — a pop, not a keygen) or, on exhaustion, a
        synchronous single-session mint on the caller's clock (pool
        MISS — counted and warned; the silent path must never be what
        serves).  Thread-safe."""
        with self._lock:
            p = self._require(pool)
            minted = p.entries.popleft() if p.entries else None
            if minted is not None:
                p.depth_gauge.set(len(p.entries))
                self._c_hits.inc()
                if self._store is not None:
                    self._spent.append(minted.pool_id)
            spec = p.spec
        if minted is not None:
            # EVERY claim with a store nudges the worker, not just
            # low-water ones: the spent frame's reclaim flip must run
            # within one worker tick, because until it does a crash
            # would resurrect the frame at restore — for a NON-durable
            # claim that is the residual reuse window (bounded at
            # ~refill_interval_s; see the claim-reclaim notes in the
            # module docstring).  Durable claims have no window at all
            # (the session publish drops the frame in the same flip).
            if self._store is not None:
                self._wake.set()
            return minted
        self._c_misses.inc()
        warnings.warn(
            BackendFallbackWarning(
                f"keyfactory-pool:{pool}", "synchronous keygen", None),
            stacklevel=3)
        minted = self._mint_sync(spec)
        self._wake.set()  # the pool is empty: refill now, not next tick
        return minted

    def _mint_sync(self, spec: PoolSpec) -> _Minted:
        """The pool-exhaustion fallback: ONE session minted through the
        refill's keygen route (``_keygen``), bit-exactly the key the
        pool would have handed out with the same seeds.  Never
        published (nothing was pooled) and never pooled (the caller
        takes it immediately).  Only the entropy draw holds the rng
        lock — concurrent misses must queue behind a seed spawn, not
        behind each other's full keygen walks (spawn derives a child
        from the full SeedSequence state, never a truncated seed: the
        draws are key material)."""
        from dcf_tpu_torch.gen import random_s0s

        with self._rng_lock:
            child = self._rng.spawn(1)[0]
        s0s = random_s0s(spec.keys_per_session, self._dcf.lam, child)
        kb, masks, planes = self._keygen(spec, 1, s0s)
        return _Minted(kb, _protocol(kb, masks, spec.bound), planes, "", 0)

    def _keygen(self, spec: PoolSpec, count: int, s0s: np.ndarray):
        """``count`` sessions of ``spec`` as ONE K-packed keygen call:
        ``gen.gen_on_device`` on the facade's device (kernel G1 at
        lam = 16, G2 at 32, B7a + W2 at lam >= 48; their plain versions
        on a ``device="cpu"`` facade), or the facade's host walk where
        the pool names it (``device=False``).  Returns the bundle, for a
        MIC pool each session's combine masks (else None), and, behind a
        lam >= 48 ``hybrid`` facade, both parties' narrow arrays on the
        device (else None)."""
        from dcf_tpu_torch.gen import gen_on_device, gen_on_device_with_planes
        from dcf_tpu_torch.protocols.keygen import interval_session_material

        if spec.intervals:
            # The ONE derivation gen_interval_bundle uses: pooled MIC
            # keys and the sync-mint fallback must share it, or the
            # combine convention could fork between hit and miss.
            alphas, session_betas, masks = interval_session_material(
                list(spec.intervals), spec.betas, self._dcf.n_bytes,
                spec.bound)
        else:
            alphas, session_betas, masks = spec.alphas, spec.betas, None
        al = np.tile(alphas, (count, 1))
        bt = np.tile(session_betas, (count, 1))
        planes = None
        if spec.device is False:
            kb = self._dcf.gen(al, bt, s0s=s0s, bound=spec.bound,
                               device=False)
        elif self._want_planes():
            kb, planes = gen_on_device_with_planes(
                self._dcf.lam, self._dcf.cipher_keys, al, bt, s0s,
                spec.bound, device=self._dcf.device)
        else:
            kb = gen_on_device(self._dcf.lam, self._dcf.cipher_keys, al, bt,
                               s0s, spec.bound, device=self._dcf.device)
        return kb, masks, planes

    def _want_planes(self) -> bool:
        """The staged-plane handoff applies where the serving facade
        stages the hybrid image (lam >= 48): the one backend that stages
        the keygen's narrow arrays as they are.  Not under a mesh
        (``dcf_tpu/serve/keyfactory.py:612-617``): the sharded hybrid
        stages from the host bundle."""
        return (self._dcf.backend_name == "hybrid"
                and getattr(self._dcf, "mesh", None) is None)

    # -- refill -------------------------------------------------------------

    def pump(self) -> RefillReport:
        """One refill sweep, inline: every pool below its low-water
        mark is topped up to ``target_depth`` (one batched mint per
        ``refill_batch`` sessions), CRITICAL pools first, BATCH pools
        skipped under service brownout.  The deterministic driving
        mode; the worker thread calls this after each wake.
        Serialized: concurrent sweeps would double-mint each pool's
        deficit."""
        with self._pump_lock:
            return self._pump_locked()

    def _pump_locked(self) -> RefillReport:
        report = RefillReport()
        brown = self._brownout()
        with self._lock:
            todo = sorted(self._pools.values(),
                          key=lambda p: (p.spec.priority,
                                         p.spec.name))
            todo = [(p, p.spec, len(p.entries)) for p in todo]
        for pool, spec, depth in todo:
            # Refill triggers when the pool is EMPTY or strictly below
            # its low-water mark, and tops up to target_depth — the
            # hysteresis band keeps steady-state claims from minting
            # one key at a time (low_water=0: only an empty pool
            # refills).
            if depth and depth >= spec.low_water:
                continue
            if brown and spec.priority is Priority.BATCH:
                report.skipped.append(spec.name)
                continue
            board_key = POOL_NS + spec.name
            if not self.breakers.allow(board_key, "keyfactory"):
                report.skipped.append(spec.name)
                continue
            minted_total = 0
            try:
                while True:
                    with self._lock:
                        want = spec.target_depth - len(pool.entries)
                    if want <= 0:
                        break
                    count = min(want, spec.refill_batch)
                    fire("keyfactory.refill", spec.name, count)
                    minted_total += self._refill_batch(pool, spec, count)
            except Exception as e:  # fallback-ok: a refill failure is
                # contained to this pool and this sweep — the worker
                # must survive, the breaker records it, and claims keep
                # serving from the remaining pool / the counted
                # synchronous fallback
                self._c_refill_failures.inc()
                self.breakers.record_failure(board_key, "keyfactory")
                report.failed[spec.name] = repr(e)
            else:
                if minted_total:
                    self.breakers.record_success(board_key, "keyfactory")
            finally:
                # A probe slot the gate sanctioned must never wedge
                # HALF_OPEN if the sweep resolved no outcome (want<=0).
                self.breakers.abort_probe(board_key, "keyfactory")
            if minted_total:
                report.minted[spec.name] = minted_total
        self._flush_spent()
        return report

    def _refill_batch(self, pool: _Pool, spec: PoolSpec,
                      count: int) -> int:
        """Mint + publish + pool ``count`` sessions as ONE K-packed
        keygen call and ONE manifest flip.  Entries become claimable
        only after the publish returns: publish-to-servable ordering."""
        from dcf_tpu_torch.gen import random_s0s

        ks = spec.keys_per_session
        with self._rng_lock:
            s0s = random_s0s(count * ks, self._dcf.lam, self._rng)
        kb_all, masks, planes = self._keygen(spec, count, s0s)
        self._c_minted.inc(count * ks)
        gens = self._registry.mint_generations(count)
        with self._lock:
            seq0 = pool.seq
            pool.seq += count
        entries = []
        for i in range(count):
            kb = _slice_keys(kb_all, i * ks, (i + 1) * ks)
            entry_planes = (None if planes is None else
                            _slice_planes_pair(planes, i * ks,
                                               (i + 1) * ks))
            entries.append(_Minted(kb, _protocol(kb, masks, spec.bound),
                                   entry_planes,
                                   pool_store_id(spec.name, seq0 + i),
                                   gens[i]))
        if self._store is not None:
            published = self._store.put_many(
                [(m.pool_id, m.bundle, m.protocol, m.generation)
                 for m in entries])
            self._c_published.inc(published)
        with self._lock:
            pool.entries.extend(entries)
            pool.depth_gauge.set(len(pool.entries))
        self._c_refills.inc()
        return count

    def reclaim_spent(self) -> None:
        """Flush the pending spent-frame reclaim now (ONE
        ``delete_many`` flip).  Normally rides each worker sweep;
        public so harnesses can separate the reclaim flip from the
        publish flip they are timing (``keyfactory_bench``)."""
        self._flush_spent()

    def _flush_spent(self) -> None:
        """Batched reclaim of claimed pool frames (ONE manifest flip).
        A failed flip re-queues the batch — the claimed ids must not be
        lost to a transient store failure, or the frames would sit in
        the manifest forever and resurrect at every restore."""
        if self._store is None:
            return
        with self._lock:
            spent, self._spent = self._spent, []
        if not spent:
            return
        try:
            self._c_reclaimed.inc(self._store.delete_many(spent))
        except Exception:  # fallback-ok: re-raised below — this handler
            # only re-queues the batch so a transient store failure
            # cannot lose the claimed ids (which would resurrect the
            # frames at every restore); it swallows nothing
            with self._lock:
                self._spent = spent + self._spent
            raise

    # -- warm restart -------------------------------------------------------

    def adopt_restored(self, report, registry) -> int:
        """Route restored ``~pool/...`` frames out of the serving
        registry and back into their pools, generations preserved
        — moving them from ``report.restored`` to
        ``report.repooled``.  Frames for pools not yet declared wait
        in an orphan stash that ``add_pool`` adopts (also reported
        repooled: they are factory-held supply).  Frames that no
        longer match their pool's declared geometry are RECLAIMED —
        reported in neither map, observable through the store's delete
        metrics (a respec'd pool cannot serve old-shape supply).
        Returns the number of entries re-pooled or stashed."""
        adopted = 0
        for key_id in sorted(report.restored):
            parsed = parse_pool_store_id(key_id)
            if parsed is None:
                continue
            name, seq = parsed
            generation = report.restored.pop(key_id)
            bundle, protocol, _gen = registry.snapshot(key_id)
            registry.unregister(key_id)  # pool supply is not servable
            minted = _Minted(bundle, protocol, None, key_id, generation)
            with self._lock:
                pool = self._pools.get(name)
                if pool is None:
                    self._orphans.setdefault(name, []).append(minted)
                elif self._adoptable(pool.spec, minted):
                    pool.entries.append(minted)
                    pool.seq = max(pool.seq, seq + 1)
                    pool.depth_gauge.set(len(pool.entries))
                else:
                    self._spent.append(key_id)
                    continue
            report.repooled[key_id] = generation
            adopted += 1
        if adopted:
            self._c_restored.inc(adopted)
        return adopted

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "KeyFactory":
        """Spawn the refill worker (idempotent and thread-safe — both
        ``DcfService.start`` and ``add_pool`` call this, and a racing
        pair must not spawn duplicate workers; a factory with no pools
        idles on the interval backstop until one is declared)."""
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._closed = False
                self._worker = threading.Thread(
                    target=self._worker_loop, name="dcf-keyfactory",
                    daemon=True)
                self._worker.start()
        return self

    def _worker_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self.refill_interval_s)
            self._wake.clear()
            if self._closed:
                return
            try:
                self.pump()
            except Exception:  # fallback-ok: the refill worker must
                # outlive ANY sweep failure (pump already contains
                # per-pool failures; this is the belt for e.g. a dying
                # store's reclaim flip) — COUNTED, never silent, and
                # the next tick retries
                self._c_worker_errors.inc()

    def close(self) -> None:
        """Stop the worker and flush the pending spent-frame reclaim."""
        self._closed = True
        self._wake.set()
        worker = self._worker
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            worker.join()
        self._flush_spent()


def _protocol(kb: KeyBundle, masks, bound: Bound):
    """A MIC session's ``ProtocolBundle`` over ``kb``; None for plain
    DCF (``masks`` None)."""
    if masks is None:
        return None
    from dcf_tpu_torch.protocols.keygen import ProtocolBundle

    return ProtocolBundle(keys=kb, combine_masks=masks, bound=bound)


def _slice_keys(kb: KeyBundle, lo: int, hi: int) -> KeyBundle:
    """Rows ``[lo, hi)`` of a K-packed bundle as an independent bundle
    (copies — a pool entry must not pin the whole refill batch's
    arrays alive)."""
    return KeyBundle(
        s0s=kb.s0s[lo:hi].copy(), cw_s=kb.cw_s[lo:hi].copy(),
        cw_v=kb.cw_v[lo:hi].copy(), cw_t=kb.cw_t[lo:hi].copy(),
        cw_np1=kb.cw_np1[lo:hi].copy())


def _slice_planes_pair(planes: dict, lo: int, hi: int) -> dict:
    """Rows ``[lo, hi)`` of a both-parties plane pair (every array is
    key-major), as copies: a pool entry must not pin the whole refill
    batch's device arrays alive.  ``gen_with_planes_pair`` shares the
    correction-word arrays between the two party dicts BY IDENTITY; the
    slice keeps that sharing (detected by identity), so an entry holds
    one copy of them, not one a party."""
    shared = {name: arr[lo:hi].clone() for name, arr in planes[0].items()
              if planes[1].get(name) is arr}
    return {b: {name: (shared[name] if name in shared
                       else arr[lo:hi].clone())
                for name, arr in planes[b].items()}
            for b in planes}
