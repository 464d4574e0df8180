"""DcfService: the online evaluator over the staged backends.

Counterpart of ``dcf_tpu/serve/service.py``, with the same knobs,
metric names, error types and messages, so a caller switches packages
with its imports alone.  It runs on the facade's device: the residencies
are the port's backend instances, their kernels launch from whichever
thread runs the batch (the worker under ``start()``, the caller under
``pump()``), on that thread's current CUDA stream.  Two behaviours
differ from ``dcf_tpu``'s, because the port's facade has no fallback
chain:

* a retry never demotes.  Its last attempt drops this service's cached
  residencies and frontiers and the facade's backend slots, and
  re-stages on a fresh instance of the same backend; a device path that keeps
  failing fails the future with its typed cause.  The host path
  (``registry.resident`` returning None) is taken only by a facade built
  with ``backend="numpy"`` or ``"cpu"``;
* the key factory's staged-plane handoff is not carried (see
  ``serve.keyfactory``).

Turns a constructed ``Dcf`` facade into a service: callers ``submit``
``(key_id, xs)`` requests from any thread and get a ``ServeFuture``;
a worker coalesces requests into padded power-of-two device batches
(``serve.batcher``), keeps hot key images device-resident
(``serve.registry``), sheds overload at admission (``serve.admission``),
and reports itself through a deterministic metrics surface
(``serve.metrics``).

Load-bearing knobs (``ServeConfig``):

* ``max_batch`` — device batch cap in points, power of two.  The
  throughput knob: batches amortize the per-dispatch overhead, and every
  padded batch shape <= max_batch is one of log2(max_batch) compiled
  programs.  Raise it until eval latency, not dispatch overhead,
  dominates.
* ``max_delay_ms`` — the latency knob: how long an accepted request may
  wait for co-batching before the worker dispatches whatever is queued.
  The classic micro-batching latency/occupancy trade.
* ``device_bytes_budget`` — LRU bound on summed resident key images
  (0 = uncapped).  The working-set knob: more resident keys means fewer
  re-stagings; the budget is what stops a long tail of cold keys from
  evicting the hot set.  With ``frontier_cache`` on, serve-cached
  prefix frontiers share this budget (one merged LRU — see
  ``serve.frontier_cache``).
* ``frontier_cache`` — keep prefix-family frontier expansions in a
  serve-resident LRU (``serve.frontier_cache.FrontierCache``) keyed by
  (key_id, generation, party, k) instead of per backend instance, so a
  hot key's expanded top-k walk levels survive residency churn and
  re-staged instances skip the 2^k-node expansion entirely
  (``serve_frontier_hits_total`` / ``_misses_total`` /
  ``serve_frontier_cache_bytes`` in the snapshot).  Default on; only
  consulted by frontier-capable backends (``prefix``, ``hybrid`` with
  ``prefix_levels``) — everything else ignores it.  ``False`` restores
  the instance-store behavior (the cold leg of ``dcf_tpu``'s
  ``serve_bench --skew`` and of ``chip_smoke.py`` phase 20's churn).
* ``max_queued_points`` — admission bound; beyond it, submits shed with
  ``QueueFullError`` (see ``serve.admission``).
* ``retries`` — per-batch retries after a backend failure; each retry
  first runs an invalidation path, so the retry re-stages on a fresh
  backend instance instead of re-entering the dead one (the same
  backend: the port never demotes).
* ``breaker_failures`` / ``breaker_cooldown_s`` — the per-(key_id,
  backend-family) circuit breaker (``serve.breaker``): after
  ``breaker_failures`` consecutive failed ATTEMPTS (each failing
  dispatch and each failing retry records one — a batch failing
  outright with ``retries=1`` records two) the pairing opens and
  non-CRITICAL groups fail fast with ``CircuitOpenError`` instead of
  burning retries against a backend known to be dying; after the
  cooldown one probe half-opens it.  ``breaker_failures=0`` disables
  breakers entirely.
* ``brownout_queue_fraction`` / ``brownout_after_s`` /
  ``brownout_clear_s`` — the brownout controller: queue points above
  the fraction of ``max_queued_points`` for ``brownout_after_s``
  (or ANY open breaker, immediately) enters brownout — BATCH-class
  submits are refused at the door (``serve_brownout`` gauge = 1) —
  and ``brownout_clear_s`` of calm exits it (hysteresis: entry and
  exit are separated so a queue oscillating around the threshold does
  not flap the gate).
* ``store_dir`` — durable key store: a
  directory holding DCFK frames published write-fsync-rename under a
  CRC'd manifest.  ``register_key(..., durable=True)`` writes through
  BEFORE acking; after a crash, ``restore_keys()`` re-registers every
  durable key with its generation preserved (zero re-keygen — the
  offline phase is the expensive one) and quarantines damaged frames
  typed (``KeyQuarantinedError``) without failing the rest.  Empty
  (the default) = no store; ``durable=True`` then fails loudly.
* ``batch_timeout_s`` — the hung-batch watchdog: a wall deadline (on
  the injectable clock) each dispatched batch must complete within.
  An overdue batch fails typed (``BatchTimeoutError``), records a
  breaker outcome against (key, the facade's backend), and takes the
  same retry/invalidation path a plain batch failure takes — so a
  backend that wedges instead of crashing still re-stages and still
  stops stalling the worker while the queue sheds behind it.  0 (the
  default) disables the watchdog.
* ``keyfactory_refill_interval_s`` — the key factory's worker-poll
  backstop: pools are refilled
  immediately when a claim drops them below their low-water mark (the
  claim nudges the worker), and at worst every this-many seconds.
  Declare pools with ``add_pool(PoolSpec(...))`` and mint fresh
  session keys with ``register_key(key_id, pool=...)`` — registration
  then costs a pool pop, not an n-level GGM keygen walk.
* ``tenants`` / ``tls_cert`` / ``tls_key`` / ``tls_client_ca`` — the
  network edge's tenant table (``admission.TenantSpec``) and TLS
  material, validated here as in ``dcf_tpu``.  Only the network edge
  (``serve.edge.EdgeServer``) consults them; in-process submits are
  unaffected.

Pipelining: within a batch run, host->device staging of batch N+1
can overlap the (async) device eval of batch N — the worker dispatches
batch N, stages and dispatches N+1, and only then fetches N.  On the
card ``eval_staged`` returns before the kernels finish and
``staged_to_bytes`` waits for them; the staging copy from pageable host
memory blocks the host, so how much of it overlaps is measured
(``serve_stage_s`` / ``serve_eval_s``), not assumed.

Failure injection: the ``serve.stage`` / ``serve.eval`` seams
(``dcf_tpu_torch.testing.faults``) fire at the exact points where a real
staging or dispatch failure would surface, so overload, mid-batch
backend death, and the retry/invalidation path are all deterministically
testable without breaking a real device.

Clocking: all waiting/deadline math uses the injectable ``clock``
(``utils.benchtime.monotonic`` by default) — never ``time.*`` directly,
so deterministic tests drive the service with a fake clock via
``pump()``.
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass

import numpy as np

from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    BatchTimeoutError,
    CircuitOpenError,
    DeadlineExceededError,
    RingEpochError,
    ShapeError,
)
from dcf_tpu_torch.protocols import ProtocolBundle
from dcf_tpu_torch.spec import ReferenceContractWarning
from dcf_tpu_torch.protocols.combine import (
    combine_pair_shares,
    staged_pair_combine,
)
from dcf_tpu_torch.utils.groups import np_group_add
from dcf_tpu_torch.serve.admission import (
    AdmissionQueue,
    Priority,
    Request,
    ServeFuture,
    TenantSpec,
    expire,
    parse_priority,
)
from dcf_tpu_torch.serve.breaker import BreakerBoard
from dcf_tpu_torch.serve.batcher import (
    BatchPlan,
    gather_batch,
    ingest_points,
    plan_batches,
    scatter_batch,
)
from dcf_tpu_torch.serve.frontier_cache import FrontierCache
from dcf_tpu_torch.serve.keyfactory import KeyFactory, PoolSpec
from dcf_tpu_torch.serve.metrics import Metrics, OCCUPANCY_BOUNDS
from dcf_tpu_torch.serve.registry import KeyRegistry
from dcf_tpu_torch.serve import replicate
from dcf_tpu_torch.serve.store import KeyStore
from dcf_tpu_torch.testing.faults import fire
from dcf_tpu_torch.utils.benchtime import monotonic

__all__ = ["ServeConfig", "DcfService"]


@dataclass(frozen=True)
class ServeConfig:
    """Serving policy; see the module docstring for which knobs are
    load-bearing and in which direction."""

    max_batch: int = 4096
    max_delay_ms: float = 2.0
    max_queued_points: int = 1 << 20
    device_bytes_budget: int = 0
    frontier_cache: bool = True
    retries: int = 1
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0
    brownout_queue_fraction: float = 0.75
    brownout_after_s: float = 0.5
    brownout_clear_s: float = 1.0
    store_dir: str = ""
    batch_timeout_s: float = 0.0
    keyfactory_refill_interval_s: float = 0.05
    tenants: tuple = ()
    tls_cert: str = ""
    tls_key: str = ""
    tls_client_ca: str = ""

    def __post_init__(self):
        # TLS on the edge socket: cert+key arm
        # the EdgeServer's ssl context; tls_client_ca pins clients
        # (router<->shard links).  Validated here so a half-configured
        # keypair dies at config time, not when the first EdgeServer
        # is constructed.
        if bool(self.tls_cert) != bool(self.tls_key):
            # api-edge: config contract — half a keypair serves nothing
            raise ValueError(
                "TLS needs BOTH tls_cert and tls_key (got only one)")
        if self.tls_client_ca and not self.tls_cert:
            # api-edge: config contract — client pinning needs a
            # server identity
            raise ValueError("tls_client_ca requires tls_cert/tls_key")
        for t in self.tenants:
            if not isinstance(t, TenantSpec):
                # api-edge: config contract — the tenant table is the
                # edge's admission policy; a loose dict would let a
                # typo'd field silently disable a tenant's rate limit
                raise ValueError(
                    f"tenants entries must be serve.TenantSpec, got "
                    f"{type(t).__name__}")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            # api-edge: config contract — two specs for one tenant
            # would make the effective class/rate order-dependent
            raise ValueError(f"duplicate tenant names in {names}")
        if self.max_batch < 1 or self.max_batch & (self.max_batch - 1):
            raise ShapeError(
                f"max_batch must be a power of two >= 1, "
                f"got {self.max_batch}")
        if self.max_delay_ms < 0:
            # api-edge: config contract
            raise ValueError("max_delay_ms must be >= 0")
        if self.retries < 0:
            # api-edge: config contract
            raise ValueError("retries must be >= 0")
        if self.max_queued_points < 1:
            # api-edge: config contract (AdmissionQueue enforces the
            # same bound; failing here names the config field instead)
            raise ValueError(
                f"max_queued_points must be >= 1, "
                f"got {self.max_queued_points}")
        if self.device_bytes_budget < 0:
            # api-edge: config contract — a negative budget would read
            # as "always over budget" and silently evict everything
            raise ValueError(
                "device_bytes_budget must be >= 0 (0 = uncapped)")
        if self.breaker_failures < 0:
            # api-edge: config contract (0 disables the breakers)
            raise ValueError("breaker_failures must be >= 0")
        if self.breaker_cooldown_s < 0:
            # api-edge: config contract
            raise ValueError("breaker_cooldown_s must be >= 0")
        if not 0 < self.brownout_queue_fraction <= 1:
            # api-edge: config contract — 0 would make brownout
            # permanent, > 1 unreachable
            raise ValueError(
                "brownout_queue_fraction must be in (0, 1]")
        if self.brownout_after_s < 0 or self.brownout_clear_s < 0:
            # api-edge: config contract
            raise ValueError(
                "brownout_after_s/brownout_clear_s must be >= 0")
        if self.batch_timeout_s < 0:
            # api-edge: config contract (0 disables the watchdog)
            raise ValueError(
                f"batch_timeout_s must be >= 0, got {self.batch_timeout_s}")
        if self.keyfactory_refill_interval_s <= 0:
            # api-edge: config contract (the worker needs a finite,
            # positive poll backstop)
            raise ValueError(
                "keyfactory_refill_interval_s must be > 0, got "
                f"{self.keyfactory_refill_interval_s}")


class _Batch:
    """One in-flight batch: its plan, how to fetch its bytes, and when
    it dispatched."""

    __slots__ = ("plan", "fetch", "t0")

    def __init__(self, plan: BatchPlan, fetch, t0: float):
        self.plan = plan
        self.fetch = fetch
        self.t0 = t0


class DcfService:
    """Online DCF evaluation service over a ``Dcf`` facade.

    Construct via ``Dcf.serve(...)``.  Two driving modes:

    * ``start()`` spawns the worker thread (production / load tests);
      ``close(drain=True)`` stops admission, serves what is queued, and
      joins the worker.  The service is also a context manager.
    * ``pump()`` serves everything currently queued inline on the
      calling thread — the deterministic mode unit tests drive with a
      fake clock (no thread, no real time).
    """

    def __init__(self, dcf, config: ServeConfig | None = None, *,
                 metrics: Metrics | None = None, clock=monotonic):
        from dcf_tpu_torch import api  # facade <-> serve wiring

        self._dcf = dcf
        self.config = config if config is not None else ServeConfig()
        self.metrics = metrics if metrics is not None else Metrics()
        self._clock = clock
        self.breakers = BreakerBoard(
            failures_to_open=max(self.config.breaker_failures, 1),
            cooldown_s=self.config.breaker_cooldown_s,
            metrics=self.metrics, clock=clock)
        self._breaker_enabled = self.config.breaker_failures > 0
        # Serve-resident frontier cache: prefix-family
        # frontier expansions keyed (key_id, generation, party, k),
        # sharing the registry's byte budget and LRU stamp sequence.
        self.frontier_cache = (FrontierCache(metrics=self.metrics)
                               if self.config.frontier_cache else None)
        self.registry = KeyRegistry(
            dcf.new_eval_backend,
            shared_image=dcf.backend_name == "keylanes",
            device_bytes_budget=self.config.device_bytes_budget,
            metrics=self.metrics, breakers=self.breakers,
            frontier_cache=self.frontier_cache)
        # Retry-after hints: overload sheds advise ~two
        # coalescing windows (the soonest a drained batch could have
        # made room — a heuristic, disclosed as such); brownout
        # refusals advise brownout_clear_s (the calm the hysteresis
        # controller needs before BATCH re-admits — the principled
        # lower bound on "when could this possibly succeed").
        self.queue = AdmissionQueue(
            self.config.max_queued_points, metrics=self.metrics,
            shed_retry_after_s=2 * self.config.max_delay_ms / 1e3,
            brownout_retry_after_s=self.config.brownout_clear_s)
        # Durable key store: the write-through target of
        # register_key(durable=True) and the source restore_keys()
        # re-registers from after a crash.
        self.store = (KeyStore(self.config.store_dir,
                               metrics=self.metrics)
                      if self.config.store_dir else None)
        if self.store is not None:
            # Floor the registry's generation counter on the store's
            # highest persisted generation BEFORE anything registers:
            # a fresh process on an existing store must never mint a
            # generation the manifest already records (the store's
            # monotonic put guard would silently drop that durable
            # write-through), and restore() preserving generations
            # stays exact either way.
            self.registry.sync_generation_floor(
                self.store.max_generation())
        # The key factory: ahead-of-demand keygen pools.
        # Inert until a pool is declared (``add_pool``); its refill
        # breakers live on its OWN board, so a dying keygen pipeline
        # never counts as serving-brownout pressure.  breaker_failures=0
        # disables only the SERVING breakers — refills keep the default
        # threshold (there is no un-gated mode for a background minter).
        self.keyfactory = KeyFactory(
            dcf, registry=self.registry, store=self.store,
            metrics=self.metrics, clock=clock,
            brownout=lambda: self.queue.brownout,
            refill_interval_s=self.config.keyfactory_refill_interval_s,
            breaker_failures=self.config.breaker_failures or 3,
            breaker_cooldown_s=self.config.breaker_cooldown_s)
        self._worker: threading.Thread | None = None
        self._pump_lock = threading.Lock()  # one batch runner at a time
        self._pump_owner: int | None = None  # thread id holding the lock
        # Brownout controller state (hysteresis timestamps on the
        # injectable clock; None = the condition is not currently held).
        # Guarded by _brownout_lock: _update_brownout runs on EVERY
        # submit (documented thread-safe) as well as in the pump, so
        # the check-then-subtract on these Optionals must be atomic.
        self._brownout_lock = threading.Lock()
        self._pressure_since: float | None = None
        self._calm_since: float | None = None
        # Ring-epoch fence state: the highest membership epoch this
        # shard has observed on a fenced frame; frames carrying an
        # older one are refused typed (check_ring_epoch).
        self._epoch_lock = threading.Lock()
        self._ring_epoch = 0
        # PIR answering context: None until
        # attach_pir; guarded-by: _pir_lock (the PirServer's selection
        # cache and evaluator residency are not themselves locked, and
        # edge reader threads submit concurrently).
        self._pir_lock = threading.Lock()
        self._pir = None
        m = self.metrics
        self._c_batches = m.counter("serve_batches_total")
        self._c_retries = m.counter("serve_retries_total")
        self._c_failures = m.counter("serve_batch_failures_total")
        self._c_breaker_fastfail = m.counter(
            "serve_breaker_fast_fails_total")
        self._c_batch_timeouts = m.counter("serve_batch_timeouts_total")
        self._c_deadline = m.counter("serve_deadline_expired_total")
        self._c_pir = m.counter("serve_pir_answers_total")
        self._c_epoch_fenced = m.counter("serve_epoch_fenced_total")
        self._g_ring_epoch = m.gauge("serve_ring_epoch")
        self._h_occupancy = m.histogram("serve_batch_occupancy",
                                        OCCUPANCY_BOUNDS)
        self._h_stage = m.histogram("serve_stage_s")
        self._h_eval = m.histogram("serve_eval_s")
        self._h_wait = m.histogram("serve_queue_wait_s")
        # The shared invalidation path: reset_backend_health() (module or
        # facade method) must evict this service's staged images too, so
        # a backend declared dead mid-serve cannot serve from cache.
        api.register_reset_listener(self)

    # -- invalidation -------------------------------------------------------

    def _on_backend_health_reset(self) -> None:
        self.registry.evict_all()
        if self.frontier_cache is not None:
            # evict_all already invalidated per registered key; this
            # sweeps anything else and bumps the cache epoch, so an
            # in-flight build that started before the reset cannot
            # persist its result — dead-backend state must not survive
            # the shared reset path anywhere.
            self.frontier_cache.invalidate_all()

    # -- key management -----------------------------------------------------

    def add_pool(self, spec: PoolSpec) -> PoolSpec:
        """Declare a key-factory pool
        and start the refill worker if this service's worker is already
        running — fresh session keys then register via
        ``register_key(key_id, pool=spec.name)`` at pool-pop latency."""
        spec = self.keyfactory.add_pool(spec)
        if self._worker is not None and self._worker.is_alive():
            self.keyfactory.start()
        return spec

    def register_key(self, key_id: str, bundle=None,
                     durable: bool = False, *, pool: str | None = None):
        """Register (or hot-swap) the two-party bundle ``key_id`` serves.
        Swapping evicts the old device residencies atomically.  Returns
        the registered bundle (the ``ProtocolBundle`` for protocol
        keys).

        ``pool``: mint a FRESH session
        key from the named key-factory pool instead of accepting a
        caller-generated bundle — the ahead-of-demand path.  A pool hit
        registers a pre-minted bundle (registration latency is a pool
        pop plus this method's bookkeeping, not a keygen walk).  Pool
        exhaustion falls back to a SYNCHRONOUS mint on the refill's
        keygen route (the facade's device) on this call's clock — counted
        (``keyfactory_pool_misses_total``) and warned
        (``BackendFallbackWarning``), bit-exact in every observable
        (same function, fresh seeds), never silent.  The returned
        bundle is the dealer's copy: ship ``for_party(b)`` shares to
        the session's parties.

        ``bundle`` may be a plain ``KeyBundle`` OR a
        ``protocols.ProtocolBundle``: protocol keys serve MIC/
        IC/piecewise queries — the device ships the inner 2m-key image
        exactly like a plain key, and the service applies the
        per-interval share combine (+ the party's public-correction
        mask) when it fetches each batch, under the same admission/
        deadline/retry semantics.  Futures for a protocol key resolve
        to uint8 [m, M, lam] (per-interval shares) instead of
        [K, M, lam].

        Device-GENERATED bundles (``gen.gen_on_device`` /
        ``Dcf.gen(..., device=True)``) register exactly like
        host-generated ones: the pipelines are pinned byte-identical,
        so the registry, the staging backends and the durable store
        codecs see the same DCFK bytes either way — a keygen pipeline
        choice can never invalidate a stored frame.

        ``durable=True``: the frame is
        written through to the durable store — atomic
        write-fsync-rename under the key's registry generation —
        BEFORE this call returns, so an acked durable registration
        survives a crash and ``restore_keys()`` brings it back with
        zero re-keygen.  If the persist raises (disk fault), the key
        IS live in the registry but NOT durable — the caller must
        treat the exception as "not persisted" and retry or
        re-register.  Hot-swapping a durable key with ``durable=False``
        deliberately leaves the previous durable snapshot in the store
        (durability is opt-in per write; a crash then restores the
        last DURABLE generation)."""
        dev_planes = None
        claimed_pool_id = ""
        if bundle is None:
            if pool is None:
                # api-edge: registration contract — either a bundle or
                # a pool to mint from, never neither
                raise ValueError(
                    f"register_key({key_id!r}) needs a bundle or a "
                    "pool= to mint a fresh session key from")
            minted = self.keyfactory.claim(pool)
            bundle = (minted.protocol if minted.protocol is not None
                      else minted.bundle)
            dev_planes = minted.planes
            claimed_pool_id = minted.pool_id  # "" for fallback mints
        elif pool is not None:
            # api-edge: registration contract (an explicit bundle and a
            # pool mint are different provenances; passing both hides
            # which one actually serves)
            raise ValueError(
                f"register_key({key_id!r}): pass a bundle OR pool=, "
                "not both")
        registered = bundle
        protocol = None
        if isinstance(bundle, ProtocolBundle):
            protocol, bundle = bundle, bundle.keys
        if bundle.lam != self._dcf.lam:
            raise ShapeError(
                f"bundle lam {bundle.lam} != service lam {self._dcf.lam}")
        if bundle.n_bits != 8 * self._dcf.n_bytes:
            raise ShapeError(
                f"bundle domain {bundle.n_bits} bits != service domain "
                f"{8 * self._dcf.n_bytes} bits")
        if durable and self.store is None:
            # api-edge: config contract — silently accepting a durable
            # registration with nowhere to persist it would be exactly
            # the data loss the flag exists to prevent
            raise ValueError(
                f"register_key({key_id!r}, durable=True) needs a "
                "configured store (ServeConfig.store_dir)")
        generation = self.registry.register(key_id, bundle,
                                            protocol=protocol,
                                            dev_planes=dev_planes)
        if durable:
            # A durable POOL claim folds the spent ~pool/ frame's
            # delete into the same manifest flip that publishes the
            # session frame: no crash window may leave both visible,
            # or a restore would re-pool key material a restored
            # session key already serves (cross-session reuse).  The
            # factory's lazy batched reclaim then finds the id gone —
            # a no-op.
            self.store.put(key_id, bundle, protocol=protocol,
                           generation=generation,
                           drop=(claimed_pool_id,) if claimed_pool_id
                           else ())
        return registered

    def unregister_key(self, key_id: str) -> None:
        """Forget ``key_id`` entirely: registry entry, residencies,
        breaker history — and its durable frame, when a store is
        configured (the name ceased to exist; restoring it after this
        would resurrect a key the operator deleted)."""
        self.registry.unregister(key_id)
        if self.store is not None:
            self.store.delete(key_id)

    def restore_keys(self):
        """Warm restart: re-register every key the durable
        store holds, preserving generations (zero re-keygen; damaged
        frames quarantined typed, never fatal to the rest — see
        ``KeyRegistry.restore``).  Restored ``~pool/...`` frames route
        back into their key-factory pools instead of the serving
        registry — the report moves them from ``restored``
        to ``repooled``, generations preserved.  Returns the
        ``RestoreReport``."""
        if self.store is None:
            # api-edge: config contract (restore needs a store)
            raise ValueError(
                "restore_keys() needs a configured store "
                "(ServeConfig.store_dir)")
        report = self.registry.restore(self.store)
        self.keyfactory.adopt_restored(report, self.registry)
        return report

    def key_ids(self) -> list[str]:
        return self.registry.key_ids()

    # -- replication surface ----------------

    def register_frame(self, key_id: str, frame,
                       proto: bool = False) -> int:
        """Register one DCFK frame off the wire (the OWNER half of the
        DCFE REGISTER verb): decode through the existing codec, mint a
        fresh generation, return it — the router forwards it to the
        replicas with this generation preserved.  Live (non-durable)
        by design: ``KeyStore.replicate_to`` is the durable twin."""
        obj = replicate.decode_key_frame(frame, proto)
        self.register_key(key_id, obj)
        return self.registry.snapshot(key_id)[2]

    def apply_replica_frame(self, key_id: str, frame, generation: int,
                            proto: bool = False) -> int:
        """Apply one forwarded frame under the owner's generation (the
        REPLICA half of REGISTER, and the anti-entropy apply).  The
        monotonic-generation fence refuses a frame at or below the
        local generation typed ``StaleStateError``
        (``serve_replica_fenced_total``) — an old partition side can
        never roll this key back."""
        return replicate.apply_frame(
            self.registry, key_id, frame, int(generation),
            bool(proto), lam=self._dcf.lam,
            n_bytes=self._dcf.n_bytes, metrics=self.metrics)

    def replication_digest(self) -> dict:
        """The live ``{key_id: generation}`` map (anti-entropy digest
        exchange — generations only, no key material)."""
        return self.registry.digest()

    def sync_frames(self, digest: dict) -> list:
        """Frames STRICTLY newer than ``digest`` records, for the
        anti-entropy pull (``serve.replicate.sync_frames``)."""
        return replicate.sync_frames(self.registry, digest)

    # -- ring-epoch fence -----------------------------------------------------

    @property
    def ring_epoch(self) -> int:
        """The highest ring epoch this shard has observed (0 = never
        fenced — a solo service, or one no router with an epoch has
        reached)."""
        return self._ring_epoch

    def check_ring_epoch(self, epoch: int, adopt: bool = True) -> int:
        """Adopt-or-refuse one fenced frame's ring epoch (the edge's
        REQUEST, PING and REGISTER handlers call it).

        Monotonic-max adoption, the generation fence's discipline
        lifted to membership: a NEWER epoch is adopted (the first
        fenced frame after a membership commit teaches this shard the
        new epoch — probes disseminate it within about one interval),
        an EQUAL one passes, and an OLDER one is refused typed
        ``RingEpochError`` (``E_EPOCH`` on the wire, counted
        ``serve_epoch_fenced_total``) — a router still routing on a
        pre-change ring is structurally unable to serve or register
        against a conflicting placement.  Epoch 0 (unfenced) is a
        no-op pass.  Returns the current epoch.

        ``adopt=False`` runs the refuse-if-older half WITHOUT raising
        the observed maximum: the edge's REQUEST path checks the fence
        before tenant admission (a stale router must not burn a token
        on a structurally-refused forward) but must not let an
        UNADMITTED sender teach this shard an arbitrary epoch — one
        forged frame with a huge epoch would otherwise fence out the
        real router (adoption happens post-admission; PING/REGISTER
        stay adopt-on-sight — they are router/operator verbs under the
        TLS client-pinning trust story, not the tenant table)."""
        epoch = int(epoch)
        if epoch <= 0:
            return self._ring_epoch
        with self._epoch_lock:
            if epoch > self._ring_epoch:
                if adopt:
                    self._ring_epoch = epoch
                    self._g_ring_epoch.set(epoch)
            elif epoch < self._ring_epoch:
                self._c_epoch_fenced.inc()
                raise RingEpochError(
                    f"frame carries ring epoch {epoch} but this shard "
                    f"has observed epoch {self._ring_epoch}: the "
                    "sender's membership view is stale — refresh the "
                    "ring before retrying",
                    retry_after_s=1.0)
            return self._ring_epoch

    # -- submission ---------------------------------------------------------

    @property
    def n_bytes(self) -> int:
        """The service's packed point width in bytes — the one shape
        fact every submit target shares (``EdgeClient`` carries it,
        the pod router carries its own), so the edge, the loadgen and
        the router read it without reaching into the facade."""
        return self._dcf.n_bytes

    def submit(self, key_id: str, xs: np.ndarray, b: int = 0,
               deadline_ms: float | None = None,
               priority: Priority | str = Priority.NORMAL) -> ServeFuture:
        """Submit points for one registered key, party ``b``.

        ``xs``: uint8 [M, n_bytes], M >= 1.  ``deadline_ms`` bounds the
        time the request may spend QUEUED; expiry completes the future
        with ``DeadlineExceededError``.  ``priority`` — CRITICAL /
        NORMAL (default) / BATCH — decides who is shed under overload
        and brownout, never dispatch order (``serve.admission``).
        Raises ``QueueFullError`` when shed.  Thread-safe.

        Normalizes ``xs`` and routes through :meth:`submit_bytes` —
        the batcher has exactly ONE feed (``batcher.ingest_points``),
        shared with the network edge's wire path."""
        xs = np.ascontiguousarray(np.asarray(xs, dtype=np.uint8))
        if xs.ndim != 2 or xs.shape[1] != self._dcf.n_bytes:
            raise ShapeError(
                f"xs must be [M, {self._dcf.n_bytes}], got {xs.shape}")
        if xs.shape[0] < 1:
            raise ShapeError("cannot submit an empty request")
        return self.submit_bytes(key_id, xs.data, b=b,
                                 deadline_ms=deadline_ms,
                                 priority=priority)

    def submit_bytes(self, key_id: str, data, b: int = 0,
                     deadline_ms: float | None = None,
                     priority: Priority | str = Priority.NORMAL
                     ) -> ServeFuture:
        """Submit packed point BYTES for one registered key.

        ``data``: any buffer-protocol object holding M >= 1 points of
        ``n_bytes`` each, back to back — the network edge hands the
        received frame's payload ``memoryview`` straight here, and
        ``submit`` hands its normalized ndarray's buffer, so EVERY
        request reaches the batcher through ``batcher.ingest_points``
        (zero copies, zero per-point Python objects; the first copy of
        wire bytes is the span gather into the padded device batch).
        The caller must not mutate ``data`` until the future completes.
        Same admission/deadline/priority semantics as ``submit``."""
        if b not in (0, 1):
            # api-edge: party index contract at the serve edge
            raise ValueError(f"party b must be 0 or 1, got {b}")
        priority = parse_priority(priority)
        xs = ingest_points(data, self._dcf.n_bytes)
        from dcf_tpu_torch.protocols.dpf import DpfBundle

        bundle = self.registry.bundle(key_id)  # unknown fails at submit
        if isinstance(bundle, DpfBundle):
            # A DPF registration is a PIR query: the KEY is the query
            # (full-domain EvalAll + database inner product), so the
            # request's points are a wire-contract placeholder — the
            # DCFE REQUEST frame needs M >= 1 — and the answer is
            # computed here, not batched (a PIR answer has no point
            # batch to coalesce with; PirServer carries its own
            # serve.eval retry-then-evict discipline).  Same wire both
            # ways: the [K, record_bytes] answer shares ride the SHARE
            # frame as [k=K, m=1, lam=record_bytes].
            return self._submit_pir(key_id, b)
        now = self._clock()
        self._update_brownout(now)  # the gate reflects current pressure
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        req = Request(key_id, b, xs, deadline, now, priority)
        self.queue.put(req)  # sheds with QueueFullError on overload
        return req.future

    def evaluate(self, key_id: str, xs: np.ndarray, b: int = 0,
                 deadline_ms: float | None = None,
                 timeout: float | None = None,
                 priority: Priority | str = Priority.NORMAL) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(key_id, xs, b, deadline_ms,
                           priority).result(timeout)

    # -- PIR -------------------------------------------

    def attach_pir(self, db, evaluator=None, *,
                   retries: int | None = None):
        """Attach a 2-server-PIR answering context to this service.

        ``db``: a ``workloads.pir.PirDatabase``.  ``evaluator``: a
        ``backends.evalall.DpfEvalAll`` (defaults to one built from the
        facade's lam, cipher keys and device: kernels B6 + P1 on the
        card, their plain versions on a ``device="cpu"`` facade).  After
        attaching, a request submitted against a registered
        ``DpfBundle`` answers as a PIR query instead of a point batch.
        ``retries`` defaults to the service's per-batch retry budget.
        Returns the ``PirServer`` (its ``eval_faults`` counter is the
        fault-soak observable)."""
        from dcf_tpu_torch.backends.evalall import DpfEvalAll
        from dcf_tpu_torch.workloads.pir import PirServer

        if evaluator is None:
            with warnings.catch_warnings():  # the facade warned already
                warnings.simplefilter("ignore", ReferenceContractWarning)
                evaluator = DpfEvalAll(
                    self._dcf.lam, self._dcf.cipher_keys,
                    device=self._dcf.device)
        with self._pir_lock:
            self._pir = PirServer(
                evaluator, db, self.registry,
                retries=self.config.retries if retries is None
                else retries)
        return self._pir

    def _submit_pir(self, key_id: str, b: int) -> ServeFuture:
        """One PIR answer as a completed ``ServeFuture`` (see
        ``submit_bytes``: the key is the query, so there is nothing to
        queue — the EvalAll + inner product run at submit, under the
        PirServer's own retry-then-evict discipline)."""
        if self._pir is None:
            # api-edge: documented serving contract — a DPF key is
            # servable only once the database context exists
            raise ShapeError(
                f"key {key_id!r} is a DPF (PIR) registration but no "
                "database is attached to this service — call "
                "attach_pir(db) first")
        fut = ServeFuture()
        try:
            with self._pir_lock:
                ans = self._pir.answer(key_id, b)
        except Exception as e:  # fallback-ok: retries exhausted inside
            # PirServer — the typed cause completes the future, same
            # contract as a failed point batch
            fut.set_exception(e)
            return fut
        self._c_pir.inc()
        fut.set_result(ans[:, None, :])  # [K, 1, record_bytes] planes
        return fut

    # -- serving ------------------------------------------------------------

    # -- resilience (breaker + brownout) ------------------------------------

    def _record_outcome(self, key_id: str, ok: bool) -> None:
        """Feed one batch attempt's outcome to the breaker board, keyed
        by (key, the facade's backend): the port's facade never changes
        backend, so every attempt of a key lands on one breaker."""
        if not self._breaker_enabled:
            return
        if ok:
            self.breakers.record_success(key_id, self._dcf.backend_name)
        else:
            self.breakers.record_failure(key_id, self._dcf.backend_name)

    def _watchdog_check(self, batch: _Batch,
                        since: float | None = None) -> None:
        """The hung-batch watchdog: raise typed if ``batch``
        overran its wall deadline.  Called INSIDE the dispatch/fetch
        containment try blocks, so an overdue batch records a failure
        outcome against its (key, backend) breaker and takes the
        existing retry/invalidation path — a backend that wedges (eats
        the clock without erroring) degrades exactly like one that
        crashes, instead of stalling the worker forever while the queue
        sheds behind it.

        Two windows are judged SEPARATELY: the dispatch window
        (``batch.t0`` to dispatch-complete — a stage/eval call that ate
        the clock) and, via ``since``, the fetch wait on its own.  The
        pipeline overlap between them (batch N+1 staging while N is in
        flight) is deliberately charged to NEITHER: that time is the
        worker doing productive work, and charging it to batch N would
        spuriously fail a healthy batch whenever staging is slower than
        the timeout — double-burning device work on the retry.  Python
        cannot preempt a call that never returns; the watchdog's
        contract is that a slow call is judged against the injectable
        clock the moment it yields, which the ``latency`` fault seam
        makes deterministically testable."""
        timeout = self.config.batch_timeout_s
        if not timeout:
            return
        elapsed = self._clock() - (batch.t0 if since is None else since)
        if elapsed > timeout:
            self._c_batch_timeouts.inc()
            raise BatchTimeoutError(
                f"batch overran its wall deadline: {elapsed:.3f}s "
                f"elapsed > batch_timeout_s={timeout}s on backend "
                f"family {self._dcf.backend_name!r} — treating the "
                "dispatch as hung")

    def _expire_at_dispatch(self, group: list[Request], errors: dict,
                            pending) -> None:
        """Deadline enforcement at DISPATCH time:
        batch formation already expired what was overdue THEN, but a
        request can outlive its deadline while its batch sits in the
        dispatch-ahead slot behind a slow eval — burning a device eval
        on it would produce a share the caller already abandoned.
        Marks newly-expired requests failed (``DeadlineExceededError``
        through the group's error map, same counter as queue expiry);
        the plan loop then skips any batch whose every request is
        already failed.

        ``pending``: the request indices with spans in the current or a
        LATER plan.  A request whose evaluation already completed in
        earlier plans is never swept — failing it here would discard a
        finished result after its device work was burned, and make the
        outcome depend on what it happened to be co-batched with."""
        now = self._clock()
        for i in pending:
            if i not in errors and group[i].expired(now):
                errors[i] = DeadlineExceededError(
                    f"deadline passed in the dispatch-ahead slot "
                    f"({group[i]!r})")
                self._c_deadline.inc()

    def _update_brownout(self, now: float) -> None:
        """Enter/exit brownout with hysteresis (see the module
        docstring's knob table).  Open breakers enter IMMEDIATELY —
        the breaker's failure threshold already is a sustained-failure
        filter; queue-depth pressure must hold for ``brownout_after_s``
        first (one coalescing burst is not an overload).

        Runs on every ``submit`` (thread-safe) and pump iteration;
        ``_brownout_lock`` makes the check-then-subtract on the
        hysteresis timestamps atomic — a concurrent None-reset between
        the two would crash a submit with an untyped TypeError."""
        cfg = self.config
        # max(1, ...): int() truncates small bounds to a 0 threshold,
        # which an EMPTY queue satisfies — permanent brownout on an
        # idle service.
        depth_pressure = self.queue.points >= max(1, int(
            cfg.brownout_queue_fraction * cfg.max_queued_points))
        open_pressure = self._breaker_enabled and self.breakers.any_open()
        with self._brownout_lock:
            if open_pressure or depth_pressure:
                self._calm_since = None
                if open_pressure:
                    self.queue.set_brownout(True)
                    return
                if self._pressure_since is None:
                    self._pressure_since = now
                if now - self._pressure_since >= cfg.brownout_after_s:
                    self.queue.set_brownout(True)
                return
            self._pressure_since = None
            if not self.queue.brownout:
                return
            if self._calm_since is None:
                self._calm_since = now
            if now - self._calm_since >= cfg.brownout_clear_s:
                self.queue.set_brownout(False)
                self._calm_since = None

    def pump(self) -> int:
        """Serve everything queued right now, inline; returns the number
        of device batches dispatched.  The deterministic driving mode —
        also what the worker thread calls after its coalescing wait."""
        if self._pump_owner == threading.get_ident():
            # Reentrant pump (e.g. ``close`` called from a fault handler
            # or future callback INSIDE a running pump): the outer pump
            # already loops until the queue is empty, and re-acquiring
            # the non-reentrant lock here would deadlock the worker.
            return 0
        served = 0
        with self._pump_lock:
            self._pump_owner = threading.get_ident()
            try:
                while True:
                    now = self._clock()
                    self._update_brownout(now)
                    expire(self.queue.take_expired(now), self.metrics)
                    group = self.queue.take_group(self.config.max_batch)
                    if not group:
                        return served
                    try:
                        served += self._serve_group(group)
                    except Exception as e:  # fallback-ok: the worker must
                        # outlive ANY per-group failure (e.g. the key was
                        # unregistered between submit and dispatch) — fail
                        # the group's futures, keep serving other keys
                        for r in group:
                            if not r.future.done():
                                r.future.set_exception(e)
            finally:
                self._pump_owner = None

    def _serve_group(self, group: list[Request]) -> int:
        """Batch-evaluate one (key_id, party) group of requests."""
        now = self._clock()
        for r in group:
            self._h_wait.observe(max(now - r.enq_t, 0.0))
        key_id, b = group[0].key_id, group[0].b
        # The breaker gate: an open (key, backend-family) pairing fails
        # the whole group fast — pump's per-group containment delivers
        # the typed CircuitOpenError to every future — unless the group
        # carries CRITICAL traffic, which keeps its pre-breaker
        # semantics (dispatch + bounded retries) and doubles as the
        # recovery sensor once the half-open window arrives.
        fam = self._dcf.backend_name
        if self._breaker_enabled and not self.breakers.allow(
                key_id, fam,
                critical=any(r.priority is Priority.CRITICAL
                             for r in group)):
            self._c_breaker_fastfail.inc(len(group))
            raise CircuitOpenError(
                f"circuit breaker open for key {key_id!r} on backend "
                f"family {fam!r}: failing fast until the cooldown's "
                "half-open probe succeeds",
                retry_after_s=self.breakers.retry_after(key_id, fam))
        try:
            return self._serve_group_batches(group, key_id, b)
        except BaseException:  # fallback-ok: re-raised below — this
            # handler only sweeps orphaned board state on the way out,
            # it swallows nothing.
            # A NON-batch failure escaped (stale snapshot, key
            # unregistered between gate and dispatch — batch failures
            # are contained below and recorded).
            if self._breaker_enabled and (
                    key_id not in self.registry.key_ids()):
                # The gate's allow() above (re-)creates board state
                # for its pairing.  If the key was unregistered
                # between submit and dispatch, forget() already ran
                # and nothing will ever run it again — sweep the
                # orphan or the board leaks one entry per churned
                # key (the allow()-path twin of the record_*
                # resurrection guards).
                self.breakers.forget(key_id)
            raise
        finally:
            # Release the probe slot if the gate sanctioned this group
            # as the half-open probe but no batch outcome ever resolved
            # it — the prober died pre-dispatch (non-batch failure
            # above).  A resolved probe has left HALF_OPEN, making this
            # a no-op; a wedged one would otherwise fail (key, fam)
            # fast forever with no recovery path short of
            # unregistering.
            if self._breaker_enabled:
                self.breakers.abort_probe(key_id, fam)

    def _serve_group_batches(self, group: list[Request], key_id: str,
                             b: int) -> int:
        # ONE locked read: a concurrent register() hot-swap must never
        # pair this bundle's geometry (or combine masks) with a
        # different entry's state; the generation travels with the
        # snapshot so resident() refuses to re-stage a swapped key under
        # this group.
        snap = self.registry.snapshot(key_id)
        bundle, proto, _ = snap
        k_num, lam = bundle.num_keys, bundle.lam
        if proto is not None:
            k_num = proto.num_intervals  # batches fetch combined rows
        xs_list = [r.xs for r in group]
        outs = [np.empty((k_num, r.m, lam), dtype=np.uint8) for r in group]
        plans = plan_batches([r.m for r in group], self.config.max_batch)
        errors: dict[int, BaseException] = {}  # req index -> failure

        def finish(batch: _Batch, y: np.ndarray | None,
                   err: BaseException | None) -> None:
            if err is not None:
                self._c_failures.inc()
                for sp in batch.plan.spans:
                    errors.setdefault(sp.req, err)
                return
            self._h_eval.observe(max(self._clock() - batch.t0, 0.0))
            self._h_occupancy.observe(batch.plan.occupancy)
            scatter_batch(outs, batch.plan, y)

        # Dispatch-ahead pipeline: batch N+1 is staged and dispatched
        # while batch N's result is still in flight; N is fetched after.
        # last_plan: each request's final plan index, so the dispatch-
        # time deadline sweep only touches requests with work still
        # ahead of the current plan.
        last_plan: dict[int, int] = {}
        for pi, plan in enumerate(plans):
            for sp in plan.spans:
                last_plan[sp.req] = pi
        prev: _Batch | None = None
        dispatched = 0
        for pi, plan in enumerate(plans):
            self._expire_at_dispatch(
                group, errors,
                [i for i, last in last_plan.items() if last >= pi])
            if all(sp.req in errors for sp in plan.spans):
                # Every request this batch would evaluate has already
                # failed (deadline expired in the dispatch-ahead slot):
                # skip the eval outright — ``prev`` stays in flight and
                # completes on the next dispatched plan or after the
                # loop.
                continue
            dispatched += 1
            cur, y, err = self._run_batch(key_id, b, plan, xs_list, snap)
            if prev is not None:
                self._complete(prev, key_id, b, xs_list, finish, snap)
            if err is not None:
                finish(_Batch(plan, None, 0.0), None, err)
                prev = None
            elif y is not None:  # a sync retry already fetched its bytes
                finish(cur, y, None)
                prev = None
            else:
                prev = cur
        if prev is not None:
            self._complete(prev, key_id, b, xs_list, finish, snap)

        for i, r in enumerate(group):
            if i in errors:
                r.future.set_exception(errors[i])
            else:
                r.future.set_result(outs[i])
        return dispatched

    # -- batch execution ----------------------------------------------------

    def _run_batch(self, key_id: str, b: int, plan: BatchPlan, xs_list,
                   snap) -> tuple[_Batch | None, np.ndarray | None,
                                  BaseException | None]:
        """Dispatch one batch.  Returns (in-flight batch, None, None) on
        the happy path; (batch, bytes, None) when a failure forced the
        synchronous retry path (already fetched); (None, None, error)
        when retries were exhausted."""
        try:
            batch = self._dispatch(key_id, b, plan, xs_list, snap)
            self._watchdog_check(batch)  # a dispatch that ate the clock
            return batch, None, None
        except Exception as e:  # fallback-ok: ANY backend/seam failure
            # must be contained to this batch (retried or failed), never
            # allowed to kill the serve worker
            self._record_outcome(key_id, ok=False)
            y, err = self._retry_sync(key_id, b, plan, xs_list, e, snap)
            if err is not None:
                return None, None, err
            return _Batch(plan, None, self._clock()), y, None

    def _dispatch(self, key_id: str, b: int, plan: BatchPlan,
                  xs_list, snap) -> _Batch:
        """Stage + dispatch one batch; returns the in-flight handle.

        ``snap``: the group's ``registry.snapshot`` — every batch of a
        group serves the same (bundle, protocol) pairing even across a
        concurrent re-register.  For protocol keys on a staged backend
        (every device backend of the port) the pair-combine runs ON
        DEVICE at dispatch (``protocols.combine`` seam fires here; a
        failure takes the ``_run_batch`` retry path) and only [m, M, lam]
        comes back to the host — half the fetched bytes.  On the host
        paths (``numpy``, ``cpu``) the combine applies to the fetched
        bytes, so a combine failure takes the same retry/invalidation
        path as a backend failure, on both the pipelined and sync-retry
        paths."""
        t0 = self._clock()
        bundle, proto, generation = snap

        def wrap(fetch):
            if proto is None:
                return fetch
            masks = proto.masks_for(b)
            return lambda: np.asarray(
                combine_pair_shares(np.asarray(fetch()), masks,
                                    proto.group))

        xs_batch = gather_batch(xs_list, plan, self._dcf.n_bytes)
        fire("serve.stage", key_id, plan.m)
        # The host path: resident() returns None only for a facade built
        # with backend="numpy" or "cpu" (the port never demotes a device
        # facade to it).
        be = self.registry.resident(key_id, b, generation)
        if be is None:
            fire("serve.eval", key_id, plan.m)
            y = self._dcf.eval(b, bundle, xs_batch)
            self._c_batches.inc()
            return _Batch(plan, wrap(lambda: y), t0)
        if hasattr(be, "stage"):
            staged = be.stage(xs_batch)
            self._h_stage.observe(max(self._clock() - t0, 0.0))
            fire("serve.eval", key_id, plan.m)
            y_dev = be.eval_staged(b, staged)  # async dispatch
            # Prefix-family backends build frontier tables on first
            # eval; re-measure so the LRU budget sees the real image.
            self.registry.note_image_growth(key_id, b)
            self._c_batches.inc()
            if proto is not None:
                # The pair combine on the device (fires the seam): every
                # staged backend of the port returns bytes [K, M_pad,
                # lam], so it always applies, and the mask folds into
                # the fetched [m, M, lam] rows.
                y_comb = staged_pair_combine(y_dev, proto.group)
                masks = proto.masks_for(b)
                return _Batch(
                    plan,
                    lambda: np_group_add(
                        be.staged_to_bytes(y_comb, plan.m),
                        masks[:, None, :], proto.group),
                    t0)
            return _Batch(
                plan, lambda: be.staged_to_bytes(y_dev, plan.m), t0)
        fire("serve.eval", key_id, plan.m)
        y = be.eval(b, xs_batch)
        self._c_batches.inc()
        return _Batch(plan, wrap(lambda: y), t0)

    def _complete(self, batch: _Batch, key_id: str, b: int, xs_list,
                  finish, snap) -> None:
        """Fetch an in-flight batch; a fetch-time failure (the dispatch
        is async — compile/execute errors can surface here) takes the
        same retry path as a dispatch-time one."""
        t_fetch = self._clock()  # the fetch WAIT is judged on its own:
        # time since dispatch includes batch N+1's staging (pipeline
        # overlap — productive, not a stall) and must not count
        try:
            y = batch.fetch()
            self._watchdog_check(batch, since=t_fetch)
        except Exception as e:  # fallback-ok: ANY backend/seam failure
            # must be contained to this batch (retried or failed), never
            # allowed to kill the serve worker
            self._record_outcome(key_id, ok=False)
            y, err = self._retry_sync(key_id, b, batch.plan, xs_list, e,
                                      snap)
            if err is not None:
                finish(batch, None, err)
            else:
                finish(_Batch(batch.plan, None, self._clock()), y, None)
            return
        self._record_outcome(key_id, ok=True)
        finish(batch, y, None)

    def _retry_sync(self, key_id: str, b: int, plan: BatchPlan, xs_list,
                    first: BaseException, snap
                    ) -> tuple[np.ndarray | None, BaseException | None]:
        """Bounded synchronous retries after a batch failure, with
        escalating invalidation.

        Early attempts evict only the failed key's residency (cheap — a
        transient fault must not cost every OTHER hot key its staged
        image).  The FINAL attempt drops this service's whole residency
        cache and frontier cache, and the facade's backend slots, so it
        re-stages on a fresh instance of the same backend rather than
        re-entering the instance that just died; other services and
        facades in the process keep theirs.  The port never demotes: a
        device path that keeps failing returns its last typed error,
        which fails the batch's futures.  With the default
        ``retries=1`` the one retry IS the final attempt."""
        last: BaseException = first
        for attempt in range(self.config.retries):
            self._c_retries.inc()
            if attempt < self.config.retries - 1:
                self.registry.evict_key(key_id)
            else:
                self._on_backend_health_reset()
                self._dcf._on_backend_health_reset()
            try:
                batch = self._dispatch(key_id, b, plan, xs_list, snap)
                y = batch.fetch()
                self._watchdog_check(batch)  # a wedged retry fails too
            except Exception as e:  # fallback-ok: retry loop boundary —
                # the last failure is reported to the affected requests
                self._record_outcome(key_id, ok=False)
                last = e
                continue
            self._record_outcome(key_id, ok=True)
            return y, None
        return None, last

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DcfService":
        """Spawn the worker thread (idempotent), and the key factory's
        refill worker when pools are declared."""
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="dcf-serve", daemon=True)
            self._worker.start()
        if self.keyfactory.pool_names():
            self.keyfactory.start()
        return self

    def _worker_loop(self) -> None:
        max_delay = self.config.max_delay_ms / 1e3
        q = self.queue
        while True:
            with q.cond:
                while not len(q) and not q.closed:
                    q.cond.wait(timeout=0.1)
                if not len(q) and q.closed:
                    return
                # Coalescing wait: give co-batchable traffic max_delay to
                # arrive, unless a full batch is already queued or we are
                # draining (queue closed).
                while not q.closed and q.points < self.config.max_batch:
                    oldest = q.oldest_enq_t()
                    if oldest is None:
                        break
                    remaining = max_delay - (self._clock() - oldest)
                    if remaining <= 0:
                        break
                    q.cond.wait(timeout=remaining)
            self.pump()

    def close(self, drain: bool = True, timeout: float | None = None
              ) -> None:
        """Stop admission and shut down.

        ``drain=True`` (default): queued requests are served before the
        worker exits.  ``drain=False``: queued requests complete with
        ``BackendUnavailableError``.  Joins the worker (unless called
        FROM it — a fault handler or chaos scenario closing the service
        mid-batch must not self-join), and never leaves a future
        hanging: queued requests are failed or drained here, and
        requests already taken for an in-flight group are completed by
        the pump that owns them (its retry loop is bounded, so the join
        is too)."""
        self.queue.close()
        # Stop refilling first: a factory minting into a closing
        # service is wasted device work (and its close flushes the
        # batched spent-frame reclaim while the store is still owned).
        # A FAILING flush (dying disk at shutdown) is deferred, not
        # propagated here: the futures below must be failed/drained
        # first — close()'s never-leave-a-future-hanging contract
        # outranks surfacing the reclaim error promptly.
        keyfactory_error: BaseException | None = None
        try:
            self.keyfactory.close()
        except Exception as e:  # fallback-ok: re-raised at the end of
            # close(), after every queued future has been completed
            keyfactory_error = e
        if not drain:
            self.queue.fail_all(lambda: BackendUnavailableError(
                "service closed without draining"))
        worker = self._worker
        if worker is not None and worker.is_alive():
            if worker is not threading.current_thread():
                worker.join(timeout)
        else:
            self.pump()  # no worker: drain inline
        if drain:
            self.pump()  # belt-and-braces: nothing may stay queued
        if keyfactory_error is not None:
            raise keyfactory_error

    def __enter__(self) -> "DcfService":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close(drain=True)
        return False

    # -- observability ------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """Deterministic point-in-time metrics dict (see serve.metrics)."""
        return self.metrics.snapshot()

    def load_report(self):
        """This shard's demand signals as one ``edge.LoadSample``,
        served over the PING/PONG round trip (a ``want_load`` probe's
        PONG appends it — see ``serve.edge``).  Queue points and the
        brownout latch are instantaneous; the shed / tenant-refusal /
        key-factory-pool-miss fields are the CUMULATIVE counters.
        Cheap by design: reads three existing instruments, never
        snapshots."""
        from dcf_tpu_torch.serve.edge import LoadSample

        # Refresh the brownout gate first: on a FULLY quiet service the
        # worker sits in its condvar wait and never pumps, so the latch
        # set during a surge would otherwise read "browned out" forever.
        self._update_brownout(self._clock())
        m = self.metrics
        return LoadSample(
            queue_points=self.queue.points,
            queue_limit=self.config.max_queued_points,
            brownout=self.queue.brownout,
            shed_total=m.counter("serve_shed_total").value,
            refusals_total=m.counter("edge_refused_total").value,
            pool_misses=m.counter(
                "keyfactory_pool_misses_total").value)
