"""Key registry + device-residency cache for the serving layer.

Counterpart of ``dcf_tpu/serve/registry.py``.  The residencies are the
port's backend instances (``Dcf.new_eval_backend``), built in the thread
that stages them and used by the service's worker thread; their images
are torch tensors on the facade's device, and ``device_image_bytes``
counts every tensor an instance holds there (``_IMAGE_ATTRS``).  A key
the key factory minted on the card at lam >= 48 arrives with both
parties' narrow arrays still on the card (``dev_planes``); a backend
that advertises ``accepts_dev_planes`` (the ``hybrid`` family) stages
them as they are, with no host round trip, and the registry counts
which way each staging went (``stagings_from_planes`` /
``stagings_from_bundle``).

Long-lived DCF keys are the defining asset of an online FSS service:
a bundle is generated once, then answers queries for hours.  The
registry separates the two lifetimes involved:

* **registration** (host): ``register(key_id, bundle)`` records the
  host-side ``KeyBundle`` under a caller-chosen name.  Cheap, unbounded
  by device memory.  Re-registration under a live name is guarded the
  same way the backends' staged-geometry freshness check guards
  re-staging: it is allowed, bumps the key's generation, and atomically
  evicts every device residency built against the old bundle — serving
  a share from a superseded key would be silent corruption.
* **residency** (device): ``resident(key_id, party)`` lazily constructs
  a dedicated backend instance for that (key, party) slot and ships the
  key image via the backend's existing ``put_bundle``; the instance (and
  with it the staged key image, frontier tables, etc.) is cached and
  reused across batches.  Residencies are evicted LRU when the summed
  device-image bytes exceed ``device_bytes_budget`` — dropping the
  backend instance releases its device arrays to the allocator.

The keylanes backend's CW image is shared between parties (reference
src/lib.rs:269-272), so its residency slot is per-key, not per
(key, party) — same rule the ``Dcf`` facade applies.

LRU order is tracked with a deterministic access counter, not a clock:
eviction order must be a pure function of the request sequence so tests
can pin it.

``restore(store)`` is the warm-restart path — a
``serve.store.KeyStore`` re-registers every durable key at startup
with its persisted generation intact (and the registry's generation
counter advanced past all of them, so nothing a later hot-swap mints
can alias a pre-crash snapshot).  Quarantined frames are reported and
skipped per key, never fatal to the rest.

A ``serve.frontier_cache.FrontierCache`` can live beside the
registry — prefix-family backends then keep their expanded top-k
frontiers in it (keyed (key_id, generation, party, k)) instead of the
instance store, so the expansion survives residency eviction under
skewed traffic.  The cache shares this registry's deterministic stamp
sequence and ``device_bytes_budget``: one merged LRU over staged images
and cached frontiers, one entry-invalidation hook (``_evict_entry``)
for hot-swap/unregister/failure eviction.
"""

from __future__ import annotations

import threading

from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.serve.frontier_cache import (
    FrontierCache,
    TickSource,
    tables_nbytes,
)
from dcf_tpu_torch.serve.metrics import Metrics

__all__ = ["KeyRegistry", "device_image_bytes"]

# The device tensors a backend instance of the port holds: ``aes`` (the
# cipher image every backend builds at construction), ``_bundle_dev``
# (walk, prefix, keylanes: the key image), ``_dev`` (the large-lambda
# hybrid's narrow key image), ``_wide`` (the hybrid's wide-tail (const,
# W), built at the first eval) and ``_frontier`` (the prefix family's
# instance-store tables, filled lazily when no serve frontier cache is
# bound).  Dicts are summed over their values.
_IMAGE_ATTRS = ("aes", "_bundle_dev", "_dev", "_wide", "_frontier")


def device_image_bytes(be) -> int:
    """Byte count of a backend instance's device-resident state (the LRU
    accounting unit): every tensor under ``_IMAGE_ATTRS``, through the
    ONE byte rule (``tables_nbytes`` — the hybrid's frontier store holds
    (rows, words) TUPLES per party).  A backend that stages nothing (host
    paths) counts 0; a mesh-sharded backend the sum of its instances'."""
    if hasattr(be, "shard_backends"):
        return sum(device_image_bytes(x) for x in be.shard_backends())
    total = 0
    for attr in _IMAGE_ATTRS:
        d = getattr(be, attr, None)
        for v in (d.values() if isinstance(d, dict) else (d,)):
            total += tables_nbytes(v)
    return total


class _Entry:
    """One registered key: host bundle + its live device residencies.

    ``protocol``: the ``protocols.ProtocolBundle`` this key was
    registered as, or None for a plain DCF key.  The DEVICE image is
    always the inner ``KeyBundle`` (the residency machinery is
    protocol-agnostic); the protocol record tells the service to apply
    the per-interval share combine when it fetches a batch.

    ``planes``: ``{party: narrow arrays on the device}`` from the
    on-device keygen (``gen.gen_on_device_with_planes``), or None.  When
    present and the backend advertises ``accepts_dev_planes``,
    ``resident`` stages through ``put_bundle(kb, dev_planes=...)``: the
    narrow image never crosses to the host and back.  Budget (LRU)
    evictions keep the planes (a re-stage reuses them); the
    entry-invalidation hook drops them (hot-swap and unregister
    supersede the key, and a failure eviction must not re-feed state
    from the path that just failed)."""

    __slots__ = ("bundle", "generation", "residents", "protocol",
                 "planes")

    def __init__(self, bundle: KeyBundle, generation: int, protocol=None,
                 planes: dict | None = None):
        self.bundle = bundle
        self.generation = generation
        self.protocol = protocol
        self.planes = planes
        self.residents: dict = {}  # slot (party int | "kl") -> _Resident

    def __repr__(self) -> str:  # never the bundle's bytes — shapes only
        return (f"_Entry(gen={self.generation}, "
                f"proto={self.protocol is not None}, "
                f"planes={self.planes is not None}, "
                f"resident_slots={sorted(map(str, self.residents))})")


class _Resident:
    """One (key, slot) device residency: the backend instance owning the
    shipped image, its byte cost, and its LRU stamp."""

    __slots__ = ("be", "bytes", "stamp", "generation")

    def __init__(self, be, nbytes: int, stamp: int, generation: int):
        self.be = be
        self.bytes = nbytes
        self.stamp = stamp
        self.generation = generation

    def __repr__(self) -> str:
        return (f"_Resident(bytes={self.bytes}, stamp={self.stamp}, "
                f"gen={self.generation})")


class KeyRegistry:
    """Named bundles + LRU device-residency cache (see module docstring).

    ``make_backend``: zero-arg factory returning a fresh eval backend
    instance (the ``Dcf`` facade's ``new_eval_backend``), or ``None``
    for host paths — then ``resident`` returns ``None`` backends and the
    service evaluates through the facade directly.
    """

    def __init__(self, make_backend, *, shared_image: bool = False,
                 device_bytes_budget: int = 0,
                 metrics: Metrics | None = None, breakers=None,
                 frontier_cache: FrontierCache | None = None):
        self._make_backend = make_backend
        self._shared_image = shared_image  # keylanes: one slot, both parties
        self.device_bytes_budget = int(device_bytes_budget)
        self._metrics = metrics if metrics is not None else Metrics()
        # The serve-resident frontier cache (serve.frontier_cache), or
        # None to leave prefix-family frontiers in their instance stores
        # (then they die with each LRU residency eviction — the pre-
        # cache behavior, kept as the ``frontier_cache=False`` knob and
        # the cold leg of ``serve_bench --skew``).  The cache shares
        # this registry's LRU stamp sequence and byte budget: eviction
        # order across staged images AND cached frontiers is one merged
        # least-recently-used order.
        self._frontier_cache = frontier_cache
        self._ticks = (frontier_cache.ticks if frontier_cache is not None
                       else TickSource())
        # guarded-by: _lock
        self._staging_keep = None  # the residency mid-staging (RLock-
        # guarded): a frontier warm's budget sweep must not evict it
        if frontier_cache is not None:
            frontier_cache.set_growth_hook(self._apply_budget)
        # The serving layer's ``serve.breaker.BreakerBoard`` (or None).
        # Breaker state is (key_id, backend-family) failure HISTORY, so
        # its lifetime is tied to the registration NAME, not to entry
        # generations or device residencies: ``register`` hot-swaps and
        # LRU/budget evictions leave it alone (a re-registered bundle
        # re-staged onto the same dying backend is still on a dying
        # backend), and only ``unregister`` — the name ceasing to exist
        # — forgets it.
        self._breakers = breakers
        self._lock = threading.RLock()
        # guarded-by: _lock
        self._entries: dict[str, _Entry] = {}
        # guarded-by: _lock
        self._generation = 0
        g = self._metrics.gauge
        self._g_resident_bytes = g("serve_resident_device_bytes")
        self._g_resident_count = g("serve_resident_images")
        self._g_registered = g("serve_registered_keys")
        self._c_evictions = self._metrics.counter("serve_evictions_total")
        self._c_stagings = self._metrics.counter("serve_key_stagings_total")
        # Which way each staging went: from an entry's device planes, or
        # from its host bundle.  Plain attributes, not metric series, so
        # a snapshot stays key-for-key dcf_tpu's.
        # guarded-by: _lock
        self.stagings_from_planes = 0
        # guarded-by: _lock
        self.stagings_from_bundle = 0

    # -- registration -------------------------------------------------------

    def register(self, key_id: str, bundle: KeyBundle,
                 protocol=None, dev_planes: dict | None = None) -> int:
        """Register (or replace) the bundle served under ``key_id``;
        returns the entry's generation (the durable write-through path
        publishes the frame under it).

        The bundle must be the full two-party bundle: the service serves
        both parties, and the keylanes image is two-party by design.
        Replacing a live key evicts its residencies atomically (the
        staleness guard), so no later batch can pair old device state
        with the new key.  ``protocol``: the ``ProtocolBundle`` wrapper
        when ``bundle`` is a protocol key's inner bundle — recorded so
        the service applies the share combine at fetch time
        (``DcfService.register_key`` unwraps and passes both).
        ``dev_planes``: both parties' narrow arrays on the device, from
        the on-device keygen — see ``_Entry.planes``.
        """
        if bundle.s0s.shape[1] != 2:
            raise ShapeError(
                f"register({key_id!r}) wants the full two-party bundle "
                "(shape [K, 2, lam] s0s); restrict per party at eval, "
                "not at registration")
        with self._lock:
            prev = self._entries.get(key_id)
            if prev is not None and prev.bundle is bundle \
                    and prev.protocol is protocol:
                # idempotent re-registration: keep the residencies
                return prev.generation
            self._generation += 1
            if prev is not None:
                self._evict_entry(key_id, prev)
            self._entries[key_id] = _Entry(bundle, self._generation,
                                           protocol, dev_planes)
            self._g_registered.set(len(self._entries))
            return self._generation

    def register_at(self, key_id: str, bundle: KeyBundle,
                    generation: int, protocol=None) -> int:
        """Register ``key_id`` under a FORCED generation.  The
        monotonic-generation fence: an entry already at or past ``generation``
        raises ``StaleStateError`` — an old partition side is structurally
        unable to roll a key back, because the only way to supersede a
        registration is a strictly newer generation.  The registry's own
        counter advances past the applied generation, so a later LOCAL hot-swap
        of any key mints strictly above everything this registry has ever seen
        (the restart-ordering guarantee: a recovered owner anti-entropies
        FIRST, flooring its counter on the replica's generations, and only then
        re-admits traffic — its next mint can never alias a pre-crash
        generation)."""
        if generation < 1:
            # api-edge: replication contract — generation 0 is the
            # wire's "mint here" sentinel, never a forced apply
            raise ValueError(
                f"register_at({key_id!r}) needs a generation >= 1, "
                f"got {generation}")
        if bundle.s0s.shape[1] != 2:
            raise ShapeError(
                f"register_at({key_id!r}) wants the full two-party "
                "bundle (shape [K, 2, lam] s0s)")
        with self._lock:
            prev = self._entries.get(key_id)
            if prev is not None and prev.generation >= generation:
                raise StaleStateError(
                    f"replica frame for {key_id!r} carries generation "
                    f"{generation} but this registry already holds "
                    f"generation {prev.generation}; the monotonic "
                    "fence refuses the rollback")
            if prev is not None:
                self._evict_entry(key_id, prev)
            self._entries[key_id] = _Entry(bundle, int(generation),
                                           protocol)
            self._generation = max(self._generation, int(generation))
            self._g_registered.set(len(self._entries))
            return int(generation)

    def digest(self) -> dict:
        """The live ``{key_id: generation}`` map."""
        with self._lock:
            return {key_id: entry.generation
                    for key_id, entry in self._entries.items()}

    def mint_generations(self, count: int) -> range:
        """Reserve ``count`` fresh generations from the shared counter.
        """
        if count < 1:
            # api-edge: reservation contract (programmer error)
            raise ValueError(f"count must be >= 1, got {count}")
        with self._lock:
            lo = self._generation + 1
            self._generation += count
            return range(lo, self._generation + 1)

    def unregister(self, key_id: str) -> None:
        with self._lock:
            entry = self._entries.pop(key_id, None)
            if entry is not None:
                self._evict_entry(key_id, entry)
            self._g_registered.set(len(self._entries))
        if self._breakers is not None:
            self._breakers.forget(key_id)

    def restore(self, store) -> "RestoreReport":
        """Warm restart: re-register every key a
        ``serve.store.KeyStore`` holds, PRESERVING each key's persisted
        generation — and advance this registry's generation counter
        past the highest restored one, so a post-restore hot-swap
        mints a generation no pre-crash snapshot (or pre-crash durable
        frame) ever carried.  That is the snapshot's aliasing guard extended
        across process death: a restored key must never share a
        generation with different key content.

        A frame the store quarantines (corrupt, truncated, vanished)
        is recorded in the report and SKIPPED — typed, counted, never
        fatal to the other keys.  A corrupt MANIFEST, by contrast,
        raises ``KeyFormatError``: without a trustworthy index there is
        nothing safe to restore.  Returns the ``RestoreReport``
        (``restored``: key_id -> generation; ``quarantined``: key_id ->
        failure message)."""
        from dcf_tpu_torch.serve.store import RestoreReport

        report = RestoreReport()
        store.sweep_orphans()  # crash debris: unreferenced frames/tmps
        loaded, report.quarantined = store.load_all()  # ONE manifest
        # read for the whole restore — per-key load() would make this
        # O(n^2) manifest parses over n stored keys
        for key_id in sorted(loaded):
            bundle, protocol, generation = loaded[key_id]
            if bundle.s0s.shape[1] != 2:
                # the store's put() refuses one-party frames, so this
                # is defense in depth against a hand-edited store —
                # and it must REALLY quarantine (rename aside, drop the
                # manifest entry, bump the counter), or every later
                # restore re-reads the bad frame and re-reports it
                # forever while its manifest entry lingers.
                store.quarantine(key_id)
                report.quarantined[key_id] = (
                    "restored frame is party-restricted; the service "
                    "serves both parties")
                continue
            with self._lock:
                prev = self._entries.get(key_id)
                if prev is not None:
                    self._evict_entry(key_id, prev)
                self._entries[key_id] = _Entry(bundle, generation,
                                               protocol)
                self._generation = max(self._generation, generation)
                self._g_registered.set(len(self._entries))
            report.restored[key_id] = generation
        self._metrics.counter("serve_store_restored_total").inc(
            len(report.restored))
        return report

    def sync_generation_floor(self, floor: int) -> None:
        """Advance the generation counter to at least ``floor`` (a
        store-backed service passes its store's ``max_generation()`` at
        construction).  Without this, a FRESH process on an existing
        store that registers durably BEFORE restoring would mint
        generations the manifest already records — the store's
        monotonic guard would then silently drop the write-through,
        un-acking an acked durable registration."""
        with self._lock:
            self._generation = max(self._generation, int(floor))

    def bundle(self, key_id: str) -> KeyBundle:
        with self._lock:
            entry = self._entries.get(key_id)
            if entry is None:
                # api-edge: unknown-name lookup contract at the serve edge
                raise ValueError(f"no bundle registered under {key_id!r}")
            return entry.bundle

    def snapshot(self, key_id: str):
        """``(bundle, protocol, generation)`` read under ONE lock
        acquisition — the serving layer snapshots this once per request
        group so a concurrent ``register`` hot-swap cannot pair the old
        key's geometry (or combine masks) with the new key's state
        mid-group.  The generation is handed back to ``resident`` so a
        residency lazily re-staged from a SWAPPED entry is refused (the
        group then fails with ``StaleStateError``, same as unregistering
        mid-flight — never silent corruption)."""
        with self._lock:
            entry = self._entries.get(key_id)
            if entry is None:
                # api-edge: unknown-name lookup contract at the serve edge
                raise ValueError(f"no bundle registered under {key_id!r}")
            return entry.bundle, entry.protocol, entry.generation

    def key_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    # -- residency ----------------------------------------------------------

    def resident(self, key_id: str, b: int, generation: int | None = None):
        """The backend instance holding ``key_id``'s party-``b`` image on
        device, staging it (and possibly evicting colder images) if
        absent.  Returns ``None`` for host-path services.

        ``generation``: when given (the serving layer passes its group
        snapshot's), a mismatch with the live entry raises
        ``StaleStateError`` — a hot-swapped key must not lazily re-stage
        under an in-flight group whose combine masks belong to the old
        key (the batch would resolve successfully with silently wrong
        shares)."""
        with self._lock:
            entry = self._entries.get(key_id)
            if entry is None:
                # api-edge: unknown-name lookup contract at the serve edge
                raise ValueError(f"no bundle registered under {key_id!r}")
            if generation is not None and entry.generation != generation:
                raise StaleStateError(
                    f"key {key_id!r} was re-registered (generation "
                    f"{entry.generation} != snapshot {generation}); the "
                    "in-flight group must fail, not serve mixed key state")
            slot = "kl" if self._shared_image else int(b)
            res = entry.residents.get(slot)
            if res is not None:
                res.stamp = self._ticks.next()
                return res.be
            be = self._make_backend()
            if be is None:
                return None
            kb = (entry.bundle if self._shared_image
                  else entry.bundle.for_party(b))
            planes = (entry.planes.get(int(b))
                      if entry.planes is not None
                      and not self._shared_image else None)
            if planes is not None \
                    and getattr(be, "accepts_dev_planes", False):
                # The on-device keygen left this party's narrow arrays
                # on the card: stage them instead of shipping the host
                # bundle's copy back.
                be.put_bundle(kb, dev_planes=planes)
                self.stagings_from_planes += 1
            else:
                be.put_bundle(kb)
                self.stagings_from_bundle += 1
            self._c_stagings.inc()
            res = _Resident(be, device_image_bytes(be), self._ticks.next(),
                            entry.generation)
            entry.residents[slot] = res
            # Prefix-family backends: bind the serve-resident frontier
            # provider (scoped to this key_id + generation — put_bundle
            # just unbound any previous one) and warm the frontier at
            # STAGE time, so later batches' evals gather from cache
            # instead of expanding 2^k nodes on their clock.  The warm
            # runs BEFORE the image budget sweep below: a re-staged
            # key's consult re-stamps its surviving frontier FIRST, so
            # the sweep sees it as the hot entry it is (sweep-first
            # would eat the returning key's own cold-stamped frontier
            # moments before the warm hits it — every re-stage then
            # misses and the cache amortizes nothing).  The warm's own
            # budget sweep (frontier-cache growth hook) must not evict
            # the residency being staged: _staging_keep extends the
            # ``keep`` guarantee across the re-entrant sweep.
            if self._frontier_cache is not None \
                    and hasattr(be, "frontier_provider") \
                    and getattr(be, "prefix_levels", 0):
                be.frontier_provider = self._frontier_cache.bind(
                    key_id, entry.generation)
                self._staging_keep = res
                try:
                    be.ensure_frontier(int(b))
                finally:
                    self._staging_keep = None
            self._enforce_budget(keep=res)
            self._update_gauges()
            return res.be

    def note_image_growth(self, key_id: str, b: int) -> None:
        """Re-measure a residency whose image grew after staging (the
        prefix backends build frontier tables lazily on first eval) and
        re-apply the budget."""
        with self._lock:
            entry = self._entries.get(key_id)
            if entry is None:
                return
            res = entry.residents.get("kl" if self._shared_image else int(b))
            if res is None:
                return
            res.bytes = device_image_bytes(res.be)
            self._enforce_budget(keep=res)
            self._update_gauges()

    # -- eviction -----------------------------------------------------------

    # holds-lock: _lock
    def _iter_residents(self):
        for entry in self._entries.values():
            for slot, res in list(entry.residents.items()):
                yield entry, slot, res

    def _apply_budget(self) -> None:
        """The frontier cache's growth hook: re-run the merged budget
        sweep after an insert.  Takes the registry lock (an RLock — a
        stage-time warm re-enters from ``resident``, where
        ``_staging_keep`` extends the keep guarantee)."""
        with self._lock:
            self._enforce_budget(keep=self._staging_keep)
            self._update_gauges()

    # holds-lock: _lock
    def _enforce_budget(self, keep) -> None:
        """Evict least-recently-used holdings until the summed device
        bytes fit the budget.  Staged key images AND serve-cached
        frontiers share the budget and the stamp sequence, so the sweep
        picks the coldest across BOTH populations — a frontier whose
        key keeps getting evals outlives the churn of colder keys'
        images, which is the whole amortization.  ``keep`` (the
        residency being served/staged) is never evicted, so one
        over-budget key still serves — a budget too small for a single
        image degrades to stage-per-use, not to an unservable key.
        Budget 0 disables the cap."""
        if not self.device_bytes_budget:
            return
        fc = self._frontier_cache
        total = sum(r.bytes for _, _, r in self._iter_residents())
        if fc is not None:
            total += fc.total_bytes()
        if total <= self.device_bytes_budget:
            return
        # One snapshot of both populations, coldest-first, then a
        # decrementing walk: the sweep runs on the serving path under
        # the registry lock, so it must be O(entries log entries), not
        # O(victims * entries) of repeated rescans.  (Cache entries can
        # be re-stamped concurrently by eval-path hits — the staleness
        # window is one sweep, and ``evict`` returning 0 for an entry
        # a racing miss already replaced keeps the total honest.)
        victims = [(res.stamp, "res", (entry, slot, res))
                   for entry, slot, res in self._iter_residents()
                   if res is not keep]
        if fc is not None:
            victims += [(stamp, "frontier", key)
                        for stamp, key, _nb in fc.lru_entries()]
        victims.sort(key=lambda v: v[0])
        for _, kind, victim in victims:
            if total <= self.device_bytes_budget:
                return
            if kind == "res":
                entry, slot, res = victim
                if hasattr(res.be, "invalidate_frontier"):
                    # Budget eviction keeps the key's CACHED frontiers
                    # (their stamps decide their own fate) but clears
                    # the dropped instance's local state: an in-flight
                    # batch closure can pin the instance, and pinned
                    # instance-store frontier bytes would be resident
                    # and uncounted.
                    res.be.invalidate_frontier()
                del entry.residents[slot]
                self._c_evictions.inc()
                total -= res.bytes
            else:
                total -= fc.evict(victim)

    # holds-lock: _lock
    def _evict_entry(self, key_id: str, entry: _Entry) -> None:
        """The ONE entry-invalidation hook: hot-swap, unregister and
        failure eviction all route here, which (a) drops the entry's
        residencies, (b) clears each dropped instance's frontier state
        through ``invalidate_frontier`` (an in-flight batch closure can
        pin the instance — its frontier bytes must not linger unbound
        and uncounted), and (c) drops the serve frontier cache's
        entries for the key (the key image they were expanded from is
        gone or superseded)."""
        n = len(entry.residents)
        for res in entry.residents.values():
            if hasattr(res.be, "invalidate_frontier"):
                res.be.invalidate_frontier()
        entry.residents.clear()
        # Keygen-staged planes die with the entry: a hot-swap/unregister
        # superseded the key they image, and a failure eviction must not
        # re-stage from the device state that just failed (the re-stage
        # then runs from the host bundle).  Budget (LRU) evictions do
        # NOT route here and keep them.
        entry.planes = None
        if n:
            self._c_evictions.inc(n)
        if self._frontier_cache is not None:
            self._frontier_cache.invalidate_key(key_id)
        self._update_gauges()

    def evict_key(self, key_id: str) -> None:
        """Drop one key's device residencies (registration stays).  The
        serving layer's cheap first-line invalidation after a batch
        failure — transient faults must not cost every other hot key its
        staged image.  Routes through the shared entry-invalidation
        hook, so the key's cached frontiers go too: they were built by
        the device state that just failed."""
        with self._lock:
            entry = self._entries.get(key_id)
            if entry is not None:
                self._evict_entry(key_id, entry)

    def evict_all(self) -> None:
        """Drop every device residency (the shared invalidation path:
        ``reset_backend_health`` routes here so a backend declared dead
        mid-serve never serves again from cached state — frontiers
        included)."""
        with self._lock:
            for key_id, entry in self._entries.items():
                self._evict_entry(key_id, entry)

    # holds-lock: _lock
    def _update_gauges(self) -> None:
        total = n = 0
        for _, _, res in self._iter_residents():
            total += res.bytes
            n += 1
        self._g_resident_bytes.set(total)
        self._g_resident_count.set(n)
