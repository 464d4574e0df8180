"""Serve-resident frontier cache: amortize the top of the walk.

Counterpart of ``dcf_tpu/serve/frontier_cache.py``, line for line.  The
port's prefix-family backends (``PrefixBackend``: kernels B2 + B3, and
``LargeLambdaBackend`` with ``prefix_levels``: B5a + B5b) expand the
top-k walk levels into a per-(key image, party) frontier (torch tensors
on the backend's device: 32-byte rows at lam = 16, 64-byte rows plus a
trajectory word per node for the hybrid).  Without this module the
expansion is an *instance* asset: it dies with every LRU residency
eviction and is rebuilt from scratch on the next re-stage.  Under
Zipf-skewed production traffic that rebuild is pure waste — the key's
image churns, the key's *function* does not.

``FrontierCache`` promotes the frontier to a *serve* asset:

* an LRU keyed by ``(key_id, generation, party, k)`` living beside the
  ``serve.registry.KeyRegistry`` — the registration generation is part
  of the key so a hot-swapped bundle can never alias the old frontier;
* charged against the registry's existing ``device_bytes_budget``: both
  populations (staged key images and cached frontiers) share ONE budget
  and ONE deterministic LRU stamp sequence (``TickSource``), so "evict
  the coldest thing" is well-defined across them and the budget math
  stays exact (frontier rows have a fixed byte cost per node);
* populated off the eval clock — the registry warms the frontier at
  stage time (``FrontierConsumerMixin.ensure_frontier``) and any miss
  builds on first consult — and invalidated through the same
  generation-bump hook as residencies (``KeyRegistry._evict_entry``):
  hot-swap, unregister and failure eviction drop a key's frontiers;
  a pure LRU *budget* eviction of the residency keeps them (that
  survival is the amortization).

Observability (all through the shared ``serve.metrics.Metrics``):
``serve_frontier_hits_total`` / ``serve_frontier_misses_total``
(consults per eval), ``serve_frontier_evictions_total``, and the
``serve_frontier_cache_bytes`` / ``serve_frontier_cache_entries``
gauges.  Hit rate = hits / (hits + misses) is the number
``serve_bench --skew`` reports.

Thread safety: one lock per cache; builds run OUTSIDE it (a frontier
expansion dispatches real device work — holding the lock would
serialize unrelated keys).  Two threads racing the same miss may both
build; the first insert wins and both results are bit-identical (the
frontier is a pure function of the key image), so the race costs work,
never correctness.  A build racing an INVALIDATION is the dangerous
case — its tables were computed against state just declared dead or
superseded — so ``invalidate_key``/``invalidate_all`` bump an epoch
that ``get`` snapshots before building and re-checks before inserting:
the raced result is handed to its in-flight caller (whose batch fails
or retries through the service's reset path anyway) but never
persisted.  LRU stamps come from the shared ``TickSource`` — a
lock of its own, never held while calling out — so eviction order is a
pure function of the request sequence (tests pin exact orders).
"""

from __future__ import annotations

import threading

from dcf_tpu_torch.serve.metrics import Metrics

__all__ = ["FrontierCache", "TickSource", "tables_nbytes"]


class TickSource:
    """Deterministic shared LRU clock: a strictly increasing counter
    handed out per access event.  Shared between a ``KeyRegistry`` and
    its ``FrontierCache`` so their merged eviction order is total."""

    __slots__ = ("_lock", "_tick")

    def __init__(self):
        self._lock = threading.Lock()
        self._tick = 0

    def next(self) -> int:
        with self._lock:
            self._tick += 1
            return self._tick


class _CacheEntry:
    __slots__ = ("tables", "bytes", "stamp")

    def __init__(self, tables, nbytes: int, stamp: int):
        self.tables = tables
        self.bytes = nbytes
        self.stamp = stamp

    def __repr__(self) -> str:  # never table contents — key material
        return f"_CacheEntry(bytes={self.bytes}, stamp={self.stamp})"


def tables_nbytes(tables) -> int:
    """Device bytes of one frontier holding (a table array or a tuple
    of them — the hybrid's (state rows, trajectory words)); torch
    tensors and numpy arrays both carry ``nbytes``.  The ONE
    byte-accounting rule for both merged-budget populations: the cache
    uses it per entry, ``registry.device_image_bytes`` per image-dict
    value — they must never drift apart or the shared budget compares
    apples to oranges."""
    if isinstance(tables, tuple):
        return sum(int(getattr(t, "nbytes", 0) or 0) for t in tables)
    return int(getattr(tables, "nbytes", 0) or 0)


class _BoundProvider:
    """The narrow provider a backend instance consults
    (``backends.frontier.FrontierConsumerMixin.frontier_provider``):
    one cache binding per (key_id, registration generation), created by
    ``FrontierCache.bind`` when the registry stages a residency."""

    __slots__ = ("_cache", "_key_id", "_generation")

    def __init__(self, cache: "FrontierCache", key_id: str,
                 generation: int):
        self._cache = cache
        self._key_id = key_id
        self._generation = generation

    def get(self, party: int, k: int, build):
        return self._cache.get(
            (self._key_id, self._generation, int(party), int(k)), build)

    def __repr__(self) -> str:
        return (f"_BoundProvider(key_id={self._key_id!r}, "
                f"gen={self._generation})")


class FrontierCache:
    """LRU over expanded prefix frontiers (see module docstring).

    ``ticks``: the shared ``TickSource`` (the registry adopts it);
    ``on_growth``: zero-arg hook run after every insert, OUTSIDE the
    cache lock — the registry hangs its merged budget enforcement here.
    """

    def __init__(self, *, metrics: Metrics | None = None,
                 ticks: TickSource | None = None):
        self._lock = threading.Lock()
        self._entries: dict[tuple, _CacheEntry] = {}
        # Invalidation epoch: bumped by invalidate_key/invalidate_all so
        # a build that was in flight when an invalidation swept the
        # cache cannot re-insert state computed against a dead or
        # superseded backend (builds run outside the lock; without the
        # epoch check the raced insert would outlive the shared
        # reset_backend_health path).
        self._epoch = 0
        self.ticks = ticks if ticks is not None else TickSource()
        self._on_growth = None
        m = metrics if metrics is not None else Metrics()
        self._c_hits = m.counter("serve_frontier_hits_total")
        self._c_misses = m.counter("serve_frontier_misses_total")
        self._c_evictions = m.counter("serve_frontier_evictions_total")
        self._g_bytes = m.gauge("serve_frontier_cache_bytes")
        self._g_entries = m.gauge("serve_frontier_cache_entries")

    # -- the provider side (consulted by backends) --------------------------

    def bind(self, key_id: str, generation: int) -> _BoundProvider:
        """A provider scoped to one (key_id, registration generation) —
        set on a residency's backend instance right after
        ``put_bundle`` (which unbinds any previous one)."""
        return _BoundProvider(self, key_id, int(generation))

    def get(self, key: tuple, build):
        """The cached tables under ``key``, building (outside the lock)
        and inserting on a miss.  Every consult re-stamps the entry —
        recency is per eval, not per staging."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                ent.stamp = self.ticks.next()
                self._c_hits.inc()
                return ent.tables
            epoch = self._epoch
        self._c_misses.inc()
        tables = build()
        grew = False
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:  # a concurrent miss inserted first
                ent.stamp = self.ticks.next()
                tables = ent.tables
            elif self._epoch != epoch:
                # An invalidation swept the cache mid-build: these
                # tables were computed against state just declared dead
                # (reset) or superseded (hot-swap).  Hand them to the
                # in-flight caller — its batch fails or retries through
                # the service's own reset path — but do NOT persist
                # them past the invalidation.
                pass
            else:
                self._entries[key] = _CacheEntry(
                    tables, tables_nbytes(tables), self.ticks.next())
                self._update_gauges()
                grew = True
        if grew and self._on_growth is not None:
            self._on_growth()  # registry budget sweep, outside our lock
        return tables

    def set_growth_hook(self, hook) -> None:
        self._on_growth = hook

    # -- the eviction side (driven by the registry) -------------------------

    def lru_entries(self) -> list[tuple[int, tuple, int]]:
        """``(stamp, key, bytes)`` per entry — the registry merges these
        with its residencies when the shared budget is exceeded."""
        with self._lock:
            return [(e.stamp, key, e.bytes)
                    for key, e in self._entries.items()]

    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.bytes for e in self._entries.values())

    def evict(self, key: tuple) -> int:
        """Drop one entry (budget eviction); returns the bytes freed
        (0 if the entry was already gone) so the registry's sweep can
        decrement its running total instead of re-scanning."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return 0
            self._c_evictions.inc()
            self._update_gauges()
            return ent.bytes

    def invalidate_key(self, key_id: str) -> None:
        """Drop every generation/party/k entry for ``key_id`` — the
        generation-bump half of the shared invalidation hook
        (hot-swap / unregister / failure eviction)."""
        with self._lock:
            self._epoch += 1  # discard raced in-flight builds too
            victims = [k for k in self._entries if k[0] == key_id]
            for k in victims:
                del self._entries[k]
            if victims:
                self._c_evictions.inc(len(victims))
                self._update_gauges()

    def invalidate_all(self) -> None:
        """Drop everything (the shared ``reset_backend_health`` path —
        frontier state derived from a backend declared dead must not
        outlive it)."""
        with self._lock:
            self._epoch += 1  # discard raced in-flight builds too
            n = len(self._entries)
            self._entries.clear()
            if n:
                self._c_evictions.inc(n)
            self._update_gauges()

    # -- internals ----------------------------------------------------------

    def _update_gauges(self) -> None:  # caller holds the lock
        self._g_bytes.set(sum(e.bytes for e in self._entries.values()))
        self._g_entries.set(len(self._entries))

    def __repr__(self) -> str:
        with self._lock:
            return (f"FrontierCache(entries={len(self._entries)}, "
                    f"bytes={sum(e.bytes for e in self._entries.values())})")
