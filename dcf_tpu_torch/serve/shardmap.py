"""Shard ring for the pod-scale serving tier: rendezvous
placement of serve keys onto host shards.

Counterpart of ``dcf_tpu/serve/shardmap.py``: the same blake2b score,
so both packages place the same keys on the same hosts
(``tests/test_torch_pod.py``).

A pod is N independent shard processes — each the existing crash-safe,
breaker-guarded, pool-fed single-host unit (``DcfService`` +
``EdgeServer``) — fronted by a router (``serve.router``) that forwards
DCFE frames by hashing ``key_id`` onto this ring.  The ring is PURE
placement: no sockets, no health state (the router owns suspicion and
failover), no clocks — a deterministic function from (membership,
key_id) to a host ranking, so two processes holding the same member
list always agree on who owns a key.

Rendezvous (highest-random-weight) hashing, not consistent-hash
tokens: every host scores ``blake2b(host_id || key_id)`` per key and
the ranking is the descending score order.  The properties the serving
tier leans on:

* **deterministic** — the score is a keyed digest of two strings;
  PYTHONHASHSEED, process identity and dict order are irrelevant, so a
  router restart (or a second router) computes the same placement;
* **minimally disruptive** — removing a host moves EXACTLY the keys it
  owned (every other pair's relative score is untouched), and adding
  one steals on average 1/N of the keys from the incumbents
  (seeded-fuzz-pinned in ``tests/test_pod.py``);
* **replica-consistent** — the ranking's second entry is the key's
  replica: the host that BECOMES the owner if the owner is removed, so
  failover routing and durable-frame replication (``KeyStore``
  discipline, generations preserved) name the same host by
  construction.

A membership change is a NEW ``ShardMap`` (``DcfRouter.set_ring``):
the router swaps the reference atomically, and an in-flight request
keeps the ranking it started with.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

__all__ = ["ShardSpec", "ShardMap"]


@dataclass(frozen=True)
class ShardSpec:
    """One shard host: a stable identity plus its DCFE edge address.

    ``host_id`` is the PLACEMENT identity — it, not the address, feeds
    the rendezvous score, so a shard that restarts on a new port (or
    migrates hosts) keeps its keys as long as it keeps its id."""

    host_id: str
    host: str = "127.0.0.1"
    port: int = 0

    def __post_init__(self):
        if not self.host_id:
            # api-edge: ring membership contract — the empty id would
            # silently collide every anonymous shard onto one score
            raise ValueError("shard host_id must be non-empty")

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)


def _score(host_id: str, key_id: str) -> int:
    """The rendezvous weight of ``host_id`` for ``key_id``: a 64-bit
    keyed digest (blake2b — stdlib, stable across processes and
    platforms; NEVER builtin ``hash``, which is salted per process)."""
    h = hashlib.blake2b(key_id.encode("utf-8"), digest_size=8,
                        key=host_id.encode("utf-8")[:64])
    return int.from_bytes(h.digest(), "little")


class ShardMap:
    """Immutable rendezvous ring over a set of ``ShardSpec`` hosts."""

    def __init__(self, shards):
        shards = tuple(shards)
        if not shards:
            # api-edge: ring membership contract — an empty ring has
            # no owner for any key; the router refuses to build one
            raise ValueError("a shard ring needs at least one host")
        ids = [s.host_id for s in shards]
        if len(set(ids)) != len(ids):
            # api-edge: ring membership contract — duplicate ids would
            # make the ranking order depend on list position
            raise ValueError(f"duplicate shard host_ids in {ids}")
        # Stored sorted by host_id: the ring is a SET — two routers
        # configured with the same members in different order must be
        # the same ring (ties in the ranking also break by this order).
        self._shards = tuple(sorted(shards, key=lambda s: s.host_id))
        self._by_id = {s.host_id: s for s in self._shards}

    # -- membership ----------------------------------------------------

    def hosts(self) -> tuple[ShardSpec, ...]:
        return self._shards

    def host_ids(self) -> list[str]:
        return [s.host_id for s in self._shards]

    def __len__(self) -> int:
        return len(self._shards)

    def __contains__(self, host_id: str) -> bool:
        return host_id in self._by_id

    def get(self, host_id: str) -> ShardSpec | None:
        return self._by_id.get(host_id)

    def with_host(self, shard: ShardSpec) -> "ShardMap":
        """A new ring with ``shard`` added (or its address updated —
        same ``host_id`` replaces the member, which moves no keys)."""
        kept = [s for s in self._shards if s.host_id != shard.host_id]
        return ShardMap([*kept, shard])

    def without_host(self, host_id: str) -> "ShardMap":
        """A new ring with ``host_id`` removed — exactly that host's
        keys move, each to the host its rendezvous ranking has next."""
        if host_id not in self._by_id:
            # api-edge: ring membership contract (removing an unknown
            # id is a caller bookkeeping bug, not a no-op)
            raise ValueError(f"host {host_id!r} is not in the ring "
                             f"({self.host_ids()})")
        return ShardMap([s for s in self._shards if s.host_id != host_id])

    # -- placement -----------------------------------------------------

    def peers(self, host_id: str) -> tuple[ShardSpec, ...]:
        """Every OTHER member of the ring: the anti-entropy exchange set
        for ``host_id`` (a healed shard converges with its peers, never
        with itself).  Raises for an unknown id, as ``without_host``
        does."""
        if host_id not in self._by_id:
            # api-edge: ring membership contract
            raise ValueError(f"host {host_id!r} is not in the ring "
                             f"({self.host_ids()})")
        return tuple(s for s in self._shards if s.host_id != host_id)

    def ranked(self, key_id: str) -> list[ShardSpec]:
        """Every host, descending rendezvous score for ``key_id``:
        ``[owner, replica, ...]``.  Ties (astronomically unlikely with
        64-bit scores, but the ranking must still be total) break by
        ``host_id`` order."""
        return sorted(
            self._shards,
            key=lambda s: (-_score(s.host_id, key_id), s.host_id))

    def owner(self, key_id: str) -> ShardSpec:
        """The host that serves ``key_id``."""
        best = self._shards[0]
        best_score = _score(best.host_id, key_id)
        for s in self._shards[1:]:
            sc = _score(s.host_id, key_id)
            if sc > best_score:
                best, best_score = s, sc
        return best

    def placement(self, key_id: str, replicas: int = 1) -> list[ShardSpec]:
        """The hosts that should HOLD ``key_id``'s durable frame: the
        owner plus ``replicas`` successors (clamped to the ring size).
        The provisioning twin of the router's failover walk — both read
        the same ranking, so the host failover lands on is a host the
        frame was replicated to."""
        if replicas < 0:
            # api-edge: placement contract
            raise ValueError(f"replicas must be >= 0, got {replicas}")
        return self.ranked(key_id)[:1 + replicas]

    def placement_ids(self, key_id: str, replicas: int = 1) -> set:
        """``placement`` as a host-id SET: the router's mesh
        registration, the replicator's anti-entropy filter and the
        membership controller all ask "does host X hold this key?" —
        one spelling."""
        return {s.host_id for s in self.placement(key_id, replicas)}

    def __repr__(self) -> str:
        return f"ShardMap({self.host_ids()})"
