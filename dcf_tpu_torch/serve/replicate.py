"""Live-key replication and partition-tolerant anti-entropy.

Counterpart of ``dcf_tpu/serve/replicate.py``.  The shard side, which
``DcfService.register_frame`` / ``apply_replica_frame`` /
``sync_frames`` call:

* ``decode_key_frame``: one DCFK frame off the wire -> the registrable
  object, through the port's codecs (``KeyBundle`` v2/v4, or the v3
  proto dispatcher for ``ProtocolBundle`` and ``DpfBundle``).
* ``apply_frame``: the fenced replica apply.  A forwarded frame whose
  generation is at or below the local entry's dies typed
  ``StaleStateError``, counted (``serve_replica_fenced_total``): the
  fence is what makes an old partition side structurally unable to
  roll a key back.
* ``sync_frames``: the anti-entropy serve half, the frames strictly
  newer than a peer's ``{key_id: generation}`` digest.

The router side, ``Replicator``, drives the router's edge client pools
over its ``ShardMap``:

* **Registration fan-out** (``Replicator.register``): a key registered
  through the pod tier travels as a DCFE REGISTER frame (the raw DCFK
  bytes, by reference), first to its ring OWNER, which MINTS the
  generation, then to each replica with the owner's generation
  preserved.  A replica forward that fails is counted, never fatal:
  the registration is acked once the owner holds it, and anti-entropy
  converges the replica when it next heals.
* **Anti-entropy** (``Replicator.anti_entropy``): a partition-healed
  shard exchanges ``{key_id: generation}`` digests with its peers
  (DIGEST/SYNC frames: generations first, key material only for the
  strictly-newer set) and pulls exactly the frames it is behind on,
  filtered to the keys the ring places on it.  The router runs it as
  the health prober's recovery gate: a DOWN shard is re-admitted only
  after the pass completes.

Secret hygiene: the frame bytes handled here are key material; this
module logs names, generations and counts only.
"""

from __future__ import annotations

from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    ShapeError,
    StaleStateError,
)
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.serve.metrics import Metrics

__all__ = ["decode_key_frame", "apply_frame", "sync_frames"]


def decode_key_frame(frame, proto: bool):
    """One DCFK frame off the wire -> the registrable object (the
    existing codecs verbatim — ``KeyBundle`` v2, or the v3 proto
    dispatcher for protocol frames (``ProtocolBundle`` for MIC,
    ``DpfBundle`` for DPF); corruption dies typed ``KeyFormatError``
    inside them)."""
    frame_bytes = bytes(frame)
    if proto:
        from dcf_tpu_torch.protocols import decode_proto_frame

        return decode_proto_frame(frame_bytes)
    return KeyBundle.from_bytes(frame_bytes)


def _unwrap(obj):
    """``(registrable bundle, protocol-or-None)`` for any bundle kind.
    A ``DpfBundle`` is self-contained (its frame IS the key material,
    no combine-mask wrapper), so it registers directly with no
    protocol record — the registry only needs the two-party ``s0s``
    shape and the geometry props, which it shares with ``KeyBundle``."""
    from dcf_tpu_torch.protocols import ProtocolBundle

    if isinstance(obj, ProtocolBundle):
        return obj.keys, obj
    return obj, None


def _check_geometry(key_id: str, bundle: KeyBundle, lam: int,
                    n_bytes: int) -> None:
    if bundle.lam != lam:
        raise ShapeError(
            f"replica frame for {key_id!r} carries lam {bundle.lam} "
            f"!= service lam {lam}")
    if bundle.n_bits != 8 * n_bytes:
        raise ShapeError(
            f"replica frame for {key_id!r} carries domain "
            f"{bundle.n_bits} bits != service domain {8 * n_bytes} "
            "bits")


def apply_frame(registry, key_id: str, frame, generation: int,
                proto: bool, *, lam: int, n_bytes: int,
                metrics: Metrics) -> int:
    """Apply one forwarded frame under the owner's generation (the
    fenced replica/anti-entropy spelling).  Returns the generation; a
    rollback attempt raises ``StaleStateError`` and bumps
    ``serve_replica_fenced_total`` — fenced typed, counted, never
    served."""
    obj = decode_key_frame(frame, proto)
    bundle, protocol = _unwrap(obj)
    _check_geometry(key_id, bundle, lam, n_bytes)
    try:
        gen = registry.register_at(key_id, bundle, generation,
                                   protocol=protocol)
    except StaleStateError:
        metrics.counter("serve_replica_fenced_total").inc()
        raise
    metrics.counter("serve_replica_applied_total").inc()
    return gen


#: Per-SYNC-response payload cap: well under the edge clients' default
#: ``max_frame_bytes`` (256 MiB), so a heal with an arbitrarily large
#: backlog streams in bounded chunks instead of one response the
#: puller's frame bound would reject — which would deadlock recovery
#: exactly when the backlog is largest.  The puller iterates: each
#: applied chunk advances its digest, so the next request returns the
#: NEXT chunk, until nothing newer remains.
SYNC_MAX_BYTES = 32 << 20


#: Digest sentinel meaning "never send this key" (u64 max on the
#: wire): the anti-entropy puller marks keys the ring does NOT place
#: on its target, so unplaced key material never moves — filtering
#: happens at the SENDER, not after the bytes crossed.
DIGEST_SUPPRESS = (1 << 64) - 1


def sync_frames(registry, digest: dict,
                max_bytes: int = SYNC_MAX_BYTES) -> list:
    """The anti-entropy serve half: keys whose generation is STRICTLY
    newer than the caller's digest records (missing = 0), as
    ``(key_id, generation, proto, frame_bytes)`` entries in sorted key
    order, capped at ~``max_bytes`` of frame payload per response
    (at least one entry always ships, so a single oversized frame
    still moves).  Strictness is load-bearing: an equal generation
    means the caller already holds these bytes, and "newer or equal"
    would turn every heal into a full-ring copy."""
    entries = []
    total = 0
    for key_id in sorted(registry.digest()):
        try:
            bundle, protocol, generation = registry.snapshot(key_id)
        except ValueError:
            continue  # unregistered between digest and snapshot
        if generation <= int(digest.get(key_id, 0)):
            continue
        frame_bytes = (protocol.to_bytes() if protocol is not None
                       else bundle.to_bytes())
        is_proto = (protocol is not None
                    or getattr(bundle, "WIRE_PROTO", 0) != 0)
        if entries and total + len(frame_bytes) > max_bytes:
            break  # this response is full; the puller comes back
        entries.append((key_id, generation, is_proto, frame_bytes))
        total += len(frame_bytes)
    return entries


class Replicator:
    """Router-side registration fan-out + anti-entropy orchestration
    (see the module docstring).

    ``pools``: the router's live ``{host_id: EdgeClientPool}`` mapping
    (shared, not copied — ring membership changes show up here).
    ``ring``: zero-arg callable returning the current ``ShardMap``
    (the router swaps its map atomically; the replicator must read the
    same reference).  ``replicas``: ranking successors that hold each
    key (the router's own knob).
    """

    def __init__(self, pools: dict, ring, *, replicas: int = 1,
                 metrics: Metrics | None = None,
                 timeout_s: float = 30.0, epoch_source=None):
        self._pools = pools
        self._ring = ring
        self._replicas = int(replicas)
        self._timeout_s = float(timeout_s)
        # Zero-arg callable returning the router's current ring epoch — forwarded REGISTER frames then carry it, so a
        # stale router's registrations are fenced E_EPOCH at the shard
        # instead of landing on a placement the pod has moved past.
        # None = unfenced (epoch 0 on the wire).
        self._epoch_source = epoch_source
        m = metrics if metrics is not None else Metrics()
        self._c_registered = m.counter("router_registered_total")
        self._c_replicated = m.counter("router_replicated_total")
        self._c_repl_failures = m.counter(
            "router_replicate_failures_total")
        self._c_fenced = m.counter("router_replica_fenced_total")
        self._c_ae_runs = m.counter("router_anti_entropy_runs_total")
        self._c_ae_frames = m.counter(
            "router_anti_entropy_frames_total")
        self._c_ae_fenced = m.counter(
            "router_anti_entropy_fenced_total")

    def register(self, key_id: str, frame, *, proto: bool = False,
                 timeout: float | None = None) -> int:
        """Fan one registration out across the ring: the OWNER mints
        the generation (a failed owner forward fails the registration
        — there is no ack without an owner); each replica applies with
        that generation preserved.  A replica forward that dies
        (transport, fence) is counted and skipped — anti-entropy
        converges it on the replica's next recovery."""
        timeout = self._timeout_s if timeout is None else timeout
        epoch = (int(self._epoch_source())
                 if self._epoch_source is not None else 0)
        placed = self._ring().placement(key_id, self._replicas)
        owner = placed[0]
        # .get, never [] — a registration racing a ``set_ring``
        # membership swap must fail TYPED (owner) or heal later
        # (replica), not crash the caller with a bare KeyError (the
        # router's own submit paths guard the identical race).
        owner_pool = self._pools.get(owner.host_id)
        if owner_pool is None:
            raise BackendUnavailableError(
                f"owner shard {owner.host_id!r} for {key_id!r} has no "
                "link (ring membership changed mid-registration)")
        gen = owner_pool.register_frame(
            key_id, frame, generation=0, proto=proto, timeout=timeout,
            epoch=epoch)
        self._c_registered.inc()
        for rep in placed[1:]:
            pool = self._pools.get(rep.host_id)
            if pool is None:
                self._c_repl_failures.inc()  # left the ring mid-
                # flight: the new ring's anti-entropy owns convergence
                continue
            try:
                pool.register_frame(
                    key_id, frame, generation=gen, proto=proto,
                    timeout=timeout, epoch=epoch)
                self._c_replicated.inc()
            except StaleStateError:
                # The replica already holds a NEWER generation — the
                # fence held against a racing re-registration; the
                # newer key wins by design.
                self._c_fenced.inc()
            except Exception:  # fallback-ok: replica darkness must not
                # fail an owner-acked registration — counted, healed by
                # the anti-entropy pass on recovery
                self._c_repl_failures.inc()
        return int(gen)

    def anti_entropy(self, target_host_id: str, *, peer_ok=None,
                     timeout: float | None = None, ring=None,
                     peers=None) -> int:
        """Converge ``target_host_id`` with its ring peers: pull the
        target's digest, ask each reachable peer for strictly-newer
        frames, and forward to the target exactly those the ring
        places on it.  Returns the number of frames applied.

        A PEER that fails the exchange raises — the caller (the health
        prober's recovery gate) must keep the target DOWN rather than
        re-admit a shard that could not see part of the ring: serving
        a stale generation would be the silent-wrong-answer partition
        bug this pass exists to close.  ``peer_ok(host_id)`` excludes
        peers the caller already knows are down (their absence is
        accounted by THEIR health state, not this pass).

        ``ring`` / ``peers`` (the membership controller's reuse):
        ``ring`` overrides the live map — the PROSPECTIVE ring for a
        join's pre-admission warm, the post-eject or post-drain ring for
        a migration — and decides the placement filter; ``peers``
        overrides the source host ids consulted (a draining host has
        left the new ring but is the primary source of its own keys; a
        joining host is not in the old ring at all).  The defaults are
        the recovery gate's: the live ring, every OTHER member a
        peer."""
        timeout = self._timeout_s if timeout is None else timeout
        ring = self._ring() if ring is None else ring
        target_pool = self._pools.get(target_host_id)
        if target_pool is None:
            raise BackendUnavailableError(
                f"shard {target_host_id!r} has no link (left the "
                "ring); nothing to converge")
        digest = target_pool.pull_digest(timeout)
        self._c_ae_runs.inc()
        pulled = 0
        peer_ids = list(peers) if peers is not None else ring.host_ids()
        for peer_id in peer_ids:
            if peer_id == target_host_id:
                continue
            if peer_ok is not None and not peer_ok(peer_id):
                continue
            peer_pool = self._pools.get(peer_id)
            if peer_pool is None:
                continue  # left the ring mid-pass: its keys moved
            # Sender-side placement filtering: pull the peer's digest
            # (names + generations, NO key material) and SUPPRESS
            # every key the ring does not place on the target — the
            # peer then never serializes those frames, so unplaced
            # key material never crosses the wire only to be dropped.
            peer_digest = peer_pool.pull_digest(timeout)
            want = dict(digest)
            for key_id in peer_digest:
                if target_host_id not in ring.placement_ids(
                        key_id, self._replicas):
                    want[key_id] = DIGEST_SUPPRESS
            # Iterate: each SYNC response is CAPPED (SYNC_MAX_BYTES);
            # applying a chunk advances ``want``, so the next request
            # returns the next chunk — an arbitrarily large backlog
            # streams in bounded frames instead of one response the
            # puller's frame bound would reject (which would wedge
            # recovery exactly when the backlog is largest).
            while True:
                entries = peer_pool.sync_newer(want, timeout)
                if not entries:
                    break
                for key_id, gen, proto, frame in entries:
                    if gen <= int(want.get(key_id, 0)):
                        continue  # belt: the server already filtered
                    try:
                        target_pool.register_frame(
                            key_id, frame, generation=gen,
                            proto=proto, timeout=timeout)
                    except StaleStateError:
                        # The target pulled this key from an earlier
                        # peer at a newer generation, or re-registered
                        # it since the digest — the fence held;
                        # convergence is per-key monotone either way.
                        self._c_ae_fenced.inc()
                    else:
                        digest[key_id] = gen
                        pulled += 1
                        self._c_ae_frames.inc()
                    # Advance past this key EITHER way: a fenced key
                    # is one the target already holds at >= gen, and
                    # not advancing would make the peer resend it in
                    # every chunk forever (a livelock, not a heal).
                    want[key_id] = max(int(want.get(key_id, 0)), gen)
        return pulled

    def __repr__(self) -> str:
        return (f"Replicator(hosts={sorted(self._pools)}, "
                f"replicas={self._replicas})")
