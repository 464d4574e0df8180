"""Live-key replication: the shard side of the monotonic-generation
fence.

Counterpart of ``dcf_tpu/serve/replicate.py``, its shard-side functions
(lines 61-165), which ``DcfService.register_frame`` /
``apply_replica_frame`` / ``sync_frames`` call:

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

The router-side ``Replicator`` (registration fan-out over a shard ring,
the anti-entropy pull) drives edge client pools over a ``ShardMap``; it
waits for the port of the router, edge and shard map (ROADMAP.md).

Secret hygiene: the frame bytes handled here are key material; this
module logs names, generations and counts only.
"""

from __future__ import annotations

from dcf_tpu_torch.errors import ShapeError, StaleStateError
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

