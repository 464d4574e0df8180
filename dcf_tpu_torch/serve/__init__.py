"""dcf_tpu_torch.serve — the online DCF evaluation service, on the card.

Counterpart of ``dcf_tpu/serve``: everything between "a staged backend
that can evaluate one big batch" and "a pod of services answering
bursty small queries over the network against many long-lived keys":

- ``serve.batcher``   pure micro-batch planning: coalesce ragged
  requests into padded power-of-two device batches, scatter results
  back per request;
- ``serve.registry``  named key bundles + LRU device-residency cache
  under a device-bytes budget, one invalidation path shared with
  ``Dcf.reset_backend_health``;
- ``serve.admission`` bounded queue (``QueueFullError`` shedding),
  priority classes (CRITICAL/NORMAL/BATCH: lowest-class-first eviction
  and brownout refusal), deadline propagation
  (``DeadlineExceededError``), result futures;
- ``serve.breaker``   per-(key_id, backend-family) circuit breakers
  (closed/open/half-open on the injectable clock; open pairings fail
  fast with ``CircuitOpenError``, CRITICAL bypasses);
- ``serve.frontier_cache`` serve-resident LRU over prefix-family
  frontier expansions (``prefix``: B2; ``hybrid`` with
  ``prefix_levels``: B5a), keyed (key_id, generation, party, k),
  sharing the registry's byte budget and deterministic LRU stamps;
- ``serve.store``     durable key store: DCFK frames published atomic
  write-fsync-rename under a CRC'd manifest, typed quarantine of
  damaged frames (``KeyQuarantinedError``) and the warm-restart path
  ``DcfService.restore_keys`` preserving generations; a store written
  by either package restores in the other;
- ``serve.keyfactory`` ahead-of-demand keygen pools minted on the card
  (G1, G2, or B7a + W2) in K-packed batches, claimed by
  ``register_key(key_id, pool=...)``;
- ``serve.replicate`` live replication: the shard side
  (``decode_key_frame``, the fenced ``apply_frame``, ``sync_frames``)
  and the router side (``Replicator``: registration fan-out across the
  ring, the anti-entropy pull);
- ``serve.edge``      the network edge: DCFE frames over TCP (plain or
  stdlib ``ssl``) with a zero-copy ingest into the batcher, tenant
  classes with per-tenant token buckets, typed wire error frames with
  retry hints; ``EdgeClient`` and the reconnecting ``EdgeClientPool``;
- ``serve.shardmap``  the pod's rendezvous ring (``ShardMap``,
  ``ShardSpec``): which shard owns a key, and its replica;
- ``serve.health``    the active prober (``HealthProber``): PINGs over
  the pools, UP -> SUSPECT -> DOWN -> UP with a gated recovery;
- ``serve.meshgroup`` the co-evaluation group (``MeshGroup``,
  ``MeshSlice``): 32-aligned slices of one batch, one per worker;
- ``serve.router``    ``DcfRouter``: DCFE on both sides, forwarding by
  header decode only, failover to replicas, promotion of DOWN shards,
  the ring-epoch fence and co-evaluation;
- ``serve.membership`` the ring's control plane
  (``MembershipController``): auto-eject after a DOWN grace, warm
  join, three-phase drain, each committed under a fresh ring epoch
  after re-replication;
- ``serve.capacity``  demand-driven autoscaling
  (``CapacityController``): prober load samples to a hysteresis-damped
  verdict, scaling through the membership verbs, a standby pool;
- ``serve.metrics``   dependency-free counters/gauges/histograms with a
  deterministic snapshot; ``rollup_snapshots`` sums snapshots;
- ``serve.service``   ``DcfService``: the worker loop tying it together,
  with a dispatch-ahead pipeline and the ``serve.stage``/``serve.eval``
  fault seams;
- ``serve.loadgen``   the closed-loop (optionally one edge client per
  thread), open-loop (Poisson, a piecewise rate schedule with
  ``open_loop_ramp``) and session-churn load generators.

Entry point: ``Dcf.serve(...)`` (see ``dcf_tpu_torch.api``).
"""

from dcf_tpu_torch.serve.admission import (  # noqa: F401
    Priority,
    ServeFuture,
    TenantSpec,
)
from dcf_tpu_torch.serve.breaker import BreakerBoard  # noqa: F401
from dcf_tpu_torch.serve.capacity import (  # noqa: F401
    CapacityController,
    CapacityEvent,
    CapacityVerdict,
)
from dcf_tpu_torch.serve.edge import (  # noqa: F401
    EdgeClient,
    EdgeClientPool,
    EdgeServer,
)
from dcf_tpu_torch.serve.frontier_cache import FrontierCache  # noqa: F401
from dcf_tpu_torch.serve.health import HealthEvent, HealthProber  # noqa: F401
from dcf_tpu_torch.serve.keyfactory import KeyFactory, PoolSpec  # noqa: F401
from dcf_tpu_torch.serve.membership import (  # noqa: F401
    MembershipController,
    MembershipEvent,
)
from dcf_tpu_torch.serve.meshgroup import MeshGroup, MeshSlice  # noqa: F401
from dcf_tpu_torch.serve.metrics import Metrics, rollup_snapshots  # noqa: F401
from dcf_tpu_torch.serve.registry import KeyRegistry  # noqa: F401
from dcf_tpu_torch.serve.replicate import Replicator  # noqa: F401
from dcf_tpu_torch.serve.router import DcfRouter  # noqa: F401
from dcf_tpu_torch.serve.service import DcfService, ServeConfig  # noqa: F401
from dcf_tpu_torch.serve.shardmap import ShardMap, ShardSpec  # noqa: F401
from dcf_tpu_torch.serve.store import KeyStore, RestoreReport  # noqa: F401

__all__ = ["DcfService", "ServeConfig", "ServeFuture", "Priority",
           "TenantSpec", "EdgeServer", "EdgeClient", "EdgeClientPool",
           "BreakerBoard", "CapacityController", "CapacityEvent",
           "CapacityVerdict", "DcfRouter", "FrontierCache", "HealthEvent",
           "HealthProber", "KeyFactory", "Metrics", "KeyRegistry",
           "KeyStore", "MembershipController", "MembershipEvent",
           "MeshGroup", "MeshSlice", "PoolSpec", "Replicator",
           "RestoreReport", "ShardMap", "ShardSpec", "rollup_snapshots"]
