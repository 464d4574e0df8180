"""dcf_tpu_torch.serve — the online DCF evaluation service, on the card.

Counterpart of ``dcf_tpu/serve``, for its in-process tier: everything
between "a staged backend that can evaluate one big batch" and "a
service answering bursty small queries against many long-lived keys":

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
- ``serve.replicate`` the shard side of live replication
  (``decode_key_frame``, the fenced ``apply_frame``, ``sync_frames``);
- ``serve.metrics``   dependency-free counters/gauges/histograms with a
  deterministic snapshot; ``rollup_snapshots`` sums snapshots;
- ``serve.service``   ``DcfService``: the worker loop tying it together,
  with a dispatch-ahead pipeline and the ``serve.stage``/``serve.eval``
  fault seams;
- ``serve.loadgen``   the closed-loop load generator.

Not carried yet (ROADMAP.md): ``dcf_tpu``'s network edge, router,
health prober, capacity controller, membership, shard map, mesh group
and the router-side ``Replicator``.

Entry point: ``Dcf.serve(...)`` (see ``dcf_tpu_torch.api``).
"""

from dcf_tpu_torch.serve.admission import (  # noqa: F401
    Priority,
    ServeFuture,
    TenantSpec,
)
from dcf_tpu_torch.serve.breaker import BreakerBoard  # noqa: F401
from dcf_tpu_torch.serve.frontier_cache import FrontierCache  # noqa: F401
from dcf_tpu_torch.serve.keyfactory import KeyFactory, PoolSpec  # noqa: F401
from dcf_tpu_torch.serve.metrics import Metrics, rollup_snapshots  # noqa: F401
from dcf_tpu_torch.serve.registry import KeyRegistry  # noqa: F401
from dcf_tpu_torch.serve.service import DcfService, ServeConfig  # noqa: F401
from dcf_tpu_torch.serve.store import KeyStore, RestoreReport  # noqa: F401

__all__ = ["DcfService", "ServeConfig", "ServeFuture", "Priority",
           "TenantSpec", "BreakerBoard", "FrontierCache", "KeyFactory",
           "Metrics", "KeyRegistry", "KeyStore", "PoolSpec",
           "RestoreReport", "rollup_snapshots"]
