"""Pod-scale routing tier: a zero-copy DCFE router over a
rendezvous-hashed shard ring.

Counterpart of ``dcf_tpu/serve/router.py``: the same routing, failover,
promotion, recovery and co-evaluation policy, the same metric names,
and DCFE on both sides, so a port router fronts ``dcf_tpu`` shards and
a ``dcf_tpu`` router fronts port shards (``tests/test_torch_pod.py``).

``DcfRouter`` is the distributed half of the serving tier.  A pod is N
independent shards — each the crash-safe, breaker-guarded, pool-fed
single-host unit (``DcfService`` + ``EdgeServer``) — and the router is
the one process clients talk to.  It speaks DCFE on BOTH sides:

* **downstream** it IS an ``EdgeServer`` target: the router exposes
  the service-like surface (``n_bytes``, ``_clock``, ``metrics``,
  ``config.tenants``, ``submit_bytes``) so the edge front — its
  frame codecs, tenant table, token buckets, per-connection
  containment and wire fuzz discipline — fronts the router UNCHANGED.
  Tenancy therefore lives at the pod door: the router's tenant table
  admits and class-caps requests once, and the shard links ride the
  open edge (or a TLS-pinned one — see below);
* **upstream** it forwards through ``EdgeClientPool`` connections, one
  pool per shard.  Forwarding is HEADER-DECODE ONLY: the edge front
  decodes the request header and hands this router the payload as a
  ``memoryview`` of the received frame buffer, and
  ``EdgeClient.submit_bytes`` relays exactly that view through the
  scatter-gather send — the packed points are never re-materialized,
  so the zero-copy ingest contract holds end to end across two
  hops (the shard's batcher gathers straight from bytes that were
  DMA'd off the router's socket).  Responses relay the same way:
  the share planes decoded off the shard connection are a view of its
  receive buffer, and ``encode_share`` hands that buffer to the
  downstream ``sendmsg``.

Placement is the ``serve.shardmap`` rendezvous ring: ``owner(key_id)``
serves the key, ``ranked(key_id)[1]`` is its replica.  Provisioning
mirrors the same ranking (``ShardMap.placement``): a durable key's
DCFK frame is written — ``KeyStore`` discipline, atomic publish,
generation preserved — into the owner's AND the replica's stores, so
the host failover lands on has already restored the key at warm-start
(``restore_keys()``) with the generation the owner registered it
under.

Failover consumes the EXISTING typed taxonomy as its signal — the
router invents no second health protocol:

* a TRANSPORT death (connect refused, dark target, a send/read that
  failed — ``BackendUnavailableError`` with no ``wire_code``) and a
  shard-side **breaker-open** (``E_CIRCUIT_OPEN``) or **overload/
  brownout** (``E_QUEUE_FULL``, non-evicted) error frame all mark the
  shard SUSPECT until the hint's ``retry_after_s`` (or
  ``suspect_cooldown_s``) elapses on the injectable clock;
* while the owner is suspect, **CRITICAL** traffic fails over to the
  key's replica shard — which serves the durably replicated frame,
  generation preserved — and a CRITICAL request that watched its
  forward die fails over inline, once, before reporting anything;
* **everything else is refused typed** with ``CircuitOpenError``
  carrying the remaining suspect time as ``retry_after_s`` — the same
  fail-fast contract the per-host breaker board gives a single shard,
  lifted to the ring;
* every OTHER typed outcome (unknown key, ``ShapeError``, deadline,
  ``StaleStateError`` from a hot-swap racing a forwarded eval —
  ``E_STALE`` keeps it distinguishable on the wire) passes through
  untouched: key-level outcomes are the caller's, not routing signals.

Self-healing: the per-request suspicion above is the FAST
signal; the ``serve.health.HealthProber`` is the control plane layered
on top — a periodic DCFE PING per shard through the same pools, with
UP -> SUSPECT -> DOWN -> UP hysteresis (``probe_fail_n`` /
``probe_recover_m``):

* a prober-SUSPECT shard routes exactly like a request-suspect one
  (merged in ``_routable_remaining``; the metrics keep the two
  distinguishable — ``router_suspected_total`` vs
  ``router_health_state``/``router_probe_failures_total``);
* a DOWN shard is dropped from the placement walk for EVERY class:
  each victim key's replica is PROMOTED to acting owner
  (``router_promoted_forwards_total`` — no keys move, rendezvous
  already pinned the successor), so NORMAL/BATCH traffic keeps
  serving instead of waiting out refusal cooldowns;
* recovery is GATED: the DOWN -> UP transition runs the anti-entropy
  pass (``serve.replicate.Replicator.anti_entropy`` — digest
  exchange, strictly-newer pulls, monotonic-generation fence) before
  the shard is re-admitted, and the UP transition clamps the pool's
  dial backoff and clears stale request suspicion.

Live registrations: ``register_frame``/``register_key``
fan a DCFK frame out across the ring — the owner MINTS the
generation, replicas apply it preserved, and the fence
(``StaleStateError``/``E_STALE``) makes an old partition side
structurally unable to roll a key back.  ``KeyStore.replicate_to``
remains the durable twin.  ``set_ring`` swaps membership atomically
and FORGETS removed hosts' state and metric series (bounded
cardinality under host churn).

Cross-host hot-swap needs no new machinery: re-registering a key on
its shard bumps the registry generation there, and a forwarded eval
whose group snapshot predates the swap fails ``StaleStateError``
exactly as an in-process one would (the registry's guard) — the router relays
the typed error and never pairs stale images.

Mesh co-evaluation: next to "route" — one host, one key —
the router speaks a second dispatch mode, "co-evaluate": ONE batch
laid across EVERY mesh worker.  ``set_mesh`` forms a ``MeshGroup``
(``serve.meshgroup`` — device placement, deliberately separate from
the ring's key placement) fenced at the current ring epoch;
``register_mesh_key`` makes a key pod-resident (owner mints through
the ring walk, every other worker applies preserved); a qualifying
request (``co_eval`` policy x ``co_eval_min_points`` threshold) is
SCATTERED as zero-copy sub-views of the same frame buffer — each
worker takes a 32-aligned contiguous point slice through the existing
DCFE relay — and the shares are GATHERED back in plan order.  The
mesh is an optimization, never a liability: a worker death, a fenced
epoch, or a missing group degrades the whole batch to route-mode —
counted ``router_mesh_degraded_total``, warned
``BackendFallbackWarning``, zero lost keys — unless the caller FORCED
the mesh (``co_eval="always"``), who gets ``MeshUnavailableError``
typed with the probe interval as the hint.  Fault seam:
``faults.fire("mesh.collective")`` at each co-evaluated dispatch.

TLS: give the router ``tls_*`` client knobs and
each shard's ``EdgeServer`` a cert (plus ``tls_client_ca`` to PIN the
router's client cert) and the router<->shard links are encrypted and
mutually authenticated; the pod door takes the same server knobs
through the router's ``config``.

Clocking: suspicion math runs on the injectable clock (dcflint
determinism).  All state is per-router-process; two routers over the
same ring agree on placement by construction (the ring is a pure
function) and converge on health independently — suspicion is local
observation, not consensus.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np

from dcf_tpu_torch.errors import (
    BackendFallbackWarning,
    BackendUnavailableError,
    CircuitOpenError,
    MeshUnavailableError,
    ShapeError,
)
from dcf_tpu_torch.serve.admission import Priority, parse_priority
from dcf_tpu_torch.serve.edge import (
    E_CIRCUIT_OPEN,
    E_EPOCH,
    E_QUEUE_FULL,
    EdgeClientPool,
    EdgeServer,
)
from dcf_tpu_torch.serve.health import DOWN, SUSPECT, HealthProber
from dcf_tpu_torch.serve.meshgroup import MeshGroup
from dcf_tpu_torch.serve.metrics import Metrics, labeled
from dcf_tpu_torch.serve.replicate import Replicator
from dcf_tpu_torch.serve.service import ServeConfig
from dcf_tpu_torch.serve.shardmap import ShardMap, ShardSpec
from dcf_tpu_torch.testing.faults import fire
from dcf_tpu_torch.utils.benchtime import monotonic

__all__ = ["DcfRouter"]


def _suspect_signal(exc: BaseException) -> bool:
    """Does ``exc`` indict the SHARD (vs the request)?  Transport
    death carries no ``wire_code``; breaker-open and overload/brownout
    arrive as coded error frames.  An EVICTED QueueFullError is a
    priority-pressure outcome for one request, not host sickness, and
    ``E_RATE_LIMITED`` (a tenant bucket on the shard link) would be
    router misconfiguration — neither marks a shard suspect."""
    code = getattr(exc, "wire_code", None)
    if code is None:
        return isinstance(exc, BackendUnavailableError)
    if code == E_CIRCUIT_OPEN:
        return True
    return code == E_QUEUE_FULL and not getattr(exc, "evicted", False)


def _is_proto(bundle) -> bool:
    """Does ``bundle`` travel as a DCFK v3 proto frame (a
    ``ProtocolBundle`` or a ``DpfBundle``) rather than a plain
    ``KeyBundle`` frame?"""
    from dcf_tpu_torch.protocols import ProtocolBundle

    return (isinstance(bundle, ProtocolBundle)
            or getattr(bundle, "WIRE_PROTO", 0) != 0)


class _RelayFuture:
    """The future a routed submit returns: waits on the forwarded
    request and owns the response-time half of the failover policy.
    The work runs on the WAITER's thread (the edge writer streaming
    this future, or an in-process caller) — the router spawns no
    per-request threads."""

    __slots__ = ("_router", "_inner", "_target", "_args")

    def __init__(self, router: "DcfRouter", inner, target: ShardSpec,
                 args: tuple | None):
        self._router = router
        self._inner = inner
        self._target = target
        self._args = args  # (key_id, data, m, b, deadline_ms, pri),
        # or None once failover is spent; holding ``data`` here is safe
        # because the edge front keeps the frame buffer alive until
        # this future completes

    def done(self) -> bool:
        return self._inner.done()

    def result(self, timeout: float | None = None) -> np.ndarray:
        # One deadline across failovers: a caller's result(5) must
        # return or raise within ~5s even if the wait is split across
        # the owner and the replica — the failover wait gets the
        # REMAINING time, not a fresh budget.
        deadline = None if timeout is None \
            else self._router._clock() + timeout
        while True:
            remaining = None if deadline is None else max(
                deadline - self._router._clock(), 0.0)
            try:
                return self._inner.result(remaining)
            except TimeoutError:
                raise
            except Exception as e:  # fallback-ok: classified by the
                # router — a shard-indicting failure marks it suspect
                # (and may fail over); everything else re-raises as
                # the caller's typed outcome.  The loop runs the
                # FAILOVER target's outcome through the same
                # classification (args spent, so at most one inline
                # re-route): a transport death on the replica must
                # also mark it suspect and surface hinted, never
                # escape bare.
                retry = self._router._on_forward_failure(
                    self._target, e, self._args)
                if retry is None:
                    raise
                self._inner, self._target = retry
                self._args = None  # one inline failover per request


class _MeshFuture:
    """The future a co-evaluated submit returns: waits on every
    scattered slice IN PLAN ORDER and concatenates the share planes
    back along the point axis.  Owns the response-time half of the
    degradation policy: a worker that dies mid-batch (shard-indicting
    signal) is marked suspect and — unless the caller forced the mesh
    — the WHOLE batch is re-routed once through route-mode (zero lost
    keys; the surviving workers' partial shares are discarded, not
    stitched to a re-evaluation).  Key-level outcomes pass through
    verbatim, same contract as the relay future."""

    __slots__ = ("_router", "_parts", "_args")

    def __init__(self, router: "DcfRouter", parts, args: tuple | None):
        self._router = router
        self._parts = parts  # [(inner, ShardSpec, MeshSlice)], plan order
        self._args = args  # (key_id, data, m, b, deadline_ms, pri),
        # or None when degradation is spent / forced-mesh (no re-route)

    def done(self) -> bool:
        return all(inner.done() for inner, _s, _sl in self._parts)

    def result(self, timeout: float | None = None) -> np.ndarray:
        # One deadline across the gather AND a possible degradation:
        # a caller's result(5) budget is shared by every slice wait
        # and the route-mode re-submission, not multiplied by them.
        deadline = None if timeout is None \
            else self._router._clock() + timeout
        shares = []
        for inner, spec, _sl in self._parts:
            remaining = None if deadline is None else max(
                deadline - self._router._clock(), 0.0)
            try:
                shares.append(inner.result(remaining))
            except TimeoutError:
                raise
            except Exception as e:  # fallback-ok: classified below —
                # worker death degrades (or surfaces typed when the
                # mesh was forced); key-level outcomes are the
                # caller's, verbatim
                if not _suspect_signal(e):
                    if getattr(e, "wire_code", None) == E_EPOCH:
                        self._router._c_stale_epoch.inc()
                    raise
                self._router.mark_suspect(
                    spec.host_id, getattr(e, "retry_after_s", None))
                if self._args is None:
                    raise MeshUnavailableError(
                        f"mesh worker {spec.host_id!r} died mid-batch "
                        f"({type(e).__name__}: {e})",
                        retry_after_s=self._router.health.interval_s
                    ) from e
                key_id, data, m, b, deadline_ms, pri = self._args
                self._router._mesh_degrade(
                    f"worker {spec.host_id!r} died mid-batch", e)
                fut = self._router._submit_route(
                    key_id, data, m, b, deadline_ms, pri)
                remaining = None if deadline is None else max(
                    deadline - self._router._clock(), 0.0)
                return fut.result(remaining)
        return np.concatenate(shares, axis=1)


class DcfRouter:
    """DCFE router over a shard ring (see the module docstring).

    ``shards``: a ``ShardMap`` or an iterable of ``ShardSpec``.
    ``n_bytes``: the pod's packed point width (every shard serves the
    same geometry; the router cannot discover it over the wire).
    ``tenants``: the pod-door tenant table (``admission.TenantSpec``)
    — consumed by the fronting ``EdgeServer`` exactly as a single
    shard's would be.  ``replicas``: how many ranking successors hold
    a key's replicated frame (the failover walk goes exactly that
    deep).  ``pool_size``: connections per shard link.  ``tls_*``:
    client-side TLS for the shard links (``tls_cert``/``tls_key`` =
    the router's client cert for pinned shards).

    ``probe_interval_s`` / ``probe_timeout_s`` / ``probe_fail_n`` /
    ``probe_recover_m``: the health prober's cadence and
    hysteresis — ``start_health()`` runs it as a thread, tests drive
    ``health.pump()`` deterministically.  ``local_tag`` names this
    router on the ``net.partition`` fault seam.

    ``co_eval`` / ``co_eval_min_points``: the co-evaluate
    dispatch policy.  ``"auto"`` (default) scatters a request across
    the mesh group when one is formed AND the batch reaches
    ``co_eval_min_points``, degrading to route-mode on any mesh trouble;
    ``"never"`` disables the mesh path; ``"always"`` forces it and
    surfaces mesh trouble typed (``MeshUnavailableError``).

    ``start(host, port)`` fronts the router with its own
    ``EdgeServer`` (DCFE downstream); in-process callers can skip it
    and drive ``submit``/``submit_bytes``/``evaluate`` directly (the
    loadgen's router-target mode).  ``register_key``/``register_frame``
    fan a live registration across the ring; ``set_ring`` swaps
    membership and forgets removed hosts' state."""

    def __init__(self, shards, *, n_bytes: int, tenants: tuple = (),
                 clock=monotonic, metrics: Metrics | None = None,
                 replicas: int = 1, suspect_cooldown_s: float = 1.0,
                 pool_size: int = 2, connect_timeout: float = 5.0,
                 reconnect_backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 max_frame_bytes: int = 256 << 20, tls: bool = False,
                 tls_ca: str = "", tls_cert: str = "",
                 tls_key: str = "", probe_interval_s: float = 0.25,
                 probe_timeout_s: float | None = None,
                 probe_fail_n: int = 3, probe_recover_m: int = 2,
                 co_eval: str = "auto",
                 co_eval_min_points: int = 4096,
                 local_tag: str = "router"):
        self.map = shards if isinstance(shards, ShardMap) \
            else ShardMap(shards)
        if replicas < 0:
            # api-edge: router config contract
            raise ValueError(f"replicas must be >= 0, got {replicas}")
        if suspect_cooldown_s <= 0:
            # api-edge: router config contract — a zero cooldown would
            # mark-and-forget in the same instant, disabling failover
            raise ValueError(
                f"suspect_cooldown_s must be > 0, "
                f"got {suspect_cooldown_s}")
        if co_eval not in ("auto", "never", "always"):
            # api-edge: router config contract
            raise ValueError(
                f"co_eval must be 'auto', 'never' or 'always', "
                f"got {co_eval!r}")
        if co_eval_min_points < 1:
            # api-edge: router config contract
            raise ValueError(
                f"co_eval_min_points must be >= 1, "
                f"got {co_eval_min_points}")
        self.co_eval = co_eval
        self.co_eval_min_points = int(co_eval_min_points)
        # The co-evaluation group: formed by ``set_mesh``,
        # consulted by the dispatch policy, epoch-fenced at every
        # scatter.  None = route-mode only.
        self.mesh_group: MeshGroup | None = None
        self.n_bytes = int(n_bytes)
        self.replicas = int(replicas)
        self.suspect_cooldown_s = float(suspect_cooldown_s)
        self._clock = clock
        self.metrics = metrics if metrics is not None else Metrics()
        # The service-like config the fronting EdgeServer reads: the
        # tenant table is the POD door's admission policy.
        self.config = ServeConfig(tenants=tuple(tenants))
        self._lock = threading.Lock()
        self._suspect_until: dict[str, float] = {}
        # One kwargs dict so set_ring-created pools match construction-
        # time ones exactly (two pool constructors would drift).
        self.local_tag = str(local_tag)
        self._pool_kwargs = dict(
            n_bytes=self.n_bytes, size=pool_size, clock=clock,
            connect_timeout=connect_timeout,
            reconnect_backoff_s=reconnect_backoff_s,
            max_backoff_s=max_backoff_s,
            max_frame_bytes=max_frame_bytes, tls=tls, tls_ca=tls_ca,
            tls_cert=tls_cert, tls_key=tls_key)
        self._pools = {s.host_id: self._make_pool(s)
                       for s in self.map.hosts()}
        self.edge: EdgeServer | None = None
        m = self.metrics
        self._c_forwards = {
            s.host_id: m.counter(labeled("router_forwards_total",
                                         shard=s.host_id))
            for s in self.map.hosts()}
        self._c_suspected = {
            s.host_id: m.counter(labeled("router_suspected_total",
                                         shard=s.host_id))
            for s in self.map.hosts()}
        self._c_failovers = m.counter("router_failovers_total")
        self._c_refused = m.counter("router_suspect_refusals_total")
        self._c_promoted = m.counter("router_promoted_forwards_total")
        self._c_down_refused = m.counter("router_down_refusals_total")
        self._g_suspects = m.gauge("router_suspect_shards")
        # Mesh co-evaluation series: dispatches that took
        # the mesh path, batches degraded back to route-mode, keys
        # made pod-resident, and the formed group's width.
        self._c_co_evals = m.counter("router_co_evals_total")
        self._c_mesh_degraded = m.counter("router_mesh_degraded_total")
        self._c_mesh_registered = m.counter(
            "router_mesh_registered_total")
        self._g_mesh_workers = m.gauge("router_mesh_workers")
        # The self-healing control plane: live-registration
        # fan-out + anti-entropy over the SAME pools the forwards use,
        # and the active health prober whose DOWN/UP transitions drive
        # promotion and gated re-admission (see the module docstring).
        # Ring epoch: the monotonic membership-commit counter this
        # router routes under.  0 =
        # unfenced (a standalone router that never saw a membership
        # change) — frames then carry epoch 0 and shards skip the
        # check.  ``set_ring(..., epoch=)`` is the only writer; every
        # forward, registration fan-out and probe carries the value.
        self.ring_epoch = 0
        self._g_epoch = m.gauge("router_ring_epoch")
        self._c_stale_epoch = m.counter("router_stale_epoch_total")
        self.replicator = Replicator(
            self._pools, lambda: self.map, replicas=self.replicas,
            metrics=self.metrics,
            epoch_source=lambda: self.ring_epoch)
        self.health = HealthProber(
            self._pools, interval_s=probe_interval_s,
            timeout_s=probe_timeout_s, fail_n=probe_fail_n,
            recover_m=probe_recover_m, clock=clock,
            metrics=self.metrics, recover_gate=self._recover_gate,
            on_transition=self._on_health_transition,
            epoch_source=lambda: self.ring_epoch)

    def _make_pool(self, spec: ShardSpec) -> EdgeClientPool:
        return EdgeClientPool(spec.host, spec.port,
                              tags=(self.local_tag, spec.host_id),
                              **self._pool_kwargs)

    # -- health --------------------------------------------------------

    def _on_health_transition(self, ev) -> None:
        """React to a prober transition.  On UP: clamp the
        pool's dial backoff (satellite: a pool whose target was DOWN
        for a long time must not wait out its accumulated exponential
        backoff after health CONFIRMED recovery) and clear the
        request-signal suspicion — a probe-confirmed recovery outranks
        a stale per-request cooldown.  (Request suspicion raised while
        the prober still says UP is deliberately untouched: no
        transition fires, so the cooldown holds — the two signals
        disagree in the conservative direction.)"""
        if ev.to != "up":
            return
        pool = self._pools.get(ev.host_id)
        if pool is not None:
            pool.reset_backoff()
        with self._lock:
            self._suspect_until.pop(ev.host_id, None)
            now = self._clock()
            self._g_suspects.set(sum(
                1 for t in self._suspect_until.values() if t > now))

    def _recover_gate(self, host_id: str) -> bool:
        """The prober's DOWN -> UP gate: the anti-entropy pass
        (``serve.replicate``).  A shard is re-admitted only after it
        converged with every peer the prober does not itself hold
        DOWN — re-admitting earlier could serve stale generations,
        the silent-wrong-answer partition bug."""
        try:
            self.replicator.anti_entropy(
                host_id,
                peer_ok=lambda h: self.health.state(h) != DOWN)
        except Exception:  # fallback-ok: the prober counts the gate
            # failure and keeps the shard DOWN; the next recover_m
            # window retries
            return False
        return True

    def loads(self) -> dict:
        """The freshest per-shard ``edge.LoadSample`` by host id, as
        sampled off the prober's PING/PONG round trips.  ``None`` means
        the shard answers probes but exposes no load surface; absent
        means it never answered.  The demand feed the capacity
        controller (``serve.capacity``) aggregates."""
        return self.health.loads()

    def start_health(self) -> "DcfRouter":
        """Start the active prober thread (production mode; tests
        drive ``self.health.pump()`` deterministically instead)."""
        self.health.start()
        return self

    def suspect_remaining(self, host_id: str) -> float:
        """Seconds of suspicion left for ``host_id`` (0 = trusted).
        The REQUEST-signal cooldown only; the prober's states are read
        via ``self.health`` (the two are merged by the routing walk in
        ``_routable_remaining``, and distinguishable in the metrics:
        ``router_suspected_total`` counts request signals,
        ``router_health_state``/``router_probe_failures_total`` the
        probe plane)."""
        now = self._clock()
        with self._lock:
            return max(self._suspect_until.get(host_id, 0.0) - now, 0.0)

    def _routable_remaining(self, host_id: str) -> float:
        """The merged do-not-route window: the request-signal cooldown
        OR the prober's SUSPECT state (hinted at one probe interval —
        the next round resolves it either way)."""
        remaining = self.suspect_remaining(host_id)
        if self.health.state(host_id) == SUSPECT:
            remaining = max(remaining, self.health.interval_s)
        return remaining

    def mark_suspect(self, host_id: str,
                     for_s: float | None = None) -> None:
        """Mark a shard suspect for ``for_s`` seconds (default: the
        router's cooldown).  Extends, never shortens — two signals
        racing must not let the later, shorter hint re-admit early."""
        until = self._clock() + (self.suspect_cooldown_s
                                 if for_s is None else max(for_s, 0.0))
        with self._lock:
            if until > self._suspect_until.get(host_id, 0.0):
                self._suspect_until[host_id] = until
            now = self._clock()
            self._g_suspects.set(sum(
                1 for t in self._suspect_until.values() if t > now))
        c = self._c_suspected.get(host_id)
        if c is not None:
            c.inc()

    def _on_forward_failure(self, target: ShardSpec,
                            exc: BaseException, args):
        """Classify one forwarded request's failure (from the relay
        future's wait, on the waiter's thread).  Returns ``None`` to
        re-raise ``exc`` (possibly converted), or ``(inner, target)``
        for an inline CRITICAL failover that was successfully
        re-submitted."""
        if not _suspect_signal(exc):
            if getattr(exc, "wire_code", None) == E_EPOCH:
                # The shard told us OUR ring is stale (a membership
                # commit we have not applied): counted, passed through
                # verbatim — the hinted typed refusal is the caller's
                # signal, and refreshing the ring is the operator's
                # move, not a failover.
                self._c_stale_epoch.inc()
            return None  # a key-level outcome: the caller's, verbatim
        hint = getattr(exc, "retry_after_s", None)
        self.mark_suspect(target.host_id, hint)
        if args is not None:
            key_id, data, m, b, deadline_ms, pri = args
            if pri is Priority.CRITICAL:
                ranked = self.map.placement(key_id, self.replicas)
                for nxt in ranked:
                    if nxt.host_id == target.host_id \
                            or self._routable_remaining(nxt.host_id) > 0 \
                            or self.health.state(nxt.host_id) == DOWN:
                        continue
                    pool = self._pools.get(nxt.host_id)
                    if pool is None:
                        continue  # left the ring mid-flight
                    try:
                        inner = pool.submit_bytes(
                            key_id, data, m=m, b=b,
                            deadline_ms=deadline_ms, priority=pri,
                            epoch=self.ring_epoch)
                    except BackendUnavailableError:
                        self.mark_suspect(nxt.host_id)
                        continue
                    self._c_failovers.inc()
                    self._count_forward(nxt.host_id)
                    return inner, nxt
        if hint is None:
            # Account every refusal: a bare transport death becomes
            # the ring's typed fail-fast refusal, hint attached (and
            # counted — this is a router-minted refusal, unlike the
            # pass-throughs above, which the shard already counted),
            # so a caller never sees an unhinted routing-tier failure.
            self._c_refused.inc()
            raise CircuitOpenError(
                f"shard {target.host_id!r} is suspect (transport "
                f"failure: {type(exc).__name__}: {exc}); failing fast "
                "until the cooldown elapses",
                retry_after_s=self.suspect_cooldown_s) from exc
        return None

    # -- submission ----------------------------------------------------

    def _count_forward(self, host_id: str) -> None:
        c = self._c_forwards.get(host_id)
        if c is None:  # a host added by set_ring after construction
            c = self.metrics.counter(labeled("router_forwards_total",
                                             shard=host_id))
            self._c_forwards[host_id] = c
        c.inc()

    def submit_bytes(self, key_id: str, data, b: int = 0,
                     deadline_ms: float | None = None,
                     priority=Priority.NORMAL):
        """Route one packed-bytes request (the edge front's entry;
        mirrors ``DcfService.submit_bytes``).  Returns a future whose
        failure modes are the shard's own typed taxonomy plus the
        routing tier's suspect refusal (``CircuitOpenError`` with
        ``retry_after_s``) — and, with ``co_eval="always"``, the mesh
        tier's ``MeshUnavailableError``.

        Dispatch: the co-evaluate policy decides first —
        a qualifying batch is scattered across the mesh group, with
        any mesh trouble degrading the WHOLE batch to route-mode
        (counted + warned) unless the caller forced the mesh."""
        pri = parse_priority(priority)
        view = memoryview(data).cast("B")
        if view.nbytes == 0 or view.nbytes % self.n_bytes:
            raise ShapeError(
                f"payload of {view.nbytes} bytes is not a positive "
                f"multiple of n_bytes={self.n_bytes}")
        m = view.nbytes // self.n_bytes
        if self._co_eval_applies(m):
            try:
                return self._submit_mesh(key_id, view, m, b,
                                         deadline_ms, pri)
            except MeshUnavailableError as e:
                if self.co_eval == "always":
                    raise
                self._mesh_degrade("mesh dispatch refused", e)
        return self._submit_route(key_id, view, m, b, deadline_ms, pri)

    def _co_eval_applies(self, m: int) -> bool:
        """Does the co-evaluate policy claim an ``m``-point batch?
        ``"always"`` claims everything (no group -> the mesh path
        refuses typed, which ``"always"`` surfaces); ``"auto"`` claims
        batches at or past the crossover when a group is formed."""
        if self.co_eval == "never":
            return False
        if self.co_eval == "always":
            return True
        return (self.mesh_group is not None
                and m >= self.co_eval_min_points)

    def _mesh_degrade(self, what: str, exc: BaseException) -> None:
        """Account one mesh -> route degradation: counted (the soak
        test's zero-lost-keys ledger) and warned (an operator watching
        stderr sees the pod quietly lose its co-evaluation tier)."""
        self._c_mesh_degraded.inc()
        warnings.warn(
            BackendFallbackWarning(f"mesh co-evaluate ({what})",
                                   "route-mode", exc),
            stacklevel=2)

    def _submit_mesh(self, key_id: str, view, m: int, b: int,
                     deadline_ms, pri):
        """Scatter one batch across the mesh group (co-evaluate
        dispatch).  Raises ``MeshUnavailableError`` — absorbed into a
        route-mode degradation by the dispatcher unless the caller
        forced the mesh — when no group is formed, the group's
        formation epoch trails the ring (membership moved; re-form
        with ``set_mesh``), a worker is unroutable (DOWN, suspect, or
        linkless), or a scatter send dies."""
        group = self.mesh_group
        try:
            fire("mesh.collective", m, 0 if group is None else len(group))
        except Exception as e:  # fallback-ok: the armed seam models a
            # collective that cannot form — same typed refusal as a
            # real dead mesh, so tests drive the degradation path
            # without killing a worker
            raise MeshUnavailableError(
                f"mesh collective failed ({type(e).__name__}: {e})",
                retry_after_s=self.health.interval_s) from e
        if group is None:
            raise MeshUnavailableError(
                "no mesh group formed (call set_mesh first)",
                retry_after_s=self.health.interval_s)
        if group.epoch != self.ring_epoch:
            raise MeshUnavailableError(
                f"mesh group formed at ring epoch {group.epoch} but "
                f"the ring is at {self.ring_epoch}; re-form with "
                "set_mesh",
                retry_after_s=self.health.interval_s)
        plan = group.plan(m)
        for sl in plan:
            if self.health.state(sl.host_id) == DOWN \
                    or self._routable_remaining(sl.host_id) > 0:
                raise MeshUnavailableError(
                    f"mesh worker {sl.host_id!r} is not routable",
                    retry_after_s=self.health.interval_s)
            if self._pools.get(sl.host_id) is None:
                raise MeshUnavailableError(
                    f"mesh worker {sl.host_id!r} has no link (left "
                    "the ring; re-form with set_mesh)",
                    retry_after_s=self.health.interval_s)
        parts = []
        for sl in plan:
            spec = self.map.get(sl.host_id)
            pool = self._pools.get(sl.host_id)
            if spec is None or pool is None:
                raise MeshUnavailableError(
                    f"mesh worker {sl.host_id!r} left the ring "
                    "mid-scatter; re-form with set_mesh",
                    retry_after_s=self.health.interval_s)
            # The scattered slice is a SUB-VIEW of the same received
            # frame buffer — the zero-copy relay contract holds across
            # the scatter (32-aligned boundaries keep the shard-side
            # pack word-aligned too).
            sub = view[sl.offset * self.n_bytes:
                       (sl.offset + sl.count) * self.n_bytes]
            try:
                inner = pool.submit_bytes(
                    key_id, sub, m=sl.count, b=b,
                    deadline_ms=deadline_ms, priority=pri,
                    epoch=self.ring_epoch)
            except BackendUnavailableError as e:
                # Scatter-time transport death: the worker is suspect
                # and the batch is NOT partially in flight from the
                # caller's perspective — the already-scattered slices
                # complete server-side and are discarded; route-mode
                # re-evaluates the whole batch.
                self.mark_suspect(sl.host_id)
                raise MeshUnavailableError(
                    f"mesh worker {sl.host_id!r} is unreachable "
                    f"({e})",
                    retry_after_s=self.health.interval_s) from e
            self._count_forward(sl.host_id)
            parts.append((inner, spec, sl))
        self._c_co_evals.inc()
        relay_args = None if self.co_eval == "always" else \
            (key_id, view, m, b, deadline_ms, pri)
        return _MeshFuture(self, parts, relay_args)

    def _submit_route(self, key_id: str, view, m: int, b: int,
                      deadline_ms, pri):
        """Route-mode dispatch: walk the key's ring placement (one
        host, one key)."""
        ranked = self.map.placement(key_id, self.replicas)
        # PROMOTION: a host the prober holds DOWN leaves the
        # walk for EVERY class — its replica serves as acting owner (no
        # keys move; rendezvous already pinned the successor).  SUSPECT
        # keeps the request-signal semantics below: CRITICAL fails over,
        # everyone else is refused typed until the state resolves.
        alive = [t for t in ranked
                 if self.health.state(t.host_id) != DOWN]
        if not alive:
            self._c_refused.inc()
            self._c_down_refused.inc()
            raise CircuitOpenError(
                f"every placed shard for {key_id!r} is DOWN "
                f"({[t.host_id for t in ranked]}); failing fast until "
                "a probe recovers one",
                retry_after_s=self.health.interval_s)
        alive_ids = {t.host_id for t in alive}
        args = (key_id, view, m, b, deadline_ms, pri)
        # Walk the placement: the first trusted holder gets the
        # forward.  Non-CRITICAL traffic only ever sees the acting
        # owner — replicas exist for continuity, not load spreading
        # (spreading would double-serve a key and hide owner sickness).
        candidates = alive if pri is Priority.CRITICAL else alive[:1]
        first_err: BaseException | None = None
        for i, target in enumerate(candidates):
            remaining = self._routable_remaining(target.host_id)
            if remaining > 0:
                if first_err is None:
                    first_err = CircuitOpenError(
                        f"shard {target.host_id!r} (acting owner of "
                        f"{key_id!r}) is suspect; failing fast",
                        retry_after_s=remaining)
                continue
            pool = self._pools.get(target.host_id)
            if pool is None:
                continue  # left the ring between placement and here
            try:
                inner = pool.submit_bytes(
                    key_id, view, m=m, b=b, deadline_ms=deadline_ms,
                    priority=pri, epoch=self.ring_epoch)
            except BackendUnavailableError as e:
                # Submit-time transport death: mark and keep walking
                # (CRITICAL) or refuse typed (everyone else).
                self.mark_suspect(target.host_id)
                if first_err is None:
                    first_err = CircuitOpenError(
                        f"shard {target.host_id!r} is unreachable "
                        f"({e}); failing fast until the cooldown "
                        "elapses",
                        retry_after_s=self.suspect_cooldown_s)
                first_err.__cause__ = e
                continue
            if target.host_id != ranked[0].host_id:
                if ranked[0].host_id not in alive_ids:
                    self._c_promoted.inc()  # owner DOWN: the replica
                    # is the acting owner (health-plane signal) ...
                else:
                    self._c_failovers.inc()  # ... vs the request-
                    # plane suspect walk — the metrics distinguish them
            self._count_forward(target.host_id)
            # Failover spending rule: the relay future may fail over
            # inline only if this forward went to the first acting
            # choice (a forward already down the walk has used the
            # ring once; the relay's own policy further restricts
            # inline failover to CRITICAL traffic).
            relay_args = args if i == 0 else None
            return _RelayFuture(self, inner, target, relay_args)
        self._c_refused.inc()
        raise first_err if first_err is not None else \
            CircuitOpenError(
                f"no shard available for {key_id!r}",
                retry_after_s=self.suspect_cooldown_s)

    def submit(self, key_id: str, xs, b: int = 0,
               deadline_ms: float | None = None,
               priority=Priority.NORMAL):
        """In-process convenience twin of ``DcfService.submit`` — the
        loadgen's router-target mode (``open_loop``
        / ``closed_loop`` drive a router exactly like a service)."""
        xs = np.ascontiguousarray(np.asarray(xs, dtype=np.uint8))
        if xs.ndim != 2 or xs.shape[1] != self.n_bytes:
            raise ShapeError(
                f"xs must be [M, {self.n_bytes}], got {xs.shape}")
        if xs.shape[0] < 1:
            raise ShapeError("cannot submit an empty request")
        return self.submit_bytes(key_id, xs.data, b=b,
                                 deadline_ms=deadline_ms,
                                 priority=priority)

    def evaluate(self, key_id: str, xs, b: int = 0,
                 deadline_ms: float | None = None,
                 timeout: float | None = None,
                 priority=Priority.NORMAL) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(key_id, xs, b, deadline_ms,
                           priority).result(timeout)

    # -- registration (live-key replication) ---------------------------

    def register_frame(self, key_id: str, frame,
                       proto: bool = False) -> int:
        """Register one DCFK frame across the ring (the pod-door
        REGISTER verb — the fronting ``EdgeServer`` routes type-6
        frames here): the OWNER mints the generation, each replica
        applies it preserved (``serve.replicate.Replicator``).
        Returns the generation.  Live (non-durable): the durable twin
        is store provisioning via ``KeyStore.replicate_to``."""
        return self.replicator.register(key_id, frame,
                                        proto=bool(proto))

    def register_key(self, key_id: str, bundle) -> int:
        """In-process convenience twin of ``register_frame``: accepts
        a ``KeyBundle``, ``protocols.ProtocolBundle`` or
        ``protocols.DpfBundle`` and fans its frame out across the
        ring."""
        return self.register_frame(key_id, bundle.to_bytes(),
                                   proto=_is_proto(bundle))

    # -- mesh co-evaluation --------------------------------------------

    def set_mesh(self, host_ids=None, *, epoch: int | None = None
                 ) -> MeshGroup:
        """Form (or re-form) the co-evaluation mesh group from ring
        members — default: every current member.  The group is fenced
        at the CURRENT ring epoch (or an explicit ``epoch``, for a
        controller forming the group inside the same membership
        commit): a later ``set_ring`` epoch bump invalidates it, and
        the next qualifying dispatch degrades to route-mode until the
        group is re-formed — a scatter can never land on an ejected
        host's successor ring by accident."""
        ids = self.map.host_ids() if host_ids is None else list(host_ids)
        for host_id in ids:
            if host_id not in self.map:
                # api-edge: mesh membership contract — a worker outside
                # the ring has no pool, no health target, no keys
                raise ValueError(
                    f"mesh worker {host_id!r} is not in the ring "
                    f"({self.map.host_ids()})")
        group = MeshGroup(
            ids, epoch=self.ring_epoch if epoch is None else int(epoch))
        self.mesh_group = group
        self._g_mesh_workers.set(len(group))
        return group

    def register_mesh_frame(self, key_id: str, frame,
                            proto: bool = False) -> int:
        """Register one DCFK frame on EVERY mesh worker: co-evaluation
        scatters a batch pod-wide, so the key must be resident beyond
        its ring placement.  The ring walk goes first (the OWNER mints
        the generation — ``Replicator.register``, durable semantics
        unchanged), then each remaining mesh worker applies it
        preserved; a worker that cannot apply (dark, fenced) is
        skipped — the dispatch-time health check keeps a batch off a
        worker that missed the key's registration window, and
        anti-entropy converges it on recovery."""
        if self.mesh_group is None:
            raise MeshUnavailableError(
                "no mesh group formed (call set_mesh first)",
                retry_after_s=self.health.interval_s)
        gen = self.replicator.register(key_id, frame, proto=bool(proto))
        placed = self.map.placement_ids(key_id, self.replicas)
        for host_id in self.mesh_group.host_ids():
            if host_id in placed:
                continue  # the ring walk already registered it here
            pool = self._pools.get(host_id)
            if pool is None:
                continue  # left the ring mid-flight; set_mesh re-forms
            try:
                pool.register_frame(key_id, frame, generation=gen,
                                    proto=bool(proto),
                                    epoch=self.ring_epoch)
            except Exception:  # fallback-ok: a dark or fenced worker
                # must not fail an owner-acked registration — the
                # scatter-time health gate covers the window, and
                # anti-entropy heals the copy
                continue
        self._c_mesh_registered.inc()
        return int(gen)

    def register_mesh_key(self, key_id: str, bundle) -> int:
        """In-process convenience twin of ``register_mesh_frame``:
        accepts a ``KeyBundle``, ``protocols.ProtocolBundle`` or
        ``protocols.DpfBundle``."""
        return self.register_mesh_frame(key_id, bundle.to_bytes(),
                                        proto=_is_proto(bundle))

    # -- ring membership (bounded state) -------------------------------

    def set_ring(self, shards, *, epoch: int | None = None,
                 retain=()) -> None:
        """Swap the shard ring atomically (``ShardMap`` or an iterable
        of ``ShardSpec``).  Removed hosts are FORGOTTEN — pool closed,
        suspect/backoff/health state dropped, labeled metric series
        removed (the ``BreakerBoard.forget`` cardinality discipline:
        host churn must not grow router state or its snapshot without
        limit).  Added hosts get fresh pools and health targets (a pool
        installed ahead of time by ``preconnect`` — the membership
        controller's pre-admission warm — is reused); a host whose
        ADDRESS changed (same id) is re-dialed.  In-flight
        requests keep the ranking they started with (the old map
        reference stays valid — ``ShardMap`` is immutable).

        ``epoch``: the ring epoch this membership change is
        committed under — strictly monotonic; subsequent forwards,
        registrations and probes carry it, so shards structurally
        refuse any router still routing on the pre-change ring
        (``E_EPOCH``).  None leaves the epoch untouched.  ``retain``:
        removed host ids whose pool and health state must be KEPT for
        now — a graceful drain's in-flight window; the membership
        controller calls ``forget_host`` once the drain grace
        elapses."""
        new = shards if isinstance(shards, ShardMap) \
            else ShardMap(shards)
        if epoch is not None and epoch <= self.ring_epoch:
            # api-edge: membership contract — the epoch IS the fence;
            # a reused or rolled-back value would let two conflicting
            # rings coexist as peers
            raise ValueError(
                f"ring epoch must be strictly monotonic: got {epoch} "
                f"at current epoch {self.ring_epoch}")
        retain = frozenset(retain)
        old_ids = {s.host_id: s for s in self.map.hosts()}
        new_ids = {s.host_id: s for s in new.hosts()}
        # Added hosts get their pools BEFORE the map swaps: a submit
        # or registration placing onto the new ring must find the
        # link already dialed-able (the reverse order would open a
        # window where placement names a host with no pool).
        for host_id, spec in new_ids.items():
            if host_id not in old_ids:
                pool = self._pools.get(host_id)
                if pool is not None and (pool.host, pool.port) \
                        != spec.address:
                    # A retained (drain-grace) or preconnected pool
                    # wired to a DIFFERENT endpoint than the spec being
                    # admitted: reusing it would route every forward
                    # for this host to the old address.  Re-dial.
                    pool.close()
                    pool = None
                if pool is None:  # else: the preconnect's pool
                    self._pools[host_id] = self._make_pool(spec)
                self._c_forwards[host_id] = self.metrics.counter(
                    labeled("router_forwards_total", shard=host_id))
                self._c_suspected[host_id] = self.metrics.counter(
                    labeled("router_suspected_total", shard=host_id))
                self.health.add_target(host_id,
                                       self._pools[host_id])
            elif old_ids[host_id].address != spec.address:
                # Same identity, new address: re-dial (placement is
                # keyed on host_id, so no keys move).
                stale = self._pools.pop(host_id, None)
                if stale is not None:
                    stale.close()
                self._pools[host_id] = self._make_pool(spec)
                self.health.add_target(host_id,
                                       self._pools[host_id])
        if epoch is not None:
            # Epoch first, map second: a forward racing the swap then
            # carries at worst (new epoch, old map) — served fine, the
            # placement is epoch-checked at membership commits, not
            # per key — never (old epoch, new map), which a shard that
            # already adopted the new epoch would refuse spuriously.
            self.ring_epoch = int(epoch)
            self._g_epoch.set(self.ring_epoch)
        self.map = new  # atomic reference swap
        for host_id in old_ids:
            if host_id not in new_ids and host_id not in retain:
                self._forget_host(host_id)

    def preconnect(self, spec: ShardSpec) -> EdgeClientPool:
        """Install (or return) a pool for a host NOT yet in the ring:
        the membership controller dials a joining host to warm it
        through the anti-entropy path BEFORE admission, so the first
        routed request finds a warm shard.  Routing never consults
        pools of unmapped hosts, so the link is inert until ``set_ring``
        admits the host (reusing this pool); an aborted join cleans up
        with ``forget_host``."""
        pool = self._pools.get(spec.host_id)
        if pool is not None and (pool.host, pool.port) != spec.address:
            # A leftover pool (a drain's retained link, or an earlier
            # preconnect) wired to another endpoint: warming through it
            # would warm the WRONG process.  Re-dial.
            pool.close()
            pool = None
        if pool is None:
            pool = self._make_pool(spec)
            self._pools[spec.host_id] = pool
        return pool

    def forget_host(self, host_id: str) -> None:
        """Drop a host's pool, suspicion and health state and its
        labeled series: the deferred half of a ``set_ring(...,
        retain=...)`` drain (the pool outlives the swap while in-flight
        relayed requests complete against it), and the cleanup of an
        aborted ``preconnect``.  Idempotent; refuses to forget a
        CURRENT ring member (placement would name a host with no
        link)."""
        if host_id in self.map:
            # api-edge: membership contract
            raise ValueError(
                f"host {host_id!r} is still in the ring; swap it out "
                "with set_ring before forgetting its state")
        self._forget_host(host_id)

    def _forget_host(self, host_id: str) -> None:
        """Drop EVERY piece of per-host router state for a host that
        left the ring (pinned by the cardinality test: churning hosts
        in and out leaves the suspect map, the pool table and the
        metrics snapshot exactly where they started)."""
        pool = self._pools.pop(host_id, None)
        if pool is not None:
            pool.close()
        self.health.remove_target(host_id)
        with self._lock:
            self._suspect_until.pop(host_id, None)
            now = self._clock()
            self._g_suspects.set(sum(
                1 for t in self._suspect_until.values() if t > now))
        self._c_forwards.pop(host_id, None)
        self._c_suspected.pop(host_id, None)
        for name in ("router_forwards_total", "router_suspected_total"):
            self.metrics.remove(labeled(name, shard=host_id))

    # -- lifecycle -----------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0,
              **edge_kwargs) -> "DcfRouter":
        """Front the router with its own DCFE ``EdgeServer`` (the pod
        door).  ``edge_kwargs`` pass through (``tls_cert``/``tls_key``
        terminate client TLS at the router; ``read_timeout_s`` etc.)."""
        if self.edge is None:
            self.edge = EdgeServer(self, host, port,
                                   **edge_kwargs).start()
        return self

    @property
    def address(self) -> tuple[str, int]:
        if self.edge is None:
            # api-edge: lifecycle contract, same spelling as EdgeServer
            raise ValueError("router edge not started (call start())")
        return self.edge.address

    def close(self) -> None:
        self.health.close()
        if self.edge is not None:
            self.edge.close()
            self.edge = None
        for pool in list(self._pools.values()):
            pool.close()

    def __enter__(self) -> "DcfRouter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- observability -------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """The ROUTER's own deterministic metrics (forwards per shard,
        failovers, suspect refusals, plus the fronting edge's series).
        The pod view — per-shard serve metrics summed — is
        ``serve.metrics.rollup_snapshots`` over the shards' own
        snapshots; the router cannot see inside its shards and does
        not pretend to."""
        return self.metrics.snapshot()

    def __repr__(self) -> str:
        return (f"DcfRouter(shards={self.map.host_ids()}, "
                f"replicas={self.replicas})")
