"""Autonomous ring membership for the pod serving tier.

Counterpart of ``dcf_tpu/serve/membership.py``: the same verbs, fences,
safety rails, events and ``membership_*`` metric series, in the same
order, so a scripted sequence gives both packages the same
``MembershipEvent``s and the same metrics snapshots
(``tests/test_torch_membership.py``).  It is host code: its migrations
move DCFK frames through the edge's DIGEST / SYNC / REGISTER verbs and
the stores' ``replicate_to``, and the shards behind it evaluate on the
card.

The router's prober walks a dead shard DOWN, promotion serves its keys
from the replica, and anti-entropy gates its re-admission; this module
is the control plane that changes the ring itself, DRIVEN by health,
with every change fenced the way generations are fenced.

``MembershipController`` owns three reconfiguration verbs plus the
fence that makes them safe:

* **Auto-eject** (``eject``, driven by ``pump``): a shard the prober
  has held DOWN for ``eject_grace_s`` is removed from the ring —
  ``ShardMap.without_host``, so exactly its keys move, each to the
  host rendezvous already ranked next.  BEFORE the swap commits, every
  frame the victim held is re-replicated to its new placement: durable
  frames via ``KeyStore.replicate_to`` (the victim's on-disk store
  survives its process and is a valid source — that is what durability
  buys), live keys via the DIGEST/SYNC + REGISTER anti-entropy
  machinery (``Replicator.anti_entropy`` against the POST-eject ring),
  generations preserved and fenced throughout.  The grace period is
  the flap filter: promotion already serves the victim's keys the
  moment the prober says DOWN, so ejection restores the REPLICATION
  FACTOR and can afford to wait out a reboot.

* **Graceful join** (``join``): a new host is warmed BEFORE it is
  admitted — the controller dials it (``DcfRouter.preconnect``), runs
  the anti-entropy pull against the PROSPECTIVE ring (every key the
  new ring will place on it arrives with its owner's generation), and
  only then swaps the map.  The first routed request therefore finds a
  warm shard.  A registration racing the warm is caught by a second,
  post-admission convergence pass (strictly-newer pulls make it
  idempotent).

* **Graceful drain** (``drain``): planned decommission, in three
  phases — migrate every frame the host holds to its new-ring
  placement (the draining host itself is the primary SOURCE: it is
  alive, this is not failover), swap the ring (new placements stop the
  moment the swap commits; a hot-swap racing the migration is caught
  by the same post-swap convergence pass), then hold the host's pool
  open for ``drain_grace_s`` so in-flight relayed requests — which
  keep the old map reference by design — complete against it before
  ``forget_host`` drops the link.

* **Epoch fencing**: every commit mints a strictly-monotonic ring
  epoch (``router.set_ring(..., epoch=)``).  Forwarded DCFE frames
  carry it; shards track the observed maximum and refuse older ones
  typed (``RingEpochError`` / ``E_EPOCH`` — ``serve.edge``).  Probes
  disseminate the epoch, so the pod converges within about one probe
  interval of a commit.

Safety rules: one membership change at a time (serialized on the
controller's lock); auto-eject refuses to shrink the ring below
``min_hosts`` and refuses while any OTHER shard is DOWN (a double
failure is a recovery scenario, not a reconfiguration scenario); a
migration pass that cannot reach a needed source raises and the change
is retried on a later pump.

Driving modes mirror ``HealthProber``: ``start()`` spawns a worker
evaluating the eject grace and finishing drains every
``poll_interval_s``; ``pump()`` runs one evaluation inline — the
deterministic mode, on the injectable clock.  Every committed change
is a typed ``MembershipEvent`` and a metrics write (``membership_*``
series — see ``serve.metrics``).

Capacity delegation (``serve.capacity``): the demand-driven
``CapacityController`` scales the ring through the SAME two verbs —
``join`` for scale-out, ``drain`` for scale-in — so autoscaling
inherits every fence and safety rule above.  ``eject_in_flight`` and
``store_for`` are the two reads its rails make.

Secret hygiene: migrations move whole DCFK frames (key material) —
this module logs names, hosts, epochs and counts only, and the frame
buffers stay inside the edge-client calls.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from dcf_tpu_torch.errors import BackendUnavailableError, KeyQuarantinedError
from dcf_tpu_torch.serve.health import DOWN
from dcf_tpu_torch.serve.shardmap import ShardMap, ShardSpec
from dcf_tpu_torch.testing.faults import fire

__all__ = ["MembershipController", "MembershipEvent"]

#: Key-factory pool frames (``~pool/<name>/<seq>``) are host-local
#: pre-minted supply, not placed serving keys: they never migrate.
_POOL_PREFIX = "~pool/"


@dataclass(frozen=True)
class MembershipEvent:
    """One committed (or completed) membership change: ``kind`` is
    ``eject`` / ``join`` / ``drain`` / ``drain-complete``, ``epoch``
    the ring epoch it committed under (0 for ``drain-complete`` — the
    deferred forget commits nothing), ``migrated`` how many live
    frames the convergence passes moved, ``at`` the injectable-clock
    time."""

    kind: str
    host_id: str
    epoch: int
    migrated: int
    at: float


class MembershipController:
    """Health-driven ring membership over one ``DcfRouter`` (see the
    module docstring).

    ``router``: the pod router whose ring this controller owns —
    after construction, ``set_ring`` belongs to the controller (an
    operator swap behind its back would fork the epoch sequence).
    ``stores``: optional ``{host_id: KeyStore}`` mapping for the
    durable half of migrations (the stores the pod was provisioned
    with; absent hosts simply get no durable copy, the live REGISTER
    path still serves).
    ``eject_grace_s``: how long a shard must stay DOWN before
    auto-ejection.  ``drain_grace_s``: how long a drained host's pool
    outlives the swap for in-flight relays.  ``min_hosts``: the floor
    auto-eject will not shrink the ring below (explicit ``drain`` may
    go to 1 — a planned decommission is the operator's call).
    ``clock``: the injectable clock (defaults to the router's).
    """

    def __init__(self, router, *, stores: dict | None = None,
                 eject_grace_s: float = 5.0,
                 drain_grace_s: float = 2.0, min_hosts: int = 2,
                 clock=None, timeout_s: float = 30.0,
                 poll_interval_s: float = 0.5,
                 max_events: int = 256):
        if eject_grace_s < 0 or drain_grace_s < 0:
            # api-edge: controller config contract
            raise ValueError(
                f"eject_grace_s/drain_grace_s must be >= 0, got "
                f"{eject_grace_s}/{drain_grace_s}")
        if min_hosts < 1:
            # api-edge: controller config contract — a ring of zero
            # hosts cannot place anything
            raise ValueError(f"min_hosts must be >= 1, got {min_hosts}")
        if poll_interval_s <= 0:
            # api-edge: controller config contract
            raise ValueError(
                f"poll_interval_s must be > 0, got {poll_interval_s}")
        self._router = router
        # guarded-by: _op_lock
        self._stores = dict(stores) if stores else {}
        self.eject_grace_s = float(eject_grace_s)
        self.drain_grace_s = float(drain_grace_s)
        self.min_hosts = int(min_hosts)
        self.poll_interval_s = float(poll_interval_s)
        self._timeout_s = float(timeout_s)
        self._clock = clock if clock is not None else router._clock
        self._max_events = int(max_events)
        # ONE membership change at a time: eject/join/drain serialize
        # here, and pump's scan re-checks state under it — two racing
        # changes could each compute a ring that forgets the other's.
        self._op_lock = threading.Lock()
        self._state_lock = threading.Lock()
        # guarded-by: _state_lock
        self._down_since: dict[str, float] = {}
        # guarded-by: _state_lock
        self._draining: dict[str, float] = {}  # host -> forget deadline
        # guarded-by: _state_lock
        self._lost_counted: set[str] = set()  # keys already in the
        #                                       lost counter (audit
        #                                       polling must not
        #                                       re-count a loss)
        # guarded-by: _state_lock
        self._events: list[MembershipEvent] = []
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        m = router.metrics
        self._c_ejects = m.counter("membership_ejections_total")
        self._c_joins = m.counter("membership_joins_total")
        self._c_drains = m.counter("membership_drains_total")
        self._c_migrated = m.counter("membership_migrated_frames_total")
        self._c_durable = m.counter(
            "membership_durable_replications_total")
        self._c_op_failures = m.counter(
            "membership_change_failures_total")
        self._c_eject_skipped = m.counter(
            "membership_eject_skipped_total")
        self._c_store_unreachable = m.counter(
            "membership_store_unreachable_total")
        self._c_lost = m.counter("membership_lost_keys_total")
        self._g_ring_size = m.gauge("membership_ring_size")
        self._g_draining = m.gauge("membership_draining_hosts")
        self._g_ring_size.set(len(router.map))

    # -- events -------------------------------------------------------

    def _record(self, kind: str, host_id: str, epoch: int,
                migrated: int) -> MembershipEvent:
        ev = MembershipEvent(kind, host_id, int(epoch), int(migrated),
                             self._clock())
        with self._state_lock:
            self._events.append(ev)
            del self._events[:-self._max_events]
        return ev

    def events(self) -> list:
        """Drain the committed-change events observed so far (bounded,
        like ``HealthProber.events`` — the metrics are the durable
        record)."""
        with self._state_lock:
            out, self._events = self._events, []
            return out

    def draining(self) -> dict:
        """``{host_id: forget_deadline}`` for drains whose in-flight
        grace has not elapsed yet (``pump`` completes them)."""
        with self._state_lock:
            return dict(self._draining)

    def eject_in_flight(self) -> bool:
        """True while the health plane is mid-failure: some ring
        member is DOWN, or an eject grace is already being tracked
        (the capacity controller's safety rail — it must never
        commit a scaling change concurrent with a health-driven eject;
        two changes racing would each compute a ring that forgets the
        other's, and a surge verdict during an outage is promotion
        noise, not demand)."""
        ring_ids = set(self._router.map.host_ids())
        states = self._router.health.states()
        if any(st == DOWN and h in ring_ids
               for h, st in states.items()):
            return True
        with self._state_lock:
            return any(h in ring_ids for h in self._down_since)

    def store_for(self, host_id: str):
        """The ``KeyStore`` recorded for ``host_id`` (None if never
        provisioned here) — how the capacity controller returns a
        drained host to the standby pool with its store attached."""
        # dcflint: disable=guarded-by single dict .get() under the GIL,
        # and the capacity controller calls this only AFTER its drain
        # committed — the entry it reads cannot be mid-mutation
        return self._stores.get(host_id)

    # -- the control loop ---------------------------------------------

    def pump(self) -> list:
        """One control round inline (the deterministic driving mode):
        finish drains whose grace elapsed, track DOWN durations, and
        auto-eject every shard DOWN past the grace.  Returns the list
        of ``MembershipEvent``s this round committed."""
        out: list = []
        now = self._clock()
        with self._state_lock:
            due = [h for h, t in self._draining.items() if now >= t]
        for host_id in due:
            with self._op_lock:
                # A drained host that re-JOINED within its grace is a
                # ring member again — its retained pool is the member's
                # pool now, and forgetting it would sever a live link
                # (forget_host refuses exactly that).  The drain window
                # still ends either way.
                if host_id not in self._router.map:
                    self._router.forget_host(host_id)
            with self._state_lock:
                self._draining.pop(host_id, None)
                self._g_draining.set(len(self._draining))
            out.append(self._record("drain-complete", host_id, 0, 0))
        states = self._router.health.states()
        ring_ids = set(self._router.map.host_ids())
        with self._state_lock:
            for host_id in list(self._down_since):
                if host_id not in ring_ids \
                        or states.get(host_id) != DOWN:
                    del self._down_since[host_id]
            overdue = []
            for host_id, st in states.items():
                if st != DOWN or host_id not in ring_ids:
                    continue
                since = self._down_since.setdefault(host_id, now)
                if now - since >= self.eject_grace_s:
                    overdue.append(host_id)
        for host_id in overdue:
            down_ids = {h for h, st in
                        self._router.health.states().items()
                        if st == DOWN and h in self._router.map}
            if len(self._router.map) - 1 < self.min_hosts \
                    or len(down_ids) > 1:
                # Never below the floor, never during a multi-failure:
                # promotion keeps the keys serving; ejecting here
                # would trade availability bookkeeping for replication
                # the surviving ring cannot actually rebuild.
                self._c_eject_skipped.inc()
                continue
            try:
                out.append(self.eject(host_id))
            except Exception:  # fallback-ok: a failed change (a
                # source peer died mid-migration) was counted by
                # eject itself and is retried on a later pump — the
                # ring stays on the last committed epoch, promotion
                # keeps serving
                pass
        return out

    # -- the three verbs ----------------------------------------------

    def eject(self, host_id: str) -> MembershipEvent:
        """Remove a (presumed dead) shard from the ring, restoring the
        replication factor of every key it held BEFORE the swap
        commits: durable frames via ``KeyStore.replicate_to`` (the
        victim's store outlives its process), live keys via the
        anti-entropy pull against the post-eject ring.  Commits under
        a fresh epoch.  Also callable directly — the operator's
        force-eject; the grace only gates the AUTOMATIC path."""
        with self._op_lock:
            router = self._router
            if host_id not in router.map:
                # api-edge: membership contract (ejecting an unknown
                # host is a caller bookkeeping bug)
                raise ValueError(
                    f"host {host_id!r} is not in the ring "
                    f"({router.map.host_ids()})")
            new_ring = router.map.without_host(host_id)
            try:
                self._replicate_durable(new_ring, exclude={host_id})
                # Live convergence BEFORE the swap: every remaining
                # member pulls the frames the new ring places on it
                # that it does not hold yet (the victim's keys, from
                # their surviving replicas) — so the swap lands on a
                # ring that is already whole.  The victim is excluded
                # as a source (it is DOWN).
                peers = [h for h in router.map.host_ids()
                         if h != host_id]
                migrated = self._converge(peers, new_ring, peers,
                                          exclude={host_id})
            except Exception:  # fallback-ok: counted, re-raised — an
                # aborted change leaves the ring on its last committed
                # epoch; promotion keeps serving and a later pump
                # retries
                self._c_op_failures.inc()
                raise
            epoch = router.ring_epoch + 1
            router.set_ring(new_ring, epoch=epoch)
            # Post-swap sweep: a registration that raced the
            # pre-commit passes landed on the OLD placement; strictly-
            # newer pulls converge it onto the new one (idempotent —
            # an already-whole ring pulls nothing).  The change is
            # COMMITTED at this point: a sweep failure is counted and
            # left to a later convergence pass (anti-entropy is
            # idempotent) — raising here would skip the bookkeeping
            # below and report a committed change as aborted.
            try:
                migrated += self._converge(peers, new_ring, peers,
                                           exclude={host_id})
            except Exception:  # fallback-ok: counted; see above
                self._c_op_failures.inc()
            with self._state_lock:
                self._down_since.pop(host_id, None)
            self._c_ejects.inc()
            self._c_migrated.inc(migrated)
            self._g_ring_size.set(len(new_ring))
            return self._record("eject", host_id, epoch, migrated)

    def join(self, spec: ShardSpec, store=None) -> MembershipEvent:
        """Admit a new (or returning) host: dial it, warm it through
        the anti-entropy SYNC path against the PROSPECTIVE ring, and
        only then commit the swap under a fresh epoch — the first
        routed request finds every key the new ring places on the
        host already registered, generations preserved (no cold-miss
        storm).  ``store``: the host's ``KeyStore``, recorded for the
        durable half of future migrations.  A warm that fails aborts
        the join typed (counted); the ring is untouched."""
        with self._op_lock:
            router = self._router
            if spec.host_id in router.map:
                # api-edge: membership contract — re-admitting a live
                # member is a bookkeeping bug (an address change is
                # set_ring's job, not a join)
                raise ValueError(
                    f"host {spec.host_id!r} is already in the ring")
            if store is not None:
                self._stores[spec.host_id] = store
            prospective = router.map.with_host(spec)
            router.preconnect(spec)
            try:
                self._replicate_durable(prospective, exclude=set())
                migrated = self._converge(
                    [spec.host_id], prospective,
                    router.map.host_ids(), exclude=set())
            except Exception:  # fallback-ok: an aborted join must not
                # leave a half-warmed host admitted OR a dangling
                # link — the caller retries once the pod is reachable
                # again
                self._c_op_failures.inc()
                router.forget_host(spec.host_id)
                raise
            epoch = router.ring_epoch + 1
            router.set_ring(prospective, epoch=epoch)
            # The join-racing-registration sweep: a key registered
            # while the warm ran placed on the OLD ring; pull anything
            # strictly newer now that the newcomer is admitted.  The
            # host IS admitted at this point: a sweep failure is
            # counted and healed by a later convergence pass, never
            # re-raised (that would report a committed join as aborted
            # and make a retry die on the already-in-the-ring check).
            try:
                migrated += self._converge(
                    [spec.host_id], prospective,
                    [h for h in prospective.host_ids()
                     if h != spec.host_id], exclude=set())
            except Exception:  # fallback-ok: counted; see above
                self._c_op_failures.inc()
            self._c_joins.inc()
            self._c_migrated.inc(migrated)
            self._g_ring_size.set(len(prospective))
            return self._record("join", spec.host_id, epoch, migrated)

    def drain(self, host_id: str) -> MembershipEvent:
        """Gracefully decommission a LIVE host: migrate every frame it
        holds to its new-ring placement (the draining host is the
        primary source — this is planned, not failover), swap the ring
        under a fresh epoch (new placements stop at the commit), and
        keep the host's pool open for ``drain_grace_s`` so in-flight
        relayed requests complete against it; ``pump`` finishes the
        forget.  The process is safe to SIGTERM once ``draining()``
        no longer names it (drain its service, then
        ``EdgeServer.close(drain_s=)``)."""
        with self._op_lock:
            router = self._router
            if host_id not in router.map:
                # api-edge: membership contract
                raise ValueError(
                    f"host {host_id!r} is not in the ring "
                    f"({router.map.host_ids()})")
            if len(router.map) < 2:
                # api-edge: membership contract — draining the last
                # host would leave an empty ring with nowhere to
                # migrate TO; stop the pod instead
                raise ValueError(
                    "cannot drain the last host in the ring")
            new_ring = router.map.without_host(host_id)
            targets = new_ring.host_ids()
            sources = router.map.host_ids()  # the drainee included
            try:
                self._replicate_durable(new_ring, exclude=set())
                migrated = self._converge(targets, new_ring, sources,
                                          exclude=set())
            except Exception:  # fallback-ok: counted, re-raised — an
                # aborted drain leaves the host a full member on the
                # last committed epoch
                self._c_op_failures.inc()
                raise
            epoch = router.ring_epoch + 1
            router.set_ring(new_ring, epoch=epoch, retain={host_id})
            # Drain-racing-hot-swap sweep: a re-registration that
            # landed on the drainee between the migration pass and the
            # commit is strictly newer — pull it across now.  The swap
            # is COMMITTED: a sweep failure is counted and healed by a
            # later pass, never re-raised — the drain-grace bookkeeping
            # below MUST run or pump never forgets the retained pool
            # (a leaked link probed forever) and the operator never
            # learns the host is safe to stop.
            try:
                migrated += self._converge(targets, new_ring, sources,
                                           exclude=set())
            except Exception:  # fallback-ok: counted; see above
                self._c_op_failures.inc()
            with self._state_lock:
                self._draining[host_id] = self._clock() \
                    + self.drain_grace_s
                self._g_draining.set(len(self._draining))
            self._c_drains.inc()
            self._c_migrated.inc(migrated)
            self._g_ring_size.set(len(new_ring))
            return self._record("drain", host_id, epoch, migrated)

    # -- migration machinery ------------------------------------------

    def _converge(self, targets, ring: ShardMap, sources,
                  exclude: set) -> int:
        """Pull every frame ``ring`` places on each target that the
        target is behind on, from ``sources`` (strictly-newer,
        placement-filtered at the sender — ``Replicator.anti_entropy``
        with the membership override).  DOWN sources are skipped via
        ``peer_ok`` (their keys come from their replicas); a REACHABLE
        source failing mid-exchange raises, aborting the change — the
        conservative direction, same as the recovery gate."""
        router = self._router
        fire("membership.migrate", sorted(targets), len(ring))
        down = {h for h, st in router.health.states().items()
                if st == DOWN}
        moved = 0
        for target in targets:
            if target in exclude or target in down:
                continue
            moved += router.replicator.anti_entropy(
                target, ring=ring,
                peers=[h for h in sources if h != target],
                peer_ok=lambda h: h not in down and h not in exclude,
                timeout=self._timeout_s)
        return moved

    # holds-lock: _op_lock
    def _replicate_durable(self, ring: ShardMap, exclude: set) -> int:
        """The durable half of a migration: for every frame any known
        store holds, ensure each store of the frame's NEW placement
        holds it at the newest stored generation
        (``KeyStore.replicate_to`` — atomic publish, monotonic
        guard, bounded transient-retry).  ``exclude`` hosts are dead
        PROCESSES, not dead disks: their stores remain valid sources
        (that is what the durable tier is for), they are only never a
        DESTINATION.  Key-factory ``~pool/`` frames are host-local
        supply and never move.  A key no reachable store holds is
        counted lost (``membership_lost_keys_total``) — a churn run
        gates it at zero."""
        if not self._stores:
            return 0
        digests: dict[str, dict] = {}
        for host_id, st in self._stores.items():
            try:
                digests[host_id] = st.digest()
            except OSError:
                # A store whose digest cannot even be READ (dead disk
                # or mount — distinct from a dead PROCESS, whose
                # surviving on-disk store is the normal eject source)
                # is neither a source nor a destination this pass:
                # counted and skipped.  Aborting on it would wedge
                # every future membership change on a disk that may
                # never return, while promotion keeps the live keys
                # serving — the conservative-direction rule applies to
                # REACHABLE sources failing mid-copy, not to hosts
                # that are provably gone.
                self._c_store_unreachable.inc()
        newest: dict[str, int] = {}
        for digest in digests.values():
            for key_id, gen in digest.items():
                if key_id.startswith(_POOL_PREFIX):
                    continue
                if gen > newest.get(key_id, 0):
                    newest[key_id] = gen
        copied = 0
        for key_id in sorted(newest):
            gen = newest[key_id]
            # EVERY holder at the newest generation is a source
            # candidate: one failing (exhausted retries, quarantined
            # frame) falls through to the next replica before the
            # change aborts.
            srcs = sorted(h for h, d in digests.items()
                          if d.get(key_id) == gen)
            for dst in sorted(ring.placement_ids(
                    key_id, self._router.replicas)):
                if dst in exclude or dst not in digests:
                    continue
                if digests[dst].get(key_id, 0) >= gen:
                    continue
                done, last_exc = False, None
                for src in srcs:
                    if src == dst:
                        continue
                    try:
                        self._stores[src].replicate_to(
                            self._stores[dst], key_id)
                        done = True
                        break
                    except (OSError, BackendUnavailableError,
                            KeyQuarantinedError) as e:
                        # fallback-ok: next holder; re-raised below if
                        # every one fails
                        last_exc = e
                if done:
                    self._c_durable.inc()
                    copied += 1
                elif last_exc is not None:
                    # Every holder failed: the conservative abort —
                    # the change retries on a later pump.
                    raise last_exc
        return copied

    def lost_keys(self, exclude: set | None = None) -> list:
        """Durably-stored keys NO store outside ``exclude`` holds —
        the zero-loss audit a churn run makes after each change."""
        exclude = exclude or set()
        held: set = set()
        everywhere: set = set()
        # dcflint: disable=guarded-by read-only audit sweep: .items()
        # snapshots under the GIL; an audit racing a join may count or
        # miss the newcomer's store, and either answer is a valid
        # point-in-time audit (the caller re-polls)
        for host_id, store in self._stores.items():
            try:
                keys = {k for k in store.digest()
                        if not k.startswith(_POOL_PREFIX)}
            except OSError:
                # fallback-ok: an unreadable store contributes to
                # NEITHER side — we cannot know what it held; counted
                self._c_store_unreachable.inc()
                continue
            everywhere |= keys
            if host_id not in exclude:
                held |= keys
        lost = sorted(everywhere - held)
        with self._state_lock:
            # Count each loss ONCE across repeated audits (a monitor
            # polling this must not inflate the counter); a key that
            # heals and is lost AGAIN is a new loss and counts again.
            fresh = [k for k in lost if k not in self._lost_counted]
            if fresh:
                self._c_lost.inc(len(fresh))
            self._lost_counted.intersection_update(lost)
            self._lost_counted.update(fresh)
        return lost

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "MembershipController":
        """Spawn the control worker (idempotent): evaluates the eject
        grace and finishes drains every ``poll_interval_s``."""
        if self._worker is None or not self._worker.is_alive():
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._worker_loop, name="dcf-membership",
                daemon=True)
            self._worker.start()
        return self

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.pump()
            except Exception:  # fallback-ok: the control worker must
                # outlive any one round's failure (counted inside
                # pump's per-change containment where attributable)
                self._c_op_failures.inc()
            self._stop.wait(self.poll_interval_s)

    def close(self) -> None:
        self._stop.set()
        worker = self._worker
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            worker.join(5.0)
        self._worker = None

    def __repr__(self) -> str:
        return (f"MembershipController(ring={self._router.map.host_ids()},"
                f" epoch={self._router.ring_epoch}, "
                f"eject_grace_s={self.eject_grace_s}, "
                f"draining={sorted(self.draining())})")
