"""Fault-injection harness: named failure points, armed per test.

Counterpart of the core of ``dcf_tpu/testing/faults.py`` (its lines
81-252): ``InjectedFault``, ``fire``, ``is_armed``, ``fail_unless`` and
``inject``.  Production seams call ``fire(point, *args)`` where the real
failure would surface; unarmed, that is a dict lookup and a return.  Armed
through the ``inject`` context manager, it runs the test's handler, which
raises, and the failure reaches the caller (no seam of the port falls back
to another path):

    from dcf_tpu_torch.testing import faults

    with faults.inject("serve.eval"):
        server.answer("q", 0)        # every attempt fails -> InjectedFault

Handlers receive ``fire``'s positional arguments and may raise
conditionally (``fail_unless``).

The serving tier's handlers (its lines 255-409): ``FakeClock``, the
injectable clock the service, admission queue, breakers and key factory
take; ``Schedule`` / ``inject_schedule`` (fail the first N fires, then
recover); ``flaky(rate, seed)``; ``latency(clock, s)``, the slow-backend
seam that advances a ``FakeClock`` instead of sleeping;
``torn_write(nbytes)`` for the durable store's ``store.write`` /
``store.manifest`` seams (a partial frame made durable); ``partition``,
the handler of the edge's ``net.partition`` seam; and ``corrupt``, the
one-byte DCFK mutator.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

__all__ = ["POINTS", "InjectedFault", "fire", "is_armed", "inject",
           "fail_unless", "corrupt", "FakeClock", "Schedule",
           "inject_schedule", "flaky", "latency", "partition",
           "torn_write"]


class InjectedFault(Exception):
    """The default exception raised by an armed fault point."""


#: The named seams the port's code exposes.  ``inject`` rejects unknown
#: names, so a typo in a test fails loudly instead of silently not arming.
POINTS = (
    "serve.stage",  # host->device batch staging (serve/service.py;
    #                 handler args: key_id, batch points)
    "serve.eval",  # one served evaluation attempt (serve/service.py:
    #                handler args key_id, batch points; workloads/pir.py:
    #                key_id, number of keys in the bundle)
    "store.write",  # durable key-frame publish (serve/store.py: after the
    #                 temp file's write + fsync, before the atomic rename;
    #                 handler args: key_id, tmp_path.  Raise = a crash
    #                 before the rename; torn_write = a partial write
    #                 made durable)
    "store.manifest",  # the manifest's publish, the same seam (handler
    #                    args: "", tmp_path)
    "keyfactory.refill",  # one key-factory refill batch, before any key
    #                       is minted (serve/keyfactory.py; handler args:
    #                       pool name, batch count)
    "keygen.device",  # keygen on the device, before its kernels run
    #                   (gen.gen_on_device, protocols.dpf.dpf_gen_on_device;
    #                   handler args: number of keys, lam)
    "native.build",  # one build of the C++ core (native.build; handler
    #                  args: portable)
    "native.load",  # loading a built C++ core (native.load; handler args:
    #                 portable)
    "protocols.combine",  # one pairwise share combine (protocols.combine;
    #                       handler args: intervals m, points, -1 on the
    #                       staged combine on the device)
    "edge.accept",  # the network edge's accept loop (serve/edge.py, before
    #                 each accept(); no handler args.  A raising handler
    #                 models a transient accept failure: the loop counts
    #                 it, edge_accept_errors_total, and keeps accepting)
    "edge.read",  # one socket read on an edge connection (serve/edge.py;
    #               handler args: peer tag, bytes wanted.  A raising
    #               handler kills that one connection, typed; latency(clock,
    #               s) here is the slow-client seam)
    "membership.migrate",  # one live-convergence pass of a ring change
    #                        (serve/membership.py, before any frame moves;
    #                        handler args: sorted target host ids, the new
    #                        ring's size.  A raising handler models a
    #                        migration source dying mid-change: the eject,
    #                        join or drain aborts typed and counted,
    #                        membership_change_failures_total, the ring
    #                        stays on its last committed epoch, and a later
    #                        pump retries it)
    "capacity.decide",  # one capacity-controller tick, after its verdict
    #                     is computed and before the hysteresis acts on it
    #                     (serve/capacity.py; handler args: the verdict's
    #                     kind, the CapacityVerdict.  Raising
    #                     capacity.ForcedVerdict(kind) forces that kind for
    #                     the tick; any other raise freezes the tick,
    #                     counted capacity_skips_total{reason=frozen})
    "mesh.collective",  # one co-evaluated router batch, before any slice
    #                     is scattered (serve/router.py; handler args: batch
    #                     points, worker count.  A raising handler models a
    #                     mesh that cannot form: the batch degrades to
    #                     route-mode, or MeshUnavailableError when the caller
    #                     forced co-evaluation)
    "mesh.provision",  # device enumeration of a mesh
    #                    (parallel.mesh.make_mesh / make_pod_mesh; no
    #                    handler args.  A raising handler models a dead
    #                    driver: BackendUnavailableError, typed)
    "net.partition",  # one dial or frame send of a tagged EdgeClient
    #                   (serve/edge.py; handler args: local tag, peer tag.
    #                   ``partition({...})`` is the canonical handler: its
    #                   OSError is contained as transport death)
)

_ACTIVE: dict[str, Callable] = {}


def fire(point: str, *args) -> None:
    """Production seam: run the armed handler for ``point``, if any."""
    handler = _ACTIVE.get(point)
    if handler is not None:
        handler(*args)


def is_armed(point: str) -> bool:
    return point in _ACTIVE


def fail_unless(ok: Callable[..., bool],
                exc: BaseException | None = None) -> Callable:
    """Handler factory: raise unless ``ok(*fire_args)`` is true."""

    def handler(*args):
        if not ok(*args):
            raise exc if exc is not None else InjectedFault(
                f"injected fault (args={args!r})")

    return handler


@contextmanager
def inject(point: str, exc: BaseException | None = None,
           handler: Callable | None = None):
    """Arm ``point`` for the duration of the block.

    By default every fire raises ``InjectedFault`` (or ``exc``); pass
    ``handler`` for conditional failures.  Nested injections restore the
    previous handler on exit.
    """
    if point not in POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; known points: {POINTS}")
    if handler is None:
        e = exc if exc is not None else InjectedFault(
            f"injected fault at {point!r}")

        def handler(*_args):
            raise e

    prev = _ACTIVE.get(point)
    _ACTIVE[point] = handler
    try:
        yield
    finally:
        if prev is None:
            _ACTIVE.pop(point, None)
        else:
            _ACTIVE[point] = prev


class FakeClock:
    """Deterministic injectable clock (seconds).  The canonical fake for
    every ``clock=``-taking serve component; ``latency`` advances it to
    model a slow backend without sleeping."""

    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"a monotonic clock cannot go back ({dt})")
        self.t += dt


class Schedule:
    """Fail-window handler state: raises for the first ``window_evals``
    fires, passes through after — the sustained-then-recovered failure
    one-shot handlers cannot express.  ``fired``/``failed`` expose how
    much of the window a scenario actually consumed."""

    def __init__(self, window_evals: int, exc: BaseException | None = None):
        if window_evals < 0:
            raise ValueError(
                f"window_evals must be >= 0, got {window_evals}")
        self.window_evals = int(window_evals)
        self.exc = exc
        self.fired = 0
        self.failed = 0

    @property
    def recovered(self) -> bool:
        """Has the failure window been fully consumed?"""
        return self.failed >= self.window_evals

    def __call__(self, *args) -> None:
        self.fired += 1
        if self.failed < self.window_evals:
            self.failed += 1
            raise self.exc if self.exc is not None else InjectedFault(
                f"injected fault {self.failed}/{self.window_evals} "
                f"of the scheduled window (args={args!r})")


@contextmanager
def inject_schedule(point: str, *, window_evals: int,
                    exc: BaseException | None = None):
    """Arm ``point`` with a fail-``window_evals``-then-recover schedule;
    yields the ``Schedule`` for fire/fail-count assertions."""
    sched = Schedule(window_evals, exc)
    with inject(point, handler=sched):
        yield sched


def flaky(rate: float, seed: int,
          exc: BaseException | None = None) -> Callable:
    """Handler factory: fail a seeded-RNG ``rate`` fraction of fires.
    Deterministic per ``(rate, seed)`` — reruns replay the exact same
    failure pattern, so chaos assertions can be exact."""
    import numpy as np

    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    rng = np.random.default_rng(seed)

    def handler(*args):
        if rng.random() < rate:
            raise exc if exc is not None else InjectedFault(
                f"injected flaky fault (rate={rate}, args={args!r})")

    return handler


def latency(clock: FakeClock, seconds: float,
            then: Callable | None = None) -> Callable:
    """Handler factory: each fire advances the injectable ``clock`` by
    ``seconds`` — the slow-backend seam.  No sleep is involved: deadline
    expiry and brownout hysteresis react to the CLOCK, so advancing it
    is indistinguishable from the eval actually taking that long.
    ``then`` chains another handler (e.g. a ``Schedule``) after the
    advance for slow-AND-failing backends."""
    if seconds < 0:
        raise ValueError(f"latency must be >= 0, got {seconds}")

    def handler(*args):
        clock.advance(seconds)
        if then is not None:
            then(*args)

    return handler


def torn_write(nbytes: int) -> Callable:
    """Handler factory for the ``store.write``/``store.manifest`` seams:
    truncate the not-yet-renamed temp file to ``nbytes`` and RETURN, so
    the atomic rename proceeds and the torn frame becomes durable — the
    on-disk state a power cut mid-flush (or an fsync that lied) leaves
    behind.  The quarantine path, not the writer, must absorb it."""
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")

    def handler(_key_id, path, *_args):
        with open(path, "r+b") as fh:
            fh.truncate(nbytes)

    return handler


def partition(pairs, *, clock: Callable[[], float] | None = None,
              window: tuple[float, float] | None = None) -> Callable:
    """Handler factory for the ``net.partition`` seam: deny
    every frame between the named host pairs.  ``pairs`` is an iterable
    of ``(a, b)`` tag pairs, symmetric — ``("router", "shard-0")`` cuts
    both directions of that link.  The handler raises ``OSError`` (what
    a dropped frame looks like to a socket client), which the edge
    client contains as transport death: pending futures fail typed,
    the routing tier marks the peer suspect, health probes start
    failing — the partition is observable only through the same typed
    taxonomy a real one would produce.

    ``clock`` + ``window=(start, end)``: deny only while
    ``start <= clock() < end`` — the healable-partition window the
    partition/flap soaks drive (heal = the clock leaving the window;
    no un-arming race with in-flight requests).  The window is read at
    every frame, so a list's end may be set while the cut holds."""
    cut = {frozenset(p) for p in pairs}
    if any(len(p) != 2 for p in cut):
        raise ValueError(f"partition pairs must name two hosts: {pairs}")
    if (clock is None) != (window is None):
        raise ValueError("clock and window arm the healable window "
                         "together (pass both or neither)")

    def handler(src: str, dst: str, *_args) -> None:
        if frozenset((src, dst)) not in cut:
            return
        if window is not None:
            now = clock()
            if not window[0] <= now < window[1]:
                return
        raise OSError(
            f"injected network partition: {src!r} <-> {dst!r} is cut")

    return handler


def corrupt(data: bytes, offset: int, xor: int = 0x01) -> bytes:
    """Flip bit(s) of one byte — the canonical DCFK corruption mutator."""
    if not 0 <= offset < len(data):
        raise ValueError(f"offset {offset} outside frame of {len(data)} bytes")
    if not 1 <= xor <= 0xFF:
        raise ValueError("xor must flip at least one bit (1..255)")
    buf = bytearray(data)
    buf[offset] ^= xor
    return bytes(buf)
