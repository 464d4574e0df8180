"""The port's lock-order watchdog (``dcf_tpu_torch.testing.lockwatch``)
against ``dcf_tpu``'s.

Each scripted lock program of ``tests/test_lockwatch.py`` runs through
the port's harness and, for comparison, through ``dcf_tpu``'s: a seeded
inversion raises before the closing acquire blocks and names the same
cycle (the same allocation sites, the same order), a consistent order
stays silent, identity is per instance, try-locks and bounded acquires
are not checked, ``RLock`` and ``Condition`` work, ``queue`` and
``Event`` survive the armed window, a double arm is rejected and disarm
restores.  Then the port's harness is armed over a port pod running a
membership script (eject, join, drain) and a short threaded loop of
routed requests, and no ``LockOrderError`` is raised.

The harness is armed by this module's fixture, not by the ``lockwatch``
marker (which arms ``dcf_tpu``'s harness).  Every wait is bounded."""

from __future__ import annotations

import queue
import re
import threading

import numpy as np
import pytest

from dcf_tpu.errors import LockOrderError as JLockOrderError
from dcf_tpu.testing import lockwatch as jlockwatch

from dcf_tpu_torch.errors import DcfError, LockOrderError
from dcf_tpu_torch.testing import lockwatch
from tests.torch_net import (
    PORT,
    WAIT_S,
    Pod,
    make_bundle,
    oracle,
    points,
    service,
)
from tests.torch_locks import inversion
from tests.torch_threads import one_torch_thread  # noqa: F401

HARNESSES = {"port": (lockwatch, LockOrderError),
             "dcf_tpu": (jlockwatch, JLockOrderError)}


@pytest.fixture(params=sorted(HARNESSES))
def armed(request):
    """One package's harness, armed for the test and disarmed after."""
    lw, err = HARNESSES[request.param]
    watch = lw.arm()
    try:
        yield request.param, lw, err
    finally:
        lw.disarm(watch)


def _sites(cycle) -> list:
    """The cycle's allocation sites, ``file:line`` without the
    per-instance sequence number."""
    return [re.sub(r"#\d+$", "", name) for name in cycle]


def test_seeded_inversion_detected_same_cycle_as_dcf_tpu():
    """The canonical two-lock inversion through both harnesses: each
    raises its own typed error before the acquire blocks, and both name
    the same cycle (A -> B -> A at the same lines of
    ``tests/torch_locks.py``)."""
    cycles = {}
    for name, (lw, err_type) in sorted(HARNESSES.items()):
        watch = lw.arm()
        try:
            err = inversion(err_type)
        finally:
            lw.disarm(watch)
        assert len(err.cycle) == 3 and err.cycle[0] == err.cycle[-1]
        assert all("#" in n for n in err.cycle)
        assert err.stacks and "closing acquire" in err.stacks[-1]
        assert "first observed" in err.stacks[0]
        cycles[name] = _sites(err.cycle)
    assert cycles["port"] == cycles["dcf_tpu"]
    assert all(s.startswith("torch_locks.py:") for s in cycles["port"])


def test_port_error_is_typed_and_rooted():
    watch = lockwatch.arm()
    try:
        err = inversion(LockOrderError)
    finally:
        lockwatch.disarm(watch)
    assert isinstance(err, DcfError) and isinstance(err, RuntimeError)
    assert "lock-order inversion" in str(err)


def test_consistent_order_stays_silent(armed):
    _, _, err_type = armed
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    errors = []

    def worker():
        try:
            for _ in range(50):
                with lock_a:
                    with lock_b:
                        pass
        except err_type as e:  # pragma: no cover - the failure
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert errors == []


def test_per_instance_identity_no_alias(armed):
    def make_pair():
        return threading.Lock(), threading.Lock()

    a1, b1 = make_pair()
    a2, b2 = make_pair()
    with a1:
        with b1:
            pass
    with b2:  # the reverse order, but on distinct instances
        with a2:
            pass


def test_trylock_and_bounded_acquire_skip_the_check(armed):
    _, _, err_type = armed
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    with lock_a:
        with lock_b:
            pass
    with lock_b:
        assert lock_a.acquire(timeout=0.2)  # against the order: allowed
        lock_a.release()
        assert lock_a.acquire(blocking=False)
        lock_a.release()
        with pytest.raises(err_type):
            lock_a.acquire()  # the blocking spelling is still refused


def test_rlock_reentrancy_and_condition_protocol(armed):
    _, lw, _ = armed
    rlock = threading.RLock()
    assert isinstance(rlock, lw.WatchedRLock)
    with rlock:
        with rlock:  # reentrant: no edge, no error
            assert rlock._count == 2
    assert rlock._count == 0
    cond = threading.Condition(threading.RLock())
    log = []

    def waiter():
        with cond:
            while not log:
                cond.wait(1.0)
            log.append("woke")

    worker = threading.Thread(target=waiter)
    worker.start()
    with cond:
        log.append("go")
        cond.notify()
    worker.join(WAIT_S)
    assert log == ["go", "woke"]


def test_queue_and_event_survive_armed_window(armed):
    q = queue.Queue()
    ev = threading.Event()

    def producer():
        q.put("payload")
        ev.set()

    worker = threading.Thread(target=producer)
    worker.start()
    assert q.get(timeout=5.0) == "payload"
    assert ev.wait(5.0)
    worker.join(5.0)


def test_double_arm_rejected(armed):
    _, lw, _ = armed
    with pytest.raises(ValueError):
        lw.arm()


def test_unarmed_locks_are_native():
    assert not isinstance(threading.Lock(), lockwatch.WatchedLock)
    assert "lock" in type(threading.Lock()).__name__.lower()


def test_disarm_restores_and_watched_locks_keep_working():
    watch = lockwatch.arm()
    try:
        survivor = threading.Lock()
        assert isinstance(survivor, lockwatch.WatchedLock)
    finally:
        lockwatch.disarm(watch)
    assert not isinstance(threading.Lock(), lockwatch.WatchedLock)
    with survivor:
        assert survivor.locked()
    assert not survivor.locked()


@pytest.fixture
def port_watch():
    """The port's harness armed around one test (the pod is built
    inside the armed window, so its locks are watched)."""
    watch = lockwatch.arm()
    try:
        yield watch
    finally:
        lockwatch.disarm(watch)


def test_port_pod_membership_script_under_lockwatch(port_watch):
    """A port pod under the port's armed harness: routed requests from
    three threads, then an eject after the grace, a warm join and a
    drain with its deferred forget.  Every lock order the pod takes is
    acyclic (no ``LockOrderError``) and every share equals the
    oracle."""
    from dcf_tpu_torch.serve import MembershipController
    from dcf_tpu_torch.serve.health import DOWN
    from dcf_tpu_torch.testing.faults import FakeClock

    rng = np.random.default_rng(0x10C)
    bundles = {f"lw-key-{i}": make_bundle(rng) for i in range(4)}
    pod = Pod(PORT, PORT, n=4, bundles=bundles)
    clk = FakeClock(50.0)
    ctrl = MembershipController(pod.router, clock=clk, eject_grace_s=1.0,
                                drain_grace_s=0.5, min_hosts=2)
    assert isinstance(ctrl._op_lock, lockwatch.WatchedLock)
    errors = []

    def loop(i):
        crng = np.random.default_rng(100 + i)
        names = sorted(bundles)
        for _ in range(6):
            name = names[int(crng.integers(0, len(names)))]
            xs = points(crng, 4)
            try:
                b = int(crng.integers(0, 2))
                y = pod.router.evaluate(name, xs, b=b, timeout=WAIT_S,
                                        priority="critical")
                assert np.array_equal(y, oracle(bundles[name], b, xs))
            except LockOrderError as e:  # pragma: no cover - the failure
                errors.append(e)

    try:
        threads = [threading.Thread(target=loop, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        victim = "shard-1"
        pod.kill(victim)
        assert pod.pump_until(victim, DOWN)
        assert ctrl.pump() == []
        clk.advance(1.5)
        assert [e.kind for e in ctrl.pump()] == ["eject"]
        svc = service(PORT)
        edge = PORT.edge.EdgeServer(svc).start()
        try:
            new = PORT.serve.ShardSpec("shard-9", *edge.address)
            assert ctrl.join(new).kind == "join"
            assert ctrl.drain("shard-0").kind == "drain"
            clk.advance(1.0)
            assert [e.kind for e in ctrl.pump()] == ["drain-complete"]
            for name, kb in bundles.items():
                xs = points(rng, 5)
                for b in (0, 1):
                    assert np.array_equal(
                        pod.router.evaluate(name, xs, b=b, timeout=WAIT_S),
                        oracle(kb, b, xs))
        finally:
            edge.close()
            svc.close(drain=False)
        assert errors == []
        assert ctrl.lost_keys() == []
    finally:
        ctrl.close()
        pod.close()
