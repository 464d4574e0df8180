"""Lock-order watchdog: inversions detected without the interleave.

Counterpart of ``dcf_tpu/testing/lockwatch.py``, raising the port's
``LockOrderError``.  Its own module state: arming it patches
``threading.Lock`` / ``RLock`` as ``dcf_tpu``'s does, and the two
harnesses must not be armed at once.

Static lint proves that annotated state is touched under its lock;
what it cannot prove is the ORDER two locks are taken in across
threads — the classic inversion (thread 1: A then B; thread 2: B then
A) deadlocks only under the right interleave.  This module detects the
inversion WITHOUT needing the interleave, the way lockdep/TSan do:

* every lock created while the harness is armed is wrapped; each
  thread carries a stack of the watched locks it currently holds;
* a blocking acquire first records one directed edge ``held -> new``
  per currently-held lock into a global lock-order graph (the stack
  of the FIRST observation is kept per edge, so reports name real
  code, not the harness);
* an edge that would close a cycle raises a typed ``LockOrderError``
  — naming the cycle and where each edge was first observed —
  *before* the acquire blocks.

Identity is PER LOCK INSTANCE (two ``TokenBucket``\\ s' locks are
distinct nodes), so independent same-class locks never alias into
false cycles; the node name still carries the allocation site
(``file:line``).  Non-blocking (``blocking=False``) and
timeout-bounded acquires update the held stack but neither record
edges nor raise — a try-lock or bounded wait cannot deadlock.
Reentrant ``RLock`` re-acquires are depth counted, not re-recorded.

Usage::

    watch = lockwatch.arm()      # patches threading.Lock/RLock
    try:
        ...                      # run the threaded scenario
    finally:
        lockwatch.disarm(watch)  # restores; graph dies with watch

Only locks CREATED while armed are watched (the serve classes build
their locks in ``__init__``, so constructing the system under test
inside the armed window covers it).  ``threading.Condition`` built on
a watched ``RLock`` works unmodified: the wrapper exposes the
``_is_owned`` / ``_release_save`` / ``_acquire_restore`` protocol,
and a condition wait re-runs the order check on re-acquire.
"""

from __future__ import annotations

import threading
import traceback

from dcf_tpu_torch.errors import LockOrderError

__all__ = ["LockWatch", "WatchedLock", "WatchedRLock", "arm", "disarm"]

#: Frames kept per first-observation stack (enough to name the code
#: path without drowning the report in harness frames).
_STACK_LIMIT = 16


def _site() -> str:
    """Allocation site of the lock being constructed: the innermost
    frame outside this module and ``threading.py`` (this module by its
    path: a caller's file whose name also ends in ``lockwatch.py`` is a
    site like any other)."""
    for frame in reversed(traceback.extract_stack(limit=24)[:-2]):
        fn = frame.filename
        if fn != __file__ and not fn.endswith("threading.py"):
            return f"{fn.rsplit('/', 1)[-1]}:{frame.lineno}"
    return "<unknown>"


def _here() -> str:
    return "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-2])


class LockWatch:
    """One armed session's lock-order graph.

    Nodes are watched-lock instances (by construction sequence
    number); edges ``a -> b`` mean "some thread held ``a`` while
    blocking-acquiring ``b``", stamped with the stack of the first
    observation.  ``check_acquire`` is called by the wrappers before
    every blocking acquire and raises ``LockOrderError`` when the new
    edge would close a cycle."""

    def __init__(self) -> None:
        self._meta = threading.RLock()  # the watch's own bookkeeping
        self._tls = threading.local()
        self._seq = 0
        self._names: dict[int, str] = {}
        self._succ: dict[int, set[int]] = {}
        self._edge_stacks: dict[tuple[int, int], str] = {}
        self._orig_lock = None
        self._orig_rlock = None

    # -- registration -------------------------------------------------

    def _register(self) -> int:
        with self._meta:
            self._seq += 1
            node = self._seq
            self._names[node] = f"{_site()}#{node}"
            return node

    def _held(self) -> list[int]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- the detector -------------------------------------------------

    def _path(self, src: int, dst: int) -> list[int] | None:
        """A directed path src -> ... -> dst in the order graph, or
        None (iterative DFS; called under ``_meta``)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._succ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def check_acquire(self, node: int) -> None:
        """Record ``held -> node`` edges; raise on a cycle.  Runs
        BEFORE the blocking acquire, so the inversion is reported
        instead of reproduced."""
        held = self._held()
        if not held:
            return
        with self._meta:
            for h in held:
                if h == node or node in self._succ.get(h, ()):
                    continue  # reentrant/known edge: nothing new
                back = self._path(node, h)
                if back is not None:
                    cycle = [self._names[n] for n in back]
                    edges = []
                    for a, b in zip(back, back[1:]):
                        edges.append(
                            f"--- edge {self._names[a]} -> "
                            f"{self._names[b]} first observed at:\n"
                            f"{self._edge_stacks.get((a, b), '?')}")
                    raise LockOrderError(
                        f"lock-order inversion: acquiring "
                        f"{self._names[node]} while holding "
                        f"{self._names[h]}, but the recorded order is "
                        f"{' -> '.join(cycle)} (acquiring here would "
                        "close the cycle; under the right interleave "
                        "this deadlocks)",
                        cycle=tuple(cycle + [self._names[node]]),
                        stacks=tuple(edges + [
                            f"--- closing acquire at:\n{_here()}"]))
                self._succ.setdefault(h, set()).add(node)
                self._edge_stacks[(h, node)] = _here()

    # -- held-stack bookkeeping (wrappers call these) -------------------

    def push(self, node: int) -> None:
        self._held().append(node)

    def pop(self, node: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == node:
                del held[i]
                return


class WatchedLock:
    """A ``threading.Lock`` recording acquisition order (see module
    docstring).  Non-blocking and timeout acquires skip the order
    check — they cannot deadlock — but still maintain the held
    stack."""

    def __init__(self, watch: LockWatch, inner):
        self._watch = watch
        self._inner = inner
        self._node = watch._register()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking and timeout == -1:
            self._watch.check_acquire(self._node)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._watch.push(self._node)
        return got

    def release(self) -> None:
        self._inner.release()
        self._watch.pop(self._node)

    def locked(self) -> bool:
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return (f"<WatchedLock {self._watch._names[self._node]} "
                f"wrapping {self._inner!r}>")


class WatchedRLock:
    """A ``threading.RLock`` with order recording and the
    ``Condition`` wait protocol (``_is_owned`` / ``_release_save`` /
    ``_acquire_restore``).  Reentrant re-acquires are depth-counted by
    the owning thread and never re-recorded."""

    def __init__(self, watch: LockWatch, inner):
        self._watch = watch
        self._inner = inner
        self._node = watch._register()
        self._owner: int | None = None
        self._count = 0

    def _mine(self) -> bool:
        return self._owner == threading.get_ident()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._mine():
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._count += 1
            return got
        if blocking and timeout == -1:
            self._watch.check_acquire(self._node)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count = 1
            self._watch.push(self._node)
        return got

    def release(self) -> None:
        mine = self._mine()
        self._inner.release()
        if mine:
            self._count -= 1
            if self._count == 0:
                self._owner = None
                self._watch.pop(self._node)

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol -------------------------------------------

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        saved = (self._owner, self._count)
        self._owner, self._count = None, 0
        self._watch.pop(self._node)
        return (state, saved)

    def _acquire_restore(self, state) -> None:
        inner_state, (owner, count) = state
        self._watch.check_acquire(self._node)
        self._inner._acquire_restore(inner_state)
        self._owner, self._count = owner, count
        self._watch.push(self._node)

    def __repr__(self) -> str:
        return (f"<WatchedRLock {self._watch._names[self._node]} "
                f"wrapping {self._inner!r}>")


_armed: LockWatch | None = None


def arm() -> LockWatch:
    """Patch ``threading.Lock``/``threading.RLock`` so every lock
    created from now on is watched; returns the watch.  One armed
    session at a time (nesting would tangle the restore order)."""
    global _armed
    if _armed is not None:
        raise ValueError(
            "lockwatch is already armed; disarm the previous watch "
            "first (one session at a time)")
    watch = LockWatch()
    watch._orig_lock = threading.Lock
    watch._orig_rlock = threading.RLock

    def make_lock():
        return WatchedLock(watch, watch._orig_lock())

    def make_rlock():
        return WatchedRLock(watch, watch._orig_rlock())

    threading.Lock = make_lock
    threading.RLock = make_rlock
    _armed = watch
    return watch


def disarm(watch: LockWatch) -> None:
    """Restore the real lock factories.  Watched locks already handed
    out keep working (they wrap real locks); only the graph stops
    growing new nodes."""
    global _armed
    if watch._orig_lock is not None:
        threading.Lock = watch._orig_lock
        threading.RLock = watch._orig_rlock
    if _armed is watch:
        _armed = None
