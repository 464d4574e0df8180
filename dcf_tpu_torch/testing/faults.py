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
conditionally (``fail_unless``).  The JAX package's fault schedules, fake
clock, partition and torn-write handlers come with the serving layer
(ROADMAP.md slice 9).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

__all__ = ["POINTS", "InjectedFault", "fire", "is_armed", "inject",
           "fail_unless"]


class InjectedFault(Exception):
    """The default exception raised by an armed fault point."""


#: The named seams the port's code exposes.  ``inject`` rejects unknown
#: names, so a typo in a test fails loudly instead of silently not arming.
POINTS = (
    "serve.eval",  # one served evaluation attempt (workloads/pir.py;
    #                handler args: key_id, number of keys in the bundle)
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
