"""Typed error taxonomy of the PyTorch port.

Counterpart of ``dcf_tpu/errors.py``, every class of it, with the same class names and bases so that a caller's
``except`` clauses carry over between the two packages.  Each class also
inherits the builtin exception a plain check would raise (``ValueError`` /
``RuntimeError``), so ``except ValueError`` call sites keep working.

    DcfError
      +-- KeyFormatError          (ValueError)   corrupt/truncated/alien key frame
      +-- ShapeError              (ValueError)   array shape/dtype contract
      +-- BackendUnavailableError (RuntimeError) no backend or device can serve
      +-- StaleStateError         (RuntimeError) staged state outlived its bundle
      +-- NativeBuildError        (RuntimeError) C++ core build/load failed
      +-- QueueFullError          (RuntimeError) admission shed a request
      +-- DeadlineExceededError   (TimeoutError) a queued request expired
      +-- CircuitOpenError        (RuntimeError) a key's breaker is open
      +-- KeyQuarantinedError     (RuntimeError) a stored frame was set aside
      +-- BatchTimeoutError       (TimeoutError) a served batch overran
      +-- RingEpochError          (RuntimeError) a stale ring epoch
      +-- StandbyExhaustedError   (RuntimeError) no standby host to admit
      +-- LockOrderError          (RuntimeError) a lock-order inversion
      +-- MeshUnavailableError    (RuntimeError) co-evaluation cannot run

    BackendFallbackWarning (UserWarning)  a slower, bit-exact path serves
"""

from __future__ import annotations

__all__ = [
    "DcfError",
    "KeyFormatError",
    "ShapeError",
    "BackendUnavailableError",
    "StaleStateError",
    "NativeBuildError",
    "QueueFullError",
    "DeadlineExceededError",
    "CircuitOpenError",
    "KeyQuarantinedError",
    "BatchTimeoutError",
    "RingEpochError",
    "StandbyExhaustedError",
    "LockOrderError",
    "MeshUnavailableError",
    "BackendFallbackWarning",
]


class DcfError(Exception):
    """Base class of every typed framework error."""


class KeyFormatError(DcfError, ValueError):
    """A serialized key bundle failed validation (bad magic, unsupported
    version, truncated/oversized frame, CRC mismatch)."""


class ShapeError(DcfError, ValueError):
    """An array violated the bundle/batch shape or dtype contract."""


class BackendUnavailableError(DcfError, RuntimeError):
    """No execution backend could serve the request: the requested device
    is absent (CUDA asked for on a host without it) or a kernel could not
    be built or loaded."""


class StaleStateError(DcfError, RuntimeError):
    """Device state is missing or out of date for the requested eval:
    staged points were cut for a bundle geometry the backend no longer
    holds (re-stage), or no bundle was shipped (``eval`` before
    ``put_bundle``)."""


class NativeBuildError(DcfError, RuntimeError):
    """The C++ host core (``dcf_tpu_torch.native``) failed to build or
    load."""


class QueueFullError(DcfError, RuntimeError):
    """The serving layer's admission control shed a request: the
    queued-points bound was hit (overload — back off and retry), the
    service is in brownout and refused a low-priority class, or the
    service is draining/closed.  Usually
    raised at ``submit`` time; the one post-acceptance spelling is
    eviction — an already-queued lower-priority request completed with
    this error through its future because a higher-priority submit
    needed its room.

    ``retry_after_s``: the caller-facing backoff hint, or
    ``None`` when no principled one exists (a draining service never
    comes back).  Populated from the refusal's own state — brownout
    hysteresis (``brownout_clear_s``: the calm the controller needs
    before it re-admits BATCH) or queue pressure (about one coalescing
    drain).

    ``evicted``: True for the post-acceptance spelling (the request
    WAS admitted — and counted — before a higher-priority submit took
    its room).  Load accounting needs the distinction: an evicted
    request appears in ``serve_requests_total``, a submit-time shed
    does not."""

    def __init__(self, *args, retry_after_s: float | None = None,
                 evicted: bool = False):
        super().__init__(*args)
        self.retry_after_s = retry_after_s
        self.evicted = evicted


class DeadlineExceededError(DcfError, TimeoutError):
    """An accepted request's deadline expired before its batch was
    dispatched; the request was dropped without evaluation (a late share
    is a useless share in an online 2PC round).  Surfaces through the
    request's result handle, not at ``submit``."""


class CircuitOpenError(DcfError, RuntimeError):
    """The per-(key_id, backend-family) circuit breaker is open: the
    backend family serving this key crossed its consecutive-failure
    threshold and the cooldown has not elapsed, so the request fails
    fast instead of re-entering a backend known to be dying (which
    would burn retry budget and deadline headroom for every queued
    request behind it).  CRITICAL-priority traffic bypasses the open
    state; after the cooldown one probe half-opens the breaker and its
    outcome decides between closing and re-opening.  Surfaces through
    the request's result handle (``serve.breaker``).

    ``retry_after_s``: the remaining cooldown of the open
    breaker (``BreakerBoard.retry_after`` — when it elapses the next
    request becomes the half-open probe), a hint that tracks the actual
    recovery schedule.  ``None`` when the breaker state was not
    consulted."""

    def __init__(self, *args, retry_after_s: float | None = None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class KeyQuarantinedError(DcfError, RuntimeError):
    """A durable key-store frame failed validation when read back (bad
    magic, truncated payload, CRC mismatch — see ``KeyFormatError`` for
    the underlying rejection, carried as ``__cause__``) and was set
    aside: the file is renamed to ``<name>.quarantined-<n>`` and its
    manifest entry dropped, so the damage is preserved for forensics
    and the next restore does not trip over it again.  Raised by
    ``serve.store.KeyStore.load``; ``KeyRegistry.restore`` catches it
    PER KEY and records the quarantine in its report — one corrupt
    frame is never silently skipped and never fatal to the other keys
    (``serve.store``)."""


class BatchTimeoutError(DcfError, TimeoutError):
    """A dispatched serve batch overran the ``batch_timeout_s`` wall
    deadline on the injectable clock (a wedged backend: the eval
    neither completed nor errored in time).  The hung-batch watchdog
    fails the batch typed, records a failure outcome against its
    (key, backend) breaker (``serve.breaker``), and sends it
    down the same retry/invalidation path a plain batch failure takes —
    so a backend that hangs instead of crashing still re-stages (on the
    same backend in this package, which never demotes), still opens its
    breaker, and still stops stalling the worker while the
    queue sheds behind it (``serve.service``)."""


class RingEpochError(DcfError, RuntimeError):
    """A frame carried a ring epoch OLDER than one this shard has
    already observed: the sender routed on a stale membership view, and
    the shard refuses it rather than serve a key from two conflicting
    placements (``DcfService.check_ring_epoch``; ``E_EPOCH`` on the
    wire).

    ``retry_after_s``: the caller-facing backoff hint."""

    def __init__(self, *args, retry_after_s: float | None = None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class StandbyExhaustedError(DcfError, RuntimeError):
    """An explicit scale-out found the declared standby pool empty:
    there is no host to admit (``serve.capacity.CapacityController.
    scale_out``).  The edge declares it internal-only: it has no wire
    code."""


class LockOrderError(DcfError, RuntimeError):
    """A lock acquisition would close a cycle in the observed
    lock-order graph (``testing.lockwatch``, a test-harness
    detector).  Carries ``cycle`` (the lock names along the inversion)
    and ``stacks`` (where each edge was first observed).  It has no
    wire code: it fires in test harnesses, never at a serving edge."""

    def __init__(self, message: str, *, cycle: tuple = (),
                 stacks: tuple = ()):
        super().__init__(message)
        self.cycle = tuple(cycle)
        self.stacks = tuple(stacks)


class MeshUnavailableError(DcfError, RuntimeError):
    """The router's co-evaluation tier cannot take this batch: a mesh
    worker is DOWN or suspect, the mesh group's formation epoch trails
    the ring, or no group is formed while the caller forced
    co-evaluation (``co_eval="always"``).  Route-mode still serves:
    under ``co_eval="auto"`` the router absorbs this error itself and
    degrades the batch (counted ``router_mesh_degraded_total``, warned
    ``BackendFallbackWarning``).

    ``retry_after_s``: one health-probe interval.  Crosses the wire as
    its own code (``E_MESH_UNAVAILABLE``)."""

    def __init__(self, *args, retry_after_s: float | None = None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class BackendFallbackWarning(UserWarning):
    """The framework degraded to a slower-but-correct path.

    Structured: ``failed`` (what was tried), ``fallback`` (what now
    serves), ``cause`` (the triggering exception, possibly None).
    """

    def __init__(self, failed: str, fallback: str,
                 cause: BaseException | None = None):
        self.failed = failed
        self.fallback = fallback
        self.cause = cause
        detail = (f" ({type(cause).__name__}: {cause})"
                  if cause is not None else "")
        super().__init__(
            f"backend {failed!r} unavailable{detail}; falling back to "
            f"{fallback!r}")
