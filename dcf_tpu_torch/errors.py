"""Typed error taxonomy of the PyTorch port.

Counterpart of ``dcf_tpu/errors.py`` (the classes at its lines 91-118 and
289-303), with the same class names and bases so that a caller's
``except`` clauses carry over between the two packages.  Each class also
inherits the builtin exception a plain check would raise (``ValueError`` /
``RuntimeError``), so ``except ValueError`` call sites keep working.

    DcfError
      +-- KeyFormatError          (ValueError)   corrupt/truncated/alien key frame
      +-- ShapeError              (ValueError)   array shape/dtype contract
      +-- BackendUnavailableError (RuntimeError) no backend or device can serve
      +-- StaleStateError         (RuntimeError) staged state outlived its bundle
      +-- NativeBuildError        (RuntimeError) C++ core build/load failed

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
