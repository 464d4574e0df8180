"""Device provisioning for the port's entry points and bench CLI.

Counterpart of ``dcf_tpu/utils/provision.py``.  There, provisioning means
JAX's platform flags and its persistent compile cache; here it means the
card a run goes to and the CUDA kernels' build directory:

- ``select_device(spec)`` turns ``cuda``, ``cuda:N`` or ``cpu`` into a
  ``torch.device``: the one device rule of every entry point
  (``backends._common.resolve_device``).  A CUDA request on a host
  without that device raises ``BackendUnavailableError``: nothing falls
  back to the CPU.
- ``repo_cache_dir()`` names the directory the kernels are built into
  (``_build.BUILD_DIR``, listed in ``.gitignore``).
- ``enable_kernel_cache(names)`` builds the listed kernels up front, one
  nvcc per source, all at once, so that no timed leg pays for a build:
  the counterpart of ``enable_compile_cache``.  The CLI calls it when a
  run picks the card.

``force_cpu_devices`` (JAX's virtual CPU devices for the sharded path) has
no counterpart yet: it comes with the multi-GPU slice (ROADMAP.md).
"""

from __future__ import annotations

from dcf_tpu_torch import _build
from dcf_tpu_torch.backends._common import resolve_device as select_device

__all__ = ["select_device", "repo_cache_dir", "enable_kernel_cache"]


def repo_cache_dir() -> str:
    """The directory the CUDA kernels are built into: ``_build/`` beside
    the package's modules (gitignored; a library's file name carries a
    digest of its sources, so a stale build is never loaded)."""
    return str(_build.BUILD_DIR)


def enable_kernel_cache(names=_build.KERNELS) -> float:
    """Build every kernel of ``names`` that is not built yet, all nvcc
    runs at once; returns the wall seconds spent (0.0 when all were
    built).  Raises ``BackendUnavailableError`` if nvcc is missing or a
    build fails."""
    return _build.build(tuple(names))
