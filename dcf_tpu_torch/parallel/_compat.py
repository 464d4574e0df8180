"""The multi-process runtime of the pod mesh, over ``torch.distributed``.

Counterpart of ``dcf_tpu/parallel/_compat.py`` (its lines 52-123).  There
the module shims JAX's version skew: ``shard_map``'s two homes,
``jax.distributed.initialize`` and the host-local to global array
conversion.  PyTorch has no ``shard_map`` (the sharded classes run one
backend instance a mesh position instead, ``parallel.mesh``), so what is
left is the process group:

- ``distributed_initialize`` joins this process to the pod's group
  (``torch.distributed.init_process_group`` over ``tcp://``);
- ``process_index`` / ``process_count`` read it (0 and 1 standalone);
- ``local_columns`` is what ``host_to_global`` becomes: the columns of
  the points axis that this process contributes to, each process
  holding an equal share of them in rank order (the slice record the
  pod mesh needs; there is no global array to build);
- ``all_reduce_sum`` is the one collective the pod mesh uses, with the
  backend's own placement rule (``gloo`` reduces CPU tensors, ``nccl``
  CUDA tensors).
"""

from __future__ import annotations

import datetime

import torch

from dcf_tpu_torch.errors import BackendUnavailableError, ShapeError

__all__ = ["distributed_initialize", "process_index", "process_count",
           "local_columns", "all_reduce_sum", "group_backend"]


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def distributed_initialize(coordinator_address: str, num_processes: int,
                           process_id: int, backend: str | None = None,
                           timeout_s: float = 60.0) -> None:
    """Join this process to the pod's process group.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    process 0's rendezvous; every process passes the same one, the group
    size ``num_processes`` and its own ``process_id``.  ``backend``
    ``None`` picks ``nccl`` where CUDA is available and ``gloo``
    otherwise; name it to choose (two processes that share one card
    need ``gloo``: NCCL refuses two ranks on one GPU).  A repeat call on
    an initialised group is a no-op.  A group that cannot form within
    ``timeout_s`` (no coordinator, a peer that never comes) raises
    ``BackendUnavailableError``."""
    if _initialized():
        return  # idempotent re-entry
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    try:
        _dist().init_process_group(
            backend, init_method=url, world_size=int(num_processes),
            rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # fallback-ok: typed re-raise of any runtime
        # or rendezvous error joining the pod
        raise BackendUnavailableError(
            f"torch.distributed.init_process_group ({backend}) failed for "
            f"process {process_id}/{num_processes} at {url!r} "
            f"({type(e).__name__}: {e})") from e


def process_index() -> int:
    """This process's rank in the group (0 standalone)."""
    return _dist().get_rank() if _initialized() else 0


def process_count() -> int:
    """The group's size (1 standalone)."""
    return _dist().get_world_size() if _initialized() else 1


def group_backend() -> str | None:
    """The group's backend (``gloo``, ``nccl``), None standalone."""
    return str(_dist().get_backend()) if _initialized() else None


def local_columns(n_columns: int) -> range:
    """The points-axis columns this process contributes: an equal share
    of ``n_columns`` a process, in rank order (``host_to_global``'s
    contract: each process stages its own slice, and the global batch is
    their concatenation in process order)."""
    count = process_count()
    if n_columns % count:
        raise ShapeError(
            f"points-axis size {n_columns} not divisible by process count "
            f"{count}")
    per = n_columns // count
    first = process_index() * per
    return range(first, first + per)


def all_reduce_sum(value: torch.Tensor) -> torch.Tensor:
    """The group-wide sum of a scalar count, readable by every process:
    the tensor itself standalone; an ``all_reduce`` SUM otherwise, on
    the CPU for ``gloo`` and on the value's card for ``nccl``."""
    if not _initialized():
        return value
    on = value.to(torch.int64)
    if group_backend() == "gloo":
        on = on.cpu()
    elif on.device.type != "cuda":
        # api-edge: documented collective placement contract
        raise ShapeError(f"an nccl all_reduce wants a CUDA tensor, got "
                         f"one on {on.device}")
    on = on.clone()
    _dist().all_reduce(on, op=_dist().ReduceOp.SUM)
    return on
