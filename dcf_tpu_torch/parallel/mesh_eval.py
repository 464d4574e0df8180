"""Pod-mesh co-evaluation: one batch spanning every process's device.

Counterpart of ``dcf_tpu/parallel/mesh_eval.py`` (its lines 46-128).
``ShardedLargeLambdaBackend`` lays a batch across one process's mesh;
``MeshLargeLambdaBackend`` lays it across every process of a
``torch.distributed`` group (``parallel._compat``).  Each process holds
the whole bundle image (the pod mesh's keys axis is 1: the ring shards
keys across hosts, ``serve.shardmap``; the mesh shards points), stages
its own equal-length slice of the points on its own positions, runs the
narrow walk and the wide tail there (kernels B4 + W1), and reads its own
slice back.  The two-party count (``points_mismatch_count``) is the one
collective: an ``all_reduce`` SUM, so every process reads the total.

Contract per process (every process makes the same calls in the same
order):

* ``distributed_initialize``, then ``make_pod_mesh()``: shape
  (1, processes), one position a process;
* ``put_bundle(bundle)`` with the identical bundle everywhere;
* ``stage(xs_local)`` with this process's slice of the batch; slices are
  equal-length (pad the tail slice: pad points are genuine x = 0
  evaluations and check themselves);
* ``eval_staged`` returns this process's blocks; ``staged_to_bytes``
  this process's slice, uint8 [K, M_local, lam].

Standalone (no group), the backend is ``ShardedLargeLambdaBackend`` over
the same positions, byte for byte.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.parallel import _compat
from dcf_tpu_torch.parallel.mesh import Mesh
from dcf_tpu_torch.parallel.sharded import ShardedLargeLambdaBackend

__all__ = ["MeshLargeLambdaBackend"]


class MeshLargeLambdaBackend(ShardedLargeLambdaBackend):
    """The large-lambda hybrid (from the root) over a multi-process pod
    mesh: this process runs the positions of its own columns of the
    points axis (``_compat.local_columns``), and the count is summed
    over the group."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh):
        kaxis = mesh.axis_names[0]
        if mesh.shape[kaxis] != 1:
            raise ShapeError(
                f"pod mesh keys axis must be 1 (the ring shards keys "
                f"across hosts; the mesh shards points), got "
                f"{mesh.shape[kaxis]}")
        super().__init__(lam, cipher_keys, mesh, prefix_levels=0)

    def _columns(self):
        return _compat.local_columns(self._psize)

    def points_mismatch_count(self, y0, y1, alpha, beta, staged: dict,
                              gt: bool = False) -> torch.Tensor:
        """The two-party count over every process's slice, pad points
        included: this process's sum, then an ``all_reduce`` SUM over the
        group (on the CPU for ``gloo``), so every process reads the
        total."""
        return _compat.all_reduce_sum(super().points_mismatch_count(
            y0, y1, alpha, beta, staged, gt))
