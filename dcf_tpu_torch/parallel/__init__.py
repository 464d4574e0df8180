"""The multi-device tier: batch evaluation over a device mesh.

Counterpart of ``dcf_tpu/parallel``.  A 2D mesh with axes ("keys",
"points") lays a batch over cards: keys shard the resident key image,
points shard the batch, and each position runs the single-device kernels
on its block with no collective inside the walk (a pure map, as the
reference's rayon threads over points, src/lib.rs:194-199).  Only the
pod mesh's two-party count crosses processes.

``dcf_tpu``'s three sharded routes to the from-root walk
(``ShardedJaxBackend``, ``ShardedBitslicedBackend``,
``ShardedPallasBackend``) are one class here, ``ShardedWalkBackend``.
"""

from dcf_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ShardedTensor,
    ShardedWalkBackend,
    make_mesh,
    make_pod_mesh,
)
from dcf_tpu_torch.parallel.mesh_eval import (  # noqa: F401
    MeshLargeLambdaBackend,
)
from dcf_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedDpfEvalAll,
    ShardedKeyLanesBackend,
    ShardedLargeLambdaBackend,
    ShardedPrefixBackend,
    ShardedTreeFullDomain,
)

__all__ = ["Mesh", "ShardedTensor", "make_mesh", "make_pod_mesh",
           "ShardedWalkBackend", "ShardedPrefixBackend",
           "ShardedKeyLanesBackend", "ShardedLargeLambdaBackend",
           "ShardedTreeFullDomain", "ShardedDpfEvalAll",
           "MeshLargeLambdaBackend"]
