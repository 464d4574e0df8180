"""dcf_tpu_torch: the PyTorch/CUDA port of dcf_tpu.

Two-party distributed comparison functions (function secret sharing):
``gen`` makes key pairs for ``f(x) = beta if x < alpha else 0`` and each
party evaluates its key on a batch of points; the two shares reconstruct
f(x).  This package carries ``dcf_tpu``'s batch evaluation at lam = 16
(one key or many keys in lanes), lam = 32 and lam >= 48 (the
large-lambda hybrid), full-domain evaluation at lam = 16, distributed
point functions with their full-domain EvalAll and 2-server PIR at
lam = 32, keygen on the card, the interval protocols and fixed-point
gates: host keygen, the numpy oracles, the DCFK wire codec, and
hand-written CUDA kernels for the NVIDIA H100 (``sm_90a``) with their
plain PyTorch versions:

    B1   ops.walk_eval      from-root walk       (dcf_tpu/ops/pallas_eval.py)
    B2   ops.tree_expand    tree levels          (dcf_tpu/ops/pallas_tree.py)
    B2f  ops.tree_expand    last level + leaves  (dcf_tpu/ops/pallas_tree.py)
    B3   ops.prefix_eval    prefix walk          (dcf_tpu/ops/pallas_prefix.py)
    B4   ops.narrow_walk    narrow walk          (dcf_tpu/ops/pallas_narrow.py)
    B5a  ops.hybrid_prefix  narrow frontier      (dcf_tpu/ops/pallas_hybrid_prefix.py)
    B5b  ops.hybrid_prefix  narrow prefix walk   (dcf_tpu/ops/pallas_hybrid_prefix.py)
    W1   ops.wide_tail      GF(2) wide tail      (dcf_tpu/backends/large_lambda.py)
    B6   ops.evalall_expand DPF tree level       (dcf_tpu/ops/pallas_evalall.py)
    P1   ops.pir_answer     PIR inner product    (dcf_tpu/workloads/pir.py)
    B8   ops.keylanes_eval  many keys in lanes   (dcf_tpu/ops/pallas_keylanes.py)
    E1   ops.walk32_eval    lam = 32 walk        (dcf_tpu/backends/jax_bitsliced.py)

and the keygen kernels G1, G2, B7a, B7b and W2 (``ops.keygen_walk``).
Its own copy of the C++ host core (``native``, built with g++ at first
use) serves ``Dcf(..., backend="cpu")`` and anchors the bench line
(``bench_torch.py`` at the repository root).

The serving tier (``serve``, ``Dcf.serve``: micro-batched requests from
many threads, resident key images, admission control, breakers, a
durable key store and keygen pools, the DCFE network edge and the pod
router over a shard ring) runs them online, and the multi-device tier
(``parallel``: a device mesh, every backend sharded over it, the pod mesh
over ``torch.distributed``; ``Dcf(..., mesh=)``) lays a batch over cards.

It imports torch and numpy, never jax and never dcf_tpu.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""

from dcf_tpu_torch.api import Dcf, reset_backend_health
from dcf_tpu_torch.errors import (
    BackendFallbackWarning,
    BackendUnavailableError,
    DcfError,
    DeadlineExceededError,
    KeyFormatError,
    NativeBuildError,
    QueueFullError,
    ShapeError,
    StaleStateError,
)
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.protocols.dpf import DpfBundle
from dcf_tpu_torch.spec import Bound, CmpFn, ReferenceContractWarning

__version__ = "0.1.0"

__all__ = [
    "Dcf",
    "reset_backend_health",
    "Bound",
    "CmpFn",
    "ReferenceContractWarning",
    "KeyBundle",
    "DpfBundle",
    "gen_batch",
    "random_s0s",
    "DcfError",
    "KeyFormatError",
    "ShapeError",
    "BackendUnavailableError",
    "StaleStateError",
    "NativeBuildError",
    "QueueFullError",
    "DeadlineExceededError",
    "BackendFallbackWarning",
]
