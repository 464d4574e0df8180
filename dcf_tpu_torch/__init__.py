"""dcf_tpu_torch: the PyTorch/CUDA port of dcf_tpu.

Two-party distributed comparison functions (function secret sharing):
``gen`` makes key pairs for ``f(x) = beta if x < alpha else 0`` and each
party evaluates its key on a batch of points; the two shares reconstruct
f(x).  This package carries the batch-eval path of ``dcf_tpu`` at
lam = 16 and at lam >= 48 (the large-lambda hybrid), full-domain
evaluation at lam = 16, and distributed point functions with their
full-domain EvalAll and 2-server PIR at lam = 32: host keygen, the numpy
oracles, the DCFK wire codec, and hand-written CUDA kernels for the NVIDIA
H100 (``sm_90a``) with their plain PyTorch versions:

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

and the keygen kernels G1, B7a, B7b and W2 (``ops.keygen_walk``).  Its
own copy of the C++ host core (``native``, built with g++ at first use)
serves ``Dcf(..., backend="cpu")`` and anchors the bench line
(``bench_torch.py`` at the repository root).

It imports torch and numpy, never jax and never dcf_tpu.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""

from dcf_tpu_torch.api import Dcf
from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    DcfError,
    KeyFormatError,
    NativeBuildError,
    ShapeError,
    StaleStateError,
)
from dcf_tpu_torch.gen import gen_batch, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.protocols.dpf import DpfBundle
from dcf_tpu_torch.spec import Bound

__all__ = [
    "Dcf",
    "Bound",
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
]
