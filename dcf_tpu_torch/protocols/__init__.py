"""Mixed-mode secure-computation protocols over DCF.

Counterpart of ``dcf_tpu/protocols``.  The source paper (Boyle et al.,
EUROCRYPT 2021) presents DCF as the building block of interval
containment (IC), multiple interval containment (MIC) and piecewise /
spline function evaluation.  This package is that layer for the port:

- ``protocols.oracle``     numpy golden models (IC / MIC / piecewise);
- ``protocols.keygen``     the 2m interval-bound DCF keys of an
  m-interval MIC packed into one ``KeyBundle`` on the K axis, wrapped in
  a ``ProtocolBundle`` with the per-interval combine masks; DCFK v3 / v4
  frames with ``proto = 1``;
- ``protocols.combine``    the pairwise share combine (on the card for
  every staged backend's shares), its
  ``protocols.combine`` fault seam, and the streamed two-party
  reconstruction;
- ``protocols.ic``         single-interval containment;
- ``protocols.mic``        batched MIC: the facade path and the staged
  ``MicEvaluator``;
- ``protocols.piecewise``  piecewise-constant lookup as a MIC over a
  domain partition, group-reduced to one value per point;
- ``protocols.fixedpoint`` fixed-point gates over the additive output
  groups: signed comparison, faithful truncation and spline sigmoid,
  each with its numpy oracle;
- ``protocols.dpf``        distributed point functions: key bundle,
  DCFK v3 ``proto = 2`` frame, host and device keygen and the per-point
  reference evaluator.

Entry points: ``Dcf.interval`` / ``mic`` / ``piecewise`` (keygen) and
``Dcf.eval_interval`` / ``eval_mic`` / ``eval_piecewise``.  What
``dcf_tpu`` serves through its serving tier (protocol bundles in
``DcfService``, ``workloads.gates.GateServer``) waits for that tier.
"""

from dcf_tpu_torch.protocols.combine import (  # noqa: F401
    combine_pair_shares,
    xor_reconstruct_stream,
)
from dcf_tpu_torch.protocols.dpf import (  # noqa: F401
    DPF_DEVICE_LAM,
    PROTO_DPF,
    DpfBundle,
    decode_proto_frame,
    dpf_eval_points,
    dpf_gen_batch,
    dpf_gen_on_device,
)
from dcf_tpu_torch.protocols.fixedpoint import (  # noqa: F401
    SigmoidGate,
    SignGate,
    TruncGate,
    eval_sigmoid_share,
    eval_sign_share,
    eval_trunc_share,
    gate_reconstruct,
    gen_sigmoid_gate,
    gen_sign_gate,
    gen_trunc_gate,
    sigmoid_fixed_oracle,
    sigmoid_table,
    sign_oracle,
    trunc_oracle,
)
from dcf_tpu_torch.protocols.ic import eval_interval  # noqa: F401
from dcf_tpu_torch.protocols.keygen import (  # noqa: F401
    ProtocolBundle,
    gen_interval_bundle,
    interval_bound_alphas,
)
from dcf_tpu_torch.protocols.mic import MicEvaluator, eval_mic  # noqa: F401
from dcf_tpu_torch.protocols.oracle import (  # noqa: F401
    dpf_oracle,
    ic_oracle,
    mic_oracle,
    piecewise_oracle,
)
from dcf_tpu_torch.protocols.piecewise import (  # noqa: F401
    eval_piecewise,
    partition_intervals,
)

__all__ = [
    "DPF_DEVICE_LAM",
    "DpfBundle",
    "MicEvaluator",
    "PROTO_DPF",
    "ProtocolBundle",
    "SigmoidGate",
    "SignGate",
    "TruncGate",
    "combine_pair_shares",
    "decode_proto_frame",
    "dpf_eval_points",
    "dpf_gen_batch",
    "dpf_gen_on_device",
    "dpf_oracle",
    "eval_interval",
    "eval_mic",
    "eval_piecewise",
    "eval_sigmoid_share",
    "eval_sign_share",
    "eval_trunc_share",
    "gate_reconstruct",
    "gen_interval_bundle",
    "gen_sigmoid_gate",
    "gen_sign_gate",
    "gen_trunc_gate",
    "ic_oracle",
    "interval_bound_alphas",
    "mic_oracle",
    "partition_intervals",
    "piecewise_oracle",
    "sigmoid_fixed_oracle",
    "sigmoid_table",
    "sign_oracle",
    "trunc_oracle",
    "xor_reconstruct_stream",
]
