"""Protocols over the GGM walk.  This package carries ``protocols.dpf``
(distributed point functions: key bundle, DCFK v3 ``proto=2`` frame, host
and device keygen and the per-point reference evaluator) and, of
``dcf_tpu/protocols/combine.py``, the streamed two-party reconstruction;
the interval protocols of ``dcf_tpu/protocols`` are not ported yet
(ROADMAP.md slice 7)."""

from dcf_tpu_torch.protocols.combine import xor_reconstruct_stream  # noqa: F401
from dcf_tpu_torch.protocols.dpf import (  # noqa: F401
    DPF_DEVICE_LAM,
    PROTO_DPF,
    DpfBundle,
    decode_proto_frame,
    dpf_eval_points,
    dpf_gen_batch,
    dpf_gen_on_device,
)

__all__ = ["DPF_DEVICE_LAM", "PROTO_DPF", "DpfBundle", "decode_proto_frame",
           "dpf_eval_points", "dpf_gen_batch", "dpf_gen_on_device",
           "xor_reconstruct_stream"]
