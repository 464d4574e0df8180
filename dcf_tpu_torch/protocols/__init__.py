"""Protocols over the GGM walk.  This package carries ``protocols.dpf``
(distributed point functions: key bundle, DCFK v3 ``proto=2`` frame, host
keygen and the per-point reference evaluator); the interval protocols of
``dcf_tpu/protocols`` are not ported yet (ROADMAP.md slice 7)."""

from dcf_tpu_torch.protocols.dpf import (  # noqa: F401
    DPF_DEVICE_LAM,
    PROTO_DPF,
    DpfBundle,
    decode_proto_frame,
    dpf_eval_points,
    dpf_gen_batch,
)

__all__ = ["DPF_DEVICE_LAM", "PROTO_DPF", "DpfBundle", "decode_proto_frame",
           "dpf_eval_points", "dpf_gen_batch"]
