"""Reference and extension workloads as runnable functions.

``workloads.core`` holds BASELINE.json config 3 (the per-point full-domain
check) and config 5 (secure ReLU: many keys at few shared points, keygen,
evaluation and check on the device); ``workloads.pir`` the 2-server PIR
workload built on the DPF EvalAll backend.  ``dcf_tpu``'s served gate
suite (``workloads.gates.GateServer``) is a client of its serving tier and
waits for that tier's port (ROADMAP.md); the gates themselves are in
``protocols.fixedpoint``.
"""

from dcf_tpu_torch.workloads.core import (  # noqa: F401
    domain_points,
    full_domain_check,
    full_domain_check_device,
    secure_relu_check_device,
    secure_relu_eval,
)
from dcf_tpu_torch.workloads.pir import (  # noqa: F401
    PirDatabase,
    PirServer,
    pir_answer_share,
    pir_query_bundle,
    pir_reconstruct,
)

__all__ = [
    "PirDatabase",
    "PirServer",
    "domain_points",
    "full_domain_check",
    "full_domain_check_device",
    "pir_answer_share",
    "pir_query_bundle",
    "pir_reconstruct",
    "secure_relu_check_device",
    "secure_relu_eval",
]
