"""Reference and extension workloads as runnable functions.

``workloads.core`` holds BASELINE.json config 3 (the per-point full-domain
check) and config 5 (secure ReLU: many keys at few shared points, keygen,
evaluation and check on the device); ``workloads.pir`` the 2-server PIR
workload built on the DPF EvalAll backend; ``workloads.gates`` the served
fixed-point gates (``GateServer``: the gates of ``protocols.fixedpoint``
registered with, and evaluated through, a ``serve.DcfService``).
"""

from dcf_tpu_torch.workloads.core import (  # noqa: F401
    domain_points,
    full_domain_check,
    full_domain_check_device,
    secure_relu_check_device,
    secure_relu_eval,
)
from dcf_tpu_torch.workloads.gates import GateServer  # noqa: F401
from dcf_tpu_torch.workloads.pir import (  # noqa: F401
    PirDatabase,
    PirServer,
    pir_answer_share,
    pir_query_bundle,
    pir_reconstruct,
)

__all__ = [
    "GateServer",
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
