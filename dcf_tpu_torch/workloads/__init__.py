"""Reference and extension workloads as runnable functions.

``workloads.core`` holds BASELINE.json config 3, the per-point full-domain
check; ``workloads.pir`` the 2-server PIR workload built on the DPF
EvalAll backend.  The secure-ReLU workload and the gate suite of
``dcf_tpu/workloads`` wait for their backends (ROADMAP.md slices 6 and 7).
"""

from dcf_tpu_torch.workloads.core import (  # noqa: F401
    domain_points,
    full_domain_check,
    full_domain_check_device,
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
]
