"""Deterministic test instrumentation of the port: the fault-injection
seam (``faults``).  Production code only touches ``faults.fire``, a dict
lookup that returns at once when nothing is armed."""

from dcf_tpu_torch.testing import faults  # noqa: F401
