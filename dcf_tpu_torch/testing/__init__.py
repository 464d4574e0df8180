"""Deterministic test instrumentation of the port: the fault-injection
seam (``faults``) and the lock-order watchdog (``lockwatch``).
Production code only touches ``faults.fire``, a dict lookup that
returns at once when nothing is armed; ``lockwatch`` patches the lock
factories only inside an explicitly armed window."""

from dcf_tpu_torch.testing import faults, lockwatch  # noqa: F401
