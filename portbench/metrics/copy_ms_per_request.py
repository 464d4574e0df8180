"""Milliseconds a request of the device's host-to-device and
device-to-host copies (``api.Dcf.eval``'s staging and fetch), from the
profiler's device trace, over the traced requests.  Nothing where the
trace holds no copy."""

from portbench import trace


def read(rec):
    copy_ns = trace.device_ns(rec, lambda name: name.startswith("Memcpy"))
    if not copy_ns or not rec.requests:
        return None
    return copy_ns / 1e6 / rec.requests
