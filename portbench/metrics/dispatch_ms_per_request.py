"""Milliseconds a request that the host spends in the backend's
``eval_staged`` call (``backends.prefix_backend``), which returns before
the card finishes: the mean of the harness's ``portbench.dispatch`` spans
in the traced window.  Nothing where no such span was traced."""

from portbench import trace


def read(rec):
    spans = trace.span_ns(rec, trace.SPAN_PREFIX + "dispatch")
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e6
