"""Milliseconds a request that the host spends staging points in
``Dcf.eval``: the backend's validation, the pad and the pageable copy
up, timed by the program's ``dcf_tpu_torch.stage`` spans in the traced
window (``portbench/program_spans.py``), over the traced requests.
Nothing where the program opened no such span."""

from portbench import program_spans as ps


def read(rec, spans=None):
    if spans is None:
        spans = ps.from_caller()
    return ps.per_request_ms(rec, ps.total_ns(rec, spans, "stage"))
