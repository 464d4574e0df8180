"""Milliseconds a request in which the card is idle while ``Dcf.eval``
runs: the time of the program's ``dcf_tpu_torch.eval`` spans in the
traced window (``portbench/program_spans.py``) that no device operation
covers, over the traced requests.  Nothing where the program opened no
such span."""

from portbench import program_spans as ps


def read(rec, spans=None):
    if spans is None:
        spans = ps.from_caller()
    return ps.per_request_ms(rec, ps.idle_in_ns(rec, spans, "eval"))
