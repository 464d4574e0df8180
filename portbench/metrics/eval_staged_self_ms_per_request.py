"""Milliseconds a request that the host spends in the backend's own part
of ``eval_staged`` (``backends.prefix_backend``): its checks, the
frontier lookup and the op wrapper's checks, without the program's spans
nested in it (the kernel's launch, a frontier build).  The self time of
the program's ``dcf_tpu_torch.eval_staged`` spans in the traced window
(``portbench/program_spans.py``), over the traced requests.  Nothing
where the program opened no such span."""

from portbench import program_spans as ps


def read(rec, spans=None):
    if spans is None:
        spans = ps.from_caller()
    return ps.per_request_ms(rec, ps.self_ns(rec, spans, "eval_staged"))
