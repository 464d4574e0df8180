"""The share of the traced window, in %, in which no kernel and no copy
ran on the card, in the cell that goes through ``Dcf.eval``: the same
reading as ``device_idle_pct.py``, kept apart because it moves that
cell's end-to-end rate, ``api_evals_per_s``."""

from portbench import trace


def read(rec):
    return trace.idle_pct(rec)
