"""The share of the traced window, in %, in which no kernel and no copy
ran on the card, from the profiler's timeline.  Nothing where the trace
holds no device operation."""

from portbench import trace


def read(rec):
    return trace.idle_pct(rec)
