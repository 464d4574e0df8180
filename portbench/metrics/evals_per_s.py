"""One party's DCF evaluations (key x point) a second, over the whole
window: every evaluation its finished requests completed, over the time
from its start to the end of its last request (the one in flight when
the window's seconds ran out is finished and counted)."""

from portbench.harness import rate


def read(w):
    return rate(w.evals, w.start, w.end)
