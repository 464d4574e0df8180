"""The 95th percentile, by nearest rank, of every request's latency in
the window, from the call into the program to its finished result, in
milliseconds."""

from portbench.harness import p95_nearest_rank


def read(w):
    return 1e3 * p95_nearest_rank(w.latencies)
