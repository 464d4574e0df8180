"""Every cell at a size a CPU test can hold: a 2-byte domain, few
points.  The code path is the cell's own; only the sizes and the window
are small."""

import time

from portbench import harness

WORKLOADS = ("dcf-batch-n128-lam16.staged-2p20",
             "dcf-batch-n128-lam16.bytes-2p20")
_BATCH = {"config": {"n_bytes": 2},
          "traffic": {"points": 256, "sample_every": 1, "sample_points": 64,
                      "min_compared": 64, "warmup_requests": 1}}
TINY = {w: _BATCH for w in WORKLOADS}
SEED = (1 << 31) + 12345


def run_tiny(workload, traced=False, seed=SEED, seconds=0.0, traffic=None,
             **kw):
    """One run of ``workload`` at its tiny size on the CPU; the window
    closes after its first request unless ``seconds`` says otherwise.
    ``traffic`` overrides more of the mix."""
    over = {"config": TINY[workload]["config"],
            "traffic": {**TINY[workload]["traffic"], **(traffic or {})}}
    return harness.run(workload, seed, seconds, traced,
                       t_start=time.perf_counter(), device="cpu",
                       overrides=over, **kw)
