"""The comparison fails what it must: each fault planted under the timed
path, and the control (the reference in the program's place with
AES-256 cut to fewer rounds), come out not correct."""

import pytest

from portbench.faults import FAULTS
from portbench.tests.tiny import WORKLOADS, run_tiny


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_under_the_timed_path_is_not_correct(workload, fault):
    r = run_tiny(workload, fault=FAULTS[fault])
    assert r["correct"] is False
    assert r["checks"]["share_mismatches"]["value"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    r = run_tiny(workload, control=True)
    assert r["correct"] is False
    c = r["checks"]
    # The control differs nearly everywhere, far above the limit of 0.
    assert c["share_mismatches"]["value"] >= 0.9 * c["answers_compared"]["value"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_cached_answer_to_a_batch_asked_before_is_not_correct(workload):
    """With one batch, every request evaluates the same buffer.  A cache
    of answers by batch, which hands back the answers of the request
    before, would be exactly right on repeated points; the points are
    refreshed between requests, so it is caught."""
    r = run_tiny(workload, fault=FAULTS["stale"], traffic={"batches": 1})
    assert r["correct"] is False
    assert r["checks"]["share_mismatches"]["value"] > 0


def test_missing_answers_are_not_correct():
    def truncate(out, prev, r):
        return out[:, : out.shape[1] // 2]

    r = run_tiny(WORKLOADS[1], fault=truncate)
    assert r["correct"] is False
    assert r["checks"]["answers_missing"]["value"] > 0
