"""Every cell's traffic end to end on the CPU at a tiny size, through the
harness's own code; only the timing differs from a run on the card."""

import json

import pytest

from portbench import harness
from portbench.tests.tiny import WORKLOADS, run_tiny


def _names(kind, workload):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench[kind]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_with_its_end_to_end_metrics(workload):
    r = run_tiny(workload)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == _names("end_to_end", workload)
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["checks"]["answers_compared"]["value"] >= 64


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_cell_reports_no_device_number_without_a_device(workload):
    r = run_tiny(workload, traced=True)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) <= _names("per_layer", workload)
    # No device, so no roofline, copy or idle share: never a 0 in their
    # place.
    assert not {"B3_roofline", "B3_roofline.api", "copy_ms_per_request",
                "device_idle_pct", "device_idle_pct.api"} & set(r["metrics"])
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs_other_seed_other_inputs():
    from portbench.generator import Cell

    _, _, config, traffic = harness.load_cell(WORKLOADS[0])
    a, b, c = (Cell(config, traffic, s, device="cpu")
               for s in (7, 7, 8 + (1 << 33)))
    assert a.inputs["cipher_keys"] == b.inputs["cipher_keys"]
    assert a.inputs["cipher_keys"] != c.inputs["cipher_keys"]
    assert (a.inputs["alphas"] == b.inputs["alphas"]).all()
    assert (a.host["base"][3] == b.host["base"][3]).all()
    assert (a.host["masks"] == b.host["masks"]).all()
    assert a.sample_offset == b.sample_offset
    assert not (a.host["base"][0] == c.host["base"][0]).all()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_no_request_repeats_the_points_of_another(workload):
    """The refresh between requests, at the cell's widths and frontier
    depth: no two requests share a point at any position, and requests
    on one buffer keep the top k bits the seed drew."""
    from portbench.drivers import _dcf
    from portbench.generator import Cell

    _, _, config, traffic = harness.load_cell(workload)
    cell = Cell(config, {**traffic, "points": 64, "sample_points": 16}, 99,
                device="cpu")
    cell.host["k"] = 21  # the program's depth at these widths
    for i in range(3 * int(traffic["batches"])):
        _dcf.log(cell, i)
        _dcf.next_mask(cell, i)
    seen = [(b, cell.host["base"][b] ^ run) for b, run in cell.host["log"]]
    top = ~_dcf.keep_mask(21, 16)
    for i, (bi, xi) in enumerate(seen):
        for bj, xj in seen[:i]:
            assert not (xi == xj).all(axis=1).any()
            if bi == bj:
                assert ((xi & top) == (xj & top)).all()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_stays_correct_over_refreshed_requests(workload):
    r = run_tiny(workload, seconds=0.3, seed=5)
    assert r["correct"] is True and r["attempted"] >= 2, r


def test_staged_cell_stages_again_where_its_points_are_not_plain_bytes(
        monkeypatch):
    """A backend whose staged dict holds its points in another layout:
    the refreshed points go through its ``stage`` again, and the run
    stays correct."""
    from portbench.drivers import staged_ring

    monkeypatch.setattr(staged_ring, "_plain", lambda staged, xs: False)
    r = run_tiny(WORKLOADS[0], seconds=0.3, seed=6)
    assert r["correct"] is True and r["attempted"] >= 2, r
