"""The metric arithmetic on synthetic records: the whole-window rate, the
nearest-rank tail, the idle share and breakdown of a timeline, the
per-layer readers, and the copied lookup counts against the smoke
script's needed counts."""

import numpy as np
import pytest

from portbench import harness, roofline, trace
from portbench.trace import Interval, Records


def test_rate_counts_the_last_request_to_its_end():
    # The window was asked for 10 s; the request in flight at 10 s ended
    # at 10.4 s and is counted, over the whole 10.4 s.
    assert harness.rate(104 * 1_000_000, 5.0, 15.4) == pytest.approx(1e7)


@pytest.mark.parametrize("n,want", [(1, 1), (19, 19), (20, 19), (21, 20),
                                    (100, 95), (101, 96)])
def test_p95_nearest_rank(n, want):
    values = list(range(1, n + 1))
    np.random.default_rng(n).shuffle(values)
    assert harness.p95_nearest_rank(values) == want


def _timeline():
    """Two requests over [0, 100) ns; kernels at [10, 40) and [50, 90),
    a copy overlapping the first kernel at [30, 45)."""
    spans = [Interval("portbench.request", 0, 48),
             Interval("portbench.dispatch", 2, 8),
             Interval("portbench.sync", 8, 48),
             Interval("portbench.request", 48, 100),
             Interval("portbench.dispatch", 49, 52),
             Interval("portbench.sync", 52, 100)]
    ops = [Interval("void prefix_eval_kernel<0>(...)", 10, 40),
           Interval("Memcpy HtoD (Pageable -> Device)", 30, 45),
           Interval("void prefix_eval_kernel<0>(...)", 50, 90),
           Interval("before the window", -20, -5)]
    return Records(ops, spans, requests=2)


def test_idle_share_from_a_timeline():
    rec = _timeline()
    assert trace.window(rec) == (0, 100)
    assert trace.busy_ns(rec) == 35 + 40
    assert trace.idle_pct(rec) == pytest.approx(25.0)


def test_breakdown_sums_ops_and_labels_gaps_by_open_span():
    b = trace.breakdown(_timeline())
    assert b["device_ops"][0] == ["void prefix_eval_kernel<0>(...)", 70e-9]
    assert b["device_ops"][1] == ["Memcpy HtoD (Pageable -> Device)", 15e-9]
    labels = {name.split(" (")[0]: s for name, s in b["idle_gaps"]}
    # gaps [0,10), [45,50) and [90,100), by the span open halfway through
    assert labels == {"portbench.dispatch": pytest.approx(10e-9),
                      "portbench.sync": pytest.approx(15e-9)}


def test_align_puts_device_operations_on_the_host_clock():
    # Launched at 100 and 200 on the host; the device's clock reads them
    # 700 early, which no operation can be (it starts after its launch).
    ops = [(Interval("k", -595, -500), 1), (Interval("k", -490, -400), 2),
           (Interval("Memcpy", -400, -390), 9)]
    out = trace.align(ops, {1: 100, 2: 150})
    assert [(i.start, i.end) for i in out] == [(100, 195), (205, 295),
                                                (295, 305)]
    # On one clock already, nothing but the launch latency moves.
    out = trace.align([(Interval("k", 105, 200), 1)], {1: 100})
    assert (out[0].start, out[0].end) == (100, 195)


def test_readers_on_a_timeline():
    rec = _timeline()
    read = harness.metric_reader
    assert read("copy_ms_per_request")(rec) == pytest.approx(15e-6 / 2)
    assert read("dispatch_ms_per_request")(rec) == pytest.approx(4.5e-6)
    assert read("device_idle_pct")(rec) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["B3_roofline", "B3_roofline.api",
                                  "copy_ms_per_request",
                                  "dispatch_ms_per_request",
                                  "device_idle_pct", "device_idle_pct.api"])
def test_readers_return_nothing_without_records(name):
    assert harness.metric_reader(name)(Records([], [])) is None


def _summary(xs, k):
    return {"m": xs.shape[0], "ones": roofline.column_ones(xs),
            "rows": roofline.prefix_rows(xs, k)}


@pytest.mark.parametrize("name", ["B3_roofline", "B3_roofline.api"])
def test_roofline_shares_are_bound_over_kernel_time(name):
    rng = np.random.default_rng(4)
    xs = [rng.integers(0, 256, (4096, 16), dtype=np.uint8) for _ in range(2)]
    peaks = {"lookups_per_s": 1e12, "bytes_per_s": 1e12}
    least = sum(roofline.bound_s(*roofline.prefix_work(x, 21, 128), peaks)
                for x in xs)
    kernel_ns = int(2 * least * 1e9)  # the kernel took twice its bound
    rec = Records([Interval("void prefix_eval_kernel<0>(x)", 0, kernel_ns)],
                  [Interval("portbench.request", 0, kernel_ns + 1)],
                  requests=2, points=[_summary(x, 21) for x in xs],
                  geometry={"n": 128, "nb": 16, "k": 21},
                  peaks=peaks)
    assert harness.metric_reader(name)(rec) == pytest.approx(50.0, rel=1e-6)
    rec.peaks = None  # a card the table does not hold: nothing, never 0
    assert harness.metric_reader(name)(rec) is None


def test_refreshed_points_are_summarised_from_their_base():
    """The trace's summary of a request on a refreshed buffer (column
    counts flipped by its running mask, rows of the base) is the work of
    the points it evaluated, counted directly."""
    from portbench.drivers import _dcf

    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (3000, 16), dtype=np.uint8)
    running = rng.integers(0, 256, 16, dtype=np.uint8) & _dcf.keep_mask(
        21, 16)

    class FakeCell:
        host = {"base": [base], "log": [(0, running)], "k": 21}

    (p,) = _dcf.points_summary(FakeCell, [0])
    want = roofline.prefix_work(base ^ running, 21, 128)
    assert roofline.prefix_work_of(p["m"], 16, p["ones"], p["rows"], 21,
                                   128) == want


def test_end_to_end_readers_on_a_window():
    w = harness.Window(evals=3 * 1048576, start=1.0, end=1.5,
                       latencies=[0.1, 0.3, 0.2], setup_s=9.5)
    read = harness.metric_reader
    for name in ("evals_per_s", "api_evals_per_s"):
        assert read(name)(w) == pytest.approx(6 * 1048576)
    for name in ("request_p95_ms", "api_request_p95_ms"):
        assert read(name)(w) == pytest.approx(300.0)
    assert read("setup_s")(w) == 9.5


def test_peaks_of_the_h100():
    p = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["lookups_per_s"] == 132 * 32 * 1.98e9
    assert p["bytes_per_s"] == 3.35e12
    assert roofline.peaks_for("Some Other Card") is None


@pytest.mark.parametrize("lo,hi", [(0, 128), (21, 128), (6, 21)])
def test_lookup_counts_match_the_smoke_scripts_needed_counts(lo, hi):
    """chip_smoke.py's ``walk_lookups`` (a function inside its kernel
    phase), computed here as it writes it, from its own constants."""
    import torch

    import chip_smoke
    from dcf_tpu_torch.ops.walk_eval import walk_bits_plain

    def smoke_walk_lookups(xs, lo, hi, left, right):
        bits = walk_bits_plain(xs)[..., lo:hi]
        rights = int(bits.sum(dtype=torch.int64))
        return left * (bits.numel() - rights) + right * rights

    turns = (2 * chip_smoke.LOOKUPS_BLOCK, chip_smoke.LOOKUPS_T_BIT)
    xs = np.random.default_rng(lo + hi).integers(0, 256, (3000, 16),
                                                 dtype=np.uint8)
    want = smoke_walk_lookups(torch.from_numpy(xs)[None], lo, hi, *turns)
    assert roofline.walk_lookups(xs, lo, hi) == want
    assert (roofline.LEFT, roofline.RIGHT) == turns == (448, 197)


def test_byte_counts_match_the_smoke_scripts():
    """chip_smoke.py's B3 byte formula (phase 6)."""
    import torch

    from dcf_tpu_torch.ops.prefix_eval import frontier_index_plain

    xs = np.random.default_rng(5).integers(0, 256, (5000, 16), dtype=np.uint8)
    m, n, k = 5000, 128, 21
    rows = int(torch.unique(frontier_index_plain(torch.from_numpy(xs), k))
               .numel())
    assert roofline.prefix_work(xs, k, n)[1] == (
        m * 16 + rows * 32 + m * 16 + (n - k) * 34 + 16 + 496)
