"""The program's spans (``dcf_tpu_torch.*``) and what reads them
(``portbench/program_spans.py``), on synthetic timelines and on the CPU:
the program's ranges leave the trace's device work and every reading the
benchmark took before them as they were, the readers find the harness's
profile, the finer idle split labels a piece by the innermost span
however deep the nesting, and the four metrics that read program spans.
The card tests run each cell traced on the card:

    python3 -m pytest portbench/tests -m card
"""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, program_spans as ps, roofline, trace
from portbench.tests.tiny import run_tiny
from portbench.trace import Interval, Records

P = ps.PREFIX
B3 = "void prefix_eval_kernel<0>(...)"
SKEW = 700  # the device clock's lead over the host's, in ns


class _Event:
    """A profiler event as ``records_from_profile`` reads one."""

    def __init__(self, name, start, end, device, corr=0):
        self._v = (name, start, end - start, device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def _bytes_events(program: bool):
    """Two ``Dcf.eval`` requests over [0, 400) ns on the host's clock: the
    copy up, B3 and the copy back, each launched by a runtime call; the
    harness's ranges, each mirrored on the device's timeline over the
    device work launched inside it as the profiler mirrors a user
    annotation, and, with ``program``, the program's plain ranges, which
    it does not mirror."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ev = []
    for r, t in enumerate((0, 200)):
        c = 10 * r
        ops = [("Memcpy HtoD (Pageable -> Device)", t + 20, t + 60, c + 1),
               (B3, t + 80, t + 150, c + 2),
               ("Memcpy DtoH (Device -> Pageable)", t + 150, t + 180, c + 3)]
        for name, a, b, corr in ops:
            ev.append(_Event(name, a + SKEW, b + SKEW, gpu, corr))
            ev.append(_Event("cudaLaunchKernel", a, a + 2, cpu, corr))
        for name, a, b in [("portbench.request", t, t + 190),
                           ("portbench.facade_eval", t + 1, t + 189)]:
            ev.append(_Event(name, a, b, cpu))
            ev.append(_Event(name, t + 20 + SKEW, t + 180 + SKEW, gpu))
        if program:
            ev += [_Event(P + "eval", t + 2, t + 188, cpu),
                   _Event(P + "stage", t + 5, t + 61, cpu),
                   _Event(P + "eval_staged", t + 62, t + 78, cpu),
                   _Event(P + "launch", t + 70, t + 77, cpu),
                   _Event(P + "fetch", t + 79, t + 185, cpu)]
    return ev


def _records(program: bool) -> Records:
    ops, spans, skew = trace.records_from_profile(
        _profile(_bytes_events(program)))
    assert skew == SKEW
    rng = np.random.default_rng(3)
    xs = [rng.integers(0, 256, (4096, 16), dtype=np.uint8) for _ in range(2)]
    points = [{"m": x.shape[0], "ones": roofline.column_ones(x),
               "rows": roofline.prefix_rows(x, 21)} for x in xs]
    return Records(ops, spans, requests=2, points=points,
                   geometry={"n": 128, "nb": 16, "k": 21},
                   peaks={"lookups_per_s": 1e12, "bytes_per_s": 1e12})


def test_program_ranges_are_neither_device_work_nor_harness_spans():
    plain, spanned = _records(program=False), _records(program=True)
    assert spanned.device_ops == plain.device_ops
    assert spanned.spans == plain.spans
    assert len(spanned.device_ops) == 6
    got = ps.of_profile(_profile(_bytes_events(program=True)))
    assert [s.name for s in got[:5]] == [
        P + n for n in ("eval", "stage", "eval_staged", "launch", "fetch")]
    assert len(got) == 10 and all(s.end <= 400 for s in got)
    assert ps.of_profile(_profile(_bytes_events(program=False))) == []


EXISTING = ["B3_roofline", "B3_roofline.api", "copy_ms_per_request",
            "dispatch_ms_per_request", "device_idle_pct",
            "device_idle_pct.api"]


@pytest.mark.parametrize("name", EXISTING)
def test_existing_readers_read_the_same_with_program_spans(name):
    read = harness.metric_reader(name)
    assert read(_records(program=True)) == read(_records(program=False))
    assert trace.breakdown(_records(True)) == trace.breakdown(
        _records(False))


def test_the_readers_find_the_profile_of_the_frame_that_reads_them():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dcf_tpu_torch.utils.tracing import span

    def reader():  # as the harness calls a metric's ``read``
        return ps.from_caller()

    def harness_run():
        prof = profile(activities=[ProfilerActivity.CPU])
        with prof:
            with span("eval"), span("stage"):
                torch.ones(4).add_(1)
        return reader()

    got = harness_run()
    assert [s.name for s in got] == [P + "eval", P + "stage"]
    outer, inner = got
    assert outer.start <= inner.start < inner.end <= outer.end
    assert reader() is None  # no profile anywhere up the stack


def test_a_tiny_traced_run_prints_its_cells_program_span_metrics():
    staged = run_tiny("dcf-batch-n128-lam16.staged-2p20", traced=True)
    facade = run_tiny("dcf-batch-n128-lam16.bytes-2p20", traced=True)
    assert staged["correct"] and facade["correct"]
    # The plain versions launch no kernel on the CPU: no ``launch`` span.
    assert staged["metrics"]["eval_staged_self_ms_per_request"]["value"] > 0
    assert "launch_ms_per_request" not in staged["metrics"]
    for name in ("stage_ms_per_request", "facade_idle_ms_per_request"):
        assert facade["metrics"][name]["value"] > 0
        assert name not in staged["metrics"]
    assert "eval_staged_self_ms_per_request" not in facade["metrics"]


def test_idle_gaps_take_the_innermost_of_twelve_nested_spans():
    # Earlier siblings that have ended, then twelve spans each inside the
    # one before, then a late sibling inside the outermost.
    spans = [Interval(f"done{i}", i, i + 1) for i in range(20)]
    spans += [Interval(f"depth{d}", 100 + d, 200 - d) for d in range(12)]
    spans += [Interval("late", 190, 195)]
    spans.sort(key=lambda s: s.start)
    starts = [s.start for s in spans]
    reach = [max(s.end for s in spans[:j + 1]) for j in range(len(spans))]
    for t, want in [(150, "depth11"), (100, "depth0"), (188, "depth11"),
                    (189, "depth10"), (192, "late"), (197, "depth2"),
                    (50, None)]:
        assert ps._label_at(spans, starts, reach, t) == want, t
    # A request whose one gap lies under all twelve; then a gap over
    # [186, 198), split at every span's edge.
    rec = Records([Interval("k", 100, 140), Interval("k", 160, 200)],
                  [Interval(trace.REQUEST_SPAN, 100, 200)])
    gaps = ps.idle_gaps(rec, spans[20:])
    assert gaps == [["depth11 (1 pieces)", 20e-9]]
    rec.device_ops = [Interval("k", 100, 186), Interval("k", 198, 200)]
    assert dict(ps.idle_gaps(rec, spans[20:])) == {
        "depth11 (1 pieces)": 3e-9, "depth10 (1 pieces)": 1e-9,
        "late (5 pieces)": 5e-9, "depth4 (1 pieces)": 1e-9,
        "depth3 (1 pieces)": 1e-9, "depth2 (1 pieces)": 1e-9}


def _staged():
    """Two staged requests; the second's eval_staged builds a frontier."""
    harness_spans = [Interval("portbench.request", 0, 100),
                     Interval("portbench.dispatch", 2, 20),
                     Interval("portbench.sync", 20, 100),
                     Interval("portbench.request", 100, 200),
                     Interval("portbench.dispatch", 102, 115),
                     Interval("portbench.sync", 115, 200)]
    program = [Interval(P + "eval_staged", 3, 18),
               Interval(P + "launch", 10, 16),
               Interval(P + "eval_staged", 103, 114),
               Interval(P + "frontier_build", 104, 106),
               Interval(P + "frontier_host_levels", 104, 105),
               Interval(P + "launch", 108, 112),
               Interval(P + "launch", 250, 260)]  # after the window
    ops = [Interval(B3, 17, 95), Interval(B3, 113, 190)]
    return Records(ops, harness_spans, requests=2), program


def _bytes():
    """One Dcf.eval request: idle before the copy up, before B3 and after
    the copy back."""
    harness_spans = [Interval("portbench.request", 0, 100),
                     Interval("portbench.facade_eval", 1, 99)]
    program = [Interval(P + "eval", 2, 98),
               Interval(P + "stage", 3, 30),
               Interval(P + "eval_staged", 31, 35),
               Interval(P + "launch", 33, 34),
               Interval(P + "fetch", 36, 97)]
    ops = [Interval("Memcpy HtoD (Pageable -> Device)", 10, 30),
           Interval(B3, 36, 80), Interval("Memcpy DtoH", 80, 97)]
    return Records(ops, harness_spans, requests=1), program


@pytest.mark.parametrize("name,cell,want_ns", [
    # (15 - 6) + (11 - 2 - 4) ns of self time over 2 requests
    ("eval_staged_self_ms_per_request", _staged, 7),
    ("launch_ms_per_request", _staged, 5),
    ("stage_ms_per_request", _bytes, 27),
    # [2, 10) + [30, 36) + [97, 98)
    ("facade_idle_ms_per_request", _bytes, 15)])
def test_program_span_metrics_on_a_timeline(name, cell, want_ns):
    rec, program = cell()
    assert harness.metric_reader(name)(rec, program) == pytest.approx(
        want_ns / 1e6)


NEW = ["eval_staged_self_ms_per_request", "launch_ms_per_request",
       "stage_ms_per_request", "facade_idle_ms_per_request"]


@pytest.mark.parametrize("name", NEW)
def test_program_span_metrics_read_nothing_without_their_span(name):
    read = harness.metric_reader(name)
    for rec, _ in (_staged(), _bytes()):
        assert read(rec) is None  # no profile up the stack: the parent's
        assert read(rec, []) is None
    assert read(Records([], []), _bytes()[1]) is None  # no window
    assert read(_records(program=False), []) is None


def test_self_total_idle_and_the_finer_idle_split():
    rec, program = _staged()
    assert ps.self_ns(rec, program, "frontier_build") == 1
    assert ps.self_ns(rec, program, "launch") == 10
    assert ps.total_ns(rec, program, "launch") == 10
    assert ps.self_ns(rec, program, "fetch") is None
    # eval_staged [3, 18) is covered by B3 from 17; [103, 114) from 113
    assert ps.idle_in_ns(rec, program, "eval_staged") == 14 + 10
    assert ps.idle_in_ns(rec, program, "eval") is None
    # Every idle piece of the bytes request under the innermost span;
    # the program's pieces sum to facade_idle_ms_per_request's 15 ns.
    rec, program = _bytes()
    gaps = {k.split(" (")[0]: v for k, v in ps.idle_gaps(rec, program)}
    assert gaps == pytest.approx({
        "portbench.request": 2e-9, "portbench.facade_eval": 2e-9,
        P + "eval": 4e-9, P + "stage": 7e-9, P + "eval_staged": 3e-9,
        P + "launch": 1e-9})
    assert sum(v for k, v in gaps.items() if k.startswith(P)) == \
        pytest.approx(15e-9)


# -- on the card -------------------------------------------------------------

CELLS = {
    "dcf-batch-n128-lam16.staged-2p20": ("eval_staged_self_ms_per_request",
                                         "launch_ms_per_request"),
    "dcf-batch-n128-lam16.bytes-2p20": ("stage_ms_per_request",
                                        "facade_idle_ms_per_request")}


def _exact(checks: dict) -> bool:
    """Every answer a short window sampled matched the reference.  A 1 s
    window samples too few staged requests (one in 64) for the cell's
    floor of compared answers, which the full-length card test holds."""
    return (checks["share_mismatches"]["value"] == 0
            and checks["answers_missing"]["value"] == 0
            and checks["answers_compared"]["value"] > 0)


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_traced_run_prints_its_program_span_metrics(card, workload):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str((1 << 31) + 2323), "--seconds", "1", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert _exact(r["checks"]), r["checks"]
    for name in CELLS[workload]:
        assert r["metrics"][name]["value"] > 0, name
    others = {n for w, names in CELLS.items() if w != workload
              for n in names}
    assert not others & set(r["metrics"])


@pytest.mark.card
def test_launch_spans_are_the_b3_launches_and_no_device_work(card,
                                                            monkeypatch):
    kept = []
    reader = trace.records_from_profile

    def keep(prof):
        kept.append((reader(prof), ps.of_profile(prof), [
            e.name() for e in prof.profiler.kineto_results.events()]))
        return kept[-1][0]

    monkeypatch.setattr(trace, "records_from_profile", keep)
    r = harness.run("dcf-batch-n128-lam16.staged-2p20", (1 << 31) + 2424,
                    1.0, True, t_start=time.perf_counter())
    assert _exact(r["checks"]), r["checks"]
    (ops, spans, _), program, names = kept[0]
    rec = Records(ops, spans, requests=r["attempted"])
    w0, w1 = trace.window(rec)
    launches = [s for s in program
                if s.name == P + "launch" and w0 <= s.start < w1]
    b3 = [o for o in ops if "prefix_eval_kernel" in o.name
          and w0 <= o.start < w1]
    assert len(launches) == len(b3) == r["attempted"]
    # Each program span appears once, on the host: the profiler mirrors
    # none of them onto the device's timeline.
    assert not any(o.name.startswith(P) for o in ops)
    assert sum(n.startswith(P) for n in names) == len(program)
