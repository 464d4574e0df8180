"""Records of a traced window, and the arithmetic that reduces them.

A traced run wraps its window in ``torch.profiler``.  The device's
operations (kernels, copies, fills) and the harness's own spans (the
``portbench.*`` ranges it opens around each call into the program) come
back on one clock.  ``Records`` holds them with what the readers of the
per-layer metrics need besides: the number of traced requests, the
driver's summary of each one's points, the cell's geometry and the
card's peaks.  Everything below is plain arithmetic on those records, so the
tests can feed it synthetic timelines.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

__all__ = ["Interval", "Records", "records_from_profile", "window",
           "align", "union_ns", "busy_ns", "idle_pct", "device_ns",
           "span_ns",
           "breakdown", "SPAN_PREFIX", "REQUEST_SPAN"]

SPAN_PREFIX = "portbench."
REQUEST_SPAN = SPAN_PREFIX + "request"


@dataclass(frozen=True)
class Interval:
    """A named stretch of time, in nanoseconds on the profiler's clock."""

    name: str
    start: int
    end: int


@dataclass
class Records:
    """What a traced window left: device operations, harness spans, the
    number of traced ``requests``, for each of them the driver's summary
    of its points (``points``; ``drivers/_dcf.points_summary``), the
    cell's ``geometry`` and the card's ``peaks``
    (``roofline.peaks_for``) or None."""

    device_ops: list[Interval]
    spans: list[Interval]
    requests: int = 0
    points: list = field(default_factory=list)
    geometry: dict = field(default_factory=dict)
    peaks: dict | None = None


def records_from_profile(prof) -> tuple[list[Interval], list[Interval],
                                        int]:
    """(device operations, harness spans, clock skew in ns) of a finished
    ``torch.profiler.profile``.  Range annotations that the profiler
    mirrors onto the device's timeline are spans, not device work.  The
    device operations are put on the host's clock by ``align``."""
    from torch.autograd import DeviceType

    ops, spans, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        iv = Interval(name, start, start + e.duration_ns())
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == DeviceType.CPU:
                spans.append(iv)
        elif e.device_type() == DeviceType.CUDA:
            ops.append((iv, e.correlation_id()))
        elif name.startswith("cu"):
            # The runtime call that launched a device operation shares its
            # correlation id; torch's own operators number theirs apart,
            # and the numbers can coincide.
            launches[e.correlation_id()] = start
    spans.sort(key=lambda i: i.start)
    return align(ops, launches), spans, skew_of(ops, launches)


def skew_of(ops: list[tuple[Interval, int]], launches: dict) -> int:
    """The least (start - launch) over the operations with a known
    launch: the device clock's lead over the host's, launch latency
    included."""
    known = [iv.start - launches[c] for iv, c in ops if c in launches]
    return min(known) if known else 0


def align(ops: list[tuple[Interval, int]], launches: dict) -> list[Interval]:
    """Device operations on the host's clock.  The profiler converts the
    device's timestamps to the host's clock, and that conversion has been
    seen off by most of a second.  An operation cannot start before the
    host call that launched it (``launches``: correlation id -> the host
    call's start), and in a closed loop the first operation of a request
    starts within microseconds of its launch; so every operation is moved
    by the least (start - launch) over the operations with a known
    launch."""
    skew = skew_of(ops, launches)
    return sorted((Interval(iv.name, iv.start - skew, iv.end - skew)
                   for iv, _ in ops), key=lambda i: i.start)


def window(rec: Records) -> tuple[int, int] | None:
    """The traced window: from the first request's start to the last
    one's end; None where no request was traced."""
    reqs = [s for s in rec.spans if s.name == REQUEST_SPAN]
    if not reqs:
        return None
    return min(s.start for s in reqs), max(s.end for s in reqs)


def _clip(ivs, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(i.start, lo), min(i.end, hi)) for i in ivs
            if i.end > lo and i.start < hi]


def union_ns(pieces: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of half-open stretches, as sorted disjoint stretches."""
    out: list[list[int]] = []
    for a, b in sorted(pieces):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(rec: Records) -> int | None:
    """Nanoseconds of the window in which some device operation ran."""
    w = window(rec)
    if w is None:
        return None
    return sum(b - a for a, b in union_ns(_clip(rec.device_ops, *w)))


def idle_pct(rec: Records) -> float | None:
    """The share of the window, in %, in which no device operation ran;
    None without a window or without any device operation (a trace
    that saw no device says nothing of its idle share)."""
    w = window(rec)
    busy = busy_ns(rec)
    if w is None or not busy:
        return None
    return 100.0 * (1.0 - busy / (w[1] - w[0]))


def device_ns(rec: Records, match) -> int:
    """Summed device time, inside the window, of the operations whose
    name satisfies ``match``."""
    w = window(rec)
    if w is None:
        return 0
    return sum(b - a for a, b in
               _clip([o for o in rec.device_ops if match(o.name)], *w))


def span_ns(rec: Records, name: str) -> list[int]:
    """Durations of the harness spans called ``name`` inside the
    window."""
    w = window(rec)
    if w is None:
        return []
    return [s.end - s.start for s in rec.spans
            if s.name == name and w[0] <= s.start and s.end <= w[1]]


def _label_at(spans: list[Interval], starts: list[int], t: int) -> str:
    """The innermost harness span open at time t.  ``spans`` are sorted by
    start (``starts``); requests do not overlap and hold a few spans
    each, so the spans open at t are among the last few started."""
    i = bisect.bisect_right(starts, t)
    open_ = [s for s in spans[max(0, i - 8):i] if t < s.end]
    if not open_:
        return "no span (between requests)"
    return min(open_, key=lambda s: s.end - s.start).name


def breakdown(rec: Records, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and
    the idle time inside the window summed by the harness span that was
    open halfway through each gap (the gap count and the longest gap in
    the label), each list at most ``top`` long, in seconds."""
    w = window(rec)
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    by_name: dict[str, int] = {}
    for o in rec.device_ops:
        for a, b in _clip([o], *w):
            by_name[o.name] = by_name.get(o.name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union_ns(_clip(rec.device_ops, *w))
    gaps, t = [], w[0]
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w[1]:
        gaps.append((t, w[1]))
    spans = sorted(rec.spans, key=lambda s: s.start)
    starts = [s.start for s in spans]
    by_label: dict[str, list[int]] = {}
    for a, b in gaps:
        by_label.setdefault(_label_at(spans, starts, (a + b) // 2),
                            []).append(b - a)
    idle = sorted(by_label.items(), key=lambda kv: -sum(kv[1]))[:top]
    return {
        "device_ops": [[name, ns / 1e9] for name, ns in ops],
        "idle_gaps": [[f"{label} ({len(g)} gaps, longest {max(g) / 1e6} ms)",
                       sum(g) / 1e9] for label, g in idle],
    }
