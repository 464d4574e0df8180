"""The program's own spans in a traced window, and what they read.

While a torch profiler records, the port opens host ranges named
``dcf_tpu_torch.*`` at the boundaries of its layers
(``dcf_tpu_torch/utils/tracing.py``).  They are plain ranges, not user
annotations, so the profiler mirrors none of them onto the device's
timeline and ``trace.records_from_profile`` reads the same device work
with them as without.  That reader keeps only the harness's own ranges
(``portbench.*``) as spans, and a per-layer reader is handed only its
``trace.Records``; so the readers of the program's spans take them from
the finished profile itself (``of_profile``), which the harness holds in
the frame that calls them (``from_caller``).  Everything else is plain
arithmetic on ``trace.Records`` and these spans, so the tests can feed
it synthetic timelines.  On a program that opens no such span every
reading here is None.
"""

from __future__ import annotations

import bisect
import itertools
import sys

from portbench import trace
from portbench.trace import Interval, Records

__all__ = ["PREFIX", "of_profile", "from_caller", "total_ns", "self_ns",
           "idle_in_ns", "per_request_ms", "idle_gaps"]

PREFIX = "dcf_tpu_torch."


def of_profile(prof) -> list[Interval]:
    """The program's host ranges in a finished ``torch.profiler.profile``,
    sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(PREFIX) and e.device_type() == DeviceType.CPU:
            start = e.start_ns()
            out.append(Interval(name, start, start + e.duration_ns()))
    return sorted(out, key=lambda s: s.start)


def from_caller() -> list[Interval] | None:
    """The program's spans in the profile of the traced run whose metrics
    are being read: the nearest frame up the stack that holds a
    ``torch.profiler.profile`` (the harness's ``prof``); None where no
    frame holds one."""
    from torch.profiler import profile

    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, profile) and v.profiler is not None:
                return of_profile(v)
        f = f.f_back
    return None


def _inside(rec: Records, spans, name: str) -> list[Interval]:
    """The spans called ``PREFIX + name`` inside the window."""
    w = trace.window(rec)
    if w is None or not spans:
        return []
    return [s for s in spans
            if s.name == PREFIX + name and w[0] <= s.start and s.end <= w[1]]


def total_ns(rec: Records, spans, name: str) -> int | None:
    """The summed time of the spans called ``name`` inside the window;
    None where there is none."""
    mine = _inside(rec, spans, name)
    return sum(s.end - s.start for s in mine) if mine else None


def self_ns(rec: Records, spans, name: str) -> int | None:
    """The time of the spans called ``name`` inside the window, less the
    part that the program's spans nested in them cover; None where there
    is none."""
    mine = _inside(rec, spans, name)
    if not mine:
        return None
    starts = [s.start for s in spans]
    total = 0
    for s in mine:
        kids = [(c.start, c.end) for c in
                spans[bisect.bisect_left(starts, s.start):
                      bisect.bisect_left(starts, s.end)]
                if c is not s and c.end <= s.end]
        total += s.end - s.start - sum(b - a for a, b in trace.union_ns(kids))
    return total


def _overlap_ns(xs, ys) -> int:
    """The time that two lists of sorted disjoint stretches share."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        total += max(0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_ns(rec: Records, spans, name: str) -> int | None:
    """The time of the spans called ``name`` inside the window that no
    device operation covers; None where there is none."""
    mine = trace.union_ns([(s.start, s.end)
                           for s in _inside(rec, spans, name)])
    if not mine:
        return None
    w = trace.window(rec)
    busy = trace.union_ns([(max(o.start, w[0]), min(o.end, w[1]))
                           for o in rec.device_ops
                           if o.end > w[0] and o.start < w[1]])
    return sum(b - a for a, b in mine) - _overlap_ns(mine, busy)


def per_request_ms(rec: Records, ns: int | None) -> float | None:
    """``ns`` over the traced requests, in milliseconds; None where
    either is missing."""
    if ns is None or not rec.requests:
        return None
    return ns / 1e6 / rec.requests


def _label_at(spans: list[Interval], starts: list[int], reach: list[int],
              t: int) -> str | None:
    """The innermost span open at time t (the shortest of those open).
    ``spans`` are sorted by start (``starts``; ``reach[j]``: the latest
    end among spans[:j + 1]): the search goes back from the last span
    started by t until no span started earlier is still open."""
    best = None
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0 and reach[j] > t:
        s = spans[j]
        if t < s.end and (best is None
                          or s.end - s.start <= best.end - best.start):
            best = s
        j -= 1
    return None if best is None else best.name


def idle_gaps(rec: Records, spans, top: int = 10) -> list:
    """The window's idle time on the device split at every span boundary,
    each piece summed under the innermost span over it, harness's or
    program's: [[label (pieces), seconds], ...], at most ``top``, most
    idle first.  ``trace.breakdown`` labels a whole gap by the harness
    span open at its midpoint; this is the finer reading for a probe."""
    w = trace.window(rec)
    if w is None:
        return []
    every = sorted([*rec.spans, *(spans or [])], key=lambda s: s.start)
    starts = [s.start for s in every]
    reach = list(itertools.accumulate((s.end for s in every), max))
    cuts = sorted({t for s in every for t in (s.start, s.end)
                   if w[0] < t < w[1]})
    busy = trace.union_ns([(max(o.start, w[0]), min(o.end, w[1]))
                           for o in rec.device_ops
                           if o.end > w[0] and o.start < w[1]])
    gaps, t = [], w[0]
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w[1]:
        gaps.append((t, w[1]))
    by_label: dict[str, list[int]] = {}
    for a, b in gaps:
        edges = [a, *cuts[bisect.bisect_right(cuts, a):
                          bisect.bisect_left(cuts, b)], b]
        for lo, hi in zip(edges, edges[1:]):
            label = (_label_at(every, starts, reach, lo)
                     or "no span (between requests)")
            by_label.setdefault(label, []).append(hi - lo)
    idle = sorted(by_label.items(), key=lambda kv: -sum(kv[1]))[:top]
    return [[f"{label} ({len(g)} pieces)", sum(g) / 1e9]
            for label, g in idle]
