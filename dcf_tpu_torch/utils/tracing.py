"""Spans at the boundaries of the port's layers, on the profiler's clock.

``span(name)`` opens a profiler range named ``"dcf_tpu_torch." + name``
while a torch profiler records, and otherwise hands back one shared
no-op context: a span site then costs one enabled check, with no
allocation and no clock read.  The range is a plain one
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): the profiler mirrors a user
annotation onto the device's timeline, over the kernels launched inside
it, where a reader of the trace would take it for device work.

Spans are on exactly while a profiler runs (the benchmark's traced runs,
the CLI's ``--profile DIR``, an operator's own profiler) and need no
switch of their own.  The profiler stamps them; the library reads no
clock.  A span's count in a trace is its counter.

Names are static strings, never built from keys, seeds, points or
shares, and carry no arguments.  Every site, and what it covers:

    eval                    ``api.Dcf.eval``, the whole facade call
    stage                   a backend's ``stage`` (and ``WalkBackend.eval``'s
                            inline staging): validation, pad, copy up
    eval_staged             a backend's ``eval_staged``: its checks, the
                            frontier lookup, the op's checks, the launch
    fetch                   a backend's ``staged_to_bytes``: the copy back
    launch                  ``ops._launch.launch_checked``: every kernel
                            launch
    frontier_build          one frontier build (a cache miss)
    frontier_host_levels    its host levels (``tree_expand_np``)
    frontier_device_levels  its device levels (kernel B2, or B5a)
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["PREFIX", "span"]

PREFIX = "dcf_tpu_torch."

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A range named ``PREFIX + name`` while a profiler records, else the
    shared no-op context."""
    if _recording():
        return _range(PREFIX + name)
    return _OFF
