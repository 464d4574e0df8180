"""The generator: a configuration and a traffic mix in, the program
driven by them out.

A traffic mix (``traffic/<mix>.json``) is data: its ``driver`` names the
module ``drivers/<driver>.py`` that drives the program, and its other
keys are that driver's parameters (points, batches, warm-up requests,
the sample).  A new mix over an existing driver is a data file alone; a
new way of driving the program is a driver file of its own.  A driver
has

- ``inputs(cell)``: everything the run needs from the seed, made on the
  host; ``cell.inputs`` is what the reference reads, ``cell.host`` the
  driver's own, ``cell.evals_per_request`` the evaluations a request
  completes;
- ``setup(cell, mark)``: the program built, its keys made and shipped,
  its data staged, ``mark(name)`` after each phase;
- ``request(cell, i)``: request i (counting every request, warm-up
  ones too), finished on the device, returning what the program
  produced;
- ``sample(cell, i, out, plan)``: ``(query, answers, got)``: what the
  reference reads to work out sampled answers of request i by the
  ``plan``-th sampling plan, how many there are, and the program's
  answers there (None where they never came whole);
- ``advance(cell, i)``: between requests, outside their latency: fresh
  inputs for the next requests;
- ``geometry(cell)`` and ``points_summary(cell, calls)``: what the
  readers of the trace need of the cell and of each traced request.

``Cell`` keeps what every driver shares: the seed's three independent
streams (inputs, points, the sample), which requests of the window are
sampled, the harness's spans, and the faults the tests plant.  Program
objects live in ``cell.state`` and are freed when the window has closed.
"""

from __future__ import annotations

import contextlib
import importlib
import re
import time
from dataclasses import dataclass

import numpy as np

__all__ = ["Cell", "Sample", "load_driver"]

MODULE = re.compile(r"^[a-z][a-z0-9_]*$")


def load_driver(name: str):
    """The module ``drivers/<name>.py``."""
    if not MODULE.match(name):
        raise ValueError(f"driver name {name!r} is not a module name")
    return importlib.import_module(f"portbench.drivers.{name}")


@dataclass
class Sample:
    """Sampled answers of one request: ``query`` is what the reference
    reads, ``answers`` how many there are, ``got`` the program's (None
    where they never came whole)."""

    query: dict
    answers: int
    got: object = None


class Cell:
    """One configuration under one traffic mix, on ``device``.

    ``fault``, for tests only, is applied to each request's output as the
    program returns it (``faults.py``)."""

    SAMPLE_MAX = 48

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", trace: bool = False, fault=None):
        self.config, self.traffic = config, traffic
        self.driver = load_driver(traffic["driver"])
        self.device, self.trace, self.fault = device, trace, fault
        self.rng = dict(zip(("inputs", "points", "sample"),
                            (np.random.default_rng(s) for s in
                             np.random.SeedSequence(seed % (1 << 64))
                             .spawn(3))))
        self.sample_every = int(traffic["sample_every"])
        self.sample_offset = int(self.rng["sample"].integers(
            self.sample_every))
        self.inputs, self.host, self.state = {}, {}, {}
        self.evals_per_request = 0
        self.calls = 0
        self.advance_s = 0.0  # the window's refreshes, on the host's clock
        self._prev = None
        self.driver.inputs(self)

    def setup(self) -> None:
        """The driver's set-up, then ``warmup_requests`` requests with
        their sample and refresh, so that every shape the window uses is
        built."""
        marks = [("start", time.perf_counter())]

        def mark(name):
            self.sync()
            marks.append((name, time.perf_counter()))

        self.driver.setup(self, mark)
        for _ in range(int(self.traffic["warmup_requests"])):
            self.warm()
        mark("warm-up requests")
        self.setup_phases = {name: t - marks[i][1]
                             for i, (name, t) in enumerate(marks[1:])}

    def warm(self) -> None:
        """One request outside the window (no request span), its sample
        and its refresh."""
        i = self.calls
        self.calls += 1
        out = self.driver.request(self, i)
        self.driver.sample(self, i, out, 0)
        self._prev = out
        self.driver.advance(self, i)

    def span(self, name: str):
        """A harness span around a call into the program (traced runs)."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("portbench." + name)

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize(self.device)

    def request(self):
        """The next request: (its index, the program's output, a fault in
        tests applied)."""
        i = self.calls
        self.calls += 1
        with self.span("request"):
            out = self.driver.request(self, i)
        if self.fault is not None:
            out, self._prev = self.fault(out, self._prev, i), out
        return i, out

    def advance(self, i: int) -> None:
        t0 = time.perf_counter()
        self.driver.advance(self, i)
        self.advance_s += time.perf_counter() - t0

    def sampled(self, r: int) -> bool:
        """Whether the window's r-th request is sampled."""
        return (r % self.sample_every == self.sample_offset
                and r // self.sample_every < self.SAMPLE_MAX)

    def sample(self, r: int, i: int, out) -> Sample:
        """The sample of the window's r-th request, request i (its answers
        stay on the device until the window has closed)."""
        return Sample(*self.driver.sample(self, i, out,
                                          r // self.sample_every))

    def close(self) -> None:
        """Free the program's state on the device."""
        self.state.clear()
        self._prev = None
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()
