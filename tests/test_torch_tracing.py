"""The port's spans (``dcf_tpu_torch.utils.tracing``) on the CPU: where
they open under ``torch.profiler``, that they change no share, that a
span site with no profiler constructs nothing, that they are plain
ranges the profiler does not mirror onto the device's timeline, and that
their names are the static list ``PERF.md`` documents."""

from __future__ import annotations

import ast
import pathlib
import re
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dcf_tpu_torch import Dcf, ReferenceContractWarning
from dcf_tpu_torch.utils import tracing

REPO = pathlib.Path(__file__).resolve().parent.parent
PREFIX = tracing.PREFIX

# (backend, lam, backend_opts): each of the four backends that carry the
# staged API's spans, at a 2-byte domain.
BACKENDS = {"walk": (16, {}), "prefix": (16, {}), "keylanes": (16, {}),
            "hybrid": (48, {"prefix_levels": 6})}


def _facade(backend: str, seed: int):
    lam, opts = BACKENDS[backend]
    rng = np.random.default_rng(seed)
    ck = [rng.bytes(32) for _ in range(max(18, 2 * (lam // 16)))]
    with warnings.catch_warnings():  # lam = 48 runs as an extension
        warnings.simplefilter("ignore", ReferenceContractWarning)
        dcf = Dcf(2, lam, ck, backend=backend, backend_opts=opts or None,
                  device="cpu")
    return dcf, rng


def _bundle(dcf, rng):
    return dcf.gen(rng.integers(0, 256, (1, 2), dtype=np.uint8),
                   rng.integers(0, 256, (1, dcf.lam), dtype=np.uint8),
                   rng=rng)


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name without the prefix, start, end) of the program's spans on the
    host, by start (a parent before a child that starts with it)."""
    out = [(e.name()[len(PREFIX):], e.start_ns(),
            e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_eval_holds_stage_eval_staged_and_fetch_in_order(backend):
    dcf, rng = _facade(backend, 11)
    bundle = _bundle(dcf, rng)
    xs = rng.integers(0, 256, (70, 2), dtype=np.uint8)
    dcf.eval(0, bundle, xs)  # ships the key image, builds any frontier
    _, spans = _traced(lambda: dcf.eval(0, bundle, xs))
    assert [s[0] for s in spans] == ["eval", "stage", "eval_staged", "fetch"]
    (_, lo, hi), inner = spans[0], spans[1:]
    assert all(lo <= a < b <= hi for _, a, b in inner)
    assert all(inner[i][2] <= inner[i + 1][1] for i in range(len(inner) - 1))


@pytest.mark.parametrize("backend,build", [
    ("prefix", ["frontier_build", "frontier_host_levels",
                "frontier_device_levels"]),
    ("hybrid", ["frontier_build", "frontier_device_levels"])])
def test_frontier_build_opens_on_a_partys_first_call_and_after_put_bundle(
        backend, build):
    dcf, rng = _facade(backend, 12)
    bundle = _bundle(dcf, rng)
    xs = rng.integers(0, 256, (40, 2), dtype=np.uint8)

    def frontier(b, bun):
        _, spans = _traced(lambda: dcf.eval(b, bun, xs))
        names = [s[0] for s in spans]
        got = [n for n in names if n.startswith("frontier")]
        if got:  # nested inside eval_staged, levels inside the build
            (_, lo, hi), = [s for s in spans if s[0] == "eval_staged"]
            (_, blo, bhi), = [s for s in spans if s[0] == "frontier_build"]
            assert lo <= blo < bhi <= hi
            assert all(blo <= a < e <= bhi for n, a, e in spans
                       if n.startswith("frontier_") and n != "frontier_build")
        return got

    assert frontier(0, bundle) == build
    assert frontier(0, bundle) == []
    assert frontier(1, bundle) == build
    assert frontier(1, bundle) == []
    assert frontier(0, _bundle(dcf, rng)) == build  # a new key image


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_shares_are_the_same_bytes_with_and_without_the_profiler(backend):
    dcf, rng = _facade(backend, 13)
    bundle = _bundle(dcf, rng)
    xs = rng.integers(0, 256, (90, 2), dtype=np.uint8)
    for b in (0, 1):
        plain = dcf.eval(b, bundle, xs)
        traced, spans = _traced(lambda: dcf.eval(b, bundle, xs))
        assert spans and traced.tobytes() == plain.tobytes()
        assert dcf.eval(b, bundle, xs).tobytes() == plain.tobytes()


def test_a_span_site_without_a_profiler_constructs_nothing(monkeypatch):
    made = []

    def built(name):
        made.append(name)
        raise AssertionError("a profiler range built with no profiler")

    monkeypatch.setattr(tracing, "_range", built)
    monkeypatch.setattr(torch.profiler, "record_function", built)
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span("eval") is tracing.span("launch")
    with tracing.span("stage") as inside:
        assert inside is None
    dcf, rng = _facade("prefix", 14)
    dcf.eval(0, _bundle(dcf, rng), rng.integers(0, 256, (40, 2),
                                                dtype=np.uint8))
    assert made == []


def test_spans_are_plain_ranges_that_the_profiler_does_not_mirror():
    # A user annotation (``record_function``) is mirrored onto the
    # device's timeline over the kernels launched inside it, where a
    # trace's reader would count it as device work; a plain range is not.
    dcf, rng = _facade("prefix", 15)
    bundle = _bundle(dcf, rng)
    xs = rng.integers(0, 256, (40, 2), dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dcf.eval(0, bundle, xs)
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PREFIX)]
    assert len(ours) >= 4
    assert not any(e.is_user_annotation() for e in ours)
    assert {e.activity_type() for e in ours} == {"cpu_op"}


def _span_literals() -> list:
    """The argument of every ``span(...)`` call in the port's sources
    (an ``ast.Constant`` where it is a literal)."""
    out = []
    for path in sorted((REPO / "dcf_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "span"):
                out.append((path.name, node.args[0] if node.args else None,
                            len(node.args) + len(node.keywords)))
    return out


def test_span_names_are_the_static_list_in_perf_md():
    text = (REPO / "PERF.md").read_text()
    para = text[text.index("\nProgram spans"):].split("\n\n")[0]
    documented = re.findall(r"`dcf_tpu_torch\.(\w+)`", para)
    assert len(documented) == len(set(documented)) == 8
    sites = _span_literals()
    assert len(sites) >= 18
    for where, arg, n_args in sites:
        # a static string and nothing else: no name or argument is built
        # from keys, seeds, points or shares
        assert n_args == 1 and isinstance(arg, ast.Constant), where
        assert arg.value in documented, where
    assert {arg.value for _, arg, _ in sites} == set(documented)
    assert not any("prefix_eval_kernel" in n or n.startswith("Memcpy")
                   for n in documented)
