"""Nothing under portbench/ imports JAX, jaxlib, flax or the JAX package
``dcf_tpu`` (top-level names compared whole: ``dcf_tpu_torch`` is the
port), nothing reads the JAX package's ``benchmarks/``, and the plain
reference imports nothing of the port either.  The run refuses a process
that loaded JAX."""

import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dcf_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not _imports(path) & (FORBIDDEN | {"dcf_tpu_torch", "torch"})


def test_guard_compares_whole_names():
    # The scanner itself: dcf_tpu_torch passes, dcf_tpu and jax.numpy fail.
    assert "dcf_tpu_torch" not in FORBIDDEN
    src = "import dcf_tpu_torch.api\nfrom jax import numpy\nimport dcf_tpu.x\n"
    tops = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
            else n.module.split(".")[0]
            for n in ast.parse(src).body}
    assert tops & FORBIDDEN == {"jax", "dcf_tpu"}


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in HERE.rglob("*"):
        if path.suffix in (".py", ".json") and path.parent.name != "tests":
            assert "benchmarks/" not in path.read_text(), path


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    sys.path.insert(0, str(HERE))
    import run

    monkeypatch.setitem(sys.modules, "dcf_tpu_torch.fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "dcf_tpu.api", object())
    assert run.forbidden_modules() == ["dcf_tpu", "jax"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    sys.path.insert(0, str(HERE))
    import run

    rc = run.main(["--workload", "dcf-batch-n128-lam16.staged-2p20",
                   "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
