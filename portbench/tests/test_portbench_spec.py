"""BENCHMARK.json against the benchmark's contract, and the data-driven
layout: every configuration, traffic mix and per-layer metric that it
names has its own file where the harness looks for it."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys_and_valid_names():
    shapes = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer",
                            "moves"}}
    for kind, keys in shapes.items():
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"])
            for text in ("why", "source", "layer"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200
                    assert "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files_and_reports_enough(cell):
    bench, _, config, traffic = harness.load_cell(cell["name"])
    assert cell["chips"] == 1
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    assert (harness.HERE / "reference" / f"{config['reference']}.py").exists()
    assert config["name"] == cell["config"]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert conf["file"].startswith("portbench/configs/")
    assert set(conf["reduced"]) == set(config["reduced"])
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    for name in e2e:
        assert (harness.HERE / "metrics" / f"{name}.py").exists()
    per = [m for m in bench["per_layer"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert per
    for m in per:
        assert m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_every_configuration_is_used_and_layers_are_named_alike():
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"kernels", "facade", "backend", "device"}
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["source"] == "device_trace"
