"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix and per-layer metric loads, names keep to the contract's characters, and
each per-layer metric's cells report the end-to-end metric it moves."""

import importlib.util
import json
import re

import pytest

from portbench.common import HERE, ROOT, benchmark, cell_spec, end_to_end_names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = benchmark()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    spec = cell_spec(cell)
    assert NAME.match(cell) and NAME.match(spec["traffic"]) and NAME.match(spec["config"])
    assert spec["chips"] == 1 and 1 <= len(spec["why"]) <= 200 and "\n" not in spec["why"]
    assert (HERE / "traffic" / f"{spec['mix']['kind']}.py").exists()
    assert spec["mix"]["limits"], "every cell compares something"
    names = end_to_end_names(cell)
    assert "setup_s" in names and len(names) >= 2
    assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"].startswith("portbench/") and data["name"] == cfg["name"]
    assert cfg["reduced"] == data["reduced"] == []
    assert cfg["source"].startswith("https://") and len(cfg["why"]) <= 200
    used = {w["config"] for w in BENCH["workloads"]}
    assert cfg["name"] in used


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
        for cell in metric["workloads"]:
            assert metric["moves"] in end_to_end_names(cell), f"{cell} does not report {metric['moves']}"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    spec = importlib.util.spec_from_file_location("reader", HERE / "metrics" / f"{metric['name']}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert callable(reader.read)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, f"PERF.md's list of layers lacks {layer!r}"
