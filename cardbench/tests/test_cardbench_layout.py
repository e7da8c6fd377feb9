"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import importlib
import json
import re

import pytest

from conftest import CELLS, ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "cardbench/run.py"]
    assert b["paths"] == ["cardbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    b = spec()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cardbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    b = spec()
    e2e = [m for m in b["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = [m for m in b["per_layer"] if cell in m.get("workloads", [])]
    assert layer and all(m["moves"] in names for m in layer)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    from cardbench import harness

    b = spec()
    w = harness.cell(b, cell)
    cfg = harness.config(ROOT, b, w["config"])
    assert cfg["reduced"] == [] and cfg["assumed"]
    traffic = json.loads((ROOT / "cardbench" / "traffic" / f"{w['traffic']}.json").read_text())
    mod = harness.driver_module(traffic["kind"])
    assert harness.driver(traffic["kind"]) is mod.Driver and callable(mod.plant)
    limits = json.loads((ROOT / "cardbench" / "limits" / f"{cell}.json").read_text())
    assert limits["checks"]
    for m in b["end_to_end"]:
        if harness.applies(m, cell) and m["name"] != "setup_s":
            assert m["name"] in traffic["end_to_end"]


@pytest.mark.parametrize("name", [m["name"] for m in spec()["per_layer"]])
def test_metric_reader_loads_by_name(name):
    mod = importlib.import_module(f"cardbench.metrics.{name}")
    assert callable(mod.read)
