"""A kind of traffic is found by name: ``harness.driver(kind)`` imports
``cardbench.drivers.<kind>``, and ``faults.plant`` plants through that
module's ``plant``.  So a new kind is a new driver module and its data
files, with the harness as it is; an unknown kind ends the run without a
result."""

import json
import shutil
import sys
import types

import pytest

from conftest import shrink

TOY = "cardbench.drivers.toy_exact"


def _toy_module():
    """A driver module of its own that wraps the exact driver and counts
    the window's calls."""
    from cardbench.drivers import exact

    class Driver(exact.Exact):
        calls = 0

        def call(self, i):
            type(self).calls += 1
            return super().call(i)

    mod = types.ModuleType(TOY)
    mod.Driver, mod.plant = Driver, exact.plant
    return mod


def _add_cell(root, name, traffic, kind):
    """A cell ``name`` of sift1m under a copy of the exact traffic of kind
    ``kind``, with the exact cell's limits and end-to-end metric, written
    as data files under the run root."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "sift1m", "traffic": traffic, "chips": 1,
                               "why": "a toy kind of traffic"})
    for m in bench["end_to_end"]:
        if m["name"] == "exact_qps":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = json.loads((root / "cardbench" / "traffic" / "exact10k.json").read_text())
    (root / "cardbench" / "traffic" / f"{traffic}.json").write_text(json.dumps(dict(tr, kind=kind)))
    shutil.copy(root / "cardbench" / "limits" / "sift1m.exact10k.json",
                root / "cardbench" / "limits" / f"{name}.json")


def _run(root, name):
    from cardbench import harness

    return harness.run(name, 2**33 + 29, 0.3, False, root=root, t_start=0.0, device="cpu",
                       shrink=shrink)


def test_a_new_kind_is_a_new_module(bench_root, monkeypatch):
    from cardbench import faults, harness

    toy = _toy_module()
    monkeypatch.setitem(sys.modules, TOY, toy)
    _add_cell(bench_root, "sift1m.toy", "toy", "toy_exact")
    assert harness.driver("toy_exact") is toy.Driver

    res = _run(bench_root, "sift1m.toy")
    assert res["correct"] is True, res["checks"]
    assert toy.Driver.calls > 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"exact_qps", "setup_s"}

    remove = faults.plant("half_batch", "toy_exact")
    try:
        assert _run(bench_root, "sift1m.toy")["correct"] is False
    finally:
        remove()


@pytest.mark.parametrize("kind", ["no_such_kind", "exact.py", "../exact"])
def test_an_unknown_kind_ends_in_no_result(bench_root, kind):
    from cardbench import faults, harness

    _add_cell(bench_root, "sift1m.unknown", "unknown", kind)
    with pytest.raises(harness.NoResult, match="no driver for traffic kind"):
        _run(bench_root, "sift1m.unknown")
    with pytest.raises(harness.NoResult):
        faults.plant("half_batch", kind)


def test_the_no_result_names_the_module_it_looked_for():
    from cardbench import harness

    with pytest.raises(harness.NoResult, match=r"cardbench\.drivers\.no_such_kind"):
        harness.driver("no_such_kind")
