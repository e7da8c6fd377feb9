"""A whole run at a tiny size on the CPU: the contract's result line, and
the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, spec

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_prints_the_contracts_line(run_tiny, cell, trace):
    res = run_tiny(cell, trace=trace)
    keys = [k for k in res if k != "breakdown"]
    assert keys == RESULT_KEYS  # the checks come last
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    b = spec()
    group = b["per_layer"] if trace else b["end_to_end"]
    declared = {m["name"]: m["unit"] for m in group}
    assert set(res["metrics"]) <= set(declared)
    for name, m in res["metrics"].items():
        assert m["unit"] == declared[name] and m["value"] == m["value"]
    if not trace:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in res["device"] and "busy_s" in res["device"]
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def test_same_seed_same_inputs():
    from cardbench import data

    cfg = {"data": "clustered", "dataset_seed": 7, "n_rows": 300, "d": 16}
    a = data.queries(cfg, 2**40 + 3, 50, "cpu")
    assert a.equal(data.queries(cfg, 2**40 + 3, 50, "cpu"))
    assert not a.equal(data.queries(cfg, 2**40 + 4, 50, "cpu"))
    assert data.catalog(cfg, "cpu").equal(data.catalog(cfg, "cpu"))


def test_query_set_fixed_or_drawn_by_the_run():
    from cardbench import data

    cfg = {"dataset_seed": 7}
    assert data.query_seed(cfg, {"query_set": "fixed"}, 2**40 + 3) == 7
    assert data.query_seed(cfg, {"query_set": "run"}, 2**40 + 3) == 2**40 + 3
    with pytest.raises(KeyError):
        data.query_seed(cfg, {"query_set": "published"}, 1)


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "sift1m.exact10k", "--seed",
         str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_without_a_card_no_result():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
