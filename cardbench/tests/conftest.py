"""Shared set-up of the benchmark's CPU tests: the checkout and its
``src`` on the path, a tiny copy of each cell, and a run root of its own
(so each test restores or builds its own snapshots)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("sift1m.batch10k", "glove1m.batch10k", "sift1m.exact10k")


def shrink(cfg, traffic):
    """The cell at a size the CPU runs in seconds: the same widths, metric,
    data and build settings, fewer rows and queries."""
    cfg = dict(cfg, n_rows=2000, build=dict(cfg["build"], wave=256))
    traffic = dict(traffic, queries_per_call=min(traffic["queries_per_call"], 96), pool_blocks=2,
                   warmup_calls=1, trace_shape_calls=1, trace_calls=2)
    for key in ("check_queries_per_block", "check_graph_rows"):
        if key in traffic:
            traffic[key] = 48
    return cfg, traffic


@pytest.fixture
def bench_root(tmp_path):
    """A run root holding ``BENCHMARK.json`` and the data files: the
    configurations, traffic and limits."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "traffic", "limits"):
        shutil.copytree(ROOT / "cardbench" / d, tmp_path / "cardbench" / d)
    return tmp_path


@pytest.fixture
def run_tiny(bench_root):
    from cardbench import harness

    def go(workload, *, trace=False, control=False, seed=2**33 + 17, seconds=0.3):
        return harness.run(workload, seed, seconds, trace, root=bench_root, t_start=0.0,
                           device="cpu", control=control, shrink=shrink)
    return go


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def kind(cell):
    """The kind of a cell's traffic, read from its traffic file."""
    from cardbench import harness

    return harness.load_traffic(ROOT, harness.cell(spec(), cell))["kind"]
