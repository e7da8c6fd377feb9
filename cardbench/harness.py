"""One run of one cell: set-up, a measured window, the check, the result line.

Everything about a cell is found by name under the run's root: the cell in
``BENCHMARK.json``, its configuration's file, its traffic file
(``cardbench/traffic/<name>.json``), its limits
(``cardbench/limits/<cell>.json``), the driver of the traffic's ``kind``
(``driver``: the module ``cardbench.drivers.<kind>``) and each per-layer
metric's reader (``cardbench/metrics/<name>.py``).  A later cell, metric or
kind of traffic is added by adding those files and ``BENCHMARK.json``
entries.

A driver module holds ``Driver``, built from the run's ``Context`` (whose
``control`` asks for the program's own next-lower-precision path), and
``plant(fault, undo)``, which plants one of ``faults.FAULTS`` under the
driver's timed path and appends to ``undo`` what takes it out again.  A
``Driver`` has ``setup()`` (rows, program state, queries, warm-up: all of
set-up), ``call(i)`` (the window's i-th call, ending with its answers on
the host; returns the queries it answered), ``keep(traced)`` (keeps what
the last call produced for the check; ``traced`` during the profiled
calls), ``call_stats()`` (one dict of counters per kept call, for the
per-layer readers), ``release()`` (frees the program's state once the
window has closed and the peak memory is read) and ``check()`` (the
numbers held to the cell's limits, from the reference).  A driver whose
calls change the index inside the window restores its starting state in
``setup``, so that every run starts from the same rows, and its check
judges each kept answer against the rows live at that call.

The window runs ``--seconds`` of back-to-back calls (a closed loop with one
caller), each timed on the host from submit to its ids on the host.  With
``--trace 1`` the window is followed by ``trace_shape_calls`` calls under a
profiler that records the host's operators and shapes, then
``trace_calls`` under one that records the device alone (``devtrace``);
the metrics are then the cell's per-layer ones.  After the window the peak
memory is read, the program's state is freed, and the reference judges
what the window produced (``reference.checks``).
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

from cardbench import devtrace
from cardbench.reference import checks

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class NoResult(Exception):
    """The run must end without a result line."""


@dataclasses.dataclass
class Context:
    workload: str
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    cache_dir: Path
    snapshot_key: str
    control: bool = False


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise NoResult(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return dict(load_json(root / c["file"]), name=name)
    raise NoResult(f"no config {name!r} in BENCHMARK.json")


def load_traffic(root: Path, w: dict) -> dict:
    return load_json(root / "cardbench" / "traffic" / f"{w['traffic']}.json")


def driver_module(kind: str):
    """The module ``cardbench.drivers.<kind>``, which holds the kind's
    ``Driver`` and ``plant``."""
    name = f"cardbench.drivers.{kind}"
    if not kind.isidentifier():
        raise NoResult(f"no driver for traffic kind {kind!r}: {name} is no module's name")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as exc:
        if exc.name != name:
            raise
        raise NoResult(f"no driver for traffic kind {kind!r}: no module {name}") from None


def driver(kind: str):
    """The ``Driver`` class of traffic of kind ``kind``."""
    return driver_module(kind).Driver


def applies(metric: dict, workload: str, reported=()) -> bool:
    """Whether ``metric`` is reported in ``workload``: listed there, or,
    without a ``workloads`` key, in every cell that reports what it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def code_hash(root: Path, cfg: dict) -> str:
    """Key of a configuration's snapshot: the program's sources, the
    benchmark's code and the configuration itself."""
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for base, globs in ((root / "src" / "repro_torch", ("*.py", "*.cu", "*.cuh")),
                        (HERE, ("*.py",))):
        files = sorted({p for g in globs for p in base.rglob(g)} - set(base.rglob("tests/*")))
        for p in files:
            h.update(str(p.relative_to(base)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:20]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: Path, t_start: float,
        device: str = "cuda", control: bool = False, shrink=None) -> dict:
    """One run; returns the result line as a dict.  ``shrink(cfg, traffic)``
    (tests only) cuts the sizes for a run on the CPU."""
    bench = spec(root)
    w = cell(bench, workload)
    cfg = config(root, bench, w["config"])
    traffic = load_traffic(root, w)
    limits = load_json(root / "cardbench" / "limits" / f"{workload}.json")
    if shrink is not None:
        cfg, traffic = shrink(cfg, traffic)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            raise NoResult(f"{workload} needs {w['chips']} CUDA device(s)")
        from repro_torch.kernels import _cuda

        _cuda.build()
    ctx = Context(workload, cfg, traffic, int(seed), dev, root / "build" / "cardbench",
                  code_hash(root, dict(cfg, control=control)), control)
    drv = driver(traffic["kind"])(ctx)
    drv.setup()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    n_shape = traffic["trace_shape_calls"] if trace else 0
    n_device = traffic["trace_calls"] if trace else 0
    trace_dir = ctx.cache_dir / "trace"
    paths = {"shapes": None, "device": None}
    lat, answered, i = [], 0, 0

    def one(shapes=False):
        nonlocal answered, i
        c0 = time.perf_counter()
        answered += drv.call(i)
        c1 = time.perf_counter()
        lat.append(c1 - c0)
        drv.keep(shapes)
        i += 1
        return c0, c1

    def profiled(tag, n, name):
        """``n`` calls under one profiling pass; its timeline is written as
        soon as it stops, before another pass starts a session of its own.
        Returns the host's window around the calls."""
        prof = devtrace.profiler(shapes=tag == "shapes")
        sync()
        if prof is not None:
            prof.start()
        start = one(tag == "shapes")[0]
        for _ in range(n - 1):
            one(tag == "shapes")
        sync()
        end = time.perf_counter()
        if prof is not None:
            prof.stop()
            trace_dir.mkdir(parents=True, exist_ok=True)
            paths[tag] = trace_dir / name
            prof.export_chrome_trace(str(paths[tag]))
        return end - start

    # the window's calls run unprofiled; a traced run profiles its passes
    # after them, since a profiler slows the host loop even once stopped
    t0 = time.perf_counter()
    while one()[1] - t0 < seconds:
        pass
    n_plain = i
    if n_shape:
        profiled("shapes", n_shape, f"{workload}.json")
    dev_window_s = profiled("device", n_device, f"{workload}.device.json") if n_device else 0.0
    window_s = time.perf_counter() - t0
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    stats = drv.call_stats()
    drv.release()
    gc.collect()
    t_check = time.perf_counter()
    values = drv.check()
    print(f"cardbench: {len(lat)} calls in {window_s:.3f} s; the reference's check took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct, judged = checks.judge(values, limits["checks"])

    result = {"correct": correct, "attempted": answered, "failed": 0}
    totals = {
        "queries_per_s": answered / window_s,
        "setup_s": setup_s,
    }
    device_rec = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(0) if on_card else dev.type,
        "count": w["chips"] if on_card else 0,
        "memory_peak_bytes": peak,
    }
    metrics = {}
    if not trace:
        names = dict(traffic["end_to_end"], setup_s="setup_s")
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": totals[names[m["name"]]], "unit": m["unit"]}
    else:
        shapes = devtrace.Trace(paths["shapes"])
        dev_tr = devtrace.Trace(paths["device"], window_s=dev_window_s)
        reported = [m["name"] for m in bench["end_to_end"] if applies(m, workload)]
        rec = Record(ctx, stats, lat[:n_plain], stats[n_plain:n_plain + n_shape], n_device,
                     shapes, dev_tr)
        for m in bench["per_layer"]:
            if applies(m, workload, reported):
                v = importlib.import_module(f"cardbench.metrics.{m['name']}").read(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_rec.update(busy_s=dev_tr.busy_s, window_s=dev_tr.window_s)
        result["breakdown"] = shapes.breakdown(dev_tr)
    result["metrics"] = metrics
    result["device"] = device_rec
    found = forbidden_modules()
    if found:
        raise NoResult(f"modules of the JAX package or JAX are loaded: {found}")
    result["checks"] = judged
    return result


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the run's context, every call's
    counters (``call_stats``), the latencies of the unprofiled calls, the
    counters of the calls profiled with their shapes, how many calls the
    device-only pass profiled, that pass's trace (``device``) and the shapes
    pass's (``shapes``)."""

    ctx: Context
    calls: list
    latencies_s: list
    shape_calls: list
    n_device_calls: int
    shapes: devtrace.Trace
    device: devtrace.Trace
