"""The program's own spans in a cell: host time by span without a profiler,
and device time by the span that launched it.

    python3 cardbench/spans.py --workload <name> --seed <n> [--calls 10] [--out DIR]

Sets the cell up as a run does (``harness``: the same snapshot, queries and
entry points), then, before any profiler starts in the process (a profiler
slows every later call of it):

  * the span pass: ``--calls`` calls with an ``obs.InMemoryTracker``
    attached (``OnlineIndex.tracker`` for ``ann_batch``, ``tracker=`` of
    ``brute_force_knn`` for ``exact``), each after an untraced call of the
    same kind, so the two means give the cost of tracing on;
  * the attributed timeline: the traffic's ``trace_calls`` calls under
    ``torch.profiler`` with the host's operators and the device, the
    tracker attached, so that each span is a range of its own name there.
    Each device event goes to the innermost program range (``index/``,
    ``search/``, ``brute/``) that holds the runtime call which launched it,
    matched by ``args.correlation``.

Writes the span pass's events (``<cell>.spans.jsonl``) and the timeline
(``<cell>.spans.json``) under ``--out`` (default ``build/cardbench/trace``)
and prints the summary as one JSON line.  Device numbers come only from a
card: on the CPU they are None.

``run`` and ``main`` repeat the harness's set-up because a run of
``run.py`` attaches no tracker; once it runs a span pass of its own, they
go, and ``device_by_span`` and ``summary`` stay as its readers' helpers.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = ("index/", "search/", "brute/")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WAITS = ("Synchronize", "Memcpy")  # runtime calls that may wait for the card


def _innermost(ranges, points):
    """For each point event, the name of the innermost range of the same
    thread whose interval holds the point's start (None outside every
    range).  Ranges of one thread nest: they are context managers."""
    by_thread = collections.defaultdict(lambda: ([], []))
    for r in ranges:
        by_thread[(r.get("pid"), r.get("tid"))][0].append(r)
    for p in points:
        by_thread[(p.get("pid"), p.get("tid"))][1].append(p)
    out = {}
    for rs, ps in by_thread.values():
        rs.sort(key=lambda r: (r["ts"], -r["dur"]))
        stack, ri = [], 0
        for p in sorted(ps, key=lambda e: e["ts"]):
            while ri < len(rs) and rs[ri]["ts"] <= p["ts"]:
                r = rs[ri]
                ri += 1
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < r["ts"]:
                    stack.pop()
                stack.append(r)
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < p["ts"]:
                stack.pop()
            out[id(p)] = stack[-1]["name"] if stack else None
    return out


def device_by_span(events):
    """Read a chrome trace's complete events: device seconds by the
    innermost program range that launched them (``device_s``; None for
    device work launched outside every program range), the count of each
    program range (``ranges``), all device seconds (``total_s``) and the
    runtime calls that may wait for the card, by the range that made them
    (``waits``: "range > call" -> count)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = [e for e in events if e.get("cat") in RANGE_CATS
              and str(e.get("name", "")).startswith(PROGRAM)]
    runtime = [e for e in events if e.get("cat") in RUNTIME_CATS]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    where = _innermost(ranges, runtime)
    launched_in = {e["args"]["correlation"]: where[id(e)] for e in runtime
                   if "correlation" in e.get("args", {})}
    device_s = collections.Counter()
    for e in device:
        device_s[launched_in.get(e.get("args", {}).get("correlation"))] += e["dur"] * 1e-6
    waits = collections.Counter(f"{where[id(e)]} > {e['name']}" for e in runtime
                                if any(w in e["name"] for w in WAITS))
    return {
        "device_s": device_s,
        "ranges": collections.Counter(e["name"] for e in ranges),
        "total_s": sum(e["dur"] for e in device) * 1e-6,
        "waits": waits,
    }


def host_by_span(span_events, calls: int) -> dict:
    """Host time by span name over ``calls`` calls: spans a call, mean ms a
    span, and ms a call."""
    durs = collections.defaultdict(list)
    for e in span_events:
        durs[e["name"]].append(e["dur_s"])
    return {name: {"per_call": len(v) / calls, "mean_ms": 1e3 * statistics.fmean(v),
                   "ms_per_call": 1e3 * sum(v) / calls}
            for name, v in sorted(durs.items())}


def summary(span_events, timeline, calls: int, profiled_calls: int) -> dict:
    """The numbers a cell's spans give (see the module doc): host time by
    span from the span pass, device time by span, range counts and waits a
    call from the attributed timeline (device numbers None without device
    events), and three per-layer quantities: ``search_issue_ms_per_iter``,
    ``search_update_device_ms_per_iter`` and ``brute_topk_device_ms_per_tile``."""
    host = host_by_span(span_events, calls)
    dev = device_by_span(timeline)
    on_device = dev["total_s"] > 0

    def per_call(counter):
        return {str(k): v / profiled_calls for k, v in counter.items()}

    def device_ms(name, per):
        n = dev["ranges"].get(per, 0)
        return 1e3 * dev["device_s"].get(name, 0.0) / n if on_device and n else None

    out = {
        "host": host,
        "device_ms_per_call": {k: 1e3 * v for k, v in per_call(dev["device_s"]).items()}
        if on_device else None,
        "device_total_ms_per_call": 1e3 * dev["total_s"] / profiled_calls if on_device else None,
        "ranges_per_call": per_call(dev["ranges"]),
        "waits_per_call": per_call(dev["waits"]),
    }
    if "search/step" in host:
        loop = sum(host[n]["ms_per_call"] for n in ("search/step", "search/done_read") if n in host)
        out["search_issue_ms_per_iter"] = host["search/step"]["mean_ms"]
        out["step_and_done_share_of_index_search"] = (
            loop / host["index/search"]["ms_per_call"] if "index/search" in host else None)
        out["search_update_device_ms_per_iter"] = device_ms("search/update", "search/step")
        out["search_update_device_share"] = (
            dev["device_s"].get("search/update", 0.0) / dev["total_s"] if on_device else None)
    if "brute/tile" in host:
        out["brute_topk_device_ms_per_tile"] = device_ms("brute/topk", "brute/tile")
    return out


def run(workload: str, seed: int, *, root: Path = ROOT, calls: int = 10, out_dir=None,
        device: str = "cuda", shrink=None) -> dict:
    """Set the cell up, run both passes, write their records and return
    the summary.  ``shrink`` (tests only) cuts the sizes for the CPU."""
    import torch

    from cardbench import harness
    from repro_torch.core.brute import brute_force_knn
    from repro_torch.obs import InMemoryTracker

    bench = harness.spec(root)
    w = harness.cell(bench, workload)
    cfg = harness.config(root, bench, w["config"])
    traffic = harness.load_traffic(root, w)
    if shrink is not None:
        cfg, traffic = shrink(cfg, traffic)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise harness.NoResult(f"{workload} needs a CUDA device")
        from repro_torch.kernels import _cuda

        _cuda.build()
    ctx = harness.Context(workload, cfg, traffic, int(seed), dev, root / "build" / "cardbench",
                          harness.code_hash(root, dict(cfg, control=False)))
    kind = traffic["kind"]
    if kind not in ("ann_batch", "exact"):
        raise harness.NoResult(f"spans.py attaches no tracker to traffic of kind {kind!r}")
    driver = harness.driver(kind)(ctx)
    driver.setup()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def call(i, tracker):
        """One call of the window's kind; the ids reach the host."""
        if kind == "ann_batch":
            driver.index.tracker = tracker
            driver.call(i)
        elif tracker is None:
            driver.call(i)
        else:
            b = i % len(driver.pool)
            brute_force_knn(driver.x_in, driver.pool_in[b], traffic["top_k"],
                            cfg["build"]["metric"], device=dev, tracker=tracker)[0].cpu()

    sync()
    trk = InMemoryTracker()
    plain_s, traced_s = [], []
    for i in range(calls):
        for tracker, times in ((None, plain_s), (trk, traced_s)):
            t0 = time.perf_counter()
            call(i, tracker)
            times.append(time.perf_counter() - t0)
    span_events = trk.span_events

    n_prof = traffic["trace_calls"]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = Path(out_dir) if out_dir is not None else ctx.cache_dir / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    timeline_path = out_dir / f"{workload}.spans.json"
    prof_trk = InMemoryTracker()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n_prof):
            call(calls + i, prof_trk)
        sync()
    prof.export_chrome_trace(str(timeline_path))
    with open(out_dir / f"{workload}.spans.jsonl", "w") as f:
        for e in span_events:
            f.write(json.dumps(e) + "\n")
    with open(timeline_path) as f:
        timeline = json.load(f).get("traceEvents", [])
    res = summary(span_events, timeline, calls, n_prof)
    res.update(
        workload=workload, seed=int(seed), calls=calls, profiled_calls=n_prof,
        device=torch.cuda.get_device_name(0) if on_card else dev.type,
        plain_call_ms=[1e3 * t for t in plain_s], traced_call_ms=[1e3 * t for t in traced_s],
        tracing_cost=statistics.fmean(traced_s) / statistics.fmean(plain_s) - 1.0,
    )
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cardbench import harness

    try:
        res = run(args.workload, args.seed, calls=args.calls, out_dir=args.out)
    except harness.NoResult as exc:
        print(f"cardbench/spans: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
