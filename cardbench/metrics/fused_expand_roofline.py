"""``fused_expand``'s share of its roofline over the calls profiled with
their shapes: the least time of the work those calls' inputs needed, at the
H100's HBM rate, over the kernel's device time in those calls.

The work is counted from the calls' own counters, never more than they
need: each live lane of each iteration (``sum n_iters``) reads its query
and candidate ids and reads and writes its beam; each fresh candidate
(``sum n_comps`` less the p entry points a lane may have) reads its row at
the table's width and its norm, probes one hash slot and is recorded (the
hash's fill, less the entry points).  Widths come from the shapes the
profiler recorded for ``repro_torch::fused_expand``.
"""

from cardbench import peaks


def read(rec):
    dims = rec.shapes.shapes.get("repro_torch::fused_expand")
    t = rec.shapes.kernel_time("fused_expand_kernel")
    calls = rec.shape_calls
    if not dims or t <= 0 or not calls or any(c.get("fill_sum") is None for c in calls):
        return None
    (_, d), _, (_, C), (_, e) = dims[0][:4]
    p = rec.ctx.cfg["build"]["n_seeds"]
    seeds = p * sum(c["queries"] for c in calls)
    lane_iters = sum(c["iters_sum"] for c in calls)
    fresh = max(0, sum(c["comps_sum"] for c in calls) - seeds)
    recorded = max(0, sum(c["fill_sum"] for c in calls) - seeds)
    nbytes = peaks.expand_bytes(lane_iters, C, e, d, 1, "fp32", fresh, fresh, recorded)
    bound_ms, _ = peaks.bound_ms(nbytes, 2.0 * d * fresh)
    return 100.0 * bound_ms * 1e-3 / t
