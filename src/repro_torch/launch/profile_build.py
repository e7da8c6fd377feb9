"""Where the time of an online build goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_build [--precision P]

1. The knn-lgd build (``configs.knn_lgd``, at ``--precision``, default fp32)
   over its 10^6 rows, on the launcher's data and seeds, with its wall time
   split between the insertion searches, ``merge.merge_candidates`` and the
   rest of ``commit_wave``.  Each part is timed on the host clock between
   ``torch.cuda.synchronize()`` calls, once per wave.
2. The same build over its first ``PROFILE_ROWS`` rows under
   ``torch.profiler``: the device's busy share of the profiled wall time,
   the device time per launch of each of the port's kernels, and the
   ``TOP`` kernels by device time.
3. That build once more, counted: the mean fresh, valid and recorded
   candidates per ``fused_expand`` launch, and the least time a launch with
   those means could take on an H100 (``expand_bytes``, the count
   ``chip_smoke.py`` uses at its synthetic state).

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import knn_lgd
from repro_torch.core import construct, merge
from repro_torch.core import search as search_lib
from repro_torch.kernels import ops
from repro_torch.kernels.precision import PRECISIONS
from repro_torch.launch import build_graph

PROFILE_ROWS = 200_000
TOP = 20
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, and the rate
# for products of each operand type: fp32 on the CUDA cores (IEEE fp32 has
# no tensor-core form), bf16 x bf16 with fp32 sums on the tensor cores
# (dense), whose products are exact in fp32
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FLOP_PER_S = {"fp32": FP32_FLOP_PER_S, "bf16": 989e12}
ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}
# ~0.1 s at the H100's clock: longer than the host takes to queue one timing
SPIN_CYCLES = 200_000_000
# the port's kernels by their CUDA function names (csrc/*.cu); the name
# covers every storage type a kernel is instantiated for
PORT_KERNELS = ("gather_distance_kernel", "fused_expand_kernel", "pairwise_kernel")


def bound_ms(nbytes: float, flops: float, operands: str = "fp32") -> tuple[float, str]:
    """Least time on an H100: the larger of bytes over the HBM rate and flops
    over the card's rate for products of ``operands`` ("fp32" or "bf16", both
    operands of that type), and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[operands] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fns, warmup=2) -> float:
    """Mean device time of one call, over calls fns[0], fns[1], ... (CUDA
    events around the whole run, after ``warmup`` calls).  A spin kernel
    holds the stream while the host queues the calls, so the events time the
    device's work back to back and not the host's rate of launching it
    (unless a call waits on the device itself)."""
    for f in fns[:warmup]:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for f in fns[warmup:]:
        f()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (len(fns) - warmup)


def expand_bytes(B, C, e, d, P, precision, fresh, valid, inserted) -> float:
    """Bytes one ``fused_expand`` launch must move: queries, candidate ids,
    the fresh rows at the table's width (int8 with its scale) and their
    norms, ``P`` probed hash ids per valid candidate, the recorded
    (id, dist) pairs, the beam in and out (id, dist, flag) and comps."""
    row_bytes = ELEM_BYTES[precision] * d + (4 if precision == "int8" else 0)
    return (4 * (B * d + B * C + fresh) + fresh * row_bytes + 4 * valid * P + 8 * inserted
            + 2 * B * e * 9 + 4 * B)


def count_expansions(x: torch.Tensor, cfg: construct.BuildConfig) -> dict:
    """Build over x counting, per ``fused_expand`` launch, the fresh (comps),
    valid (id >= 0) and recorded candidates; returns their means and the
    bound at those means."""
    sums = {"launches": 0, "shape_bytes": 0.0}
    dev = {k: torch.zeros((), dtype=torch.int64, device=x.device)
           for k in ("fresh", "valid", "inserted")}
    saved = (search_lib.step, ops.expand_step)

    def step(g, x_, q, st, cfg_, enc=None, **kw):
        new = saved[0](g, x_, q, st, cfg_, enc, **kw)
        dev["fresh"] += (new.n_comps - st.n_comps).sum()
        dev["inserted"] += (new.fill - st.fill).sum()
        return new

    def expand_step(q, x_, cands, *args, **kw):
        B, C = cands.shape
        e, d = args[0].shape[1], q.shape[1]
        dev["valid"] += (cands >= 0).sum()
        sums["launches"] += 1
        sums["shape_bytes"] += expand_bytes(B, C, e, d, 0, cfg.precision, 0, 0, 0)
        return saved[1](q, x_, cands, *args, **kw)

    search_lib.step, ops.expand_step = step, expand_step
    try:
        _build(x, cfg)
    finally:
        search_lib.step, ops.expand_step = saved
    n = sums["launches"]
    mean = {k: int(v) / n for k, v in dev.items()}
    d = x.shape[1]
    nbytes = sums["shape_bytes"] / n + expand_bytes(
        0, 0, 0, d, cfg.search_config().hash_probes, cfg.precision, mean["fresh"], mean["valid"],
        mean["inserted"])
    b, how = bound_ms(nbytes, 2 * d * mean["fresh"])
    return {"launches": n, **mean, "bytes": nbytes, "bound_ms": b, "bound_by": how}


def _timed(totals, name, fn):
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0
        return out

    return run


def _build(x, cfg):
    gen = torch.Generator(device=x.device).manual_seed(build_graph.BUILD_SEED)
    return construct.build(x, cfg, generator=gen, device=x.device)


def split_build(x: torch.Tensor, cfg: construct.BuildConfig) -> dict:
    """Build over x with the search, the merge and the commit timed apart."""
    totals = collections.Counter()
    saved = (search_lib.search, merge.merge_candidates, construct.commit_wave)
    search_lib.search = _timed(totals, "search", saved[0])
    merge.merge_candidates = _timed(totals, "merge_candidates", saved[1])
    construct.commit_wave = _timed(totals, "commit_wave", saved[2])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _build(x, cfg)
        torch.cuda.synchronize()
        totals["build"] = time.perf_counter() - t0
    finally:
        search_lib.search, merge.merge_candidates, construct.commit_wave = saved
    return totals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="fp32", choices=list(PRECISIONS))
    args = ap.parse_args(argv)
    dev = device_lib.resolve(None)
    cfg = dataclasses.replace(knn_lgd.full_config(), precision=args.precision)
    n = knn_lgd.N_ROWS
    x = build_graph.make_data(n, knn_lgd.D, cfg.metric, dev)
    _build(x[:20_000], cfg)  # warm-up: kernel build and first launches

    t = split_build(x, cfg)
    commit_rest = t["commit_wave"] - t["merge_candidates"]
    other = t["build"] - t["search"] - t["commit_wave"]
    print(f"build n={n} W={cfg.wave} precision={cfg.precision}: {t['build']:.3f} s = search {t['search']:.3f} s"
          f" + merge_candidates {t['merge_candidates']:.3f} s + rest of commit_wave "
          f"{commit_rest:.3f} s + other {other:.3f} s")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _build(x[:PROFILE_ROWS], cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only: an op's row repeats the device time of its kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in kernels) / 1e6
    print(f"profiled build n={PROFILE_ROWS}: wall {wall:.3f} s under the profiler, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f}% of wall), {len(kernels)} distinct kernels")
    for name in PORT_KERNELS:
        rows = [e for e in kernels if name in e.key]
        us, calls = sum(_device_us(e) for e in rows), sum(e.count for e in rows)
        print(f"  port kernel {name}: {us / 1e3:.3f} ms device time over {calls} launches, "
              f"{us / 1e3 / max(calls, 1):.6f} ms per launch")
    for e in kernels[:TOP]:
        print(f"  {_device_us(e) / 1e3:12.3f} ms  {e.count:8d} calls  {e.key[:100]}")

    if cfg.precision != "pq":  # pq's comps count ADC ranks, not kernel rows
        c = count_expansions(x[:PROFILE_ROWS], cfg)
        print(f"fused_expand over the same build: {c['launches']} launches; per launch "
              f"{c['fresh']:.1f} fresh, {c['valid']:.1f} valid and {c['inserted']:.1f} recorded "
              f"candidates, {c['bytes'] / 1e6:.3f} MB; bound {c['bound_ms']:.6f} ms "
              f"({c['bound_by']}) on an H100")


def _device_us(e) -> float:
    # renamed from self_cuda_time_total in newer PyTorch releases
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


if __name__ == "__main__":
    main()
