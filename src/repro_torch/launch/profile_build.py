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
from repro_torch.kernels.precision import PRECISIONS
from repro_torch.launch import build_graph

PROFILE_ROWS = 200_000
TOP = 20
# the port's kernels by their CUDA function names (csrc/*.cu); the name
# covers every storage type a kernel is instantiated for
PORT_KERNELS = ("gather_distance_kernel", "fused_expand_kernel", "pairwise_kernel")


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


def _device_us(e) -> float:
    # renamed from self_cuda_time_total in newer PyTorch releases
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


if __name__ == "__main__":
    main()
