"""Plan variants of three cells on the single-pod mesh and record their
roofline records side by side (counterpart of ``repro.launch.perf``).

    PYTHONPATH=src python -m repro_torch.launch.perf --cell gemma-decode
    PYTHONPATH=src python -m repro_torch.launch.perf --cell mixtral-train
    PYTHONPATH=src python -m repro_torch.launch.perf --cell knn-search

Each cell plans {baseline, variants...} on the (16, 16) mesh over a fake
world of 256 ranks, with the reference's tags, and appends the JSON
records to ``--out`` (default ``perf_results.json``).  The numbers are
planned, on the H100's terms (``launch.roofline``), not measured.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

from repro_torch import configs
from repro_torch.configs import cells
from repro_torch.launch import dryrun, roofline


def measure(cell, mesh, tag):
    t0 = time.time()
    lowered = cells.lower(cell)
    rec = roofline.analyze(lowered, mesh, model_flops=cell.model_flops,
                           loop_factor=cell.loop_factor)
    rec.update(arch=cell.arch, shape=cell.shape, variant=tag,
               wall_s=round(time.time() - t0, 1), notes=lowered.notes)
    print(f"[{tag}] t_comp={rec['t_compute_s']:.4f}s t_mem={rec['t_memory_s']:.4f}s "
          f"t_coll={rec['t_collective_s']:.4f}s dom={rec['dominant']} "
          f"peak={rec['bytes_per_device'] / 2**30:.2f}GiB "
          f"roofline_frac={rec.get('roofline_fraction', float('nan')):.4f}", flush=True)
    return rec


@contextlib.contextmanager
def config_variant(arch: str, **changes):
    """``arch``'s ``full_config()`` with ``changes`` while inside."""
    mod = configs.get(arch)
    orig = mod.full_config
    mod.full_config = lambda: dataclasses.replace(orig(), **changes)
    try:
        yield
    finally:
        mod.full_config = orig


def gemma_decode(mesh):
    return [
        measure(cells.plan("gemma3-1b", "decode_32k", mesh), mesh, "baseline-dense-cache"),
        measure(cells.plan("gemma3-1b", "decode_32k", mesh, opts={"split_cache": True}), mesh,
                "ring-local-cache"),
        measure(cells.plan("gemma3-1b", "long_500k", mesh), mesh, "long500k-baseline"),
        measure(cells.plan("gemma3-1b", "long_500k", mesh, opts={"split_cache": True}), mesh,
                "long500k-ring"),
    ]


def mixtral_train(mesh):
    out = [measure(cells.plan("mixtral-8x7b", "train_4k", mesh), mesh, "baseline")]
    # sequence-parallel residual stream (Megatron-SP): h split on S over
    # 'model' between blocks
    with config_variant("mixtral-8x7b", seq_shard=True):
        out.append(measure(cells.plan("mixtral-8x7b", "train_4k", mesh), mesh, "seq-parallel-h"))
    # the ring cache for the decode shapes rides the SWA window
    out.append(measure(cells.plan("mixtral-8x7b", "long_500k", mesh), mesh, "long500k-baseline"))
    out.append(measure(cells.plan("mixtral-8x7b", "long_500k", mesh, opts={"split_cache": True}),
                       mesh, "long500k-ring"))
    return out


def knn_search(mesh):
    out = [measure(cells.plan("knn-lgd", "search_4k", mesh), mesh, "baseline")]
    # bf16 candidate storage (distances accumulate in fp32)
    with config_variant("knn-lgd", data_bf16=True):
        out.append(measure(cells.plan("knn-lgd", "search_4k", mesh), mesh, "bf16-data"))
    # a leaner beam and hash (quality is measured apart)
    with config_variant("knn-lgd", beam=24, hash_slots=1024):
        out.append(measure(cells.plan("knn-lgd", "search_4k", mesh), mesh, "beam24-hash1024"))
    return out


CELLS = {
    "gemma-decode": gemma_decode,
    "mixtral-train": mixtral_train,
    "knn-search": knn_search,
}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--out", default="perf_results.json")
    args = ap.parse_args(argv)
    with dryrun.production_mesh(multi_pod=False) as mesh:
        recs = CELLS[args.cell](mesh)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    with open(args.out, "w") as f:
        json.dump(existing + recs, f, indent=1, default=str)
    print(f"appended {len(recs)} records to {args.out}")
    return recs


if __name__ == "__main__":
    main()
