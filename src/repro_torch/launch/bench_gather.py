"""The gather-distance kernel on the card, at the seed gather's shape and at
a large candidate count.

    PYTHONPATH=src python -m repro_torch.launch.bench_gather

For each shape in ``SHAPES`` and each storage type (fp32, bf16, int8), one
JSON object per line with:

- ``ms``: the kernel's device time per call, cold: each timed call gathers
  its own set of queries and ids (``COLD_SETS`` sets, drawn alike), so no
  call finds the rows of the one before it in the card's 50 MB L2
  (``profile_build.time_ms``: CUDA events around back-to-back calls queued
  behind a spin kernel);
- ``warm_ms``: the same timer replaying set 0, whose rows stay in L2 where
  they fit;
- ``floor_ms``: the same timer over an empty kernel launched with the
  gather's own grid, block and shared memory (``gather_dist.gather_floor``),
  the least any gather can read under it;
- ``index_select_ms``: ``table.index_select(0, ids)`` of each cold set's
  valid (non-negative) ids,
  which moves the same rows and computes no distance;
- ``plain_ms`` over the cold sets, and ``bound_ms`` with what bounds it
  (``gather_bound``, the mean over the timed sets).

The main shape is ``chip_smoke.py``'s: B=4096 queries drawn from the
launcher's 10^6 clustered rows, C=8 uniform ids, d=128.  The large-C shape
is B=256, C=512, d=256 over 2^18 N(0,1) rows with uniform ids.  The last
line is the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess

import torch

from repro_torch import device as device_lib
from repro_torch.configs import knn_lgd
from repro_torch.core.graph import squared_norms
from repro_torch.kernels import gather_dist, ops, ref
from repro_torch.kernels.precision import encode_dataset
from repro_torch.launch import build_graph, profile_build

PRECISIONS = ("fp32", "bf16", "int8")
# (B, C, d) of each timed shape
SHAPES = {"main": (4096, 8, knn_lgd.D), "large_c": (256, 512, 256)}
LARGE_C_ROWS = 2**18
MAIN_SEEDS = (9, 10)  # the queries' rows and the ids at the main shape
LARGE_C_SEEDS = (20, 21, 22)  # rows, queries, ids at the large-C shape
SET_SEED_STRIDE = 1000  # set k draws its queries and ids from seed + k * stride
# timed sets per reading, after two warm-up sets: at the main shape's int8
# table (4.5 MB of rows a set) 40 sets move 3.6 times the L2
COLD_SETS = 40
PLAIN_SETS = 10


def gather_bytes(B: int, C: int, d: int, rows: int, precision: str) -> int:
    """Bytes one gather must move: queries, ids, each of the ``rows``
    distinct rows it reads once at the table's width (int8 with its scale)
    with its norm, the outputs."""
    row_bytes = profile_build.ELEM_BYTES[precision] * d + (4 if precision == "int8" else 0)
    return 4 * (B * d + B * C + rows + B * C) + rows * row_bytes


def gather_bound(idx: torch.Tensor, d: int, precision: str) -> tuple[float, str]:
    """Least time of one gather over ids ``idx`` on an H100, and what bounds
    it: a row named twice is read once, but every valid id is a distance."""
    B, C = idx.shape
    valid = idx[idx >= 0]
    rows = int(torch.unique(valid).numel())
    return profile_build.bound_ms(gather_bytes(B, C, d, rows, precision), 2 * d * valid.numel())


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def main_inputs(x: torch.Tensor, k: int = 0):
    """Queries and ids of the main shape's set k over rows x: (q, idx)."""
    B, C, _ = SHAPES["main"]
    n, dev = x.shape[0], x.device
    seeds = [_gen(dev, s + k * SET_SEED_STRIDE) for s in MAIN_SEEDS]
    q = x[torch.randint(0, n, (B,), generator=seeds[0], device=dev)]
    idx = torch.randint(0, n, (B, C), generator=seeds[1], device=dev).int()
    return q, idx


def large_c_queries(x: torch.Tensor, k: int = 0, *, integer: bool = False):
    """Queries and ids of the large-C shape's set k over rows x: (q, idx),
    N(0,1) queries, or integers in [0, 16) with ``integer``."""
    B, C, d = SHAPES["large_c"]
    n, dev = x.shape[0], x.device
    seeds = [_gen(dev, s + k * SET_SEED_STRIDE) for s in LARGE_C_SEEDS[1:]]
    if integer:
        q = torch.randint(0, 16, (B, d), generator=seeds[0], device=dev).float()
    else:
        q = torch.randn((B, d), generator=seeds[0], device=dev)
    idx = torch.randint(0, n, (B, C), generator=seeds[1], device=dev).int()
    return q, idx


def large_c_inputs(dev, n: int = LARGE_C_ROWS, *, integer: bool = False):
    """Rows and set 0 of the large-C shape: (x, q, idx), N(0,1) rows, or
    integers in [0, 16) with ``integer``."""
    d = SHAPES["large_c"][2]
    g = _gen(dev, LARGE_C_SEEDS[0])
    if integer:
        x = torch.randint(0, 16, (n, d), generator=g, device=dev).float()
    else:
        x = torch.randn((n, d), generator=g, device=dev)
    return (x,) + large_c_queries(x, integer=integer)


def timing_sets(shape: str, x: torch.Tensor) -> list:
    """Two warm-up sets and ``COLD_SETS`` timed ones of ``shape`` over x."""
    draw = main_inputs if shape == "main" else large_c_queries
    return [draw(x, k) for k in range(COLD_SETS + 2)]


def measure(x, sets, precision: str, metric: str = "l2") -> dict:
    """Kernel (cold and warm), floor, index_select and plain times and the
    bound of the gather under ``metric`` over the (q, idx) ``sets``
    (``timing_sets``)."""
    sq = squared_norms(x)
    enc = encode_dataset(x, precision)
    table, scale = ops.kernel_table(x, enc)
    kw = dict(sq_norms=sq, enc=enc, precision=precision)
    q0, idx0 = sets[0]
    B, C = idx0.shape
    d = x.shape[1]
    bounds = [gather_bound(idx, d, precision) for _, idx in sets[2:]]
    flats = [idx[idx >= 0] for _, idx in sets]  # -1 pads no row
    time_ms = profile_build.time_ms
    return {
        "precision": precision, "B": B, "C": C, "d": d, "n": x.shape[0],
        "ms": time_ms([lambda q=q, idx=idx: ops.gather_distance(q, x, idx, metric, **kw)
                       for q, idx in sets]),
        "warm_ms": time_ms([lambda: ops.gather_distance(q0, x, idx0, metric, **kw)] * 22),
        "floor_ms": time_ms([lambda: gather_dist.gather_floor(
            q0, table, idx0, metric, sq_norms=sq, row_scale=scale)] * 22),
        "index_select_ms": time_ms([lambda f=f: table.index_select(0, f) for f in flats]),
        "plain_ms": time_ms([lambda q=q, idx=idx: ref.gather_distance(q, x, idx, metric, **kw)
                             for q, idx in sets[:PLAIN_SETS + 2]]),
        "bound_ms": sum(b for b, _ in bounds) / len(bounds), "bound_by": bounds[0][1],
    }


def main() -> None:
    dev = device_lib.resolve(None)
    x = build_graph.make_data(knn_lgd.N_ROWS, knn_lgd.D, "l2", dev)
    sets = timing_sets("main", x)
    for precision in PRECISIONS:
        print(json.dumps({"shape": "main", **measure(x, sets, precision)}), flush=True)
    del x, sets
    x = large_c_inputs(dev)[0]
    sets = timing_sets("large_c", x)
    for precision in PRECISIONS:
        print(json.dumps({"shape": "large_c", **measure(x, sets, precision)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
