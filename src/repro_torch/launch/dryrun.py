"""The dry run: plan and trace every (arch x shape x mesh) cell on fakes
(counterpart of ``repro.launch.dryrun``), with no card and nothing
allocated.

For every cell it prints and records, planned for rank 0 on the H100's
terms (``launch.roofline``): the peak bytes per rank and whether they fit
80 GiB, the FLOPs (bf16 and fp32) and bytes, the collective bytes, the
three roofline terms and the dominant one.  Each mesh is laid over a fake
world that this process joins for it and leaves afterwards: 256 ranks for
the single-pod (16, 16) mesh, 512 for the multi-pod (2, 16, 16) mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single    # 16x16 only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --knn            # include the paper's cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --lower-only     # plan and place, no trace
  PYTHONPATH=src python -m repro_torch.launch.dryrun --markdown       # and a table of the records
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

from repro_torch import configs
from repro_torch.configs import cells
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.models import sharding

MESHES = {"single": ("single-pod-16x16", False), "multi": ("multi-pod-2x16x16", True)}


@contextlib.contextmanager
def production_mesh(multi_pod: bool):
    """The production mesh over a fake world of its size, left on exit."""
    shape, _ = mesh_lib.PRODUCTION_MESHES[multi_pod]
    world = 1
    for s in shape:
        world *= s
    mesh_lib.fake_world(world)
    try:
        yield mesh_lib.make_production_mesh(multi_pod=multi_pod)
    finally:
        sharding.set_mesh(None)
        mesh_lib.close_group()


def run_cell(arch: str, shape: str, mesh, mesh_name: str, skip_reason=None,
             lower_only: bool = False, opts=None) -> dict:
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if skip_reason:
        rec["status"] = "skipped"
        rec["reason"] = skip_reason
        return rec
    t0 = time.time()
    try:
        cell = cells.plan(arch, shape, mesh, opts)
        if lower_only:
            from torch._subclasses.fake_tensor import FakeTensorMode

            with FakeTensorMode():
                cells.place_args(cell)
            rec["status"] = "lowered"
            rec["wall_s"] = round(time.time() - t0, 1)
            return rec
        lowered = cells.lower(cell)
        rec.update(roofline.analyze(lowered, mesh, model_flops=cell.model_flops,
                                    loop_factor=cell.loop_factor))
        rec["kernels"] = lowered.kernels
        rec["kind"] = cell.kind
        rec["notes"] = lowered.notes
        rec["status"] = "ok"
    except Exception as e:  # a failing cell is a bug in the system: surface it
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def line(rec: dict) -> str:
    """The reference's per-cell line."""
    head = f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}:"
    status = rec["status"]
    if status == "lowered":
        return f"{head} LOWER-OK ({rec['wall_s']}s)"
    if status == "ok":
        return (f"{head} OK ({rec['wall_s']}s) "
                f"bytes/dev={rec['bytes_per_device'] / 2**30:.2f}GiB "
                f"flops={rec['hlo_gflops']:.1f}G coll={rec['collective_gbytes']:.3f}GB "
                f"dominant={rec['dominant']}")
    if status == "skipped":
        return f"{head} SKIP ({rec['reason'][:60]}...)"
    return f"{head} FAIL {rec['error']}"


def markdown(records: list) -> str:
    """The records as one Markdown table, a row per cell with each mesh's
    planned numbers side by side: GiB per rank (peak / arguments),
    GFLOPs per rank (bf16 / fp32), GB moved, collective GB, the three terms
    in ms, the dominant term and whether the peak fits 80 GiB."""
    meshes = list(dict.fromkeys(r["mesh"] for r in records))
    head = ["cell"] + [f"{m}: {c}" for m in meshes for c in (
        "GiB peak / args", "GFLOP bf16 / fp32", "GB", "coll GB",
        "ms compute / memory / coll", "dominant", "fits")]
    rows = {}
    for r in records:
        key = f"{r['arch']} x {r['shape']}"
        if r["status"] == "ok":
            cells = [f"{r['bytes_per_device'] / 2**30:.2f} / {r['arg_bytes_per_device'] / 2**30:.2f}",
                     f"{r['gflops_bf16']:.1f} / {r['gflops_fp32']:.1f}", f"{r['hlo_gbytes']:.1f}",
                     f"{r['collective_gbytes']:.3f}",
                     f"{r['t_compute_s'] * 1e3:.2f} / {r['t_memory_s'] * 1e3:.2f} / "
                     f"{r['t_collective_s'] * 1e3:.2f}",
                     r["dominant"], "yes" if r["fits_80gib"] else "no"]
        else:
            cells = [r["status"]] + [""] * 6
        rows.setdefault(key, []).extend(cells)
    lines = ["| " + " | ".join(head) + " |", "|" + " --- |" * len(head)]
    lines += [f"| {k} | " + " | ".join(v) + " |" for k, v in rows.items()]
    return "\n".join(lines)


def cell_list(arch=None, shape=None, knn=False) -> list:
    out = configs.all_cells(include_knn=knn)
    if arch:
        out = [c for c in out if c[0] == arch]
        if arch.startswith("knn-"):
            mod = configs.get(arch)
            out = [(arch, s, mod.SKIP.get(s)) for s in mod.SHAPES]
    if shape:
        out = [c for c in out if c[1] == shape]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--knn", action="store_true", help="include the paper's k-NN cells")
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--lower-only", action="store_true",
                    help="plan and place every cell on its mesh, trace nothing")
    ap.add_argument("--markdown", action="store_true",
                    help="print the records as a Markdown table at the end")
    args = ap.parse_args(argv)

    todo = cell_list(args.arch, args.shape, args.knn)
    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    records = []
    n_fail = 0
    for key in names:
        mesh_name, multi_pod = MESHES[key]
        with production_mesh(multi_pod) as mesh:
            for arch, shape, skip in todo:
                rec = run_cell(arch, shape, mesh, mesh_name, skip, lower_only=args.lower_only)
                records.append(rec)
                n_fail += rec["status"] == "FAIL"
                print(line(rec), flush=True)

    if args.markdown:
        print(markdown(records))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1, default=str)
        print(f"wrote {len(records)} records to {args.out}")
    print(f"done: {sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skipped' for r in records)} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
