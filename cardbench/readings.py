"""Readings that set the limits of ``correct``: the numbers a cell's check
compares, for the program on many seeds and for the control on a few, in
one process (the kernels built once).

    python3 cardbench/readings.py --workload <name> --seconds <s> \\
        --seeds 1,2,3 [--control-seeds 4,5,6] [--fault-seeds 7,8,9]

The control is the program's own next-lower-precision path: its bf16
distance engine for the EHC search (``BuildConfig.precision="bf16"``), bf16
rows and queries for the exact search (the bf16 pairwise kernel).  Each
``--fault-seeds`` seed is read once under each fault of ``faults.FAULTS``,
planted under the timed path at the cell's own size by the driver of the
cell's traffic kind; run the program's seeds first, so that the fault never
reaches a build.  Each reading is one JSON line.  The benchmark's own runs
never run the control or a fault.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cardbench import faults, harness

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    plan = [(s, False, None) for s in seeds(args.seeds)]
    plan += [(s, True, None) for s in seeds(args.control_seeds)]
    plan += [(s, False, f) for f in faults.FAULTS for s in seeds(args.fault_seeds)]
    kind = harness.load_traffic(ROOT, harness.cell(harness.spec(ROOT), args.workload))["kind"]
    for seed, control, fault in plan:
        remove = faults.plant(fault, kind) if fault else None
        try:
            t = time.perf_counter()
            res = harness.run(args.workload, seed, args.seconds, False, root=ROOT, t_start=t,
                              control=control)
        finally:
            if remove is not None:
                remove()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "fault": fault, "correct": res["correct"],
                          "attempted": res["attempted"], "metrics": res["metrics"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
