"""The port's benchmark: one run of one cell.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  Needs as
many CUDA devices as the cell asks for; without them, or without the
program, it exits non-zero and prints no result.  The last line of
standard output is the result's JSON object; the numbers that decided
``correct`` are also the last lines of standard error.  Caches (the
kernels' build, the configurations' snapshots, the traced timeline) live
under ``build/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the checkout's script directory must not shadow modules by name
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    try:
        import repro_torch  # noqa: F401  (the system under test)
        from cardbench import harness
    except ImportError as exc:
        print(f"cardbench: cannot import the program or the harness: {exc}", file=sys.stderr)
        return 2
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             root=ROOT, t_start=T_START)
    except harness.NoResult as exc:
        print(f"cardbench: {exc}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
