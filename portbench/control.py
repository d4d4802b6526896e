"""The upper readings the limits of `judge.LIMITS` are set against: whole
runs of a cell, in one process, with the control in the timed path's
place (the reference in int4, one step of precision below the
configuration's int8), and optionally with each planted fault.  The
benchmark's own runs give the lower readings.

    python3 portbench/control.py --workload capsnet_mnist_L-bulk \\
        --seeds 11 12 13 --seconds 10 [--faults]

Prints one JSON line a run: the cell, the seed, what ran in the program's
place, `correct` and every compared number.  Not run by the benchmark.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", action="store_true",
                    help="also run each planted fault on each seed")
    args = ap.parse_args(argv)
    from portbench import faults, harness, spec
    cell = spec.cell(args.workload)
    runs = [("control_int4", faults.control)]
    if args.faults:
        runs += [("fault_alter", lambda: faults.fault("alter")),
                 ("fault_half", lambda: faults.fault("half"))]
    for seed in args.seeds:
        for name, ctx in runs:
            with ctx():
                res, det = harness.run_cell(cell, seed, args.seconds, False,
                                            t_start=0.0)
            print(json.dumps({
                "cell": cell.name, "seed": seed, "in_place": name,
                "correct": res["correct"], "compared": det["compared"],
                "sent": det["sent"],
                "checks": {k: v["value"] for k, v in res["checks"].items()}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
