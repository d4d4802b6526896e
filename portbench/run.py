"""The benchmark's command: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout, on a machine with a CUDA card; puts
the checkout's `src/` on its own path.  Prints a detail line, then, as
its last line on standard output, the result as one JSON object; the
numbers the comparison held to their limits end standard error.  Exits
with another code than 0, and prints no result, where there is no card,
where the port's sources are missing, or where JAX or the JAX package
`repro` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def pin_to_one_cpu() -> None:
    """Run the whole process, and every thread it starts, on one CPU: the
    last of those it may use.  In one measurement on the one-card hosts,
    runs whose threads the scheduler was free to place spread 15 % in
    images/s between runs, pinned ones 2 % (PERF.md, section 2)."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, spec
    cell = spec.cell(args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port's sources (src/repro_torch) are not in this checkout",
              file=sys.stderr)
        return 2
    pin_to_one_cpu()
    import torch
    torch.set_num_threads(1)     # the window does no CPU tensor work
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    runner = harness
    if spec.family(cell.config) == "lm":
        from portbench import lm_harness as runner
    result, detail = runner.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), t_start=T_START)
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"loaded modules of JAX or the JAX package: {forbidden}",
              file=sys.stderr)
        return 3
    print(json.dumps({"detail": detail}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
