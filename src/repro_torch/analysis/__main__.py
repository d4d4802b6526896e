"""Statically verify exported `.capsbin` artifacts:

    PYTHONPATH=src python -m repro_torch.analysis out/edge_tiny.capsbin [...]

Loads each artifact, runs the full checker (structure, plan algebra,
int32 range proofs, arena aliasing) and prints one result block per
file.  Exit 1 on any finding.

`--profile` additionally prints the static MCU cycle/latency estimate
of each (passing or failing) artifact on every calibrated profile
(repro_torch.edge.costmodel: cortex-m7 @ 480 MHz, gap8 @ 170 MHz).
Nothing here touches a GPU.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify exported .capsbin artifacts")
    ap.add_argument("paths", nargs="+", metavar="artifact.capsbin",
                    help="exported artifacts to check")
    ap.add_argument("--profile", action="store_true",
                    help="also print the static per-op cycle/latency "
                    "estimate on every calibrated MCU profile")
    args = ap.parse_args(argv)

    from repro_torch.analysis.checker import check_program
    from repro_torch.edge.costmodel import format_estimates
    from repro_torch.edge.program import EdgeProgram

    failed = False
    for path in args.paths:
        program = EdgeProgram.load(path)
        result = check_program(program)
        print(result.format())
        failed = failed or not result.ok
        if args.profile:
            print(format_estimates(program))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
