"""Run the quantization/variant search and write a verified Pareto
frontier doc.

    PYTHONPATH=src python -m repro_torch.launch.search_caps \
        --model edge_tiny --budget 24 --out /tmp/search.json

trains the float model (seeded) on the device (the card unless
`--device` says otherwise), explores the design space with the chosen
strategy under an evaluation budget, computes the Pareto frontier over
accuracy x packed flash x RAM x estimated Cortex-M7 latency,
export/check/bit-verifies every frontier point, and writes a
`repro.search/v1` JSON doc.  Identical seeds on one device reproduce an
identical doc, and any point can later be exported as a deployable
artifact with

    python -m repro_torch.launch.export_caps --from-search search.json \
        --point 0 --out /tmp/e

Exit codes: 0 ok, 1 an empty frontier or a point that failed its
export verification, 2 a bad argument (`ValueError`).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.captrain.evalq import format_rows
from repro_torch.search import (SearchConfig, frontier_table_rows,
                                run_search, save_doc)
from repro_torch.search.strategies import STRATEGIES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="edge_tiny",
                    help="search model: edge_tiny or a dataset with a "
                    "capsnet config (mnist, smallnorb, cifar10)")
    ap.add_argument("--strategy", choices=sorted(STRATEGIES),
                    default="coordinate")
    ap.add_argument("--budget", type=int, default=24,
                    help="unique candidate evaluations")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds training, calibration subsampling and "
                    "the strategy (one generator; identical seeds -> "
                    "identical docs)")
    ap.add_argument("--out", required=True,
                    help="path for the repro.search/v1 result JSON")
    ap.add_argument("--float-steps", type=int, default=60)
    ap.add_argument("--qat-steps", type=int, default=0,
                    help=">0: QAT-refine each accepted candidate on its "
                    "fixed plan and record acc_qat (slower)")
    ap.add_argument("--eval-n", type=int, default=256,
                    help="held-out images for the accuracy axis")
    ap.add_argument("--rounding", choices=("floor", "nearest"),
                    default="floor")
    ap.add_argument("--acc-tol", type=float, default=0.005,
                    help="accuracy loss the strategies treat as "
                    "acceptable when keeping a cheaper candidate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    try:
        cfg = SearchConfig(model=args.model, strategy=args.strategy,
                           budget=args.budget, seed=args.seed,
                           float_steps=args.float_steps,
                           qat_steps=args.qat_steps, eval_n=args.eval_n,
                           rounding=args.rounding, acc_tol=args.acc_tol)
        doc = run_search(cfg, log=print, device=args.device)
    except ValueError as e:
        print(f"[search_caps] {e}", file=sys.stderr)
        return 2
    save_doc(doc, args.out)

    front = doc["frontier"]
    n_bad = sum(1 for p in front if not (p["verified"] and p["checked"]))
    print(f"[search_caps] wrote {args.out}: {len(front)} frontier "
          f"points, {len(doc['evaluated'])} evaluated")
    print(format_rows(frontier_table_rows(doc)))
    if not front:
        print("[search_caps] EMPTY FRONTIER", file=sys.stderr)
        return 1
    if n_bad:
        print(f"[search_caps] {n_bad} frontier point(s) failed "
              "export verification", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
