"""The readings the limits of `lm_judge.LIMITS` are set from, for a
language-model cell: whole runs, of the program (the lower readings)
and, optionally, of each planted fault.  Each program run also reads the
control on the same wave: the plain reference with int4 activations in
the program's place, at every position of the same prompts and served
tokens, and the token it puts first there (the upper readings).

    python3 portbench/lm_control.py --workload mixtral_8x22b_w8a8_14L-offline \\
        --seeds 11 12 13 [--seconds 1] [--faults [KIND ...]] [--dump DIR]

Prints one JSON line a run and what stood in the program's place:
the cell, the seed, `correct` and every compared number, and for a
fault run after the program's on the same seed `err_change_max`, the
largest change of a position's logit error against the program's run
(0: the fault changed nothing the comparison sees); `--dump` also
writes each one's per-position readings (gap, logit error, the
reference's top-2 margin, the least route margin) to
DIR/<what>-<seed>.pt.  Not run by the benchmark.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="planted faults to run (none named: all)")
    ap.add_argument("--no-program", action="store_true",
                    help="run only the faults")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from portbench import lm_faults, lm_harness, lm_judge, spec
    cell = spec.cell(args.workload)
    runs = [] if args.no_program else [("program", contextlib.nullcontext)]
    if args.faults is not None:
        runs += [(f"fault_{k}", lambda k=k: lm_faults.fault(k))
                 for k in (args.faults or lm_faults.KINDS)]
    seen = {}
    real_judge = lm_harness.judge_wave

    def judge_wave(cfg, seed, device, prompts, tokens, logits, unanswered,
                   served=None):
        checks, notes = real_judge(cfg, seed, device, prompts, tokens,
                                   logits, unanswered, served)
        seen["self"] = notes
        if seen["name"] == "program":
            lm_harness.judge_wave = real_judge
            try:
                with lm_faults.control():
                    seen["control_int4"] = lm_harness.judge_wave(
                        cfg, seed, device, prompts, tokens, logits,
                        unanswered)
            finally:
                lm_harness.judge_wave = judge_wave
        return checks, notes

    sound = {}

    def emit(name, seed, res, det, checks, notes):
        if name == "program":
            sound[seed] = notes["err"]
        base = sound.get(seed) if name.startswith("fault_") else None
        change = None if base is None or base.shape != notes["err"].shape \
            else float((notes["err"] - base).abs().max())
        print(json.dumps({
            "cell": cell.name, "seed": seed, "in_place": name,
            "correct": lm_judge.passed(checks),
            "compared": notes["compared"], "waves": det["waves"],
            "wave_s": det["wave_s"], "reference_s": det["reference_s"],
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "checks": {k: v for k, (v, _) in checks.items()},
            "err_change_max": change}), flush=True)
        if args.dump:
            out = Path(args.dump)
            out.mkdir(parents=True, exist_ok=True)
            torch.save({k: notes.get(k) for k in
                        ("gap", "err", "ref_margin", "margin")},
                       out / f"{name}-{seed}.pt")

    lm_harness.judge_wave = judge_wave
    try:
        for seed in args.seeds:
            for name, ctx in runs:
                seen.clear()
                seen["name"] = name
                with ctx():
                    res, det = lm_harness.run_cell(
                        cell, seed, args.seconds, False, device=args.device,
                        t_start=0.0)
                checks = {k: (v["value"], v["limit"])
                          for k, v in res["checks"].items()}
                emit(name, seed, res, det, checks, seen["self"])
                if "control_int4" in seen:
                    emit("control_int4", seed, res, det,
                         *seen["control_int4"])
    finally:
        lm_harness.judge_wave = real_judge
    return 0


if __name__ == "__main__":
    sys.exit(main())
