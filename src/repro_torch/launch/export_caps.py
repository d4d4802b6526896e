"""Export a quantized CapsNet as a deployable MCU artifact.

    PYTHONPATH=src python -m repro_torch.launch.export_caps \
        --model edge_tiny@torch --out /tmp/e --device cpu

builds (or reuses) the model through the serving registry's lazy-PTQ
path on the device (the card unless --device says otherwise), lowers it
to an EdgeProgram, and writes

    <out>/<stem>.capsbin        single-file binary (weights + plan)
    <out>/<stem>.manifest.json  human-readable IR manifest
    <out>/<stem>.c / .h         CMSIS-NN-style sources

then reloads the `.capsbin` from disk and re-verifies it in the NumPy
q7 VM against the live model, bit for bit — export and proof in one
command.  The files are byte-identical to what the reference's
`repro.launch.export_caps` writes for the same net.  `--model` accepts a
bare dataset name (mnist, smallnorb, cifar10, edge_tiny -> the @cuda
spec, or @torch with `--device cpu`) or a full registry id.
`--softmax`/`--squash` export with an operator variant from the
registry (unknown names fail with the registered ones listed) — the
variant references ride the `.capsbin` attrs and pick the matching C
kernel symbols.  The static verifier (repro_torch.analysis) vets the
lowered program before anything is written; `--no-check` skips it.
`--profile` prints the static MCU cycle/latency estimate.

The reference's `--drift`, `--numerics*` and `--from-search` wait for
the port of its observability layer and of its search.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.analysis import CheckError
from repro_torch.edge import describe, format_estimates, format_export
from repro_torch.nn.variants import REGISTRY
from repro_torch.serving import ModelRegistry, default_specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="edge_tiny",
                    help="registry model id (mnist@cuda, ...) or bare "
                    "dataset name (-> @cuda, or @torch on the CPU)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--stem", default=None,
                    help="artifact file stem (default: model id)")
    ap.add_argument("--rounding", choices=("floor", "nearest"),
                    default="floor")
    ap.add_argument("--per-channel", action="store_true",
                    help="per-output-channel conv weight formats "
                    "(ConvPlan.w_frac_per_channel)")
    ap.add_argument("--softmax", choices=REGISTRY.names("softmax"),
                    default=None,
                    help="softmax operator variant (repro_torch.nn."
                    "variants), e.g. the ISLPED'22 'approx'")
    ap.add_argument("--squash", choices=REGISTRY.names("squash"),
                    default=None,
                    help="squash operator variant")
    ap.add_argument("--verify-n", type=int, default=4,
                    help="images for the bit-exact VM re-verification "
                    "(0 disables)")
    ap.add_argument("--check", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="statically verify the lowered program before "
                    "writing artifacts (repro_torch.analysis: int32 range "
                    "proofs, plan shift algebra, arena aliasing)")
    ap.add_argument("--profile", action="store_true",
                    help="print the static per-op cycle/latency estimate "
                    "of the exported program on every calibrated MCU "
                    "profile (repro_torch.edge.costmodel: cortex-m7, gap8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    registry = ModelRegistry(device=args.device)
    backend = "cuda" if registry.device.type == "cuda" else "torch"
    model_id = args.model if "@" in args.model \
        else f"{args.model}@{backend}"
    if model_id not in registry.specs:
        print(f"[export_caps] unknown model {args.model!r}; have "
              f"{sorted(default_specs())}", file=sys.stderr)
        return 2
    spec = registry.specs[model_id]
    if args.rounding != "floor" or args.per_channel \
            or args.softmax or args.squash:
        overrides = {f"{k}_impl": v
                     for k, v in (("softmax", args.softmax),
                                  ("squash", args.squash)) if v}
        spec = dataclasses.replace(spec, rounding=args.rounding,
                                   per_channel=args.per_channel,
                                   **overrides)
        registry.register(spec)

    print(f"[export_caps] model={model_id} rounding={args.rounding} "
          f"per_channel={args.per_channel} variants={spec.variants.tag} "
          f"device={registry.device} -> {args.out}")
    try:
        result = registry.export(model_id, args.out, stem=args.stem,
                                 verify_n=args.verify_n, check=args.check)
    except CheckError as e:          # static findings are exit 1 too
        print(f"[export_caps] STATIC CHECK FAILED:\n{e}", file=sys.stderr)
        return 1
    except AssertionError as e:      # verification failure is exit 1
        print(f"[export_caps] VERIFY FAILED: {e}", file=sys.stderr)
        return 1
    print(describe(result["program"]))
    print(format_export(result))
    if args.profile:
        print(format_estimates(result["program"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
