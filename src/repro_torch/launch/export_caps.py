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
`--profile` prints the static MCU cycle/latency estimate; `--drift`
runs the program through the VM with per-op profiling and prints the
cost-model drift report (repro_torch.obs.analyze.costmodel_drift);
`--numerics` runs it with numeric-health probes and prints the report
(exit 1 on an int32 clip or an observed value outside its static
bound), and `--numerics-out PATH` also writes it as a
`repro.numerics/v1` doc.  `--from-search RESULT.json --point N` exports
frontier point N of a `repro.search/v1` doc (`search_caps --out`): it
replays the doc's seeded setup on the device, asserts the rebuilt plan
equals the doc's bit for bit (exit 2 on a drift, a bad point index, a
wrong schema or an unreadable file), re-runs the static checker before
anything is written (exit 1 on a finding), then exports.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

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
    ap.add_argument("--drift", action="store_true",
                    help="run the exported program through the NumPy q7 "
                    "VM with per-op profiling and print the cost-model "
                    "drift report (repro_torch.obs.analyze.costmodel_drift:"
                    " measured wall-time shares vs static cycle shares, "
                    "per calibrated MCU profile)")
    ap.add_argument("--drift-n", type=int, default=8,
                    help="images for the --drift measurement batch")
    ap.add_argument("--numerics", action="store_true",
                    help="run the exported program through the VM with "
                    "numeric-health probes (repro_torch.obs.numerics) and "
                    "print the report: saturation, int32 clips, bound "
                    "tightness vs the static proofs, per-layer q7-vs-"
                    "f32 SNR; exits 1 on any int32-clip event or any "
                    "observed value outside its static bound")
    ap.add_argument("--numerics-out", metavar="PATH", default=None,
                    help="also write the report as a repro.numerics/v1 "
                    "JSON doc (repro_torch.obs.analyze accepts it); "
                    "implies --numerics")
    ap.add_argument("--numerics-n", type=int, default=8,
                    help="images for the --numerics probe batch")
    ap.add_argument("--from-search", metavar="RESULT.json", default=None,
                    help="export a frontier point from a repro.search/v1 "
                    "result doc (repro_torch.launch.search_caps --out): "
                    "replays the doc's seeded setup, rebuilds the point's "
                    "model, asserts its plan matches the doc bit-for-bit, "
                    "re-runs the static checker, then exports.  Ignores "
                    "--model/--rounding/--per-channel/--softmax/--squash "
                    "(the doc's config governs)")
    ap.add_argument("--point", type=int, default=0,
                    help="frontier point index for --from-search")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    if args.from_search:
        return _export_from_search(args)

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
    if args.drift:
        from repro_torch.edge.vm import EdgeVM
        from repro_torch.obs.analyze import costmodel_drift, format_drift
        program = result["program"]
        vm = EdgeVM(program)
        n = max(args.drift_n, 1)
        x_q = vm.quantize_input(spec.images(n, seed=0))
        rows: list = []
        vm.run(x_q, profile=rows)
        print(format_drift(costmodel_drift(program, rows, batch=n)))
    if args.numerics or args.numerics_out:
        from repro_torch.obs import numerics as health
        qnet = registry.model(model_id)
        # the float weights the model was quantized from (ModelSpec.build
        # inits from the spec seed) — the SNR oracle
        params = qnet.pipeline.init(
            torch.Generator().manual_seed(spec.seed), registry.device)
        n = max(args.numerics_n, 1)
        report = health.run_numerics(qnet, spec.images(n, seed=0),
                                     params=params,
                                     program=result["program"])
        print(report.format())
        if args.numerics_out:
            path = pathlib.Path(args.numerics_out)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(report.to_doc(), indent=1,
                                       sort_keys=True))
            print(f"[export_caps] wrote numerics report to {path}")
        findings = health.check_containment(result["program"], report)
        clips = report.total_int32_clip()
        if clips:
            findings.append(f"{clips} int32-clip event(s) observed — "
                            "statically proven impossible on a "
                            "verifier-clean program")
        if findings:
            for f in findings:
                print(f"[export_caps] NUMERICS: {f}", file=sys.stderr)
            return 1
    return 0


def _export_from_search(args) -> int:
    """The --from-search path: result doc + point index -> artifact."""
    from repro_torch.analysis import check_program
    from repro_torch.device import resolve_device
    from repro_torch.edge import export_artifacts, lower
    from repro_torch.search import load_doc, rebuild_point

    device = resolve_device(args.device)
    try:
        doc = load_doc(args.from_search)
        qnet, entry, st = rebuild_point(doc, args.point, device=device)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"[export_caps] --from-search: {e}", file=sys.stderr)
        return 2
    print(f"[export_caps] search point {args.point} of "
          f"{args.from_search}: spec={entry['spec']} "
          f"acc={entry['metrics'].get('acc'):.4f} device={device} "
          f"-> {args.out}")

    # re-run the static verifier on the rebuilt program BEFORE anything
    # is written, even though export_artifacts would check again — a
    # drifted checker must block the export here
    result = check_program(lower(qnet))
    if not result.ok:
        print(f"[export_caps] STATIC CHECK FAILED:\n{result.format()}",
              file=sys.stderr)
        return 1
    stem = args.stem or f"{doc['config']['model']}_p{args.point}"
    verify = st.images[:args.verify_n] if args.verify_n > 0 else None
    try:
        out = export_artifacts(qnet, args.out, stem=stem,
                               verify_images=verify, check=args.check)
    except CheckError as e:
        print(f"[export_caps] STATIC CHECK FAILED:\n{e}", file=sys.stderr)
        return 1
    except AssertionError as e:
        print(f"[export_caps] VERIFY FAILED: {e}", file=sys.stderr)
        return 1
    print(describe(out["program"]))
    print(format_export(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
