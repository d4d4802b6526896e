"""One-call export: QuantCapsNet -> on-disk MCU artifact, verified.

    result = export_artifacts(qnet, out_dir, stem="edge_tiny",
                              verify_images=images)

writes `<stem>.capsbin` + `<stem>.manifest.json` + `<stem>.c/.h`,
reloads the binary from disk, and re-verifies the reloaded program in
the NumPy VM against `qnet.forward` bit for bit — so "it exported"
always means "the artifact executes identically".  The net may lie on
the card: `qnet.forward` then runs its kernels there, and the VM runs
on the host.  Each stage runs under its span (`export.lower`,
`export.arena`, `export.check`, `export.save`, `export.emit_c`,
`export.verify`; repro_torch.obs), as in the reference.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
from repro_torch.edge.arena import format_report, memory_report, plan_arena
from repro_torch.edge.emit_c import save_c
from repro_torch.edge.lower import lower
from repro_torch.edge.program import EdgeProgram
from repro_torch.edge.vm import EdgeVM


def export_artifacts(qnet, out_dir, stem: str | None = None, *,
                     verify_images=None, check: bool = True) -> dict:
    """Lower, plan, statically check, serialize, emit C, and
    (optionally) verify.

    check (default on): run the full static verifier
    (repro_torch.analysis.check_program — int32 range proofs, plan
    shift algebra, arena aliasing) on the lowered program BEFORE
    anything is written; findings raise a CheckError listing every
    diagnostic.

    verify_images: float images [N,H,W,C] in [0,1]; when given, the
    `.capsbin` is reloaded from disk and executed in the EdgeVM, and a
    mismatch with `qnet.forward` raises — a failed export never leaves a
    silently-wrong artifact behind.  Returns paths, the memory report,
    and the number of verified images."""
    out_dir = Path(out_dir)
    with obs.span("export.lower"):
        program = lower(qnet, name=stem)
    stem = program.name
    with obs.span("export.arena", program=stem):
        plan = plan_arena(program)

    if check:
        from repro_torch.analysis import check_program
        with obs.span("export.check", program=stem):
            check_program(program, arena=plan).raise_if_failed()

    with obs.span("export.save", program=stem):
        paths = program.save(out_dir / stem)
    with obs.span("export.emit_c", program=stem):
        paths.update(save_c(program, out_dir, plan))
    report = memory_report(program, plan)

    verified = 0
    if verify_images is not None:
        with obs.span("export.verify", program=stem):
            reloaded = EdgeProgram.load(paths["capsbin"])
            if not program.same_as(reloaded):
                raise AssertionError(f"{paths['capsbin']}: serialize/load "
                                     "round-trip changed the program")
            with torch.inference_mode():
                x_q = qnet.quantize_input(
                    torch.as_tensor(np.asarray(verify_images, np.float32))
                    .to(qnet.device))
                v_host = qnet.forward(x_q).cpu().numpy()
            v_vm = EdgeVM(reloaded).run(x_q.cpu().numpy())
            if not np.array_equal(v_vm, v_host):
                diff = np.abs(v_vm.astype(np.int32)
                              - v_host.astype(np.int32)).max()
                raise AssertionError(
                    f"{paths['capsbin']}: VM output differs from "
                    f"QuantCapsNet.forward on {len(x_q)} verify images "
                    f"(max |diff| {diff})")
            verified = int(len(x_q))

    return {"paths": paths, "report": report, "program": program,
            "arena": plan, "verified": verified, "checked": check}


def format_export(result: dict) -> str:
    lines = [format_report(result["report"])]
    lines.append("  artifacts: "
                 + ", ".join(str(p) for p in result["paths"].values()))
    if result.get("checked"):
        lines.append("  static checks clean (repro_torch.analysis: "
                     "ranges, plan, arena)")
    if result["verified"]:
        lines.append(f"  VM re-verified bit-exact on "
                     f"{result['verified']} images (reloaded from disk)")
    return "\n".join(lines)
