"""`check_program` — the one-call static verifier for an EdgeProgram.

Three stages, each reusing the single statement of its rules:

  1. structure (this module): tensor table indexed by tid, positive
     shapes, dataflow well-formedness (defined inputs, single writer,
     tid 0 read-only), required attrs per op kind, weight blob dtypes
     and shapes consistent with the attr geometry, activation shapes
     consistent with the conv/caps geometry chain, tensor formats
     matching the op's declared output format;
  2. plan invariants (plancheck, on the flattened attrs) + the
     program-level in_frac threading;
  3. value ranges (ranges) and arena aliasing (arenacheck, against a
     supplied or freshly derived ArenaPlan).

Stages 2-3 assume a sound structure, so a structural finding
short-circuits the pass (the diagnostics already name the defect).
Returns a `CheckResult`; `raise_if_failed()` upgrades findings to a
`CheckError` (caught as AssertionError by the export CLI, as
ValueError by importer callers).
"""
from __future__ import annotations

from repro_torch.analysis import arenacheck, plancheck, ranges
from repro_torch.analysis.diagnostics import CheckResult, Diagnostic

_ROUNDINGS = ("floor", "nearest")

_CONV_ATTRS = ("kernel", "stride", "in_ch", "out_ch", "relu", "in_frac",
               "w_frac", "b_frac", "out_frac", "out_shift", "bias_shift")
_PCAP_ATTRS = _CONV_ATTRS + ("caps", "dim", "squash_in_frac",
                             "squash_out_frac")
_ROUTING_ATTRS = ("num_out", "num_in", "out_dim", "in_dim", "routings",
                  "in_frac", "W_frac", "uhat_frac", "uhat_shift",
                  "logit_frac", "caps_out_shifts", "caps_out_fracs",
                  "agree_shifts", "squash_out_frac")
_REQUIRED = {"CONV_Q7": _CONV_ATTRS, "PRIMARY_CAPS_Q7": _PCAP_ATTRS,
             "CAPS_ROUTING_Q7": _ROUTING_ATTRS}
_WEIGHTS = {"CONV_Q7": ("w", "b"), "PRIMARY_CAPS_Q7": ("w", "b"),
            "CAPS_ROUTING_Q7": ("W",)}


def _blob(diags, op, i, wname, shape, what) -> bool:
    """One weight blob: present, int8, exactly the attr-implied shape.
    Returns False when follow-up checks can't use the blob."""
    w = op.weights.get(wname)
    if w is None:
        diags.append(Diagnostic.of(
            "ir.missing-weight", f"op has no {wname!r} blob ({what})",
            op_index=i, op_name=op.name))
        return False
    if str(w.dtype) != "int8":
        diags.append(Diagnostic.of(
            "ir.weight-dtype",
            f"{wname} blob is {w.dtype}, not int8", op_index=i,
            op_name=op.name, blob=wname))
        return False
    if tuple(w.shape) != shape:
        diags.append(Diagnostic.of(
            "ir.weight-shape-mismatch",
            f"{wname} blob shape {tuple(w.shape)} != {shape} implied by "
            f"the attrs ({what})", op_index=i, op_name=op.name,
            blob=wname))
        return False
    return True


def _conv_geometry(diags, program, op, i) -> None:
    a = op.attrs
    _blob(diags, op, i, "w",
          (a["kernel"], a["kernel"], a["in_ch"], a["out_ch"]),
          "k x k x in_ch x out_ch")
    _blob(diags, op, i, "b", (a["out_ch"],), "out_ch")
    x = program.tensor(op.inputs[0])
    where = dict(op_index=i, op_name=op.name)
    if len(x.shape) != 3 or x.shape[2] != a["in_ch"]:
        diags.append(Diagnostic.of(
            "ir.geometry-mismatch",
            f"input tensor shape {x.shape} is not (H, W, "
            f"in_ch={a['in_ch']})", tensor=x.tid, **where))
        return
    if a["stride"] < 1 or a["kernel"] < 1 \
            or x.shape[0] < a["kernel"] or x.shape[1] < a["kernel"]:
        diags.append(Diagnostic.of(
            "ir.geometry-mismatch",
            f"kernel {a['kernel']} / stride {a['stride']} does not fit "
            f"the {x.shape[0]}x{x.shape[1]} input", tensor=x.tid,
            **where))
        return
    ho = (x.shape[0] - a["kernel"]) // a["stride"] + 1
    wo = (x.shape[1] - a["kernel"]) // a["stride"] + 1
    out = program.tensor(op.output)
    if op.kind == "CONV_Q7":
        want, frac = (ho, wo, a["out_ch"]), a["out_frac"]
    else:
        if a["caps"] * a["dim"] != a["out_ch"]:
            diags.append(Diagnostic.of(
                "ir.geometry-mismatch",
                f"caps {a['caps']} * dim {a['dim']} != out_ch "
                f"{a['out_ch']}", **where))
            return
        want, frac = (ho * wo * a["caps"], a["dim"]), a["squash_out_frac"]
    if tuple(out.shape) != want:
        diags.append(Diagnostic.of(
            "ir.geometry-mismatch",
            f"output tensor shape {out.shape} != {want} implied by the "
            f"schedule geometry", tensor=out.tid, **where))
    elif out.frac != frac:
        diags.append(Diagnostic.of(
            "ir.frac-mismatch",
            f"output tensor frac {out.frac} != the op's declared output "
            f"format {frac}", tensor=out.tid, **where))


def _routing_geometry(diags, program, op, i) -> None:
    a = op.attrs
    where = dict(op_index=i, op_name=op.name)
    _blob(diags, op, i, "W",
          (a["num_out"], a["num_in"], a["out_dim"], a["in_dim"]),
          "num_out x num_in x out_dim x in_dim")
    x = program.tensor(op.inputs[0])
    if tuple(x.shape) != (a["num_in"], a["in_dim"]):
        diags.append(Diagnostic.of(
            "ir.geometry-mismatch",
            f"input tensor shape {x.shape} != (num_in, in_dim) = "
            f"({a['num_in']}, {a['in_dim']})", tensor=x.tid, **where))
    out = program.tensor(op.output)
    if tuple(out.shape) != (a["num_out"], a["out_dim"]):
        diags.append(Diagnostic.of(
            "ir.geometry-mismatch",
            f"output tensor shape {out.shape} != (num_out, out_dim) = "
            f"({a['num_out']}, {a['out_dim']})", tensor=out.tid, **where))
    elif out.frac != a["squash_out_frac"]:
        diags.append(Diagnostic.of(
            "ir.frac-mismatch",
            f"output tensor frac {out.frac} != squash_out_frac "
            f"{a['squash_out_frac']}", tensor=out.tid, **where))
    if a["routings"] < 1:
        diags.append(Diagnostic.of(
            "ir.geometry-mismatch", f"routings {a['routings']} < 1",
            **where))


def check_structure(program) -> list:
    """Stage-1 diagnostics (see module docstring)."""
    diags: list = []
    if program.rounding not in _ROUNDINGS:
        diags.append(Diagnostic.of(
            "ir.bad-rounding",
            f"rounding {program.rounding!r} not in {_ROUNDINGS}"))
    for idx, t in enumerate(program.tensors):
        if t.tid != idx:
            diags.append(Diagnostic.of(
                "ir.tensor-index",
                f"tensor table position {idx} holds tid {t.tid}",
                tensor=t.tid))
        if not t.shape or any(int(s) < 1 for s in t.shape):
            diags.append(Diagnostic.of(
                "ir.bad-shape", f"tensor shape {t.shape} has "
                f"non-positive dims", tensor=t.tid))
    if diags:
        return diags                # tid table broken: nothing below holds
    if program.input_frac != program.tensors[0].frac:
        diags.append(Diagnostic.of(
            "ir.frac-mismatch",
            f"program input_frac {program.input_frac} != input tensor "
            f"frac {program.tensors[0].frac}", tensor=0))
    if not program.ops:
        diags.append(Diagnostic.of("ir.empty-schedule",
                                   "program has no ops"))
        return diags

    written = {0}
    for i, op in enumerate(program.ops):
        where = dict(op_index=i, op_name=op.name)
        if len(op.inputs) != 1:
            diags.append(Diagnostic.of(
                "ir.bad-arity",
                f"{op.kind} takes 1 input tensor, got {len(op.inputs)}",
                **where))
            return diags
        bad_ref = [t for t in (*op.inputs, op.output)
                   if not 0 <= t < len(program.tensors)]
        if bad_ref:
            diags.append(Diagnostic.of(
                "ir.bad-tensor-ref",
                f"op references unknown tensor ids {bad_ref}", **where))
            return diags
        for t in op.inputs:
            if t not in written:
                diags.append(Diagnostic.of(
                    "ir.undefined-input",
                    f"input tensor {t} is not produced by any earlier "
                    f"op (nor the program input)", tensor=t, **where))
        if op.output in written:
            diags.append(Diagnostic.of(
                "ir.output-clobber",
                f"output tensor {op.output} already has a writer "
                f"(the schedule is single-assignment)", tensor=op.output,
                **where))
        written.add(op.output)

        missing = [k for k in _REQUIRED[op.kind] if k not in op.attrs]
        if missing:
            diags.append(Diagnostic.of(
                "ir.missing-attr",
                f"{op.kind} attrs missing {missing}", **where))
            continue                # geometry checks need these attrs
        if op.kind == "CAPS_ROUTING_Q7":
            _routing_geometry(diags, program, op, i)
        else:
            _conv_geometry(diags, program, op, i)
    return diags


def check_program(program, *, arena=None) -> CheckResult:
    """Run every static check on one program; see the module docstring
    for staging.  `arena`: verify a specific ArenaPlan (e.g. the one
    being exported) instead of deriving a fresh one."""
    res = CheckResult(program.name)
    res.extend(check_structure(program))
    if not res.ok:
        return res

    for i, op in enumerate(program.ops):
        a = op.attrs
        where = dict(op_index=i, op_name=op.name)
        if op.kind == "CAPS_ROUTING_Q7":
            res.extend(plancheck.check_routing_fields(a, **where))
        else:
            res.extend(plancheck.check_conv_fields(
                a, out_ch=a["out_ch"], **where))
            if op.kind == "PRIMARY_CAPS_Q7":
                res.extend(plancheck.check_squash_fields(
                    a, conv_out_frac=a["out_frac"], **where))
        x = program.tensor(op.inputs[0])
        if a["in_frac"] != x.frac:
            res.add(Diagnostic.of(
                "plan.frac-thread-mismatch",
                f"op in_frac {a['in_frac']} != its input tensor's "
                f"format {x.frac}", tensor=x.tid, **where))

    res.extend(ranges.check_ranges(program))

    if arena is None:
        from repro_torch.edge.arena import plan_arena
        arena = plan_arena(program)
    res.extend(arenacheck.check_arena(program, arena))
    return res
