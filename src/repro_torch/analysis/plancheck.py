"""PipelinePlan invariant linter.

The Qm.n algebra every shift in a plan must satisfy (paper Alg. 6,
derived in quant.qformat and nn.layers):

  conv      out_shift     == in_frac + w_frac - out_frac
            bias_shift    == in_frac + w_frac - b_frac
            (and per output channel with the per-channel tables)
  routing   uhat_shift    == in_frac + W_frac - uhat_frac
            caps_out_shifts[r] == uhat_frac + 7 - caps_out_fracs[r]
            agree_shifts[r]    == uhat_frac + 7 - logit_frac
            len(agree_shifts)  == routings - 1
  chaining  each layer's in_frac == previous layer's out_frac

All checks work on plain field dicts, so the SAME functions lint a
typed plan (`check_pipeline_plan`) and an EdgeOp's flattened attrs (the
program checker reuses them) — there is exactly one statement of each
invariant.  Variant references are resolved through
`nn.variants.REGISTRY`; unknown names are findings, not exceptions.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.nn.plans import ConvPlan, PrimaryCapsPlan, RoutingPlan
from repro_torch.nn.variants import REGISTRY
from repro_torch.quant.qformat import MAX_FRAC_BITS

_FRAC_FIELDS_CONV = ("in_frac", "w_frac", "b_frac", "out_frac")
_FRAC_FIELDS_ROUTING = ("in_frac", "W_frac", "uhat_frac",
                        "squash_out_frac")


def _frac_range(diags, name: str, value: int, **where) -> None:
    lim = MAX_FRAC_BITS
    if not -lim <= value <= lim:
        diags.append(Diagnostic.of(
            "plan.frac-range",
            f"{name} = {value} outside the Qm.n derivation range "
            f"[{-lim}, {lim}]", field=name, value=value, **where))


def _variant_ref(diags, kind: str, name, **where) -> None:
    if not REGISTRY.is_registered(kind, name):
        diags.append(Diagnostic.of(
            "plan.unregistered-variant",
            f"{kind} variant {name!r} is not in nn.variants.REGISTRY "
            f"(registered: {', '.join(REGISTRY.names(kind))})",
            kind=kind, name=str(name), **where))


def check_conv_fields(d: dict, *, out_ch: int | None = None,
                      **where) -> list:
    """Shift/frac invariants of one conv plan (or CONV_Q7 attr dict).
    `out_ch`, when known, pins the per-channel table lengths."""
    diags: list = []
    for f in _FRAC_FIELDS_CONV:
        _frac_range(diags, f, d[f], **where)
    want = d["in_frac"] + d["w_frac"] - d["out_frac"]
    if d["out_shift"] != want:
        diags.append(Diagnostic.of(
            "plan.out-shift-mismatch",
            f"out_shift {d['out_shift']} != in_frac + w_frac - out_frac "
            f"= {want}", out_shift=d["out_shift"], expected=want, **where))
    want = d["in_frac"] + d["w_frac"] - d["b_frac"]
    if d["bias_shift"] != want:
        diags.append(Diagnostic.of(
            "plan.bias-shift-mismatch",
            f"bias_shift {d['bias_shift']} != in_frac + w_frac - b_frac "
            f"= {want}", bias_shift=d["bias_shift"], expected=want,
            **where))

    tables = {k: tuple(d.get(k) or ())
              for k in ("w_frac_per_channel", "out_shift_per_channel",
                        "bias_shift_per_channel")}
    if any(tables.values()):
        lengths = {k: len(v) for k, v in tables.items()}
        want_len = out_ch if out_ch is not None \
            else max(lengths.values())
        bad = {k: n for k, n in lengths.items() if n != want_len}
        if bad:
            diags.append(Diagnostic.of(
                "plan.per-channel-length",
                f"per-channel tables must all have {want_len} entries "
                f"(one per output channel); got {lengths}",
                expected=want_len, **where))
            return diags            # can't zip truncated tables below
        for c, (wf, osh, bsh) in enumerate(zip(
                tables["w_frac_per_channel"],
                tables["out_shift_per_channel"],
                tables["bias_shift_per_channel"])):
            _frac_range(diags, f"w_frac_per_channel[{c}]", wf, **where)
            if osh != d["in_frac"] + wf - d["out_frac"]:
                diags.append(Diagnostic.of(
                    "plan.out-shift-mismatch",
                    f"out_shift_per_channel[{c}] = {osh} != in_frac + "
                    f"w_frac_per_channel[{c}] - out_frac = "
                    f"{d['in_frac'] + wf - d['out_frac']}",
                    channel=c, **where))
            if bsh != d["in_frac"] + wf - d["b_frac"]:
                diags.append(Diagnostic.of(
                    "plan.bias-shift-mismatch",
                    f"bias_shift_per_channel[{c}] = {bsh} != in_frac + "
                    f"w_frac_per_channel[{c}] - b_frac = "
                    f"{d['in_frac'] + wf - d['b_frac']}",
                    channel=c, **where))
    return diags


def check_squash_fields(d: dict, *, conv_out_frac: int | None = None,
                        **where) -> list:
    """Squash plan fields of a primary-caps stage (typed plan or
    PRIMARY_CAPS_Q7 attrs)."""
    diags: list = []
    _frac_range(diags, "squash_out_frac", d["squash_out_frac"], **where)
    _variant_ref(diags, "squash",
                 d.get("squash_impl", REGISTRY.default("squash")), **where)
    in_frac = d.get("squash_in_frac", conv_out_frac)
    if in_frac is not None and conv_out_frac is not None \
            and in_frac != conv_out_frac:
        diags.append(Diagnostic.of(
            "plan.squash-in-frac-mismatch",
            f"squash_in_frac {in_frac} != the conv stage's out_frac "
            f"{conv_out_frac}", squash_in_frac=in_frac,
            conv_out_frac=conv_out_frac, **where))
    return diags


def check_routing_fields(d: dict, **where) -> list:
    """Shift/frac/table invariants of one routing plan (or
    CAPS_ROUTING_Q7 attr dict)."""
    diags: list = []
    for f in _FRAC_FIELDS_ROUTING:
        _frac_range(diags, f, d[f], **where)
    want = d["in_frac"] + d["W_frac"] - d["uhat_frac"]
    if d["uhat_shift"] != want:
        diags.append(Diagnostic.of(
            "plan.uhat-shift-mismatch",
            f"uhat_shift {d['uhat_shift']} != in_frac + W_frac - "
            f"uhat_frac = {want}", uhat_shift=d["uhat_shift"],
            expected=want, **where))
    per_out = {k: tuple(d.get(k) or ())
               for k in ("W_frac_per_out", "uhat_shift_per_out")}
    if any(per_out.values()):
        lengths = {k: len(v) for k, v in per_out.items()}
        want_len = d.get("num_out") or max(lengths.values())
        bad = {k: n for k, n in lengths.items() if n != want_len}
        if bad:
            diags.append(Diagnostic.of(
                "plan.per-out-length",
                f"per-output-capsule tables must all have {want_len} "
                f"entries (one per output capsule); got {lengths}",
                expected=want_len, **where))
        else:
            for j, (wf, sh) in enumerate(zip(per_out["W_frac_per_out"],
                                             per_out["uhat_shift_per_out"])):
                _frac_range(diags, f"W_frac_per_out[{j}]", wf, **where)
                if sh != d["in_frac"] + wf - d["uhat_frac"]:
                    diags.append(Diagnostic.of(
                        "plan.uhat-shift-mismatch",
                        f"uhat_shift_per_out[{j}] = {sh} != in_frac + "
                        f"W_frac_per_out[{j}] - uhat_frac = "
                        f"{d['in_frac'] + wf - d['uhat_frac']}",
                        channel=j, **where))
    if not 0 <= d["logit_frac"] <= 7:
        diags.append(Diagnostic.of(
            "plan.logit-frac-range",
            f"logit_frac {d['logit_frac']} outside [0, 7] (int8 logits "
            f"cannot carry more than 7 fractional bits)",
            logit_frac=d["logit_frac"], **where))

    shifts = tuple(d["caps_out_shifts"])
    fracs = tuple(d["caps_out_fracs"])
    agree = tuple(d["agree_shifts"])
    routings = d.get("routings", len(shifts))
    if len(shifts) != routings or len(fracs) != routings \
            or len(agree) != routings - 1:
        diags.append(Diagnostic.of(
            "plan.routing-table-length",
            f"per-iteration tables for {routings} routings must have "
            f"{routings}/{routings}/{routings - 1} entries; got "
            f"{len(shifts)}/{len(fracs)}/{len(agree)} "
            f"(caps_out_shifts/caps_out_fracs/agree_shifts)",
            routings=routings, **where))
        return diags                # lengths wrong: cannot zip below
    for r, (sh, f) in enumerate(zip(shifts, fracs)):
        _frac_range(diags, f"caps_out_fracs[{r}]", f, **where)
        if sh != d["uhat_frac"] + 7 - f:
            diags.append(Diagnostic.of(
                "plan.caps-out-shift-mismatch",
                f"caps_out_shifts[{r}] = {sh} != uhat_frac + 7 - "
                f"caps_out_fracs[{r}] = {d['uhat_frac'] + 7 - f}",
                iteration=r, **where))
    for r, sh in enumerate(agree):
        if sh != d["uhat_frac"] + 7 - d["logit_frac"]:
            diags.append(Diagnostic.of(
                "plan.agree-shift-mismatch",
                f"agree_shifts[{r}] = {sh} != uhat_frac + 7 - logit_frac "
                f"= {d['uhat_frac'] + 7 - d['logit_frac']}",
                iteration=r, **where))
    _variant_ref(diags, "softmax",
                 d.get("softmax_impl", REGISTRY.default("softmax")),
                 **where)
    _variant_ref(diags, "squash",
                 d.get("squash_impl", REGISTRY.default("squash")), **where)
    return diags


def check_pipeline_plan(plan) -> list:
    """Lint a typed PipelinePlan: every per-layer invariant above plus
    the out_frac -> in_frac chaining between layers.  Returns the
    diagnostics (empty list == clean)."""
    diags: list = []
    _frac_range(diags, "input_frac", plan.input_frac, op_name="input")
    f_act = plan.input_frac
    for name, p in plan.layers.items():
        where = dict(op_name=name)
        if isinstance(p, (ConvPlan, PrimaryCapsPlan)):
            conv = p.conv if isinstance(p, PrimaryCapsPlan) else p
            d = dataclasses.asdict(conv)
            diags += check_conv_fields(d, **where)
            if isinstance(p, PrimaryCapsPlan):
                diags += check_squash_fields(
                    dataclasses.asdict(p), conv_out_frac=conv.out_frac,
                    **where)
            in_frac = conv.in_frac
        elif isinstance(p, RoutingPlan):
            diags += check_routing_fields(dataclasses.asdict(p), **where)
            in_frac = p.in_frac
        else:
            diags.append(Diagnostic.of(
                "plan.unknown-layer-plan",
                f"no invariants registered for plan type "
                f"{type(p).__name__}", **where))
            continue
        if in_frac != f_act:
            diags.append(Diagnostic.of(
                "plan.frac-thread-mismatch",
                f"in_frac {in_frac} != the upstream activation format "
                f"{f_act} (plans chain out_frac -> in_frac)",
                in_frac=in_frac, upstream=f_act, **where))
        f_act = p.out_frac
    return diags
