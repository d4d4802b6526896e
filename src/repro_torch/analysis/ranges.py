"""Interval abstract interpretation over the q7 dataflow.

Propagates worst-case int8 value intervals through the EdgeProgram
schedule and proves, per op, that

  * no int32 accumulator can wrap — conv/uhat/s/agreement accumulations
    are bounded by sum(|w|) * max|x| computed from the ACTUAL weight
    blobs (not a generic 127*count bound), plus the shift-aligned bias
    and, for "nearest" rounding, the half-LSB add `1 << (shift-1)`;
  * every power-of-two shift is in-bounds for int32 arithmetic —
    right shifts in [0, 31], left shifts (negative amounts) both small
    enough and proven not to overflow the shifted bound;
  * the shift-only softmax/squash internals stay in int32 — the softmax
    normalizer sum `n * 2^20`, the squash denominator/ratio chain with
    its guard bits, and the logit format feeding `right_shift`.

Everything is exact integer arithmetic on Python ints (no float, no
wrap), so the derived conv accumulator bound doubles as the `acc_bound`
attr `edge.lower` records and the EdgeVM asserts: `analyze()` returns
(bounds, diagnostics) and `annotate_acc_bounds()` stamps the bounds
onto a program.  The module deliberately imports nothing from
`repro_torch.edge` — it walks any program-shaped object — so `lower()`
can call it without an import cycle.  `requant_bounds` gives the numerics
probe (`repro_torch.obs.numerics.check_containment`) the static bound of
every requantization point it observes.

The "precise" softmax variant is float by design (see nn.variants);
its integer-softmax checks are skipped, as for unregistered variant
names (those are flagged by `checker.check_structure`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.nn.variants import PLAN_FIELDS, REGISTRY

INT32_MAX = 2 ** 31 - 1
_GUARD_BITS = 10                    # quant.int8_ops.SQUASH_GUARD_BITS
_SOFTMAX_UNIT_BITS = 20             # max softmax term is 1 << 20
_INT8 = (-128, 127)


def _xmax(iv) -> int:
    """Worst-case magnitude of an int8 interval AFTER int32 widening
    (-128 contributes 128)."""
    return max(abs(iv[0]), abs(iv[1]))


def _variant(attrs: dict, kind: str):
    """(name, registered?) of an op's variant reference, with the same
    defaulting rule as REGISTRY.from_attrs but no raise — the checker
    reports unregistered names as a diagnostic, not an exception."""
    name = attrs.get(PLAN_FIELDS[kind], REGISTRY.default(kind))
    return name, REGISTRY.is_registered(kind, name)


def _check_requant(diags, bound: int, shift: int, rounding: str, what: str,
                   *, op_index, op_name, tensor, **detail) -> None:
    """One requantization point: an int32 value with |x| <= bound goes
    through `rshift_sat8(x, shift)`.  Emits shift-domain and overflow
    diagnostics (bound is exact Python-int arithmetic, so no wrap here
    either)."""
    where = dict(op_index=op_index, op_name=op_name, tensor=tensor)
    if shift > 31 or shift < -31:
        diags.append(Diagnostic.of(
            "ranges.shift-range",
            f"{what}: shift amount {shift} outside int32 domain [-31, 31]",
            shift=shift, **where, **detail))
        return
    if shift >= 0:
        half = 1 << (shift - 1) if rounding == "nearest" and shift > 0 else 0
        total = bound + half
        if total > INT32_MAX:
            diags.append(Diagnostic.of(
                "ranges.acc-overflow",
                f"{what}: |accumulator| can reach {bound}"
                + (f" (+{half} rounding half-add)" if half else "")
                + f" > int32 max {INT32_MAX}",
                bound=total, shift=shift, **where, **detail))
    elif bound << -shift > INT32_MAX:
        diags.append(Diagnostic.of(
            "ranges.shift-overflow",
            f"{what}: left shift by {-shift} overflows int32 "
            f"(bound {bound} << {-shift} > {INT32_MAX})",
            bound=bound, shift=shift, **where, **detail))


# ---------------------------------------------------------------------------
# CONV_Q7 (also the conv stage of PRIMARY_CAPS_Q7)
# ---------------------------------------------------------------------------
def conv_acc_bounds(op, x_iv) -> list:
    """Per-output-channel worst-case |int32 conv accumulator| including
    the shift-aligned bias, before requantization — valid for ANY
    accumulation order (sum of |w|*max|x|), which is what an MCU kernel
    needs.  Exact Python ints from the actual weight blobs."""
    a = op.attrs
    wsum = np.abs(op.weights["w"].astype(np.int64)).sum(axis=(0, 1, 2))
    bias = op.weights["b"].astype(np.int64)
    xmax = _xmax(x_iv)
    per_ch = a.get("bias_shift_per_channel")
    bounds = []
    for c in range(len(bias)):
        bs = per_ch[c] if per_ch else a["bias_shift"]
        b = int(bias[c])
        b_aligned = b << bs if bs >= 0 else b >> -bs
        bounds.append(int(wsum[c]) * xmax + abs(b_aligned))
    return bounds


def _analyze_conv(op, op_index: int, x_iv, rounding: str, diags):
    """-> (out_interval, acc_bound attr value).  Checks bias alignment,
    accumulator fit and the output requantization shifts."""
    a = op.attrs
    where = dict(op_index=op_index, op_name=op.name, tensor=op.output)
    bias = op.weights["b"].astype(np.int64)
    n_ch = len(bias)
    b_shifts = a.get("bias_shift_per_channel") or [a["bias_shift"]] * n_ch
    out_shifts = a.get("out_shift_per_channel") or [a["out_shift"]] * n_ch

    for c in range(n_ch):
        bs = b_shifts[c]
        if bs > 31 or bs < -31:
            diags.append(Diagnostic.of(
                "ranges.shift-range",
                f"bias alignment: shift amount {bs} outside int32 "
                f"domain [-31, 31]", shift=bs, channel=c, **where))
            break
        if bs > 0 and abs(int(bias[c])) << bs > INT32_MAX:
            diags.append(Diagnostic.of(
                "ranges.shift-overflow",
                f"bias alignment: |b[{c}]|={abs(int(bias[c]))} << {bs} "
                f"overflows int32", shift=bs, channel=c, **where))
            break

    bounds = conv_acc_bounds(op, x_iv)
    for c, (bound, sh) in enumerate(zip(bounds, out_shifts)):
        before = len(diags)
        _check_requant(diags, bound, sh, rounding, "conv accumulator",
                       channel=c, **where)
        if len(diags) > before:     # one finding per op, not per channel
            break

    out_iv = (0, 127) if a.get("relu") else _INT8
    return out_iv, max(bounds)


# ---------------------------------------------------------------------------
# squash / softmax internals (shift-only integer variants)
# ---------------------------------------------------------------------------
def _check_squash(diags, in_frac: int, out_frac: int, dim: int, attrs: dict,
                  what: str, **where) -> None:
    """Integer squash (nn.variants np_q7 semantics): denominator
    `(1 << in_frac) + (Q >> in_frac)`, numerator `S << (out_frac -
    in_frac + GUARD)`, then `ratio * s >> GUARD`.  Bounds every stage.
    Skipped for unregistered squash names (flagged structurally)."""
    name, known = _variant(attrs, "squash")
    if not known:
        return
    if in_frac < 0 or in_frac > 31:
        diags.append(Diagnostic.of(
            "ranges.squash-frac-range",
            f"{what}: squash in_frac {in_frac} outside [0, 31] "
            f"(denominator needs `1 << in_frac` and `Q >> in_frac`)",
            in_frac=in_frac, **where))
        return
    # worst-case (norm, norm^2): exact uses the L2 pair, approx the
    # L-inf pair — the L2 pair dominates both
    q_max = dim * 127 * 127
    if q_max > INT32_MAX:
        diags.append(Diagnostic.of(
            "ranges.squash-overflow",
            f"{what}: squared-norm sum can reach {q_max} > int32 max",
            bound=q_max, dim=dim, **where))
        return
    s_max = math.isqrt(q_max)
    shift = out_frac - in_frac + _GUARD_BITS
    if shift > 31 or shift < -31:
        diags.append(Diagnostic.of(
            "ranges.shift-range",
            f"{what}: squash numerator shift {shift} outside [-31, 31]",
            shift=shift, **where))
        return
    num_max = s_max << shift if shift >= 0 else s_max >> -shift
    if num_max > INT32_MAX:
        diags.append(Diagnostic.of(
            "ranges.shift-overflow",
            f"{what}: squash numerator {s_max} << {shift} overflows int32",
            bound=s_max, shift=shift, **where))
        return
    ratio_max = num_max // (1 << in_frac)       # denominator >= 1 << in_frac
    if ratio_max * 127 > INT32_MAX:
        diags.append(Diagnostic.of(
            "ranges.squash-overflow",
            f"{what}: squash ratio*s product can reach {ratio_max * 127} "
            f"> int32 max", bound=ratio_max * 127, **where))


def _check_softmax(diags, attrs: dict, num_out: int, **where) -> None:
    """Shift-softmax internals (q7 / approx families): the normalizer is
    a sum of up to `num_out` terms of `1 << 20`, and the logits are
    right-shifted by `logit_frac`.  "precise" is float by design and
    unregistered names are flagged structurally — both skipped."""
    name, known = _variant(attrs, "softmax")
    if not known or name == "precise":
        return
    lf = attrs["logit_frac"]
    if lf < 0 or lf > 31:
        diags.append(Diagnostic.of(
            "ranges.logit-frac-range",
            f"softmax: logit_frac {lf} outside [0, 31] (logits are "
            f"right-shifted by it)", logit_frac=lf, **where))
    tot_max = num_out << _SOFTMAX_UNIT_BITS
    if tot_max > INT32_MAX:
        diags.append(Diagnostic.of(
            "ranges.softmax-overflow",
            f"softmax: normalizer sum can reach {num_out} * "
            f"2^{_SOFTMAX_UNIT_BITS} = {tot_max} > int32 max",
            bound=tot_max, num_out=num_out, **where))


# ---------------------------------------------------------------------------
# CAPS_ROUTING_Q7
# ---------------------------------------------------------------------------
def _analyze_routing(op, op_index: int, x_iv, rounding: str, diags):
    a = op.attrs
    where = dict(op_index=op_index, op_name=op.name, tensor=op.output)

    # u_hat = W @ u: per (j, i) capsule pair, sum over in_dim
    wsum = np.abs(op.weights["W"].astype(np.int64)).sum(axis=3)
    per_out = a.get("uhat_shift_per_out")
    if per_out:
        # per-output-capsule shifts: bound each capsule j by ITS rows of
        # W, against its own shift (one finding per op, like conv)
        for j, sh in enumerate(per_out):
            bound_j = int(wsum[j].max()) * _xmax(x_iv)
            before = len(diags)
            _check_requant(diags, bound_j, sh, rounding,
                           "u_hat accumulator", channel=j, **where)
            if len(diags) > before:
                break
    else:
        uhat_bound = int(wsum.max()) * _xmax(x_iv)
        _check_requant(diags, uhat_bound, a["uhat_shift"], rounding,
                       "u_hat accumulator", **where)
    uhat_max = 128                  # |sat8| after the u_hat requantization

    _check_softmax(diags, a, a["num_out"], **where)

    out_frac = a["squash_out_frac"]
    for r in range(a["routings"]):
        # s = sum_i c * u_hat, couplings in [0, 127]
        s_bound = a["num_in"] * 127 * uhat_max
        _check_requant(diags, s_bound, a["caps_out_shifts"][r], rounding,
                       "routing s accumulator", iteration=r, **where)
        _check_squash(diags, a["caps_out_fracs"][r], out_frac,
                      a["out_dim"], a, "routing squash",
                      iteration=r, **where)
        if r < a["routings"] - 1:
            # agreement = sum_o u_hat * v; the VM applies
            # agree_shifts[r] + (squash_out_frac - 7) (can go negative)
            agr_bound = a["out_dim"] * uhat_max * 128
            eff = a["agree_shifts"][r] + out_frac - 7
            _check_requant(diags, agr_bound, eff, rounding,
                           "agreement accumulator", iteration=r, **where)
    return _INT8


# ---------------------------------------------------------------------------
# program walk
# ---------------------------------------------------------------------------
def analyze(program):
    """-> (acc_bounds, diagnostics).

    acc_bounds maps schedule index -> the statically-derived worst-case
    |int32 conv accumulator| (incl. aligned bias) for CONV_Q7 /
    PRIMARY_CAPS_Q7 ops — exactly the `acc_bound` attr value.  Assumes
    a structurally sound program (run checker.check_structure first)."""
    iv = {0: _INT8}
    diags: list = []
    bounds: dict = {}
    for i, op in enumerate(program.ops):
        x_iv = iv[op.inputs[0]]
        if op.kind == "CONV_Q7":
            out_iv, bounds[i] = _analyze_conv(op, i, x_iv,
                                              program.rounding, diags)
        elif op.kind == "PRIMARY_CAPS_Q7":
            out_iv, bounds[i] = _analyze_conv(op, i, x_iv,
                                              program.rounding, diags)
            _check_squash(diags, op.attrs["squash_in_frac"],
                          op.attrs["squash_out_frac"], op.attrs["dim"],
                          op.attrs, "primary-caps squash",
                          op_index=i, op_name=op.name, tensor=op.output)
            out_iv = _INT8          # squash output, not the conv's
        elif op.kind == "CAPS_ROUTING_Q7":
            out_iv = _analyze_routing(op, i, x_iv, program.rounding, diags)
        else:                       # unreachable on a structure-checked
            continue                # program; stay total regardless
        iv[op.output] = out_iv
    return bounds, diags


def requant_bounds(program):
    """-> (sites, out_ivs): the static bound for every requantization
    point the EdgeVM has, keyed exactly like the runtime numerics probe
    labels them (`repro_torch.obs.numerics`), so observed and proven can be
    joined row-for-row.

    `sites` maps (op_index, site) -> worst-case |int32 accumulator|
    entering that requantization (pre-half-add, like the probe's
    `acc_peak`): conv/primary-caps `"out"` is `max(conv_acc_bounds)`
    (== the `acc_bound` attr), routing has `"uhat"`, per-iteration
    `"s[r]"`, and `"agree[r]"` for all but the last iteration.
    `out_ivs` maps op_index -> the op's static int8 output interval.
    Walks the same interval chain as `analyze()`."""
    iv = {0: _INT8}
    sites: dict = {}
    out_ivs: dict = {}
    for i, op in enumerate(program.ops):
        x_iv = iv[op.inputs[0]]
        a = op.attrs
        if op.kind in ("CONV_Q7", "PRIMARY_CAPS_Q7"):
            sites[(i, "out")] = max(conv_acc_bounds(op, x_iv))
            out_iv = (0, 127) if op.kind == "CONV_Q7" and a.get("relu") \
                else _INT8
        elif op.kind == "CAPS_ROUTING_Q7":
            wsum = np.abs(op.weights["W"].astype(np.int64)).sum(axis=3)
            sites[(i, "uhat")] = int(wsum.max()) * _xmax(x_iv)
            uhat_max = 128          # |sat8| after the u_hat requant
            for r in range(a["routings"]):
                sites[(i, f"s[{r}]")] = a["num_in"] * 127 * uhat_max
                if r < a["routings"] - 1:
                    sites[(i, f"agree[{r}]")] = \
                        a["out_dim"] * uhat_max * 128
            out_iv = _INT8
        else:
            continue
        out_ivs[i] = out_iv
        iv[op.output] = out_iv
    return sites, out_ivs


def check_ranges(program) -> list:
    """All interval/overflow/shift diagnostics for a program, plus a
    cross-check that any recorded `acc_bound` attr equals this module's
    own derivation (lower() and the VM must agree with the checker)."""
    bounds, diags = analyze(program)
    for i, op in enumerate(program.ops):
        recorded = op.attrs.get("acc_bound")
        if recorded is not None and i in bounds and recorded != bounds[i]:
            diags.append(Diagnostic.of(
                "ranges.acc-bound-mismatch",
                f"recorded acc_bound {recorded} != statically derived "
                f"{bounds[i]}", op_index=i, op_name=op.name,
                tensor=op.output, recorded=recorded, derived=bounds[i]))
    return diags


def annotate_acc_bounds(program):
    """Return the program with each conv-accumulating op's statically
    derived bound stamped as an `acc_bound` attr (the EdgeVM asserts it
    at run time, so VM and checker can never disagree silently)."""
    bounds, _ = analyze(program)
    ops = []
    for i, op in enumerate(program.ops):
        if i in bounds:
            attrs = dict(op.attrs)
            attrs["acc_bound"] = int(bounds[i])
            op = dataclasses.replace(op, attrs=attrs)
        ops.append(op)
    return dataclasses.replace(program, ops=tuple(ops))
