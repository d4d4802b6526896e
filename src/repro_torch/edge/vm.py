"""EdgeVM — a pure-NumPy q7 interpreter for `EdgeProgram`s.

Executes the exported schedule with CMSIS-NN integer semantics — int8
operands, int32 accumulation, power-of-two arithmetic shift, saturation
to [-128, 127] — in pure NumPy, exactly the way the MCU kernels would
run it.  Softmax/squash operators are resolved through the
operator-variant registry's NumPy faces (`repro_torch.nn.variants`), so
a schedule naming an unregistered variant fails loudly with the
registered names listed instead of silently mis-executing.

Bit-exactness contract: for programs lowered from a `QuantCapsNet`,
`EdgeVM(program).run(x_q)` equals `qnet.forward(x_q)` bit for bit, for
both rounding modes, per-tensor or per-channel conv plans, and every
registered operator variant, and equals the reference's `repro.edge.vm`
on the same program.  The only non-integer operator is the
beyond-paper "precise" softmax variant, which uses float32 like its
torch counterpart and is therefore matched in value but not guaranteed
to the last bit.

With a numerics probe installed (repro_torch.obs.numerics) each op
reports its requantizations (`out`, `uhat`, `s[r]`, `agree[r]`, the
sites `analysis.ranges.requant_bounds` names) and its output; with a
tracer installed the run is one `edgevm.run` span over an
`edgevm.<op>` span per op; `run(profile=rows)` records each op's host
wall time.  All of it observes only, and with none of it the plain loop
runs.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import obs
from repro_torch.edge.program import EdgeOp, EdgeProgram
from repro_torch.obs import numerics as _health
from repro_torch.nn.variants import REGISTRY as _VARIANTS

INT8_MIN, INT8_MAX = -128, 127


def _np_variant(kind: str, attrs: dict):
    """Resolve an op's variant attr to its NumPy face (shared registry
    accessor: defaults for pre-variant artifacts, raises with the
    registered names listed for unknown ones)."""
    return _VARIANTS.from_attrs(kind, attrs).np_q7


# ---------------------------------------------------------------------------
# integer primitives (NumPy mirrors of repro_torch.quant.int8_ops; the
# softmax/squash mirrors live with their variants in nn.variants)
# ---------------------------------------------------------------------------
def _sat8(x):
    return np.clip(x, INT8_MIN, INT8_MAX).astype(np.int8)


def _rshift_sat8(acc, shift: int, rounding: str):
    acc = acc.astype(np.int32)
    if shift > 0:
        if rounding == "nearest":
            acc = acc + (1 << (shift - 1))
        acc = np.right_shift(acc, shift)
    elif shift < 0:
        acc = np.left_shift(acc, -shift)
    return _sat8(acc)


def _rshift_sat8_vec(acc, shifts, rounding: str):
    """Per-lane (per-channel) variant; mirrors int8_ops.rshift_sat8_vec."""
    acc = acc.astype(np.int32)
    shifts = np.asarray(shifts, np.int32)
    if rounding == "nearest":
        half = np.left_shift(np.int32(1), np.maximum(shifts - 1, 0))
        acc = acc + np.where(shifts > 0, half, 0)
    acc = np.right_shift(acc, np.maximum(shifts, 0))
    acc = np.left_shift(acc, np.maximum(-shifts, 0))
    return _sat8(acc)


def _conv2d_acc(x, w, stride: int):
    """VALID NHWC int conv via im2col, int32 accumulation (wrap-on-
    overflow; `_assert_acc_bound` enforces the statically-proven bound
    lower() records, so a geometry that could wrap is rejected rather
    than silently wrong)."""
    kh, kw = w.shape[0], w.shape[1]
    win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(1, 2))
    win = win[:, ::stride, ::stride]            # [B,Ho,Wo,Cin,kh,kw]
    return np.einsum("bhwcij,ijco->bhwo", win.astype(np.int32),
                     w.astype(np.int32), dtype=np.int32)


def _add_q7(a, b):
    return _sat8(a.astype(np.int32) + b.astype(np.int32))


# ---------------------------------------------------------------------------
# op execution
# ---------------------------------------------------------------------------
def _run_conv(op: EdgeOp, x, rounding: str, relu_override=None):
    a = op.attrs
    acc = _conv2d_acc(x, op.weights["w"], a["stride"])
    bias = op.weights["b"].astype(np.int32)
    if a.get("bias_shift_per_channel"):
        bs = np.asarray(a["bias_shift_per_channel"], np.int32)
        bias = np.left_shift(bias, np.maximum(bs, 0))
        bias = np.right_shift(bias, np.maximum(-bs, 0))
    else:
        bs = a["bias_shift"]
        bias = np.left_shift(bias, bs) if bs >= 0 \
            else np.right_shift(bias, -bs)
    acc = acc + bias
    _assert_acc_bound(op, acc)
    if _health._PROBE is not None:     # pure observer — never alters acc
        _health._PROBE.observe_requant(
            acc, a.get("out_shift_per_channel") or a["out_shift"],
            rounding, site="out", bound=a.get("acc_bound"))
    if a.get("out_shift_per_channel"):
        y = _rshift_sat8_vec(acc, a["out_shift_per_channel"], rounding)
    else:
        y = _rshift_sat8(acc, a["out_shift"], rounding)
    relu = a["relu"] if relu_override is None else relu_override
    return np.maximum(y, 0).astype(np.int8) if relu else y


def _assert_acc_bound(op: EdgeOp, acc) -> None:
    """`lower()` records the statically-derived worst-case |int32
    accumulator| (repro_torch.analysis.ranges) as an `acc_bound` attr;
    the VM enforces it so a wrap the checker proved impossible can never
    happen silently here either (pre-acc_bound artifacts skip it)."""
    bound = op.attrs.get("acc_bound")
    if bound is None or not acc.size:
        return
    peak = int(np.abs(acc.astype(np.int64)).max())
    if peak > bound:
        raise AssertionError(
            f"{op.name}: |int32 accumulator| reached {peak}, above the "
            f"statically derived acc_bound {bound} — the program's "
            f"attrs disagree with its weights; rerun "
            f"repro_torch.analysis.check_program on this artifact")


def _run_primary_caps(op: EdgeOp, x, rounding: str):
    a = op.attrs
    y = _run_conv(op, x, rounding, relu_override=False)
    u = y.reshape(y.shape[0], -1, a["dim"])
    return _np_variant("squash", a)(u, a["squash_in_frac"],
                                    a["squash_out_frac"])


def _run_routing(op: EdgeOp, u, rounding: str):
    a = op.attrs
    W = op.weights["W"].astype(np.int32)
    acc = np.einsum("jiod,bid->bjio", W, u.astype(np.int32),
                    dtype=np.int32)
    if a.get("uhat_shift_per_out"):
        # per-output-capsule W formats (RoutingPlan.per_out): acc is
        # [B,J,I,O], so the length-J table must broadcast on axis 1
        sh = np.asarray(a["uhat_shift_per_out"], np.int32)[None, :, None,
                                                           None]
        if _health._PROBE is not None:
            _health._PROBE.observe_requant(acc, sh, rounding, site="uhat")
        u_hat = _rshift_sat8_vec(acc, sh, rounding)
    else:
        if _health._PROBE is not None:
            _health._PROBE.observe_requant(acc, a["uhat_shift"], rounding,
                                           site="uhat")
        u_hat = _rshift_sat8(acc, a["uhat_shift"], rounding)

    out_frac = a["squash_out_frac"]
    softmax = _np_variant("softmax", a)
    squash = _np_variant("squash", a)
    b = np.zeros(u_hat.shape[:3], np.int8)
    v = None
    for r in range(a["routings"]):
        c = softmax(b.swapaxes(1, 2), a["logit_frac"]).swapaxes(1, 2)
        acc = np.einsum("bji,bjio->bjo", c.astype(np.int32),
                        u_hat.astype(np.int32), dtype=np.int32)
        if _health._PROBE is not None:
            _health._PROBE.observe_requant(acc, a["caps_out_shifts"][r],
                                           rounding, site=f"s[{r}]")
        s_q = _rshift_sat8(acc, a["caps_out_shifts"][r], rounding)
        v = squash(s_q, a["caps_out_fracs"][r], out_frac)
        if r < a["routings"] - 1:
            acc = np.einsum("bjio,bjo->bji", u_hat.astype(np.int32),
                            v.astype(np.int32), dtype=np.int32)
            # agree_shifts assume a Q0.7 squash; compensate plan edits
            # exactly like the torch backend does
            if _health._PROBE is not None:
                _health._PROBE.observe_requant(
                    acc, a["agree_shifts"][r] + out_frac - 7, rounding,
                    site=f"agree[{r}]")
            agr = _rshift_sat8(acc, a["agree_shifts"][r] + out_frac - 7,
                               rounding)
            b = _add_q7(b, agr)
    return v


_RUNNERS = {
    "CONV_Q7": _run_conv,
    "PRIMARY_CAPS_Q7": _run_primary_caps,
    "CAPS_ROUTING_Q7": _run_routing,
}


class EdgeVM:
    """Interpreter for one EdgeProgram.

        vm = EdgeVM(lower(qnet))
        v_q = vm.run(x_q)           # int8 [B, classes, caps_dim]

    `run` accepts a single sample (the program's per-sample input shape)
    or a batch with a leading axis, always as int8 already quantized to
    the program's input format (use `quantize_input` for floats).

    Profile rows carry `op_index` (schedule position) next to name/kind
    — the join key `repro_torch.obs.analyze.costmodel_drift` uses to line
    measured rows up against `costmodel.estimate_program` rows."""

    def __init__(self, program: EdgeProgram):
        self.program = program

    def quantize_input(self, x) -> np.ndarray:
        q = np.round(np.asarray(x, np.float32)
                     * (2.0 ** self.program.input_frac))
        return np.clip(q, INT8_MIN, INT8_MAX).astype(np.int8)

    def run(self, x_q: np.ndarray, *, trace: dict | None = None,
            profile: list | None = None):
        """Execute the schedule.  `trace` captures every intermediate
        activation by op name (tests use it to pin per-layer bits).
        `profile` appends one {"op_index", "name", "kind", "wall_s"} row
        per op — the measured host-side counterpart of the static
        `costmodel` estimate.  Both are pure observation: the op loop
        computes identical bits with or without them, and when neither
        is requested (and no probe or tracer is installed) the plain
        loop runs untouched."""
        p = self.program
        x_q = np.asarray(x_q)
        if x_q.dtype != np.int8:
            raise TypeError(f"EdgeVM.run wants int8 input in the "
                            f"program's Q format, got {x_q.dtype}")
        squeeze = x_q.shape == p.input_tensor.shape
        h = x_q[None] if squeeze else x_q
        if h.shape[1:] != p.input_tensor.shape:
            raise ValueError(f"input shape {x_q.shape} does not match "
                             f"program input {p.input_tensor.shape}")
        probe = _health._PROBE
        if trace is None and profile is None and probe is None \
                and obs.get_tracer() is None:
            for op in p.ops:                     # hot path: zero obs cost
                h = _RUNNERS[op.kind](op, h, p.rounding)
            return h[0] if squeeze else h
        with obs.span("edgevm.run", program=p.name, batch=h.shape[0]):
            for i, op in enumerate(p.ops):
                if probe is not None:
                    probe.begin_op(i, op.name, op.kind)
                with obs.span(f"edgevm.{op.name}", kind=op.kind):
                    t0 = time.perf_counter()
                    h = _RUNNERS[op.kind](op, h, p.rounding)
                    wall = time.perf_counter() - t0
                if probe is not None:
                    probe.observe_output(h, frac=p.tensor(op.output).frac)
                if profile is not None:
                    profile.append({"op_index": i, "name": op.name,
                                    "kind": op.kind, "wall_s": wall})
                if trace is not None:
                    trace[op.name] = h
        return h[0] if squeeze else h


def execute(program: EdgeProgram, x_q) -> np.ndarray:
    """One-shot convenience: EdgeVM(program).run(x_q)."""
    return EdgeVM(program).run(x_q)
