"""Lower a calibrated `QuantCapsNet` of the port into an `EdgeProgram`.

The walk mirrors `CapsPipeline.forward_q7` one-to-one: each layer
becomes one schedule entry whose attrs are a flat copy of its typed plan
(ConvPlan / PrimaryCapsPlan / RoutingPlan) and whose weight blobs are
the already-quantized int8 tensors, brought to the host as NumPy arrays
from whatever device they live on.  Activation shapes are per-sample
(no batch dim) — the MCU artifact serves batch 1; the VM re-vectorizes
over a leading batch axis when testing against the host model.  The
program, and so the `.capsbin` written from it, equals the reference's
`repro.edge.lower` of the same net byte for byte.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.ranges import annotate_acc_bounds
from repro_torch.edge.program import EdgeOp, EdgeProgram, TensorSpec
from repro_torch.nn.layers import CapsuleRouting, PrimaryCaps, QuantConv2D
from repro_torch.nn.pipeline import QuantCapsNet


def _conv_attrs(layer: QuantConv2D, plan) -> dict:
    attrs = {
        "kernel": layer.kernel, "stride": layer.stride,
        "in_ch": layer.in_ch, "out_ch": layer.out_ch,
        "relu": layer.relu,
        "in_frac": plan.in_frac, "w_frac": plan.w_frac,
        "b_frac": plan.b_frac, "out_frac": plan.out_frac,
        "out_shift": plan.out_shift, "bias_shift": plan.bias_shift,
    }
    if plan.per_channel:
        attrs["w_frac_per_channel"] = tuple(plan.w_frac_per_channel)
        attrs["out_shift_per_channel"] = tuple(plan.out_shift_per_channel)
        attrs["bias_shift_per_channel"] = tuple(plan.bias_shift_per_channel)
    return attrs


def _np(t) -> np.ndarray:
    """An int8 weight tensor on any device as a host NumPy array."""
    return np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.int8)


def lower(qnet: QuantCapsNet, name: str | None = None) -> EdgeProgram:
    """Compile any quantized CapsNet (per-tensor or per-channel plans,
    either rounding mode) into the flat MCU schedule."""
    cfg = qnet.pipeline.cfg
    name = name or cfg.name
    h, w = cfg.input_shape[0], cfg.input_shape[1]

    tensors = [TensorSpec(0, "input", tuple(cfg.input_shape),
                          qnet.plan.input_frac)]
    ops = []

    def new_tensor(tname, shape, frac) -> int:
        tensors.append(TensorSpec(len(tensors), tname, tuple(shape), frac))
        return len(tensors) - 1

    cur = 0
    for layer in qnet.pipeline.layers:
        plan = qnet.plan[layer.name]
        qw = {k: _np(v) for k, v in qnet.qweights[layer.name].items()}
        if isinstance(layer, PrimaryCaps):
            conv = layer.conv
            h = (h - conv.kernel) // conv.stride + 1
            w = (w - conv.kernel) // conv.stride + 1
            attrs = _conv_attrs(conv, plan.conv)
            attrs.update(caps=layer.caps, dim=layer.dim,
                         squash_in_frac=plan.conv.out_frac,
                         squash_out_frac=plan.squash_out_frac,
                         squash_impl=plan.squash_impl)
            out = new_tensor(f"{layer.name}.caps",
                             (h * w * layer.caps, layer.dim),
                             plan.squash_out_frac)
            ops.append(EdgeOp("PRIMARY_CAPS_Q7", layer.name, (cur,), out,
                              attrs, qw))
        elif isinstance(layer, QuantConv2D):
            h = (h - layer.kernel) // layer.stride + 1
            w = (w - layer.kernel) // layer.stride + 1
            out = new_tensor(f"{layer.name}.out", (h, w, layer.out_ch),
                             plan.out_frac)
            ops.append(EdgeOp("CONV_Q7", layer.name, (cur,), out,
                              _conv_attrs(layer, plan), qw))
        elif isinstance(layer, CapsuleRouting):
            attrs = {
                "num_out": layer.num_out, "num_in": layer.num_in,
                "out_dim": layer.out_dim, "in_dim": layer.in_dim,
                "routings": layer.routings,
                "in_frac": plan.in_frac, "W_frac": plan.W_frac,
                "uhat_frac": plan.uhat_frac, "uhat_shift": plan.uhat_shift,
                "logit_frac": plan.logit_frac,
                "caps_out_shifts": tuple(plan.caps_out_shifts),
                "caps_out_fracs": tuple(plan.caps_out_fracs),
                "agree_shifts": tuple(plan.agree_shifts),
                "softmax_impl": plan.softmax_impl,
                "squash_out_frac": plan.squash_out_frac,
                "squash_impl": plan.squash_impl,
            }
            if plan.per_out:
                attrs["W_frac_per_out"] = tuple(plan.W_frac_per_out)
                attrs["uhat_shift_per_out"] = \
                    tuple(plan.uhat_shift_per_out)
            out = new_tensor(f"{layer.name}.v",
                             (layer.num_out, layer.out_dim),
                             plan.out_frac)
            ops.append(EdgeOp("CAPS_ROUTING_Q7", layer.name, (cur,), out,
                              attrs, qw))
        else:
            raise TypeError(
                f"no lowering for layer {layer.name!r} "
                f"({type(layer).__name__}); teach repro_torch.edge.lower "
                "about new layer kinds before exporting them")
        cur = out

    program = EdgeProgram(name=name, rounding=qnet.rounding,
                          input_frac=qnet.plan.input_frac,
                          tensors=tuple(tensors), ops=tuple(ops))
    # every conv-accumulating op carries its statically-derived
    # worst-case |int32 accumulator| (repro_torch.analysis.ranges); the
    # VM asserts it at run time, so the checker and the VM cannot
    # silently disagree about wrap safety
    return annotate_acc_bounds(program)


def describe(program: EdgeProgram) -> str:
    """One line per schedule entry (the CLI's program dump)."""
    lines = [f"EdgeProgram {program.name!r} rounding={program.rounding} "
             f"input={program.input_tensor.shape} "
             f"Q{7 - program.input_frac}.{program.input_frac}"]
    for op in program.ops:
        o = program.tensor(op.output)
        lines.append(f"  {op.kind:<16} {op.name:<6} -> {o.shape} "
                     f"frac={o.frac} weights={op.weight_bytes}B")
    return "\n".join(lines)
