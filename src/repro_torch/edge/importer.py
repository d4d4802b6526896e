"""Import a `.capsbin` artifact back into a servable `QuantCapsNet`.

`lower()` is a lossless flattening: every op record carries the full
typed plan and the int8 blobs.  This module is its inverse — rebuild the
`CapsNetConfig` geometry from the schedule, re-type the attrs into
Conv/PrimaryCaps/Routing plans, and wrap the blobs into a
`QuantCapsNet` whose int8 weights lie on the device the caller names
(the card unless it asks for the CPU) — so the serving engine serves
EXACTLY the artifact `export_caps` shipped
(`ModelRegistry.install_artifact`), not a model that was merely
quantized the same way.  A net on a CUDA device runs the `cuda` backend
(the hand-written routing and squash kernels); on the CPU it runs the
`torch` oracle.

Round-trip contract:
  program -> to_qnet -> lower  ==  program   (same_as, bit for bit)
  to_qnet(program).forward     ==  EdgeVM(program).run
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.edge.program import EdgeProgram
from repro_torch.nn.config import CapsNetConfig
from repro_torch.nn.pipeline import CapsPipeline, QuantCapsNet
from repro_torch.nn.plans import ConvPlan, PipelinePlan, PrimaryCapsPlan, \
    RoutingPlan
from repro_torch.nn.variants import REGISTRY as _VARIANTS
from repro_torch.nn.variants import VariantSet


def _impl(attrs: dict, kind: str) -> str:
    """An op's variant reference, defaulted for pre-variant artifacts
    (shared registry accessor); a tampered/unknown name is rejected
    with the registered ones listed."""
    return _VARIANTS.from_attrs(kind, attrs).name


def _conv_plan(attrs: dict) -> ConvPlan:
    return ConvPlan(
        in_frac=attrs["in_frac"], w_frac=attrs["w_frac"],
        b_frac=attrs["b_frac"], out_frac=attrs["out_frac"],
        out_shift=attrs["out_shift"], bias_shift=attrs["bias_shift"],
        w_frac_per_channel=tuple(attrs.get("w_frac_per_channel", ())),
        out_shift_per_channel=tuple(attrs.get("out_shift_per_channel", ())),
        bias_shift_per_channel=tuple(
            attrs.get("bias_shift_per_channel", ())))


def program_config(program: EdgeProgram) -> CapsNetConfig:
    """Rebuild the geometry config the program was lowered from."""
    convs = [op for op in program.ops if op.kind == "CONV_Q7"]
    pcaps = [op for op in program.ops if op.kind == "PRIMARY_CAPS_Q7"]
    routs = [op for op in program.ops if op.kind == "CAPS_ROUTING_Q7"]
    if len(pcaps) != 1 or len(routs) != 1:
        raise ValueError(
            f"{program.name}: expected one PRIMARY_CAPS_Q7 and one "
            f"CAPS_ROUTING_Q7 op, got {len(pcaps)}/{len(routs)} — not a "
            "pipeline this importer can rebuild")
    pc, rt = pcaps[0].attrs, routs[0].attrs
    cfg = CapsNetConfig(
        name=program.name,
        input_shape=tuple(program.input_tensor.shape),
        conv_filters=tuple(op.attrs["out_ch"] for op in convs),
        conv_kernels=tuple(op.attrs["kernel"] for op in convs),
        conv_strides=tuple(op.attrs["stride"] for op in convs),
        pcap_caps=pc["caps"], pcap_dim=pc["dim"],
        pcap_kernel=pc["kernel"], pcap_stride=pc["stride"],
        num_classes=rt["num_out"], caps_dim=rt["out_dim"],
        routings=rt["routings"])
    if cfg.num_input_caps != rt["num_in"]:
        raise ValueError(
            f"{program.name}: geometry mismatch — schedule implies "
            f"{cfg.num_input_caps} input capsules, routing op says "
            f"{rt['num_in']}")
    return cfg


def to_qnet(program: EdgeProgram, *, check: bool = True,
            device=None) -> QuantCapsNet:
    """EdgeProgram -> QuantCapsNet executing bit-identically to the VM,
    its int8 weights on `resolve_device(device)`.

    check (default on): run the static verifier first
    (repro_torch.analysis.check_program), so a tampered or miscompiled
    artifact is rejected with op/tensor-precise diagnostics
    (CheckError, a ValueError) instead of being served."""
    device = resolve_device(device)
    if check:
        from repro_torch.analysis import check_program
        check_program(program).raise_if_failed()
    cfg = program_config(program)
    routing = next(op for op in program.ops
                   if op.kind == "CAPS_ROUTING_Q7")
    pipeline = CapsPipeline.from_config(
        cfg, variants=VariantSet(softmax=_impl(routing.attrs, "softmax"),
                                 squash=_impl(routing.attrs, "squash")),
        per_channel=any("w_frac_per_channel" in op.attrs
                        for op in program.ops),
        per_channel_w="W_frac_per_out" in routing.attrs)

    plans, qweights = {}, {}
    if len(pipeline.layers) != len(program.ops):
        raise ValueError(f"{program.name}: {len(program.ops)} ops for "
                         f"{len(pipeline.layers)} pipeline layers")
    for layer, op in zip(pipeline.layers, program.ops):
        a = op.attrs
        if op.kind == "CONV_Q7":
            plans[layer.name] = _conv_plan(a)
        elif op.kind == "PRIMARY_CAPS_Q7":
            plans[layer.name] = PrimaryCapsPlan(
                conv=_conv_plan(a), squash_out_frac=a["squash_out_frac"],
                squash_impl=_impl(a, "squash"))
        else:
            plans[layer.name] = RoutingPlan(
                uhat_shift=a["uhat_shift"], logit_frac=a["logit_frac"],
                caps_out_shifts=tuple(a["caps_out_shifts"]),
                caps_out_fracs=tuple(a["caps_out_fracs"]),
                agree_shifts=tuple(a["agree_shifts"]),
                softmax_impl=_impl(a, "softmax"), in_frac=a["in_frac"],
                W_frac=a["W_frac"], uhat_frac=a["uhat_frac"],
                squash_out_frac=a["squash_out_frac"],
                squash_impl=_impl(a, "squash"),
                W_frac_per_out=tuple(a.get("W_frac_per_out", ())),
                uhat_shift_per_out=tuple(
                    a.get("uhat_shift_per_out", ())))
        qweights[layer.name] = {
            k: torch.from_numpy(np.array(w, np.int8)).to(device)
            for k, w in op.weights.items()}

    plan = PipelinePlan(input_frac=program.input_frac, layers=plans)
    return QuantCapsNet(pipeline=pipeline, plan=plan, qweights=qweights,
                        rounding=program.rounding,
                        backend="cuda" if device.type == "cuda" else "torch")


def load_qnet(path, *, check: bool = True, device=None) -> QuantCapsNet:
    """One-call `.capsbin` file -> servable model on `device`
    (statically checked unless check=False)."""
    return to_qnet(EdgeProgram.load(path), check=check, device=device)
