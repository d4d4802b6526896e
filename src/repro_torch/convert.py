"""Carrying weights and train states across from the reference package.

The functions take and give plain NumPy arrays and JSON (what the
reference's arrays and `plan_to_json` give), so this module imports
nothing of the reference.  Tests use them to make both packages compute
on the same weights; the reference's init RNG is never imitated.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.config import CapsNetConfig
from repro_torch.nn.pipeline import CapsPipeline, QuantCapsNet
from repro_torch.nn.plans import ConvPlan, PrimaryCapsPlan, RoutingPlan, \
    plan_from_json


def params_from_reference(np_params: dict, device=None) -> dict:
    """The reference's float params ({layer: {"w", "b"} | {"W"}}, NumPy)
    -> the port's (same layouts: HWIO convs, [J, I, O, D] routing W)."""
    device = resolve_device(device)
    return {layer: {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                    for k, v in ws.items()}
            for layer, ws in np_params.items()}


def state_from_reference(np_state: dict, device=None) -> dict:
    """A reference train state ({"params": {"caps", "dec"}, "opt": {"m",
    "v", "step"}}, NumPy leaves) -> the port's: float32 tensors, and
    `opt/step` a 0-d int32 tensor, on `device`."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        a = np.asarray(tree)
        dtype = np.int32 if a.dtype.kind in "iu" else np.float32
        return torch.from_numpy(np.array(a, dtype)).to(device)
    return conv(np_state)


def state_to_reference(state: dict) -> dict:
    """The port's train state -> NumPy leaves in the reference's layout
    (what `state_from_reference` reads)."""
    if isinstance(state, dict):
        return {k: state_to_reference(v) for k, v in state.items()}
    return state.detach().cpu().numpy()


def qnet_from_reference(plan_json: dict, np_qweights: dict,
                        cfg: CapsNetConfig, *, rounding: str = "floor",
                        backend: str = "torch", device=None) -> QuantCapsNet:
    """The reference's `plan_to_json(qnet.plan)` and int8 qweights ->
    the port's QuantCapsNet.  The pipeline's per-channel options and
    variants are read off the plan."""
    device = resolve_device(device)
    plan = plan_from_json(plan_json)
    convs = [p.conv if isinstance(p, PrimaryCapsPlan) else p
             for p in plan.layers.values()
             if isinstance(p, (ConvPlan, PrimaryCapsPlan))]
    routes = [p for p in plan.layers.values() if isinstance(p, RoutingPlan)]
    pipe = CapsPipeline.from_config(
        cfg, variants=plan.variants,
        per_channel=any(c.per_channel for c in convs),
        per_channel_w=any(r.per_out for r in routes))
    qweights = {layer: {k: torch.from_numpy(np.array(v, np.int8)).to(device)
                        for k, v in ws.items()}
                for layer, ws in np_qweights.items()}
    return QuantCapsNet(pipeline=pipe, plan=plan, qweights=qweights,
                        rounding=rounding, backend=backend)
