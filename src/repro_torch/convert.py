"""Carrying weights and train states across from the reference package:
CapsNet params, train states and quantized nets, LM param trees and LM
train states.

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


def _lm_leaf_from(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16: its bits
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_reference(np_tree, device=None):
    """A reference LM param tree (nested dicts and tuples of NumPy
    leaves: stacked [C, ...] block leaves, {"q","n"} W8A8 leaves) -> the
    port's, leaf for leaf: bfloat16, float32, int8 and int32 kept as they
    are, on `device`; a W8A8 leaf's q [..., K, N] becomes the port's
    K-major qt [..., N, K] (`quant.lm_quant`)."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict) and set(tree) == {"q", "n"}:
            qt = np.ascontiguousarray(np.swapaxes(np.asarray(tree["q"]),
                                                  -1, -2))
            return {"qt": _lm_leaf_from(qt, device), "n": conv(tree["n"])}
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(conv(v) for v in tree)
        return _lm_leaf_from(tree, device)
    return conv(np_tree)


def lm_params_to_reference(tree):
    """The port's LM param tree -> NumPy leaves in the reference's
    structure; bfloat16 leaves come back as float32 (exact), the rest in
    their own dtype, for the reference to cast to its leaf's dtype; a
    W8A8 leaf's qt [..., N, K] as the reference's q [..., K, N]."""
    if isinstance(tree, dict) and set(tree) == {"qt", "n"}:
        return {"q": np.ascontiguousarray(np.swapaxes(
            lm_params_to_reference(tree["qt"]), -1, -2)),
            "n": lm_params_to_reference(tree["n"])}
    if isinstance(tree, dict):
        return {k: lm_params_to_reference(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(lm_params_to_reference(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_train_state_from_reference(np_state: dict, device=None) -> dict:
    """A reference LM train state ({"params", "opt": {"m", "v", "step"},
    "step"(, "err")}, NumPy leaves) -> the port's: the trees leaf for
    leaf through `lm_params_from_reference` (bf16 params, float32
    moments and error buffer), the steps 0-d int32 tensors, on `device`."""
    device = resolve_device(device)

    def step(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=device)
    opt = np_state["opt"]
    out = {"params": lm_params_from_reference(np_state["params"], device),
           "opt": {"m": lm_params_from_reference(opt["m"], device),
                   "v": lm_params_from_reference(opt["v"], device),
                   "step": step(opt["step"])},
           "step": step(np_state["step"])}
    if "err" in np_state:
        out["err"] = lm_params_from_reference(np_state["err"], device)
    return out


def lm_train_state_to_reference(state: dict) -> dict:
    """The port's LM train state -> NumPy leaves in the reference's
    structure (what `lm_train_state_from_reference` reads); bf16 params
    come back as float32 (exact), the steps as 0-d int32 arrays."""
    def step(t):
        return np.asarray(int(t), np.int32)
    opt = state["opt"]
    out = {"params": lm_params_to_reference(state["params"]),
           "opt": {"m": lm_params_to_reference(opt["m"]),
                   "v": lm_params_to_reference(opt["v"]),
                   "step": step(opt["step"])},
           "step": step(state["step"])}
    if "err" in state:
        out["err"] = lm_params_to_reference(state["err"])
    return out
