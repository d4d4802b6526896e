"""Optimizers as plain functions over nested dicts of tensors: AdamW
(default) and SGD-momentum, a cosine schedule, global-norm clipping.

The update is the reference's (`repro.optim.adam`) formula, in float32:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p;  p = p - lr delta
with b2 = 0.95 by default.  It is not `torch.optim.AdamW`, whose decay
(applied to p before the step, scaled by lr) and eps placement differ.
Moments are float32 whatever the parameter dtype; `step` is a 0-d int32
tensor on the params' device.  Under a tensor-parallel mesh the update
runs on each rank's shares unchanged (it is elementwise); the global
norm sums the squares of the split leaves over the model line and counts
each replicated leaf once (`global_norm(split=)`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch

from repro_torch.dist import api
from repro_torch.dist.op_analysis import trip_scan
from repro_torch.tree import leaves, tree_map, unflatten

UPDATE_CHUNK = 1 << 24    # elements a chunk of `AdamW.update_`

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def fn(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn


def global_norm(tree, split=None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted key order) of sum(g^2).  Under
    a tensor-parallel mesh (`api.model_group`), `split` flags the leaves
    (in `leaves(tree)` order) whose shares the model line holds: their
    sums are added over the line, each other leaf's counted once."""
    group = api.model_group()
    if group is None or split is None:
        total = 0
        for g in leaves(tree):
            total = total + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    parts = [0, 0]
    for g, s in zip(leaves(tree), split):
        parts[bool(s)] = parts[bool(s)] + torch.sum(torch.square(
            g.to(torch.float32)))
    whole, shared = (torch.as_tensor(p, dtype=torch.float32,
                                     device=leaves(tree)[0].device)
                     for p in parts)
    return torch.sqrt(whole + api.collective("sum", shared, group.handle))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _step0(params):
    first = leaves(params)
    device = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr(lr: Schedule, step):
    if callable(lr):
        return lr(step)
    return torch.as_tensor(lr, dtype=torch.float32, device=step.device)


def _clip_or_norm(grads, clip_norm: float):
    if clip_norm > 0:
        return clip_by_global_norm(grads, clip_norm)
    return grads, global_norm(grads)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Schedule = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params) -> dict:
        return {"m": _zeros(params), "v": _zeros(params),
                "step": _step0(params)}

    def _scalars(self, step):
        lr = _lr(self.lr, step)
        bc1 = 1 - self.b1 ** step.to(torch.float32)
        bc2 = 1 - self.b2 ** step.to(torch.float32)
        return lr, bc1, bc2

    def _leaf(self, p, g, m, v, lr, bc1, bc2):
        """One leaf's (new p, new m, new v)."""
        b1, b2 = self.b1, self.b2
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + self.eps)
        if self.weight_decay:
            delta = delta + self.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return new_p, m, v

    @torch.no_grad()
    def update(self, grads, state, params):
        """(grads, state, params) -> (params, state, {"grad_norm", "lr"})."""
        step = state["step"] + 1
        grads, gnorm = _clip_or_norm(grads, self.clip_norm)
        lr, bc1, bc2 = self._scalars(step)
        out = [self._leaf(p, g, m, v, lr, bc1, bc2) for p, g, m, v in zip(
            leaves(params), leaves(grads), leaves(state["m"]),
            leaves(state["v"]))]
        new_state = {"m": _pick(params, out, 1), "v": _pick(params, out, 2),
                     "step": step}
        return _pick(params, out, 0), new_state, {"grad_norm": gnorm,
                                                  "lr": lr}

    @torch.no_grad()
    def update_(self, grads: list, state, params,
                chunk: int | None = None, split=None) -> dict:
        """`update` in place: `grads` a flat list in `leaves(params)`
        order, consumed (each entry set to None once applied); every
        param, m and v is overwritten and state["step"] advanced, so no
        second copy of the state is ever held.  The work runs `chunk`
        elements at a time (UPDATE_CHUNK by default); every op is
        elementwise, so the bits are `update`'s.  `split` flags the
        leaves split over a tensor-parallel mesh (`global_norm`).
        Returns {"grad_norm", "lr"}."""
        chunk = chunk or UPDATE_CHUNK
        step = state["step"] + 1
        gnorm = global_norm(grads, split)
        scale = _clip_scale(gnorm, self.clip_norm) if self.clip_norm > 0 \
            else None
        lr, bc1, bc2 = self._scalars(step)
        for i, (p, m, v) in enumerate(zip(leaves(params), leaves(state["m"]),
                                          leaves(state["v"]))):
            g = grads[i]
            grads[i] = None
            pf, mf, vf = (t.view(-1) for t in (p, m, v))
            gf = g.reshape(-1)

            def part(j, _, pf=pf, mf=mf, vf=vf, gf=gf):
                sl = slice(j * chunk, (j + 1) * chunk)
                gs = gf[sl]
                if scale is not None:
                    gs = (gs.to(torch.float32) * scale).to(gs.dtype)
                new_p, new_m, new_v = self._leaf(pf[sl], gs, mf[sl], vf[sl],
                                                 lr, bc1, bc2)
                pf[sl].copy_(new_p)
                mf[sl].copy_(new_m)
                vf[sl].copy_(new_v)
                return None, None
            trip_scan(part, -(-pf.numel() // chunk))
        state["step"] = step
        return {"grad_norm": gnorm, "lr": lr}


def _pick(tree, out: list, i: int):
    """A tree of `tree`'s structure holding the i-th member of each
    tuple in `out` (one tuple per leaf, in leaf order)."""
    return unflatten(tree, [o[i] for o in out])


@dataclasses.dataclass(frozen=True)
class SGDM:
    lr: Schedule = 1e-2
    momentum: float = 0.9
    clip_norm: float = 0.0

    def init(self, params) -> dict:
        return {"m": _zeros(params), "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        grads, gnorm = _clip_or_norm(grads, self.clip_norm)
        lr = _lr(self.lr, step)

        def upd(p, g, m):
            m = self.momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr * m).to(p.dtype), m

        out = [upd(p, g, m) for p, g, m in zip(
            leaves(params), leaves(grads), leaves(state["m"]))]
        return _pick(params, out, 0), {"m": _pick(params, out, 1),
                                       "step": step}, \
            {"grad_norm": gnorm, "lr": lr}
