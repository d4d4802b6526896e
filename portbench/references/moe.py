"""Sparse experts as Mixtral routes them (arXiv:2401.04088 §2.1): router
logits x @ W_r in float32, softmax over all experts, the top k (ties to
the lower index), gates renormalised over the k; every token reaches
its k experts (none dropped); each expert a SwiGLU, w_down(silu(x w_gate)
* (x w_up)), its three products W8A8.  The activation of w_gate and w_up
is the group's tokens, that of w_down every assignment of the group.

Notes `route_margin` [B, T]: for each token, the least over the layers
so far of the gap between its k-th and (k+1)-th router logit, where a
route can turn on rounding; `routes`, a list with one entry a MoE layer:
each token's k experts [B, T, k], by falling probability."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def leaves(cfg: dict) -> dict:
    D, Fd, E = cfg["d_model"], cfg["d_ff"], cfg["num_experts"]
    bf = torch.bfloat16
    return {"moe/router": ((D, E), torch.float32),
            "moe/w_gate": ((E, D, Fd), bf), "moe/w_up": ((E, D, Fd), bf),
            "moe/w_down": ((E, Fd, D), bf)}


def _expert(w, e):
    return w[0][e], w[1][e]


def apply(ctx, p, h):
    cfg = ctx.cfg
    B, T, D = h.shape
    E, k = cfg["num_experts"], cfg["experts_per_tok"]
    N = B * T
    rows = h.reshape(N, D)
    rg = ctx.groups.repeat(B)
    logits = rows @ p["moe/router"].float()                  # [N, E]
    ranked, order = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                               descending=True, stable=True)
    top = order[:, :k]
    gates = ranked[:, :k] / ranked[:, :k].sum(-1, keepdim=True)
    srt = torch.sort(logits, dim=-1, descending=True).values
    margin = (srt[:, k - 1] - srt[:, k]).view(B, T)
    prev = ctx.notes.get("route_margin")
    ctx.notes["route_margin"] = margin if prev is None \
        else torch.minimum(prev, margin)
    ctx.notes.setdefault("routes", []).append(top.view(B, T, k))

    xq, er = ctx.quantize(rows, rg)
    a = torch.empty((N, k, cfg["d_ff"]), dtype=torch.float32,
                    device=h.device)
    sel = [torch.nonzero(top == e, as_tuple=True) for e in range(E)]
    for e, (tok, slot) in enumerate(sel):
        if tok.numel():
            g = ctx.product(xq[tok], er[tok], *_expert(p["moe/w_gate"], e))
            u = ctx.product(xq[tok], er[tok], *_expert(p["moe/w_up"], e))
            a[tok, slot] = F.silu(g) * u
    del xq
    aq, ea = ctx.quantize(a.view(N * k, -1), rg.repeat_interleave(k))
    del a
    y = torch.zeros((N, D), dtype=torch.float32, device=h.device)
    for e, (tok, slot) in enumerate(sel):
        if tok.numel():
            i = tok * k + slot
            ye = ctx.product(aq[i], ea[i], *_expert(p["moe/w_down"], e))
            y.index_add_(0, tok, ye * gates[tok, slot, None])
    return y.view(B, T, D)
