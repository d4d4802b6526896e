"""Mixture-of-Experts FFN: top-k router with capacity-limited, sort-free
scatter/gather dispatch (GShard-style groups); the counterpart of
`repro.models.moe`.

Tokens are scattered into a [G, E, C, D] buffer by (expert,
position-in-expert) slot and gathered back, so dispatch moves bytes and
does no one-hot product.  Groups: one per batch row at train and
prefill, one over the whole batch at decode.  Assignments past an
expert's capacity C are dropped: the token gets nothing from that
expert.

Every shape follows from (B, S, cfg) alone: the scatter writes dropped
assignments into one spare row past the buffer, and the gather reads a
kept row and zeroes the dropped ones, so no step builds a size from
the data or waits for the card.  The expert products run on
`quant.lm_quant.q_einsum` for a W8A8 tree (the batched `w8a8_bmm`
kernel on the card) and on `torch.einsum` for a float one.

The reference takes its top k with `lax.top_k`, which puts the lower
expert first among equal probabilities; the port sorts with a stable
descending sort, which does the same (`torch.topk` promises no order
among equals).

Under a tensor-parallel mesh every expert weight holds this rank's share
of its last axis (F of w_gate and w_up, D of w_down) and the router's E:
the router's logits are gathered before the top k, the dispatch runs
whole on every rank of the model line, silu(g) * u stays split over F
and is gathered before w_down, whose output is gathered over D.  Groups
never cross a rank's rows: at train and prefill a group is a row, and
at decode, where one group spans the batch, a batch split over BATCH is
gathered first and the rank keeps its rows of the result, so the
capacity drops are the one-device ones.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist import api
from repro_torch.models import layers


class Routing(NamedTuple):
    gates: torch.Tensor      # [G, T, K] float32, renormalised over k
    eidx: torch.Tensor       # [G, T, K] int64, by falling probability
    slot: torch.Tensor       # [G, T*K] int64 e*C + pos, E*C if dropped
    keep: torch.Tensor       # [G, T*K] bool: pos < C
    aux: torch.Tensor        # () float32, the Switch load-balance loss


def init_moe(gen, cfg, device=None) -> dict:
    """Router float32 [d, E], experts [E, d, f] / [E, f, d] in
    layers.DEFAULT_DTYPE, at the reference's scales."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    return {
        "router": layers.normal(gen, (d, e), s_in, torch.float32, device),
        "w_gate": layers.normal(gen, (e, d, f), s_in, device=device),
        "w_up": layers.normal(gen, (e, d, f), s_in, device=device),
        "w_down": layers.normal(gen, (e, f, d), s_out, device=device),
    }


def capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.experts_per_tok * cfg.capacity_factor
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4, >= 4


def one_hot(idx, n: int):
    """`F.one_hot(idx, n)` (int64), as one comparison on every device:
    torch's reads the indices' range back to the host on the CPU and
    takes another op sequence on the card and on the meta device."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def route(params: dict, xg, cfg) -> Routing:
    """Router, aux loss and slots of the groups xg [G, T, D]: slot
    positions count an expert's assignments in t-major, then k, order."""
    G, T, _ = xg.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    C = capacity(T, cfg)
    logits = layers.col_matmul(xg.float(), params["router"], E)  # [G,T,E]
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = ranked[..., :K], order[..., :K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    me = probs.mean(1)                                           # [G, E]
    ce = one_hot(eidx[..., 0], E).float().mean(1)                # top-1
    aux = (me * ce).sum(-1).mean() * E

    e_flat = eidx.reshape(G, T * K)
    seen = torch.cumsum(one_hot(e_flat, E), dim=1)               # [G,TK,E]
    pos = torch.gather(seen, 2, e_flat[..., None])[..., 0] - 1
    keep = pos < C
    slot = torch.where(keep, e_flat * C + pos, E * C)
    return Routing(gates, eidx, slot, keep, aux)


def _expert_mm(spec: str, x, w, n: int | None = None):
    """One expert product; a W8A8 leaf {"qt","n"} goes to q_einsum.  A bf16
    product on the CPU runs in float32 and is cast once, as XLA rounds
    it (`layers._matmul`).  Under a tensor-parallel mesh, column-parallel:
    x whole, w this rank's columns, the output gathered to its n columns
    (n None: kept split)."""
    g = api.model_group()
    if g is None:
        return _expert_local(spec, x, w)
    y = _expert_local(spec, api.copy_to(x, g), w)
    return y if n is None else api.gather_along(y, n, g)


def _expert_local(spec: str, x, w):
    if isinstance(w, dict):
        from repro_torch.quant.lm_quant import q_einsum
        return q_einsum(spec, x, w, out_dtype=x.dtype)
    if x.dtype == torch.bfloat16 and layers.cpu_detour(x):
        return torch.einsum(spec, x.float(), w.float()).to(x.dtype)
    return torch.einsum(spec, x, w)


def moe_apply(params: dict, x, cfg, *, is_decode: bool = False):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar float32).  At decode
    with the rows split over BATCH (`api.rows_group`) the group is the
    whole batch: the rows are gathered, and this rank's kept."""
    rows = api.rows_group() if is_decode else None
    if rows is None:
        return _moe(params, x, cfg, is_decode)
    B = x.shape[0]
    whole = api.gather_cat(x, 0, [B] * rows.size, rows)
    with api.rows_split(False):
        y, aux = _moe(params, whole, cfg, is_decode)
    return y[rows.index * B:(rows.index + 1) * B], aux


def _moe(params: dict, x, cfg, is_decode: bool):
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    xg = x.reshape(1, B * S, D) if is_decode else x
    G, T, _ = xg.shape
    C = capacity(T, cfg)
    r = route(params, xg, cfg)

    # scatter into G*E*C rows, g-major; dropped assignments into the spare
    # row G*E*C, never read
    rows = G * E * C
    base = torch.arange(G, device=x.device)[:, None] * (E * C)
    dest = torch.where(r.keep, base + r.slot, rows).reshape(-1)
    buf = xg.new_zeros((rows + 1, D))
    buf.index_copy_(0, dest, xg.repeat_interleave(K, dim=1)
                    .reshape(G * T * K, D))
    h = buf[:rows].view(G, E, C, D)

    # experts: SwiGLU (g and u split over the model line, if any, until
    # silu(g) * u is gathered)
    g = _expert_mm("gecd,edf->gecf", h, params["w_gate"])
    u = _expert_mm("gecd,edf->gecf", h, params["w_up"])
    a = F.silu(g.float()).to(h.dtype) * u
    a = api.gather_along(a, cfg.d_ff, api.model_group())
    y = _expert_mm("gecf,efd->gecd", a, params["w_down"], D)

    # gather back (a dropped slot reads 0) and combine over k, in float32
    # and cast once
    src = torch.where(r.keep, base + r.slot, 0).reshape(-1)
    out_tok = torch.where(r.keep.reshape(-1, 1),
                          y.reshape(rows, D).index_select(0, src), 0)
    out = torch.einsum("gtkd,gtk->gtd", out_tok.view(G, T, K, D).float(),
                       r.gates.to(x.dtype).float()).to(x.dtype)
    return out.reshape(B, S, D), r.aux
