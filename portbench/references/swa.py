"""Causal grouped-query attention with rotary positions and a sliding
window (`cfg["window_size"]`; 0: none), as Mixtral computes it
(arXiv:2401.04088; Mistral 7B's arXiv:2310.06825 for the window): q, k,
v and o are W8A8 products; RoPE rotates split halves with angles pos *
theta^(-i / half) in float32; the softmax runs in float32 over keys s <=
t with t - s < window; query head h reads kv head h // (H / K)."""
from __future__ import annotations

import torch


def leaves(cfg: dict) -> dict:
    D, Dh = cfg["d_model"], cfg["head_dim"]
    q, kv = cfg["num_heads"] * Dh, cfg["num_kv_heads"] * Dh
    bf = torch.bfloat16
    return {"attn/wq": ((D, q), bf), "attn/wk": ((D, kv), bf),
            "attn/wv": ((D, kv), bf), "attn/wo": ((q, D), bf)}


def rope(x, theta: float):
    """x [T, N, Dh] float32, positions 0..T-1."""
    T, _, Dh = x.shape
    half = Dh // 2
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                          torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(T, dtype=torch.float32)[:, None] * inv
    sin, cos = ang.sin().to(x.device)[:, None], ang.cos().to(x.device)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, window: int):
    """q [T, H, Dh], k, v [T, K, Dh] -> [T, H * Dh], float32."""
    T, H, Dh = q.shape
    K = k.shape[1]
    qg = q.view(T, K, H // K, Dh).permute(1, 2, 0, 3)       # [K, G, T, Dh]
    s = qg @ k.permute(1, 2, 0)[:, None] * Dh ** -0.5        # [K, G, T, T]
    t = torch.arange(T, device=q.device)
    ok = t[None, :] <= t[:, None]
    if window > 0:
        ok &= t[:, None] - t[None, :] < window
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    o = p @ v.permute(1, 0, 2)[:, None]                      # [K, G, T, Dh]
    return o.permute(2, 0, 1, 3).reshape(T, H * Dh)


def apply(ctx, p, h):
    cfg = ctx.cfg
    B, T, D = h.shape
    H, K, Dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    rg = ctx.groups.repeat(B)
    xq, er = ctx.quantize(h.reshape(B * T, D), rg)
    q = ctx.product(xq, er, *p["attn/wq"]).view(B, T, H, Dh)
    k = ctx.product(xq, er, *p["attn/wk"]).view(B, T, K, Dh)
    v = ctx.product(xq, er, *p["attn/wv"]).view(B, T, K, Dh)
    del xq
    o = torch.empty((B, T, H * Dh), dtype=torch.float32, device=h.device)
    for b in range(B):
        o[b] = attend(rope(q[b], cfg["rope_theta"]),
                      rope(k[b], cfg["rope_theta"]), v[b],
                      cfg.get("window_size", 0))
    del q, k, v
    return ctx.dense(o.view(B * T, -1), rg, p["attn/wo"]).view(B, T, D)
