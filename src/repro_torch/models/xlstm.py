"""xLSTM mixers: mLSTM (matrix memory, exp-gated linear attention) and
sLSTM (scalar memory with block-diagonal recurrent gates); the
counterpart of `repro.models.xlstm`.

The mLSTM follows the paper's stabilized exponential gating (a running
max m) and carries its own up/down projections (projection factor 2);
`mlstm_apply` takes the reference's path exactly: one recurrent step at
decode, the chunkwise closed form when `xlstm_impl == "chunked"` and the
chunk divides S > 1, else the recurrence as a Python loop over time.
Its state C, n, m stays float32, the activations bf16.  A recurrent
step on a cache updates C in place (`mul_`, then `addcmul_` of the
rank-1 term), so a decode step makes four passes over C to update it
and one to read it out; with no cache (training) it builds a new C, so
autograd keeps each step's C for the backward pass.  The closed
form's C update sum_s w_s v_s k_s^T is one batched product,
(w v)^T k.  sLSTM blocks append the paper's pf = 4/3 gated FFN
(tanh-approximate GELU, as `jax.nn.gelu` defaults to).  At prefill and
decode the new state is written into the cache's own buffers.

Under a tensor-parallel mesh every product is column-parallel and its
output is gathered whole (`layers.col_dense`; `col_matmul` for the
float32 gates): up_proj's (its 2*ed columns split contiguously would
pair no inner channel with its gate), wq's, wk's, wv's, wi's, wf's and
down_proj's; the sLSTM's wx, ffn_up
and ffn_down the same; bi, bf, bx and the sLSTM's recurrent r are
gathered where they are used (`layers.full`).  The recurrences run on
every head on every rank of the line, and the states are whole
(`transformer.block_apply` keeps the cache's share).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.dist.op_analysis import trip_scan
from repro_torch.models import layers, scan_utils
from repro_torch.models.layers import silu, softplus
from repro_torch.models.scan_utils import chunked_scan, pick_chunk


def log_sigmoid(x):
    """-softplus(-x), as `jax.nn.log_sigmoid` computes it."""
    return -softplus(-x)


def _write_state(cache, state: dict) -> dict:
    """Copy each new state tensor into the cache's buffer of that name
    (skipping one updated in place) and return the cache; with no cache,
    the state itself."""
    if cache is None:
        return state
    for name, t in state.items():
        if t is not cache[name]:
            cache[name].copy_(t)
    return cache


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg, device=None) -> dict:
    d, ed, h = cfg.d_model, cfg.xlstm_inner, cfg.num_heads
    dt, f32 = layers.DEFAULT_DTYPE, torch.float32
    s, si = d ** -0.5, ed ** -0.5
    return {
        "up_proj": layers.normal(gen, (d, 2 * ed), s, dt, device),
        "wq": layers.normal(gen, (ed, ed), si, dt, device),
        "wk": layers.normal(gen, (ed, ed), si, dt, device),
        "wv": layers.normal(gen, (ed, ed), si, dt, device),
        "wi": layers.normal(gen, (ed, h), si, f32, device),
        "bi": torch.zeros((h,), dtype=f32, device=device),
        "wf": layers.normal(gen, (ed, h), si, f32, device),
        "bf": torch.full((h,), 3.0, dtype=f32, device=device),
        "down_proj": layers.normal(gen, (ed, d), si, dt, device),
    }


def _mlstm_chunked(q, k, v, ig, logf, C0, n0, m0, chunk: int):
    """Chunkwise-parallel mLSTM (closed form within chunks), equal to the
    per-step recurrence up to float32 rounding: within a chunk, with
    F_t = cumsum(logf) and m_t = F_t + max(m0, cummax(i_t - F_t)),
        h_t = [exp(F_t + m0 - m_t) C0 q_t + sum_{s<=t} D_ts (k_s.q_t) v_s]
              / max(|n_t . q_t|, exp(-m_t)),
        D_ts = exp(F_t - F_s + i_s - m_t).

    q, k, v [B,S,H,dh] float32; ig, logf [B,S,H]; carry C0 [B,H,dv,dk],
    n0 [B,H,dk], m0 [B,H].  Returns (h [B,S,H,dv], (C, n, m))."""
    B, S, H, dh = q.shape
    nc = S // chunk

    def r(a):                                            # [nc,B,H,c,dh]
        return a.reshape(B, nc, chunk, H, -1).permute(1, 0, 3, 2, 4)

    def rg(a):                                           # [nc,B,H,c]
        return a.reshape(B, nc, chunk, H).permute(1, 0, 3, 2)

    rq, rk, rv, ri, rf = r(q), r(k), r(v), rg(ig), rg(logf)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))

    def chunk_step(j, carry):
        C0, n0, m0 = carry
        qt, kt, vt, it, ft = rq[j], rk[j], rv[j], ri[j], rf[j]
        Fc_ = torch.cumsum(ft, -1)
        b = torch.cummax(it - Fc_, dim=-1).values
        m = Fc_ + torch.maximum(m0[..., None], b)         # [B,H,c]
        di = torch.exp(Fc_ + m0[..., None] - m)
        logD = (Fc_[..., :, None] - Fc_[..., None, :]
                + it[..., None, :] - m[..., :, None])
        D = torch.where(tri, torch.exp(logD), 0.0)
        G = qt @ kt.transpose(-1, -2)                     # bhts
        inter = (qt @ C0.transpose(-1, -2)) * di[..., None]
        num = inter + (G * D) @ vt
        nvec = n0[..., None, :] * di[..., None] + D @ kt
        den = torch.maximum(torch.abs((nvec * qt).sum(-1)), torch.exp(-m))
        h = num / den[..., None]                          # [B,H,c,dv]
        mc, Fc = m[..., -1], Fc_[..., -1]
        w = torch.exp(Fc[..., None] - Fc_ + it - mc[..., None])
        decay = torch.exp(Fc + m0 - mc)
        C0 = decay[..., None, None] * C0 \
            + (w[..., None] * vt).transpose(-1, -2) @ kt
        n0 = decay[..., None] * n0 + (w[..., None] * kt).sum(-2)
        return (C0, n0, mc), h
    (C0, n0, m0), hs = trip_scan(chunk_step, nc, (C0, n0, m0))
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S, H, -1)
    return h, (C0, n0, m0)


def _mlstm_step(carry, xs, inplace: bool):
    """One recurrent step; with `inplace` C and n are updated in place
    (the carry's own tensors), else made anew; m is new.  q, k, v
    [B,H,dh]; i, f [B,H]."""
    C, n, m = carry
    q_t, k_t, v_t, i_t, f_t = xs
    logf = log_sigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(i_t - m_new)
    vi = (ip[..., None] * v_t)[..., :, None]
    if inplace:
        C.mul_(fp[..., None, None]).addcmul_(vi, k_t[..., None, :])
        n.mul_(fp[..., None]).add_(ip[..., None] * k_t)
    else:
        C = torch.addcmul(C * fp[..., None, None], vi, k_t[..., None, :])
        n = n * fp[..., None] + ip[..., None] * k_t
    num = (C @ q_t[..., None])[..., 0]
    den = torch.maximum(torch.abs((n * q_t).sum(-1)), torch.exp(-m_new))
    return (C, n, m_new), num / den[..., None]


def _bf16_scalar(value: float, dtype) -> float:
    """A Python scalar rounded to `dtype`, as the reference's weak-typed
    scalar is before it multiplies a bf16 array."""
    return float(torch.tensor(value).to(dtype))


def mlstm_apply(params, x, cfg, *, mode: str, cache=None):
    """x [B,S,D] -> (y, cache {C, n, m}: read as the initial state,
    overwritten with the new one at prefill and decode; None at
    train)."""
    B, S, D = x.shape
    ed, H = cfg.xlstm_inner, cfg.num_heads
    dh = ed // H

    up = layers.col_dense(x, params["up_proj"], 2 * ed)
    inner, z = torch.chunk(up, 2, dim=-1)
    scale = _bf16_scalar(dh ** -0.5, x.dtype)
    q = layers.col_dense(inner, params["wq"], ed).reshape(B, S, H, dh) \
        * scale
    k = layers.col_dense(inner, params["wk"], ed).reshape(B, S, H, dh) \
        * scale
    v = layers.col_dense(inner, params["wv"], ed).reshape(B, S, H, dh)
    inner32 = inner.float()
    ig = layers.col_matmul(inner32, params["wi"], H) \
        + layers.full(params["bi"], H)                        # [B,S,H]
    fg = layers.col_matmul(inner32, params["wf"], H) \
        + layers.full(params["bf"], H)

    if cache is not None:
        C0, n0, m0 = cache["C"].float(), cache["n"].float(), cache["m"]
    else:
        z32 = dict(dtype=torch.float32, device=x.device)
        C0 = torch.zeros((B, H, dh, dh), **z32)
        n0 = torch.zeros((B, H, dh), **z32)
        m0 = torch.full((B, H), -1e30, **z32)

    q, k, v = q.float(), k.float(), v.float()
    chunk = pick_chunk(S, cfg.xlstm_chunk)
    step = functools.partial(_mlstm_step, inplace=cache is not None)
    if mode == "decode":
        (C, n, m), h = step((C0, n0, m0), (
            q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]))
        hs = h[:, None]                                  # [B,1,H,dh]
    elif cfg.xlstm_impl == "chunked" and S % chunk == 0 and S > 1:
        hs, (C, n, m) = _mlstm_chunked(q, k, v, ig, log_sigmoid(fg), C0,
                                       n0, m0, chunk)
    else:          # with a cache, C and n updated in place (its own)
        (C, n, m), hs = chunked_scan(
            step, (C0, n0, m0),
            tuple(a.transpose(0, 1) for a in (q, k, v, ig, fg)), chunk=chunk)
        hs = hs.transpose(0, 1)                          # [B,S,H,dh]

    out = hs.reshape(B, S, ed).to(x.dtype)
    out = out * silu(z.float()).to(x.dtype)
    out = layers.col_dense(out, params["down_proj"], D)
    if mode not in ("prefill", "decode"):
        return out, None
    return out, _write_state(cache, {"C": C, "n": n, "m": m})


def init_mlstm_cache(cfg, batch: int, device=None) -> dict:
    ed, H = cfg.xlstm_inner, cfg.num_heads
    dh = ed // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(gen, cfg, device=None) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    # pf = 4/3, rounded up to a multiple of 128 (2731 -> 2816 at d 2048),
    # the reference's rounding
    ff = -(-(-(-4 * d // 3)) // 128) * 128
    dt = layers.DEFAULT_DTYPE
    s = d ** -0.5
    return {
        "wx": layers.normal(gen, (d, 4 * d), s, dt, device),
        "bx": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "r": layers.normal(gen, (H, dh, 4 * dh), dh ** -0.5, dt, device),
        "ffn_up": layers.normal(gen, (d, 2 * ff), s, dt, device),
        "ffn_down": layers.normal(gen, (ff, d), ff ** -0.5, dt, device),
    }


def slstm_apply(params, x, cfg, *, mode: str, cache=None):
    """x [B,S,D] -> (y, cache {c, n, m, h}: read as the initial state,
    overwritten with the new one at prefill and decode; None at
    train)."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H

    gx = layers.col_dense(x, params["wx"], 4 * D).float() \
        + layers.full(params["bx"], 4 * D)                    # [B,S,4D]
    if cache is not None:
        c0, n0, m0, h0 = (cache["c"], cache["n"], cache["m"], cache["h"])
    else:
        z = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        c0, n0, m0, h0 = z, z + 1e-6, z - 1e30, z
    r = layers.full(params["r"], 4 * dh).float()            # [H,dh,4dh]

    def body(carry, gx_t):
        c, n, m, h = carry
        rec = torch.bmm(h.reshape(B, H, dh).transpose(0, 1), r)
        # layout: per head, [i f z o] each dh wide (gx re-interleaved below)
        g = (gx_t + rec.transpose(0, 1).reshape(B, H * 4 * dh)).reshape(
            B, H, 4, dh)
        gi, gf, gz, go = g.unbind(2)
        mh = m.reshape(B, H, dh)
        m_new = torch.maximum(gf + mh, gi)
        fp = torch.exp(gf + mh - m_new)
        ip = torch.exp(gi - m_new)
        ch = fp * c.reshape(B, H, dh) + ip * torch.tanh(gz)
        nh = fp * n.reshape(B, H, dh) + ip
        hh = torch.sigmoid(go) * ch / torch.clamp_min(nh, 1e-6)
        flat = [a.reshape(B, D) for a in (ch, nh, m_new, hh)]
        return tuple(flat), flat[3]

    # wx gives [i f z o] blocks of D each: re-interleave to per-head
    # [i f z o] once, outside the loop
    gx = gx.reshape(B, S, 4, H, dh).permute(0, 1, 3, 2, 4).reshape(
        B, S, 4 * D)
    if mode == "decode":
        (c, n, m, h), y = body((c0, n0, m0, h0), gx[:, 0])
        ys = y[:, None]
    else:
        (c, n, m, h), ys = chunked_scan(
            body, (c0, n0, m0, h0), gx.transpose(0, 1),
            chunk=pick_chunk(S, scan_utils.SCAN_CHUNK))
        ys = ys.transpose(0, 1)

    out = ys.to(x.dtype)
    # the pf = 4/3 gated FFN
    ff = params["ffn_down"]
    ff = (ff["qt"].shape[-1] if isinstance(ff, dict) else ff.shape[0])
    u1, u2 = torch.chunk(layers.col_dense(out, params["ffn_up"], 2 * ff), 2,
                         dim=-1)
    out = layers.col_dense(
        F.gelu(u1.float(), approximate="tanh").to(x.dtype) * u2,
        params["ffn_down"], D)
    if mode not in ("prefill", "decode"):
        return out, None
    return out, _write_state(cache, {"c": c, "n": n, "m": m, "h": h})


def init_slstm_cache(cfg, batch: int, device=None) -> dict:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                    device=device)
    return {"c": z, "n": z + 1e-6, "m": z - 1e30, "h": z.clone()}
