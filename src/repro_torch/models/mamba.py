"""Mamba (selective SSM, Mamba-1) mixer; the counterpart of
`repro.models.mamba`.

The projections and the depthwise causal conv run over the whole
sequence; the recurrence is a Python loop over time
(`scan_utils.chunked_scan`) on a float32 [B, ED, N] state.  The
per-step decay exp(dt * A) and input dt * u * B are elementwise, so
they are computed for every step at once before the loop, which then
issues three operations a step (the state's multiply and add, and the
readout).  Decode is one step of the same recurrence.  At prefill and
decode the new conv window and SSM state are written into the cache's
own buffers (`copy_`), so the cache layout never changes.

Under a tensor-parallel mesh every product is column-parallel and its
output is gathered whole (`layers.col_dense`): in_proj's (a contiguous
split of its 2*ED columns would give one rank all of u and the other
all of z), x_proj's, dt_proj's and out_proj's; conv_w, conv_b, dt_bias,
A_log and D are gathered where they are used (`layers.full`).  The
conv and the scan then run on all ED channels on every rank of the
line, and the state is whole (`transformer.block_apply` keeps the
cache's share).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, scan_utils
from repro_torch.models.layers import silu, softplus
from repro_torch.models.scan_utils import chunked_scan, pick_chunk


def init_mamba(gen, cfg, device=None) -> dict:
    """The reference's leaves: dt_bias, A_log and D float32, the rest in
    layers.DEFAULT_DTYPE."""
    d, ed = cfg.d_model, cfg.ssm_inner
    n, r, kc = cfg.ssm_state_dim, cfg.dt_rank, cfg.ssm_conv_dim
    dt = layers.DEFAULT_DTYPE
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.arange(1, n + 1, **f32)
    return {
        "in_proj": layers.normal(gen, (d, 2 * ed), d ** -0.5, dt, device),
        "conv_w": layers.normal(gen, (kc, ed), 0.2, dt, device),
        "conv_b": torch.zeros((ed,), dtype=dt, device=device),
        "x_proj": layers.normal(gen, (ed, r + 2 * n), ed ** -0.5, dt,
                                device),
        "dt_proj": layers.normal(gen, (r, ed), r ** -0.5, dt, device),
        "dt_bias": torch.zeros((ed,), **f32),
        "A_log": torch.log(a.repeat(ed, 1)),
        "D": torch.ones((ed,), **f32),
        "out_proj": layers.normal(gen, (ed, d), ed ** -0.5, dt, device),
    }


def _causal_conv(u, w, b, state=None):
    """u [B,S,ED]; w [K,ED] depthwise causal conv, its K taps summed in
    float32 in order, then the bias and SiLU, cast back to u's dtype.
    state [B,K-1,ED] holds the last K-1 inputs of the previous segment
    (or zeros).  Returns (y, the new state)."""
    K = w.shape[0]
    B, S, ED = u.shape
    if state is None:
        state = torch.zeros((B, K - 1, ED), dtype=u.dtype, device=u.device)
    up = torch.cat([state, u], dim=1)                  # [B, S+K-1, ED]
    wf = w.float()
    y = torch.zeros((B, S, ED), dtype=torch.float32, device=u.device)
    for j in range(K):
        y = y + up[:, j:j + S].float() * wf[j]
    y = y + b.float()
    return silu(y).to(u.dtype), up[:, -(K - 1):]


def _ssm_scan(u, dt, Bt, Ct, A, h0, chunk):
    """u, dt [B,S,ED]; Bt, Ct [B,S,N]; A [ED,N]; h0 [B,ED,N] float32.
    Returns (y [B,S,ED] float32, the last state)."""
    dA = torch.exp(dt[..., None] * A)                          # [B,S,ED,N]
    dBu = (dt * u.float())[..., None] * Bt.float()[:, :, None, :]
    cs = Ct.float().transpose(0, 1)[..., None].contiguous()   # [S,B,N,1]

    def body(h, xs):
        dA_t, dBu_t, c_t = xs
        h = dA_t * h + dBu_t
        return h, torch.bmm(h, c_t)[..., 0]

    hT, ys = chunked_scan(body, h0, (dA.transpose(0, 1),
                                     dBu.transpose(0, 1), cs), chunk=chunk)
    return ys.transpose(0, 1), hT


def mamba_apply(params, x, cfg, *, mode: str, cache=None):
    """x [B,S,D] -> (y [B,S,D], cache).  cache {"conv", "ssm"}: read as
    the initial state and, at prefill and decode, overwritten in place
    with the new one and returned (a new dict when none was given; None
    at train)."""
    B, S, D = x.shape
    ed, n, r = cfg.ssm_inner, cfg.ssm_state_dim, cfg.dt_rank

    xz = layers.col_dense(x, params["in_proj"], 2 * ed)
    u, z = torch.chunk(xz, 2, dim=-1)
    u, new_conv = _causal_conv(u, layers.full(params["conv_w"], ed),
                               layers.full(params["conv_b"], ed),
                               None if cache is None else cache["conv"])

    bcr = layers.col_dense(u, params["x_proj"], r + 2 * n)  # [B,S,r+2n]
    dt_r, Bt, Ct = torch.split(bcr, [r, n, n], dim=-1)
    dt = softplus(layers.col_dense(dt_r, params["dt_proj"], ed).float()
                  + layers.full(params["dt_bias"], ed))
    A = -torch.exp(layers.full(params["A_log"], n))       # [ED,N]
    h0 = cache["ssm"].float() if cache is not None else torch.zeros(
        (B, ed, n), dtype=torch.float32, device=x.device)

    chunk = 1 if mode == "decode" else pick_chunk(S, scan_utils.SCAN_CHUNK)
    ys, hT = _ssm_scan(u, dt, Bt, Ct, A, h0, chunk=chunk)
    ys = ys + layers.full(params["D"], ed) * u.float()
    out = (ys * silu(z.float())).to(x.dtype)
    out = layers.col_dense(out, params["out_proj"], D)
    if mode not in ("prefill", "decode"):
        return out, None
    if cache is None:
        return out, {"conv": new_conv, "ssm": hT}
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(hT)
    return out, cache


def init_mamba_cache(cfg, batch: int, dtype=layers.DEFAULT_DTYPE,
                     device=None) -> dict:
    ed, n, kc = cfg.ssm_inner, cfg.ssm_state_dim, cfg.ssm_conv_dim
    return {"conv": torch.zeros((batch, kc - 1, ed), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, ed, n), dtype=torch.float32,
                               device=device)}
