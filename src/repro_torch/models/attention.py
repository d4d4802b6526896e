"""Attention: chunked online-softmax (flash-style) prefill/train path,
cached decode path, GQA/MQA, sliding windows (ring-buffer cache), qk-norm,
prefix-LM masking, and the int8 KV cache.

The counterpart of `repro.models.attention`, in plain torch
(`torch.matmul`/`einsum`; no fused attention operator, so the CPU tests
hold the reference's arithmetic): the query is scaled before its bf16
cast, the softmax runs in float32 with NEG_INF = -1e30 masking, and the
probabilities are cast to v's dtype before the PV product; each product
the reference asks for in float32 of bf16 operands casts its operands to
float32.  The reference's scans over q and KV chunks are Python loops
(`op_analysis.trip_scan`, which a dry run weights by trip count).

Decode writes the new K/V into the cache IN PLACE (the counterpart of the
reference's donated `dynamic_update_slice`) and returns the same tensors;
a slot beyond the allocation raises (the reference's update would clamp
it).

Under a tensor-parallel mesh (`dist.api.model_group`) train and prefill
split the heads: wq, wk and wv hold this rank's columns, so each rank
holds whole heads when H and K divide by the model size, and RoPE,
qk-norm and `flash_attention` run on its heads; o is gathered before wo.
Where the heads do not divide, q, k and v are gathered before attention
and every rank attends all heads.  Prefill gathers k and v over the
heads to fill the cache.  Decode follows the reference's
`_decode_seq_axes` (head-sharding was refuted there): the cache holds
this rank's share of the slots (`api.seq_group`: the model line, or
("data", "model") when the batch does not shard), q, k and v are
gathered (one all_gather), the new token's k/v are written only by the
rank that owns its slot, each rank attends all heads over its slots,
and the ranks merge the softmax (`_merge`): an all-reduce of its max,
one of its sum, so that every probability is the one-device value
before its cast to v's dtype (a merge of unnormalized partials rounds
them otherwise, and a W8A8 model's next int8 codes follow), and one of
the partial outputs; the int8 cache's v exponents stay folded into the
probabilities.
"""
from __future__ import annotations

import torch

from repro_torch.dist import api
from repro_torch.dist.op_analysis import trip_scan
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.quant.int8_ops import einsum_i32
from repro_torch.quant.lm_quant import exponent, pow2

NEG_INF = -1e30
# flash attention's default chunks (the reference's)
Q_CHUNK = 512
KV_CHUNK = 1024


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init_attn(gen, cfg, device=None) -> dict:
    d = cfg.d_model
    h_eff = cfg.num_heads + cfg.head_pad
    qdim = h_eff * cfg.head_dim
    kdim = cfg.num_kv_heads * cfg.head_dim
    s = d ** -0.5
    dt = layers.DEFAULT_DTYPE
    p = {"wq": layers.normal(gen, (d, qdim), s, dt, device),
         "wk": layers.normal(gen, (d, kdim), s, dt, device),
         "wv": layers.normal(gen, (d, kdim), s, dt, device),
         "wo": layers.normal(gen, (qdim, d), qdim ** -0.5, dt, device)}
    if cfg.head_pad:  # zero the padded query heads (function-preserving)
        p["wq"][:, cfg.num_heads * cfg.head_dim:] = 0
        p["wo"][cfg.num_heads * cfg.head_dim:] = 0
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((qdim,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kdim,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kdim,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((cfg.head_dim,), dtype=torch.float32,
                                  device=device)
        p["k_norm"] = torch.zeros((cfg.head_dim,), dtype=torch.float32,
                                  device=device)
    return p


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (n assumed power-of-2-ish)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# chunked online-softmax attention (train / prefill)
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal=True, window=0, prefix_len=0,
                    q_chunk=None, kv_chunk=None):
    """q [B,Sq,H,Dh]; k,v [B,Sk,K,Dh].  Positions are array indices;
    the chunks default to Q_CHUNK and KV_CHUNK.

    Returns [B,Sq,H,Dh] in q.dtype, with fp32 softmax accumulation.
    """
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = Dh ** -0.5
    qc = _pick_chunk(Sq, q_chunk or Q_CHUNK)
    kv_chunk = kv_chunk or KV_CHUNK
    dev = q.device
    if window > 0:
        # static KV strip per q-chunk: [window + qc]
        strip = window + qc
        pad = max(strip - Sk, 0)
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))

        def q_block(i, _):
            q0 = i * qc
            start = min(max(q0 - window + pad, 0), Sk + pad - strip)
            # padded index i holds position i - pad
            kv_pos = start - pad + torch.arange(strip, device=dev)
            q_pos = q0 + torch.arange(qc, device=dev)
            return None, _attend_block(
                q[:, q0:q0 + qc], kp[:, start:start + strip],
                vp[:, start:start + strip], q_pos, kv_pos, causal, window,
                prefix_len, G, scale, kv_chunk)
    else:
        kv_pos = torch.arange(Sk, device=dev)

        def q_block(i, _):
            q0 = i * qc
            q_pos = q0 + torch.arange(qc, device=dev)
            return None, _attend_block(q[:, q0:q0 + qc], k, v, q_pos,
                                       kv_pos, causal, 0, prefix_len, G,
                                       scale, kv_chunk)
    _, out = trip_scan(q_block, Sq // qc)
    return torch.cat(out, dim=1)


def _attend_block(q_blk, k, v, q_pos, kv_pos, causal, window, prefix_len,
                  G, scale, kv_chunk):
    """One q-chunk against a KV strip, inner loop over KV chunks.

    q_blk [B,qc,H,Dh]; k,v [B,Skv,K,Dh]; q_pos [qc]; kv_pos [Skv].
    """
    B, qc, H, Dh = q_blk.shape
    Skv = k.shape[1]
    kc = _pick_chunk(Skv, kv_chunk)
    K = H // G
    qf = q_blk.float() * scale
    # the scaled query rounded to q's dtype, then the product in float32
    # (grouped-query einsum: the G-fold KV repeat is implicit)
    qg = qf.reshape(B, qc, K, G, Dh).to(q_blk.dtype).float()
    m = torch.full((B, K, G, qc), NEG_INF, dtype=torch.float32,
                   device=q_blk.device)
    l = torch.zeros((B, K, G, qc), dtype=torch.float32, device=q_blk.device)
    acc = torch.zeros((B, K, G, qc, Dh), dtype=torch.float32,
                      device=q_blk.device)

    def kv_block(i, carry):
        m, l, acc = carry
        c0 = i * kc
        k_blk, v_blk = k[:, c0:c0 + kc], v[:, c0:c0 + kc]
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_blk.float())
        mask = _mask(q_pos[:, None], kv_pos[None, c0:c0 + kc], causal,
                     window, prefix_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(v_blk.dtype).float(),
                          v_blk.float())
        return (m_new, l, acc * corr[..., None] + pv), None
    (m, l, acc), _ = trip_scan(kv_block, Skv // kc, (m, l, acc))
    out = acc / torch.clamp_min(l, 1e-30)[..., None]      # [B,K,G,qc,Dh]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, Dh)
    return out.to(q_blk.dtype)


def _mask(qp, kp, causal, window, prefix_len):
    ok = (kp <= qp) if causal else (kp >= 0)
    if window > 0:
        ok = ok & (kp > qp - window)
    if prefix_len > 0:
        ok = ok | ((kp < prefix_len) & (qp < prefix_len))
    return ok & (kp >= 0)


# ---------------------------------------------------------------------------
# int8 KV cache (the paper's Qm.n format on the cache)
# ---------------------------------------------------------------------------
def quantize_kv(x):
    """x [B,S,K,Dh] -> (int8 values, int8 exponents [B,S,K]).
    Per-(position, head) power-of-two scales: q = round(x * 2^e)."""
    xf = x.float()
    e = exponent(torch.amax(torch.abs(xf), dim=-1))
    q = torch.clamp(torch.round(xf * pow2(e)[..., None]), -128, 127)
    return q.to(torch.int8), e.to(torch.int8)


def _merge(s, pv, seq):
    """pv(softmax(s)), softmax over the last axis, of which the ranks of
    `seq` hold shares (the cache's slots): the max and the sum of exps
    are all-reduced over them, so every p is the one-device value before
    its cast, and the partial pv(p) are summed (three all-reduces).
    With no `seq`, pv(torch.softmax(s))."""
    if seq is None:
        return pv(torch.softmax(s, dim=-1))
    m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else torch.full(
        s.shape[:-1] + (1,), NEG_INF, dtype=s.dtype, device=s.device)
    e = torch.exp(s - api.reduce_max(m, seq))
    p = e / api.collective("sum", e.sum(-1, keepdim=True), seq.handle)
    return api.collective("sum", pv(p), seq.handle)


def _int8_cached_attention(q, cache, kv_pos, q_pos, seq=None):
    """Decode attention on the int8 cache.

    QK^T is an exact int8 x int8 -> int32 product descaled by the pow2
    exponents; the PV product folds the per-position v exponents into
    the probabilities, with v dequantized to bf16.  Under `seq` the
    cache holds this rank's slots (`_merge`).
    """
    B, Q, H, Dh = q.shape
    K = cache["k"].shape[2]
    G = H // K
    kq, ke = cache["k"], cache["k_e"]
    vq, ve = cache["v"], cache["v_e"]
    qq, qe = quantize_kv(q)                        # [B,Q,H,Dh], [B,Q,H]
    acc = einsum_i32("bqkgd,bskd->bkgqs", qq.reshape(B, Q, K, G, Dh), kq)
    scale = Dh ** -0.5
    qe_g = qe.reshape(B, Q, K, G).permute(0, 2, 3, 1).to(torch.int32)
    de = pow2(-(qe_g[..., None] + ke.permute(0, 2, 1)[:, :, None, None, :]
                .to(torch.int32)))
    s = acc.float() * de * scale
    ok = (kv_pos <= q_pos) & (kv_pos >= 0)
    s = torch.where(ok[None, None, None, None, :], s, NEG_INF)
    vexp = pow2(-ve.permute(0, 2, 1)[:, :, None, None, :].to(torch.int32))
    o = _merge(s, lambda p: torch.einsum(
        "bkgqs,bskd->bkgqd", (p * vexp).to(torch.bfloat16).float(),
        vq.to(torch.bfloat16).float()), seq)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Q, H, Dh).to(torch.bfloat16)


def cached_attention(q, k_cache, v_cache, kv_pos, q_pos, groups, seq=None):
    """q [B,1,H,Dh]; caches [B,S,K,Dh]; kv_pos [S] (position per slot, may
    be invalid/negative); q_pos scalar.  fp32 softmax over the whole
    cache, as a grouped-query einsum that never repeats the cache.
    Under `seq` the caches hold this rank's slots, merged over its ranks
    (`_merge`)."""
    B, Q, H, Dh = q.shape
    K = k_cache.shape[2]
    G = H // K
    # q * Dh^-0.5 in q's dtype: the reference's weak-typed scalar takes
    # q's dtype (bf16) before the product, so the scale is rounded to it
    # on the host (a device tensor made from a Python number would wait
    # for the card)
    scale = float(torch.tensor(Dh ** -0.5).to(q.dtype))
    qg = (q * scale).reshape(B, Q, K, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float())
    ok = (kv_pos <= q_pos) & (kv_pos >= 0)
    s = torch.where(ok[None, None, None, None, :], s, NEG_INF)
    if seq is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                         v_cache.float())
        return o.reshape(B, Q, H, Dh).to(q.dtype)
    o = _merge(s, lambda p: torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(v_cache.dtype).float(), v_cache.float()),
        seq)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Q, H, Dh).to(q.dtype)


def ring_positions(q_pos, alloc: int, device=None):
    """Position stored in each ring slot i after writes up to q_pos:
    largest p <= q_pos with p % alloc == i (negative -> never written)."""
    i = torch.arange(alloc, device=device)
    return q_pos - torch.remainder(q_pos - i, alloc)


# ---------------------------------------------------------------------------
# full attention mixer (projections + rope + dispatch by mode)
# ---------------------------------------------------------------------------
def heads_split(cfg, mode: str, group) -> bool:
    """Whether attention runs on this rank's heads: in train and prefill
    on a model line (`group`) whose size divides the query and KV
    heads."""
    if group is None or mode == "decode":
        return False
    return (cfg.num_heads + cfg.head_pad) % group.size == 0 and \
        cfg.num_kv_heads % group.size == 0


def attn_apply(cfg, params, x, *, mode: str, cache=None, pos=None,
               prefix_len: int = 0, window: int = 0,
               kv_override=None, is_cross: bool = False, slots=None):
    """x [B,S,D].  mode: train | prefill | decode; pos an int (decode).
    cache: {"k","v"} (+ "k_e","v_e" int8) [B,S_alloc,K,Dh], filled in
    place at prefill and written in place at decode; under a mesh that
    splits the slots (`api.seq_group`) this rank's share of the
    `slots` (the whole allocation's count) of them.
    kv_override: encoder hidden states [B,Skv,D] for cross-attention at
    train/prefill (decode cross reads the cache only, is_cross=True).
    Returns (out [B,S,D], cache or None).
    """
    is_cross = is_cross or (kv_override is not None)
    B, S, D = x.shape
    H = cfg.num_heads + cfg.head_pad
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    G = H // K
    g = api.model_group()
    split = heads_split(cfg, mode, g)
    t = 1 if g is None else g.size
    Hl, Kl = (H // t, K // t) if split else (H, K)

    def proj(inp, name):
        return layers.dense(inp, params[name], params.get("b" + name[1]))

    xc = api.copy_to(x, g)
    q = proj(xc, "wq")
    if kv_override is not None:
        kv = api.copy_to(kv_override, g)
        k, v = proj(kv, "wk"), proj(kv, "wv")
    elif is_cross and mode == "decode":
        k = v = None  # encoder K/V already live in the cache
    else:
        k, v = proj(xc, "wk"), proj(xc, "wv")
    if not split:               # every head on every rank: one gather
        q, *kv = api.gather_leaves([t for t in (q, k, v) if t is not None],
                                   (H * Dh, K * Dh, K * Dh), g)
        if kv:
            k, v = kv
    q = q.reshape(B, S, Hl, Dh)
    if k is not None:
        k = k.reshape(B, k.shape[1], Kl, Dh)
        v = v.reshape(B, v.shape[1], Kl, Dh)

    if cfg.qk_norm:
        q = rms_norm(q, layers.full(params["q_norm"], Dh, split),
                     cfg.norm_eps)
        if k is not None:
            k = rms_norm(k, layers.full(params["k_norm"], Dh, split),
                         cfg.norm_eps)

    use_rope = cfg.rope_theta > 0 and not is_cross
    if mode in ("train", "prefill"):
        if use_rope:
            positions = torch.arange(S, device=x.device)[None, :]
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, causal=kv_override is None,
                            window=window, prefix_len=prefix_len)
        new_cache = None
        if mode == "prefill" and cache is not None:
            if split:           # the cache holds every head
                kk, vv = api.gather_leaves(
                    (k.reshape(B, -1, Kl * Dh), v.reshape(B, -1, Kl * Dh)),
                    (K * Dh,) * 2, g)
                k_all, v_all = (a.reshape(B, -1, K, Dh) for a in (kk, vv))
            else:
                k_all, v_all = k, v
            new_cache = _fill_cache(cache, k_all, v_all, window, slots)
        o = o.reshape(B, S, Hl * Dh)
        if split:
            o = api.gather_along(o, H * Dh, g)
        out = layers.col_dense(o, params["wo"], D)
        return out, new_cache

    # ---- decode: S == 1 -------------------------------------------------
    if mode != "decode":
        raise ValueError(f"unknown attention mode {mode!r}")
    if use_rope:
        positions = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    seq = api.seq_group()
    alloc = cache["k"].shape[1] if seq is None else slots
    lo, hi = api.share(alloc, seq)
    if is_cross:
        # cross-attention at decode reads the (static) encoder cache
        kv_pos_arr = torch.arange(lo, hi, device=x.device)
        o = cached_attention(q, cache["k"], cache["v"], kv_pos_arr, 2 ** 30,
                             G, seq)
        out = layers.col_dense(o.reshape(B, 1, H * Dh), params["wo"], D)
        return out, cache
    if window > 0 and alloc <= window:
        slot = pos % alloc
        kv_pos_arr = ring_positions(pos, alloc, x.device)
    else:
        slot = pos
        kv_pos_arr = torch.arange(alloc, device=x.device)
        if window > 0:  # full cache but windowed layer: mask stale slots
            kv_pos_arr = torch.where(kv_pos_arr > pos - window, kv_pos_arr,
                                     -1)
    if not 0 <= slot < alloc:
        raise ValueError(f"decode at position {pos}: slot {slot} is "
                         f"outside the cache's {alloc} slots")
    kv_pos_arr = kv_pos_arr[lo:hi]
    if lo <= slot < hi:         # the rank that owns the slot writes it
        if cfg.kv_cache_int8:
            parts = dict(zip(("k", "k_e"), quantize_kv(k)))
            parts.update(zip(("v", "v_e"), quantize_kv(v)))
        else:
            parts = {"k": k, "v": v}
        for name, val in parts.items():
            cache[name][:, slot - lo] = val[:, 0]
    if cfg.kv_cache_int8:
        o = _int8_cached_attention(q, cache, kv_pos_arr, pos, seq)
    else:
        o = cached_attention(q, cache["k"], cache["v"], kv_pos_arr, pos, G,
                             seq)
    out = layers.col_dense(o.reshape(B, 1, H * Dh), params["wo"], D)
    return out, cache


def _fill_cache(cache, k, v, window: int, slots=None):
    """Write prefill K/V into an allocated cache, in place (ring layout
    for SWA; int8 caches quantize on write); under `api.seq_group` the
    cache holds this rank's share of the `slots`, and only those are
    written.  Returns the cache."""
    seq = api.seq_group()
    alloc = cache["k"].shape[1] if seq is None else slots
    lo, hi = api.share(alloc, seq)
    S = k.shape[1]
    if "k_e" in cache:
        parts = dict(zip(("k", "k_e"), quantize_kv(k)))
        parts.update(zip(("v", "v_e"), quantize_kv(v)))
    else:
        parts = {"k": k, "v": v}
    for name, val in parts.items():
        if window > 0 and alloc <= window:
            take = min(S, alloc)
            last = val[:, S - take:]
            # ring invariant: position p lives in slot p % alloc
            shift = (S - take) % alloc if take < alloc else S % alloc
            val = torch.roll(last, shift, dims=1)
        if val.shape[1] > alloc:
            raise ValueError(f"prefill of {S} positions into a cache of "
                             f"{alloc} slots")
        # slots [0, len(val)) of the whole cache; this rank's [lo, hi)
        end = min(hi, val.shape[1])
        if end > lo:
            cache[name][:, :end - lo] = val[:, lo:end]
    return cache


def init_attn_cache(cfg, batch: int, alloc: int, dtype=torch.bfloat16,
                    device=None) -> dict:
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    if getattr(cfg, "kv_cache_int8", False):
        z = dict(dtype=torch.int8, device=device)
        return {"k": torch.zeros((batch, alloc, K, Dh), **z),
                "k_e": torch.zeros((batch, alloc, K), **z),
                "v": torch.zeros((batch, alloc, K, Dh), **z),
                "v_e": torch.zeros((batch, alloc, K), **z)}
    return {"k": torch.zeros((batch, alloc, K, Dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, alloc, K, Dh), dtype=dtype,
                             device=device)}
