"""Model assembly: block stacks of attention / SWA / mamba / mLSTM /
sLSTM mixers with gated-MLP, MoE or no FFN, over pattern cycles; the
counterpart of `repro.models.transformer` (`LM`, `EncDecLM`).

Parameters for each pattern position are stacked over the cycles on a
leading axis, as in the reference; `run_stack` is a Python loop over
the cycles (`op_analysis.trip_scan`, weighted by trip count in a dry
run) that hands each block per-cycle views of them.  Three entry
points per model: `train_loss`, `prefill`, `decode_step`; the VLM
(paligemma, prefix-LM) and the encoder-decoder (seamless, a frame
encoder and a token decoder with cross-attention) wrap the same
machinery.  `LM` caches are per layer, a tuple over cycles of a tuple
over pattern positions of the mixer's state: {"k", "v"} for attention,
{"conv", "ssm"} for mamba, {"C", "n", "m"} for mLSTM and {"c", "n",
"m", "h"} for sLSTM (the reference's `decode_unroll` layout, its only
one for these configs).  `EncDecLM` keeps the reference's scanned
layout, a 1-tuple of {"self", "cross"} KV caches stacked over the
decoder's cycles.  Every mixer fills its cache at prefill and writes it
in place at decode, so the layout `init_cache` made never changes.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.op_analysis import trip_scan
from repro_torch.models import attention, layers, mamba, moe, xlstm
from repro_torch.models.layers import init_norm, rms_norm
from repro_torch.models.scan_utils import checkpoint
from repro_torch.tree import leaves, unflatten

MIXERS = ("attn", "swa", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")
LOSS_CHUNK = 512          # lm_loss's sequence chunk (the reference's)


def check_ported(cfg) -> None:
    """Raise ValueError for a block kind the port does not know."""
    for mixer, ffn in cfg.blocks:
        if mixer not in MIXERS:
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}")
        if ffn not in FFNS:
            raise ValueError(f"{cfg.name}: unknown ffn {ffn!r}")


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def decode_alloc(seq_len: int) -> int:
    """KV allocation for decode: seq_len filled + headroom, divisible by
    512 (the reference's rule, kept so that both allocate alike)."""
    return round_up(seq_len + 1, 512)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def _map_pair(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _map_pair(fn, a[k], b[k])
    else:
        fn(a, b)


def _cycle(tree, ci: int):
    """Per-cycle views of a stacked [C, ...] tree."""
    return _map(lambda a: a[ci], tree)


def _cycles(tree) -> list:
    """Per cycle, the views of a stacked [C, ...] tree (`unbind`, so the
    gradients of the C views are stacked once in the backward)."""
    parts = [a.unbind(0) for a in leaves(tree)]
    return [unflatten(tree, [p[ci] for p in parts])
            for ci in range(len(parts[0]))]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def init_block(gen, cfg, kind, device=None) -> dict:
    """A block's params: its mixer's own leaves and its FFN's."""
    mixer, ffn = kind
    p = {"norm1": init_norm(cfg.d_model, device)}
    if mixer in ("attn", "swa"):
        p["attn"] = attention.init_attn(gen, cfg, device)
    elif mixer == "mamba":
        p["mamba"] = mamba.init_mamba(gen, cfg, device)
    elif mixer == "mlstm":
        p["mlstm"] = xlstm.init_mlstm(gen, cfg, device)
    elif mixer == "slstm":
        p["slstm"] = xlstm.init_slstm(gen, cfg, device)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "mlp":
        p["norm2"] = init_norm(cfg.d_model, device)
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                   device=device)
    elif ffn == "moe":
        p["norm2"] = init_norm(cfg.d_model, device)
        p["moe"] = moe.init_moe(gen, cfg, device)
    elif ffn != "none":
        raise ValueError(f"unknown ffn {ffn!r}")
    return p


def block_apply(cfg, kind, p, x, *, mode, cache, pos, prefix_len):
    """x [B,S,D] -> (x, cache, aux)."""
    mixer, ffn = kind
    h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        window = cfg.window_size if mixer == "swa" else 0
        h, new_cache = attention.attn_apply(
            cfg, p["attn"], h, mode=mode, cache=cache, pos=pos,
            prefix_len=prefix_len, window=window)
    elif mixer == "mamba":
        h, new_cache = mamba.mamba_apply(p["mamba"], h, cfg, mode=mode,
                                         cache=cache)
    elif mixer == "mlstm":
        h, new_cache = xlstm.mlstm_apply(p["mlstm"], h, cfg, mode=mode,
                                         cache=cache)
    elif mixer == "slstm":
        h, new_cache = xlstm.slstm_apply(p["slstm"], h, cfg, mode=mode,
                                         cache=cache)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "mlp":
        x = x + layers.mlp(p["mlp"], rms_norm(x, p["norm2"]["scale"],
                                              cfg.norm_eps))
    elif ffn == "moe":
        h2, aux = moe.moe_apply(p["moe"],
                                rms_norm(x, p["norm2"]["scale"], cfg.norm_eps),
                                cfg, is_decode=(mode == "decode"))
        x = x + h2
    return x, new_cache, aux


def _run_cycle(cfg, blocks, params, x, aux, mode, caches, pos,
               prefix_len):
    """One pattern cycle: each block in turn, its aux summed."""
    for i, kind in enumerate(blocks):
        x, _, a = block_apply(cfg, kind, params[i], x, mode=mode,
                              cache=None if caches is None else caches[i],
                              pos=pos, prefix_len=prefix_len)
        aux = aux + a
    return x, aux


def run_stack(cfg, blocks, stack_params, x, *, mode, caches=None,
              pos=None, prefix_len=0):
    """Loop the pattern cycle over depth (the stacked params' leading
    axis).

    stack_params: tuple (per pattern position) of param trees with a
    leading cycle axis.  caches: tuple over cycles of tuples (per
    pattern position) of cache dicts, or None; each block writes its own
    in place.  In mode "train" each cycle is rematerialized in the
    backward (`scan_utils.checkpoint`), as the reference's scan body is.
    Returns (x, caches, aux_sum).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_cycle = _cycles(stack_params)

    def cycle(ci, carry):
        args = (cfg, blocks, per_cycle[ci], *carry, mode,
                None if caches is None else caches[ci], pos, prefix_len)
        return (checkpoint(_run_cycle, *args) if mode == "train"
                else _run_cycle(*args)), None
    (x, aux), _ = trip_scan(cycle, len(per_cycle), (x, aux))
    return x, caches, aux


def _stacked(cycles: int, make):
    """A param tree stacked over `cycles` on a leading axis, filled one
    cycle at a time from `make()`."""
    stacked = None
    for ci in range(cycles):
        one = make()
        if stacked is None:
            stacked = _map(lambda a: a.new_empty((cycles,) + a.shape), one)
        _map_pair(lambda dst, src: dst[ci].copy_(src), stacked, one)
    return stacked


def _init_stack(gen, cfg, blocks, cycles, device):
    """Per pattern position, its blocks' params stacked over `cycles`."""
    return tuple(_stacked(cycles, lambda k=kind: init_block(gen, cfg, k,
                                                            device))
                 for kind in blocks)


# ---------------------------------------------------------------------------
# chunked LM loss (bounded memory at 256k vocab)
# ---------------------------------------------------------------------------
def _xent_chunk(xc, head_w, tc, mc):
    """(sum of the masked nll, sum of the mask) over one chunk."""
    B, c, D = xc.shape
    xc = xc.float()
    logits = torch.einsum("bcd,dv->bcv", xc, head_w.float())
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    lab = torch.index_select(head_w.transpose(0, 1), 0, tc.reshape(-1))
    lab_logit = torch.einsum("bcd,bcd->bc", xc, lab.reshape(B, c, D).float())
    return torch.sum((lse - lab_logit) * mc), torch.sum(mc)


def lm_loss(x, head_w, targets, mask=None, seq_chunk: int | None = None):
    """x [B,S,D], head_w [D,V], targets [B,S] -> mean xent (fp32).  Each
    chunk of the sequence (LOSS_CHUNK by default) is rematerialized in
    the backward, so its [B, chunk, V] logits are never kept."""
    B, S, D = x.shape
    c = min(seq_chunk or LOSS_CHUNK, S)
    while S % c:
        c -= 1
    targets = torch.as_tensor(targets, device=x.device)
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device) \
        if mask is None else torch.as_tensor(mask, device=x.device).float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)

    def part(i, carry):
        s0 = i * c
        nll, n = checkpoint(_xent_chunk, x[:, s0:s0 + c], head_w,
                            targets[:, s0:s0 + c], mask[:, s0:s0 + c])
        return (carry[0] + nll, carry[1] + n), None
    (tot, cnt), _ = trip_scan(part, S // c, (tot, cnt))
    return tot / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# decoder-only LM (incl. VLM prefix variant)
# ---------------------------------------------------------------------------
class LM:
    def __init__(self, cfg):
        check_ported(cfg)
        self.cfg = cfg

    # -- params -------------------------------------------------------------
    def init(self, gen, device=None) -> dict:
        """Random params from `gen` (a torch.Generator on `device`: the
        card unless device="cpu"), each leaf drawn in float32 then cast."""
        cfg = self.cfg
        device = resolve_device(device)
        params = {
            "embed": layers.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                       device=device),
            "final_norm": init_norm(cfg.d_model, device),
            "lm_head": layers.init_lm_head(gen, cfg.d_model,
                                           cfg.padded_vocab, device=device),
            "blocks": self._init_blocks(gen, device),
        }
        if cfg.frontend is not None:
            params["frontend"] = layers.init_dense(gen, cfg.d_model,
                                                   cfg.d_model,
                                                   device=device)
        return params

    def _init_blocks(self, gen, device):
        return _init_stack(gen, self.cfg, self.cfg.blocks,
                           self.cfg.num_cycles, device)

    # -- embedding of a batch (handles vlm prefix) ---------------------------
    def _embed(self, params, batch):
        cfg = self.cfg
        x = layers.embed_lookup(params["embed"], batch["inputs"])
        prefix_len = 0
        if cfg.frontend is not None and "prefix_embeds" in batch:
            pre = torch.as_tensor(batch["prefix_embeds"], device=x.device)
            pre = layers.dense(pre.to(x.dtype), params["frontend"]["w"])
            x = torch.cat([pre, x], dim=1)
            prefix_len = pre.shape[1]
        if not cfg.prefix_bidir:
            prefix_len = 0
        return x, prefix_len

    # -- train ----------------------------------------------------------------
    @layers.full_bf16_sums()
    def train_loss(self, params, batch):
        cfg = self.cfg
        x, prefix_len = self._embed(params, batch)
        x, _, aux = run_stack(cfg, cfg.blocks, params["blocks"], x,
                              mode="train", prefix_len=prefix_len)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        if prefix_len:           # loss over the text positions only
            x = x[:, prefix_len:]
        loss = lm_loss(x, params["lm_head"]["w"], batch["targets"],
                       batch.get("mask"))
        if cfg.num_experts:
            loss = loss + cfg.router_aux_coef * aux
        return loss, {"loss": loss, "aux": aux}

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, alloc: int, device=None,
                   dtype=layers.DEFAULT_DTYPE):
        """Zeroed per-layer caches: a tuple over cycles of a tuple over
        pattern positions of each mixer's state, shaped as the
        reference's `_cache_proto` shapes it; SWA layers hold min(window,
        alloc) slots, the recurrent mixers their O(1) state (mamba's
        conv window in `dtype`, the rest float32).  Every buffer is
        zero, as the reference's `init_cache` makes it from the protos'
        shapes alone: the mLSTM's m and the sLSTM's n and m start at 0,
        not at the -1e30 and 1e-6 of `init_mlstm_cache` /
        `init_slstm_cache`."""
        cfg = self.cfg
        device = resolve_device(device)

        def proto(kind):
            mixer = kind[0]
            if mixer in ("attn", "swa"):
                n = min(cfg.window_size, alloc) if mixer == "swa" else alloc
                return attention.init_attn_cache(cfg, batch, n, dtype=dtype,
                                                 device="meta")
            if mixer == "mamba":
                return mamba.init_mamba_cache(cfg, batch, dtype, "meta")
            if mixer == "mlstm":
                return xlstm.init_mlstm_cache(cfg, batch, "meta")
            if mixer == "slstm":
                return xlstm.init_slstm_cache(cfg, batch, "meta")
            raise ValueError(f"unknown mixer {mixer!r}")

        def one(kind):
            return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                    for k, v in proto(kind).items()}
        return tuple(tuple(one(kind) for kind in cfg.blocks)
                     for _ in range(cfg.num_cycles))

    # -- prefill / decode -----------------------------------------------------
    @layers.full_bf16_sums()
    def prefill(self, params, batch, alloc: int | None = None):
        """batch {"inputs" [B,S] int, ("prefix_embeds" [B,P,D])} ->
        (logits [B,V] of the last position, caches of `alloc` slots in
        the activations' dtype)."""
        cfg = self.cfg
        x, prefix_len = self._embed(params, batch)
        B, S = x.shape[0], x.shape[1]
        caches = self.init_cache(B, alloc or S, x.device, x.dtype)
        x, caches, _ = run_stack(cfg, cfg.blocks, params["blocks"], x,
                                 mode="prefill", caches=caches,
                                 prefix_len=prefix_len)
        x = rms_norm(x[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x)[:, 0], caches

    @layers.full_bf16_sums()
    def decode_step(self, params, caches, token, pos: int):
        """token [B,1] int; pos an int (the same position for every row).
        The caches are written in place and returned."""
        cfg = self.cfg
        x = layers.embed_lookup(params["embed"], token)
        x, caches, _ = run_stack(cfg, cfg.blocks, params["blocks"], x,
                                 mode="decode", caches=caches, pos=pos)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x)[:, 0], caches


# ---------------------------------------------------------------------------
# encoder-decoder (seamless-m4t): frame-embedding encoder + token decoder
# ---------------------------------------------------------------------------
ENC_BLOCK = (("attn", "mlp"),)


def _init_dec_block(gen, cfg, device=None) -> dict:
    return {
        "norm1": init_norm(cfg.d_model, device),
        "self": attention.init_attn(gen, cfg, device),
        "norm2": init_norm(cfg.d_model, device),
        "cross": attention.init_attn(gen, cfg, device),
        "norm3": init_norm(cfg.d_model, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def dec_block(cfg, p, x, enc_out, *, mode, cache=None, pos=None):
    """One decoder block: self-attention, cross-attention, MLP.  At train
    and prefill the cross K/V are projected from `enc_out` (and fill
    cache["cross"] at prefill); at decode (enc_out None) they are read
    from it.  cache {"self", "cross"} KV caches, written in place."""
    h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    h, _ = attention.attn_apply(cfg, p["self"], h, mode=mode,
                                cache=None if cache is None
                                else cache["self"], pos=pos)
    x = x + h
    h = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if mode == "decode":
        h, _ = attention.attn_apply(cfg, p["cross"], h, mode="decode",
                                    cache=cache["cross"], pos=pos,
                                    is_cross=True)
    else:
        h, _ = attention.attn_apply(cfg, p["cross"], h, mode=mode,
                                    cache=None if cache is None
                                    else cache["cross"],
                                    kv_override=enc_out)
    x = x + h
    return x + layers.mlp(p["mlp"], rms_norm(x, p["norm3"]["scale"],
                                             cfg.norm_eps))


def _dec_block(cfg, p, x, enc_out, mode, cache, pos):
    return dec_block(cfg, p, x, enc_out, mode=mode, cache=cache, pos=pos)


class EncDecLM:
    """The encoder-decoder: frame embeddings [B, S_src, D] through a
    dense frontend and bidirectional encoder blocks, then a token decoder
    of self-attention, cross-attention to the encoder's output and an
    MLP.  The encoder runs once, at prefill (or train); the cross K/V are
    projected at prefill into the cache, which decode reads."""

    def __init__(self, cfg):
        check_ported(cfg)
        self.cfg = cfg

    def init(self, gen, device=None) -> dict:
        """Random params from `gen` on `device` (the card unless
        device="cpu"); decoder blocks stacked over the cycles as a
        1-tuple, as the reference's vmap leaves them."""
        cfg = self.cfg
        device = resolve_device(device)
        return {
            "frontend": layers.init_dense(gen, cfg.d_model, cfg.d_model,
                                          device=device),
            "embed": layers.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                       device=device),
            "enc_blocks": _init_stack(gen, cfg, ENC_BLOCK,
                                      cfg.num_encoder_layers, device),
            "enc_norm": init_norm(cfg.d_model, device),
            "dec_blocks": self._init_dec_blocks(gen, device),
            "final_norm": init_norm(cfg.d_model, device),
            "lm_head": layers.init_lm_head(gen, cfg.d_model,
                                           cfg.padded_vocab, device=device),
        }

    def _init_dec_blocks(self, gen, device):
        return (_stacked(self.cfg.num_cycles,
                         lambda: _init_dec_block(gen, self.cfg, device)),)

    def encode(self, params, frames):
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=params["embed"]["table"]
                                 .device)
        x = layers.dense(frames.to(layers.DEFAULT_DTYPE),
                         params["frontend"]["w"])
        # bidirectional: the reference's prefix_len=2**30 mask
        x, _, _ = run_stack(cfg, ENC_BLOCK, params["enc_blocks"], x,
                            mode="train", prefix_len=2 ** 30)
        return rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)

    def _dec_stack(self, params, x, enc_out, *, mode, caches=None, pos=None):
        """The decoder's blocks over its cycles (`dec_block`), each cycle
        rematerialized in the backward in mode "train"."""
        per_cycle = _cycles(params["dec_blocks"][0])
        cache_cycles = None if caches is None else _cycles(caches[0])

        def cycle(ci, x):
            args = (self.cfg, per_cycle[ci], x, enc_out, mode,
                    None if caches is None else cache_cycles[ci], pos)
            return (checkpoint(_dec_block, *args) if mode == "train"
                    else _dec_block(*args)), None
        x, _ = trip_scan(cycle, len(per_cycle), x)
        return x, caches

    @layers.full_bf16_sums()
    def train_loss(self, params, batch):
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = layers.embed_lookup(params["embed"], batch["inputs"])
        x, _ = self._dec_stack(params, x, enc_out, mode="train")
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        loss = lm_loss(x, params["lm_head"]["w"], batch["targets"],
                       batch.get("mask"))
        return loss, {"loss": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=x.device)}

    def init_cache(self, batch: int, alloc: int, src_len: int, device=None,
                   dtype=layers.DEFAULT_DTYPE):
        """Zeroed decoder caches: a 1-tuple of {"self": `alloc` slots,
        "cross": `src_len` slots} KV caches stacked over the cycles."""
        cfg = self.cfg
        device = resolve_device(device)
        C = cfg.num_cycles

        def stacked(n):
            one = attention.init_attn_cache(cfg, batch, n, dtype=dtype,
                                            device="meta")
            return {k: torch.zeros((C,) + v.shape, dtype=v.dtype,
                                   device=device) for k, v in one.items()}
        return ({"self": stacked(alloc), "cross": stacked(src_len)},)

    @layers.full_bf16_sums()
    def prefill(self, params, batch, alloc: int | None = None):
        """batch {"frames" [B,S_src,D] float, "inputs" [B,S] int} ->
        (logits [B,V] of the last position, caches)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = layers.embed_lookup(params["embed"], batch["inputs"])
        B, S = x.shape[0], x.shape[1]
        caches = self.init_cache(B, alloc or S, enc_out.shape[1], x.device,
                                 x.dtype)
        x, caches = self._dec_stack(params, x, enc_out, mode="prefill",
                                    caches=caches)
        x = rms_norm(x[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x)[:, 0], caches

    @layers.full_bf16_sums()
    def decode_step(self, params, caches, token, pos: int):
        """token [B,1] int; pos an int.  The self caches are written in
        place and returned."""
        cfg = self.cfg
        x = layers.embed_lookup(params["embed"], token)
        x, caches = self._dec_stack(params, x, None, mode="decode",
                                    caches=caches, pos=pos)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x)[:, 0], caches


def build_model(cfg):
    """The model of `cfg`: an `EncDecLM` for an encoder-decoder config,
    else an `LM`."""
    return EncDecLM(cfg) if cfg.is_encoder_decoder else LM(cfg)
