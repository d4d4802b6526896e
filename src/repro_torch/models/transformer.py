"""Model assembly: decoder-only transformers of attention / SWA blocks
with gated-MLP or MoE FFNs, over pattern cycles; the counterpart of the
`LM` class of `repro.models.transformer`.

Parameters for each pattern position are stacked over `num_cycles` on a
leading axis, as in the reference; `run_stack` is a Python loop over the
cycles that hands each block per-cycle views of them.  Three entry points
per model: `train_loss`, `prefill`, `decode_step`; the VLM (paligemma,
prefix-LM) wraps the same machinery.  Caches are per layer, a tuple over
cycles of a tuple over pattern positions of {"k", "v"} dicts (the
reference's `decode_unroll` layout, its only one for these configs),
filled at prefill and written in place at decode.

Not ported yet (ROADMAP Queue A item 5): the mamba / mLSTM / sLSTM
mixers and the encoder-decoder model; `build_model` and `LM` raise
NotImplementedError for configs that need them.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe
from repro_torch.models.layers import init_norm, rms_norm

ROADMAP_ITEMS = {
    "mamba": "SSM and hybrid: mamba, xlstm, scan_utils",
    "mlstm": "SSM and hybrid: mamba, xlstm, scan_utils",
    "slstm": "SSM and hybrid: mamba, xlstm, scan_utils",
    "encdec": "EncDecLM",
}


def _not_ported(cfg, what: str, key: str):
    return NotImplementedError(
        f"{cfg.name}: {what} is not ported yet (ROADMAP Queue A item 5, "
        f"{ROADMAP_ITEMS[key]})")


def check_ported(cfg) -> None:
    """Raise NotImplementedError for a config the port cannot build."""
    if cfg.is_encoder_decoder:
        raise _not_ported(cfg, "the encoder-decoder model", "encdec")
    for mixer, ffn in cfg.blocks:
        if mixer not in ("attn", "swa"):
            raise _not_ported(cfg, f"the {mixer!r} mixer", mixer)
        if ffn not in ("mlp", "moe"):
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


def _cycle(tree, ci: int):
    """Per-cycle views of a stacked [C, ...] tree."""
    return _map(lambda a: a[ci], tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def init_block(gen, cfg, kind, device=None) -> dict:
    mixer, ffn = kind
    p = {"norm1": init_norm(cfg.d_model, device),
         "attn": attention.init_attn(gen, cfg, device)}
    if ffn == "mlp":
        p["norm2"] = init_norm(cfg.d_model, device)
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                   device=device)
    elif ffn == "moe":
        p["norm2"] = init_norm(cfg.d_model, device)
        p["moe"] = moe.init_moe(gen, cfg, device)
    return p


def block_apply(cfg, kind, p, x, *, mode, cache, pos, prefix_len):
    """x [B,S,D] -> (x, cache, aux)."""
    mixer, ffn = kind
    h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    window = cfg.window_size if mixer == "swa" else 0
    h, new_cache = attention.attn_apply(
        cfg, p["attn"], h, mode=mode, cache=cache, pos=pos,
        prefix_len=prefix_len, window=window)
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


def run_stack(cfg, blocks, stack_params, x, *, mode, caches=None,
              pos=None, prefix_len=0):
    """Loop the pattern cycle over depth.

    stack_params: tuple (per pattern position) of param trees with a
    leading num_cycles axis.  caches: tuple over cycles of tuples (per
    pattern position) of cache dicts, or None.  Returns (x, caches,
    aux_sum).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(cfg.num_cycles):
        for i, kind in enumerate(blocks):
            x, _, a = block_apply(
                cfg, kind, _cycle(stack_params[i], ci), x, mode=mode,
                cache=None if caches is None else caches[ci][i], pos=pos,
                prefix_len=prefix_len)
            aux = aux + a
    return x, caches, aux


# ---------------------------------------------------------------------------
# chunked LM loss (bounded memory at 256k vocab)
# ---------------------------------------------------------------------------
def lm_loss(x, head_w, targets, mask=None, seq_chunk: int = 512):
    """x [B,S,D], head_w [D,V], targets [B,S] -> mean xent (fp32)."""
    B, S, D = x.shape
    c = min(seq_chunk, S)
    while S % c:
        c -= 1
    targets = torch.as_tensor(targets, device=x.device)
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device) \
        if mask is None else torch.as_tensor(mask, device=x.device).float()
    wt = head_w.transpose(0, 1)                          # [V, D]
    hw = head_w.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        xc = x[:, s0:s0 + c].float()
        tc, mc = targets[:, s0:s0 + c], mask[:, s0:s0 + c]
        logits = torch.einsum("bcd,dv->bcv", xc, hw)
        m = torch.amax(logits, dim=-1)
        lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]),
                                      dim=-1))
        lab = torch.index_select(wt, 0, tc.reshape(-1)).reshape(B, c, D)
        lab_logit = torch.einsum("bcd,bcd->bc", xc, lab.float())
        tot = tot + torch.sum((lse - lab_logit) * mc)
        cnt = cnt + torch.sum(mc)
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
        """Per pattern position, a tree stacked over the cycles, filled
        one cycle at a time."""
        C = self.cfg.num_cycles
        out = []
        for kind in self.cfg.blocks:
            stacked = None
            for ci in range(C):
                one = init_block(gen, self.cfg, kind, device)
                if stacked is None:
                    stacked = _map(lambda a: a.new_empty((C,) + a.shape),
                                   one)
                _map_pair(lambda dst, src: dst[ci].copy_(src), stacked, one)
            out.append(stacked)
        return tuple(out)

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
        pattern positions; SWA layers hold min(window, alloc) slots."""
        cfg = self.cfg
        device = resolve_device(device)

        def one(kind):
            n = min(cfg.window_size, alloc) if kind[0] == "swa" else alloc
            return attention.init_attn_cache(cfg, batch, n, dtype=dtype,
                                             device=device)
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


def _map_pair(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _map_pair(fn, a[k], b[k])
    else:
        fn(a, b)


def build_model(cfg):
    """The model of `cfg`: an `LM`, or NotImplementedError for what the
    port does not have yet (SSM/hybrid, encoder-decoder)."""
    return LM(cfg)
