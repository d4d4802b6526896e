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
from repro_torch.dist import api
from repro_torch.dist.op_analysis import trip_scan
from repro_torch.models import attention, layers, mamba, moe, xlstm
from repro_torch.models.layers import init_norm, rms_norm
from repro_torch.models.scan_utils import checkpoint
from repro_torch.tree import leaves, leaves_with_paths, unflatten

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


def _small_n(cfg, name: str):
    """The whole last axis of a block's leaf that the models use whole
    (`layers.full`), by its name; None for the others."""
    return {"scale": cfg.d_model, "q_norm": cfg.head_dim,
            "k_norm": cfg.head_dim, "conv_w": cfg.ssm_inner,
            "conv_b": cfg.ssm_inner, "dt_bias": cfg.ssm_inner,
            "D": cfg.ssm_inner, "A_log": cfg.ssm_state_dim,
            "bi": cfg.num_heads, "bf": cfg.num_heads, "bx": 4 * cfg.d_model,
            "r": 4 * (cfg.d_model // max(cfg.num_heads, 1))}.get(name)


def _whole_small(cfg, tree, mode: str):
    """The stacked block tree with every leaf the blocks use whole (the
    norms' scales, qk-norm, the recurrent mixers' small leaves) gathered
    over the model line in one collective, so that `layers.full` finds
    it whole; qk-norm's gradient summed over the line where the heads
    split.  The tree itself with no tensor-parallel mesh."""
    g = api.model_group()
    if g is None:
        return tree
    paths = leaves_with_paths(tree)
    pick = [i for i, (path, t) in enumerate(paths)
            if (n := _small_n(cfg, path.rsplit("/", 1)[-1])) is not None
            and t.shape[-1] != n]
    if not pick:
        return tree
    names = [paths[i][0].rsplit("/", 1)[-1] for i in pick]
    split = attention.heads_split(cfg, mode, g)
    whole = api.gather_leaves(
        [paths[i][1] for i in pick], [_small_n(cfg, n) for n in names], g,
        [split and n in ("q_norm", "k_norm") for n in names])
    new = [t for _, t in paths]
    for i, w in zip(pick, whole):
        new[i] = w
    return unflatten(tree, new)


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


RECURRENT = {"mamba": mamba.init_mamba_cache,
             "mlstm": xlstm.init_mlstm_cache,
             "slstm": xlstm.init_slstm_cache}


def _whole_state(cfg, mixer, cache):
    """(the whole state of a recurrent mixer whose cache holds this rank's
    share of axis 1, gathered over `api.seq_group`; {name: axis-1 size})
    or (cache, None) when it is not split."""
    seq = api.seq_group()
    if seq is None or cache is None or mixer not in RECURRENT:
        return cache, None
    n = {k: v.shape[1] for k, v in RECURRENT[mixer](cfg, 1,
                                                     device="meta").items()}
    return {k: api.gather_cat(v, 1, api.shares(n[k], seq), seq)
            for k, v in cache.items()}, n


def block_apply(cfg, kind, p, x, *, mode, cache, pos, prefix_len,
                slots=None):
    """x [B,S,D] -> (x, cache, aux).  `slots`: the whole slot count of an
    attention cache split over `api.seq_group`."""
    mixer, ffn = kind
    D = cfg.d_model
    h = rms_norm(x, layers.full(p["norm1"]["scale"], D), cfg.norm_eps)
    run_cache, n = _whole_state(cfg, mixer, cache)
    if mixer in ("attn", "swa"):
        window = cfg.window_size if mixer == "swa" else 0
        h, new_cache = attention.attn_apply(
            cfg, p["attn"], h, mode=mode, cache=cache, pos=pos,
            prefix_len=prefix_len, window=window, slots=slots)
    elif mixer == "mamba":
        h, new_cache = mamba.mamba_apply(p["mamba"], h, cfg, mode=mode,
                                         cache=run_cache)
    elif mixer == "mlstm":
        h, new_cache = xlstm.mlstm_apply(p["mlstm"], h, cfg, mode=mode,
                                         cache=run_cache)
    elif mixer == "slstm":
        h, new_cache = xlstm.slstm_apply(p["slstm"], h, cfg, mode=mode,
                                         cache=run_cache)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if n is not None:           # keep this rank's share of the new state
        for k, whole in new_cache.items():
            lo, hi = api.share(n[k], api.seq_group())
            cache[k].copy_(whole.narrow(1, lo, hi - lo))
        new_cache = cache
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn in ("mlp", "moe"):
        h2 = rms_norm(x, layers.full(p["norm2"]["scale"], D), cfg.norm_eps)
    if ffn == "mlp":
        x = x + layers.mlp(p["mlp"], h2, cfg.d_ff)
    elif ffn == "moe":
        h2, aux = moe.moe_apply(p["moe"], h2, cfg,
                                is_decode=(mode == "decode"))
        x = x + h2
    return x, new_cache, aux


def _run_cycle(cfg, blocks, params, x, aux, mode, caches, pos,
               prefix_len, slots=None):
    """One pattern cycle: each block in turn, its aux summed."""
    for i, kind in enumerate(blocks):
        x, _, a = block_apply(cfg, kind, params[i], x, mode=mode,
                              cache=None if caches is None else caches[i],
                              pos=pos, prefix_len=prefix_len,
                              slots=None if slots is None else slots[i])
        aux = aux + a
    return x, aux


def run_stack(cfg, blocks, stack_params, x, *, mode, caches=None,
              pos=None, prefix_len=0, slots=None):
    """Loop the pattern cycle over depth (the stacked params' leading
    axis).

    stack_params: tuple (per pattern position) of param trees with a
    leading cycle axis.  caches: tuple over cycles of tuples (per
    pattern position) of cache dicts, or None; each block writes its own
    in place.  `slots`: per pattern position, the whole slot count of an
    attention cache split over `api.seq_group` (else None).  In mode
    "train" each cycle is rematerialized in the
    backward (`scan_utils.checkpoint`), as the reference's scan body is.
    Returns (x, caches, aux_sum).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_cycle = _cycles(_whole_small(cfg, stack_params, mode))

    def cycle(ci, carry):
        args = (cfg, blocks, per_cycle[ci], *carry, mode,
                None if caches is None else caches[ci], pos, prefix_len,
                slots)
        return (checkpoint(_run_cycle, *args) if mode == "train"
                else _run_cycle(*args)), None
    (x, aux), _ = trip_scan(cycle, len(per_cycle), (x, aux))
    return x, caches, aux


def _keeper(mesh, stacked: bool):
    """The share a rank of `mesh`'s model line keeps of a leaf drawn
    whole (`sharding.param_specs`: the last axis of a leaf of two or
    more axes, a layer's leaf counting its stacking axis); None to keep
    all of it."""
    g = None if mesh is None or api.tp_size(mesh) == 1 else \
        mesh.group(api.MODEL)
    if g is None:
        return None

    def keep(leaf):
        if leaf.dim() + stacked < 2 or leaf.shape[-1] < 2:
            return leaf
        lo, hi = api.share(leaf.shape[-1], g)
        return leaf.narrow(-1, lo, hi - lo).clone()
    return keep


def _keep(tree, keep):
    return tree if keep is None else _map(keep, tree)


def _stacked(cycles: int, make, keep=None):
    """A param tree stacked over `cycles` on a leading axis, filled one
    cycle at a time from `make()` (each leaf cut by `keep`, if given)."""
    stacked = None
    for ci in range(cycles):
        one = _keep(make(), keep)
        if stacked is None:
            stacked = _map(lambda a: a.new_empty((cycles,) + a.shape), one)
        _map_pair(lambda dst, src: dst[ci].copy_(src), stacked, one)
    return stacked


def _init_stack(gen, cfg, blocks, cycles, device, mesh=None):
    """Per pattern position, its blocks' params stacked over `cycles`
    (this rank's share under `mesh`)."""
    keep = _keeper(mesh, stacked=True)
    return tuple(_stacked(cycles, lambda k=kind: init_block(gen, cfg, k,
                                                            device), keep)
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


def _xent_chunk_split(xc, head_w, tc, mc, vocab: int):
    """`_xent_chunk` on the vocabulary split over the model line: head_w
    holds this rank's columns; the max and the sum of exps are reduced
    over the line, and the label's logit comes from the rank that owns
    its column."""
    g = api.model_group()
    B, c, D = xc.shape
    xc = api.copy_to(xc.float(), g)
    logits = torch.einsum("bcd,dv->bcv", xc, head_w.float())
    m = api.reduce_max(torch.amax(logits, dim=-1), g)
    lse = m + torch.log(api.reduce_sum(torch.sum(
        torch.exp(logits - m[..., None]), dim=-1), g))
    lo, hi = api.share(vocab, g)
    own = (tc >= lo) & (tc < hi)
    idx = torch.clamp(tc - lo, 0, max(hi - lo - 1, 0))
    lab = torch.index_select(head_w.transpose(0, 1), 0, idx.reshape(-1))
    lab_logit = torch.einsum("bcd,bcd->bc", xc, lab.reshape(B, c, D).float())
    lab_logit = api.reduce_sum(torch.where(own, lab_logit, 0.0), g)
    return torch.sum((lse - lab_logit) * mc), torch.sum(mc)


def lm_loss(x, head_w, targets, mask=None, seq_chunk: int | None = None,
            vocab: int | None = None):
    """x [B,S,D], head_w [D,V], targets [B,S] -> mean xent (fp32).  Each
    chunk of the sequence (LOSS_CHUNK by default) is rematerialized in
    the backward, so its [B, chunk, V] logits are never kept.  Under a
    tensor-parallel mesh head_w holds this rank's columns of `vocab`
    (`_xent_chunk_split`); where the rows split over BATCH the sums are
    reduced over them, so every rank returns the whole batch's mean."""
    B, S, D = x.shape
    c = min(seq_chunk or LOSS_CHUNK, S)
    while S % c:
        c -= 1
    targets = torch.as_tensor(targets, device=x.device)
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device) \
        if mask is None else torch.as_tensor(mask, device=x.device).float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    split = api.model_group() is not None

    def part(i, carry):
        s0 = i * c
        args = (x[:, s0:s0 + c], head_w, targets[:, s0:s0 + c],
                mask[:, s0:s0 + c])
        nll, n = checkpoint(_xent_chunk_split, *args, vocab) if split \
            else checkpoint(_xent_chunk, *args)
        return (carry[0] + nll, carry[1] + n), None
    (tot, cnt), _ = trip_scan(part, S // c, (tot, cnt))
    rows = api.rows_group()
    if rows is not None:
        tot = api.reduce_sum(tot, rows)
        cnt = api.collective("sum", cnt.detach(), rows.handle)
    return tot / torch.clamp_min(cnt, 1.0)


def _slot_counts(cfg, blocks, alloc: int):
    """Per pattern position, the whole slot count of its attention cache
    of `alloc` (a sliding window's ring holds min(window, alloc)), None
    for a recurrent mixer; None outside a mesh that splits the slots."""
    if api.seq_group() is None:
        return None
    return tuple({"attn": alloc, "swa": min(cfg.window_size, alloc)}
                 .get(kind[0]) for kind in blocks)


def _local_cache(shape, axis: int, dtype, device):
    """Zeros of a cache leaf's `shape` cut to this rank's share of
    `axis` over `api.seq_group`."""
    lo, hi = api.share(shape[axis], api.seq_group())
    shape = tuple(shape[:axis]) + (hi - lo,) + tuple(shape[axis + 1:])
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# decoder-only LM (incl. VLM prefix variant)
# ---------------------------------------------------------------------------
class LM:
    def __init__(self, cfg):
        check_ported(cfg)
        self.cfg = cfg

    # -- params -------------------------------------------------------------
    def init(self, gen, device=None, mesh=None) -> dict:
        """Random params from `gen` (a torch.Generator on `device`: the
        card unless device="cpu"), each leaf drawn in float32 then cast;
        under `mesh` this rank's share of each (`_keeper`)."""
        cfg = self.cfg
        device = resolve_device(device)
        keep = _keeper(mesh, stacked=False)
        params = {
            "embed": _keep(layers.init_embed(gen, cfg.padded_vocab,
                                             cfg.d_model, device=device),
                           keep),
            "final_norm": init_norm(cfg.d_model, device),
            "lm_head": _keep(layers.init_lm_head(
                gen, cfg.d_model, cfg.padded_vocab, device=device), keep),
            "blocks": self._init_blocks(gen, device, mesh),
        }
        if cfg.frontend is not None:
            params["frontend"] = _keep(layers.init_dense(
                gen, cfg.d_model, cfg.d_model, device=device), keep)
        return params

    def _init_blocks(self, gen, device, mesh=None):
        return _init_stack(gen, self.cfg, self.cfg.blocks,
                           self.cfg.num_cycles, device, mesh)

    # -- embedding of a batch (handles vlm prefix) ---------------------------
    def _embed(self, params, batch):
        cfg = self.cfg
        x = layers.embed_lookup(params["embed"], batch["inputs"],
                                cfg.d_model)
        prefix_len = 0
        if cfg.frontend is not None and "prefix_embeds" in batch:
            pre = torch.as_tensor(batch["prefix_embeds"], device=x.device)
            pre = layers.col_dense(pre.to(x.dtype), params["frontend"]["w"],
                                   cfg.d_model)
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
                       batch.get("mask"), vocab=cfg.padded_vocab)
        rows = api.rows_group()
        if rows is not None:    # the mean over groups of every rank's rows
            aux = api.reduce_sum(aux, rows) / rows.size
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
        `init_slstm_cache`.  Under a mesh that splits the caches'
        axis 1 (`api.seq_group`), this rank's share of it; `batch` is
        this rank's rows."""
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
            return {k: _local_cache(v.shape, 1, v.dtype, device)
                    for k, v in proto(kind).items()}
        return tuple(tuple(one(kind) for kind in cfg.blocks)
                     for _ in range(cfg.num_cycles))

    def _attn_positions(self) -> list:
        return [i for i, kind in enumerate(self.cfg.blocks)
                if kind[0] in ("attn", "swa")]

    def slot_counts(self, caches) -> list:
        """The slot counts of the attention caches of the first cycle, in
        pattern order: what a decode step under a mesh that splits them
        sums over the ranks (`api.whole_sizes`)."""
        return [caches[0][i]["k"].shape[1] for i in self._attn_positions()]

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
                                 prefix_len=prefix_len,
                                 slots=_slot_counts(cfg, cfg.blocks,
                                                    alloc or S))
        x = rms_norm(x[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x,
                                cfg.padded_vocab)[:, 0], caches

    @layers.full_bf16_sums()
    def decode_step(self, params, caches, token, pos: int):
        """token [B,1] int; pos an int (the same position for every row).
        The caches are written in place and returned."""
        cfg = self.cfg
        x = layers.embed_lookup(params["embed"], token, cfg.d_model)
        slots = None
        attn = self._attn_positions()
        if api.seq_group() is not None and attn:
            whole = iter(api.whole_sizes(self.slot_counts(caches),
                                         api.seq_group()))
            slots = tuple(next(whole) if i in attn else None
                          for i in range(len(cfg.blocks)))
        x, caches, _ = run_stack(cfg, cfg.blocks, params["blocks"], x,
                                 mode="decode", caches=caches, pos=pos,
                                 slots=slots)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x,
                                cfg.padded_vocab)[:, 0], caches


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


def dec_block(cfg, p, x, enc_out, *, mode, cache=None, pos=None,
              slots=None):
    """One decoder block: self-attention, cross-attention, MLP.  At train
    and prefill the cross K/V are projected from `enc_out` (and fill
    cache["cross"] at prefill); at decode (enc_out None) they are read
    from it.  cache {"self", "cross"} KV caches, written in place;
    `slots` {"self", "cross"} their whole slot counts where they split
    over `api.seq_group`."""
    slots = slots or {}
    D = cfg.d_model
    h = rms_norm(x, layers.full(p["norm1"]["scale"], D), cfg.norm_eps)
    h, _ = attention.attn_apply(cfg, p["self"], h, mode=mode,
                                cache=None if cache is None
                                else cache["self"], pos=pos,
                                slots=slots.get("self"))
    x = x + h
    h = rms_norm(x, layers.full(p["norm2"]["scale"], D), cfg.norm_eps)
    if mode == "decode":
        h, _ = attention.attn_apply(cfg, p["cross"], h, mode="decode",
                                    cache=cache["cross"], pos=pos,
                                    is_cross=True, slots=slots.get("cross"))
    else:
        h, _ = attention.attn_apply(cfg, p["cross"], h, mode=mode,
                                    cache=None if cache is None
                                    else cache["cross"],
                                    kv_override=enc_out,
                                    slots=slots.get("cross"))
    x = x + h
    return x + layers.mlp(p["mlp"], rms_norm(
        x, layers.full(p["norm3"]["scale"], D), cfg.norm_eps), cfg.d_ff)


def _dec_block(cfg, p, x, enc_out, mode, cache, pos, slots):
    return dec_block(cfg, p, x, enc_out, mode=mode, cache=cache, pos=pos,
                     slots=slots)


class EncDecLM:
    """The encoder-decoder: frame embeddings [B, S_src, D] through a
    dense frontend and bidirectional encoder blocks, then a token decoder
    of self-attention, cross-attention to the encoder's output and an
    MLP.  The encoder runs once, at prefill (or train); the cross K/V are
    projected at prefill into the cache, which decode reads."""

    def __init__(self, cfg):
        check_ported(cfg)
        self.cfg = cfg

    def init(self, gen, device=None, mesh=None) -> dict:
        """Random params from `gen` on `device` (the card unless
        device="cpu"); decoder blocks stacked over the cycles as a
        1-tuple, as the reference's vmap leaves them.  Under `mesh`
        this rank's share of each leaf (`_keeper`)."""
        cfg = self.cfg
        device = resolve_device(device)
        keep = _keeper(mesh, stacked=False)
        return {
            "frontend": _keep(layers.init_dense(gen, cfg.d_model,
                                                cfg.d_model, device=device),
                              keep),
            "embed": _keep(layers.init_embed(gen, cfg.padded_vocab,
                                             cfg.d_model, device=device),
                           keep),
            "enc_blocks": _init_stack(gen, cfg, ENC_BLOCK,
                                      cfg.num_encoder_layers, device, mesh),
            "enc_norm": init_norm(cfg.d_model, device),
            "dec_blocks": self._init_dec_blocks(gen, device, mesh),
            "final_norm": init_norm(cfg.d_model, device),
            "lm_head": _keep(layers.init_lm_head(
                gen, cfg.d_model, cfg.padded_vocab, device=device), keep),
        }

    def _init_dec_blocks(self, gen, device, mesh=None):
        return (_stacked(self.cfg.num_cycles,
                         lambda: _init_dec_block(gen, self.cfg, device),
                         _keeper(mesh, stacked=True)),)

    def encode(self, params, frames):
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=params["embed"]["table"]
                                 .device)
        x = layers.col_dense(frames.to(layers.DEFAULT_DTYPE),
                             params["frontend"]["w"], cfg.d_model)
        # bidirectional: the reference's prefix_len=2**30 mask
        x, _, _ = run_stack(cfg, ENC_BLOCK, params["enc_blocks"], x,
                            mode="train", prefix_len=2 ** 30)
        return rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)

    def _dec_stack(self, params, x, enc_out, *, mode, caches=None, pos=None,
                   slots=None):
        """The decoder's blocks over its cycles (`dec_block`), each cycle
        rematerialized in the backward in mode "train"."""
        per_cycle = _cycles(_whole_small(self.cfg, params["dec_blocks"][0],
                                         mode))
        cache_cycles = None if caches is None else _cycles(caches[0])

        def cycle(ci, x):
            args = (self.cfg, per_cycle[ci], x, enc_out, mode,
                    None if caches is None else cache_cycles[ci], pos,
                    slots)
            return (checkpoint(_dec_block, *args) if mode == "train"
                    else _dec_block(*args)), None
        x, _ = trip_scan(cycle, len(per_cycle), x)
        return x, caches

    @layers.full_bf16_sums()
    def train_loss(self, params, batch):
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = layers.embed_lookup(params["embed"], batch["inputs"],
                                cfg.d_model)
        x, _ = self._dec_stack(params, x, enc_out, mode="train")
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        loss = lm_loss(x, params["lm_head"]["w"], batch["targets"],
                       batch.get("mask"), vocab=cfg.padded_vocab)
        return loss, {"loss": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=x.device)}

    def init_cache(self, batch: int, alloc: int, src_len: int, device=None,
                   dtype=layers.DEFAULT_DTYPE):
        """Zeroed decoder caches: a 1-tuple of {"self": `alloc` slots,
        "cross": `src_len` slots} KV caches stacked over the cycles (this
        rank's share of the slots under `api.seq_group`, and `batch` its
        rows)."""
        cfg = self.cfg
        device = resolve_device(device)
        C = cfg.num_cycles

        def stacked(n):
            one = attention.init_attn_cache(cfg, batch, n, dtype=dtype,
                                            device="meta")
            return {k: _local_cache((C,) + v.shape, 2, v.dtype, device)
                    for k, v in one.items()}
        return ({"self": stacked(alloc), "cross": stacked(src_len)},)

    @layers.full_bf16_sums()
    def prefill(self, params, batch, alloc: int | None = None):
        """batch {"frames" [B,S_src,D] float, "inputs" [B,S] int} ->
        (logits [B,V] of the last position, caches)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = layers.embed_lookup(params["embed"], batch["inputs"],
                                cfg.d_model)
        B, S = x.shape[0], x.shape[1]
        caches = self.init_cache(B, alloc or S, enc_out.shape[1], x.device,
                                 x.dtype)
        slots = None if api.seq_group() is None else \
            {"self": alloc or S, "cross": enc_out.shape[1]}
        x, caches = self._dec_stack(params, x, enc_out, mode="prefill",
                                    caches=caches, slots=slots)
        x = rms_norm(x[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x,
                                cfg.padded_vocab)[:, 0], caches

    @staticmethod
    def slot_counts(caches) -> list:
        """The slot counts of the self and cross caches: what a decode
        step under a mesh that splits them sums over the ranks."""
        return [caches[0][k]["k"].shape[2] for k in ("self", "cross")]

    @layers.full_bf16_sums()
    def decode_step(self, params, caches, token, pos: int):
        """token [B,1] int; pos an int.  The self caches are written in
        place and returned."""
        cfg = self.cfg
        x = layers.embed_lookup(params["embed"], token, cfg.d_model)
        slots = None
        if api.seq_group() is not None:
            slots = dict(zip(("self", "cross"), api.whole_sizes(
                self.slot_counts(caches), api.seq_group())))
        x, caches = self._dec_stack(params, x, None, mode="decode",
                                    caches=caches, pos=pos, slots=slots)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return layers.lm_logits(params["lm_head"], x,
                                cfg.padded_vocab)[:, 0], caches


def build_model(cfg):
    """The model of `cfg`: an `EncDecLM` for an encoder-decoder config,
    else an `LM`."""
    return EncDecLM(cfg) if cfg.is_encoder_decoder else LM(cfg)
