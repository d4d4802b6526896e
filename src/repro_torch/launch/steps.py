"""Step functions and input structs for every (architecture x input
shape) cell; the counterpart of `repro.launch.steps`.

A "struct" is a tensor on the meta device: its shape and dtype, no
storage, the counterpart of `jax.ShapeDtypeStruct`.  `input_specs(cfg,
shape)` returns the structs of every input of a cell's step;
`make_cell(cfg, shape, mesh)` also returns the step callable and the
spec trees of its inputs and outputs (`repro_torch.dist.sharding`), for
a mesh of one device or one over a `torch.distributed` world (data
parallel, tensor parallel, or both): there the callable takes and
returns each rank's shares of its inputs and outputs, laid out by those
specs (`sharding.local_shard`, `local_structs`), and gives the
one-device result.

The train step is the reference's (value and grad of `train_loss`, then
AdamW), with two differences of form.  The whole step, backward and
recompute included, runs inside `layers.full_bf16_sums`, so every bf16
product of the backward is rounded once from a float32 sum as the
forward's are.  And where the reference donates the old state to its
jitted step, the port's updates the state in place
(`AdamW.update_`, `EFCompressor.apply_`): the params, m and v are
overwritten a chunk at a time, so the step never holds a second copy of
the state.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.dist import api
from repro_torch.dist import sharding as shd
from repro_torch.dist.api import BATCH, dp_size
from repro_torch.models.layers import full_bf16_sums
from repro_torch.models.transformer import build_model, decode_alloc
from repro_torch.optim.adam import AdamW, cosine_schedule
from repro_torch.tree import leaves, tree_map, unflatten

META = torch.device("meta")


def structs(tree):
    """The tree's leaves as meta tensors of the same shapes and dtypes."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=META), tree)


def _meta_init(model):
    return model.init(torch.Generator(), META)


# ---------------------------------------------------------------------------
# batch structs per shape kind
# ---------------------------------------------------------------------------
def batch_structs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len

    def tok(s):
        return torch.empty(s, dtype=torch.int32, device=META)

    def emb(s):
        return torch.empty(s, dtype=torch.float32, device=META)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            Pn = cfg.num_prefix_embeds
            b = {"inputs": tok((B, S - Pn)),
                 "prefix_embeds": emb((B, Pn, cfg.d_model))}
            if shape.kind == "train":
                b["targets"] = tok((B, S - Pn))
            return b
        if cfg.is_encoder_decoder:
            b = {"frames": emb((B, S, cfg.d_model)), "inputs": tok((B, S))}
            if shape.kind == "train":
                b["targets"] = tok((B, S))
            return b
        b = {"inputs": tok((B, S))}
        if shape.kind == "train":
            b["targets"] = tok((B, S))
        return b
    # decode: one new token against a seq_len cache
    return {"token": tok((B, 1))}


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                quant: bool = False) -> dict:
    """All inputs of the cell's step, as structs.  quant=True swaps the
    parameter tree for its W8A8 form (serving only)."""
    def params_struct():
        p = _meta_init(build_model(cfg))
        if quant:
            from repro_torch.quant.lm_quant import quantize_lm_params
            p = quantize_lm_params(p)
        return p

    out = {"batch": batch_structs(cfg, shape)}
    if shape.kind == "train":
        out["state"] = train_state_structs(cfg)
    elif shape.kind == "prefill":
        out["params"] = params_struct()
    else:
        out["params"] = params_struct()
        out["cache"] = cache_structs(cfg, shape)
        out["pos"] = torch.empty((), dtype=torch.int32, device=META)
    return out


def cache_is_stacked(cfg: ModelConfig) -> bool:
    return cfg.is_encoder_decoder or not cfg.decode_unroll


def _init_cache(cfg, B: int, alloc: int, src_len: int):
    model = build_model(cfg)
    if not cfg.decode_unroll:
        raise NotImplementedError(
            f"{cfg.name}: the port keeps per-layer decode caches only "
            "(decode_unroll=True, every assigned config)")
    if cfg.is_encoder_decoder:
        return model.init_cache(B, alloc, src_len, META)
    return model.init_cache(B, alloc, META)


def cache_structs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache of `shape` (decode_alloc(seq_len) slots)."""
    return _init_cache(cfg, shape.global_batch, decode_alloc(shape.seq_len),
                       shape.seq_len)


def _prefill_cache_structs(cfg, shape):
    """The cache prefill returns (seq_len slots)."""
    return _init_cache(cfg, shape.global_batch, shape.seq_len, shape.seq_len)


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------
def make_optimizer(total_steps: int = 100_000) -> AdamW:
    return AdamW(lr=cosine_schedule(3e-4, 2000, total_steps),
                 weight_decay=0.1, clip_norm=1.0)


def train_state_structs(cfg: ModelConfig) -> dict:
    p = _meta_init(build_model(cfg))
    return {"params": p, "opt": make_optimizer().init(p),
            "step": torch.zeros((), dtype=torch.int32, device=META)}


def init_train_state(cfg: ModelConfig, gen, device=None,
                     mesh=None) -> dict:
    """Params drawn from `gen` (a torch.Generator on `device`: the card
    unless device="cpu"), zeroed AdamW moments, step 0; under `mesh`
    this rank's shares, each leaf drawn whole (the one-device bits)."""
    p = build_model(cfg).init(gen, device, mesh)
    opt = make_optimizer().init(p)
    return {"params": p, "opt": opt, "step": opt["step"].clone()}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def loss_and_grads(model, params, batch):
    """(loss, metrics, grads): `model.train_loss` and its gradients by
    every param leaf, a flat list in `leaves(params)` order (zeros for a
    leaf the loss does not reach, as `jax.grad` gives).  Runs inside
    `full_bf16_sums`, backward included."""
    with full_bf16_sums():
        ws = [p.detach().requires_grad_() for p in leaves(params)]
        loss, metrics = model.train_loss(unflatten(params, ws), batch)
        grads = list(torch.autograd.grad(loss, ws, allow_unused=True))
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(ws, grads)]
    rows = api.rows_group()
    if rows is not None:      # each rank's rows gave its part of the sum
        grads = [api.collective("sum", g.float(), rows.handle).to(g.dtype)
                 for g in grads]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt: AdamW | None = None,
                    compressor=None, split=None):
    """train_step(state, batch) -> (state, metrics): the state {"params",
    "opt", "step"(, "err" with a compressor)} is updated in place and
    returned; metrics {"loss", "aux", "grad_norm", "lr"} are 0-d tensors
    on the state's device.  Under a tensor-parallel mesh `split` flags
    the param leaves (in `leaves` order) split over the model line
    (`split_leaves`)."""
    model = build_model(cfg)
    opt = opt or make_optimizer()

    def train_step(state, batch):
        _, metrics, grads = loss_and_grads(model, state["params"], batch)
        if compressor is not None:
            compressor.apply_(grads, leaves(state["err"]))
        om = opt.update_(grads, state["opt"], state["params"], split=split)
        state["step"] = state["step"] + 1
        return state, dict(metrics, **om)
    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec):
    model = build_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """serve_step(params, cache, token, pos): pos a Python int or a 0-d
    tensor on a device that holds its value (a meta struct has none: a
    dry run passes the cell's last slot as an int)."""
    model = build_model(cfg)

    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        if isinstance(pos, torch.Tensor) and pos.device.type == "meta":
            raise ValueError("decode pos is a meta tensor, which has no "
                             "value: pass the position as an int")
        return model.decode_step(params, cache, token, int(pos))
    return serve_step


# ---------------------------------------------------------------------------
# full cell assembly: (step fn, input structs, in/out specs)
# ---------------------------------------------------------------------------
def split_leaves(cfg: ModelConfig) -> list:
    """Per param leaf (`leaves` order), whether `param_specs` splits it
    over the model axis."""
    p = _meta_init(build_model(cfg))
    return [any(e == "model" or (isinstance(e, tuple) and "model" in e)
                for e in spec)
            for spec in shd.flat_specs(p, shd.param_specs(p))]


def local_structs(args, in_specs, mesh):
    """The structs each rank of `mesh` holds of `args` laid out by
    `in_specs` (as `make_cell` returns them): over a world this rank's
    shares, for a record of devices the first (largest) ones."""
    def leaf(t, spec):
        shape = list(t.shape)
        for i, ent in enumerate(spec):
            if ent is None:
                continue
            ways = mesh.ways(ent)
            index = mesh.index(ent) if mesh.world is not None else 0
            lo, hi = api.row_share(shape[i], ways, index)
            shape[i] = hi - lo
        return torch.empty(shape, dtype=t.dtype, device=META)
    return shd.zip_specs(leaf, args, in_specs)


def make_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, quant: bool = False):
    """Returns (fn, args tuple of structs, in_specs, out_specs), each spec
    filtered to the mesh's axes (`sharding.to_shardings`), and `args` the
    global structs.  On a mesh over a world `fn` runs under the mesh and
    takes and returns each rank's shares (`local_structs`): the rows
    split over BATCH when the batch divides its ways, the params, the
    optimizer state and the caches as their specs say."""
    B = shape.global_batch
    specs = input_specs(cfg, shape, quant=quant)
    bspec = shd.batch_specs(specs["batch"], B, mesh)
    logits_spec = (BATCH, None) if B % dp_size(mesh) == 0 else ()

    if shape.kind == "train":
        fn = make_train_step(cfg, split=split_leaves(cfg)
                             if api.tp_size(mesh) > 1 else None)
        st = specs["state"]
        st_spec = {
            "params": shd.param_specs(st["params"]),
            "opt": shd.opt_state_specs(st["opt"], st["params"]),
            "step": (),
        }
        args = (st, specs["batch"])
        in_specs = (st_spec, bspec)
        out_specs = (st_spec, ())          # metrics replicated
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, shape)
        p_spec = shd.param_specs(specs["params"])
        cache_out = shd.cache_specs(
            _prefill_cache_structs(cfg, shape), B, mesh,
            stacked=cache_is_stacked(cfg))
        args = (specs["params"], specs["batch"])
        in_specs = (p_spec, bspec)
        out_specs = (logits_spec, cache_out)
    else:
        fn = make_decode_step(cfg)
        p_spec = shd.param_specs(specs["params"])
        c_spec = shd.cache_specs(specs["cache"], B, mesh,
                                 stacked=cache_is_stacked(cfg))
        args = (specs["params"], specs["cache"], specs["batch"]["token"],
                specs["pos"])
        tok_spec = bspec["token"]
        in_specs = (p_spec, c_spec, tok_spec, ())
        out_specs = (logits_spec, c_spec)

    def place(spec_tree):
        return shd.map_specs(lambda s: shd.to_shardings(s, mesh), spec_tree)

    rows = shd.dp_shardable(B, mesh)

    def step(*a):
        with mesh, api.rows_split(rows):
            return fn(*a)
    return step, args, place(in_specs), place(out_specs)
