"""Rank functions of the tensor-parallel tests (`test_torch_tensor_parallel`).

Each runs on every rank of a gloo world that `repro_torch.dist.world.spawn`
started on the CPU, builds the world's (pod, data, model) mesh, and makes
every check of its test module inside that one world: the one-process
port in the same rank (the same thread count, so the same CPU kernels)
beside the meshed run of `launch.steps.make_cell`'s steps on the rank's
shares.  Results come back as plain CPU tensors and numbers; rank 0's
hold the gathered trees.  This module imports neither JAX nor the
reference package, so the children start without them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import base as tbase
from repro_torch.dist import api, sharding
from repro_torch.dist.api import Mesh
from repro_torch.dist.world import current_world
from repro_torch.launch import steps as TS
from repro_torch.launch.train import reduced
from repro_torch.models.transformer import build_model
from repro_torch.quant import lm_quant
from repro_torch.tree import leaves, tree_map, unflatten

S, STEPS = 16, 4
ALLOC = 64           # prefill's cache: the VLM's prefix + S + STEPS fit


def cfg_of(arch: str):
    c = tbase.get_config(arch)
    n = len(c.blocks)
    return reduced(c, d_model=64, layers=2 if n == 1 else n)


def world_mesh(data: int) -> Mesh:
    """The world's (pod 1, data, model = size / data) mesh."""
    w = current_world()
    return Mesh(("pod", "data", "model"), (1, data, w.size // data),
                w.devices, world=w)


def full_params(cfg, dtype: str):
    """The one-process init of seed 0 on the CPU, in `dtype`."""
    p = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    if dtype == "f32":
        p = tree_map(lambda t: t.float(), p)
    return p


def make_batch(cfg, B: int, seed: int = 1) -> dict:
    """Tokens [B, S + STEPS + 1] (inputs, targets, decode tokens), the
    VLM's image embeds, the encoder-decoder's frames: NumPy from `seed`."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S + STEPS + 1)).astype(
        np.int32)
    out = {"toks": toks}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            0, 1, (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(
            np.float32)
    return out


def train_batch(data: dict) -> dict:
    toks = torch.from_numpy(data["toks"])
    b = {"inputs": toks[:, :S], "targets": toks[:, 1:S + 1]}
    for k in ("prefix_embeds", "frames"):
        if k in data:
            b[k] = torch.from_numpy(data[k])
    return b


def prompt(data: dict) -> dict:
    b = train_batch(data)
    b.pop("targets")
    return b


def rows(batch: dict, mesh, split: bool) -> dict:
    """This rank's rows of every leaf when they split over BATCH."""
    return {k: api.split_rows(v, mesh) if split else v
            for k, v in batch.items()}


def decode_pos(cfg) -> int:
    return S + (cfg.num_prefix_embeds if cfg.family == "vlm" else 0)


def serve(cfg, params, data, mesh, split, B):
    """make_cell's prefill logits, then the model's prefill into ALLOC
    slots and STEPS of make_cell's decode: (prefill logits, the model's
    prefill logits, [decode logits]), every row (gathered where they
    split)."""
    model = build_model(cfg)
    mesh = mesh or Mesh(("pod", "data", "model"), (1, 1, 1), ["cpu"])
    shape = tbase.ShapeSpec("p", "prefill", S, B)
    pre, *_ = TS.make_cell(cfg, shape, mesh)
    dec, *_ = TS.make_cell(cfg, tbase.ShapeSpec("d", "decode", S, B), mesh)
    batch = rows(prompt(data), mesh, split)

    def whole(t):
        t = t.float()
        return (api.gather_rows(t, mesh, B) if split else t).clone()
    logits, _ = pre(params, batch)
    with mesh, api.rows_split(split):
        again, cache = model.prefill(params, batch, alloc=ALLOC)
    out = []
    toks = torch.from_numpy(data["toks"])
    p0 = decode_pos(cfg)
    for i in range(STEPS):
        tok = rows({"t": toks[:, S + i:S + i + 1]}, mesh, split)["t"]
        step, cache = dec(params, cache, tok, p0 + i)
        out.append(whole(step))
    return whole(logits), whole(again), out


def record_exponents():
    """Patch `lm_quant.quantize_activation` to record (input, exponent)
    of every W8A8 product; returns the list and the undo."""
    seen = []
    orig = lm_quant.quantize_activation

    def spy(x):
        q, e = orig(x)
        seen.append((x.detach().float().clone(), float(e)))
        return q, e
    lm_quant.quantize_activation = spy
    return seen, lambda: setattr(lm_quant, "quantize_activation", orig)


def compare_exponents(one: list, tp: list, mesh, split: bool) -> dict:
    """Products compared and the exponents that differ; a differing
    exponent whose input was equal to the one-process product's raises.
    Under split rows the input compared is this rank's rows of it."""
    if len(one) != len(tp):
        raise AssertionError(f"{len(one)} W8A8 products alone, {len(tp)} "
                             "on the mesh")
    mismatched = after = 0
    for (xo, eo), (xt, et) in zip(one, tp):
        if split and xo.dim() and xo.shape[0] != xt.shape[0]:
            xo = api.split_rows(xo, mesh)
        same_input = xo.shape == xt.shape and torch.equal(xo, xt)
        if eo != et:
            if same_input:
                raise AssertionError(f"exponent {et} against {eo} on the "
                                     "same input")
            mismatched += 1
        after += not same_input
    return {"products": len(one), "mismatched": mismatched,
            "inputs_differing": after}


def case(arch: str, dtype: str, data_ways: int, B: int) -> dict:
    """One (arch, dtype) on this world's mesh: the train step's loss and
    every gradient, prefill and decode logits, each beside the
    one-process port's; W8A8 (dtype "w8a8") serves only."""
    cfg = cfg_of(arch)
    mesh = world_mesh(data_ways)
    split = sharding.dp_shardable(B, mesh)
    data = make_batch(cfg, B)
    model = build_model(cfg)
    full = full_params(cfg, "bf16" if dtype == "w8a8" else dtype)
    specs = sharding.param_specs(full)
    # the meshed init: each leaf drawn whole, this rank's share kept
    drawn = model.init(torch.Generator().manual_seed(0), "cpu", mesh)
    if dtype == "f32":
        drawn = tree_map(lambda t: t.float(), drawn)
    local = sharding.local_shard(full, specs, mesh)
    out = {"rank": current_world().rank, "split": split,
           "init_equal": all(torch.equal(a, b) for a, b in zip(
               leaves(drawn), leaves(local))),
           "local_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(local)),
           "full_bytes": sum(t.numel() * t.element_size()
                             for t in leaves(full))}
    if dtype == "w8a8":
        qfull = lm_quant.quantize_lm_params(full)
        qspecs = sharding.param_specs(qfull)
        local = sharding.local_shard(qfull, qspecs, mesh)
        qlocal = lm_quant.quantize_lm_params(
            sharding.local_shard(full, specs, mesh))
        # the share of a quantized leaf is the quantized leaf of the share
        # (the head's exponent vector, replicated by its spec, aside)
        lo, hi = api.share(cfg.padded_vocab, mesh.group("model"))
        out["quantized_share_equal"] = all(torch.equal(
            a if a.shape == b.shape else a[lo:hi], b)
            for a, b in zip(leaves(local), leaves(qlocal)))
        seen, undo = record_exponents()
        one = serve(cfg, qfull, data, None, False, B)
        seen_one = list(seen)
        seen.clear()
        tp = serve(cfg, local, data, mesh, split, B)
        undo()
        out["exponents"] = compare_exponents(seen_one, seen, mesh, split)
    else:
        one = serve(cfg, full, data, None, False, B)
        tp = serve(cfg, local, data, mesh, split, B)
        # the train step's loss and gradients, alone and on the mesh
        tb = train_batch(data)
        loss1, _, g1 = TS.loss_and_grads(model, full, tb)
        with mesh, api.rows_split(split):
            losst, _, gt = TS.loss_and_grads(model, local,
                                             rows(tb, mesh, split))
        gathered = sharding.gather_tree(unflatten(local, gt), specs, mesh)
        out["loss"] = (float(loss1), float(losst))
        out["grad_err"] = max(
            float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(leaves(gathered), g1))
        if out["rank"] == 0:
            out["grads"] = [t.float().clone() for t in leaves(gathered)]
    out["prefill"] = (one[0], tp[0], tp[1])
    out["decode"] = [(a, b) for a, b in zip(one[2], tp[2])]
    return out


def tp_checks(cases: list, misc=None) -> dict:
    """cases: [(arch, dtype, data ways, B)].  Every case's results, and
    with `misc` (`misc_checks`' arguments) those checks' too."""
    out = {"rank": current_world().rank,
           "cases": [case(*c) for c in cases]}
    if misc is not None:
        out.update(misc_checks(*misc))
    return out


# ---------------------------------------------------------------------------
# the collectives, the layouts, checkpoints, and the CapsNet paths
# ---------------------------------------------------------------------------
def gradchecks(mesh) -> dict:
    """`torch.autograd.gradcheck` in float64 of the model line's
    Functions, each inside a function whose input is whole on every
    rank of the line (so every rank perturbs the same element):
    copy_to then gather_along of a column-parallel product, reduce_sum
    of rank-weighted copies, and the `partial` gather of a share."""
    g = mesh.group("model")
    r = g.index
    gen = torch.Generator().manual_seed(7)
    w = torch.randn(6, 5, generator=gen, dtype=torch.float64)
    lo, hi = api.share(5, g)
    x = torch.randn(3, 6, generator=gen, dtype=torch.float64,
                    requires_grad=True)

    def product(x):
        y = api.copy_to(x, g) @ w[:, lo:hi]
        return torch.tanh(api.gather_along(y, 5, g))

    def reduced(x):
        return api.reduce_sum(api.copy_to(x, g) * (r + 1.5), g)

    v = torch.randn(3, 6, generator=gen, dtype=torch.float64)

    def partial(x):
        xs = api.copy_to(x, g)
        a, b = api.share(6, g)
        whole = api.gather_along(xs[:, a:b], 6, g, partial=True)
        mine = (whole * v)[:, a:b]           # each rank its own part
        return api.reduce_sum(torch.sin(mine).sum(), g)

    return {name: torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-8)
            for name, fn in (("copy_gather", product), ("reduce", reduced),
                             ("partial_gather", partial))}


LAYOUT_SHAPES = {"a": ((5, 7), (None, "model")),
                 "b": ((3,), (("data", "model"),)),
                 "c": ((6, 5), (("pod", "data"), "model")),
                 "d": ((7, 2), (("data", "model"), None)),
                 "e": ((4, 4), ())}


def layout_round_trip(mesh) -> dict:
    """local_shard then gather_tree of leaves split evenly, unevenly and
    into empty shares: the shares' shapes and the round trip."""
    gen = torch.Generator().manual_seed(3)
    tree = {k: torch.randn(shape, generator=gen)
            for k, (shape, _) in LAYOUT_SHAPES.items()}
    specs = {k: spec for k, (_, spec) in LAYOUT_SHAPES.items()}
    local = sharding.local_shard(tree, specs, mesh)
    back = sharding.gather_tree(local, specs, mesh)
    return {"shapes": {k: tuple(v.shape) for k, v in local.items()},
            "equal": all(torch.equal(back[k], tree[k]) for k in tree)}


def ckpt_checks(ckpt_dir: str, data_ways: int) -> dict:
    """Checkpoints between one process and the mesh, and a fault then a
    resume under the mesh, on qwen3_14b's f32 train state (d 64): the
    one-process save restored into each rank's shares; the meshed save
    (gathered onto rank 0) for the parent to restore; two make_cell
    steps against one step, a save, a restore into fresh shares and one
    step more; the global norm of the gradients on the mesh and alone."""
    import os

    from repro_torch import ckpt
    from repro_torch.optim.adam import global_norm
    cfg = cfg_of("qwen3_14b")
    mesh = world_mesh(data_ways)
    B = 4
    split = sharding.dp_shardable(B, mesh)
    rank = current_world().rank
    full = TS.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    full = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    full)
    shape = tbase.ShapeSpec("t", "train", S, B)
    step, args, in_specs, _ = TS.make_cell(cfg, shape, mesh)
    st_spec = in_specs[0]
    local = sharding.local_shard(full, st_spec, mesh)
    local = tree_map(lambda t: t.clone(), local)
    out = {"rank": rank}
    # one process writes, every rank restores its shares
    one_dir = os.path.join(ckpt_dir, "one")
    if rank == 0:
        ckpt.save(one_dir, 0, full)
    api.barrier(mesh)
    zeros = tree_map(torch.zeros_like, local)
    got = ckpt.restore(one_dir, 0, zeros, specs=st_spec, mesh=mesh)
    out["restored_shares_equal"] = all(torch.equal(a, b) for a, b in zip(
        leaves(got), leaves(local)))
    out["local_structs_match"] = all(
        tuple(a.shape) == tuple(b.shape) for a, b in zip(
            leaves(TS.local_structs(args, in_specs, mesh)[0]),
            leaves(local)))
    # the global norm of this rank's gradient shares, alone and meshed
    data = make_batch(cfg, B)
    tb = train_batch(data)
    model = build_model(cfg)
    _, _, g1 = TS.loss_and_grads(model, full["params"], tb)
    with mesh, api.rows_split(split):
        _, _, gt = TS.loss_and_grads(model, local["params"],
                                     rows(tb, mesh, split))
        out["norm"] = (float(global_norm(g1)),
                       float(global_norm(gt, TS.split_leaves(cfg))))
    # uninterrupted: two steps; interrupted: one, save, restore, one
    batch = rows(tb, mesh, split)
    a = tree_map(lambda t: t.clone(), local)
    for _ in range(2):
        a, m = step(a, batch)
    b = tree_map(lambda t: t.clone(), local)
    b, _ = step(b, batch)
    tp_dir = os.path.join(ckpt_dir, f"tp{data_ways}")
    ckpt.save(tp_dir, 1, b, specs=st_spec, mesh=mesh)
    saved = leaves(sharding.gather_tree(b, st_spec, mesh))
    if rank == 0:
        out["saved"] = [t.clone() for t in saved]
    fresh = tree_map(torch.zeros_like, local)
    b = ckpt.restore(tp_dir, 1, fresh, into=True, specs=st_spec, mesh=mesh)
    b, _ = step(b, batch)
    out["resume_equal"] = all(torch.equal(x, y) for x, y in zip(
        leaves(a), leaves(b)))
    out["loss"] = float(m["loss"])
    # the state after one step, gathered, for the parent's restore
    one = tree_map(lambda t: t.clone(), full)
    one, m1 = TS.make_train_step(cfg)(one, tb)
    out["one_step_loss"] = float(m1["loss"])
    if rank == 0:
        out["one_step"] = [t.clone() for t in leaves(one)]
    return out


def caps_checks(images: dict, xs: list) -> dict:
    """mnist-free CapsNet paths on this world's (data 2, model 2) mesh:
    EDGE_TINY waves at each bucket, a CapsTrainer run, and
    compressed_psum of this rank's x; each beside the no-mesh run."""
    from repro_torch.captrain import CapsTrainer, TrainConfig
    from repro_torch.nn import EDGE_TINY
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.serving import ModelRegistry, default_specs, sharded
    mesh = world_mesh(2)
    reg = ModelRegistry({"e": default_specs()["edge_tiny@torch"]},
                        device="cpu")
    qnet = reg.model("e")
    out = {"rank": current_world().rank, "dp_rank": api.dp_rank(mesh),
           "tp_rank": api.tp_rank(mesh), "waves": {}}
    for b, x in images.items():
        meshed = sharded.compile_wave(qnet, b, mesh, "e")(x)
        alone = sharded.compile_wave(qnet, b)(x)
        out["waves"][b] = all(torch.equal(p, q) for p, q in zip(meshed,
                                                                 alone))
    tc = TrainConfig(dataset="edge_tiny", batch=32, microbatches=8,
                     calib_n=16)
    runs = {}
    for key, m in (("mesh", mesh), ("none", None)):
        t = CapsTrainer(EDGE_TINY, tc, mesh=m, device="cpu")
        s, _, h = t.fit(t.init_state(), 2)
        runs[key] = ([r["loss"] for r in h], leaves(s))
    out["train_equal"] = runs["mesh"][0] == runs["none"][0] and all(
        torch.equal(a, b) for a, b in zip(runs["mesh"][1], runs["none"][1]))
    out["psum"] = compressed_psum(torch.from_numpy(
        xs[current_world().rank]), mesh)
    return out


def misc_checks(ckpt_dir: str, images: dict, xs: list) -> dict:
    """Every check of the (data 2, model 2) world but the LM cases."""
    mesh = world_mesh(2)
    return {"rank": current_world().rank, "gradcheck": gradchecks(mesh),
            "layout": layout_round_trip(mesh),
            "ckpt": ckpt_checks(ckpt_dir, 2),
            "caps": caps_checks(images, xs)}
