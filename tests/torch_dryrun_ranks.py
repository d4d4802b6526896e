"""Rank functions of the multi-card dry-run tests (`test_torch_dryrun_multi`).

Each runs on every rank of a gloo world that `repro_torch.dist.world.spawn`
started on the CPU: it builds the world's (pod 1, data, model) mesh, runs
`launch.steps.make_cell`'s train, prefill and decode steps on CPU tensors
of the rank's shares under an unweighted `OpCounter`, and returns each
step's count: what the dry run's meta count of the same rank, in a fake
world of the same shape (`meta_count`, in a process of its own), must
equal.  This module imports neither JAX nor the reference package, so
the children start without them.
"""
from __future__ import annotations

import torch

from repro_torch.configs import base as tbase
from repro_torch.dist import op_analysis as oa
from repro_torch.dist.api import Mesh
from repro_torch.dist.world import current_world
from repro_torch.launch import steps
from repro_torch.launch.train import reduced
from repro_torch.models import attention, scan_utils, transformer
from repro_torch.optim import adam
from repro_torch.tree import tree_map

S, B = 32, 4
KINDS = ("train", "prefill", "decode")
# the loops that hold collectives at >= 4 trips at S 32 (four cycles of
# layers, the loss's chunks of the split vocabulary), the attention's
# blocks (none) at 2; AdamW's last chunk ragged
CHUNKS = ((attention, "Q_CHUNK", 16), (attention, "KV_CHUNK", 16),
          (transformer, "LOSS_CHUNK", 8), (scan_utils, "SCAN_CHUNK", 8),
          (adam, "UPDATE_CHUNK", 3000))


def short_chunks() -> None:
    """Cut the loops' chunks (in this process, for good)."""
    for mod, name, value in CHUNKS:
        setattr(mod, name, value)


def cell_config(arch: str):
    cfg = tbase.get_config(arch)
    n = len(cfg.blocks)
    return reduced(cfg, d_model=64, layers=4 if n == 1 else n).scaled(
        xlstm_chunk=8)


def layout(size: int, data: int) -> Mesh:
    """The record of the world's (pod 1, data, model = size / data)
    mesh, for the dry run."""
    return Mesh(("pod", "data", "model"), (1, data, size // data),
                [torch.device("meta")] * size)


def filled(tree, seed: int):
    """CPU tensors of the structs' shapes: token ids in [1, 60), small
    floats, step counters 0."""
    g = torch.Generator().manual_seed(seed)

    def fill(t):
        if t.dtype in (torch.int32, torch.int64):
            if t.dim() == 0:
                return torch.zeros((), dtype=t.dtype)
            return torch.randint(1, 60, t.shape, generator=g, dtype=t.dtype)
        return (torch.randn(t.shape, generator=g) * 0.05).to(t.dtype)
    return tree_map(fill, tree)


def summary(cost: oa.OpCost) -> dict:
    return {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "count_by_kind": dict(cost.collective_count_by_kind),
            "bytes_by_kind": dict(cost.collective_bytes_by_kind),
            "bytes_by_fabric": dict(cost.collective_bytes_by_fabric)}


def tiny():
    """qwen3_14b at d 128, a train cell of B 8 x S 64."""
    return (reduced(tbase.get_config("qwen3_14b"), d_model=128),
            tbase.ShapeSpec("tiny_train", "train", 64, 8))


def one_card_record(rec: dict) -> dict:
    return {k: rec[k] for k in ("flops_per_dev", "bytes_per_dev", "memory",
                                "terms", "collectives")}


def count_cells(archs, data: int, fresh: bool = False) -> dict:
    """{(arch, kind): this rank's count of the cell's real step on CPU
    tensors of its shares}; with `fresh`, first the dry run's one-card
    record of `tiny()`, the first cell this process counts
    ("fresh")."""
    out = {}
    if fresh:
        from repro_torch.launch import dryrun
        out["fresh"] = one_card_record(dryrun.analyze_step(*tiny())[0])
    short_chunks()
    torch.set_num_threads(1)
    w = current_world()
    mesh = Mesh(("pod", "data", "model"), (1, data, w.size // data),
                w.devices, world=w)
    for arch in archs:
        cfg = cell_config(arch)
        for kind in KINDS:
            shape = tbase.ShapeSpec("reduced", kind, S, B)
            fn, args, in_specs, _ = steps.make_cell(cfg, shape, mesh)
            args = filled(steps.local_structs(args, in_specs, mesh), 0)
            if kind == "decode":
                args = args[:3] + (S - 1,)
            cost = oa.analyze_ops(fn, *args, track_memory=False).cost
            out[arch, kind] = summary(cost)
    return out


def meta_count(archs, size: int, data: int, rank: int) -> dict:
    """{(arch, kind): the dry run's count of rank `rank`'s step} on a
    fake world of `size` ranks, (pod 1, data, model = size / data), the
    loops' chunks cut as `count_cells` cuts them (in this process, for
    good)."""
    import contextlib
    import io
    from repro_torch.launch import dryrun
    short_chunks()
    out = {}
    for arch in archs:
        for kind in KINDS:
            shape = tbase.ShapeSpec("reduced", kind, S, B)
            with contextlib.redirect_stdout(io.StringIO()):
                _, cost = dryrun.analyze_step(cell_config(arch), shape, "t",
                                              mesh=layout(size, data),
                                              rank=rank)
            out[arch, kind] = summary(cost)
    return out
