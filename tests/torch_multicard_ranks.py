"""Rank functions for the multi-process tests (`test_torch_multicard_*`,
`test_torch_grad_compress`, `test_torch_sharded`).

Each runs on every rank of a gloo world that `repro_torch.dist.world.spawn`
started on the CPU, makes every check of its test module inside that one
world, and returns plain results (CPU tensors, strings) to the parent,
which holds them against the reference.  This module imports neither JAX
nor the reference package, so the children start without them.
"""
from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

from repro_torch import convert
from repro_torch.dist import api
from repro_torch.dist.world import current_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.nn import CIFAR10, EDGE_TINY
from repro_torch.serving import sharded

CONFIGS = {"cifar10": CIFAR10, "edge_tiny": EDGE_TINY}
# the serving mesh: BATCH = (pod, data) takes the ranks
SERVE_AXES = ("pod", "model", "data")


def _wave(qnet, bucket, mesh, x, model_id=None):
    out = sharded.compile_wave(qnet, bucket, mesh, model_id)(x)
    return [t.clone() for t in out]


def serving_checks(nets: dict, waves: list, serve_argv: list) -> dict:
    """nets: {name: (config key, plan json, int8 qweights)} from the
    reference; waves: [(name, bucket, x)].  Returns each wave's outputs
    and this rank's share of its rows, the ValueError of a wave whose
    ranks were bound to different buckets, a wave after it, and
    serve_caps --mesh host's exit code and standard output."""
    world = current_world()
    mesh = make_host_mesh(SERVE_AXES, device="cpu")
    qnets = {name: convert.qnet_from_reference(plan, qw, CONFIGS[cfg],
                                               device="cpu")
             for name, (cfg, plan, qw) in nets.items()}
    out = {"rank": world.rank, "mesh": mesh.tag(),
           "dp_rank": api.dp_rank(mesh), "waves": [], "rows": [],
           "shape": mesh.shape, "dp_size": api.dp_size(mesh)}
    for name, bucket, x in waves:
        out["waves"].append(_wave(qnets[name], bucket, mesh, x, name))
        out["rows"].append(api.split_rows(torch.as_tensor(x), mesh)
                           .shape[0])
    # ranks bound to different buckets: every rank raises, none hangs
    bucket = 3 + world.rank % 2
    shape = (bucket,) + tuple(EDGE_TINY.input_shape)
    try:
        _wave(qnets["edge_tiny"], bucket, mesh, np.zeros(shape, np.float32),
              "edge_tiny")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    # and the world goes on serving in step
    name, bucket, x = waves[-1]
    out["after"] = _wave(qnets[name], bucket, mesh, x, name)
    from repro_torch.launch import serve_caps
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["serve_rc"] = serve_caps.main(serve_argv)
    out["serve_out"] = buf.getvalue()
    return out


def _run_trainer(cfg, tcfg, mesh, float_steps, qat_steps):
    from repro_torch.captrain import CapsTrainer
    t = CapsTrainer(cfg, tcfg, mesh=mesh, device="cpu")
    s = t.init_state()
    s, _, h1 = t.fit(s, float_steps)
    s, plan, h2 = t.fit(s, qat_steps, qat=True)
    return t, s, plan, [h["loss"] for h in h1 + h2], \
        [h["accuracy"] for h in h1 + h2]


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def train_checks(runs: list, ckpt_dir: str) -> dict:
    """runs: [(microbatches, float steps, qat steps)] of the reference
    test's EDGE_TINY recipe.  Returns, for each, the losses, accuracies
    and state of the run split over this world's ranks beside those of
    the no-mesh run in this same process; then a checkpoint written under
    the mesh and what every rank resumes from it."""
    import dataclasses

    from repro_torch.captrain import CapsTrainer, TrainConfig
    world = current_world()
    mesh = make_host_mesh(SERVE_AXES, device="cpu")
    out = {"rank": world.rank, "runs": []}
    for S, nf, nq in runs:
        tc = TrainConfig(dataset="edge_tiny", batch=32, microbatches=S,
                         calib_n=16, lr=3e-3, recalib_every=20)
        row = {}
        for key, m in (("mesh", mesh), ("none", None)):
            _, s, _, losses, accs = _run_trainer(EDGE_TINY, tc, m, nf, nq)
            row[key] = {"losses": losses, "accuracy": accs,
                        "state": _cpu(s)}
        out["runs"].append(row)
    # checkpoints: rank 0 writes, every rank resumes the same bits
    tc = TrainConfig(dataset="edge_tiny", batch=32, microbatches=8,
                     calib_n=16, ckpt_every=2, ckpt_dir=ckpt_dir)
    t = CapsTrainer(EDGE_TINY, tc, mesh=mesh, device="cpu")
    s, _, _ = t.fit(t.init_state(), 2)
    resumed, plan = CapsTrainer(EDGE_TINY, tc, mesh=mesh,
                                device="cpu").resume_or_init()
    out["saved"] = _cpu(s)
    out["resumed"] = _cpu(resumed)
    out["resumed_plan"] = plan
    api.barrier(mesh)
    # the Table-2 harness splits both trainers over the mesh; beside it
    # the one-rank harness in this process
    from repro_torch.captrain.evalq import table2_rows
    tc = dataclasses.replace(tc, ckpt_every=0, ckpt_dir=None)
    for key, m in (("table2", mesh), ("table2_none", None)):
        out[key] = [dataclasses.asdict(r) for r in table2_rows(
            EDGE_TINY, tc, float_steps=2, qat_steps=1, roundings=("floor",),
            eval_n=32, mesh=m, device="cpu")]
    return out


def psum_checks(inputs: list) -> dict:
    """inputs: [[x of rank 0, x of rank 1, ...], ...].  Returns this
    rank's compressed_psum of its x of each, over the default group and
    over the serving mesh."""
    from repro_torch.optim.grad_compress import compressed_psum
    world = current_world()
    mesh = make_host_mesh(SERVE_AXES, device="cpu")
    return {"rank": world.rank,
            "world": [compressed_psum(torch.from_numpy(xs[world.rank]))
                      for xs in inputs],
            "mesh": [compressed_psum(torch.from_numpy(xs[world.rank]), mesh)
                     for xs in inputs]}


def registry_wave(images) -> dict:
    """An EDGE_TINY wave at bucket 4 through a registry that carries the
    serving mesh: its device, and the outputs; then through one that
    carries the default host mesh, whose ranks are on the model axis."""
    from repro_torch.serving import ModelRegistry, default_specs
    out = {}
    for key, axes in (("", SERVE_AXES), ("tp_", ("pod", "data", "model"))):
        mesh = make_host_mesh(axes, device="cpu")
        reg = ModelRegistry({"e": default_specs()["edge_tiny@torch"]},
                            mesh=mesh)
        exe = reg.executable("e", 4)
        out.update({key + "device": str(reg.device),
                    key + "mesh": exe.mesh is mesh,
                    key + "out": [t.clone() for t in exe(images)]})
    out["tp_mesh"] = mesh.shape
    return out


def raise_on(rank: int):
    """Rank `rank` raises; the others wait at a barrier it never joins."""
    import torch.distributed as dist
    if current_world().rank == rank:
        raise KeyError(f"rank {rank} refuses")
    dist.barrier()


def hang_on(rank: int):
    """Rank `rank` stops making calls; the others return at once."""
    import time
    if current_world().rank == rank:
        time.sleep(3600)
    return current_world().rank
