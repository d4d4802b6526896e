"""Fault-tolerant checkpointing: atomic per-step npz snapshots.

Write protocol (restart-safe at any kill point):
  1. serialize the tree to  <dir>/step_<N>.npz.tmp
  2. fsync + os.replace -> <dir>/step_<N>.npz       (atomic on POSIX)
  3. rewrite <dir>/LATEST (tmp + replace) with N
A crash mid-write leaves only a .tmp file that restore ignores; LATEST
always points at a fully written snapshot.  Resume = restore_latest().

A snapshot's keys are the tree's paths joined by "/" in flattening
order (`params/caps/conv0/w`, `opt/step`, `params/blocks/0/attn/wq`:
dict keys sorted, tuple indices in order), exactly as the reference package
writes them, so a checkpoint written by either package restores in the
other.  Batches are pure functions of the step index
(`repro_torch.data.synthetic.ImageTask`, `TokenTask`), so no
data-pipeline state is saved.

A tree laid out over a mesh (`dist.sharding.local_shard` by its specs)
is saved as full leaves, each gathered onto every rank
(`sharding.gather_leaf`) and written by rank 0 alone, into the files a
one-process run writes, as the reference's `_host_array` gathers a
sharded array; `restore` under a mesh reads each full leaf and keeps
this rank's share.  A checkpoint moves between one process and any mesh
bit for bit.
"""
from __future__ import annotations

import os
import pathlib
import re
import zipfile

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, unflatten


def _host_array(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach()
    # np.savez cannot store bfloat16; store it as float32 (restore casts
    # back to the example leaf's dtype, exactly)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _sharded(specs, mesh) -> bool:
    return specs is not None and mesh is not None and mesh.size > 1


def save(ckpt_dir, step: int, tree, specs=None, mesh=None) -> str:
    """Write the snapshot of `step`.  The file is the `.npz` that
    `np.savez` writes (one stored `<path>.npy` member per leaf), written
    one leaf at a time, so the host holds one leaf's copy at most.
    Under `mesh`, `tree` holds this rank's shares by the spec tree
    `specs`: every rank gathers each leaf in turn, rank 0 writes it, and
    the ranks meet at a barrier once the file is published."""
    from repro_torch.dist import api, sharding
    d = pathlib.Path(ckpt_dir)
    path = d / f"step_{step:08d}.npz"
    tmp = d / f"step_{step:08d}.npz.tmp"
    items = leaves_with_paths(tree)
    if _sharded(specs, mesh):
        items = [(key, sharding.gather_leaf(leaf, spec, mesh))
                 for (key, leaf), spec in zip(
                     items, sharding.flat_specs(tree, specs))]
        writer = api.world_rank(mesh) == 0
    else:
        writer = True
    if writer:
        d.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for key, leaf in items:
                    with zf.open(key + ".npy", "w",
                                 force_zip64=True) as member:
                        np.lib.format.write_array(member, _host_array(leaf),
                                                  allow_pickle=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        ltmp = d / "LATEST.tmp"
        ltmp.write_text(str(step))
        os.replace(ltmp, d / "LATEST")
    if _sharded(specs, mesh):
        api.barrier(mesh)
    return str(path)


def latest_step(ckpt_dir) -> int | None:
    d = pathlib.Path(ckpt_dir)
    marker = d / "LATEST"
    if marker.exists():
        try:
            step = int(marker.read_text().strip())
            if (d / f"step_{step:08d}.npz").exists():
                return step
        except ValueError:
            pass
    # fall back to scanning (LATEST lost but snapshots intact)
    best = None
    for p in d.glob("step_*.npz"):
        m = re.match(r"step_(\d+)\.npz$", p.name)
        if m:
            best = max(best or 0, int(m.group(1)))
    return best


def restore(ckpt_dir, step: int, example_tree, into: bool = False,
            specs=None, mesh=None):
    """The snapshot in the structure of `example_tree`: each leaf takes
    the dtype and the device of the example's leaf at its path.  With
    into=True each leaf is copied into the example's own tensor, which
    is returned, so no second copy of the tree is made on its device.
    Leaves are read one at a time.  Under `mesh` the example holds this
    rank's shares by `specs`, and each full leaf read is cut to them
    (`sharding.local_shard`)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}.npz"
    cut = {}
    if _sharded(specs, mesh):
        from repro_torch.dist import sharding
        cut = dict(zip((k for k, _ in leaves_with_paths(example_tree)),
                       sharding.flat_specs(example_tree, specs)))
    with np.load(path) as data:
        def load(key, leaf):
            got = torch.from_numpy(data[key])
            if key in cut:
                got = sharding.local_shard(got, cut[key], mesh)
            if into:
                return leaf.copy_(got)
            return got.to(device=leaf.device, dtype=leaf.dtype)
        got = [load(k, leaf) for k, leaf in leaves_with_paths(example_tree)]
    return example_tree if into else unflatten(example_tree, got)


def restore_latest(ckpt_dir, example_tree, into: bool = False,
                   specs=None, mesh=None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, example_tree, into, specs, mesh)


def gc_keep_n(ckpt_dir, keep: int = 3):
    """Delete all but the newest `keep` snapshots, and every .tmp."""
    d = pathlib.Path(ckpt_dir)
    snaps = sorted(d.glob("step_*.npz"))
    for p in snaps[:-keep] if keep > 0 else []:
        p.unlink(missing_ok=True)
    for p in d.glob("*.tmp"):
        p.unlink(missing_ok=True)
