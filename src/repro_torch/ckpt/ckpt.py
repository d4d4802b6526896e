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


def save(ckpt_dir, step: int, tree) -> str:
    """Write the snapshot of `step`.  The file is the `.npz` that
    `np.savez` writes (one stored `<path>.npy` member per leaf), written
    one leaf at a time, so the host holds one leaf's copy at most."""
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"step_{step:08d}.npz"
    tmp = d / f"step_{step:08d}.npz.tmp"
    with open(tmp, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in leaves_with_paths(tree):
                with zf.open(key + ".npy", "w", force_zip64=True) as member:
                    np.lib.format.write_array(member, _host_array(leaf),
                                              allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    ltmp = d / "LATEST.tmp"
    ltmp.write_text(str(step))
    os.replace(ltmp, d / "LATEST")
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


def restore(ckpt_dir, step: int, example_tree, into: bool = False):
    """The snapshot in the structure of `example_tree`: each leaf takes
    the dtype and the device of the example's leaf at its path.  With
    into=True each leaf is copied into the example's own tensor, which
    is returned, so no second copy of the tree is made on its device.
    Leaves are read one at a time."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}.npz"
    with np.load(path) as data:
        def load(key, leaf):
            got = torch.from_numpy(data[key])
            if into:
                return leaf.copy_(got)
            return got.to(device=leaf.device, dtype=leaf.dtype)
        got = [load(k, leaf) for k, leaf in leaves_with_paths(example_tree)]
    return example_tree if into else unflatten(example_tree, got)


def restore_latest(ckpt_dir, example_tree, into: bool = False):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, example_tree, into)


def gc_keep_n(ckpt_dir, keep: int = 3):
    """Delete all but the newest `keep` snapshots, and every .tmp."""
    d = pathlib.Path(ckpt_dir)
    snaps = sorted(d.glob("step_*.npz"))
    for p in snaps[:-keep] if keep > 0 else []:
        p.unlink(missing_ok=True)
    for p in d.glob("*.tmp"):
        p.unlink(missing_ok=True)
