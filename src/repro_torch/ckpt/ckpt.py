"""Fault-tolerant checkpointing: atomic per-step npz snapshots.

Write protocol (restart-safe at any kill point):
  1. serialize the tree to  <dir>/step_<N>.npz.tmp
  2. fsync + os.replace -> <dir>/step_<N>.npz       (atomic on POSIX)
  3. rewrite <dir>/LATEST (tmp + replace) with N
A crash mid-write leaves only a .tmp file that restore ignores; LATEST
always points at a fully written snapshot.  Resume = restore_latest().

A snapshot's keys are the tree's paths joined by "/" in sorted key order
(`params/caps/conv0/w`, `opt/step`), exactly as the reference package
writes them, so a checkpoint written by either package restores in the
other.  Batches are pure functions of the step index
(`repro_torch.data.synthetic.ImageTask`), so no data-pipeline state is
saved.
"""
from __future__ import annotations

import io
import os
import pathlib
import re

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths


def _flatten(tree) -> dict:
    flat = {}
    for key, leaf in leaves_with_paths(tree):
        t = torch.as_tensor(leaf).detach()
        # np.savez cannot store bfloat16; store it as float32 (restore
        # casts back to the example leaf's dtype, exactly)
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        flat[key] = t.cpu().numpy()
    return flat


def save(ckpt_dir, step: int, tree) -> str:
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"step_{step:08d}.npz"
    tmp = d / f"step_{step:08d}.npz.tmp"
    buf = io.BytesIO()
    np.savez(buf, **_flatten(tree))
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
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


def restore(ckpt_dir, step: int, example_tree):
    """The snapshot in the structure of `example_tree`: each leaf takes
    the dtype and the device of the example's leaf at its path."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}.npz"
    with np.load(path) as data:
        flat = dict(data)

    def load(tree, key: str):
        if isinstance(tree, dict):
            return {k: load(v, f"{key}/{k}" if key else str(k))
                    for k, v in tree.items()}
        return torch.from_numpy(np.array(flat[key])).to(
            device=tree.device, dtype=tree.dtype)
    return load(example_tree, "")


def restore_latest(ckpt_dir, example_tree):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, example_tree)


def gc_keep_n(ckpt_dir, keep: int = 3):
    """Delete all but the newest `keep` snapshots, and every .tmp."""
    d = pathlib.Path(ckpt_dir)
    snaps = sorted(d.glob("step_*.npz"))
    for p in snaps[:-keep] if keep > 0 else []:
        p.unlink(missing_ok=True)
    for p in d.glob("*.tmp"):
        p.unlink(missing_ok=True)
