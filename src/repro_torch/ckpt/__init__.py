"""Atomic npz checkpoints of nested dicts of tensors (the reference's
`repro.ckpt`), in the reference's file format."""
from repro_torch.ckpt.ckpt import (  # noqa: F401
    gc_keep_n, latest_step, restore, restore_latest, save)
