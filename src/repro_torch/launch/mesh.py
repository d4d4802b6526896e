"""Mesh builders: the counterpart of `repro.launch.mesh`'s host mesh.

`make_host_mesh` is a function, not a module-level constant, so that
importing this module never touches device state.  The reference's
production meshes (TPU pods of 256 and 512 chips) have no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.api import Mesh


def make_host_mesh(axes=("pod", "data", "model"), device=None) -> Mesh:
    """A mesh over the local devices of `device`'s type (the CUDA cards
    by default, raising without one; one device for "cpu"): every axis 1
    but the last, which holds all of them, as in the reference."""
    device = resolve_device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    sizes = [1] * len(axes)
    sizes[-1] = len(devices)
    return Mesh(axes, sizes, devices)
