"""Meshes: the counterpart of `repro.launch.mesh`.

`make_host_mesh` is a function, not a module-level constant, so that
importing this module never touches device state.  The counterpart of
the reference's production meshes (a TPU pod of 256 chips, two of 512)
is `make_production_mesh`: one H100, the card a dry run's roofline is
for; the multi-pod mesh raises (ROADMAP Queue A, multi-card).
"""
from __future__ import annotations

import math

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The one-card production mesh, axes (data, model) of size 1 over
    cuda:0 (a record: building it touches no device).  multi_pod=True
    raises NotImplementedError."""
    if multi_pod:
        raise NotImplementedError(
            "a multi-card production mesh is not ported yet (ROADMAP "
            "Queue A, multi-card)")
    return Mesh(("data", "model"), (1, 1), [torch.device("cuda", 0)])


def mesh_chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
