"""Meshes: the counterpart of `repro.launch.mesh`.

`make_host_mesh` is a function, not a module-level constant, so that
importing this module never touches device state.  Inside a
`torch.distributed` world (`dist.world.init_world`, as under `torchrun`)
it is a mesh over the world's ranks, one device each, all on the last
axis, as the reference fills its last axis with the local devices: with
the default axes, a tensor-parallel mesh (model = the world).
Outside one it covers one device: a process drives one card, so more
than one visible card raises and asks for `torchrun`.  The counterpart of
the reference's production meshes (a TPU pod of 256 chips, two of 512)
is `make_production_mesh`: one H100, the card a dry run's roofline is
for; the multi-pod mesh raises (`api.MULTI_CARD`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.api import MULTI_CARD, Mesh
from repro_torch.dist.world import current_world


def make_host_mesh(axes=("pod", "data", "model"), device=None) -> Mesh:
    """Every axis 1 but the last, which holds the devices, as in the
    reference.  Inside a world: the ranks' devices, in rank order (a
    `device` of another type than the world's raises).  Outside one:
    the one device of `device`'s type (the CUDA card by default, raising
    without one); more than one visible card raises ValueError, since a
    process drives one card and the others would sit idle."""
    sizes = [1] * len(axes)
    world = current_world()
    if world is not None:
        if device is not None and \
                torch.device(device).type != world.device.type:
            raise ValueError(f"a mesh on {device} inside a world of "
                             f"{world.device.type} ranks")
        sizes[-1] = world.size
        return Mesh(axes, sizes, world.devices, world=world)
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        raise ValueError(
            f"{torch.cuda.device_count()} cards are visible and one process "
            "drives one of them: launch under `torchrun --nproc-per-node "
            f"{torch.cuda.device_count()}` for a mesh over all of them, or "
            "set CUDA_VISIBLE_DEVICES to one card")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return Mesh(axes, sizes, [device])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The one-card production mesh, axes (data, model) of size 1 over
    cuda:0 (a record: building it touches no device).  multi_pod=True
    raises NotImplementedError."""
    if multi_pod:
        raise NotImplementedError(
            f"a multi-card production mesh is not ported yet ({MULTI_CARD})")
    return Mesh(("data", "model"), (1, 1), [torch.device("cuda", 0)])


def mesh_chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
