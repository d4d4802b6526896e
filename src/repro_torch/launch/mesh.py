"""Meshes: the counterpart of `repro.launch.mesh`.

`make_host_mesh` is a function, not a module-level constant, so that
importing this module never touches device state.  Inside a
`torch.distributed` world (`dist.world.init_world`, as under `torchrun`)
it is a mesh over the world's ranks, one device each, all on the last
axis, as the reference fills its last axis with the local devices: with
the default axes, a tensor-parallel mesh (model = the world).
Outside one it covers one device: a process drives one card, so more
than one visible card raises and asks for `torchrun`.

`make_production_mesh` gives the counterparts of the reference's
production meshes, as records (building one touches no device; a dry
run lays a live mesh of the same axes over `dist.world.fake_world`):

  single  (data 1, model 1) over cuda:0: the one card whose measured
          steps the dry run's bounds are held against.  The reference's
          is one TPU pod of 256 chips; the port keeps one card, the
          unit it measures.
  multi   (pod 2, data 32, model 8): the reference's (pod 2, data 16,
          model 16) of 512 chips with its axes and its 512 devices, so
          that the job's model flops per card are the reference's.  The
          reference puts the model axis, whose activation collectives
          come in every layer, inside a pod's torus; the H100's fastest
          fabric is one node's NVLink of CARDS_PER_NODE = 8 cards, so
          the model axis is 8 and lies within a node.  Row-major with
          model fastest, ranks 8n .. 8n + 7 are node n: 64 HGX H100
          nodes, a pod of 256 cards being one DGX SuperPOD scalable
          unit of 32 nodes.  The data and pod lines cross nodes over
          InfiniBand (NDR, 400 Gb/s a card).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.api import Mesh
from repro_torch.dist.world import CARDS_PER_NODE, current_world

MULTI_POD = (2, 32, CARDS_PER_NODE)          # (pod, data, model)


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
    """The production mesh's record (see the module docstring): one card,
    axes (data, model) of size 1 over cuda:0; with multi_pod, (pod 2,
    data 32, model 8) over 512 cards, rank r on card r % 8 of node
    r // 8."""
    if multi_pod:
        n = math.prod(MULTI_POD)
        return Mesh(("pod", "data", "model"), MULTI_POD,
                    [torch.device("cuda", r % CARDS_PER_NODE)
                     for r in range(n)])
    return Mesh(("data", "model"), (1, 1), [torch.device("cuda", 0)])


def mesh_chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
