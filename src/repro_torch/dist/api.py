"""Logical sharding axes and mesh-aware helpers, for one device.

The counterpart of `repro.dist.api`.  Models and serving waves speak in
LOGICAL axes — `BATCH` (data parallel, spanning the pod and data mesh
axes) and `SEQ` (sequence parallel over the model axis) — and `fspec`
filters a logical spec down to the axes a mesh has, as the reference's
does before it builds a `PartitionSpec`.

A `Mesh` here is a record of axis names, their sizes and the devices,
made active with `with mesh:` as in the reference.  On one device every
constraint is the identity, so `shard` returns its input unchanged (the
tensor itself, no copy); a mesh of more than one device raises
NotImplementedError wherever it is used, since splitting work across
cards is not ported (ROADMAP Queue A): it never quietly runs on one card.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

# logical axes: data parallelism spans pod x data; sequence parallelism
# reuses the model axis
BATCH = ("pod", "data")
SEQ = "model"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


class Mesh:
    """Axis names over a grid of devices, `devices` flat in row-major
    order of `sizes`.  `shape` is {name: size}, as the reference mesh's."""

    def __init__(self, axis_names, sizes, devices):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        self.devices = tuple(devices)
        if len(self.axis_names) != len(self.sizes) or \
                math.prod(self.sizes) != len(self.devices):
            raise ValueError(f"mesh axes {self.axis_names} of sizes "
                             f"{self.sizes} over {len(self.devices)} "
                             "devices")
        self._tokens: list = []

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __enter__(self):
        require_one_device(self)
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(map(str, self.devices))})"


def require_one_device(mesh) -> None:
    """Raise NotImplementedError for a mesh of more than one device."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices {mesh.shape}: sharding across "
            "devices is not ported yet (ROADMAP Queue A, multi-card "
            "meshes); use one device or no mesh")


def use_mesh(mesh):
    """`with use_mesh(mesh):` activates `mesh`, or nothing when None."""
    return contextlib.nullcontext() if mesh is None else mesh


def current_mesh() -> Mesh | None:
    """The mesh of the innermost `with mesh:` context, or None."""
    return _ACTIVE.get()


def dp_size(mesh) -> int:
    """Total data-parallel ways (product of the BATCH axes present)."""
    if mesh is None:
        return 1
    shape = mesh.shape
    return math.prod(shape[a] for a in BATCH if a in shape)


def fspec(mesh, *axes) -> tuple:
    """Filter a logical spec down to the axes `mesh` actually has: the
    tuple the reference's `PartitionSpec` holds.

    Each entry is None, an axis name, or a tuple of axis names; names not
    in `mesh.axis_names` are dropped.  A tuple that filters down to one
    name collapses to the bare name, and to None when nothing survives.
    """
    names = set(mesh.axis_names)
    out = []
    for ax in axes:
        if ax is None:
            out.append(None)
        elif isinstance(ax, (tuple, list)):
            kept = tuple(a for a in ax if a in names)
            out.append(kept[0] if len(kept) == 1 else (kept or None))
        else:
            out.append(ax if ax in names else None)
    return tuple(out)


def shard(x, *axes):
    """The sharding constraint `axes` on `x` under the active mesh: the
    identity with no mesh or a mesh of one device (returns `x` itself)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    require_one_device(mesh)
    return x
