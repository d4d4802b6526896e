"""Logical sharding axes, meshes, and the data-parallel collectives.

The counterpart of `repro.dist.api`.  Models and serving waves speak in
LOGICAL axes — `BATCH` (data parallel, spanning the pod and data mesh
axes) and `SEQ` (sequence parallel over the model axis) — and `fspec`
filters a logical spec down to the axes a mesh has, as the reference's
does before it builds a `PartitionSpec`.

A `Mesh` is a record of axis names, their sizes and the devices, made
active with `with mesh:` as in the reference.  Over a live
`torch.distributed` world (`dist.world`) its devices are the ranks'
devices in rank order, and each rank holds only its own rows: where the
reference's GSPMD splits a BATCH axis, the port splits explicitly
(`split_rows`: contiguous shares in rank order, uneven or empty where
the rows do not divide) and gathers explicitly (`gather_rows`), so the
result equals the unsharded one whatever the number of ranks.  `shard`
is the identity on the local view.  Data parallelism is what is ported:
a mesh whose `model` axis is larger than 1 (tensor parallelism) raises
NotImplementedError (ROADMAP Queue A, multi-card), and a mesh of more
than one device with no world behind it cannot run a collective, so
splitting rows over it raises ValueError.

Every collective goes through `collective`, over the world's default
group: every axis but the BATCH axes is 1, so the ranks that split the
BATCH axes are the whole world.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

# logical axes: data parallelism spans pod x data; sequence parallelism
# reuses the model axis
BATCH = ("pod", "data")
SEQ = "model"

MULTI_CARD = "ROADMAP Queue A, multi-card"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


class Mesh:
    """Axis names over a grid of devices, `devices` flat in row-major
    order of `sizes`.  `shape` is {name: size}, as the reference mesh's.

    `world` is the live `dist.world.World` the mesh spans, or None for a
    record of devices (one device, or the specs of a larger layout).  A
    mesh over a world covers every rank and is data parallel, so its
    collectives run over the world's default group."""

    def __init__(self, axis_names, sizes, devices, world=None):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.axis_names) != len(self.sizes) or \
                math.prod(self.sizes) != len(self.devices):
            raise ValueError(f"mesh axes {self.axis_names} of sizes "
                             f"{self.sizes} over {len(self.devices)} "
                             "devices")
        self.world = world
        self._tokens: list = []
        if world is not None:
            if world.size != self.size or world.devices != self.devices:
                raise ValueError(
                    f"mesh {self.shape} over {len(self.devices)} devices "
                    f"does not cover the world of {world.size} ranks "
                    f"{list(map(str, world.devices))}")
            require_data_parallel(self)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This rank's device (the one device of a mesh of one)."""
        if self.world is not None:
            return self.world.device
        if self.size == 1:
            return self.devices[0]
        raise ValueError(f"a mesh of {self.size} devices has no device of "
                         "this process without a world")

    def __enter__(self):
        require_data_parallel(self)
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())

    def __repr__(self) -> str:
        w = "" if self.world is None else f", world={self.world.tag()}"
        return (f"Mesh({self.shape}, devices={list(map(str, self.devices))}"
                f"{w})")

    def tag(self) -> str:
        """What serving prints: the shape, and the world's if any."""
        if self.world is None:
            return str(self.shape)
        return f"{self.shape} over {self.world.tag()}"


def require_data_parallel(mesh) -> None:
    """Raise NotImplementedError for a mesh that splits an axis other
    than the BATCH axes over more than one device (the `model` axis:
    tensor parallelism is not ported)."""
    if mesh is None:
        return
    for name, size in mesh.shape.items():
        if name not in BATCH and size > 1:
            raise NotImplementedError(
                f"a mesh {mesh.shape} splits the {name} axis over {size} "
                f"devices: tensor parallelism is not ported yet "
                f"({MULTI_CARD} meshes); put the devices on the BATCH "
                "axes (pod, data)")


def rank_device(mesh, device=None):
    """Where this process computes: `device`, or under a mesh over a
    world this rank's device (a `device` of another type raises)."""
    if mesh is None or mesh.world is None:
        return device
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"asked for {device}, but this rank's mesh device "
                         f"is {mesh.device}")
    return mesh.device


def _local(mesh) -> bool:
    """Whether `mesh` computes with no collective: no mesh, or a record
    of one device with no world behind it (a world's mesh, even of one
    rank, goes through its process group)."""
    return mesh is None or (mesh.world is None and mesh.size == 1)


def require_world(mesh) -> None:
    """Raise ValueError unless `mesh` spans a live world."""
    if mesh.world is None:
        raise ValueError(
            f"a mesh of {mesh.size} devices runs only inside a "
            "torch.distributed world of as many ranks: launch under "
            "`torchrun --nproc-per-node N` (dist.world.init_world) or "
            "dist.world.spawn")


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


def dp_rank(mesh) -> int:
    """This rank's index among the data-parallel ways: its rank, every
    axis but the BATCH axes being 1; 0 with no mesh or a mesh of one
    device."""
    if _local(mesh):
        return 0
    require_data_parallel(mesh)
    require_world(mesh)
    return mesh.world.rank


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
    identity on the local view (returns `x` itself), since each rank
    already holds its own rows; a tensor-parallel mesh raises."""
    require_data_parallel(current_mesh())
    return x


# ---------------------------------------------------------------------------
# rows over the data-parallel ranks
# ---------------------------------------------------------------------------
def row_share(n: int, ways: int, index: int) -> tuple:
    """[lo, hi) of `index`'s contiguous share of n rows over `ways`: the
    first n % ways shares take one row more (some may be empty)."""
    base, extra = divmod(n, ways)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def split_rows(x, mesh):
    """This rank's contiguous share of x's rows (a view); all of x with
    no mesh or a mesh of one device and no world."""
    if _local(mesh):
        return x
    require_data_parallel(mesh)
    lo, hi = row_share(x.shape[0], dp_size(mesh), dp_rank(mesh))
    return x[lo:hi]


def gather_rows(y, mesh, n: int):
    """The n rows whose `row_share`s the ranks hold, in rank order, on
    every rank (`gather_shares`).  `y` itself with no mesh or a mesh of
    one device and no world."""
    if _local(mesh):
        return y
    ways = dp_size(mesh)
    return gather_shares(y, mesh, [hi - lo for lo, hi in (
        row_share(n, ways, r) for r in range(ways))])


def gather_shares(y, mesh, sizes):
    """Every rank's rows, rank r holding sizes[r] of them, concatenated
    in rank order on every rank: each share is padded to the largest for
    `all_gather`, then trimmed.  `y` itself with no mesh or a mesh of
    one device and no world."""
    if _local(mesh):
        return y
    require_data_parallel(mesh)
    mine = sizes[dp_rank(mesh)]
    if y.shape[0] != mine:
        raise ValueError(f"rank holds {y.shape[0]} rows, its share is "
                         f"{mine} of {list(sizes)}")
    top = max(sizes)
    pad = y
    if mine != top:
        pad = y.new_zeros((top,) + tuple(y.shape[1:]))
        pad[:mine] = y
    parts = _collective("all_gather", pad, mesh)
    return torch.cat([p[:k] for p, k in zip(parts, sizes)])


def all_reduce(t, mesh, op: str = "sum"):
    """The elementwise sum ("sum") or minimum ("min") of `t` over the
    BATCH group, as a new tensor on t's device; `t` with no world."""
    if _local(mesh):
        return t
    return _collective(op, t, mesh)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh's world (a no-op without one)."""
    if mesh is not None and mesh.world is not None:
        import torch.distributed as dist
        dist.barrier()


def agree(mesh, what: str, key: tuple) -> None:
    """Check that every rank passes the same `key` (a short tuple): one
    small all_gather of its repr; a mismatch raises ValueError naming
    this rank's key and the first that differs, on every rank."""
    if _local(mesh):
        return
    mine = repr(key).encode()[:_KEY_BYTES].ljust(_KEY_BYTES, b"\0")
    for r, row in enumerate(_collective(
            "all_gather", torch.tensor(list(mine), dtype=torch.uint8),
            mesh)):
        theirs = bytes(row.tolist())
        if theirs != mine:
            text = theirs.rstrip(b"\0").decode(errors="replace")
            raise ValueError(
                f"{what}: ranks disagree: rank {mesh.world.rank} has {key}, "
                f"rank {r} has {text} (their queues diverged)")


_KEY_BYTES = 256


def _collective(kind: str, t, mesh):
    require_data_parallel(mesh)
    require_world(mesh)
    return collective(kind, t)


def collective(kind: str, t, group=None):
    """The one collective helper: "all_gather" returns the list of every
    rank's `t` (same shape) in rank order; "sum" / "min" an all_reduce
    of a copy of `t`; both over `group` (default: the whole world) and
    on t's device.  NCCL takes the tensor on the rank's card, gloo where
    it lies."""
    import torch.distributed as dist
    home = t.device
    if dist.get_backend(group) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if kind == "all_gather":
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return [p.to(home) for p in parts]
    out = t.clone()
    op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[kind]
    dist.all_reduce(out, op=op, group=group)
    return out.to(home)
