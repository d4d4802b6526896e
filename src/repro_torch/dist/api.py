"""Logical sharding axes, meshes, their process groups, and the
collectives of data and tensor parallelism.

The counterpart of `repro.dist.api`.  Models and serving waves speak in
LOGICAL axes — `BATCH` (data parallel, spanning the pod and data mesh
axes) and `SEQ` (sequence parallel over the model axis) — and `fspec`
filters a logical spec down to the axes a mesh has, as the reference's
does before it builds a `PartitionSpec`.

A `Mesh` is a record of axis names, their sizes and the devices, made
active with `with mesh:` as in the reference.  Over a live
`torch.distributed` world (`dist.world`) its devices are the ranks'
devices in rank order, row-major over the axes (with the default (pod,
data, model) the model axis varies fastest), and the mesh knows this
rank's coordinates.  It builds, at construction and in the same order on
every rank, one process group per line of the `model` axis, one per
line of the BATCH axes and one per line of ("data", "model") (the
decode cache's sequence axes when the batch does not shard): only where
the line is longer than 1 and shorter than the world, the default group
otherwise.  Where the reference's GSPMD lays a tensor out, the port does
so explicitly: rows over BATCH with `split_rows` (contiguous shares in
rank order, uneven or empty where the rows do not divide) and
`gather_rows`, and the model axis through the autograd Functions of this
module (`copy_to`, `gather_along`, `reduce_sum`: Megatron's pair and
the sum of a split reduction), which the models call at their shard
sites.  `shard` stays the identity on the local view.  A mesh of more
than one device with no world behind it cannot run a collective, so
splitting rows over it raises ValueError.

Every collective goes through `collective`, over a `Group` (the ranks of
one line of some axes) or the world's default group.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch

# logical axes: data parallelism spans pod x data; sequence parallelism
# reuses the model axis
BATCH = ("pod", "data")
SEQ = "model"
MODEL = ("model",)
# the decode cache's sequence axes when the batch does not shard
SEQ_WIDE = ("data", "model")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
# whether the rows of the running step are split over BATCH
_ROWS_SPLIT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_rows_split", default=False)
# the whole lengths of the split axes the running step asks its ranks
# for (`whole_sizes`), where the caller knows them
_KNOWN_SIZES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_known_sizes", default=None)


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks of this rank's line of some mesh axes.  `handle` is the
    process group (None: the world's default group); `index` is this
    rank's index on the line, row-major over the axes in the mesh's
    order; `order[i]` is the index of the line's i-th rank in ascending
    global rank (the order a collective returns)."""
    axes: tuple
    handle: object
    size: int
    index: int
    order: tuple


def _unravel(i: int, sizes) -> tuple:
    out = []
    for s in reversed(sizes):
        i, r = divmod(i, s)
        out.append(r)
    return tuple(reversed(out))


class Mesh:
    """Axis names over a grid of devices, `devices` flat in row-major
    order of `sizes`.  `shape` is {name: size}, as the reference mesh's.

    `world` is the live `dist.world.World` the mesh spans, or None for a
    record of devices (one device, or the specs of a larger layout).  A
    mesh over a world builds its groups (`group`) when it is made, so
    every rank must make it, in the same order."""

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
        self._groups: dict = {}
        self.coords = None
        if world is not None:
            if world.size != self.size or world.devices != self.devices:
                raise ValueError(
                    f"mesh {self.shape} over {len(self.devices)} devices "
                    f"does not cover the world of {world.size} ranks "
                    f"{list(map(str, world.devices))}")
            self.coords = dict(zip(self.axis_names,
                                   _unravel(world.rank, self.sizes)))
            for axes in (MODEL, BATCH, SEQ_WIDE):
                self._build(self._live(axes))

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

    def _live(self, axes) -> tuple:
        """`axes` (a name or a tuple) cut to the mesh's axes above 1, in
        the mesh's order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def _build(self, axes: tuple) -> None:
        """Make the groups of every line of `axes` (each rank makes every
        group, in the same order) and keep this rank's."""
        if not axes or axes in self._groups:
            return
        key = (self.axis_names, self.sizes, axes)
        cache = self.world.groups
        if key not in cache:
            import torch.distributed as dist
            names = self.axis_names
            lines = {}
            for r in range(self.size):
                c = dict(zip(names, _unravel(r, self.sizes)))
                rest = tuple(c[a] for a in names if a not in axes)
                on = 0
                for a in axes:
                    on = on * self.shape[a] + c[a]
                lines.setdefault(rest, []).append((r, on))
            mine = None
            for rest, members in sorted(lines.items()):
                ranks = [r for r, _ in members]
                if len(ranks) == self.size:
                    handle = None
                else:
                    handle = dist.new_group(ranks)
                if self.world.rank in ranks:
                    mine = Group(axes, handle, len(ranks),
                                 dict(members)[self.world.rank],
                                 tuple(on for _, on in members))
            cache[key] = mine
        self._groups[axes] = cache[key]

    def group(self, axes) -> Group | None:
        """This rank's `Group` on `axes` (a name or a tuple of names),
        None where those axes hold one device (nothing to reduce)."""
        live = self._live(axes)
        if not live:
            return None
        require_world(self)
        if live not in self._groups:
            raise ValueError(f"no group on {live}: a mesh builds those of "
                             f"{MODEL}, {BATCH} and {SEQ_WIDE}")
        return self._groups[live]

    def index(self, axes) -> int:
        """This rank's index on its line of `axes` (0 where they hold one
        device)."""
        g = self.group(axes)
        return 0 if g is None else g.index

    def ways(self, axes) -> int:
        """The number of devices on a line of `axes`."""
        return math.prod(self.shape[a] for a in self._live(axes))

    def __enter__(self):
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
    """This rank's index among the data-parallel ways (its line of the
    BATCH axes); 0 with no mesh or a mesh of one device."""
    if _local(mesh) or dp_size(mesh) == 1:
        return 0
    return mesh.index(BATCH)


def tp_size(mesh) -> int:
    """The model axis's size (1 with no mesh or no such axis)."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


def tp_rank(mesh) -> int:
    """This rank's index on the model axis (0 with no mesh)."""
    if _local(mesh) or tp_size(mesh) == 1:
        return 0
    return mesh.index(MODEL)


def world_rank(mesh) -> int:
    """This rank's rank in the mesh's world (0 without one)."""
    return 0 if mesh is None or mesh.world is None else mesh.world.rank


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
    already holds its own share; the models lay tensors out explicitly
    (`copy_to`, `gather_along`)."""
    return x


# ---------------------------------------------------------------------------
# the running step's layout: rows over BATCH, the model axis
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def rows_split(split: bool):
    """For the duration, whether the running step's rows are split over
    the BATCH axes of the active mesh (its batch divides them) or whole
    on every rank."""
    token = _ROWS_SPLIT.set(bool(split))
    try:
        yield
    finally:
        _ROWS_SPLIT.reset(token)


@contextlib.contextmanager
def known_sizes(sizes):
    """For the duration, the whole lengths `whole_sizes` gives under a
    process group that moves no values (`dist.world.fake_world`): the
    caller that laid the step's tensors out knows them."""
    token = _KNOWN_SIZES.set(None if sizes is None else tuple(sizes))
    try:
        yield
    finally:
        _KNOWN_SIZES.reset(token)


def whole_sizes(sizes, group: Group) -> list:
    """The whole lengths of axes of which the ranks of `group` hold
    `row_share`s, this rank `sizes` of them: one all-reduce of the
    sizes.  Under the fake backend, whose collectives move nothing, the
    all-reduce and its read-back are made all the same (a dry run counts
    them) and the lengths are `known_sizes`'s, each of whose shares on
    this rank must be its size (ValueError otherwise)."""
    import torch.distributed as dist
    summed = [int(n) for n in collective(
        "sum", torch.tensor(sizes, dtype=torch.int64), group.handle)]
    if dist.get_backend(group.handle) != "fake":
        return summed
    known = _KNOWN_SIZES.get()
    if known is None or len(known) != len(sizes) or any(
            shares(n, group)[group.index] != k
            for n, k in zip(known, sizes)):
        raise ValueError(
            f"a fake process group moves no values: the whole lengths of "
            f"this rank's shares {list(sizes)} on a line of {group.size} "
            f"must be given by known_sizes (given {known})")
    return list(known)


def model_group() -> Group | None:
    """The active mesh's model line, None when it holds one device (no
    mesh, or model 1): the models' tensor-parallel switch."""
    mesh = current_mesh()
    if mesh is None or tp_size(mesh) == 1:
        return None
    return mesh.group(MODEL)


def rows_group() -> Group | None:
    """The active mesh's BATCH line when the running step's rows are
    split over it (`rows_split`), else None."""
    mesh = current_mesh()
    if mesh is None or not _ROWS_SPLIT.get() or dp_size(mesh) == 1:
        return None
    return mesh.group(BATCH)


def seq_group() -> Group | None:
    """The line that splits a decode cache's slots, as `cache_specs`
    lays them out: the model axis when the rows are split over BATCH,
    else ("data", "model"); None where it holds one device."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return mesh.group(MODEL if _ROWS_SPLIT.get() else SEQ_WIDE)


def share(n: int, group: Group | None) -> tuple:
    """[lo, hi) of this rank's `row_share` of n along `group`."""
    if group is None:
        return 0, n
    return row_share(n, group.size, group.index)


def shares(n: int, group: Group) -> list:
    """Every index's share size of n along `group`, in index order."""
    return [hi - lo for lo, hi in (row_share(n, group.size, i)
                                   for i in range(group.size))]


def gather_parts(t, group: Group) -> list:
    """Every rank's `t` (same shape) on `group`, in index order."""
    parts = collective("all_gather", t, group.handle)
    out = [None] * group.size
    for p, i in zip(parts, group.order):
        out[i] = p
    return out


def gather_cat(t, dim: int, sizes, group: Group):
    """The concatenation along `dim`, in index order, of every rank's
    `t`, the rank of index i holding sizes[i] of that axis: each padded
    to the largest for `all_gather`, then trimmed."""
    dim = dim % t.dim()
    top = max(sizes)
    pad = t
    if t.shape[dim] != top:
        shape = list(t.shape)
        shape[dim] = top
        pad = t.new_zeros(shape)
        pad.narrow(dim, 0, t.shape[dim]).copy_(t)
    parts = gather_parts(pad, group)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)],
                     dim=dim)


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.group), None


def _sum32(t, group: Group):
    """The sum of `t` over `group`, added in float32 (one rounding to a
    narrower dtype, after the sum)."""
    return collective("sum", t.float(), group.handle).to(t.dtype)


class _Reduce(torch.autograd.Function):
    """Sum over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return collective("sum", x, group.handle)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, group: Group | None):
    """x, entering a product split over `group` (Megatron's f): the
    identity forward, the gradient all-reduced (sum) over the group
    backward.  `x` itself when group is None."""
    return x if group is None else _Copy.apply(x, group)


def reduce_sum(x, group: Group | None):
    """The sum of every rank's x over `group` forward, the identity
    backward (each rank then computes the same from it).  `x` itself
    when group is None."""
    return x if group is None else _Reduce.apply(x, group)


class _GatherLeaves(torch.autograd.Function):
    """The whole last axes of tensors of any shapes whose `row_share`s the
    ranks of the group hold, in one all_gather of their flattened
    shares.  Backward, each gradient's share, with no sum (Megatron's g:
    every rank computes the same after a gather), or summed over the
    group first where `partial`."""

    @staticmethod
    def forward(ctx, group, ns, partial, *xs):
        ctx.group, ctx.partial = group, partial
        ctx.shapes = [x.shape for x in xs]
        per = [shares(n, group) for n in ns]
        rows = [x.numel() // max(x.shape[-1], 1) for x in xs]
        sizes = [sum(r * p[i] for r, p in zip(rows, per))
                 for i in range(group.size)]
        flat = torch.cat([x.reshape(-1) for x in xs])
        parts = torch.split(gather_cat(flat, 0, sizes, group), sizes)
        pieces = [torch.split(part, [r * p[i] for r, p in zip(rows, per)])
                  for i, part in enumerate(parts)]
        ctx.lo = [sum(p[:group.index]) for p in per]
        return tuple(    # each in its own dtype (the cat promotes)
            torch.cat([pieces[i][j].view(rows[j], per[j][i])
                       for i in range(group.size)], dim=1)
            .view(xs[j].shape[:-1] + (ns[j],)).to(xs[j].dtype)
            for j in range(len(xs)))

    @staticmethod
    def backward(ctx, *gs):
        gs = list(gs)
        sums = [i for i, p in enumerate(ctx.partial) if p]
        if sums:
            flat = _sum32(torch.cat([gs[i].reshape(-1) for i in sums]),
                          ctx.group)
            for i, part in zip(sums, torch.split(
                    flat, [gs[i].numel() for i in sums])):
                gs[i] = part.view(gs[i].shape)
        return (None, None, None) + tuple(
            g.narrow(-1, lo, shape[-1]).contiguous()
            for g, lo, shape in zip(gs, ctx.lo, ctx.shapes))


def gather_leaves(xs, ns, group: Group | None, partial=None) -> tuple:
    """The whole last axis (ns[i] long) of each x, of which this rank
    holds its `row_share` on `group`, in one all_gather; with
    `partial[i]` (the ranks go on to compute different things from it)
    its gradient is summed over the group before the slice.  `xs`
    themselves when group is None."""
    if group is None:
        return tuple(xs)
    partial = tuple(partial or (False,) * len(xs))
    return _GatherLeaves.apply(group, tuple(ns), partial, *xs)


def gather_along(x, n: int, group: Group | None, partial: bool = False):
    """`gather_leaves` of one tensor's last axis."""
    return gather_leaves((x,), (n,), group, (partial,))[0]


def reduce_max(t, group: Group | None):
    """The elementwise maximum of `t` over `group` (no gradient)."""
    return t if group is None else collective("max", t.detach(),
                                              group.handle)


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
    """This rank's contiguous share of x's rows over the BATCH axes (a
    view); all of x with no mesh or a mesh of one device and no world."""
    if _local(mesh):
        return x
    lo, hi = row_share(x.shape[0], dp_size(mesh), dp_rank(mesh))
    return x[lo:hi]


def gather_rows(y, mesh, n: int):
    """The n rows whose `row_share`s the BATCH lines hold, in order, on
    every rank (`gather_shares`).  `y` itself with no mesh or a mesh of
    one device and no world."""
    if _local(mesh):
        return y
    ways = dp_size(mesh)
    return gather_shares(y, mesh, [hi - lo for lo, hi in (
        row_share(n, ways, r) for r in range(ways))])


def gather_shares(y, mesh, sizes):
    """Every BATCH line's rows, index r holding sizes[r] of them,
    concatenated in order on every rank (`gather_cat` over the BATCH
    group).  `y` itself with no mesh, a mesh of one device and no
    world, or BATCH axes of one device."""
    if _local(mesh):
        return y
    mine = sizes[dp_rank(mesh)]
    if y.shape[0] != mine:
        raise ValueError(f"rank holds {y.shape[0]} rows, its share is "
                         f"{mine} of {list(sizes)}")
    group = mesh.group(BATCH)
    return y if group is None else gather_cat(y, 0, list(sizes), group)


def all_reduce(t, mesh, op: str = "sum"):
    """The elementwise sum ("sum"), minimum ("min") or maximum ("max")
    of `t` over the BATCH group, as a new tensor on t's device; `t`
    with no world or BATCH axes of one device."""
    if _local(mesh):
        return t
    group = mesh.group(BATCH)
    return t if group is None else collective(op, t, group.handle)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh's world (a no-op without one)."""
    if mesh is not None and mesh.world is not None:
        import torch.distributed as dist
        dist.barrier()


def agree(mesh, what: str, key: tuple) -> None:
    """Check that every rank of the world passes the same `key` (a short
    tuple; the ranks of a model line compute the same rows): one small
    all_gather of its repr; a mismatch raises ValueError naming this
    rank's key and the first that differs, on every rank."""
    if _local(mesh):
        return
    require_world(mesh)
    mine = repr(key).encode()[:_KEY_BYTES].ljust(_KEY_BYTES, b"\0")
    for r, row in enumerate(collective(
            "all_gather", torch.tensor(list(mine), dtype=torch.uint8))):
        theirs = bytes(row.tolist())
        if theirs != mine:
            text = theirs.rstrip(b"\0").decode(errors="replace")
            raise ValueError(
                f"{what}: ranks disagree: rank {mesh.world.rank} has {key}, "
                f"rank {r} has {text} (their queues diverged)")


_KEY_BYTES = 256

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def collective(kind: str, t, group=None):
    """The one collective helper: "all_gather" returns the list of every
    rank's `t` (same shape) in group-rank order; "sum" / "min" / "max"
    an all_reduce of a copy of `t`; both over `group` (a process group;
    default: the whole world) and on t's device.  NCCL takes the tensor
    on the rank's card, gloo where it lies."""
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
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[kind]), group=group)
    return out.to(home)
