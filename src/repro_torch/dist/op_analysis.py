"""Trip-weighted op-level cost model of a torch step; the counterpart of
`repro.dist.hlo_analysis`.

The reference reads post-optimization HLO and multiplies each `while`
body by its trip count, since XLA's own cost analysis counts a body once.
The port has no HLO: a step is Python that dispatches aten ops one at a
time, so this module counts the ops themselves.  `OpCounter`, a
`TorchDispatchMode`, sees every op below autograd (forward, backward and
recompute) and counts

  flops  `mm` / `addmm` / `bmm` / `baddbmm` / `_int_mm`: 2 x out x
         contracted, the reference's `_dot_flops` (`einsum` and `matmul`
         reach these); `convolution`: 2 x out x prod(weight) / out
         channels, `_conv_flops` (each gradient of `convolution_backward`
         as much again); nothing else, as in the reference;
  bytes  operand bytes plus output bytes of every op that is not a view,
         an alias or an allocation (the counterpart of `_FREE_OPS`), an
         in-place op's operand once.  Eager torch fuses nothing, so this
         is the traffic the card really makes, op by op; it is not
         comparable with the reference's count over fused HLO;
  collective bytes  the output bytes of the `c10d` ops (0 on one card),
         by the reference's kinds, and by fabric: "nvlink" where every
         rank of the op's group lies on one node (`dist.world.
         CARDS_PER_NODE` cards a node), "infiniband" where it crosses
         nodes;
  ops    a tally by op name.  The kernels the port launches through
         ctypes are invisible to torch: their wrappers call
         `record_kernel` (a name, its flops and bytes), one tally entry a
         launch.

With `track_memory` a live-bytes tracker follows the storages the step
allocates: a view shares its base's storage, a storage is freed when its
last reference goes, and tensors that autograd saves stay live; its peak
is the step's `temp` memory.

Loops.  A Python loop dispatches every iteration, so a dry run of a
full-size cell would take minutes to hours.  The loops whose count grows
with sequence, depth or parameters go through `trip_scan`: a plain loop
outside a weighted count; inside one (`analyze_ops` on meta tensors) it
runs the first iteration, the second weighted by n - 2 (standing for
iterations 1 .. n-2) and the last, which may be ragged, and fills the
collected outputs of the iterations it skips with uninitialized tensors
of the second's shapes.  An op in the backward is weighted by the
autograd node that runs it (`torch._C._current_autograd_node`): its
sequence number lies in the range recorded while the weighted iteration
built it.  A rematerialized region (`remat`) recomputes at the weight it
had in the forward.  So a weighted count equals the full count op for
op wherever the middle iterations have the second's shapes, which every
routed loop keeps.  The tracker holds what the second iteration left
live beyond its outputs (the tensors autograd saved, the carry's
growth) n - 3 more times until its own is freed, and likewise each
gradient it sends to a stacked param's per-iteration view (`unbind`),
which a full run holds until the stack: so the peak is a full run's too.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.world import CARDS_PER_NODE

aten = torch.ops.aten

# the counter in force, else None: every hook tests this one name
active: "OpCounter | None" = None

# lhs operand index of each dot op
_DOTS = {aten.mm: 0, aten.addmm: 1, aten.bmm: 0, aten.baddbmm: 1,
         aten._int_mm: 0}
# ops that move no bytes besides the views (`OpOverload.is_view`): the
# allocations, and the aliases, which allocate nothing either
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided, aten.empty_permuted}
_ALIASES = {aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh}
# c10d ops (functional and eager) -> the reference's collective kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_C10D = ("_c10d_functional", "c10d_functional", "c10d")


def fabric(ranks) -> str:
    """The fabric a collective over `ranks` (global ranks) crosses:
    "nvlink" within one node, "infiniband" across nodes."""
    return "nvlink" if len({r // CARDS_PER_NODE for r in ranks}) <= 1 \
        else "infiniband"


def _group_ranks(func, args) -> list:
    """The global ranks of a c10d op's process group (its
    `process_group` argument; the world's without one)."""
    import torch.distributed as dist
    names = [a.name for a in func._schema.arguments]
    if "process_group" not in names:
        return list(range(dist.get_world_size()))
    pg = dist.ProcessGroup.unbox(args[names.index("process_group")])
    return dist.get_process_group_ranks(pg)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs (nested tuples and
    lists of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    if isinstance(tree, (tuple, list)):
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (tuple, list)):
                out.extend(_tensors(x))
    return out


def dot_flops(lhs_shape, out_shape) -> float:
    """2 x out x contracted: the lhs's last axis is the contraction."""
    n = 1
    for d in out_shape:
        n *= d
    return 2.0 * n * lhs_shape[-1]


def conv_flops(weight_shape, out_shape, transposed: bool = False,
               groups: int = 1) -> float:
    """2 x out x prod(weight) / out channels (weight [O, I/g, *k], or
    [I, O/g, *k] transposed)."""
    out_ch = weight_shape[1] * groups if transposed else weight_shape[0]
    n = 1
    for d in out_shape:
        n *= d
    w = 1
    for d in weight_shape:
        w *= d
    return 2.0 * n * w / max(out_ch, 1)


def _flops(func, args, out) -> float:
    pkt = func.overloadpacket
    if pkt in _DOTS:
        return dot_flops(args[_DOTS[pkt]].shape, out.shape)
    if pkt is aten.convolution:
        return conv_flops(args[1].shape, out.shape, bool(args[6]),
                          int(args[8]))
    if pkt is aten.convolution_backward:
        # (grad_out, input, weight, ..., transposed, _, groups, mask)
        per = conv_flops(args[2].shape, args[0].shape, bool(args[7]),
                         int(args[9]))
        return per * sum(bool(m) for m in args[10][:2])
    return 0.0


@dataclasses.dataclass
class OpCost:
    """A step's cost terms, trip-weighted: `HloCost`'s fields (its
    `n_whiles` is `n_loops`, the loops run) plus the tally by op and the
    collective bytes by fabric ("nvlink", "infiniband")."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    collective_count_by_kind: dict = dataclasses.field(default_factory=dict)
    n_loops: int = 0
    ops: dict = dataclasses.field(default_factory=dict)
    collective_bytes_by_fabric: dict = dataclasses.field(
        default_factory=dict)

    def add(self, other: "OpCost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.hbm_bytes += mult * other.hbm_bytes
        self.collective_bytes += mult * other.collective_bytes
        for k, v in other.collective_bytes_by_kind.items():
            self.collective_bytes_by_kind[k] = \
                self.collective_bytes_by_kind.get(k, 0.0) + mult * v
        for k, v in other.collective_count_by_kind.items():
            self.collective_count_by_kind[k] = \
                self.collective_count_by_kind.get(k, 0) + int(mult * v)
        for k, v in other.collective_bytes_by_fabric.items():
            self.collective_bytes_by_fabric[k] = \
                self.collective_bytes_by_fabric.get(k, 0.0) + mult * v
        for k, v in other.ops.items():
            self.ops[k] = self.ops.get(k, 0) + int(mult * v)
        self.n_loops += other.n_loops


class _LiveBytes:
    """Live and peak bytes of the storages allocated under the counter,
    each storage once, freed with its last reference; and `tie`d bytes
    that stand for the iterations a weighted loop skipped."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.serial = 0                # storages held so far
        self._held: dict = {}          # storage key -> (nbytes, ref, serial)
        self._ties: dict = {}          # storage key -> [tie, ...]

    def track(self, tensors) -> None:
        """Hold the storages of `tensors` (an op's new outputs)."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            nb = st.nbytes()
            self._held[key] = (nb, weakref.ref(st, self._freer(key)),
                               self.serial)
            self.serial += 1
            self._add(nb)

    def holds(self, t) -> bool:
        return t.untyped_storage()._cdata in self._held

    def held_since(self, serial: int) -> set:
        """The keys of the storages held since `serial` and still live."""
        return {k for k, v in self._held.items() if v[2] >= serial}

    def tie(self, nbytes: int, keys) -> None:
        """Hold `nbytes` more until every storage of `keys` is freed."""
        if nbytes <= 0 or not keys:
            return
        tie = [nbytes, len(keys)]
        for k in keys:
            self._ties.setdefault(k, []).append(tie)
        self._add(nbytes)

    def _add(self, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _freer(self, key):
        def free(_ref):
            self.live -= self._held.pop(key)[0]
            for tie in self._ties.pop(key, ()):
                tie[1] -= 1
                if tie[1] == 0:
                    self.live -= tie[0]
        return free


_INFO: dict = {}


def _info(func) -> tuple:
    """(tally name, moves no bytes, allocates its outputs) of an op: a
    view, an alias or an in-place op allocates nothing."""
    pkt = func.overloadpacket
    alias = func.is_view or pkt in _ALIASES
    info = (str(func), alias or pkt in _ALLOCS,
            not alias and not func._schema.is_mutable)
    _INFO[func] = info
    return info


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched under it into `self.cost` (see the
    module docstring); `weighted` turns on the trip weighting of
    `trip_scan` and `remat`, `track_memory` the live-bytes tracker."""

    def __init__(self, weighted: bool = False, track_memory: bool = False):
        super().__init__()
        self.cost = OpCost()
        self.weighted = weighted
        self.mem = _LiveBytes() if track_memory else None
        self._weight = 1
        self._forced = False
        self._quiet = 0
        self._starts: list = []        # sorted disjoint sequence ranges
        self._ranges: list = []        # (start, end, weight)

    # -- weights --------------------------------------------------------------
    def weight(self) -> int:
        """The weight of an op dispatched now: the loop weight in the
        forward and in a recompute, else that of the autograd node that
        runs it."""
        if self._forced or not self.weighted:
            return self._weight
        node = torch._C._current_autograd_node()
        if node is None:
            return self._weight
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._starts, seq) - 1
        if i >= 0 and seq < self._ranges[i][1]:
            return self._ranges[i][2]
        return 1

    @contextlib.contextmanager
    def at_weight(self, w: int):
        """Count at weight w for the duration, and give the autograd
        nodes made meanwhile weight w wherever no inner range did."""
        saved = self._weight, self._forced
        self._weight, self._forced = w, True
        s0 = torch._C._autograd._get_sequence_nr()
        try:
            yield
        finally:
            self._weight, self._forced = saved
            self._register(s0, torch._C._autograd._get_sequence_nr(), w)

    def _register(self, s0: int, s1: int, w: int) -> None:
        """Weight w for the sequence numbers of [s0, s1) that no range
        registered before (the inner ones, which close first) holds."""
        if s1 <= s0:
            return
        pos, new = s0, []
        for a, b, _ in self._ranges:
            if b <= s0 or a >= s1:
                continue
            if a > pos:
                new.append((pos, a, w))
            pos = max(pos, b)
        if pos < s1:
            new.append((pos, s1, w))
        self._ranges = sorted(self._ranges + new)
        self._starts = [r[0] for r in self._ranges]

    @contextlib.contextmanager
    def quiet(self):
        """Ops dispatched meanwhile are not counted (their storages are
        still tracked)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- counting -------------------------------------------------------------
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        w = self.weight()
        c = self.cost
        c.flops += w * flops
        c.hbm_bytes += w * nbytes
        c.ops[name] = c.ops.get(name, 0) + w

    def _skipped_cycle_grad(self, func, args) -> bool:
        """Whether the op is unbind's backward filling the gradient of a
        stacked cycle that a weighted loop skipped with a 0-d zero, which
        a full run does not make (it has the cycle's own gradient)."""
        if func.overloadpacket is not aten.zeros or args[0]:
            return False
        node = torch._C._current_autograd_node()
        return node is not None and node.name() == "UnbindBackward0"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = _INFO.get(func) or _info(func)
        name, free, allocates = info
        if allocates and self.mem is not None:
            self.mem.track(_tensors(out))
        if self._quiet or free or (self.weighted and
                                   self._skipped_cycle_grad(func, args)):
            return out
        w = self.weight()
        c = self.cost
        c.ops[name] = c.ops.get(name, 0) + w
        c.flops += w * _flops(func, args, out)
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        outs = [t for t in _tensors(out) if not any(t is i for i in ins)]
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        c.hbm_bytes += w * nbytes
        if func.namespace in _C10D:
            kind = _COLLECTIVES.get(func.overloadpacket.__name__)
            if kind is not None:
                cb = w * sum(map(_nbytes, _tensors(out)))
                c.collective_bytes += cb
                c.collective_bytes_by_kind[kind] = \
                    c.collective_bytes_by_kind.get(kind, 0.0) + cb
                c.collective_count_by_kind[kind] = \
                    c.collective_count_by_kind.get(kind, 0) + w
                f = fabric(_group_ranks(func, args))
                c.collective_bytes_by_fabric[f] = \
                    c.collective_bytes_by_fabric.get(f, 0.0) + cb
        return out

    def __enter__(self):
        global active
        self._outer = active
        active = self
        return super().__enter__()

    def __exit__(self, *exc):
        global active
        active = self._outer
        return super().__exit__(*exc)


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Count one launch of a kernel torch cannot see (a ctypes kernel):
    its name in the tally, its flops and its bytes, at the current
    weight.  A no-op with no counter in force."""
    if active is not None:
        active.kernel(name, flops, nbytes)


def trip_scan(body, n: int, carry=None):
    """`for i in range(n): carry, y = body(i, carry)` -> (carry, [y_0 ..
    y_{n-1}]).  In a weighted count with n > 3, only iterations 0, 1 and
    n-1 run; iteration 1 is counted n - 2 times, and y_2 .. y_{n-2} are
    uninitialized tensors shaped as y_1 (None where y_1 is None)."""
    c = active
    if c is not None:
        c.cost.n_loops += c.weight()
    if c is None or not c.weighted or n <= 3:
        ys = []
        for i in range(n):
            carry, y = body(i, carry)
            ys.append(y)
        return carry, ys
    carry, y0 = body(0, carry)
    mem = c.mem
    if mem is not None:
        live, serial = mem.live, mem.serial
    s0 = torch._C._autograd._get_sequence_nr()
    with c.at_weight(c.weight() * (n - 2)):
        carry, y1 = body(1, carry)
    if mem is not None:
        # what iteration 1 left live beyond its outputs (the carry's
        # growth, the tensors autograd saved) is held once more for each
        # iteration skipped, until iteration 1's own is freed; the
        # fillers stand for the outputs
        _tie_stacked_grads(mem, (carry, y1), s0,
                           torch._C._autograd._get_sequence_nr(), n - 3)
        kept = mem.held_since(serial)
        ys = {t.untyped_storage()._cdata: _nbytes(t) for t in _tensors(y1)}
        grown = mem.live - live - sum(nb for k, nb in ys.items()
                                      if k in kept)
        mem.tie((n - 3) * grown, kept)
    with c.quiet():
        fill = _fillers(y1, n - 3)
    carry, last = body(n - 1, carry)
    return carry, [y0, y1, *fill, last]


def _tie_stacked_grads(mem: _LiveBytes, outs, s0: int, s1: int,
                       k: int) -> None:
    """Hook the autograd nodes one iteration built (sequence numbers in
    [s0, s1)) that send a gradient to unbind's backward, i.e. to a
    stacked param's per-iteration view: each such gradient stands for k
    more, which a full run holds until the stack."""
    todo = [t.grad_fn for t in _tensors(outs) if t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in seen or \
                not s0 <= node._sequence_nr() < s1:
            continue
        seen.add(node)
        edges = [j for j, (nxt, _) in enumerate(node.next_functions)
                 if nxt is not None and nxt.name() == "UnbindBackward0"]
        if edges:
            node.register_hook(functools.partial(_tie_grads, mem, edges, k))
        todo.extend(nxt for nxt, _ in node.next_functions)


def _tie_grads(mem: _LiveBytes, edges, k: int, grads, _outputs) -> None:
    for j in edges:
        g = grads[j]
        if g is not None and mem.holds(g):
            mem.tie(k * _nbytes(g), {g.untyped_storage()._cdata})


def _fillers(y, k: int) -> list:
    """k uninitialized copies of the structure y (tensors, tuples of
    them, None), each tensor leaf a view of one [k, ...] allocation."""
    if y is None:
        return [None] * k
    if isinstance(y, torch.Tensor):
        return list(y.new_empty((k,) + tuple(y.shape)).unbind(0))
    cols = [_fillers(leaf, k) for leaf in y]
    return [type(y)(col[i] for col in cols) for i in range(k)]


def remat(fn):
    """`fn` to hand to `torch.utils.checkpoint`: in a weighted count its
    recompute in the backward is counted at the weight of the forward
    that called this; otherwise `fn` itself."""
    c = active
    if c is None or not c.weighted:
        return fn
    w = c.weight()

    def run(*args):
        with c.at_weight(w):
            return fn(*args)
    return run


def counting() -> bool:
    """Whether a counter is in force (the models then take the card's op
    sequence on the CPU too, so that a CPU count is the card's)."""
    return active is not None


@dataclasses.dataclass
class OpAnalysis:
    """`analyze_ops`'s result: the step's output, its cost, the peak
    live bytes it allocated (None untracked) and FlopCounterMode's flops
    over the ops that ran (not trip-weighted)."""
    out: object
    cost: OpCost
    peak_bytes: int | None
    flop_counter: float | None


def _all_meta(tree) -> bool:
    """Whether `tree` (nested dicts, tuples and lists) holds tensors and
    all of them are on the meta device."""
    seen = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            seen.append(x.device.type == "meta")
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(tree)
    return bool(seen) and all(seen)


def analyze_ops(fn, *args, track_memory: bool = True,
                flop_counter: bool = False) -> OpAnalysis:
    """Run fn(*args) under an `OpCounter`: trip-weighted when every
    tensor argument is on the meta device, with FlopCounterMode stacked
    under it when `flop_counter`."""
    counter = OpCounter(weighted=_all_meta(args), track_memory=track_memory)
    fc = None
    with contextlib.ExitStack() as stack:
        if flop_counter:
            from torch.utils.flop_counter import FlopCounterMode
            fc = stack.enter_context(FlopCounterMode(display=False))
        stack.enter_context(counter)
        out = fn(*args)
    return OpAnalysis(out, counter.cost,
                      counter.mem.peak if counter.mem is not None else None,
                      None if fc is None else float(fc.get_total_flops()))


def analyze_collectives(fn, *args) -> dict:
    """Collective traffic summary of fn(*args), as the reference's."""
    cost = analyze_ops(fn, *args, track_memory=False).cost
    return {
        "total_bytes": cost.collective_bytes,
        "bytes_by_kind": cost.collective_bytes_by_kind,
        "count_by_kind": cost.collective_count_by_kind,
    }
