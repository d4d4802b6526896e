"""Fused int8 dynamic routing (paper Alg. 5): the CUDA kernel's wrapper
and its plain version.

`routing_q7` takes u_hat int8 [B, J, I, O] and returns v int8 [B, J, O]
in Q0.7 after all r iterations.  A tensor on the CPU goes to
`routing_q7_plain`; a CUDA tensor goes to `csrc/routing_q7.cu` or
raises.  The kernel replaces the Pallas TPU kernel
`repro.kernels.routing.routing_q7_pallas` and implements what it does:
the default softmax ("q7") and squash ("exact") variants, Q0.7 output.

`routing_q7_plain` is the torch loop the kernel is held against; with
other variant faces and output formats it is also the `torch` backend's
routing (`repro_torch.nn.backend.TorchBackend.routing_q7`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.squash import MAX_DIM, check_in_frac
from repro_torch.quant import int8_ops as q

MAX_ITERS = 16                         # csrc/routing_q7.cu kMaxIters
MAX_CLUSTER = 8                        # the portable thread-block cluster
CLUSTER_SIZES = (1, 2, 4, 8)           # checked at every bucket
CHOSEN_MAX = 4                         # the largest cluster_size picks
NUM_SMS = 132                          # H100 SXM
SMEM_LIMIT = 232_448                   # H100: 227 KB of dynamic smem a block


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def slice_bounds(I: int, cs: int) -> list:
    """The input capsules [lo, hi) of each CTA of a cs-CTA cluster (the
    kernel's slice_begin): never empty when cs <= I."""
    return [(k * I // cs, (k + 1) * I // cs) for k in range(cs)]


def routing_smem_bytes(J: int, I: int, O: int, cs: int = 1,
                       staged: bool = True) -> int:
    """Dynamic shared memory one CTA of a cs-CTA cluster needs, for the
    largest slice I_k = ceil(I / cs): u_hat rows [J][align16(I_k*O)]
    int8 where the slice is staged, logits and couplings [J*I_k] int8
    each, two partial s and one v [J*O] int32 (the layout in
    csrc/routing_q7.cu)."""
    ik = -(-I // cs)
    return J * _align16(ik * O) * staged + 2 * _align16(J * ik) \
        + 3 * _align16(4 * J * O)


def _sizes(I: int) -> list:
    return [cs for cs in CLUSTER_SIZES if cs <= I]


def cluster_size(B: int, J: int, I: int, O: int) -> int:
    """The cluster size the wrapper launches with: the largest of 1, 2
    and 4 (and at most I, so no slice is empty) whose B*cs CTAs fit one
    to an SM, then the next larger size while a CTA's slice would not
    fit in shared memory (the largest size, unstaged, where none fits).
    On the H100 at the MNIST geometry 8 CTAs a sample ran slower than
    4, and a second CTA on an SM slower than a smaller cluster (PERF.md
    §6)."""
    sizes = _sizes(I)
    picks = [c for c in sizes if c <= CHOSEN_MAX and B * c <= NUM_SMS]
    cs = picks[-1] if picks else 1
    for c in sizes:
        if c >= cs and routing_smem_bytes(J, I, O, c) <= SMEM_LIMIT:
            return c
    return sizes[-1]


def routing_q7_plain(u_hat, *, num_iters: int, caps_out_shifts,
                     caps_out_fracs, agree_shifts, logit_frac: int,
                     rounding: str = "floor", softmax=q.softmax_q7,
                     squash=q.squash_q7, out_frac: int = 7):
    """Alg. 5's r-iteration loop over an already-computed u_hat.

    `softmax` / `squash` are variant q7 faces; the agreement shifts were
    derived for a Q0.7 squash output, so `out_frac - 7` is added to them
    to keep the logits in Q(logit_frac) when the output format differs."""
    B, J, I, _ = u_hat.shape
    b = torch.zeros((B, J, I), dtype=torch.int8, device=u_hat.device)
    v = None
    for r in range(num_iters):
        c = softmax(b.transpose(1, 2), logit_frac).transpose(1, 2)
        acc = q.einsum_i32("bji,bjio->bjo", c, u_hat)
        s_q = q.rshift_sat8(acc, caps_out_shifts[r], rounding)
        v = squash(s_q, in_frac=caps_out_fracs[r], out_frac=out_frac)
        if r < num_iters - 1:
            acc = q.einsum_i32("bjio,bjo->bji", u_hat, v)
            a = q.rshift_sat8(acc, agree_shifts[r] + out_frac - 7, rounding)
            b = q.add_q7(b, a)
    return v


class RoutingArgs(ctypes.Structure):
    """csrc/routing_q7.cu's RoutingArgs: the shift tables, by pointer."""
    _fields_ = [("num_iters", ctypes.c_int), ("logit_frac", ctypes.c_int),
                ("nearest", ctypes.c_int),
                ("caps_out_shifts", ctypes.c_int * MAX_ITERS),
                ("caps_out_fracs", ctypes.c_int * MAX_ITERS),
                ("agree_shifts", ctypes.c_int * MAX_ITERS)]


_ARGS: dict = {}                       # table key -> RoutingArgs


def _table(values) -> ctypes.Array:
    t = (ctypes.c_int * MAX_ITERS)()
    t[:len(values)] = [int(x) for x in values]
    return t


def _routing_args(num_iters, caps_out_shifts, caps_out_fracs, agree_shifts,
                  logit_frac, nearest) -> RoutingArgs:
    """The shift tables as one RoutingArgs, checked and built once per
    distinct tables (a served model reuses its plan's on every call)."""
    key = (num_iters, tuple(caps_out_shifts), tuple(caps_out_fracs),
           tuple(agree_shifts[:num_iters - 1]), logit_frac, nearest)
    args = _ARGS.get(key)
    if args is None:
        if len(caps_out_shifts) != num_iters or \
                len(caps_out_fracs) != num_iters or \
                len(agree_shifts) < num_iters - 1:
            raise ValueError("routing_q7: shift tables do not match "
                             "num_iters")
        for f in caps_out_fracs:
            check_in_frac(f)
        if len(_ARGS) >= 4096:
            _ARGS.clear()
        args = _ARGS[key] = RoutingArgs(num_iters, logit_frac, nearest,
                                        *map(_table, key[1:4]))
    return args


@functools.cache
def _launch():
    """routing_q7_launch with its argtypes, bound once."""
    fn = build.load("routing_q7").routing_q7_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 \
        + [ctypes.POINTER(RoutingArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stages(J: int, I: int, O: int, cs: int) -> bool:
    """Whether a CTA of a cs-CTA cluster copies its u_hat slice into
    shared memory (else it reads u_hat where it lies, on every pass)."""
    return routing_smem_bytes(J, I, O, cs) <= SMEM_LIMIT


def check_geometry(J: int, I: int, O: int, num_iters: int) -> None:
    """Raise for a routing problem the kernel does not take: capsule dim
    above 32, more than 16 iterations, or logits and couplings of an
    8-CTA slice beyond a block's shared memory (J * I above about
    900,000)."""
    if not 1 <= O <= MAX_DIM:
        raise ValueError(f"routing_q7 takes capsule dim 1..{MAX_DIM}, got {O}")
    if not 1 <= num_iters <= MAX_ITERS:
        raise ValueError(f"routing_q7 takes 1..{MAX_ITERS} iterations, "
                         f"got {num_iters}")
    if J < 1 or I < 1:
        raise ValueError(f"routing_q7 takes J, I >= 1, got {J}, {I}")
    cs = _sizes(I)[-1]
    need = routing_smem_bytes(J, I, O, cs, staged=False)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"routing_q7: a {cs}-CTA cluster's slice of one sample's logits "
            f"and couplings (J={J}, I={I}, O={O}) needs {need} B of shared "
            f"memory a CTA, above the {SMEM_LIMIT} B a block can have")


@functools.lru_cache(maxsize=4096)
def launch_plan(B: int, J: int, I: int, O: int, num_iters: int,
                cs: int | None = None, stage: bool | None = None) -> tuple:
    """(cluster size, u_hat staged) of a launch, checked once per
    geometry: raises for one the kernel does not take, or for a forced
    cluster size or staging that does not fit.  `cluster_size` and
    `stages` decide what is not forced."""
    check_geometry(J, I, O, num_iters)
    if cs is None:
        cs = cluster_size(B, J, I, O)
    elif not 1 <= cs <= min(MAX_CLUSTER, I):
        raise ValueError(f"routing_q7: cluster size {cs} for I={I}")
    if stage is None:
        stage = stages(J, I, O, cs)
    if routing_smem_bytes(J, I, O, cs, stage) > SMEM_LIMIT:
        raise ValueError(f"routing_q7: cluster size {cs} for I={I} "
                         f"{'staged' if stage else 'unstaged'} needs more "
                         f"than {SMEM_LIMIT} B of shared memory")
    return cs, stage


def routing_q7(u_hat, *, num_iters: int, caps_out_shifts, caps_out_fracs,
               agree_shifts, logit_frac: int, rounding: str = "floor",
               cs: int | None = None, stage: bool | None = None):
    """u_hat int8 [B, J, I, O] -> v int8 [B, J, O], all r iterations fused.

    A CUDA tensor launches one cs-CTA cluster per sample; `cs` (1..8,
    at most I) forces the cluster size and `stage` whether u_hat is
    staged in shared memory, which `launch_plan` decides otherwise (the
    checks use both to cover every path)."""
    kw = dict(num_iters=num_iters, caps_out_shifts=caps_out_shifts,
              caps_out_fracs=caps_out_fracs, agree_shifts=agree_shifts,
              logit_frac=logit_frac, rounding=rounding)
    if u_hat.device.type == "cpu":
        return routing_q7_plain(u_hat, **kw)
    if u_hat.device.type != "cuda":
        raise NotImplementedError(f"routing_q7 on {u_hat.device}")
    if u_hat.dtype != torch.int8 or u_hat.dim() != 4:
        raise TypeError(f"routing_q7 takes int8 [B, J, I, O], got "
                        f"{u_hat.dtype} {tuple(u_hat.shape)}")
    if rounding not in ("floor", "nearest"):
        raise ValueError(f"unknown rounding {rounding!r}")
    B, J, I, O = u_hat.shape
    cs, stage = launch_plan(B, J, I, O, num_iters, cs, stage)
    args = _routing_args(num_iters, caps_out_shifts, caps_out_fracs,
                         agree_shifts, logit_frac, int(rounding == "nearest"))
    u = u_hat.contiguous()
    v = torch.empty((B, J, O), dtype=torch.int8, device=u.device)
    with torch.cuda.device(u.device):
        err = _launch()(u.data_ptr(), v.data_ptr(), B, J, I, O, cs,
                        int(stage), ctypes.byref(args),
                        torch.cuda.current_stream().cuda_stream)
    build.check(err, "routing_q7")
    routing_q7.launches += 1
    return v


routing_q7.launches = 0
