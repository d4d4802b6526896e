"""int8 GEMM with the q7 scalar-shift epilogue: the CUDA kernel's
wrappers and their plain versions.

`matmul_q7` takes int8 [M, K] x [K, N]; `bmm_q7` takes [..., M, K] x
[..., K, N] with equal leading axes (the reference's `vmap` over the 2-D
kernel) and keeps the batch on the grid in one call.  A tensor on the
CPU goes to the plain version; a CUDA tensor goes to
`csrc/q7_matmul.cu` or raises.  The kernel replaces the Pallas TPU
kernel `repro.kernels.q7_matmul.q7_matmul_pallas`.

`gemm_plan` picks the main loop of every CUDA call, from the shape and
the alignment of the operands alone, before any launch: the "wgmma"
route (`csrc/i8_gemm_sm90.cuh`) or the "mma.sync" route
(`csrc/i8_gemm.cuh`, one launch).  On the wgmma route B is read
K-major: `matmul_q7`, `bmm_q7` and `w8a8_matmul` take B [K, N] and
transpose it first (`transpose_kn`, one launch), while `w8a8_dense`
and `w8a8_bmm` take W stored K-major and launch no transpose.  Then a
product of M <= SMALL_M rows runs the stream-K schedule (one launch:
a persistent block per SM, each an equal share of the (tile, K-block)
iterations), and a larger one a block per output tile and K part (the
product, and with split K a reduction, one launch each).  A launch that
is refused raises; no call changes route.  Each wrapper counts its
calls in `launches` and, by route, in `launches_by_route`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.quant import int8_ops as q

MAX_GRID_YZ = 65_535                     # CUDA's gridDim.y / gridDim.z limit
TILE_M = 128                             # rows of an output tile, M > SMALL_M
SMALL_M = 64                             # M at most this: the stream-K plan
SK_TILE = (64, 128)                      # i8_gemm_sm90.cuh kSkBM x kSkBN
K_BLOCK = 128                            # i8_gemm_sm90.cuh kBK, K bytes
MIN_SPLIT_KBLOCKS = 2                    # K blocks of a split-K part, least
MAX_TRANSPOSE_N = MAX_GRID_YZ * 64       # transpose_kernel: N tiles on grid.y
H100_SMS = 132
ROUTES = ("wgmma", "mma.sync")


class GemmPlan(NamedTuple):
    route: str                           # one of ROUTES
    tile: tuple                          # (rows, cols) of an output tile
    split: int                           # blocks a tile's K is cut into
    schedule: str = "tiles"              # or "stream-k"
    ctas: int = 0                        # stream-k: persistent blocks


def gemm_plan(M: int, K: int, N: int, batch: int, a_ptr: int,
              sms: int = H100_SMS, b_ptr: int = 0) -> GemmPlan:
    """Route, output tile and schedule of `batch` products [M, K] x
    [K, N] whose A starts at address `a_ptr`, on a card with `sms` SMs;
    `b_ptr` is the address of a B stored K-major that TMA reads as it is
    (0: B goes through `transpose_kn` into an aligned scratch).

    TMA describes an operand only when its rows are whole 16-byte units
    (K % 16 == 0) and it starts 16-byte aligned.  Every other shape
    takes the mma.sync loop.  On the wgmma route a product of M <=
    SMALL_M rows is bound by the bytes of B: it takes 64 x 128 tiles (one
    wgmma's rows, so no shared memory holds padding rows of A) on the
    stream-K schedule, min(sms, iterations // MIN_SPLIT_KBLOCKS) blocks
    (at least one) over the tiles x K blocks iterations, each block a
    contiguous share, shares within one iteration of each other
    (`streamk_shares`).  A larger product with N >= 256 that fills every
    SM with 128 x 256 tiles takes them (each B byte staged feeds 128
    rows, each A byte 256 columns); the rest take 128 x 128.  When the
    output has fewer tiles than the card has SMs and K is long (at least
    2 * MIN_SPLIT_KBLOCKS blocks of K_BLOCK), K is cut into
    min(ceil(sms / tiles), K blocks // MIN_SPLIT_KBLOCKS) parts."""
    if min(M, K, N, batch) <= 0 or K % 16 or (a_ptr | b_ptr) % 16 \
            or N > MAX_TRANSPOSE_N:
        return GemmPlan("mma.sync", (TILE_M, 128), 1)
    if M <= SMALL_M:
        iters = streamk_iterations(M, K, N, batch)
        return GemmPlan("wgmma", SK_TILE, 1, "stream-k",
                        min(sms, max(1, iters // MIN_SPLIT_KBLOCKS)))
    m_tiles = batch * -(-M // TILE_M)
    tile_n = 256 if N >= 256 and m_tiles * -(-N // 256) >= sms else 128
    tiles = m_tiles * -(-N // tile_n)
    split = 1
    if tiles < sms:
        kblocks = -(-K // K_BLOCK)
        split = max(1, min(-(-sms // tiles), kblocks // MIN_SPLIT_KBLOCKS))
    return GemmPlan("wgmma", (TILE_M, tile_n), split)


def streamk_iterations(M: int, K: int, N: int, batch: int) -> int:
    """(tile, K block) iterations of the stream-K schedule, its tiles
    SK_TILE each; iteration i is K block i % kblocks of tile i //
    kblocks."""
    return batch * -(-M // SK_TILE[0]) * -(-N // SK_TILE[1]) \
        * -(-K // K_BLOCK)


def streamk_shares(iters: int, ctas: int) -> list:
    """[begin, end) of each block's iterations, as wgmma_streamk_kernel
    cuts them: block c walks [c * iters // ctas, (c + 1) * iters //
    ctas)."""
    return [(c * iters // ctas, (c + 1) * iters // ctas)
            for c in range(ctas)]


def streamk_work_ints(plan: GemmPlan, M: int) -> int:
    """int32 of a stream-K call's workspace: an arrival count and a sum
    tile (min(M, 64) x 128) a block, for the one tile cut between shares
    that the block is the first owner of."""
    return plan.ctas * (1 + min(M, SK_TILE[0]) * SK_TILE[1])


matmul_q7_plain = q.matmul_q7          # exact float64 product


def bmm_q7_plain(a, b, shift: int, rounding: str = "floor"):
    """[..., M, K] x [..., K, N] int8 -> int8, one product per batch entry."""
    return q.rshift_sat8(q.einsum_i32("...mk,...kn->...mn", a, b), shift,
                         rounding)


def transpose_kn_plain(b):
    """[..., K, N] -> [..., N, K], contiguous."""
    return b.transpose(-1, -2).contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int
# each C entry of csrc/{q7_matmul,w8a8_matmul,w8a8_dense}.cu and its
# arguments
ARGTYPES = {
    "q7_matmul_launch": [_P] * 3 + [_I] * 6 + [_P],
    "i8_transpose_launch": [_P, _P] + [_I] * 3 + [_P],
    "q7_matmul_wgmma_launch": [_P] * 4 + [_I] * 6 + [_I, _I, _P],
    "q7_matmul_reduce_launch": [_P] * 2 + [_I] * 4 + [_I, _I, _P],
    "q7_matmul_streamk_launch": [_P] * 4 + [_I] * 5 + [_I, _I, _P],
    "w8a8_matmul_launch": [_P] * 4 + [_I] * 4 + [_P],
    "w8a8_matmul_wgmma_launch": [_P] * 4 + [_I] * 6 + [_P, _I, _P],
    "w8a8_matmul_reduce_launch": [_P] * 2 + [_I] * 4 + [_P, _I, _P],
    "w8a8_matmul_streamk_launch": [_P] * 4 + [_I] * 5 + [_P, _I, _P],
    "w8a8_dense_launch": [_P] * 5 + [_I] * 5 + [_P],
    "w8a8_dense_wgmma_launch": [_P] * 4 + [_I] * 6 + [_P, _P, _I, _P],
    "w8a8_dense_reduce_launch": [_P] * 2 + [_I] * 4 + [_P, _P, _I, _P],
    "w8a8_dense_streamk_launch": [_P] * 4 + [_I] * 5 + [_P, _P, _I, _P],
}


@functools.cache
def entry(lib: str, name: str):
    """C entry `name` of kernel library `lib`, its argtypes bound once."""
    fn = getattr(build.load(lib), name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def transpose_kn(b):
    """int8 B [..., K, N] -> Bt [..., N, K], the wgmma route's K-major
    copy of B.  A CPU tensor takes the plain version; a CUDA tensor
    csrc/i8_gemm_sm90.cuh's transpose_kernel (K % 4 == 0) or raises."""
    if b.device.type == "cpu":
        return transpose_kn_plain(b)
    if b.device.type != "cuda" or b.dtype != torch.int8 or b.dim() < 2:
        raise NotImplementedError(f"transpose_kn on {b.device} {b.dtype} "
                                  f"{tuple(b.shape)}")
    b = b.contiguous()
    K, N = b.shape[-2:]
    bt = torch.empty(b.shape[:-2] + (N, K), dtype=b.dtype, device=b.device)
    with torch.cuda.device(b.device):
        err = entry("q7_matmul", "i8_transpose_launch")(
            b.data_ptr(), bt.data_ptr(), math.prod(b.shape[:-2]), K, N,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "i8_transpose")
    transpose_kn.launches += 1
    return bt


transpose_kn.launches = 0


def plan_for(a, b, b_kmajor: bool = False) -> GemmPlan:
    """gemm_plan for contiguous operands on the card: b [..., K, N], or
    with `b_kmajor` b [..., N, K] read as it is."""
    N = b.shape[-2] if b_kmajor else b.shape[-1]
    return gemm_plan(a.shape[-2], a.shape[-1], N, math.prod(a.shape[:-2]),
                     a.data_ptr(), sm_count(a.device.index or 0),
                     b.data_ptr() if b_kmajor else 0)


def wgmma_route(lib: str, plan: GemmPlan, a, b, out, epi: tuple,
                b_kmajor: bool = False) -> None:
    """The wgmma route of library `lib` over contiguous a [batch, M, K]
    and b [batch, K, N] (with `b_kmajor`, b [batch, N, K] as it is) into
    out, on the current stream, each launch checked: the transpose of a
    [K, N] b; then on the stream-K schedule one launch over a workspace
    of arrival counts and sum tiles, else the product and, with
    split K, the reduction of the partials in a workspace.  `epi` holds
    the epilogue's trailing arguments of the C entries."""
    M, K = a.shape[-2:]
    N = b.shape[-2] if b_kmajor else b.shape[-1]
    batch = math.prod(a.shape[:-2])
    bt = b if b_kmajor else transpose_kn(b)
    stream = torch.cuda.current_stream().cuda_stream
    if plan.schedule == "stream-k":
        work = torch.empty(streamk_work_ints(plan, M), dtype=torch.int32,
                           device=a.device)
        err = entry(lib, f"{lib}_streamk_launch")(
            a.data_ptr(), bt.data_ptr(), out.data_ptr(), work.data_ptr(),
            batch, M, N, K, plan.ctas, *epi, stream)
        build.check(err, f"{lib} stream-K")
        return
    work = None
    if plan.split > 1:
        work = torch.empty((batch, plan.split, M, N), dtype=torch.int32,
                           device=a.device)
    err = entry(lib, f"{lib}_wgmma_launch")(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), batch, M, N, K,
        plan.tile[1], plan.split, *epi, stream)
    build.check(err, f"{lib} wgmma")
    if work is not None:
        err = entry(lib, f"{lib}_reduce_launch")(
            work.data_ptr(), out.data_ptr(), batch, M, N, plan.split, *epi,
            stream)
        build.check(err, f"{lib} split-K reduction")


def check_operands(what: str, a, b, rounding: str) -> None:
    """Raise for operands the GEMM kernel does not take: int8, at least
    2-D, equal leading axes, matching contraction, a known rounding and a
    grid CUDA can launch."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{what} takes int8, got {a.dtype} x {b.dtype}")
    if a.dim() < 2 or a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2] \
            or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} are not [..., M, K] x "
                         "[..., K, N]")
    if b.device != a.device:
        raise ValueError(f"{what}: operands on {a.device} and {b.device}")
    if rounding not in ("floor", "nearest"):
        raise ValueError(f"unknown rounding {rounding!r}")
    batch = math.prod(a.shape[:-2])
    if batch > MAX_GRID_YZ or -(-a.shape[-2] // TILE_M) > MAX_GRID_YZ:
        raise ValueError(f"{what}: batch {batch} or M {a.shape[-2]} is "
                         "beyond one launch's grid")


def _launch(a, b, shift: int, rounding: str, plan: GemmPlan | None = None):
    """[batch, M, K] x [batch, K, N] -> [batch, M, N] on the route of
    `plan` (gemm_plan's when None); returns the output and the plan."""
    a, b = a.contiguous(), b.contiguous()
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(a.shape[:-1] + (N,), dtype=torch.int8, device=a.device)
    epi = (int(shift), int(rounding == "nearest"))
    with torch.cuda.device(a.device):
        plan = plan_for(a, b) if plan is None else plan
        if plan.route == "wgmma":
            wgmma_route("q7_matmul", plan, a, b, out, epi)
        else:
            err = entry("q7_matmul", "q7_matmul_launch")(
                a.data_ptr(), b.data_ptr(), out.data_ptr(),
                math.prod(a.shape[:-2]), M, N, K, *epi,
                torch.cuda.current_stream().cuda_stream)
            build.check(err, "q7_matmul")
    return out, plan


def matmul_q7(a, b, shift: int, rounding: str = "floor"):
    """[M, K] x [K, N] int8 -> int8: int32 accumulation, then one shift
    (nearest adds the half-LSB, a negative shift shifts left) and sat8."""
    if a.device.type == "cpu":
        return matmul_q7_plain(a, b, shift, rounding)
    if a.device.type != "cuda":
        raise NotImplementedError(f"matmul_q7 on {a.device}")
    if a.dim() != 2:
        raise ValueError(f"matmul_q7 takes 2-D operands, got "
                         f"{tuple(a.shape)} (use bmm_q7 for a batch)")
    check_operands("matmul_q7", a, b, rounding)
    out, plan = _launch(a, b, shift, rounding)
    matmul_q7.launches += 1
    matmul_q7.launches_by_route[plan.route] += 1
    return out


def bmm_q7(a, b, shift: int, rounding: str = "floor"):
    """[..., M, K] x [..., K, N] int8 -> int8 [..., M, N], the batch on
    the grid of each launch."""
    if a.device.type == "cpu":
        return bmm_q7_plain(a, b, shift, rounding)
    if a.device.type != "cuda":
        raise NotImplementedError(f"bmm_q7 on {a.device}")
    check_operands("bmm_q7", a, b, rounding)
    out, plan = _launch(a, b, shift, rounding)
    bmm_q7.launches += 1
    bmm_q7.launches_by_route[plan.route] += 1
    return out


for _fn in (matmul_q7, bmm_q7):
    _fn.launches = 0
    _fn.launches_by_route = dict.fromkeys(ROUTES, 0)
