"""Integer squash (paper Eq. 8) and float squash (Eq. 1): the CUDA
kernels' wrappers and their plain versions.

`squash_q7` takes int8 [..., D] (D <= 32).  A tensor on the CPU goes to
the plain version (`repro_torch.quant.int8_ops.squash_q7`, the torch
oracle); a CUDA tensor goes to `csrc/squash_q7.cu` or raises.  The
kernel replaces the Pallas TPU kernel `repro.kernels.squash
.squash_q7_pallas`.  `squash_float` does the same for float [..., D]
with `csrc/squash_float.cu` (replacing `squash_float_pallas`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.routing import squash
from repro_torch.kernels import build
from repro_torch.quant import int8_ops as q

MAX_DIM = 32                           # csrc/q7.cuh kMaxDim

squash_q7_plain = q.squash_q7


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> (kernel library, argtypes)
_ENTRIES = {
    "squash_q7_launch": ("squash_q7", [_P, _P, _I, _I, _I, _I, _P]),
    "isqrt_launch": ("squash_q7", [_P, _P, _I, _P]),
    "squash_float_launch": ("squash_float",
                            [_P, _P, _L, _I, _L, _I, _I, _I, _I, _P]),
    "squash_float_floor_launch": ("squash_float", [_P]),
}


@functools.cache
def _launch(entry: str):
    """A C entry of a squash kernel library with its argtypes, bound
    once."""
    lib, argtypes = _ENTRIES[entry]
    fn = getattr(build.load(lib), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def isqrt(n):
    """The kernels' device isqrt (`q7::isqrt` in csrc/q7.cuh) on an int32
    tensor: a check entry, since the squash and routing kernels inline
    it.  It equals `int8_ops.isqrt_newton`, which CPU tensors take."""
    if n.device.type == "cpu":
        return q.isqrt_newton(n)
    if n.device.type != "cuda" or n.dtype != torch.int32:
        raise NotImplementedError(f"isqrt on {n.device} {n.dtype}")
    src = n.contiguous()
    if src.numel() >= 2 ** 31:
        raise ValueError("isqrt takes fewer than 2^31 elements a call")
    out = torch.empty_like(src)
    with torch.cuda.device(src.device):
        err = _launch("isqrt_launch")(
            src.data_ptr(), out.data_ptr(), src.numel(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "isqrt")
    isqrt.launches += 1
    return out


isqrt.launches = 0


def check_in_frac(in_frac: int) -> None:
    """The reference computes `1 << in_frac` on Python ints, which fits
    int32 for 0 <= in_frac <= 30 only; the kernels take that range."""
    if not 0 <= in_frac <= 30:
        raise ValueError(f"squash in_frac {in_frac} outside [0, 30]")


def squash_q7(s, in_frac: int, out_frac: int = 7):
    """[..., D] int8 -> int8, rows squashed independently."""
    if s.device.type == "cpu":
        return squash_q7_plain(s, in_frac=in_frac, out_frac=out_frac)
    if s.device.type != "cuda":
        raise NotImplementedError(f"squash_q7 on {s.device}")
    if s.dtype != torch.int8:
        raise TypeError(f"squash_q7 takes int8, got {s.dtype}")
    D = s.shape[-1]
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"squash_q7 takes capsule dim 1..{MAX_DIM}, got {D}")
    check_in_frac(in_frac)
    s2 = s.reshape(-1, D).contiguous()
    out = torch.empty_like(s2)
    with torch.cuda.device(s.device):
        err = _launch("squash_q7_launch")(
            s2.data_ptr(), out.data_ptr(), s2.shape[0], D, in_frac,
            out_frac, torch.cuda.current_stream().cuda_stream)
    build.check(err, "squash_q7")
    squash_q7.launches += 1
    return out.reshape(s.shape)


squash_q7.launches = 0


FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_FLOAT_DIM = 1024                   # csrc/squash_float.cu: 32 lanes x 32
FLOAT_PATHS = ("packed", "lanes", "element")


class SquashFloatPlan(NamedTuple):
    path: str                          # one of FLOAT_PATHS
    lanes: int                         # lanes sharing a row (packed: 1)
    chunks: int                        # packed: rows a 16-byte word; else
    #                                    16-byte words or elements a lane


def squash_float_plan(D: int, itemsize: int, row_stride: int,
                      ptr: int) -> SquashFloatPlan:
    """The path of `csrc/squash_float.cu` for rows of D elements of
    `itemsize` bytes, `row_stride` elements apart, the first at address
    `ptr`.  "packed" where whole rows fill 16-byte words (a row of 2, 4,
    8 or 16 bytes, rows contiguous, ptr 16-byte aligned); "lanes" where
    each row is whole 16-byte words, 16-byte aligned, at most 4 words a
    lane of a 32-lane group; "element" otherwise.  Lane groups are the
    least power of two that keeps a lane's share within what the kernel
    holds in registers."""
    row_bytes = D * itemsize
    aligned = ptr % 16 == 0
    if aligned and row_bytes <= 16 and 16 % row_bytes == 0 \
            and row_stride == D:
        return SquashFloatPlan("packed", 1, 16 // row_bytes)
    if aligned and row_bytes % 16 == 0 and row_stride * itemsize % 16 == 0 \
            and row_bytes // 16 <= 32 * 4:
        words = row_bytes // 16
        lanes = min(32, 1 << (words - 1).bit_length())
        return SquashFloatPlan("lanes", lanes, 1 if words <= lanes else 4)
    lanes = min(32, 1 << (D - 1).bit_length())
    need = -(-D // lanes)
    return SquashFloatPlan("element", lanes,
                           next(n for n in (1, 4, 32) if n >= need))


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def squash_float_plain(s):
    """Float squash (Eq. 1) in float32, returned in the input's dtype."""
    return squash(s).to(s.dtype)


def squash_float(s):
    """[..., D] float -> the same dtype, rows squashed in float32 (the
    Pallas kernel's output keeps `s.dtype`).  CPU tensors take the plain
    `squash_float_plain`; a CUDA tensor goes to `csrc/squash_float.cu`,
    which replaces `repro.kernels.squash.squash_float_pallas`, in one
    launch on the path `squash_float_plan` names.  The kernel reads the
    rows where they lie (a view such as s[:, 1:] included); only a tensor
    whose rows are not equally strided, or whose elements are not
    adjacent, is copied first."""
    if s.device.type == "cpu":
        return squash_float_plain(s)
    if s.device.type != "cuda":
        raise NotImplementedError(f"squash_float on {s.device}")
    if s.dtype not in FLOAT_DTYPES:
        raise TypeError(f"squash_float takes {FLOAT_DTYPES}, got {s.dtype}")
    D = s.shape[-1]
    if D > MAX_FLOAT_DIM:
        raise ValueError(f"squash_float takes rows of at most "
                         f"{MAX_FLOAT_DIM} elements, got {D}")
    s2 = s.reshape(-1, D)
    if D > 1 and s2.stride(1) != 1:
        s2 = s2.contiguous()
    R = s2.shape[0]
    out = torch.empty((R, D), dtype=s.dtype, device=s.device)
    if out.numel() == 0:
        return out.reshape(s.shape)
    rs = s2.stride(0) if R > 1 else D
    plan = squash_float_plan(D, s2.element_size(), rs, s2.data_ptr())
    with torch.cuda.device(s.device):
        err = _launch("squash_float_launch")(
            s2.data_ptr(), out.data_ptr(), R, D, rs, _DTYPE_CODE[s.dtype],
            FLOAT_PATHS.index(plan.path), plan.lanes, plan.chunks,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, f"squash_float {plan}")
    squash_float.launches += 1
    return out.reshape(s.shape)


squash_float.launches = 0


def squash_float_floor(device) -> None:
    """Launch the empty kernel of `csrc/squash_float.cu` on `device`: its
    device time is the least any launch of the squash can take."""
    with torch.cuda.device(device):
        err = _launch("squash_float_floor_launch")(
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "squash_float_floor")
