"""Integer squash (paper Eq. 8) and float squash (Eq. 1): the CUDA
kernels' wrappers and their plain versions.

`squash_q7` takes int8 [..., D] (D <= 16).  A tensor on the CPU goes to
the plain version (`repro_torch.quant.int8_ops.squash_q7`, the torch
oracle); a CUDA tensor goes to `csrc/squash_q7.cu` or raises.  The
kernel replaces the Pallas TPU kernel `repro.kernels.squash
.squash_q7_pallas`.  `squash_float` does the same for float [..., D]
with `csrc/squash_float.cu` (replacing `squash_float_pallas`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.routing import squash
from repro_torch.kernels import build
from repro_torch.quant import int8_ops as q

MAX_DIM = 16                           # csrc/q7.cuh kMaxDim

squash_q7_plain = q.squash_q7


@functools.cache
def _launch(entry: str):
    """A C entry of the squash_q7 library with its argtypes, bound once."""
    fn = getattr(build.load("squash_q7"), entry)
    fn.argtypes = {
        "squash_q7_launch": [ctypes.c_void_p, ctypes.c_void_p] +
        [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "isqrt_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p]}[entry]
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


def squash_float_plain(s):
    """Float squash (Eq. 1) in float32, returned in the input's dtype."""
    return squash(s).to(s.dtype)


def squash_float(s):
    """[..., D] float -> the same dtype, rows squashed in float32 (the
    Pallas kernel's output keeps `s.dtype`).  CPU tensors take the plain
    `squash_float_plain`; a CUDA tensor goes to `csrc/squash_float.cu`,
    which replaces `repro.kernels.squash.squash_float_pallas`."""
    if s.device.type == "cpu":
        return squash_float_plain(s)
    if s.device.type != "cuda":
        raise NotImplementedError(f"squash_float on {s.device}")
    if s.dtype not in FLOAT_DTYPES:
        raise TypeError(f"squash_float takes {FLOAT_DTYPES}, got {s.dtype}")
    D = s.shape[-1]
    s2 = s.reshape(-1, D).to(torch.float32).contiguous()
    out = torch.empty_like(s2)
    fn = build.load("squash_float").squash_float_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(s.device):
        err = fn(s2.data_ptr(), out.data_ptr(), s2.shape[0], D,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "squash_float")
    squash_float.launches += 1
    return out.reshape(s.shape).to(s.dtype)


squash_float.launches = 0
