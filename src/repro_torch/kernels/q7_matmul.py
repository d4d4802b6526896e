"""int8 GEMM with the q7 scalar-shift epilogue: the CUDA kernel's
wrappers and their plain versions.

`matmul_q7` takes int8 [M, K] x [K, N]; `bmm_q7` takes [..., M, K] x
[..., K, N] with equal leading axes (the reference's `vmap` over the 2-D
kernel) and makes one launch with the batch on the grid.  A tensor on
the CPU goes to the plain version; a CUDA tensor goes to
`csrc/q7_matmul.cu` or raises.  The kernel replaces the Pallas TPU
kernel `repro.kernels.q7_matmul.q7_matmul_pallas`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.quant import int8_ops as q

MAX_GRID_YZ = 65_535                     # CUDA's gridDim.y / gridDim.z limit
TILE_M = 128                             # csrc/i8_gemm.cuh kBM


matmul_q7_plain = q.matmul_q7          # exact float64 product


def bmm_q7_plain(a, b, shift: int, rounding: str = "floor"):
    """[..., M, K] x [..., K, N] int8 -> int8, one product per batch entry."""
    return q.rshift_sat8(q.einsum_i32("...mk,...kn->...mn", a, b), shift,
                         rounding)


def _lib():
    fn = build.load("q7_matmul").q7_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def _launch(a, b, shift: int, rounding: str):
    """One launch over [batch, M, K] x [batch, K, N] -> [batch, M, N]."""
    a, b = a.contiguous(), b.contiguous()
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(a.shape[:-1] + (N,), dtype=torch.int8, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     math.prod(a.shape[:-2]), M, N, K, int(shift),
                     int(rounding == "nearest"),
                     torch.cuda.current_stream().cuda_stream)
    build.check(err, "q7_matmul")
    return out


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
    out = _launch(a, b, shift, rounding)
    matmul_q7.launches += 1
    return out


matmul_q7.launches = 0


def bmm_q7(a, b, shift: int, rounding: str = "floor"):
    """[..., M, K] x [..., K, N] int8 -> int8 [..., M, N], one launch."""
    if a.device.type == "cpu":
        return bmm_q7_plain(a, b, shift, rounding)
    if a.device.type != "cuda":
        raise NotImplementedError(f"bmm_q7 on {a.device}")
    check_operands("bmm_q7", a, b, rounding)
    out = _launch(a, b, shift, rounding)
    bmm_q7.launches += 1
    return out


bmm_q7.launches = 0
