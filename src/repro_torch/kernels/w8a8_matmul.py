"""W8A8 GEMM with per-output-channel power-of-two shifts: the CUDA
kernel's wrapper and its plain version.

`w8a8_matmul` takes int8 a [M, K], w [K, N] and int32 col_shift [N].  A
tensor on the CPU goes to the plain version (`ref.w8a8_matmul_ref`); a
CUDA tensor goes to `csrc/w8a8_matmul.cu` or raises.  The kernel
replaces the Pallas TPU kernel
`repro.kernels.w8a8_matmul.w8a8_matmul_pallas`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.q7_matmul import check_operands
from repro_torch.kernels.ref import w8a8_matmul_ref

w8a8_matmul_plain = w8a8_matmul_ref


def _lib():
    fn = build.load("w8a8_matmul").w8a8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def w8a8_matmul(a, w, col_shift, rounding: str = "nearest"):
    """[M, K] x [K, N] int8 and int32 [N] shifts -> int8 [M, N]."""
    if a.device.type == "cpu":
        return w8a8_matmul_plain(a, w, col_shift, rounding)
    if a.device.type != "cuda":
        raise NotImplementedError(f"w8a8_matmul on {a.device}")
    if a.dim() != 2:
        raise ValueError(f"w8a8_matmul takes 2-D operands, got "
                         f"{tuple(a.shape)}")
    check_operands("w8a8_matmul", a, w, rounding)
    N = w.shape[1]
    if col_shift.dtype != torch.int32 or tuple(col_shift.shape) != (N,) \
            or col_shift.device != a.device:
        raise ValueError(f"w8a8_matmul: col_shift must be int32 [{N}] on "
                         f"{a.device}, got {col_shift.dtype} "
                         f"{tuple(col_shift.shape)} on {col_shift.device}")
    a, w, sh = a.contiguous(), w.contiguous(), col_shift.contiguous()
    M, K = a.shape
    out = torch.empty((M, N), dtype=torch.int8, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib()(a.data_ptr(), w.data_ptr(), sh.data_ptr(),
                     out.data_ptr(), M, N, K, int(rounding == "nearest"),
                     torch.cuda.current_stream().cuda_stream)
    build.check(err, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
