"""W8A8 GEMM with per-output-channel power-of-two shifts: the CUDA
kernel's wrapper and its plain version.

`w8a8_matmul` takes int8 a [M, K], w [K, N] and int32 col_shift [N].  A
tensor on the CPU goes to the plain version (`ref.w8a8_matmul_ref`); a
CUDA tensor goes to `csrc/w8a8_matmul.cu` or raises, on the route that
`q7_matmul.gemm_plan` picks (counted in `launches_by_route`).  The
kernel replaces the Pallas TPU kernel
`repro.kernels.w8a8_matmul.w8a8_matmul_pallas`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.q7_matmul import (ROUTES, GemmPlan, check_operands,
                                           entry, plan_for, wgmma_route)
from repro_torch.kernels.ref import w8a8_matmul_ref

w8a8_matmul_plain = w8a8_matmul_ref


def _launch(a, w, sh, rounding: str, plan: GemmPlan | None = None):
    """[M, K] x [K, N] with int32 [N] shifts -> [M, N] on the route of
    `plan` (gemm_plan's when None); returns the output and the plan."""
    a, w, sh = a.contiguous(), w.contiguous(), sh.contiguous()
    M, K = a.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.int8, device=a.device)
    nearest = int(rounding == "nearest")
    with torch.cuda.device(a.device):
        plan = plan_for(a, w) if plan is None else plan
        if plan.route == "wgmma":
            wgmma_route("w8a8_matmul", plan, a, w, out,
                        (sh.data_ptr(), nearest))
        else:
            err = entry("w8a8_matmul", "w8a8_matmul_launch")(
                a.data_ptr(), w.data_ptr(), sh.data_ptr(), out.data_ptr(), M,
                N, K, nearest, torch.cuda.current_stream().cuda_stream)
            build.check(err, "w8a8_matmul")
    return out, plan


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
    out, plan = _launch(a, w, col_shift, rounding)
    w8a8_matmul.launches += 1
    w8a8_matmul.launches_by_route[plan.route] += 1
    return out


w8a8_matmul.launches = 0
w8a8_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
