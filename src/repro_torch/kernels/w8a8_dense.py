"""W8A8 dense product with a power-of-two dequantizing epilogue: the CUDA
kernel's wrappers and their plain version.

`w8a8_dense(xq, wt, xe, n, out_dtype)` takes int8 xq [M, K], int8 W
stored K-major as wt [N, K] (the port's W8A8 leaf "qt",
`quant.lm_quant`), the activation's exponent xe (a one-element tensor,
its value an integer) and int32 n [N], and returns out_dtype(float32(xq
@ wt^T) * 2^-(xe + n[col])): the product `repro.quant.lm_quant.q_dense`
computes with XLA's int8 dot_general from W [K, N].
`w8a8_bmm(xq, wt, xe, n, out_dtype)` is its batched face, xq [E, M, K],
wt [E, N, K] and n [E, N] (each batch entry its own column exponents,
one xe for all) -> [E, M, N]: the MoE expert products
`repro.quant.lm_quant.q_einsum` computes with XLA's int8 einsum.  No TPU
kernel computes either (the reference leaves them to XLA); on the card
both are `csrc/w8a8_dense.cu`, the batch on the grid, on the same two
GEMM main loops and the same `gemm_plan` as `q7_matmul` and
`w8a8_matmul`, with W read as it is stored (no transpose launch), each
wrapper counted in its own `launches` and `launches_by_route`.  A
tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel or raises; a meta tensor gets the output's shape and dtype (a
dry run's face).  Under an `op_analysis` counter each call is one
kernel in the tally, 2 M N K int8 operations a batch entry and the bytes
of xq, wt, n, xe and the output.  xe is read on the card by the kernel,
so a call never waits for the device.

Both build the scale 2^-(xe + n) from its float32 exponent bits, exact
for exponents in [-126, 127] (the quantizers clip xe and n to [-24,
24]): `torch.ldexp` multiplies by pow(2, e), and CUDA's powf promises no
exact result.  With exact scales the kernel and the plain version agree
bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import op_analysis
from repro_torch.kernels import build
from repro_torch.kernels.q7_matmul import (ROUTES, GemmPlan, check_operands,
                                           entry, plan_for, wgmma_route)
from repro_torch.quant import int8_ops as q

OUT_DTYPES = (torch.bfloat16, torch.float32)


def pow2(e):
    """2.0 ** e as float32, exactly, for integer-valued e in [-126, 127]
    (any dtype): the exponent field of the result holds e + 127."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def w8a8_dense_plain(xq, wt, xe, n, out_dtype=torch.bfloat16):
    """The kernel's arithmetic in torch, over [..., M, K] and the
    K-major [..., N, K] with n [..., N] (equal leading axes, none for the
    2-D face): the int32 product (exact, wrapping), float32, times
    2^-(xe + n), one rounding to out_dtype."""
    acc = q.einsum_i32("...mk,...nk->...mn", xq, wt)
    e = xe.reshape(()).to(torch.int32) + n.to(torch.int32)[..., None, :]
    return (acc.to(torch.float32) * pow2(-e)).to(out_dtype)


def _check(what: str, dims: int, xq, wt, xe, n, out_dtype) -> None:
    """Raise for what the kernel does not take; wt is K-major [..., N,
    K], checked as its [..., K, N] view."""
    if xq.dim() != dims:
        raise ValueError(f"{what} takes {dims}-D operands, got "
                         f"{tuple(xq.shape)}")
    check_operands(what, xq, wt.transpose(-1, -2), "floor")
    n_shape = tuple(wt.shape[:-1])
    if n.dtype != torch.int32 or tuple(n.shape) != n_shape \
            or n.device != xq.device:
        raise ValueError(f"{what}: n must be int32 {list(n_shape)} on "
                         f"{xq.device}, got {n.dtype} {tuple(n.shape)} on "
                         f"{n.device}")
    if xe.numel() != 1 or xe.device != xq.device:
        raise ValueError(f"{what}: xe must be one element on "
                         f"{xq.device}, got {tuple(xe.shape)} on "
                         f"{xe.device}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{what} writes {OUT_DTYPES}, not {out_dtype}")


def _launch(xq, wt, xe, n, out_dtype, plan: GemmPlan | None = None):
    """[batch, M, K] and the K-major [batch, N, K] (or [M, K] and [N,
    K]) with the exponents -> out_dtype [batch, M, N] on the route of
    `plan` (gemm_plan's when None); returns the output and the plan."""
    xq, wt, n = xq.contiguous(), wt.contiguous(), n.contiguous()
    xe = xe.reshape(()).to(torch.int32)       # on the card, no wait
    M, K = xq.shape[-2:]
    N = wt.shape[-2]
    out = torch.empty(xq.shape[:-1] + (N,), dtype=out_dtype,
                      device=xq.device)
    epi = (xe.data_ptr(), n.data_ptr(), int(out_dtype == torch.bfloat16))
    with torch.cuda.device(xq.device):
        plan = plan_for(xq, wt, b_kmajor=True) if plan is None else plan
        if plan.route == "wgmma":
            wgmma_route("w8a8_dense", plan, xq, wt, out, epi, b_kmajor=True)
        else:
            err = entry("w8a8_dense", "w8a8_dense_launch")(
                xq.data_ptr(), wt.data_ptr(), *epi[:2], out.data_ptr(),
                math.prod(xq.shape[:-2]), M, N, K, epi[2],
                torch.cuda.current_stream().cuda_stream)
            build.check(err, "w8a8_dense")
    return out, plan


def _cost(xq, wt, xe, n, out_dtype) -> tuple:
    """(int8 operations, bytes) of one call: 2 M N K a batch entry; xq,
    wt, n and xe read once, the output written once."""
    M, K = xq.shape[-2:]
    N = wt.shape[-2]
    batch = math.prod(xq.shape[:-2])
    out = batch * M * N * torch.finfo(out_dtype).bits // 8
    return 2.0 * batch * M * N * K, float(
        xq.numel() * xq.element_size() + wt.numel() * wt.element_size()
        + n.numel() * n.element_size() + xe.numel() * xe.element_size()
        + out)


def _call(fn, dims: int, xq, wt, xe, n, out_dtype):
    """The plain version on the CPU, the output's struct on the meta
    device, the kernel on the card (counted in fn's launches); any other
    device raises.  Under an `op_analysis` counter the call is one
    kernel in its tally, with its flops and bytes, whatever the device."""
    if op_analysis.active is not None:
        op_analysis.record_kernel(fn.__name__,
                                  *_cost(xq, wt, xe, n, out_dtype))
        with op_analysis.active.quiet():
            return _run(fn, dims, xq, wt, xe, n, out_dtype)
    return _run(fn, dims, xq, wt, xe, n, out_dtype)


def _run(fn, dims, xq, wt, xe, n, out_dtype):
    what = fn.__name__
    if xq.device.type == "cpu":
        return w8a8_dense_plain(xq, wt, xe, n, out_dtype)
    if xq.device.type not in ("cuda", "meta"):
        raise NotImplementedError(f"{what} on {xq.device}")
    _check(what, dims, xq, wt, xe, n, out_dtype)
    if xq.device.type == "meta":
        return torch.empty(xq.shape[:-1] + (wt.shape[-2],), dtype=out_dtype,
                           device=xq.device)
    out, plan = _launch(xq, wt, xe, n, out_dtype)
    fn.launches += 1
    fn.launches_by_route[plan.route] += 1
    return out


def w8a8_dense(xq, wt, xe, n, out_dtype=torch.bfloat16):
    """int8 [M, K] and K-major [N, K], exponents xe and n [N] ->
    out_dtype [M, N]."""
    return _call(w8a8_dense, 2, xq, wt, xe, n, out_dtype)


def w8a8_bmm(xq, wt, xe, n, out_dtype=torch.bfloat16):
    """int8 [E, M, K] and K-major [E, N, K], exponents xe and n [E, N]
    -> out_dtype [E, M, N], product e dequantized by n[e], the E products
    in one launch of each kernel of its route."""
    return _call(w8a8_bmm, 3, xq, wt, xe, n, out_dtype)


for _fn in (w8a8_dense, w8a8_bmm):
    _fn.launches = 0
    _fn.launches_by_route = dict.fromkeys(ROUTES, 0)
