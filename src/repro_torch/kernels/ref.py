"""Plain torch oracles for every kernel in this package, the counterpart
of `repro.kernels.ref`.

The integer semantics live in `repro_torch.quant.int8_ops`; this module
re-exports them under kernel-facing names and adds the per-channel W8A8
reference, the fused-routing oracle and the float squash.
"""
from __future__ import annotations

import torch

from repro_torch.core.routing import squash as squash_float_ref  # noqa: F401
from repro_torch.quant.int8_ops import (  # noqa: F401  (re-exported oracles)
    INT8_MAX, INT8_MIN, add_q7, conv2d_q7, einsum_i32, isqrt_newton,
    matmul_q7, matmul_q7_acc, relu_q7, rshift_sat8, softmax_q7,
    softmax_q7_precise, squash_q7,
)


def w8a8_matmul_ref(a, w, col_shift, rounding: str = "nearest"):
    """[M,K] int8 x [K,N] int8 -> int8 [M,N] with per-output-channel
    power-of-two shifts (beyond-paper granularity; still shift-only)."""
    acc = matmul_q7_acc(a, w)
    sh = torch.as_tensor(col_shift, device=acc.device).to(torch.int32)[None, :]
    zero = torch.zeros_like(sh)
    if rounding == "nearest":
        half = torch.ones_like(sh) << (sh - 1).clamp(min=0)
        acc = acc + torch.where(sh > 0, half, zero)
    acc = torch.where(sh >= 0, acc >> sh.clamp(min=0),
                      acc << (-sh).clamp(min=0))
    return acc.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def routing_q7_ref(u_hat, num_iters: int, caps_out_shifts, caps_out_fracs,
                   agree_shifts, logit_frac: int, rounding: str = "floor",
                   softmax_impl: str = "q7"):
    """Fused dynamic-routing oracle (Alg. 5 inner loop, int8):
    u_hat int8 [B, J, I, O] -> v int8 [B, J, O] (Q0.7)."""
    from repro_torch.kernels.routing import routing_q7_plain
    from repro_torch.nn.variants import REGISTRY
    return routing_q7_plain(
        u_hat, num_iters=num_iters, caps_out_shifts=caps_out_shifts,
        caps_out_fracs=caps_out_fracs, agree_shifts=agree_shifts,
        logit_frac=logit_frac, rounding=rounding,
        softmax=REGISTRY.get("softmax", softmax_impl).q7)
