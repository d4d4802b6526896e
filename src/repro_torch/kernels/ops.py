"""Public entry point of the kernel library, the counterpart of
`repro.kernels.ops`: the same functions under the same names, with the
arguments that define each function.

Each call dispatches on its tensor's device: a CPU tensor takes the plain
torch version, a CUDA tensor the hand-written kernel, anything else
raises.  `w8a8_dense` (the W8A8 dense product of the LM path, with a
power-of-two dequantizing epilogue) and `w8a8_bmm` (its batched face,
the MoE expert products) have no counterpart there: the reference
computes them with XLA (`repro.quant.lm_quant.q_dense`, `q_einsum`).  The
reference's TPU tiling arguments (`bm`, `bn`, `bk`) and its
`interpret` switch are gone: the kernels pick their own tiles and mask
ragged edges themselves, so no caller pads.
"""
from __future__ import annotations

from repro_torch.kernels import routing as _routing
from repro_torch.kernels.q7_matmul import bmm_q7, matmul_q7
from repro_torch.kernels.squash import squash_float, squash_q7
from repro_torch.kernels.w8a8_dense import w8a8_bmm, w8a8_dense
from repro_torch.kernels.w8a8_matmul import w8a8_matmul

__all__ = ["bmm_q7", "matmul_q7", "routing_q7", "squash_float", "squash_q7",
           "w8a8_bmm", "w8a8_dense", "w8a8_matmul"]


def routing_q7(u_hat, num_iters: int, caps_out_shifts, caps_out_fracs,
               agree_shifts, logit_frac: int, rounding: str = "floor"):
    """Fused dynamic routing: u_hat [B,J,I,O] int8 -> v [B,J,O] int8."""
    return _routing.routing_q7(
        u_hat, num_iters=num_iters, caps_out_shifts=tuple(caps_out_shifts),
        caps_out_fracs=tuple(caps_out_fracs),
        agree_shifts=tuple(agree_shifts), logit_frac=logit_frac,
        rounding=rounding)
