"""Dynamic routing between capsules (Sabour et al. 2017, Algorithm 1):
the float squash (Eq. 1), the nonlinearity of the float face
(`fwd_f32`) the calibration pass runs, and the float routing loop.

u_hat [B, J, I, O]: prediction of capsule j (layer L+1) from capsule i
(layer L).  Coupling logits b start at zero; each iteration couples via a
softmax over the *output* capsules j, forms s_j = sum_i c_ij u_hat_ji,
squashes, and reinforces b by the agreement <u_hat_ji, v_j>.
"""
from __future__ import annotations

import torch


def squash(s, axis: int = -1, eps: float = 1e-7):
    """v = (|s|^2 / (1+|s|^2)) * s/|s|  (Eq. 1), fp32 internals."""
    s = s.to(torch.float32)
    sq = torch.sum(s * s, dim=axis, keepdim=True)
    return (sq / (1.0 + sq)) * s * torch.rsqrt(sq + eps)


def dynamic_routing(u_hat, num_iters: int = 3):
    """u_hat [B, J, I, O] -> (v [B, J, O] in u_hat's dtype, None): the
    reference's return, whose second slot never holds the coupling."""
    B, J, I, _ = u_hat.shape
    b = torch.zeros((B, J, I), dtype=torch.float32, device=u_hat.device)
    u_f = u_hat.to(torch.float32)
    v = None
    for r in range(num_iters):
        c = torch.softmax(b, dim=1)              # over output capsules j
        s = torch.einsum("bji,bjio->bjo", c, u_f)
        v = squash(s, axis=-1)
        if r < num_iters - 1:
            b = b + torch.einsum("bjio,bjo->bji", u_f, v)
    return v.to(u_hat.dtype), None
