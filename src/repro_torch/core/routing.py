"""Float squash (Sabour et al. 2017, Eq. 1), the nonlinearity of the
float face (`fwd_f32`) the calibration pass runs."""
from __future__ import annotations

import torch


def squash(s, axis: int = -1, eps: float = 1e-7):
    """v = (|s|^2 / (1+|s|^2)) * s/|s|  (Eq. 1), fp32 internals."""
    s = s.to(torch.float32)
    sq = torch.sum(s * s, dim=axis, keepdim=True)
    return (sq / (1.0 + sq)) * s * torch.rsqrt(sq + eps)
