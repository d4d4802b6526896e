"""Qm.n power-of-two quantization format calculus (paper §4, Alg. 7).

Symmetric, uniform, static, power-of-two scaling: a float A is stored as
round(A * 2^n) in int8, where n is the number of (possibly virtual)
fractional bits.  Every rescale in the int8 pass is then a bit shift:
    out_shift  = f_ia + f_ib - f_o      (right shift of the int32 accum)
    bias_shift = f_ia + f_ib - f_b      (left shift aligning the bias)
"""
from __future__ import annotations

import math

import numpy as np
import torch

INT8_MIN, INT8_MAX = -128, 127
MAX_FRAC_BITS = 24


def frac_bits(max_abs: float) -> int:
    """Maximal n with round(max_abs * 2^n) <= 127 (Alg. 7), capped at
    MAX_FRAC_BITS for degenerate ranges."""
    max_abs = float(max_abs)
    if max_abs <= 0 or math.isnan(max_abs):
        return MAX_FRAC_BITS
    n = int(math.floor(math.log2(INT8_MAX / max_abs)))
    # floating point edge: ensure round(max_abs * 2^n) <= 127 < round(*2^(n+1))
    while round(max_abs * 2.0 ** (n + 1)) <= INT8_MAX and n < MAX_FRAC_BITS:
        n += 1
    while round(max_abs * 2.0 ** n) > INT8_MAX and n > -MAX_FRAC_BITS:
        n -= 1
    return n


def quantize(x, n: int):
    """float -> int8 in Qm.n (round half to even, clip to [-128, 127])."""
    q = torch.round(torch.as_tensor(x, dtype=torch.float32) * (2.0 ** n))
    return q.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def quantize_with_fracs(x, ns, axis: int):
    """float -> int8 with a per-slice fractional-bit table along `axis`
    (fracs already derived, e.g. carried by a ConvPlan).  Computed in
    NumPy float32 on the host, as the reference does."""
    t = torch.as_tensor(x)
    moved = np.moveaxis(t.detach().cpu().numpy().astype(np.float32), axis, 0)
    ns = np.asarray(ns, np.int32)
    scale = (2.0 ** ns).reshape((-1,) + (1,) * (moved.ndim - 1))
    q = np.clip(np.round(moved * scale), INT8_MIN, INT8_MAX).astype(np.int8)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(q, 0, axis))) \
        .to(t.device)


def quantize_per_channel(x, axis: int):
    """Per-slice power-of-two formats along `axis`.  Returns (int8
    tensor, n per slice as an int32 tensor)."""
    t = torch.as_tensor(x)
    moved = np.moveaxis(t.detach().cpu().numpy().astype(np.float32), axis, 0)
    ns = np.array([frac_bits(np.abs(c).max()) for c in moved], np.int32)
    return quantize_with_fracs(t, ns, axis), torch.from_numpy(ns)


def out_shift(f_ia: int, f_ib: int, f_o: int) -> int:
    return f_ia + f_ib - f_o


def bias_shift(f_ia: int, f_ib: int, f_b: int) -> int:
    return f_ia + f_ib - f_b
