"""Qm.n power-of-two quantization format calculus (paper §4, Alg. 7).

Symmetric, uniform, static, power-of-two scaling: a float A is stored as
round(A * 2^n) in int8, where n is the number of (possibly virtual)
fractional bits.  Every rescale in the int8 pass is then a bit shift:
    out_shift  = f_ia + f_ib - f_o      (right shift of the int32 accum)
    bias_shift = f_ia + f_ib - f_b      (left shift aligning the bias)

The fake-quant faces (`fake_quant`, `fake_quant_with_fracs`) are the QAT
counterparts: the same grid in float32, with a straight-through gradient.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.obs import numerics as _health

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


def dequantize(q, n: int):
    return torch.as_tensor(q).to(torch.float32) * (2.0 ** -n)


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


@dataclasses.dataclass(frozen=True)
class QTensor:
    """An int8 tensor + its Qm.n fractional-bit count."""
    q: torch.Tensor       # int8
    n: int                # fractional bits

    @property
    def float(self):
        return dequantize(self.q, self.n)

    @property
    def nbytes(self) -> int:
        return int(self.q.numel())


def qtensor(x, n: int | None = None) -> QTensor:
    if n is None:
        n = frac_bits(float(torch.as_tensor(x).abs().max()))
    return QTensor(quantize(x, n), n)


def out_shift(f_ia: int, f_ib: int, f_o: int) -> int:
    return f_ia + f_ib - f_o


def bias_shift(f_ia: int, f_ib: int, f_b: int) -> int:
    return f_ia + f_ib - f_b


# ---------------------------------------------------------------------------
# fake quantization (QAT): the same Qm.n clamp, straight-through gradient
# ---------------------------------------------------------------------------
def _ste(x, q):
    """Straight-through estimator: forward `x + (q - x)` (as the
    reference computes it, which may sit one ulp off `q`), gradient of
    the identity."""
    return x + (q - x).detach()


def _round(scaled, rounding: str):
    return torch.round(scaled) if rounding == "nearest" \
        else torch.floor(scaled)


def fake_quant(x, n: int, rounding: str = "nearest"):
    """quantize(x, n) -> dequantize, differentiably (STE).

    The forward lands on the Qm.n grid `quantize` produces: the same
    round/floor and the same [-128, 127] saturation.  "nearest" matches
    the weight/input quantizer; "floor" matches the truncating
    accumulator shift (`int8_ops.rshift_sat8`)."""
    x = torch.as_tensor(x).to(torch.float32)
    r = _round(x * (2.0 ** n), rounding)
    if _health._PROBE is not None:     # count STE-clipped grid values
        _health.observe_fq(r)
    q = r.clamp(INT8_MIN, INT8_MAX) * (2.0 ** -n)
    return _ste(x, q)


def fake_quant_with_fracs(x, ns, axis: int, rounding: str = "nearest"):
    """Per-slice fake quantization along `axis` (the QAT face of
    `quantize_with_fracs`; `ns` comes from a plan, e.g.
    `ConvPlan.w_frac_per_channel`).  Stays in torch, differentiable."""
    x = torch.as_tensor(x).to(torch.float32)
    shape = [1] * x.ndim
    shape[axis] = -1
    scale = torch.exp2(torch.as_tensor(ns, dtype=torch.float32,
                                       device=x.device).reshape(shape))
    r = _round(x * scale, rounding)
    if _health._PROBE is not None:     # count STE-clipped grid values
        _health.observe_fq(r)
    q = r.clamp(INT8_MIN, INT8_MAX) / scale
    return _ste(x, q)
