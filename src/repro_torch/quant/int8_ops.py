"""Exact int8 operation semantics in torch (the integer oracle layer).

These functions define the integer arithmetic the CUDA kernels must
reproduce bit for bit: int8 operands, int32 accumulation, power-of-two
rescale (arithmetic shift), saturation to [-128, 127].  They run on any
device and hold `repro.quant.int8_ops` bit for bit
(tests/test_torch_int8_ops.py), including its edge semantics:

* shifts: torch's `<<` / `>>` on int32 follow XLA's rules for amounts
  outside [0, 31] (left gives 0, right gives the sign fill);
* overflow: int32 adds and multiplies wrap, as XLA's do;
* division: every `//` is a floor division (`torch.div(...,
  rounding_mode="floor")`), as jnp's is;
* sums: `torch.sum` of int32 returns int64, so every reduction asks for
  `dtype=torch.int32` to keep jnp's int32 accumulator.

Products that jnp computes on XLA's int32 conv / einsum run here in
float64: every partial sum is an integer far below 2^53, so the result
is exact and does not depend on the summation order (`_exact_int32`).
cuDNN's float convolutions are avoided, since their Winograd and FFT
algorithms are not exact.

`rounding="floor"` matches the paper/CMSIS `__SSAT(sum >> shift, 8)`
truncation; `rounding="nearest"` adds the half-LSB before shifting.

`rshift_sat8` and `rshift_sat8_vec` are numerics-probe sites
(`repro_torch.obs.numerics`): with a probe installed they report the
accumulator as passed; without one the hook is a single `None` check.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.obs import numerics as _health

INT8_MIN, INT8_MAX = -128, 127
SQUASH_GUARD_BITS = 10
EXP_FLOOR = -20                      # exponent clamp shared by softmaxes


def _i32(x):
    return x.to(torch.int32)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _sum32(x, dim: int, keepdim: bool = True):
    return x.sum(dim=dim, keepdim=keepdim, dtype=torch.int32)


def _exact_int32(y):
    """float64 holding exact integers -> int32, wrapping like XLA."""
    return y.to(torch.int64).to(torch.int32)


def einsum_i32(eq: str, *operands):
    """Integer einsum with jnp's int32 result, computed exactly in float64."""
    return _exact_int32(torch.einsum(eq, *(t.to(torch.float64)
                                           for t in operands)))


def rshift_sat8(acc, shift: int, rounding: str = "floor"):
    """int32 accumulator -> int8 via arithmetic shift + saturate."""
    if _health._PROBE is not None:     # observer only
        _health.observe_requant(acc, shift, rounding)
    acc = _i32(acc)
    if shift > 0:
        if rounding == "nearest":
            acc = acc + (1 << (shift - 1))
        acc = acc >> shift
    elif shift < 0:
        acc = acc << -shift
    return acc.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def sat8(x):
    return _i32(x).clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def matmul_q7_acc(a, b):
    """Raw int32 accumulator of a [..., K] x b [..., K, N].

    The reference's `lax.dot_general` contracts a's last axis with b's
    second-to-last and has no batch axes, so a 3-D operand gives a's
    free axes followed by b's ([B,M,K] x [B,K,N] -> [B,M,B,N]): this is
    `torch.tensordot`, not the broadcasting `torch.matmul`."""
    acc = torch.tensordot(a.to(torch.float64), b.to(torch.float64),
                          dims=([a.dim() - 1], [b.dim() - 2]))
    return _exact_int32(acc)


def matmul_q7(a, b, shift: int, rounding: str = "floor"):
    """[..., M, K] int8 x [..., K, N] int8 -> int8, int32 accumulation
    (the paper's `mat_mult_q7` family; axes as in `matmul_q7_acc`)."""
    return rshift_sat8(matmul_q7_acc(a, b), shift, rounding)


def add_q7(a, b, shift_a: int = 0, shift_b: int = 0):
    """Saturating int8 addition with per-operand alignment shifts."""
    aa = _i32(a) << max(-shift_a, 0) if shift_a <= 0 else _i32(a) >> shift_a
    bb = _i32(b) << max(-shift_b, 0) if shift_b <= 0 else _i32(b) >> shift_b
    return sat8(aa + bb)


def _conv_acc(x, w, stride: int, padding: str):
    """NHWC int8 x HWIO int8 -> NHWC int32 accumulator, VALID padding.

    im2col (`F.unfold`) and one float64 matmul; exact for any int8
    geometry whose accumulators fit int32 (far below 2^53)."""
    if padding != "VALID":
        raise NotImplementedError(f"padding {padding!r}: only VALID")
    B, H, W, _ = x.shape
    KH, KW, Cin, Cout = w.shape
    cols = F.unfold(x.permute(0, 3, 1, 2).to(torch.float64), (KH, KW),
                    stride=stride)                     # [B, Cin*KH*KW, L]
    w2 = w.permute(3, 2, 0, 1).reshape(Cout, Cin * KH * KW) \
        .to(torch.float64)
    oh, ow = (H - KH) // stride + 1, (W - KW) // stride + 1
    acc = torch.matmul(w2, cols).reshape(B, Cout, oh, ow)
    return _exact_int32(acc.permute(0, 2, 3, 1))


def conv2d_q7(x, w, bias, out_shift: int, bias_shift: int,
              stride: int = 1, padding: str = "VALID",
              rounding: str = "floor"):
    """NHWC int8 conv, int32 accumulation, shifted bias, shift+sat output.

    x [B,H,W,Cin] int8; w [KH,KW,Cin,Cout] int8; bias [Cout] int8.
    bias is left-shifted by `bias_shift` into the accumulator's Qm.n
    (paper Alg. 6 line 10)."""
    acc = _conv_acc(x, w, stride, padding)
    if bias is not None:
        b = _i32(bias)
        b = b << bias_shift if bias_shift >= 0 else b >> -bias_shift
        acc = acc + b
    return rshift_sat8(acc, out_shift, rounding)


def rshift_sat8_vec(acc, shifts, rounding: str = "floor"):
    """rshift_sat8 with a per-lane shift array broadcast against the
    accumulator's trailing axes (the per-channel requantization step)."""
    if _health._PROBE is not None:     # observer only
        _health.observe_requant(acc, shifts, rounding)
    acc = _i32(acc)
    shifts = torch.as_tensor(shifts, dtype=torch.int32, device=acc.device)
    if rounding == "nearest":
        half = torch.ones_like(shifts) << (shifts - 1).clamp(min=0)
        acc = acc + torch.where(shifts > 0, half, torch.zeros_like(half))
    acc = acc >> shifts.clamp(min=0)
    acc = acc << (-shifts).clamp(min=0)
    return acc.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def conv2d_q7_per_channel(x, w, bias, out_shifts, bias_shifts,
                          stride: int = 1, padding: str = "VALID",
                          rounding: str = "floor"):
    """conv2d_q7 with per-output-channel bias and output shift tables."""
    acc = _conv_acc(x, w, stride, padding)
    if bias is not None:
        b = _i32(bias)
        bs = torch.as_tensor(bias_shifts, dtype=torch.int32,
                             device=b.device)
        b = b << bs.clamp(min=0)
        b = b >> (-bs).clamp(min=0)
        acc = acc + b
    return rshift_sat8_vec(acc, out_shifts, rounding)


def relu_q7(x):
    return x.clamp(min=0).to(torch.int8)


# ---------------------------------------------------------------------------
# integer square root (Newton-Raphson, paper Alg. 4) and squash (Eq. 8)
# ---------------------------------------------------------------------------
def isqrt_newton(n):
    """Integer sqrt of int32 n (elementwise): Alg. 4 as a fixed
    32-iteration Newton loop with the monotonicity guard."""
    n = _i32(n)
    x = _floordiv(n, 2).clamp(min=1)
    for _ in range(32):
        nxt = _floordiv(x + _floordiv(n, x.clamp(min=1)), 2)
        x = torch.where(nxt < x, nxt, x)
    return torch.where(n <= 1, n, x)


def _squash_factor(S, Q, in_frac: int, out_frac: int):
    """Eq. 8 ratio on a (norm, norm^2) pair; numerator >= 0, divisor
    >= 1 on every int8 input, so floor and truncating division agree."""
    shift = out_frac - in_frac + SQUASH_GUARD_BITS
    num = S << shift if shift >= 0 else S >> -shift
    den = (1 << in_frac) + (Q >> in_frac)
    return _floordiv(num, den.clamp(min=1))


def squash_q7(s, in_frac: int, out_frac: int = 7):
    """Integer squash (paper Eq. 8) over the last axis: s int8 [..., D]
    in Q(in_frac) -> int8 in Q(out_frac).  With Q = sum(s^2) and
    S = isqrt(Q):  ratio = (S << (o - i + P)) // ((1 << i) + (Q >> i)),
    v = sat8((ratio * s) >> P), P = SQUASH_GUARD_BITS."""
    s32 = _i32(s)
    Q = _sum32(s32 * s32, -1)
    ratio = _squash_factor(isqrt_newton(Q), Q, in_frac, out_frac)
    return sat8((ratio * s32) >> SQUASH_GUARD_BITS)


def squash_q7_approx(s, in_frac: int, out_frac: int = 7):
    """ISLPED'22 approximate squash: Eq. 8 with the L2 norm replaced by
    the L-inf norm M = max|s_i| (no integer square root)."""
    s32 = _i32(s)
    M = s32.abs().amax(dim=-1, keepdim=True)
    ratio = _squash_factor(M, M * M, in_frac, out_frac)
    return sat8((ratio * s32) >> SQUASH_GUARD_BITS)


# ---------------------------------------------------------------------------
# softmax variants (over the last axis, Q0.7 output)
# ---------------------------------------------------------------------------
def _pow2_probs(x, in_frac: int):
    """2^(20 + max(floor(x - max), -20)) per element, int32."""
    x32 = _i32(x)
    e = ((x32 - x32.amax(dim=-1, keepdim=True)) >> in_frac) \
        .clamp(min=EXP_FLOOR)
    return torch.ones_like(e) << (20 + e)


def softmax_q7(x, in_frac: int):
    """Shift-based integer softmax (arm_softmax_q7 approach): powers of
    two of the integer part of (x - max), normalized to 128 = 1.0."""
    p = _pow2_probs(x, in_frac)
    tot = _sum32(p, -1)                      # <= n * 2^20, fits int32
    c = _floordiv(p << 7, tot.clamp(min=1))
    return c.clamp(0, INT8_MAX).to(torch.int8)


def softmax_q7_precise(x, in_frac: int):
    """Dequantize -> fp32 softmax -> requant Q0.7.  Its fp32 `exp` is
    not bit-reproducible across libraries: held to 1 LSB, not exactly."""
    xf = x.to(torch.float32) * (2.0 ** -in_frac)
    p = torch.softmax(xf, dim=-1)
    return torch.round(p * 128.0).clamp(0, INT8_MAX).to(torch.int8)


def ceil_log2_int(tot):
    """ceil(log2(tot)) for positive int32 tensors: the bit length of
    tot - 1, counted with shifts so the semantics are integer-exact."""
    t1 = _i32(tot) - 1
    k = torch.zeros_like(t1)
    for j in range(31):
        k = k + ((t1 >> j) > 0).to(torch.int32)
    return k


def softmax_q7_approx(x, in_frac: int):
    """ISLPED'22 approximate softmax: the same powers of two as
    `softmax_q7`, normalized by 2^ceil(log2(sum)) — one shift per
    element instead of an integer division."""
    p = _pow2_probs(x, in_frac)
    k = ceil_log2_int(_sum32(p, -1))        # >= 20: the max term is 2^20
    return (p >> (k - 7)).clamp(0, INT8_MAX).to(torch.int8)
