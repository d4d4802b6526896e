"""Operator variants: the typed registry of softmax / squash choices.

A variant is one registration here; plans validate their variant fields
against the registry, and the backends, the edge VM, the C emitter and
the static checker resolve it through it.  The port carries two faces
of each registered variant, `q7` (the torch integer oracle) and `np_q7`
(the NumPy mirror the EdgeVM runs, copied from the reference), the
training faces `fq` (fake-quant, for QAT) and `f32` (the variant's plain
float math), plus the C emitter's kernel symbols:

  softmax  "q7"       arm_softmax-style shift softmax (paper baseline)
           "precise"  dequantize -> fp32 softmax -> requant
           "approx"   ISLPED'22: power-of-two normalizer, no division
  squash   "exact"    Eq. 8 with the Alg. 4 Newton-Raphson integer sqrt
           "approx"   ISLPED'22: L-inf norm instead of L2, no sqrt

`VariantSet` is the pipeline-level selection (one softmax + one squash)
attached to a `PipelinePlan` as plan edits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.routing import squash as _f32_squash_l2
from repro_torch.quant import int8_ops as q
from repro_torch.quant import qformat as qf

KINDS = ("softmax", "squash")
PLAN_FIELDS = {"softmax": "softmax_impl", "squash": "squash_impl"}

_INT8_MIN, _INT8_MAX = -128, 127
_SQUASH_GUARD_BITS = 10             # must match quant.int8_ops
_EXP_FLOOR = -20                    # exponent clamp shared by softmaxes


# ---------------------------------------------------------------------------
# NumPy faces (the EdgeVM semantics)
# ---------------------------------------------------------------------------
def _np_sat8(x):
    return np.clip(x, _INT8_MIN, _INT8_MAX).astype(np.int8)


def _np_ceil_log2(tot):
    """ceil(log2(tot)) for positive int32 arrays, integer-only (bit
    length of tot-1) so torch and NumPy cannot disagree on boundaries."""
    t1 = tot.astype(np.int32) - 1
    k = np.zeros_like(t1)
    for j in range(31):
        k = k + (np.right_shift(t1, j) > 0)
    return k


def _np_softmax_q7(x, in_frac: int):
    x32 = x.astype(np.int32)
    m = np.max(x32, axis=-1, keepdims=True)
    e = np.maximum(np.right_shift(x32 - m, in_frac), _EXP_FLOOR)
    p = np.left_shift(np.ones_like(e), 20 + e)
    tot = np.sum(p, axis=-1, keepdims=True, dtype=np.int32)
    c = np.left_shift(p, 7) // np.maximum(tot, 1)
    return np.clip(c, 0, _INT8_MAX).astype(np.int8)


def _np_softmax_q7_precise(x, in_frac: int):
    xf = x.astype(np.float32) * np.float32(2.0 ** -in_frac)
    xf = xf - xf.max(axis=-1, keepdims=True)
    p = np.exp(xf)
    p = p / p.sum(axis=-1, keepdims=True)
    c = np.round(p.astype(np.float32) * 128.0)
    return np.clip(c, 0, _INT8_MAX).astype(np.int8)


def _np_softmax_q7_approx(x, in_frac: int):
    """ISLPED'22 shift softmax: 2^floor(x-max) probabilities normalized
    by 2^ceil(log2(sum)) — division-free (one shift per element)."""
    x32 = x.astype(np.int32)
    m = np.max(x32, axis=-1, keepdims=True)
    e = np.maximum(np.right_shift(x32 - m, in_frac), _EXP_FLOOR)
    p = np.left_shift(np.ones_like(e), 20 + e)
    tot = np.sum(p, axis=-1, keepdims=True, dtype=np.int32)
    k = _np_ceil_log2(tot)                   # >= 20: the max term is 2^20
    c = np.right_shift(p, k - 7)
    return np.clip(c, 0, _INT8_MAX).astype(np.int8)


def _np_isqrt_newton(n):
    n = n.astype(np.int32)
    x = np.maximum(n // 2, 1)
    for _ in range(32):
        nxt = (x + n // np.maximum(x, 1)) // 2
        x = np.where(nxt < x, nxt, x)
    return np.where(n <= 1, n, x)


def _np_squash_factor(S, Q, in_frac: int, out_frac: int):
    """Eq. 8 ratio on a (norm, norm^2) pair; shared by both variants."""
    P = _SQUASH_GUARD_BITS
    shift = out_frac - in_frac + P
    num = np.left_shift(S, shift) if shift >= 0 \
        else np.right_shift(S, -shift)
    den = (1 << in_frac) + np.right_shift(Q, in_frac)
    return num // np.maximum(den, 1)


def _np_squash_q7(s, in_frac: int, out_frac: int = 7):
    s32 = s.astype(np.int32)
    Q = np.sum(s32 * s32, axis=-1, keepdims=True, dtype=np.int32)
    ratio = _np_squash_factor(_np_isqrt_newton(Q), Q, in_frac, out_frac)
    return _np_sat8(np.right_shift(ratio * s32, _SQUASH_GUARD_BITS))


def _np_squash_q7_approx(s, in_frac: int, out_frac: int = 7):
    """ISLPED'22 approximate squash: the L2 norm (32-iteration Newton
    isqrt, Alg. 4) is replaced by the L-inf norm max|s_i| — no sqrt."""
    s32 = s.astype(np.int32)
    M = np.max(np.abs(s32), axis=-1, keepdims=True)
    ratio = _np_squash_factor(M, M * M, in_frac, out_frac)
    return _np_sat8(np.right_shift(ratio * s32, _SQUASH_GUARD_BITS))


# ---------------------------------------------------------------------------
# float and fake-quant faces (training)
# ---------------------------------------------------------------------------
def _f32_softmax(b, axis: int = -1):
    return torch.softmax(b, dim=axis)


def _f32_ceil_log2(t):
    """ceil(log2(t)) on floats by counting powers of two strictly below
    t (t in [2^-20, 2^30)).  The float face only: a float32 normalizer
    sum can itself round across a power-of-two boundary, so the
    fake-quant face mirrors the integer op's int32 sum instead."""
    K = torch.full_like(t, float(_EXP_FLOOR - 1))
    for j in range(_EXP_FLOOR - 1, 31):
        K = K + (t > 2.0 ** j).to(t.dtype)
    return K


def _pow2_exponents(b, axis: int):
    """floor(b - max) clamped at the shared exponent floor."""
    return torch.clamp(torch.floor(b - b.amax(dim=axis, keepdim=True)),
                       min=float(_EXP_FLOOR))


def _f32_softmax_approx(b, axis: int = -1):
    """Float math of the shift softmax (dequantized semantics)."""
    p = torch.exp2(_pow2_exponents(b, axis))
    t = p.sum(dim=axis, keepdim=True)
    return p * torch.exp2(-_f32_ceil_log2(t))


def _f32_squash(s):
    return _f32_squash_l2(s, axis=-1)


def _f32_squash_approx(s):
    M = s.abs().amax(dim=-1, keepdim=True)
    return s * M / (1.0 + M * M)


# Softmax fq faces take the routing logits [B, J, I] and return couplings
# over dim 1 (the routing loop's QAT convention); the float softmax is the
# straight-through surrogate.  `sm + (c - sm).detach()` is kept as the
# reference writes it: its value may sit one ulp off the Q0.7 grid.
def _fq_softmax_q7(b):
    sm = torch.softmax(b, dim=1)
    p = torch.exp2(_pow2_exponents(b, 1))
    c = torch.clamp(torch.floor(p * 128.0 / p.sum(dim=1, keepdim=True)),
                    0.0, 127.0) / 128.0
    return sm + (c - sm).detach()


def _fq_softmax_precise(b):
    return qf.fake_quant(torch.softmax(b, dim=1), 7)


def _fq_softmax_approx(b):
    sm = torch.softmax(b, dim=1)
    e = _pow2_exponents(b, 1)
    # the normalizer exponent is computed as the integer op computes it
    # (int32 sum of powers of two + integer ceil-log2): a float32 sum of
    # exp2(e) loses its tail once >= 16 logits tie at the max and would
    # round K across a power-of-two boundary
    p_int = torch.exp2(e - float(_EXP_FLOOR)).to(torch.int32)
    k = q.ceil_log2_int(p_int.sum(dim=1, keepdim=True, dtype=torch.int32))
    K = (k + _EXP_FLOOR).to(torch.float32)
    c = torch.clamp(torch.floor(torch.exp2(e - K) * 128.0), 0.0,
                    127.0) / 128.0
    return sm + (c - sm).detach()


# Squash fq faces: the variant's float math snapped onto the plan's
# output grid.
def _fq_squash(s, out_frac: int, rounding: str = "floor"):
    return qf.fake_quant(_f32_squash(s), out_frac, rounding)


def _fq_squash_approx(s, out_frac: int, rounding: str = "floor"):
    return qf.fake_quant(_f32_squash_approx(s), out_frac, rounding)


@dataclasses.dataclass(frozen=True)
class OpVariant:
    """One operator variant: its int8, training and float faces and its
    C kernel symbols."""
    name: str                       # registry key within its kind
    kind: str                       # "softmax" | "squash"
    description: str
    q7: Callable                    # torch int8 oracle
    np_q7: Callable                 # NumPy mirror (EdgeVM / MCU contract)
    fq: Callable                    # fake-quant (QAT) face
    f32: Callable                   # plain float math of the variant
    c_symbol: str                   # standalone kernel symbol (emit_c)
    c_suffix: str = ""              # routing-kernel symbol suffix

    @property
    def plan_field(self) -> str:
        return PLAN_FIELDS[self.kind]


class VariantRegistry:
    """(kind, name) -> OpVariant, with one default per kind."""

    def __init__(self):
        self._variants: dict = {}
        self._defaults: dict = {}

    def register(self, v: OpVariant, *, default: bool = False) -> OpVariant:
        if v.kind not in KINDS:
            raise ValueError(f"unknown op kind {v.kind!r}; have {KINDS}")
        key = (v.kind, v.name)
        if key in self._variants:
            raise ValueError(f"variant {v.kind}:{v.name} already registered")
        self._variants[key] = v
        if default:
            self._defaults[v.kind] = v.name
        return v

    def get(self, kind: str, name: str) -> OpVariant:
        try:
            return self._variants[(kind, name)]
        except KeyError:
            raise ValueError(
                f"unknown {kind} variant {name!r}; registered: "
                f"{', '.join(self.names(kind)) or '(none)'}") from None

    def names(self, kind: str) -> tuple:
        return tuple(sorted(n for k, n in self._variants if k == kind))

    def default(self, kind: str) -> str:
        return self._defaults[kind]

    def validate(self, kind: str, name: str) -> str:
        """Raise (listing registered names) unless `name` is registered."""
        self.get(kind, name)
        return name

    def is_registered(self, kind: str, name: str) -> bool:
        """Non-raising membership test (the static checker reports
        unknown references as diagnostics instead of exceptions)."""
        return (kind, name) in self._variants

    def from_attrs(self, kind: str, attrs: dict) -> OpVariant:
        """Resolve an EdgeOp attr dict's variant reference (the kind's
        plan-field key), defaulting for pre-variant artifacts — the
        accessor every edge consumer (VM, importer, C emitter) shares."""
        return self.get(kind, attrs.get(PLAN_FIELDS[kind],
                                        self.default(kind)))


REGISTRY = VariantRegistry()

REGISTRY.register(OpVariant(
    name="q7", kind="softmax",
    description="arm_softmax-style shift softmax (paper baseline): "
                "powers of two of floor(x - max), integer-divided by "
                "their sum",
    q7=q.softmax_q7, np_q7=_np_softmax_q7, fq=_fq_softmax_q7,
    f32=_f32_softmax, c_symbol="arm_softmax_q7"),
    default=True)
REGISTRY.register(OpVariant(
    name="precise", kind="softmax",
    description="dequantize -> fp32 softmax -> requant Q0.7 "
                "(beyond-paper accuracy reference)",
    q7=q.softmax_q7_precise, np_q7=_np_softmax_q7_precise,
    fq=_fq_softmax_precise, f32=_f32_softmax,
    c_symbol="capsnet_softmax_q7_precise", c_suffix="_softmax_precise"))
REGISTRY.register(OpVariant(
    name="approx", kind="softmax",
    description="ISLPED'22 approximate softmax: shift-based exp with "
                "power-of-two normalization — no integer division",
    q7=q.softmax_q7_approx, np_q7=_np_softmax_q7_approx,
    fq=_fq_softmax_approx, f32=_f32_softmax_approx,
    c_symbol="capsnet_softmax_q7_approx", c_suffix="_softmax_approx"))
REGISTRY.register(OpVariant(
    name="exact", kind="squash",
    description="Eq. 8 squash with Alg. 4 Newton-Raphson integer sqrt "
                "(paper baseline)",
    q7=q.squash_q7, np_q7=_np_squash_q7, fq=_fq_squash,
    f32=_f32_squash, c_symbol="capsnet_squash_q7"),
    default=True)
REGISTRY.register(OpVariant(
    name="approx", kind="squash",
    description="ISLPED'22 approximate squash: L-inf norm instead of "
                "the L2 norm — no square root",
    q7=q.squash_q7_approx, np_q7=_np_squash_q7_approx,
    fq=_fq_squash_approx, f32=_f32_squash_approx,
    c_symbol="capsnet_squash_q7_approx", c_suffix="_squash_approx"))

DEFAULT_SOFTMAX = REGISTRY.default("softmax")
DEFAULT_SQUASH = REGISTRY.default("squash")


@dataclasses.dataclass(frozen=True)
class VariantSet:
    """One softmax + one squash choice for a whole pipeline; validated
    against the registry at construction and applied as plan edits."""
    softmax: str = DEFAULT_SOFTMAX
    squash: str = DEFAULT_SQUASH

    def __post_init__(self):
        REGISTRY.validate("softmax", self.softmax)
        REGISTRY.validate("squash", self.squash)

    @property
    def tag(self) -> str:
        return f"{self.softmax}+{self.squash}"

    def is_default(self) -> bool:
        return self.softmax == DEFAULT_SOFTMAX \
            and self.squash == DEFAULT_SQUASH

    @classmethod
    def of_plan(cls, plan) -> "VariantSet":
        """Read the selection off a PipelinePlan's layer plans (they must
        agree — apply() is the only writer and keeps them uniform)."""
        sms, sqs = set(), set()
        for p in plan.layers.values():
            if hasattr(p, "softmax_impl"):
                sms.add(p.softmax_impl)
            if hasattr(p, "squash_impl"):
                sqs.add(p.squash_impl)
        if len(sms) > 1 or len(sqs) > 1:
            raise ValueError(
                f"plan mixes operator variants: softmax={sorted(sms)} "
                f"squash={sorted(sqs)}")
        return cls(softmax=sms.pop() if sms else DEFAULT_SOFTMAX,
                   squash=sqs.pop() if sqs else DEFAULT_SQUASH)

    def apply(self, plan):
        """Return a PipelinePlan with every variant-bearing layer plan
        switched to this selection (untouched plans keep identity)."""
        layers = {}
        for name, p in plan.layers.items():
            kw = {}
            if hasattr(p, "softmax_impl") and p.softmax_impl != self.softmax:
                kw["softmax_impl"] = self.softmax
            if hasattr(p, "squash_impl") and p.squash_impl != self.squash:
                kw["squash_impl"] = self.squash
            layers[name] = dataclasses.replace(p, **kw) if kw else p
        return dataclasses.replace(plan, layers=layers)

    def to_json(self) -> dict:
        return {"softmax": self.softmax, "squash": self.squash}

    @classmethod
    def from_json(cls, d: dict) -> "VariantSet":
        return cls(softmax=d.get("softmax", DEFAULT_SOFTMAX),
                   squash=d.get("squash", DEFAULT_SQUASH))


def all_variant_sets() -> tuple:
    """Every registered (softmax, squash) combination."""
    return tuple(VariantSet(softmax=sm, squash=sq)
                 for sm in REGISTRY.names("softmax")
                 for sq in REGISTRY.names("squash"))
