"""Operator variants: the typed registry of softmax / squash choices.

A variant is one registration here; plans validate their variant fields
against the registry, and the backends resolve the int8 face through
it.  The port carries the `q7` face (the torch integer oracle) of each
registered variant:

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

from repro_torch.quant import int8_ops as q

KINDS = ("softmax", "squash")


@dataclasses.dataclass(frozen=True)
class OpVariant:
    """One operator variant and its int8 face."""
    name: str                       # registry key within its kind
    kind: str                       # "softmax" | "squash"
    description: str
    q7: Callable                    # torch int8 oracle


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


REGISTRY = VariantRegistry()

REGISTRY.register(OpVariant(
    name="q7", kind="softmax",
    description="arm_softmax-style shift softmax (paper baseline): "
                "powers of two of floor(x - max), integer-divided by "
                "their sum",
    q7=q.softmax_q7), default=True)
REGISTRY.register(OpVariant(
    name="precise", kind="softmax",
    description="dequantize -> fp32 softmax -> requant Q0.7 "
                "(beyond-paper accuracy reference)",
    q7=q.softmax_q7_precise))
REGISTRY.register(OpVariant(
    name="approx", kind="softmax",
    description="ISLPED'22 approximate softmax: shift-based exp with "
                "power-of-two normalization — no integer division",
    q7=q.softmax_q7_approx))
REGISTRY.register(OpVariant(
    name="exact", kind="squash",
    description="Eq. 8 squash with Alg. 4 Newton-Raphson integer sqrt "
                "(paper baseline)",
    q7=q.squash_q7), default=True)
REGISTRY.register(OpVariant(
    name="approx", kind="squash",
    description="ISLPED'22 approximate squash: L-inf norm instead of "
                "the L2 norm — no square root",
    q7=q.squash_q7_approx))

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


def all_variant_sets() -> tuple:
    """Every registered (softmax, squash) combination."""
    return tuple(VariantSet(softmax=sm, squash=sq)
                 for sm in REGISTRY.names("softmax")
                 for sq in REGISTRY.names("squash"))
