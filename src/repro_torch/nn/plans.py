"""Typed quantization plans: per-layer Qm.n formats and the power-of-two
shifts between them (paper Alg. 6).

Each layer derives its own plan from its calibration taps, and the
pipeline threads the activation format from one plan's `out_frac` into
the next layer's `in_frac`.  Plans are plain ints, tuples and
registry-validated variant names, so they round-trip through JSON
(`plan_to_json` / `plan_from_json`) in the same schema the reference
writes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.nn import variants as _variants


@dataclasses.dataclass(frozen=True)
class TapStats:
    """max|x| observed on the calibration set, per tap name
    (`<layer>.<tap>`, e.g. "conv0.out", "caps.s/1", plus "input")."""
    max_abs: dict

    def __getitem__(self, name: str) -> float:
        return self.max_abs[name]

    def get(self, name: str, default: float = 0.0) -> float:
        return self.max_abs.get(name, default)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """int8 conv: out_shift rescales the int32 accumulator into the
    output format; bias_shift aligns the bias into the accumulator.
    Non-empty per-channel tuples select per-output-channel formats."""
    in_frac: int
    w_frac: int
    b_frac: int
    out_frac: int
    out_shift: int
    bias_shift: int
    w_frac_per_channel: tuple = ()
    out_shift_per_channel: tuple = ()
    bias_shift_per_channel: tuple = ()

    @property
    def per_channel(self) -> bool:
        return bool(self.w_frac_per_channel)


@dataclasses.dataclass(frozen=True)
class PrimaryCapsPlan:
    """conv plan + the integer squash that lands capsules in Q0.7."""
    conv: ConvPlan
    squash_out_frac: int = 7
    squash_impl: str = _variants.DEFAULT_SQUASH

    def __post_init__(self):
        _variants.REGISTRY.validate("squash", self.squash_impl)

    @property
    def out_frac(self) -> int:
        return self.squash_out_frac


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """Dynamic routing (Alg. 5): one caps-output shift/format pair per
    iteration, one agreement shift per non-final iteration (derived for
    a Q0.7 squash output; backends add `out_frac - 7`), a shared logit
    format, and the variant references."""
    uhat_shift: int
    logit_frac: int
    caps_out_shifts: tuple
    caps_out_fracs: tuple
    agree_shifts: tuple
    softmax_impl: str = _variants.DEFAULT_SOFTMAX
    in_frac: int = 7
    W_frac: int = 0
    uhat_frac: int = 0
    squash_out_frac: int = 7
    squash_impl: str = _variants.DEFAULT_SQUASH
    W_frac_per_out: tuple = ()
    uhat_shift_per_out: tuple = ()

    def __post_init__(self):
        _variants.REGISTRY.validate("softmax", self.softmax_impl)
        _variants.REGISTRY.validate("squash", self.squash_impl)

    @property
    def per_out(self) -> bool:
        return bool(self.W_frac_per_out)

    @property
    def routings(self) -> int:
        return len(self.caps_out_shifts)

    @property
    def out_frac(self) -> int:
        return self.squash_out_frac


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """The input image format plus one typed plan per layer, keyed by
    layer name in walk order."""
    input_frac: int
    layers: dict

    def __getitem__(self, name: str):
        return self.layers[name]

    @property
    def variants(self) -> "_variants.VariantSet":
        return _variants.VariantSet.of_plan(self)

    def check(self) -> list:
        """Lint this plan's shift/frac algebra, per-channel tables,
        variant references and layer chaining
        (repro_torch.analysis.plancheck): the diagnostics, empty when
        clean."""
        from repro_torch.analysis.plancheck import check_pipeline_plan
        return check_pipeline_plan(self)


_PLAN_KINDS = {cls.__name__: cls
               for cls in (ConvPlan, PrimaryCapsPlan, RoutingPlan)}


def plan_to_json(plan) -> dict:
    """Typed plan -> JSON-safe dict (the reference's schema)."""
    if isinstance(plan, PipelinePlan):
        return {"kind": "PipelinePlan", "input_frac": plan.input_frac,
                "layers": {k: plan_to_json(p)
                           for k, p in plan.layers.items()}}
    d = {"kind": type(plan).__name__}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if dataclasses.is_dataclass(v):
            v = plan_to_json(v)
        elif isinstance(v, tuple):
            v = list(v)
        d[f.name] = v
    return d


def plan_from_json(d: dict):
    """Inverse of plan_to_json; fields missing from the JSON take the
    dataclass default, and variant references re-validate."""
    kind = d["kind"]
    if kind == "PipelinePlan":
        return PipelinePlan(input_frac=d["input_frac"],
                            layers={k: plan_from_json(p)
                                    for k, p in d["layers"].items()})
    cls = _PLAN_KINDS[kind]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, dict) and "kind" in v:
            v = plan_from_json(v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def plan_scalars(plan) -> int:
    """Number of scalar entries a plan materializes at run time (for
    footprint accounting)."""
    if isinstance(plan, PipelinePlan):
        return 1 + sum(plan_scalars(p) for p in plan.layers.values())
    n = 0
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, int):
            n += 1
        elif isinstance(v, tuple):
            n += len(v)
        elif dataclasses.is_dataclass(v):
            n += plan_scalars(v)
    return n
