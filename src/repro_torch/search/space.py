"""The quantization & variant design space over a trained CapsNet (the
port of the reference's `repro.search.space`).

A point in the space is a `CandidateSpec`: per-layer Qm.n fractional-bit
reductions (Q-CapsNets-style "virtual bit" coarsening of weights and
activations), per-tensor vs per-channel weight formats for the convs
and the routing `W`, and the softmax/squash operator variant selection
(repro_torch.nn.variants).  `SearchSpace` turns any spec into a
requantized `QuantCapsNet` whose plan satisfies the full shift algebra:
candidates are built by re-deriving the default plan from the trained
weights and the calibration set, then applying the spec's deltas with
every dependent shift recomputed, so `PipelinePlan.check()` is clean by
construction (and asserted).

Frac deltas are always <= 0: the search coarsens formats (fewer
fractional bits -> smaller packed weights, the paper's memory axis),
never refines past the calibrated allocation (which is already the
finest format that provably fits int8).

The space lives on one device, the float params' device: calibration
runs there, the requantized weights land there, and every model it
builds runs the `cuda` backend (the kernels) on a CUDA device and the
`torch` backend on the CPU unless the caller names one.
"""
from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.nn.layers import CapsuleRouting, PrimaryCaps, QuantConv2D
from repro_torch.nn.pipeline import CapsPipeline, QuantCapsNet
from repro_torch.nn.plans import (ConvPlan, PipelinePlan, PrimaryCapsPlan,
                                  RoutingPlan)
from repro_torch.nn.variants import REGISTRY, VariantSet

# deepest per-coordinate fractional-bit reduction the space admits;
# beyond ~3 bits an int8 weight grid has lost most of its levels and
# every candidate is rejected on accuracy anyway
MAX_REDUCTION = 3


@dataclasses.dataclass(frozen=True)
class CandidateSpec:
    """One point of the design space, JSON-round-trippable and hashable
    (delta maps are canonically-sorted tuples of (layer, delta<=0))."""
    softmax: str = ""                # "" -> registry default
    squash: str = ""
    per_channel: bool = False        # conv weight formats per out-channel
    per_channel_w: bool = False      # routing W formats per out-capsule
    w_frac_deltas: tuple = ()        # ((layer, delta), ...)
    out_frac_deltas: tuple = ()      # ((layer, delta), ...)

    def __post_init__(self):
        for field in ("w_frac_deltas", "out_frac_deltas"):
            entries = tuple(tuple(e) for e in getattr(self, field))
            object.__setattr__(self, field,
                               tuple(sorted(dict(entries).items())))
            for layer, delta in getattr(self, field):
                if not -MAX_REDUCTION <= delta <= 0:
                    raise ValueError(
                        f"{field}[{layer!r}] = {delta}: deltas must be "
                        f"in [-{MAX_REDUCTION}, 0]")
        if self.softmax:
            REGISTRY.validate("softmax", self.softmax)
        if self.squash:
            REGISTRY.validate("squash", self.squash)

    def delta(self, field: str, layer: str) -> int:
        return dict(getattr(self, field)).get(layer, 0)

    @property
    def key(self) -> str:
        """Canonical identity (dedupe/cache key)."""
        return json.dumps(self.to_json(), sort_keys=True)

    def to_json(self) -> dict:
        return {"softmax": self.softmax, "squash": self.squash,
                "per_channel": self.per_channel,
                "per_channel_w": self.per_channel_w,
                "w_frac_deltas": [list(e) for e in self.w_frac_deltas],
                "out_frac_deltas": [list(e) for e in self.out_frac_deltas]}

    @classmethod
    def from_json(cls, d: dict) -> "CandidateSpec":
        return cls(softmax=str(d.get("softmax") or ""),
                   squash=str(d.get("squash") or ""),
                   per_channel=bool(d.get("per_channel", False)),
                   per_channel_w=bool(d.get("per_channel_w", False)),
                   w_frac_deltas=tuple(tuple(e)
                                       for e in d.get("w_frac_deltas", [])),
                   out_frac_deltas=tuple(
                       tuple(e) for e in d.get("out_frac_deltas", [])))

    # -- functional edits (the strategies' move set) -------------------
    def with_delta(self, field: str, layer: str,
                   delta: int) -> "CandidateSpec":
        entries = dict(getattr(self, field))
        if delta == 0:
            entries.pop(layer, None)
        else:
            entries[layer] = delta
        return dataclasses.replace(self, **{field: tuple(entries.items())})

    def with_variant(self, kind: str, name: str) -> "CandidateSpec":
        if name == REGISTRY.default(kind):
            name = ""
        return dataclasses.replace(
            self, **{"softmax" if kind == "softmax" else "squash": name})

    def with_flag(self, flag: str, value: bool) -> "CandidateSpec":
        return dataclasses.replace(self, **{flag: value})


class SearchSpace:
    """Spec -> verified plan/model factory over ONE trained network.

    Holds the float params and the calibration set on the params'
    device; every structural pipeline (variant set x per-channel flags)
    and its calibrated plan are derived once and cached, so a search
    loop pays only the delta algebra + weight requantization per
    candidate."""

    def __init__(self, cfg, params, calib_images):
        self.cfg = cfg
        self.params = params
        self.device = next(iter(next(iter(params.values())).values())).device
        self.calib_images = torch.as_tensor(calib_images,
                                            dtype=torch.float32,
                                            device=self.device)
        self._pipelines: dict = {}
        self._base_plans: dict = {}

    @property
    def backend(self) -> str:
        """The op backend of the models this space builds: the kernels
        on a CUDA device, the torch oracle elsewhere."""
        return "cuda" if self.device.type == "cuda" else "torch"

    # -- coordinates ---------------------------------------------------
    def axes(self) -> list:
        """Deterministic coordinate list (the strategies' walk order):
        per-layer ("w_frac", layer) and ("out_frac", layer) reductions,
        then ("variant", kind) selections, then the per-channel flags.
        out_frac applies to conv-stage activations only — squash
        outputs stay in their derived format (the routing contract)."""
        axes = []
        for layer in self.pipeline(CandidateSpec()).layers:
            if isinstance(layer, (QuantConv2D, PrimaryCaps,
                                  CapsuleRouting)):
                axes.append(("w_frac", layer.name))
            if isinstance(layer, (QuantConv2D, PrimaryCaps)):
                axes.append(("out_frac", layer.name))
        axes += [("variant", "softmax"), ("variant", "squash"),
                 ("flag", "per_channel"), ("flag", "per_channel_w")]
        return axes

    def variant_names(self, kind: str) -> tuple:
        return tuple(REGISTRY.names(kind))

    # -- construction --------------------------------------------------
    def _struct_key(self, spec: CandidateSpec) -> tuple:
        return (spec.softmax, spec.squash, spec.per_channel,
                spec.per_channel_w)

    def pipeline(self, spec: CandidateSpec) -> CapsPipeline:
        key = self._struct_key(spec)
        if key not in self._pipelines:
            variants = VariantSet(**{k: v for k, v in (
                ("softmax", spec.softmax), ("squash", spec.squash)) if v})
            self._pipelines[key] = CapsPipeline.from_config(
                self.cfg, variants=variants, per_channel=spec.per_channel,
                per_channel_w=spec.per_channel_w)
        return self._pipelines[key]

    def base_plan(self, spec: CandidateSpec) -> PipelinePlan:
        """The calibrated default plan of the spec's structural
        pipeline (before any frac deltas)."""
        key = self._struct_key(spec)
        if key not in self._base_plans:
            pipe = self.pipeline(spec)
            stats = pipe.calibrate(self.params, self.calib_images)
            self._base_plans[key] = pipe.plan(self.params, stats)
        return self._base_plans[key]

    def build_plan(self, spec: CandidateSpec) -> PipelinePlan:
        """Apply the spec's frac deltas to the calibrated plan,
        recomputing every dependent shift so the Qm.n algebra holds
        (asserted via PipelinePlan.check)."""
        plan = _apply_deltas(self.base_plan(spec), spec)
        findings = plan.check()
        assert not findings, \
            f"search produced an inconsistent plan: {findings}"
        return plan

    @torch.no_grad()
    def build_qnet(self, spec: CandidateSpec, *, rounding: str = "floor",
                   params=None, backend: str | None = None) -> QuantCapsNet:
        """Requantize the trained weights on the spec's plan.  `params`
        overrides the space's float params (QAT-refined weights keep
        the candidate plan — fixed-grid fine-tuning); `backend`
        overrides the device's (`self.backend`)."""
        pipe = self.pipeline(spec)
        plan = self.build_plan(spec)
        params = self.params if params is None else params
        qweights = {l.name: l.quantize(params[l.name], plan[l.name])
                    for l in pipe.layers}
        return QuantCapsNet(pipeline=pipe, plan=plan, qweights=qweights,
                            rounding=rounding,
                            backend=backend or self.backend)


# ---------------------------------------------------------------------------
# delta algebra
# ---------------------------------------------------------------------------
def _shift_conv(plan: ConvPlan, in_frac: int, wd: int, od: int) -> ConvPlan:
    w_frac = plan.w_frac + wd
    out_frac = plan.out_frac + od
    pc_w = tuple(f + wd for f in plan.w_frac_per_channel)
    return dataclasses.replace(
        plan, in_frac=in_frac, w_frac=w_frac, out_frac=out_frac,
        out_shift=in_frac + w_frac - out_frac,
        bias_shift=in_frac + w_frac - plan.b_frac,
        w_frac_per_channel=pc_w,
        out_shift_per_channel=tuple(in_frac + f - out_frac for f in pc_w),
        bias_shift_per_channel=tuple(in_frac + f - plan.b_frac
                                     for f in pc_w))


def _apply_deltas(plan: PipelinePlan, spec: CandidateSpec) -> PipelinePlan:
    """Thread the activation format through the layers while applying
    w_frac/out_frac reductions — the same chaining walk as
    `CapsPipeline.plan`, expressed over already-derived plans."""
    f_act = plan.input_frac
    layers: dict = {}
    for name, p in plan.layers.items():
        wd = spec.delta("w_frac_deltas", name)
        od = spec.delta("out_frac_deltas", name)
        if isinstance(p, PrimaryCapsPlan):
            p = dataclasses.replace(p, conv=_shift_conv(p.conv, f_act, wd,
                                                        od))
        elif isinstance(p, ConvPlan):
            p = _shift_conv(p, f_act, wd, od)
        elif isinstance(p, RoutingPlan):
            in_frac = f_act
            W_frac = p.W_frac + wd
            pc_w = tuple(f + wd for f in p.W_frac_per_out)
            p = dataclasses.replace(
                p, in_frac=in_frac, W_frac=W_frac,
                uhat_shift=in_frac + W_frac - p.uhat_frac,
                W_frac_per_out=pc_w,
                uhat_shift_per_out=tuple(in_frac + f - p.uhat_frac
                                         for f in pc_w))
        else:                       # pragma: no cover - new plan kinds
            raise TypeError(f"no delta algebra for {type(p).__name__}")
        layers[name] = p
        f_act = p.out_frac
    return PipelinePlan(input_frac=plan.input_frac, layers=layers)
