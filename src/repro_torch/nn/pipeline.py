"""CapsPipeline: one typed graph walk for the float, calibration, PTQ and
int8 faces, and QuantCapsNet, the quantized model it produces.

  forward    — float inference (optionally returning calibration taps)
  calibrate  — max|x| per tap over a reference dataset (Alg. 6 line 8)
  quantize   — per-layer plans + int8 weights -> a QuantCapsNet
  forward_q7 — int8 inference on a selectable op backend
  forward_fq — fake-quant float forward on a plan's grids (QAT)

The float and fake-quant faces run in full float32: TF32 is switched off
for their matmuls and convolutions while they run (`_full_fp32`), since
a calibration max that drifts by TF32's rounding can move `frac_bits`
across a power-of-two boundary and change the plan, and a TF32 sum can
cross a grid line that `forward_fq`'s `floor` snaps to.  Their backward
runs after they return, so a train step enters the same scope itself
(`repro_torch.captrain.steps`).

PTQ runs under the spans `ptq.calibrate`, `ptq.plan` and
`ptq.quantize_weights`.  With a tracer installed, `forward_q7` opens one
span per layer of its loop, `layer.<name>` (`layer.conv0` ...,
`layer.pcap`, `layer.caps`; arg `kind`, the layer's class), so a wave's
host time and the card's idle gaps fall to a layer; the loop opens them,
never a layer, so the primary capsules' inner conv is not counted
twice.  With a numerics probe installed, it attributes each layer's
requantizations to that layer and observes its int8 output
(repro_torch.obs).  With neither, it is the plain loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.nn.config import CapsNetConfig
from repro_torch.nn.layers import CapsuleRouting, PrimaryCaps, QuantConv2D
from repro_torch.nn.plans import PipelinePlan, TapStats, plan_scalars
from repro_torch.nn.variants import VariantSet
from repro_torch.obs import numerics as _health
from repro_torch.obs import trace as _trace
from repro_torch.quant import qformat as qf


@contextlib.contextmanager
def _full_fp32():
    """torch.backends.cuda.matmul.allow_tf32 = False and
    torch.backends.cudnn.allow_tf32 = False for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass(frozen=True)
class CapsPipeline:
    cfg: CapsNetConfig
    layers: tuple

    @classmethod
    def from_config(cls, cfg: CapsNetConfig, *,
                    variants: VariantSet | None = None,
                    per_channel: bool = False,
                    per_channel_w: bool = False) -> "CapsPipeline":
        """The typed pipeline for a geometry config.  `per_channel` opts
        the convs into per-output-channel weight formats; `per_channel_w`
        the routing W into per-output-capsule formats."""
        variants = variants or VariantSet()
        layers = []
        cin = cfg.input_shape[2]
        for i, (f, k, s) in enumerate(zip(cfg.conv_filters, cfg.conv_kernels,
                                          cfg.conv_strides)):
            layers.append(QuantConv2D(f"conv{i}", k, s, cin, f, relu=True,
                                      per_channel=per_channel))
            cin = f
        layers.append(PrimaryCaps("pcap", cfg.pcap_kernel, cfg.pcap_stride,
                                  cin, cfg.pcap_caps, cfg.pcap_dim,
                                  per_channel=per_channel,
                                  squash_impl=variants.squash))
        layers.append(CapsuleRouting(
            "caps", cfg.num_classes, cfg.num_input_caps, cfg.caps_dim,
            cfg.pcap_dim, cfg.routings, softmax_impl=variants.softmax,
            squash_impl=variants.squash, per_channel=per_channel_w))
        return cls(cfg=cfg, layers=tuple(layers))

    @functools.cached_property
    def _layer_spans(self) -> tuple:
        """(span name, kind) of each layer, built once per pipeline."""
        return tuple((f"layer.{l.name}", type(l).__name__)
                     for l in self.layers)

    def layer(self, name: str):
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Float params drawn from `generator` (a CPU generator, so the
        same seed gives the same params on every device)."""
        device = resolve_device(device)
        return {l.name: {k: v.to(device) for k, v in l.init(generator).items()}
                for l in self.layers}

    @staticmethod
    def param_bytes(params) -> int:
        """fp32 footprint of a nested dict of params (Table 2's
        numerator)."""
        if isinstance(params, dict):
            return sum(CapsPipeline.param_bytes(v) for v in params.values())
        return 4 * params.numel()

    # ------------------------------------------------------------------
    # float face
    # ------------------------------------------------------------------
    def forward(self, params, x, *, with_taps: bool = False):
        """x [B,H,W,C] float in [0,1] -> class capsules [B, J, O]."""
        taps = {"input": x}
        h = x
        with _full_fp32():
            for l in self.layers:
                h, t = l.fwd_f32(params[l.name], h)
                for k, v in t.items():
                    taps[f"{l.name}.{k}"] = v
        return (h, taps) if with_taps else h

    def tap_names(self) -> tuple:
        """Every stats key any layer's plan() will read."""
        names = ["input"]
        for l in self.layers:
            names.extend(l.plan_tap_names())
        return tuple(names)

    # ------------------------------------------------------------------
    # calibration face (Alg. 6 line 8)
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def calibrate(self, params, calib_images, batch: int = 64) -> TapStats:
        """Running max|x| per tap, kept on the params' device; the host
        reads it once at the end."""
        device = next(iter(params[self.layers[0].name].values())).device
        x_all = torch.as_tensor(calib_images, dtype=torch.float32,
                                device=device)
        running = None
        for i in range(0, x_all.shape[0], batch):
            _, taps = self.forward(params, x_all[i:i + batch],
                                   with_taps=True)
            m = {k: t.abs().amax() for k, t in taps.items()}
            running = m if running is None else \
                {k: torch.maximum(running[k], v) for k, v in m.items()}
        if running is None:
            raise ValueError("empty calibration set")
        keys = list(running)
        vals = torch.stack([running[k] for k in keys]).cpu().tolist()
        return TapStats(dict(zip(keys, vals)))

    # ------------------------------------------------------------------
    # planning + quantization face (Alg. 6 & 7)
    # ------------------------------------------------------------------
    def plan(self, params, stats: TapStats) -> PipelinePlan:
        """Each layer derives its own plan; the activation format chains
        through `out_frac` -> next layer's `in_frac`."""
        input_frac = qf.frac_bits(stats["input"])
        f_act = input_frac
        plans: dict = {}
        for l in self.layers:
            p = l.plan(params[l.name], stats, f_act)
            plans[l.name] = p
            f_act = p.out_frac
        return PipelinePlan(input_frac=input_frac, layers=plans)

    def quantize(self, params, calib_images, *, rounding: str = "floor",
                 backend: str = "torch", batch: int = 64) -> "QuantCapsNet":
        with obs.span("ptq.calibrate", config=self.cfg.name):
            stats = self.calibrate(params, calib_images, batch=batch)
        with obs.span("ptq.plan", config=self.cfg.name):
            plan = self.plan(params, stats)
        with obs.span("ptq.quantize_weights", config=self.cfg.name):
            qweights = {l.name: l.quantize(params[l.name], plan[l.name])
                        for l in self.layers}
        return QuantCapsNet(pipeline=self, plan=plan, qweights=qweights,
                            rounding=rounding, backend=backend)

    # ------------------------------------------------------------------
    # fake-quant face (QAT; see repro_torch.captrain)
    # ------------------------------------------------------------------
    def forward_fq(self, params, x, plan: PipelinePlan, *,
                   rounding: str = "floor"):
        """Float forward with every int8 quantization point fake-applied
        on the plan's Qm.n grids (straight-through gradients).  The plan
        comes from the same `plan()` machinery PTQ uses.  With a numerics
        probe installed, each layer's fake-quant calls are attributed to
        that layer (and the input's to "input")."""
        with _full_fp32():
            if _health._PROBE is None:             # hot path untouched
                h = qf.fake_quant(x, plan.input_frac)
                for l in self.layers:
                    h = l.fwd_fq(params[l.name], plan[l.name], h,
                                 rounding=rounding)
                return h
            with _health.scope("input"):
                h = qf.fake_quant(x, plan.input_frac)
            for i, l in enumerate(self.layers):
                with _health.scope(l.name, index=i, kind=type(l).__name__):
                    h = l.fwd_fq(params[l.name], plan[l.name], h,
                                 rounding=rounding)
            return h

    # ------------------------------------------------------------------
    # int8 face
    # ------------------------------------------------------------------
    def forward_q7(self, qweights, plan: PipelinePlan, x_q, *,
                   backend: str = "torch", rounding: str = "floor"):
        """x_q int8 image in the plan's input format -> v int8 [B,J,O]."""
        probe = _health._PROBE
        if probe is None and _trace._AMBIENT is None:   # hot path untouched
            h = x_q
            for l in self.layers:
                h = l.fwd_q7(qweights[l.name], plan[l.name], h,
                             backend=backend, rounding=rounding)
            return h
        h = x_q
        for i, (l, (name, kind)) in enumerate(zip(self.layers,
                                                  self._layer_spans)):
            with obs.span(name, kind=kind), \
                    _health.scope(l.name, index=i, kind=kind):
                h = l.fwd_q7(qweights[l.name], plan[l.name], h,
                             backend=backend, rounding=rounding)
                if probe is not None:
                    probe.observe_output(h, frac=plan[l.name].out_frac)
        return h

    def quantize_input(self, x, plan: PipelinePlan):
        return qf.quantize(x, plan.input_frac)


@dataclasses.dataclass(frozen=True)
class QuantCapsNet:
    """A quantized CapsNet: pipeline + plan + int8 weights (on one
    device) + the rounding mode and op backend it runs with."""
    pipeline: CapsPipeline
    plan: PipelinePlan
    qweights: dict
    rounding: str = "floor"
    backend: str = "torch"

    @property
    def device(self) -> torch.device:
        return next(iter(self.qweights[self.pipeline.layers[0].name]
                         .values())).device

    def quantize_input(self, x):
        return self.pipeline.quantize_input(x, self.plan)

    def forward(self, x_q):
        return self.pipeline.forward_q7(self.qweights, self.plan, x_q,
                                        backend=self.backend,
                                        rounding=self.rounding)

    def class_lengths(self, v_q):
        """||v|| per class, dequantized with the final layer's output
        format (squash_out_frac is a plan field)."""
        out_frac = self.plan[self.pipeline.layers[-1].name].out_frac
        v32 = v_q.to(torch.int32)
        ss = (v32 * v32).sum(dim=-1, dtype=torch.int32)
        return torch.sqrt(ss.to(torch.float32)) * (2.0 ** -out_frac)

    def memory_bytes(self) -> int:
        n = sum(t.numel() * t.element_size()
                for w in self.qweights.values() for t in w.values())
        n += 4 * plan_scalars(self.plan)       # int32 shift/format table
        return int(n)

    def with_backend(self, backend: str) -> "QuantCapsNet":
        return dataclasses.replace(self, backend=backend)

    @property
    def variants(self) -> VariantSet:
        return self.plan.variants

    def with_variants(self, variants: VariantSet) -> "QuantCapsNet":
        """A model running `variants`: a pure plan edit (weights and
        shifts untouched)."""
        return dataclasses.replace(self, plan=variants.apply(self.plan))

    def with_softmax(self, impl: str) -> "QuantCapsNet":
        """Softmax-only plan edit (see with_variants)."""
        return self.with_variants(
            dataclasses.replace(self.variants, softmax=impl))

    def with_squash(self, impl: str) -> "QuantCapsNet":
        """Squash-only plan edit (see with_variants)."""
        return self.with_variants(
            dataclasses.replace(self.variants, squash=impl))
