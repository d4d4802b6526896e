"""Capsule-network layers: small frozen objects with one protocol
(`CapsLayer`):

  init(generator)               -> float params (explicit torch.Generator)
  fwd_f32(params, x)            -> (y, taps)   float forward; `taps` are
                                   the layer's own calibration points.
  plan_tap_names()              -> the stats keys `plan` reads.
  plan(params, stats, in_frac)  -> the layer's typed plan (Alg. 6/7).
  quantize(params, plan)        -> int8 weight dict (Alg. 7).
  fwd_q7(qweights, plan, x, *, backend, rounding) -> y   int8 execution
                                   on a selectable op backend.
  fwd_fq(params, plan, x, *, rounding) -> y   fake-quantized float
                                   forward (QAT, `repro_torch.captrain`):
                                   every tensor the int8 graph quantizes
                                   is snapped onto the plan's Qm.n grid
                                   with a straight-through gradient.
                                   Weights and couplings quantize
                                   nearest (Alg. 7); activations use the
                                   net's rounding mode.

Activations are NHWC and weights HWIO (convs) or [J, I, O, D] (routing)
at this interface, as in the reference package; the float convs permute
to torch's NCHW / OIHW inside.  int8 shapes come from the data, never
the config.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch
import torch.nn.functional as F

from repro_torch.core.routing import squash
from repro_torch.nn.backend import get_backend
from repro_torch.nn.plans import (ConvPlan, PrimaryCapsPlan, RoutingPlan,
                                  TapStats)
from repro_torch.nn.variants import DEFAULT_SOFTMAX, DEFAULT_SQUASH, REGISTRY
from repro_torch.quant import qformat as qf


@runtime_checkable
class CapsLayer(Protocol):
    """The protocol above; `QuantConv2D`, `PrimaryCaps` and
    `CapsuleRouting` satisfy it."""
    name: str

    def init(self, generator) -> dict: ...
    def fwd_f32(self, params, x) -> tuple: ...
    def plan_tap_names(self) -> tuple: ...
    def plan(self, params, stats: TapStats, in_frac: int): ...
    def quantize(self, params, plan) -> dict: ...
    def fwd_q7(self, qweights, plan, x, *, backend="torch",
               rounding="floor"): ...
    def fwd_fq(self, params, plan, x, *, rounding="floor"): ...


def _conv(x, w, b, stride: int):
    """NHWC float x HWIO float -> NHWC, VALID padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def _weight_frac(w) -> int:
    return qf.frac_bits(float(w.abs().max()))


@dataclasses.dataclass(frozen=True)
class QuantConv2D:
    """VALID-padded NHWC conv + bias (+ optional relu), int8 via one
    accumulator shift.  Taps: "out" (pre-activation)."""
    name: str
    kernel: int
    stride: int
    in_ch: int
    out_ch: int
    relu: bool = True
    init_scale_pow: float = 2.0     # he-normal: sqrt(init_scale_pow/fan_in)
    per_channel: bool = False       # per-output-channel weight formats

    def init(self, generator: torch.Generator) -> dict:
        k, fan_in = self.kernel, self.kernel * self.kernel * self.in_ch
        w = torch.randn((k, k, self.in_ch, self.out_ch), generator=generator,
                        dtype=torch.float32)
        return {"w": w * (self.init_scale_pow / fan_in) ** 0.5,
                "b": torch.zeros((self.out_ch,), dtype=torch.float32)}

    def fwd_f32(self, params, x):
        y = _conv(x, params["w"], params["b"], self.stride)
        return (torch.relu(y) if self.relu else y), {"out": y}

    def plan_tap_names(self) -> tuple:
        return (f"{self.name}.out",)

    def plan(self, params, stats: TapStats, in_frac: int) -> ConvPlan:
        f_w = _weight_frac(params["w"])
        f_b = _weight_frac(params["b"]) if params["b"].numel() else f_w
        f_out = qf.frac_bits(stats[f"{self.name}.out"])
        pc_w = pc_out = pc_bias = ()
        if self.per_channel:
            _, ns = qf.quantize_per_channel(params["w"], axis=-1)
            pc_w = tuple(int(n) for n in ns)
            pc_out = tuple(qf.out_shift(in_frac, f, f_out) for f in pc_w)
            pc_bias = tuple(qf.bias_shift(in_frac, f, f_b) for f in pc_w)
        return ConvPlan(
            in_frac=in_frac, w_frac=f_w, b_frac=f_b, out_frac=f_out,
            out_shift=qf.out_shift(in_frac, f_w, f_out),
            bias_shift=qf.bias_shift(in_frac, f_w, f_b),
            w_frac_per_channel=pc_w, out_shift_per_channel=pc_out,
            bias_shift_per_channel=pc_bias)

    def quantize(self, params, plan: ConvPlan) -> dict:
        if plan.per_channel:
            qw = qf.quantize_with_fracs(params["w"],
                                        plan.w_frac_per_channel, axis=-1)
        else:
            qw = qf.quantize(params["w"], plan.w_frac)
        return {"w": qw, "b": qf.quantize(params["b"], plan.b_frac)}

    def fwd_q7(self, qweights, plan: ConvPlan, x, *, backend="torch",
               rounding="floor"):
        be = get_backend(backend)
        if plan.per_channel:
            return be.conv2d_q7_per_channel(
                x, qweights["w"], qweights["b"],
                plan.out_shift_per_channel, plan.bias_shift_per_channel,
                stride=self.stride, rounding=rounding, relu=self.relu)
        return be.conv2d_q7(x, qweights["w"], qweights["b"], plan.out_shift,
                            plan.bias_shift, stride=self.stride,
                            rounding=rounding, relu=self.relu)

    def fwd_fq(self, params, plan: ConvPlan, x, *, rounding="floor"):
        """Fake-quant forward at fwd_q7's requantization points: weights
        and bias on their plan grids (nearest), the accumulator snapped
        to out_frac with the net's rounding."""
        if plan.per_channel:
            w = qf.fake_quant_with_fracs(params["w"],
                                         plan.w_frac_per_channel, axis=-1)
        else:
            w = qf.fake_quant(params["w"], plan.w_frac)
        b = qf.fake_quant(params["b"], plan.b_frac)
        y = qf.fake_quant(_conv(x, w, b, self.stride), plan.out_frac,
                          rounding)
        return torch.relu(y) if self.relu else y


@dataclasses.dataclass(frozen=True)
class PrimaryCaps:
    """Primary capsules (paper §3.3): conv -> reshape [B, N_caps, dim] ->
    squash into Q0.7.  Taps: "out" (conv pre-squash), "squashed".  The
    conv faces delegate to an inner QuantConv2D (no relu, 1/fan_in
    init)."""
    name: str
    kernel: int
    stride: int
    in_ch: int
    caps: int
    dim: int
    per_channel: bool = False
    squash_impl: str = DEFAULT_SQUASH   # variant default carried into plan

    @property
    def out_ch(self) -> int:
        return self.caps * self.dim

    @property
    def conv(self) -> QuantConv2D:
        return QuantConv2D(self.name, self.kernel, self.stride, self.in_ch,
                           self.out_ch, relu=False, init_scale_pow=1.0,
                           per_channel=self.per_channel)

    def init(self, generator: torch.Generator) -> dict:
        return self.conv.init(generator)

    def fwd_f32(self, params, x):
        y, taps = self.conv.fwd_f32(params, x)
        u = squash(y.reshape(y.shape[0], -1, self.dim), axis=-1)
        return u, {**taps, "squashed": u}

    def plan_tap_names(self) -> tuple:
        return self.conv.plan_tap_names()

    def plan(self, params, stats: TapStats, in_frac: int) -> PrimaryCapsPlan:
        return PrimaryCapsPlan(conv=self.conv.plan(params, stats, in_frac),
                               squash_impl=self.squash_impl)

    def quantize(self, params, plan: PrimaryCapsPlan) -> dict:
        return self.conv.quantize(params, plan.conv)

    def fwd_q7(self, qweights, plan: PrimaryCapsPlan, x, *, backend="torch",
               rounding="floor"):
        y = self.conv.fwd_q7(qweights, plan.conv, x, backend=backend,
                             rounding=rounding)
        u = y.reshape(y.shape[0], -1, self.dim)
        return get_backend(backend).squash_q7(
            u, in_frac=plan.conv.out_frac, out_frac=plan.squash_out_frac,
            impl=plan.squash_impl)

    def fwd_fq(self, params, plan: PrimaryCapsPlan, x, *, rounding="floor"):
        y = self.conv.fwd_fq(params, plan.conv, x, rounding=rounding)
        u = y.reshape(y.shape[0], -1, self.dim)
        return REGISTRY.get("squash", plan.squash_impl).fq(
            u, plan.squash_out_frac, rounding)


@dataclasses.dataclass(frozen=True)
class CapsuleRouting:
    """Class capsules with dynamic routing (Alg. 5).  Taps: "u_hat",
    per-iteration "s/{r}", "agree/{r}", "logits/{r}"."""
    name: str
    num_out: int                    # J (classes)
    num_in: int                     # I (input capsules)
    out_dim: int                    # O
    in_dim: int                     # D
    routings: int = 3
    softmax_impl: str = DEFAULT_SOFTMAX
    squash_impl: str = DEFAULT_SQUASH
    per_channel: bool = False       # per-output-capsule W formats

    def init(self, generator: torch.Generator) -> dict:
        W = torch.randn((self.num_out, self.num_in, self.out_dim,
                         self.in_dim), generator=generator,
                        dtype=torch.float32)
        return {"W": W * 0.1}

    def fwd_f32(self, params, u):
        u_hat = torch.einsum("jiod,bid->bjio", params["W"], u)
        taps = {"u_hat": u_hat}
        b = torch.zeros(u_hat.shape[:3], dtype=torch.float32,
                        device=u_hat.device)
        v = None
        for r in range(self.routings):
            c = torch.softmax(b, dim=1)
            s = torch.einsum("bji,bjio->bjo", c, u_hat)
            taps[f"s/{r}"] = s
            v = squash(s, axis=-1)
            if r < self.routings - 1:
                a = torch.einsum("bjio,bjo->bji", u_hat, v)
                taps[f"agree/{r}"] = a
                b = b + a
                taps[f"logits/{r}"] = b
        return v, taps

    def plan_tap_names(self) -> tuple:
        names = [f"{self.name}.u_hat"]
        names += [f"{self.name}.s/{r}" for r in range(self.routings)]
        names += [f"{self.name}.logits/{r}"
                  for r in range(self.routings - 1)]
        return tuple(names)

    def plan(self, params, stats: TapStats, in_frac: int) -> RoutingPlan:
        fb = qf.frac_bits
        f_W = _weight_frac(params["W"])
        f_uhat = fb(stats[f"{self.name}.u_hat"])
        # logit format is shared across iterations (b accumulates
        # agreements), capped at the Q0.7 barrier
        max_logit = max([stats.get(f"{self.name}.logits/{r}")
                         for r in range(self.routings - 1)] + [1e-6])
        f_logit = min(fb(max_logit), 7)
        f_s = tuple(fb(stats[f"{self.name}.s/{r}"])
                    for r in range(self.routings))
        pc_W = pc_shift = ()
        if self.per_channel:
            _, ns = qf.quantize_per_channel(params["W"], axis=0)
            pc_W = tuple(int(n) for n in ns)
            pc_shift = tuple(qf.out_shift(in_frac, f, f_uhat)
                             for f in pc_W)
        return RoutingPlan(
            uhat_shift=qf.out_shift(in_frac, f_W, f_uhat),
            logit_frac=f_logit,
            caps_out_shifts=tuple(qf.out_shift(f_uhat, 7, f)
                                  for f in f_s),
            caps_out_fracs=f_s,
            agree_shifts=tuple(qf.out_shift(f_uhat, 7, f_logit)
                               for _ in range(self.routings - 1)),
            softmax_impl=self.softmax_impl, squash_impl=self.squash_impl,
            in_frac=in_frac, W_frac=f_W, uhat_frac=f_uhat,
            W_frac_per_out=pc_W, uhat_shift_per_out=pc_shift)

    def quantize(self, params, plan: RoutingPlan) -> dict:
        if plan.per_out:
            return {"W": qf.quantize_with_fracs(params["W"],
                                                plan.W_frac_per_out,
                                                axis=0)}
        return {"W": qf.quantize(params["W"], plan.W_frac)}

    def fwd_q7(self, qweights, plan: RoutingPlan, u, *, backend="torch",
               rounding="floor"):
        be = get_backend(backend)
        shift = plan.uhat_shift_per_out if plan.per_out \
            else plan.uhat_shift
        u_hat = be.uhat_q7(qweights["W"], u, shift=shift,
                           rounding=rounding)
        return be.routing_q7(u_hat, plan, rounding=rounding)

    @staticmethod
    def _softmax_fq(b, impl: str):
        """Couplings in Q0.7 as the int8 graph computes them: the
        registered variant's fake-quant face, with the float softmax as
        the straight-through surrogate."""
        return REGISTRY.get("softmax", impl).fq(b)

    def fwd_fq(self, params, plan: RoutingPlan, u, *, rounding="floor"):
        """Fake-quant routing: u_hat, couplings, per-iteration s/v and
        the accumulated logits snap to the grids routing_q7 uses (the
        logit clamp models add_q7's int8 saturation)."""
        sq = REGISTRY.get("squash", plan.squash_impl)
        if plan.per_out:
            W = qf.fake_quant_with_fracs(params["W"],
                                         plan.W_frac_per_out, axis=0)
        else:
            W = qf.fake_quant(params["W"], plan.W_frac)
        u_hat = qf.fake_quant(torch.einsum("jiod,bid->bjio", W, u),
                              plan.uhat_frac, rounding)
        b = torch.zeros(u_hat.shape[:3], dtype=torch.float32,
                        device=u_hat.device)
        v = None
        for r in range(self.routings):
            c = self._softmax_fq(b, plan.softmax_impl)
            s = qf.fake_quant(torch.einsum("bji,bjio->bjo", c, u_hat),
                              plan.caps_out_fracs[r], rounding)
            v = sq.fq(s, plan.squash_out_frac, rounding)
            if r < self.routings - 1:
                a = qf.fake_quant(torch.einsum("bjio,bjo->bji", u_hat, v),
                                  plan.logit_frac, rounding)
                b = qf.fake_quant(b + a, plan.logit_frac, rounding)
        return v
