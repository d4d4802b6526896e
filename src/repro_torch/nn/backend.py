"""Selectable int8 op backends for the quantized execution path.

`torch` — the torch integer oracle (repro_torch.quant.int8_ops) on any
          device: the bit-exact reference every other backend must
          reproduce, the counterpart of the reference's `jnp` backend.
          Operator variants resolve through the variant registry.
`cuda`  — the hand-written CUDA kernels (repro_torch.kernels): the
          int8 convs (an implicit GEMM with the bias, shifts, saturation
          and relu in its epilogue; the reference has no Pallas kernel
          for them), the integer squash of the primary capsules and the
          fused r-iteration routing loop, the counterparts of the
          reference's `pallas` backend.  With a numerics probe installed
          a conv still runs on its kernel, and the probe is handed the
          torch oracle's int32 accumulator besides (an observer mode,
          not the hot path).
          The kernels implement the default variants ("q7" softmax,
          "exact" squash) and a Q0.7 routing output.  A plan with another
          variant runs the torch oracle on the same CUDA tensors
          (bit-identical, slower), counted per decision in
          `CudaBackend.fallbacks` under (op, variant) and warned once per
          label; a routing plan with another output format runs the
          torch loop uncounted, as the reference's `pallas` backend
          does.  A tensor that is not on a CUDA device is refused with
          NotImplementedError: no call leaves the card.

The u_hat product is exact integer torch code on both backends (a
float64 einsum, see int8_ops); so are the convolutions on `torch`.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.kernels import conv as kconv
from repro_torch.kernels import routing as kroute
from repro_torch.kernels import squash as ksquash
from repro_torch.nn.variants import REGISTRY
from repro_torch.obs import METRICS, MetricsRegistry
from repro_torch.obs import numerics as _health
from repro_torch.quant import int8_ops as q


class TorchBackend:
    """Oracle backend: exact paper/CMSIS integer semantics in torch."""

    name = "torch"

    def conv2d_q7(self, x, w, b, out_shift, bias_shift, *, stride, rounding,
                  relu: bool = False):
        y = q.conv2d_q7(x, w, b, out_shift, bias_shift,
                        stride=stride, rounding=rounding)
        return q.relu_q7(y) if relu else y

    def conv2d_q7_per_channel(self, x, w, b, out_shifts, bias_shifts, *,
                              stride, rounding, relu: bool = False):
        y = q.conv2d_q7_per_channel(x, w, b, out_shifts, bias_shifts,
                                    stride=stride, rounding=rounding)
        return q.relu_q7(y) if relu else y

    def squash_q7(self, s, *, in_frac, out_frac=7, impl=None):
        impl = impl or REGISTRY.default("squash")
        return REGISTRY.get("squash", impl).q7(s, in_frac=in_frac,
                                               out_frac=out_frac)

    def uhat_q7(self, W, u, *, shift, rounding):
        """W int8 [J,I,O,D] x u int8 [B,I,D] -> int8 u_hat [B,J,I,O]
        (int32 accumulation, one shift).  `shift` is a scalar or a
        length-J sequence (RoutingPlan.uhat_shift_per_out)."""
        acc = q.einsum_i32("jiod,bid->bjio", W, u)
        if isinstance(shift, (tuple, list)):
            shifts = torch.as_tensor(shift, dtype=torch.int32,
                                     device=acc.device)[None, :, None, None]
            return q.rshift_sat8_vec(acc, shifts, rounding)
        return q.rshift_sat8(acc, shift, rounding)

    def routing_q7(self, u_hat, plan, *, rounding):
        """Alg. 5's r-iteration loop over an already-computed u_hat."""
        return kroute.routing_q7_plain(
            u_hat, num_iters=plan.routings,
            caps_out_shifts=plan.caps_out_shifts,
            caps_out_fracs=plan.caps_out_fracs,
            agree_shifts=plan.agree_shifts, logit_frac=plan.logit_frac,
            rounding=rounding,
            softmax=REGISTRY.get("softmax", plan.softmax_impl).q7,
            squash=REGISTRY.get("squash", plan.squash_impl).q7,
            out_frac=plan.out_frac)


# the fallback target of CudaBackend: a plain oracle instance, so a
# routing-level fallback runs the WHOLE loop on oracle ops and records
# exactly one count per fallback decision
_TORCH_ORACLE = TorchBackend()


class CudaBackend(TorchBackend):
    """Kernel backend: the CUDA convs, squash and fused routing kernel.
    u_hat stays on the exact torch ops of TorchBackend."""

    name = "cuda"

    def __init__(self, metrics: MetricsRegistry | None = None):
        # fallback DECISIONS (one per call, not per image) are counted in
        # a metrics registry, labeled (op, variant): a bare CudaBackend()
        # gets a private registry, the shared BACKENDS["cuda"] records
        # into the process-default obs.METRICS
        self.metrics = MetricsRegistry("cuda") if metrics is None \
            else metrics
        self._fallback_counter = self.metrics.counter(
            "cuda.fallback_decisions",
            help="cuda->torch-oracle fallback decisions by (op, variant)")
        self._warned: set = set()

    @property
    def fallbacks(self):
        """Counter-shaped view keyed by (op, variant)."""
        return self._fallback_counter.view("op", "variant")

    def _require_cuda(self, op: str, t) -> None:
        if t.device.type != "cuda":
            raise NotImplementedError(
                f"cuda backend: {op} got a tensor on {t.device}; the CUDA "
                "kernels take CUDA tensors (use the 'torch' backend on the "
                "CPU)")

    def _fallback(self, op: str, variant: str) -> None:
        self._fallback_counter.inc(op=op, variant=variant)
        if (op, variant) not in self._warned:
            self._warned.add((op, variant))
            warnings.warn(
                f"cuda backend has no {op} kernel for variant {variant!r}; "
                "falling back to the torch oracle on the card "
                "(bit-identical, slower)", RuntimeWarning, stacklevel=3)

    def conv2d_q7(self, x, w, b, out_shift, bias_shift, *, stride, rounding,
                  relu: bool = False):
        self._require_cuda("conv2d_q7", x)
        if _health._PROBE is not None:     # observer only: the accumulator
            _health.observe_requant(
                q.conv_acc_q7(x, w, b, bias_shift, stride), out_shift,
                rounding)
        return kconv.conv2d_q7(x, w, b, out_shift, bias_shift, stride=stride,
                               rounding=rounding, relu=relu)

    def conv2d_q7_per_channel(self, x, w, b, out_shifts, bias_shifts, *,
                              stride, rounding, relu: bool = False):
        self._require_cuda("conv2d_q7_per_channel", x)
        if _health._PROBE is not None:     # observer only: the accumulator
            _health.observe_requant(
                q.conv_acc_q7_per_channel(x, w, b, bias_shifts, stride),
                out_shifts, rounding)
        return kconv.conv2d_q7_per_channel(
            x, w, b, out_shifts, bias_shifts, stride=stride,
            rounding=rounding, relu=relu)

    def squash_q7(self, s, *, in_frac, out_frac=7, impl=None):
        self._require_cuda("squash_q7", s)
        impl = impl or REGISTRY.default("squash")
        if impl != REGISTRY.default("squash"):
            self._fallback("squash", impl)
            return _TORCH_ORACLE.squash_q7(s, in_frac=in_frac,
                                           out_frac=out_frac, impl=impl)
        return ksquash.squash_q7(s, in_frac=in_frac, out_frac=out_frac)

    def routing_q7(self, u_hat, plan, *, rounding):
        self._require_cuda("routing_q7", u_hat)
        # the fused kernel implements only the default variants and the
        # Q0.7 squash output; other plans take the oracle loop
        if plan.softmax_impl != REGISTRY.default("softmax"):
            self._fallback("routing.softmax", plan.softmax_impl)
            return _TORCH_ORACLE.routing_q7(u_hat, plan, rounding=rounding)
        if plan.squash_impl != REGISTRY.default("squash"):
            self._fallback("routing.squash", plan.squash_impl)
            return _TORCH_ORACLE.routing_q7(u_hat, plan, rounding=rounding)
        if plan.out_frac != 7:
            return _TORCH_ORACLE.routing_q7(u_hat, plan, rounding=rounding)
        return kroute.routing_q7(
            u_hat, num_iters=plan.routings,
            caps_out_shifts=plan.caps_out_shifts,
            caps_out_fracs=plan.caps_out_fracs,
            agree_shifts=plan.agree_shifts,
            logit_frac=plan.logit_frac, rounding=rounding)


BACKENDS = {"torch": TorchBackend(), "cuda": CudaBackend(metrics=METRICS)}


def get_backend(backend):
    """Resolve a backend name (or pass a backend-shaped object through)."""
    if isinstance(backend, str):
        try:
            return BACKENDS[backend]
        except KeyError:
            raise ValueError(
                f"unknown backend {backend!r}; have {sorted(BACKENDS)}")
    return backend
