"""Multi-model registry: model ids -> quantized CapsNets + wave functions.

Two caches with different lifetimes:

  * model cache — `model(id)` builds a `QuantCapsNet` lazily on first
    request (init -> calibrate -> PTQ, paper Alg. 6/7) on the registry's
    device; externally quantized models are `install()`ed under an id
    and skip the lazy path, and an exported `.capsbin` artifact is
    `install_artifact()`ed onto the registry's device.  `export(id)`
    writes a served model out as that artifact.
  * wave cache — `executable(id, bucket)` binds `wave_fn` to (model,
    bucket) once and reuses it for every later wave.

`quantize_count` / `compile_count` / `exec_hits` count builds, wave
bindings and wave-cache hits, so tests can pin reuse: they are views
over the counters `serving.quantize_builds`, `serving.wave_compiles` and
`serving.wave_cache_hits` of the registry's `obs.MetricsRegistry`.
Models whose `cuda` backend falls back to the torch oracle on
non-default operator variants are listed in `variant_fallbacks` and
counted per (model, variant) in `serving.variant_fallbacks`
(`fallback_counts`), with one warning each.  A lazy build runs under the
span `serving.ptq_build`, a wave binding under `serving.compile_wave`.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.nn.config import (CIFAR10, EDGE_TINY, MNIST, SMALLNORB,
                                   CapsNetConfig)
from repro_torch.nn.pipeline import CapsPipeline, QuantCapsNet
from repro_torch.nn.variants import DEFAULT_SOFTMAX, DEFAULT_SQUASH, VariantSet


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything needed to materialize a servable quantized CapsNet."""
    model_id: str
    config: CapsNetConfig
    backend: str = "torch"           # "torch" oracle | "cuda" kernels
    rounding: str = "floor"
    dataset: str = "mnist"           # calibration kind, or "uniform"
    calib_n: int = 32
    seed: int = 0
    softmax_impl: str = DEFAULT_SOFTMAX
    squash_impl: str = DEFAULT_SQUASH
    per_channel: bool = False        # per-output-channel conv PTQ

    @property
    def variants(self) -> VariantSet:
        return VariantSet(softmax=self.softmax_impl,
                          squash=self.squash_impl)

    def images(self, n: int, seed: int) -> np.ndarray:
        """n request/calibration images matching the config's geometry
        ("uniform" serves geometries with no dataset analogue)."""
        if self.dataset == "uniform":
            rng = np.random.default_rng(seed)
            shape = (n,) + tuple(self.config.input_shape)
            return rng.uniform(0, 1, shape).astype(np.float32)
        return make_image_dataset(self.dataset, n, seed=seed)[0]

    def build(self, device=None) -> QuantCapsNet:
        device = resolve_device(device)
        pipe = CapsPipeline.from_config(self.config, variants=self.variants,
                                        per_channel=self.per_channel)
        params = pipe.init(torch.Generator().manual_seed(self.seed), device)
        calib = self.images(self.calib_n, self.seed + 1)
        return pipe.quantize(params, calib, rounding=self.rounding,
                             backend=self.backend)


def default_specs() -> dict:
    """The paper's three configs plus the edge-tiny geometry, x both op
    backends: "mnist@torch", "mnist@cuda", ... (ids are dataset@backend)."""
    out = {}
    for ds, cfg, kind in (("mnist", MNIST, "mnist"),
                          ("smallnorb", SMALLNORB, "smallnorb"),
                          ("cifar10", CIFAR10, "cifar10"),
                          ("edge_tiny", EDGE_TINY, "uniform")):
        for be in ("torch", "cuda"):
            mid = f"{ds}@{be}"
            out[mid] = ModelSpec(mid, cfg, backend=be, dataset=kind)
    return out


def wave_fn(qnet: QuantCapsNet, bucket: int):
    """What one serving wave computes, bound to (model, bucket): float
    images [bucket,H,W,C] -> (v_q int8 [B,J,O], lengths float32 [B,J],
    pred int32 [B]), all on the model's device."""
    shape = (bucket,) + tuple(qnet.pipeline.cfg.input_shape)
    device = qnet.device

    @torch.inference_mode()
    def fn(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if tuple(x.shape) != shape:
            raise ValueError(f"wave bound to {shape}, got {tuple(x.shape)}")
        v_q = qnet.forward(qnet.quantize_input(x.to(device)))
        lengths = qnet.class_lengths(v_q)
        pred = torch.argmax(lengths, dim=-1).to(torch.int32)
        return v_q, lengths, pred
    return fn


class ModelRegistry:
    def __init__(self, specs: dict | None = None, device=None,
                 metrics: obs.MetricsRegistry | None = None):
        self.device = resolve_device(device)
        self.specs = dict(specs) if specs is not None else default_specs()
        self._models: dict = {}
        self._execs: dict = {}
        # cache counts live in a metrics registry (labeled by model, and
        # bucket); a fresh ModelRegistry defaults to its own, so counts
        # stay per instance
        self.metrics = obs.MetricsRegistry("serving") if metrics is None \
            else metrics
        self._c_quantize = self.metrics.counter(
            "serving.quantize_builds", help="lazy PTQ builds by model")
        self._c_compile = self.metrics.counter(
            "serving.wave_compiles", help="wave function bindings by "
            "(model, bucket)")
        self._c_hits = self.metrics.counter(
            "serving.wave_cache_hits", help="wave-function cache hits")
        self._c_fallback = self.metrics.counter(
            "serving.variant_fallbacks", help="models served through the "
            "cuda->torch variant fallback")
        # model_id -> variant tag for models whose cuda backend falls back
        # to the torch oracle on non-default operator variants (the
        # engine-side view of CudaBackend.fallbacks; warned once each)
        self.variant_fallbacks: dict = {}
        self._warned_fallbacks: set = set()

    # views over the metrics registry
    @property
    def quantize_count(self) -> int:
        return int(self._c_quantize.total())

    @property
    def compile_count(self) -> int:
        return int(self._c_compile.total())

    @property
    def exec_hits(self) -> int:
        return int(self._c_hits.total())

    @property
    def fallback_counts(self):
        """(model, variant tag) -> times noted."""
        return self._c_fallback.view("model", "variant")

    # ------------------------------------------------------------------
    # models
    # ------------------------------------------------------------------
    def register(self, spec: ModelSpec) -> None:
        """(Re-)register a spec under its id, dropping any model and wave
        functions cached for that id."""
        self.specs[spec.model_id] = spec
        self._models.pop(spec.model_id, None)
        self.variant_fallbacks.pop(spec.model_id, None)
        self._drop_waves(spec.model_id)

    def install(self, model_id: str, qnet: QuantCapsNet) -> None:
        """Serve an already-built model under `model_id`, bypassing the
        lazy PTQ path (drops wave functions bound to a previous model)."""
        self._models[model_id] = qnet
        self._drop_waves(model_id)
        self._note_variant_fallback(model_id, qnet)

    def install_artifact(self, capsbin_path, *, model_id: str | None = None,
                         check: bool = True) -> QuantCapsNet:
        """Serve exactly the artifact `export_caps` shipped: load the
        `.capsbin`, rebuild a QuantCapsNet from its ops on the registry's
        device (repro_torch.edge importer: the `cuda` backend on the
        card, bit-identical to the EdgeVM), and install it under
        `model_id` (default: the program's own name).  The static
        verifier vets the program first unless check=False (a tampered
        artifact is rejected with a CheckError, not served)."""
        from repro_torch.edge import load_qnet
        qnet = load_qnet(capsbin_path, check=check, device=self.device)
        self.install(model_id or qnet.pipeline.cfg.name, qnet)
        return qnet

    def export(self, model_id: str, out_dir, *, stem: str | None = None,
               verify_n: int = 4, check: bool = True) -> dict:
        """Dump a served model as an MCU artifact (repro_torch.edge):
        lower it to an EdgeProgram, statically check it (unless
        check=False), write `.capsbin` + manifest + CMSIS-NN-style
        `.c/.h`, and re-verify the reloaded binary in the NumPy VM
        against the live model on `verify_n` images."""
        from repro_torch.edge import export_artifacts
        qnet = self.model(model_id)
        images = None
        if verify_n > 0:
            spec = self.specs.get(model_id)
            if spec is not None:
                images = spec.images(verify_n, seed=99)
            else:                    # install()ed model: synthetic probes
                rng = np.random.default_rng(99)
                shape = (verify_n,) + self.input_shape(model_id)
                images = rng.uniform(0, 1, shape).astype(np.float32)
        stem = stem or model_id.replace("@", "_")
        return export_artifacts(qnet, out_dir, stem=stem,
                                verify_images=images, check=check)

    def _note_variant_fallback(self, model_id: str,
                               qnet: QuantCapsNet) -> None:
        """Non-default operator variants on the cuda backend run the torch
        oracle loop (bit-identical, slower).  Make that observable per
        model: a count plus one warning per (model, variant)."""
        vs = qnet.variants
        if qnet.backend != "cuda" or vs.is_default():
            self.variant_fallbacks.pop(model_id, None)   # no longer stale
            return
        self.variant_fallbacks[model_id] = vs.tag
        self._c_fallback.inc(model=model_id, variant=vs.tag)
        if (model_id, vs.tag) not in self._warned_fallbacks:
            self._warned_fallbacks.add((model_id, vs.tag))
            warnings.warn(
                f"model {model_id!r}: cuda backend falls back to the torch "
                f"oracle for operator variants {vs.tag!r} (no fused "
                "kernel; bit-identical, slower)", RuntimeWarning,
                stacklevel=3)

    def _drop_waves(self, model_id: str) -> None:
        for key in [k for k in self._execs if k[0] == model_id]:
            del self._execs[key]

    def model_ids(self) -> tuple:
        return tuple(sorted(set(self.specs) | set(self._models)))

    def has(self, model_id: str) -> bool:
        return model_id in self._models or model_id in self.specs

    def model(self, model_id: str) -> QuantCapsNet:
        if model_id not in self._models:
            try:
                spec = self.specs[model_id]
            except KeyError:
                raise KeyError(
                    f"unknown model {model_id!r}; have {self.model_ids()}")
            with obs.span("serving.ptq_build", model=model_id):
                self._models[model_id] = spec.build(self.device)
            self._c_quantize.inc(model=model_id)
            self._note_variant_fallback(model_id, self._models[model_id])
        return self._models[model_id]

    def input_shape(self, model_id: str) -> tuple:
        """Static geometry only — never triggers the lazy PTQ build."""
        if model_id in self._models:
            return tuple(self._models[model_id].pipeline.cfg.input_shape)
        return tuple(self.specs[model_id].config.input_shape)

    # ------------------------------------------------------------------
    # wave functions
    # ------------------------------------------------------------------
    def executable(self, model_id: str, bucket: int):
        key = (model_id, bucket)
        if key in self._execs:
            self._c_hits.inc(model=model_id, bucket=str(bucket))
            return self._execs[key]
        with obs.span("serving.compile_wave", model=model_id, bucket=bucket):
            exe = wave_fn(self.model(model_id), bucket)
        self._execs[key] = exe
        self._c_compile.inc(model=model_id, bucket=str(bucket))
        return exe
