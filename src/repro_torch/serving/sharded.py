"""Wave execution: one wave function per (model, bucket), optionally
under a device mesh.

The counterpart of `repro.serving.sharded`.  `wave_fn` is the single
definition of what a serving wave computes — quantize the float images,
run the int8 pipeline (`QuantCapsNet.forward`), score class lengths,
argmax — with `dist.api.shard` constraints on the logical BATCH axis at
the wave's two boundaries, as in the reference.  With no mesh, or a mesh
of one device, `api.shard` is the identity and the very same function
runs, so a wave under a one-device mesh is bit-identical to one without;
a mesh of more than one device raises NotImplementedError when the wave
is bound (ROADMAP Queue A).

`compile_wave` binds the wave to (model, bucket, mesh).  PyTorch runs
eagerly, so there is nothing to trace or compile: the registry's wave
cache holds these bindings, keyed on (model, bucket), and counts them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import api


def wave_fn(qnet, bucket: int, mesh=None):
    """What one serving wave computes, bound to (model, bucket, mesh):
    float images [bucket,H,W,C] -> (v_q int8 [B,J,O], lengths float32
    [B,J], pred int32 [B]), all on the model's device."""
    api.require_one_device(mesh)
    shape = (bucket,) + tuple(qnet.pipeline.cfg.input_shape)
    device = qnet.device

    @torch.inference_mode()
    def fn(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if tuple(x.shape) != shape:
            raise ValueError(f"wave bound to {shape}, got {tuple(x.shape)}")
        with api.use_mesh(mesh):
            x = api.shard(x.to(device), api.BATCH)
            v_q = qnet.forward(qnet.quantize_input(x))
            v_q = api.shard(v_q, api.BATCH)
        lengths = qnet.class_lengths(v_q)
        pred = torch.argmax(lengths, dim=-1).to(torch.int32)
        return v_q, lengths, pred
    return fn


@dataclasses.dataclass(frozen=True)
class CompiledWave:
    """A wave function pinned to one input shape (and mesh, if any)."""
    fn: object
    mesh: object | None              # None off-mesh
    bucket: int
    input_shape: tuple               # (bucket, H, W, C)

    def __call__(self, x):
        return self.fn(x)


def compile_wave(qnet, bucket: int, mesh=None) -> CompiledWave:
    """Bind `wave_fn(qnet, bucket, mesh)` for a fixed bucket."""
    shape = (bucket,) + tuple(qnet.pipeline.cfg.input_shape)
    return CompiledWave(fn=wave_fn(qnet, bucket, mesh), mesh=mesh,
                        bucket=bucket, input_shape=shape)
