"""Wave execution: one wave function per (model, bucket), optionally
split over a data-parallel mesh.

The counterpart of `repro.serving.sharded`.  `wave_fn` is the single
definition of what a serving wave computes — quantize the float images,
run the int8 pipeline (`QuantCapsNet.forward`), score class lengths,
argmax — with `dist.api.shard` constraints on the logical BATCH axis at
the wave's two boundaries, as in the reference.

Under a mesh over a `torch.distributed` world (every rank holding the
whole bucket, as every rank drains the same queue) the wave does
explicitly what the reference's GSPMD does: each rank quantizes and runs
the forward on its contiguous share of the rows (`api.split_rows`; a
rank with no rows launches nothing), `api.gather_rows` assembles v_q in
rank order, and lengths and pred come from the gathered v_q, so every
rank returns the whole wave.  Every int8 op is exact and the rows are
independent, so the split wave is bit-identical to the unsharded one,
whatever the number of ranks.  On a mesh whose model axis is above 1
the rows split over the BATCH lines only and every rank of a model line
computes the same rows, as the reference's GSPMD replicates the wave
over `model`.  Before any compute one small all_gather checks that
every rank of the world agrees on (model id, bucket, wave index): ranks
whose queues diverged raise ValueError instead of deadlocking.  With no
mesh, or a mesh of one device, the very same function runs on all the
rows.

With a tracer installed, the wave opens `wave.h2d` around the padded
batch's copy to the model's device, and the forward its `layer.<name>`
spans (`nn.pipeline`); with none, one `is None` test and no span.

`compile_wave` binds the wave to (model, bucket, mesh).  PyTorch runs
eagerly, so there is nothing to trace or compile: the registry's wave
cache holds these bindings, keyed on (model, bucket), and counts them.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from repro_torch import obs
from repro_torch.dist import api
from repro_torch.obs import trace as _trace

# meshed waves run on each mesh in this process: the wave index its
# ranks agree on
_WAVES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def wave_fn(qnet, bucket: int, mesh=None, model_id: str | None = None):
    """What one serving wave computes, bound to (model, bucket, mesh):
    float images [bucket,H,W,C] -> (v_q int8 [B,J,O], lengths float32
    [B,J], pred int32 [B]), all on the model's device.  `model_id`
    (default: the config's name) is what the ranks of a mesh check they
    agree on."""
    cfg = qnet.pipeline.cfg
    shape = (bucket,) + tuple(cfg.input_shape)
    device = qnet.device
    model_id = model_id or cfg.name
    # a world's mesh (of any size) splits and gathers through its group
    split = mesh is not None and (mesh.world is not None or mesh.size > 1)
    if split and mesh.device != device:
        raise ValueError(f"model on {device}, but this rank's mesh device "
                         f"is {mesh.device}")

    @torch.inference_mode()
    def fn(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if split:
            _WAVES[mesh] = index = _WAVES.get(mesh, 0) + 1
            api.agree(mesh, "serving wave", (model_id, bucket, index))
        if tuple(x.shape) != shape:
            raise ValueError(f"wave bound to {shape}, got {tuple(x.shape)}")
        with api.use_mesh(mesh):
            with (obs.NULL_SPAN if _trace._AMBIENT is None
                  else obs.span("wave.h2d")):
                x = api.split_rows(x, mesh).to(device)
            x = api.shard(x, api.BATCH)
            if x.shape[0]:
                v_q = qnet.forward(qnet.quantize_input(x))
            else:                       # an empty share launches nothing
                v_q = torch.empty((0, cfg.num_classes, cfg.caps_dim),
                                  dtype=torch.int8, device=device)
            v_q = api.shard(api.gather_rows(v_q, mesh, bucket), api.BATCH)
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


def compile_wave(qnet, bucket: int, mesh=None,
                 model_id: str | None = None) -> CompiledWave:
    """Bind `wave_fn(qnet, bucket, mesh, model_id)` for a fixed bucket."""
    shape = (bucket,) + tuple(qnet.pipeline.cfg.input_shape)
    return CompiledWave(fn=wave_fn(qnet, bucket, mesh, model_id), mesh=mesh,
                        bucket=bucket, input_shape=shape)
