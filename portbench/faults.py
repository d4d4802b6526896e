"""Stand-ins for the timed path that the comparison has to fail: the
control (the plain reference one step of precision lower, int4, put in
the program's place) and planted faults of a serving wave.  Each patches
`repro_torch.serving.sharded.compile_wave`, which the registry calls to
bind every wave, for the duration of a `with` block; `control.py` and the
tests drive whole runs under them.  The benchmark's runs never do.
"""
from __future__ import annotations

import contextlib

import torch

from portbench import data, reference


def _patch(fn_for):
    """Replace compile_wave by one whose wave function is
    `fn_for(qnet, bucket, real_fn)`."""
    from repro_torch.serving import sharded
    real = sharded.compile_wave

    def compile_wave(qnet, bucket, mesh=None, model_id=None):
        exe = real(qnet, bucket, mesh=mesh, model_id=model_id)
        return sharded.CompiledWave(fn=fn_for(qnet, bucket, exe.fn),
                                    mesh=exe.mesh, bucket=bucket,
                                    input_shape=exe.input_shape)
    return sharded, real, compile_wave


@contextlib.contextmanager
def control(bits: int = 4):
    """Waves answered by the reference at `bits` bits, from the weights
    and calibration images the run draws."""
    seen = {}
    real_draw = data.draw

    def draw(cfg, seed, pool_n, device):
        out = real_draw(cfg, seed, pool_n, device)
        seen.update(cfg=cfg, params=out[0], calib=out[1], ref=None)
        return out

    def fn_for(qnet, bucket, real_fn):
        @torch.inference_mode()
        def fn(x):
            if seen["ref"] is None:
                seen["ref"] = reference.Reference(seen["cfg"], seen["params"],
                                                  seen["calib"], bits=bits)
            ref = seen["ref"]
            x = torch.as_tensor(x, dtype=torch.float32, device=qnet.device)
            v = reference.forward(ref.geo, ref.qw, ref.plan, x)
            ln = reference.lengths(v, bits - 1)
            v8 = (v.to(torch.int32) << (8 - bits)).to(torch.int8)
            return v8, ln, torch.argmax(ln, dim=-1).to(torch.int32)
        return fn

    sharded, real, patched = _patch(fn_for)
    data.draw, sharded.compile_wave = draw, patched
    try:
        yield
    finally:
        data.draw, sharded.compile_wave = real_draw, real


@contextlib.contextmanager
def fault(kind: str):
    """A serving wave broken underneath: "alter" flips the low bit of one
    answer's first capsule element in every wave, where it is produced;
    "half" leaves the second half of every wave's rows out (they are
    computed on blank images)."""
    if kind not in ("alter", "half"):
        raise ValueError(kind)

    def fn_for(qnet, bucket, real_fn):
        def fn(x):
            if kind == "half":
                x = torch.as_tensor(x, dtype=torch.float32).clone()
                x[(bucket + 1) // 2:] = 0
                return real_fn(x)
            v_q, lengths, pred = real_fn(x)
            v_q = v_q.clone()
            v_q[0, 0, 0] ^= 1
            return v_q, lengths, pred
        return fn

    sharded, real, patched = _patch(fn_for)
    sharded.compile_wave = patched
    try:
        yield
    finally:
        sharded.compile_wave = real
