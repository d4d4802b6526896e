"""Decode-vs-prefill drift of the xlstm_1_3b LM on the CPU, the reference
`repro` beside the port `repro_torch`: prefill(t[:65]) against
prefill(t[:64]) then decode_step(t[64]), for 8 TokenTask rows (seed 5),
on the pattern of xlstm_1_3b cut to a width and depth (`reduced`, the
full vocab 50,304), weights from seed 0 (each package its own).  Prints
each side's max |difference| of the logits and how many lie beyond the
tests' tolerance (atol 0.15 + rtol 0.05); the port also with its params
in float32 (a witness that rounds nothing to bf16).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_drift.py \\
        --d-model 1024 --layers 16

It shows that the bf16 drift between the two paths grows with width and
depth in the reference as in the port, while the float32 witness stays
within the tolerance.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as rget
from repro.launch.train import reduced as rreduced
from repro.models import transformer as RT
from repro_torch.configs.base import get_config as tget
from repro_torch.data.synthetic import TokenTask
from repro_torch.launch.train import reduced as treduced
from repro_torch.models import transformer as TT

ATOL, RTOL = 0.15, 0.05


def report(name: str, full, dec) -> None:
    a, b = np.asarray(full, np.float32), np.asarray(dec, np.float32)
    e = np.abs(a - b)
    print(f"{name}: max |diff| {e.max():.4f} over logits up to "
          f"{np.abs(a).max():.3f}, {int((e > ATOL + RTOL * np.abs(a)).sum())}"
          f" of {e.size} beyond atol {ATOL} + rtol {RTOL}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=16)
    args = ap.parse_args(argv)
    toks = TokenTask(50304, 65, seed=5).batch(0, 8)["inputs"]

    cfg = dataclasses.replace(rreduced(rget("xlstm_1_3b"), args.d_model,
                                       args.layers), vocab_size=50304)
    rm = RT.build_model(cfg)
    rp = rm.init(jax.random.key(0))
    pre = jax.jit(lambda p, t: rm.prefill(p, {"inputs": t}, alloc=512))
    full, _ = pre(rp, jnp.asarray(toks))
    _, cache = pre(rp, jnp.asarray(toks[:, :64]))
    dec, _ = jax.jit(rm.decode_step)(rp, cache, jnp.asarray(toks[:, 64:]),
                                     jnp.asarray(64, jnp.int32))
    report(f"reference bf16, d {args.d_model}, {args.layers} layers", full,
           dec)

    cfg = dataclasses.replace(treduced(tget("xlstm_1_3b"), args.d_model,
                                       args.layers), vocab_size=50304)
    tm = TT.build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    t = torch.from_numpy(toks)
    for what, params in (("bf16", tp), ("float32 witness",
                                        TT._map(lambda a: a.float(), tp))):
        with torch.inference_mode():
            full, _ = tm.prefill(params, {"inputs": t}, alloc=512)
            _, cache = tm.prefill(params, {"inputs": t[:, :64]}, alloc=512)
            dec, _ = tm.decode_step(params, cache, t[:, 64:], 64)
        report(f"port {what}, d {args.d_model}, {args.layers} layers",
               full.float().numpy(), dec.float().numpy())


if __name__ == "__main__":
    main()
