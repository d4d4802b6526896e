"""End-to-end LM training driver; the counterpart of
`repro.launch.train`.

Runs the reference's training loop (the synthetic token stream, AdamW
with the cosine schedule and clipping, checkpoints, crash-restart) for
any assigned architecture, in full on the card or reduced:

  # stablelm_3b in full on one H100
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \
      --steps 12 --batch 8 --seq 256 --ckpt-dir /tmp/ck --ckpt-every 4
  # a reduced qwen3_14b on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --reduce --d-model 64 \
      --steps 4 --batch 2 --seq 32 --ckpt-dir /tmp/ck --device cpu

Fault tolerance: checkpoints every --ckpt-every steps (atomic, keep-3),
resumes from LATEST (restored into the freshly built state, so the card
never holds two), and the whole loop runs under
`dist.fault.run_with_restarts`.  --grad-compress applies the int8
error-feedback compression (`optim.grad_compress`) to the gradient.  The
flags and printed lines are the reference's, plus --device (the card
unless `cpu` is asked; no GPU and no --device cpu raises).  --reduce is
off by default as in the reference, so the default arch, qwen3_14b,
trains in full and runs out of one card's memory.

Each step is timed after `torch.cuda.synchronize()`, the counterpart of
the reference's `block_until_ready`; float matmuls run with TF32 off.
A resumed run equals an uninterrupted one bit for bit where every op is
deterministic: on the CPU always, on the card under
`torch.use_deterministic_algorithms(True)` with
CUBLAS_WORKSPACE_CONFIG=:4096:8 (the embedding's backward otherwise
sums with atomics).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import ckpt
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.synthetic import TokenTask
from repro_torch.device import resolve_device
from repro_torch.dist.fault import StepTimer, run_with_restarts
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import build_model
from repro_torch.optim.grad_compress import EFCompressor


def reduced(cfg, d_model=256, layers=None):
    """Shrink an assigned config to a CPU-trainable scale (same family)."""
    n_blocks = len(cfg.blocks)
    num_layers = layers or n_blocks * max(1, 2 // max(n_blocks // 4, 1))
    num_layers = max(n_blocks, (num_layers // n_blocks) * n_blocks)
    return cfg.scaled(
        num_layers=num_layers, d_model=d_model,
        num_heads=4, num_kv_heads=min(4, cfg.num_kv_heads),
        head_dim=d_model // 4,
        d_ff=d_model * 4 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 4096),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        window_size=min(cfg.window_size, 64) if cfg.window_size else 0,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        num_prefix_embeds=min(cfg.num_prefix_embeds, 16),
    )


def make_batch(cfg, task: TokenTask, i: int, batch: int, device) -> dict:
    """Batch i of the token stream on `device`, with the zero image
    prefix (VLM) or zero frames (encoder-decoder) the reference feeds."""
    out = {k: torch.as_tensor(v, device=device)
           for k, v in task.batch(i, batch).items()}
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.zeros(
            (batch, cfg.num_prefix_embeds, cfg.d_model), dtype=torch.float32,
            device=device)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.zeros((batch, task.seq, cfg.d_model),
                                    dtype=torch.float32, device=device)
    return out


def main(argv=None) -> dict:
    """Train as the flags say.  Returns {"state": the final train state,
    "log": [{"step", "loss", "grad_norm", "ms"}, ...] of the last
    attempt's steps, "attempts"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_14b")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, d_model=args.d_model)
    model = build_model(cfg)
    opt = steps_mod.make_optimizer(total_steps=args.steps)
    task = TokenTask(cfg.vocab_size, args.seq, seed=7)
    comp = EFCompressor() if args.grad_compress else None
    step_fn = steps_mod.make_train_step(cfg, opt, comp)
    out = {"attempts": 0}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def make_and_run(attempt: int) -> int:
        out["attempts"] = attempt + 1
        params = model.init(torch.Generator(device).manual_seed(0), device)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        if comp is not None:
            state["err"] = comp.init(params)
        start = 0
        if args.ckpt_dir:
            got = ckpt.restore_latest(args.ckpt_dir, state, into=True)
            if got[0] is not None:
                start, state = got
                print(f"[resume] from step {start}")
        timer = StepTimer()
        log = []
        saved = None
        for i in range(start, args.steps):
            batch = make_batch(cfg, task, i, args.batch, device)
            sync()
            timer.start()
            state, metrics = step_fn(state, batch)
            sync()
            dt = timer.stop()
            rec = {"step": i, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]), "ms": dt * 1e3}
            log.append(rec)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i}: loss={rec['loss']:.4f} "
                      f"gnorm={rec['grad_norm']:.3f} "
                      f"{rec['ms']:.0f}ms"
                      + (" [straggler]" if timer.is_straggler(dt) else ""))
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                saved = i + 1
                ckpt.save(args.ckpt_dir, saved, state)
                ckpt.gc_keep_n(args.ckpt_dir, keep=3)
        if args.ckpt_dir and saved != args.steps:
            ckpt.save(args.ckpt_dir, args.steps, state)
        out["state"], out["log"] = state, log
        return args.steps

    run_with_restarts(make_and_run, max_restarts=2)
    return out


if __name__ == "__main__":
    main()
