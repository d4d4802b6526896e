"""End-to-end run on the port: train a ~100M-parameter LM for a few
hundred steps with checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_lm.py      # ~100M, 200 steps
    PYTHONPATH=src python examples/torch_train_lm.py --params 25e6 --steps 100

The counterpart of examples/train_lm.py on `repro_torch`: the same
`sized_config` (V 8192, the same d / L search), AdamW with a cosine
schedule warming up over 20 steps, weight decay 0.01 and clipping at 1,
the token stream of seed 11, a checkpoint every 50 steps (keep 2) and at
the end, all under `dist.fault.run_with_restarts`.  The step is the
port's `launch.steps.make_train_step`, timed after
`torch.cuda.synchronize()`.  Kill it mid-run and re-run: it prints
`[resume] step N` and continues from the checkpoint on the exact batch
index.  The flags are the reference's plus --device (the card unless
`cpu` is asked); --ckpt-dir defaults to build/torch_train_lm under the
repository.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import ckpt  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.synthetic import TokenTask  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.dist.fault import StepTimer, run_with_restarts  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import make_batch  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.optim.adam import AdamW, cosine_schedule  # noqa: E402


def sized_config(target_params: float, log=print) -> ModelConfig:
    """Dense LM sized to ~target_params (12 * L * d^2 + 2 V d)."""
    V = 8192
    best = None
    for d in (256, 384, 512, 640, 768, 1024):
        for L in (2, 4, 6, 8, 12, 16):
            n = 12 * L * d * d + 2 * V * d
            if best is None or abs(n - target_params) < abs(best[0]
                                                            - target_params):
                best = (n, d, L)
    n, d, L = best
    log(f"[config] d_model={d} layers={L}  (~{n/1e6:.1f}M params)")
    return ModelConfig(
        name="train_lm_100m", family="dense", num_layers=L, d_model=d,
        num_heads=8, num_kv_heads=4, head_dim=d // 8, d_ff=4 * d,
        vocab_size=V)


def train_lm(target_params: float = 100e6, steps: int = 200,
             batch: int = 4, seq: int = 256,
             ckpt_dir=ROOT / "build" / "torch_train_lm", device=None,
             log=print) -> dict:
    """Train (or resume) to `steps`.  Returns {"cfg", "start" (the step
    resumed from, 0 for a fresh run), "log": [{"step", "loss", "lr",
    "ms"}, ...] of the last attempt's steps, "state"}."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = sized_config(target_params, log)
    model = build_model(cfg)
    # short-run schedule (the production default warms up over 2000 steps)
    opt = AdamW(lr=cosine_schedule(1e-3, warmup=20, total=steps),
                weight_decay=0.01, clip_norm=1.0)
    task = TokenTask(cfg.vocab_size, seq, seed=11)
    train_step = make_train_step(cfg, opt)
    out = {"cfg": cfg}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def make_and_run(attempt: int) -> int:
        params = model.init(torch.Generator(device).manual_seed(0), device)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        start = 0
        got = ckpt.restore_latest(ckpt_dir, state, into=True)
        if got[0] is not None:
            start, state = got
            log(f"[resume] step {start}")
        timer = StepTimer()
        rows = []
        for i in range(start, steps):
            b = make_batch(cfg, task, i, batch, device)
            sync()
            timer.start()
            state, m = train_step(state, b)
            sync()                          # sync for honest step timing
            dt = timer.stop()
            rows.append({"step": i, "loss": float(m["loss"]),
                         "lr": float(m["lr"]), "ms": dt * 1e3})
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i:4d}: loss={rows[-1]['loss']:.4f} "
                    f"lr={rows[-1]['lr']:.2e} {dt*1e3:6.0f} ms/step")
            if (i + 1) % 50 == 0:
                ckpt.save(ckpt_dir, i + 1, state)
                ckpt.gc_keep_n(ckpt_dir, keep=2)
        ckpt.save(ckpt_dir, steps, state)
        out.update(start=start, log=rows, state=state)
        return steps

    run_with_restarts(make_and_run, max_restarts=2)
    log("train_lm done")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", type=float, default=100e6)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build"
                                              / "torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)
    return train_lm(args.params, args.steps, args.batch, args.seq,
                    args.ckpt_dir, args.device)


if __name__ == "__main__":
    main()
