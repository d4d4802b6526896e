"""End-to-end CapsNet run on the port's training subsystem: train
(float) with `repro_torch.captrain.CapsTrainer`, then reproduce the
paper's Table 2 — memory-footprint saving and float-vs-int8 accuracy
delta — for plain PTQ and for QAT fine-tuning.

    PYTHONPATH=src python examples/torch_train_capsnet.py --dataset mnist
    PYTHONPATH=src python examples/torch_train_capsnet.py --dataset edge_tiny \
        --steps 120 --qat-steps 40 --device cpu
    PYTHONPATH=src python examples/torch_train_capsnet.py --dataset cifar10

The counterpart of examples/train_capsnet.py on `repro_torch`: the same
datasets, flags, defaults and printed table, over
`repro_torch.captrain.table2_rows` / `format_rows`, plus --device (the
card unless `cpu` is asked).  On the card every int8 accuracy is
`eval_q7` on the `cuda` backend, the `routing_q7` and `squash_q7`
kernels.  Both rounding modes are reported: "floor" is the paper/CMSIS
`>> shift` truncation; "nearest" adds the half-LSB (beyond-paper).
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.captrain import (TrainConfig, format_rows,  # noqa: E402
                                  table2_rows)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.nn.config import (CIFAR10, EDGE_TINY, MNIST,  # noqa: E402
                                   SMALLNORB)

DATASETS = {"mnist": MNIST, "smallnorb": SMALLNORB, "cifar10": CIFAR10,
            "edge_tiny": EDGE_TINY}


def train_capsnet(dataset: str = "mnist", steps: int = 250,
                  qat_steps: int = 60, batch: int = 64, eval_n: int = 768,
                  lr: float | None = None, ckpt_dir: str | None = None,
                  device=None, log=print) -> list:
    """Train `steps` float steps, then PTQ and `qat_steps` of QAT per
    rounding mode; prints and returns the Table-2 rows."""
    device = resolve_device(device)
    cfg = DATASETS[dataset]
    tcfg = TrainConfig(
        dataset=dataset, batch=batch,
        lr=lr if lr is not None else cfg.lr,
        ckpt_dir=ckpt_dir,
        ckpt_every=50 if ckpt_dir else 0)
    log(f"== {cfg.name}  (input {cfg.input_shape}, "
        f"{cfg.num_input_caps} input capsules)")

    t0 = time.time()
    rows = table2_rows(cfg, tcfg, float_steps=steps, qat_steps=qat_steps,
                       eval_n=eval_n, log=log, device=device)
    log(f"\n== Table 2 analogue ({time.time() - t0:.0f}s)")
    log(format_rows(rows))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=list(DATASETS), default="mnist")
    ap.add_argument("--steps", type=int, default=250,
                    help="float training steps")
    ap.add_argument("--qat-steps", type=int, default=60,
                    help="fake-quant fine-tuning steps per rounding mode")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-n", type=int, default=768)
    ap.add_argument("--lr", type=float, default=None,
                    help="override the config's learning rate")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume directory (repro_torch.ckpt)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)
    return train_capsnet(args.dataset, args.steps, args.qat_steps,
                         args.batch, args.eval_n, args.lr, args.ckpt_dir,
                         args.device)


if __name__ == "__main__":
    main()
