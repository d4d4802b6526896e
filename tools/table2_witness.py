"""A witness for the int8 columns of a Table-2 row, on the CPU: the float
state that a `torch_train_capsnet --ckpt-dir DIR` run saved (its newest
checkpoint, the float run's last step) quantized by the port's `torch`
oracle and, carried across, by the reference `repro`, each with the
trainer's calibration set, and scored on the example's evaluation images
(`eval_n` of seed 999,999).  Prints acc_f32 and, for each rounding,
acc_ptq from both sides and whether their PTQ plans are equal.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/table2_witness.py \\
        build/examples_smoke/smallnorb --dataset smallnorb

Where both sides give the same acc_ptq as the row printed on the card,
the card's int8 accuracy is what the reference's PTQ makes of those
float weights: the loss comes from the plan, not from the port.
"""
from __future__ import annotations

import argparse

import jax.numpy as jnp

from repro.captrain.evalq import eval_q7 as r_eval_q7
from repro.captrain.trainer import CapsTrainer as RTrainer
from repro.captrain.trainer import TrainConfig as RTrainConfig
from repro.data.synthetic import make_image_dataset as r_images
from repro.nn import config as rconfig
from repro.nn.plans import plan_to_json as r_plan_json
from repro.serving.registry import EDGE_TINY as R_EDGE_TINY
from repro_torch.captrain.evalq import eval_float, eval_q7
from repro_torch.captrain.trainer import CapsTrainer, TrainConfig
from repro_torch.convert import state_to_reference
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.nn import config as tconfig
from repro_torch.nn.plans import plan_to_json

EVAL_SEED = 999_999             # table2_rows' evaluation images
CONFIGS = {"mnist": "MNIST", "smallnorb": "SMALLNORB", "cifar10": "CIFAR10",
           "edge_tiny": "EDGE_TINY"}


def witness(ckpt_dir: str, dataset: str, eval_n: int = 768,
            roundings=("floor", "nearest")) -> dict:
    """{"step", "acc_f32", "port": {rounding: acc_ptq}, "reference":
    {rounding: acc_ptq}, "plans_equal": {rounding: bool}} of the newest
    checkpoint in `ckpt_dir`."""
    cfg = getattr(tconfig, CONFIGS[dataset])
    rcfg = R_EDGE_TINY if dataset == "edge_tiny" else \
        getattr(rconfig, CONFIGS[dataset])
    trainer = CapsTrainer(cfg, TrainConfig(dataset=dataset,
                                           ckpt_dir=ckpt_dir), device="cpu")
    state, _ = trainer.resume_or_init()
    step = trainer.step_index(state)
    if step == 0:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    images, labels = make_image_dataset(dataset, eval_n, seed=EVAL_SEED)
    r_imgs, r_labels = r_images(dataset, eval_n, seed=EVAL_SEED)
    caps = state["params"]["caps"]
    out = {"step": step, "acc_f32": eval_float(trainer.pipeline, caps,
                                               images, labels),
           "port": {}, "reference": {}, "plans_equal": {}}

    rtrainer = RTrainer(rcfg, RTrainConfig(dataset=dataset))
    r_params = {layer: {k: jnp.asarray(v) for k, v in ws.items()}
                for layer, ws in state_to_reference(caps).items()}
    r_calib = rtrainer.calib_images()
    for rounding in roundings:
        q = trainer.quantize(state, rounding=rounding, backend="torch")
        out["port"][rounding] = eval_q7(q, images, labels)
        rq = rtrainer.pipeline.quantize(r_params, r_calib, rounding=rounding,
                                        backend="jnp")
        out["reference"][rounding] = r_eval_q7(rq, r_imgs, r_labels)
        out["plans_equal"][rounding] = \
            plan_to_json(q.plan) == r_plan_json(rq.plan)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir", help="a torch_train_capsnet --ckpt-dir")
    ap.add_argument("--dataset", choices=list(CONFIGS), default="smallnorb")
    ap.add_argument("--eval-n", type=int, default=768)
    args = ap.parse_args(argv)
    res = witness(args.ckpt_dir, args.dataset, args.eval_n)
    print(f"{args.dataset}, the float state of step {res['step']} in "
          f"{args.ckpt_dir}: acc_f32 {res['acc_f32']!r} (the port's float "
          f"pipeline on the CPU, {args.eval_n} images)")
    for r in res["port"]:
        print(f"  {r:<8} acc_ptq: port's torch oracle {res['port'][r]!r}, "
              f"reference (jnp backend) {res['reference'][r]!r}; PTQ plans "
              f"equal: {res['plans_equal'][r]}")
    return res


if __name__ == "__main__":
    main()
