"""Capsule train steps with a fixed gradient reduction order.

The reduction order is part of the step's definition, as in the
reference (`repro.captrain.steps`):

  1. the batch is reshaped into S fixed microbatches [S, B/S, ...];
  2. each microbatch's loss and gradient are computed on their own (a
     loop of S forward passes, each followed by `torch.autograd.grad`),
     with no cross-microbatch arithmetic, so each is exactly the
     gradient of that microbatch alone;
  3. the S partials combine through an explicit pairwise halving tree
     (`pairwise_reduce`), elementwise adds in a fixed association order;
  4. the optimizer runs on the reduced gradient.

`S`, not the hardware, defines the numerics.  The whole step (forward,
backward, reduction, update) runs in full float32 with deterministic
cuDNN algorithms (`deterministic_fp32`), scoped to the step: TF32 would
round the convolutions' and matmuls' inputs, and cuDNN's fastest
weight-gradient algorithms may add in a different order from run to
run, so a step replayed from a checkpoint would not repeat its bits.
On one device the reference's `dist.api.shard` constraints are the
identity, so the step has no sharding call.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.captrain.losses import accuracy_count, margin_loss
from repro_torch.nn.pipeline import _full_fp32
from repro_torch.tree import leaves, tree_map, unflatten


@contextlib.contextmanager
def deterministic_fp32():
    """TF32 off (`_full_fp32`) and cuDNN deterministic, not benchmarking,
    for the duration; every flag is restored on exit."""
    cudnn = torch.backends.cudnn
    old = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with _full_fp32():
            yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


def pairwise_reduce(a):
    """Sum over a power-of-two leading axis in a fixed halving tree:
    ((a0+a1)+(a2+a3))+... ."""
    n = a.shape[0]
    if n & (n - 1):
        raise ValueError(f"leading axis must be a power of two, got {n}")
    while a.shape[0] > 1:
        a = a[0::2] + a[1::2]
    return a[0]


def tree_pairwise_mean(tree, n: int):
    return tree_map(lambda g: pairwise_reduce(g) / n, tree)


def make_train_step(pipeline, decoder, opt, *, num_classes: int,
                    microbatches: int = 8, recon_weight: float = 0.0,
                    plan=None, rounding: str = "floor"):
    """One step: (state, x, y) -> (state, metrics), x and y tensors on
    the state's device.

    plan=None trains the float pipeline; a PipelinePlan switches the
    forward to `CapsPipeline.forward_fq` (fake-quant QAT) on that plan's
    grids."""
    S = microbatches
    if S < 1 or (S & (S - 1)):
        raise ValueError(f"microbatches must be a power of two, got {S}")

    def micro_loss(tparams, x, y):
        """Loss of ONE microbatch (mean over its rows only)."""
        if plan is None:
            v = pipeline.forward(tparams["caps"], x)
        else:
            v = pipeline.forward_fq(tparams["caps"], x, plan,
                                    rounding=rounding)
        loss = margin_loss(v, y, num_classes)
        if decoder is not None and recon_weight > 0:
            loss = loss + recon_weight * decoder.loss(tparams["dec"], v, y,
                                                      x)
        return loss, accuracy_count(v, y)

    def step(state, x, y):
        if x.shape[0] % S:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"microbatches={S}")
        xs = x.reshape((S, x.shape[0] // S) + tuple(x.shape[1:]))
        ys = y.reshape(S, -1)
        with deterministic_fp32():
            live = tree_map(lambda p: p.detach().requires_grad_(True),
                            state["params"])
            flat = leaves(live)
            losses, counts, parts = [], [], []
            for s in range(S):
                loss, count = micro_loss(live, xs[s], ys[s])
                parts.append(torch.autograd.grad(
                    loss, flat, allow_unused=True, materialize_grads=True))
                losses.append(loss.detach())
                counts.append(count)
            grads = unflatten(live, [pairwise_reduce(torch.stack(g)) / S
                                     for g in zip(*parts)])
            loss = pairwise_reduce(torch.stack(losses)) / S
            acc = torch.stack(counts).sum() / x.shape[0]   # int sum
            params, opt_state, info = opt.update(grads, state["opt"],
                                                 state["params"])
        metrics = {"loss": loss, "accuracy": acc,
                   "grad_norm": info["grad_norm"], "lr": info["lr"],
                   "step": opt_state["step"]}
        return {"params": params, "opt": opt_state}, metrics

    return step
