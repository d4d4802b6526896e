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

`S`, not the hardware, defines the numerics.  Step 3 runs as the
microbatches come: each finished subtree of the halving tree is added
to its left sibling at once (`tree_push`), so a step holds about
log2(S) + 1 partials, not S.  Under a data-parallel mesh over a
`torch.distributed` world each rank computes step 2 for its contiguous
share of the S microbatches (`dist.api.row_share`; a share may be
empty), sums each whole subtree of the tree that lies in its share
(`tree_blocks`), and the ranks gather those sums in microbatch order
(`dist.api.gather_shares`, one to about 2 log2(S) rows a rank) and
finish the tree on every rank, with the same additions in the same
order: growing the world never changes a bit of the loss curve.  The
accuracy count is an integer all_reduce, and the optimizer runs
replicated.  The whole step (forward, backward, reduction, update) runs
in full float32 with deterministic cuDNN algorithms
(`deterministic_fp32`), scoped to the step: TF32 would
round the convolutions' and matmuls' inputs, and cuDNN's fastest
weight-gradient algorithms may add in a different order from run to
run, so a step replayed from a checkpoint would not repeat its bits.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.captrain.losses import accuracy_count, margin_loss
from repro_torch.dist import api
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


def tree_blocks(lo: int, hi: int) -> list:
    """The whole subtrees of `pairwise_reduce`'s tree that tile rows
    [lo, hi): blocks (b, n), n a power of two and b % n == 0, each as
    large as it can be, in order."""
    out = []
    while lo < hi:
        n = 1 << (hi - lo).bit_length()
        while lo % n or lo + n > hi:
            n //= 2
        out.append((lo, n))
        lo += n
    return out


def tree_push(stack: list, b: int, n: int, total: list) -> None:
    """Push `total`, the tree's sums over rows [b, b + n) (a list of
    tensors), onto `stack` and add each finished pair of siblings as
    left + right, the tree's own addition: pushing the rows 0 .. S-1 one
    by one, or the `tree_blocks` of consecutive shares of them, leaves
    [(0, S, pairwise_reduce(rows))], bit for bit.  The stack starts at
    row 0 or at a block's own start, so it holds the blocks of a binary
    count and a top of the pushed block's size is its left sibling.
    The sums are new tensors (one `_foreach_add` a pair): the tensors
    pushed may be autograd's, which can alias."""
    while stack and stack[-1][1] == n:
        b, _, left = stack.pop()
        total = torch._foreach_add(left, total)
        n *= 2
    stack.append((b, n, total))


def make_train_step(pipeline, decoder, opt, *, num_classes: int,
                    microbatches: int = 8, recon_weight: float = 0.0,
                    plan=None, rounding: str = "floor", mesh=None):
    """One step: (state, x, y) -> (state, metrics), x and y the whole
    batch as tensors on the state's device (on every rank, under a mesh).

    plan=None trains the float pipeline; a PipelinePlan switches the
    forward to `CapsPipeline.forward_fq` (fake-quant QAT) on that plan's
    grids.  Under a `mesh` the microbatches split over its BATCH lines
    (replicated over a model axis); the losses and the state equal the no-mesh step's bit for
    bit, for every S and every number of ranks."""
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
        ways = api.dp_size(mesh)
        shares = [tree_blocks(*api.row_share(S, ways, r))
                  for r in range(ways)]
        with deterministic_fp32():
            live = tree_map(lambda p: p.detach().requires_grad_(True),
                            state["params"])
            flat = leaves(live)
            # each microbatch's [loss, *gradients], added into the tree
            # as it comes; then each whole subtree's sums, one flat row
            # a block, gathered from the ranks
            sizes = [1] + [p.numel() for p in flat]
            rows = []
            count = torch.zeros((), dtype=torch.int64, device=x.device)
            for b, n in shares[api.dp_rank(mesh)]:
                stack = []
                for s in range(b, b + n):
                    loss, k = micro_loss(live, xs[s], ys[s])
                    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                                materialize_grads=True)
                    tree_push(stack, s, 1, [loss.detach()] + list(grads))
                    count = count + k
                rows.append(torch.cat([t.reshape(-1) for t in stack[0][2]]))
            part = api.gather_shares(
                torch.stack(rows) if rows
                else flat[0].new_empty((0, sum(sizes))),
                mesh, [len(sh) for sh in shares])
            stack = []
            for (b, n), row in zip([bl for sh in shares for bl in sh], part):
                tree_push(stack, b, n, list(torch.split(row, sizes)))
            total = torch._foreach_div(stack[0][2], S)
            loss = total[0].reshape(())
            grads = unflatten(live, [t.reshape(p.shape)
                                     for t, p in zip(total[1:], flat)])
            acc = api.all_reduce(count, mesh) / x.shape[0]   # int sum
            params, opt_state, info = opt.update(grads, state["opt"],
                                                 state["params"])
        metrics = {"loss": loss, "accuracy": acc,
                   "grad_norm": info["grad_norm"], "lr": info["lr"],
                   "step": opt_state["step"]}
        return {"params": params, "opt": opt_state}, metrics

    return step
