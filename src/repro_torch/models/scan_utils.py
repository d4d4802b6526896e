"""Time scans of the recurrent mixers; the counterpart of
`repro.models.scan_utils`.

The reference nests two `lax.scan`s, the inner one rematerialized, so
that training saves one carry per chunk.  `chunked_scan` is a Python
loop over time; when autograd records (grad enabled) and S is longer
than the chunk, each chunk of steps runs under `checkpoint` (this
module's wrapper of `torch.utils.checkpoint`, which the transformer's
stacks and loss use too), so the backward keeps the carry at each chunk
boundary and recomputes the steps inside, as the reference's remat
does.  Without grad (serving) it is the plain loop.  The values are the
same either way.  Both loops are `op_analysis.trip_scan`s and the
checkpointed function goes through `op_analysis.remat`, so a dry run
weights them by trip count.  `pick_chunk` is the reference's exactly:
`mlstm_apply` uses it to choose between the closed form and the
recurrence, so it changes the numbers.
"""
from __future__ import annotations

import contextvars

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from repro_torch.dist.op_analysis import remat, trip_scan

SCAN_CHUNK = 64      # the chunk of the mamba and sLSTM scans (the reference's)


def rematerializing() -> bool:
    """Whether a remat point recomputes in the backward: autograd is
    recording."""
    return torch.is_grad_enabled()


def checkpoint(fn, *args):
    """fn(*args) under `torch.utils.checkpoint` (non-reentrant) when
    `rematerializing()`, else fn(*args).  The RNG state is not kept: the
    models draw no random numbers.  The recompute runs in the context
    variables of the forward (the active mesh and the rows' layout,
    `dist.api`): autograd may run a CUDA backward on a thread of its own,
    which does not see them."""
    if not rematerializing():
        return fn(*args)
    ctx = contextvars.copy_context()
    run = remat(fn)
    return _checkpoint(lambda *a: ctx.run(run, *a), *args,
                       use_reentrant=False, preserve_rng_state=False)


def _stack(ys):
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(col) for col in zip(*ys))
    return torch.stack(ys)


def _cat(parts):
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(col) for col in zip(*parts))
    return torch.cat(parts)


def _steps(body, carry, xs, many: bool, t0: int, t1: int):
    def step(i, carry):
        t = t0 + i
        return body(carry, tuple(x[t] for x in xs) if many else xs[t])
    carry, ys = trip_scan(step, t1 - t0, carry)
    return carry, _stack(ys)


def chunked_scan(body, carry, xs, chunk: int = 64):
    """Like lax.scan(body, carry, xs) over the leading axis S of every
    leaf of `xs` (a tensor or a tuple of them): returns (carry, ys
    stacked on a new leading axis).  S must be at most `chunk` or
    divisible by it, as in the reference.  With grad enabled and S >
    chunk, every chunk is rematerialized in the backward."""
    many = isinstance(xs, tuple)
    S = (xs[0] if many else xs).shape[0]
    if S > chunk and S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    if S <= chunk or not rematerializing():
        return _steps(body, carry, xs, many, 0, S)
    def part(i, carry):
        t0 = i * chunk
        return checkpoint(_steps, body, carry, xs, many, t0, t0 + chunk)
    carry, parts = trip_scan(part, S // chunk, carry)
    return carry, _cat(parts)


def pick_chunk(S: int, target: int = 64) -> int:
    c = min(target, S)
    while S % c:
        c -= 1
    return c
