"""Time scans of the recurrent mixers; the counterpart of
`repro.models.scan_utils`.

The reference nests two `lax.scan`s, the inner one rematerialized, so
that training saves one carry per chunk.  The port serves only (LM
training is not ported yet, ROADMAP Queue A), so `chunked_scan` is a Python
loop over time with no remat; it keeps the reference's precondition on
the chunk.  `pick_chunk` is the reference's exactly: `mlstm_apply` uses
it to choose between the closed form and the recurrence, so it changes
the numbers.
"""
from __future__ import annotations

import torch


def _stack(ys):
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(col) for col in zip(*ys))
    return torch.stack(ys)


def chunked_scan(body, carry, xs, chunk: int = 64):
    """Like lax.scan(body, carry, xs) over the leading axis S of every
    leaf of `xs` (a tensor or a tuple of them): returns (carry, ys
    stacked on a new leading axis).  S must be at most `chunk` or
    divisible by it, as in the reference."""
    many = isinstance(xs, tuple)
    S = (xs[0] if many else xs).shape[0]
    if S > chunk and S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    ys = []
    for t in range(S):
        carry, y = body(carry, tuple(x[t] for x in xs) if many else xs[t])
        ys.append(y)
    return carry, _stack(ys)


def pick_chunk(S: int, target: int = 64) -> int:
    c = min(target, S)
    while S % c:
        c -= 1
    return c
