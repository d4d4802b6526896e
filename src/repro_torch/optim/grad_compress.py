"""Int8 gradient compression with error feedback; the counterpart of
`repro.optim.grad_compress`.

The paper's Qm.n power-of-two int8 format applied to the gradient: each
leaf is quantized to int8 with a per-tensor power-of-two scale, the
quantization residual is kept in a float32 error-feedback buffer and
added back the next step (EF-SGD, which keeps convergence).

Exponents are the reference's, floor(log2(127 / max(max_abs, 1e-30)))
clipped to [-24, 24], but read off the float32 quotient's exponent bits
and scaled by exact powers of two: XLA's CPU `log2` and `exp2` are not
exact at some powers of two, so there the reference's exponent can be
one less than the port's (the tests count those cases).

`compress` / `decompress` are the wire format; `EFCompressor.apply` is
the gradient transform and `apply_` its in-place form for the training
step; `compressed_psum` is the reference's collective over the workers
of a `torch.distributed` group (or of a mesh's BATCH line, as the
reference's psum over the data axes): the exponents' minimum, an int32
sum of the aligned int8 payloads, and one exact power-of-two scale.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.w8a8_dense import pow2
from repro_torch.tree import leaves, tree_map, unflatten


def pow2_scale(max_abs):
    """The exponent e (a float32 tensor) with max_abs * 2^e <= 127:
    floor(log2(127 / max(max_abs, 1e-30))) clipped to [-24, 24], from the
    quotient's exponent field (the quotient is a normal float32 for any
    finite max_abs)."""
    y = 127.0 / torch.clamp_min(max_abs.float(), 1e-30)
    e = ((y.view(torch.int32) >> 23) & 0xFF) - 127
    return torch.clamp(e, -24, 24).to(torch.float32)


def compress(g):
    """float tensor -> (int8 tensor, exponent, a 0-d float32 tensor)."""
    gf = g.float()
    e = pow2_scale(torch.amax(torch.abs(gf)))
    q = torch.clamp(torch.round(gf * pow2(e)), -128, 127).to(torch.int8)
    return q, e


def decompress(q, e):
    return q.float() * pow2(-e)


def _feedback(g, err):
    """(dequantized g + err, residual): the transform of one leaf."""
    gf = g.float() + err
    deq = decompress(*compress(gf))
    return deq, gf - deq


@dataclasses.dataclass(frozen=True)
class EFCompressor:
    """Error-feedback int8 gradient compressor."""

    def init(self, params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def apply(self, grads, err):
        """Returns (compressed-then-decompressed grads, new error state)."""
        pairs = [_feedback(g, e) for g, e in zip(leaves(grads),
                                                  leaves(err))]
        return (unflatten(grads, [p[0] for p in pairs]),
                unflatten(grads, [p[1] for p in pairs]))

    @torch.no_grad()
    def apply_(self, grads: list, err: list) -> None:
        """`apply` in place over flat lists: grads[i] becomes the float32
        dequantized gradient (the old one is dropped) and err[i] is
        overwritten with the residual; bit-equal to `apply`."""
        for i, e in enumerate(err):
            deq, res = _feedback(grads[i], e)
            grads[i] = deq
            e.copy_(res)


def compressed_psum(x, group=None):
    """The sum over the workers of `group` of int8-compressed `x`: the
    reference's formula.  `group` is a process group, a `dist.api.Mesh`
    (its BATCH line: the ranks of a model line hold the same x), or None
    for the whole world.  Each worker's exponent e aligns to the
    workers' minimum e_min (an all_reduce MIN), its int8 payload shifts
    right by e - e_min in int32, the payloads add in int32 (an
    all_reduce SUM, exact in any order) and the total scales by
    2^-e_min.  With no world, or one worker, it is
    decompress(compress(x))."""
    import torch.distributed as dist
    from repro_torch.dist import api
    if isinstance(group, api.Mesh):
        if api.dp_size(group) == 1:
            return decompress(*compress(x))
        api.require_world(group)
        group = group.group(api.BATCH).handle
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size(group) == 1:
        return decompress(*compress(x))
    q, e = compress(x)
    e_min = api.collective("min", e.reshape(1), group)[0]
    # shifts past 31 give the sign, as XLA's arithmetic shift does
    shift = torch.clamp(e - e_min, max=31).to(torch.int32)
    tot = api.collective("sum", q.to(torch.int32) >> shift, group)
    return tot.to(torch.float32) * pow2(-e_min)
