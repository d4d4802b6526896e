"""Fused int8 dynamic routing (paper Alg. 5): the CUDA kernel's wrapper
and its plain version.

`routing_q7` takes u_hat int8 [B, J, I, O] and returns v int8 [B, J, O]
in Q0.7 after all r iterations.  A tensor on the CPU goes to
`routing_q7_plain`; a CUDA tensor goes to `csrc/routing_q7.cu` or
raises.  The kernel replaces the Pallas TPU kernel
`repro.kernels.routing.routing_q7_pallas` and implements what it does:
the default softmax ("q7") and squash ("exact") variants, Q0.7 output.

`routing_q7_plain` is the torch loop the kernel is held against; with
other variant faces and output formats it is also the `torch` backend's
routing (`repro_torch.nn.backend.TorchBackend.routing_q7`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.squash import MAX_DIM, check_in_frac
from repro_torch.quant import int8_ops as q

MAX_ITERS = 8                          # csrc/routing_q7.cu kMaxIters
SMEM_LIMIT = 232_448                   # H100: 227 KB of dynamic smem a block


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def routing_smem_bytes(J: int, I: int, O: int) -> int:
    """Dynamic shared memory one CTA needs: u_hat [J*I*O] int8, logits
    and couplings [J*I] int8 each, s/v [J*O] int32 (the layout in
    csrc/routing_q7.cu)."""
    return _align16(J * I * O) + 2 * _align16(J * I) + _align16(4 * J * O)


def routing_q7_plain(u_hat, *, num_iters: int, caps_out_shifts,
                     caps_out_fracs, agree_shifts, logit_frac: int,
                     rounding: str = "floor", softmax=q.softmax_q7,
                     squash=q.squash_q7, out_frac: int = 7):
    """Alg. 5's r-iteration loop over an already-computed u_hat.

    `softmax` / `squash` are variant q7 faces; the agreement shifts were
    derived for a Q0.7 squash output, so `out_frac - 7` is added to them
    to keep the logits in Q(logit_frac) when the output format differs."""
    B, J, I, _ = u_hat.shape
    b = torch.zeros((B, J, I), dtype=torch.int8, device=u_hat.device)
    v = None
    for r in range(num_iters):
        c = softmax(b.transpose(1, 2), logit_frac).transpose(1, 2)
        acc = q.einsum_i32("bji,bjio->bjo", c, u_hat)
        s_q = q.rshift_sat8(acc, caps_out_shifts[r], rounding)
        v = squash(s_q, in_frac=caps_out_fracs[r], out_frac=out_frac)
        if r < num_iters - 1:
            acc = q.einsum_i32("bjio,bjo->bji", u_hat, v)
            a = q.rshift_sat8(acc, agree_shifts[r] + out_frac - 7, rounding)
            b = q.add_q7(b, a)
    return v


def _lib():
    lib = build.load("routing_q7")
    fn = lib.routing_q7_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.POINTER(ctypes.c_int)] * 3 \
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_geometry(J: int, I: int, O: int, num_iters: int) -> None:
    """Raise for a routing problem the kernel does not take."""
    if not 1 <= O <= MAX_DIM:
        raise ValueError(f"routing_q7 takes capsule dim 1..{MAX_DIM}, got {O}")
    if not 1 <= num_iters <= MAX_ITERS:
        raise ValueError(f"routing_q7 takes 1..{MAX_ITERS} iterations, "
                         f"got {num_iters}")
    need = routing_smem_bytes(J, I, O)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"routing_q7: one sample's u_hat, logits and couplings "
            f"(J={J}, I={I}, O={O}) need {need} B of shared memory, above "
            f"the {SMEM_LIMIT} B a block can have")


def routing_q7(u_hat, *, num_iters: int, caps_out_shifts, caps_out_fracs,
               agree_shifts, logit_frac: int, rounding: str = "floor"):
    """u_hat int8 [B, J, I, O] -> v int8 [B, J, O], all r iterations fused."""
    kw = dict(num_iters=num_iters, caps_out_shifts=caps_out_shifts,
              caps_out_fracs=caps_out_fracs, agree_shifts=agree_shifts,
              logit_frac=logit_frac, rounding=rounding)
    if u_hat.device.type == "cpu":
        return routing_q7_plain(u_hat, **kw)
    if u_hat.device.type != "cuda":
        raise NotImplementedError(f"routing_q7 on {u_hat.device}")
    if u_hat.dtype != torch.int8 or u_hat.dim() != 4:
        raise TypeError(f"routing_q7 takes int8 [B, J, I, O], got "
                        f"{u_hat.dtype} {tuple(u_hat.shape)}")
    if rounding not in ("floor", "nearest"):
        raise ValueError(f"unknown rounding {rounding!r}")
    B, J, I, O = u_hat.shape
    check_geometry(J, I, O, num_iters)
    for f in caps_out_fracs:
        check_in_frac(f)
    if len(caps_out_shifts) != num_iters or len(caps_out_fracs) != num_iters \
            or len(agree_shifts) < num_iters - 1:
        raise ValueError("routing_q7: shift tables do not match num_iters")
    u = u_hat.contiguous()
    v = torch.empty((B, J, O), dtype=torch.int8, device=u.device)
    ints = ctypes.c_int * MAX_ITERS
    tables = [ints(*[int(x) for x in t][:MAX_ITERS])
              for t in (caps_out_shifts, caps_out_fracs, agree_shifts)]
    with torch.cuda.device(u.device):
        err = _lib()(u.data_ptr(), v.data_ptr(), B, J, I, O, num_iters,
                     *tables, logit_frac, int(rounding == "nearest"),
                     torch.cuda.current_stream().cuda_stream)
    build.check(err, "routing_q7")
    routing_q7.launches += 1
    return v


routing_q7.launches = 0
