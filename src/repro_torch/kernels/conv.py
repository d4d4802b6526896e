"""Int8 NHWC convolution with a shifted bias, requantisation, saturation
and an optional relu: the CUDA kernel's wrapper and its plain versions.

`conv2d_q7` (one output and one bias shift) and `conv2d_q7_per_channel`
(a table of each, one entry a channel) take x [B, H, W, Cin] and w [KH,
KW, Cin, Cout] int8, VALID padding.  A tensor on the CPU goes to the
plain version (`repro_torch.quant.int8_ops.conv2d_q7` /
`conv2d_q7_per_channel`, the torch oracle), then `relu_q7`; a CUDA
tensor goes to `csrc/conv_q7.cu`, one implicit-GEMM launch a call with
the bias, shifts, saturation and relu in its epilogue, or raises.  The
kernel replaces no TPU kernel: the reference runs these convs on XLA's
int32 conv.  The shift tables go with the launch's arguments, so a call
copies nothing to the card and does not synchronise; the arguments of
each geometry and shift table are packed once (`_launch_args`).  This
module picks the tile (`conv_plan`); the C entry checks what it is given
(the tile, Cout, the tables, the shared memory, each tensor under 2^31
elements) and refuses the rest with an error that `build.check` raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.quant import int8_ops as q

BLOCK_ROWS = (128, 64, 32, 16)         # output pixels a block, largest first
BLOCK_COLS = (16, 32, 64)              # output channels a block
SHIFT_CLAMP = 64                       # any |shift| >= 32 acts as 32 or 33

conv2d_q7_plain = q.conv2d_q7
conv2d_q7_per_channel_plain = q.conv2d_q7_per_channel


class ConvPlan(NamedTuple):
    bm: int                            # output pixels a block
    bn: int                            # output channels a block
    blocks: int                        # the grid's blocks


def tile_fits(bm: int, bn: int) -> bool:
    """Four warps split a bm x bn tile into m16 x n8 mma tiles: along the
    pixels first (min(bm / 16, 4) warps), the rest along the channels."""
    wm = min(bm // 16, 4)
    return bn // (4 // wm) >= 8


def conv_plan(M: int, Cout: int, sms: int) -> ConvPlan:
    """The tile of `csrc/conv_q7.cu` for M output pixels and Cout channels
    on a card of `sms` SMs: BN the least of 16/32/64 that holds Cout (64
    and more columns of blocks above it), BM the largest of BLOCK_ROWS
    whose grid still gives every SM a block (the smallest that fits four
    warps where none does)."""
    bn = next((b for b in BLOCK_COLS if Cout <= b), BLOCK_COLS[-1])
    cols = -(-Cout // bn)
    fits = [bm for bm in BLOCK_ROWS if tile_fits(bm, bn)]
    bm = next((bm for bm in fits if -(-M // bm) * cols >= sms), fits[-1])
    return ConvPlan(bm, bn, -(-M // bm) * cols)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _launch():
    fn = build.load("conv_q7").conv_q7_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, P, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return fn


def _clamp(shift) -> int:
    """Past 32 a left shift gives 0, a right one the sign fill and the
    half-LSB 0, so clamping to [-64, 64] changes no result and every
    shift fits the kernel's int8 tables."""
    return max(-SHIFT_CLAMP, min(SHIFT_CLAMP, int(shift)))


def _shift_tuple(shifts) -> tuple:
    return shifts if isinstance(shifts, tuple) else \
        tuple(torch.as_tensor(shifts).reshape(-1).tolist())


def _check(x, w, bias, padding: str) -> None:
    if padding != "VALID":
        raise NotImplementedError(f"padding {padding!r}: only VALID")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t is not None and t.dtype != torch.int8:
            raise TypeError(f"conv2d_q7 takes int8 operands, {name} is "
                            f"{t.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_q7 takes x [B,H,W,Cin] and w [KH,KW,Cin,"
                         f"Cout], got {tuple(x.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"conv2d_q7 bias {tuple(bias.shape)} for "
                         f"{w.shape[3]} channels")


@functools.lru_cache(maxsize=512)
def _launch_args(xshape, wshape, stride: int, index: int, out_shifts: tuple,
                 bias_shifts: tuple, nearest: bool, relu: bool):
    """The output shape and the C entry's int arguments of one conv on
    card `index`, worked out once: [B, H, W, Cin, KH, KW, Cout, stride,
    nearest, relu, bm, bn, n_out, n_bias, out shifts..., bias shifts...]."""
    B, H, W, Cin = xshape
    KH, KW, _, Cout = wshape
    if stride < 1 or H < KH or W < KW:
        raise ValueError(f"conv2d_q7: stride {stride}, {H}x{W} input, "
                         f"{KH}x{KW} kernel")
    OH, OW = (H - KH) // stride + 1, (W - KW) // stride + 1
    plan = conv_plan(B * OH * OW, Cout, _sm_count(index))
    vals = [B, H, W, Cin, KH, KW, Cout, stride, int(nearest), int(relu),
            plan.bm, plan.bn, len(out_shifts), len(bias_shifts),
            *map(_clamp, out_shifts), *map(_clamp, bias_shifts)]
    return (B, OH, OW, Cout), (ctypes.c_int * len(vals))(*vals), plan


def _conv_cuda(x, w, bias, out_shifts: tuple, bias_shifts: tuple,
               stride: int, rounding: str, relu: bool):
    dev = x.device
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"conv2d_q7: {name} on {t.device}, x on {dev}")
    shape, args, plan = _launch_args(x.shape, w.shape, stride, dev.index,
                                     out_shifts, bias_shifts,
                                     rounding == "nearest", bool(relu))
    out = x.new_empty(shape)
    x, w = x.contiguous(), w.contiguous()
    bias = None if bias is None else bias.contiguous()
    # the raw current stream: torch.cuda.current_stream() builds a Stream
    # object a call, a host cost the serving wave pays once a conv
    err = _launch()(x.data_ptr(), w.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), args, dev.index,
                    torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(err, f"conv_q7 {plan}")
    return out


def _on_card(x, op: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise NotImplementedError(f"{op} on {x.device}")
    return True


def conv2d_q7(x, w, bias, out_shift: int, bias_shift: int, stride: int = 1,
              padding: str = "VALID", rounding: str = "floor",
              relu: bool = False):
    """NHWC int8 conv: int32 accumulation, bias << bias_shift, one output
    shift and saturation (int8_ops.conv2d_q7), then relu_q7 if `relu`."""
    _check(x, w, bias, padding)
    if not _on_card(x, "conv2d_q7"):
        y = conv2d_q7_plain(x, w, bias, out_shift, bias_shift, stride=stride,
                            padding=padding, rounding=rounding)
        return q.relu_q7(y) if relu else y
    y = _conv_cuda(x, w, bias, (int(out_shift),), (int(bias_shift),), stride,
                   rounding, relu)
    conv2d_q7.launches += 1
    return y


conv2d_q7.launches = 0


def conv2d_q7_per_channel(x, w, bias, out_shifts, bias_shifts,
                          stride: int = 1, padding: str = "VALID",
                          rounding: str = "floor", relu: bool = False):
    """conv2d_q7 with per-output-channel bias and output shift tables
    (int8_ops.conv2d_q7_per_channel), then relu_q7 if `relu`."""
    _check(x, w, bias, padding)
    if not _on_card(x, "conv2d_q7_per_channel"):
        y = conv2d_q7_per_channel_plain(x, w, bias, out_shifts, bias_shifts,
                                        stride=stride, padding=padding,
                                        rounding=rounding)
        return q.relu_q7(y) if relu else y
    y = _conv_cuda(x, w, bias, _shift_tuple(out_shifts),
                   _shift_tuple(bias_shifts), stride, rounding, relu)
    conv2d_q7_per_channel.launches += 1
    return y


conv2d_q7_per_channel.launches = 0
