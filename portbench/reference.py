"""The plain reference that decides `correct`: post-training quantization
and the integer CapsNet forward, written from the paper (Alg. 4-7, Eq. 8)
in plain PyTorch, from the float weights and calibration images the
benchmark draws.  It imports nothing of the program and takes nothing
the program made: it works out the Qm.n plan, the integer weights and
every served image's forward again.

`bits` sets the integer width: 8 is the configuration's precision; 4 is
the control, the same graph one step of precision lower (Q0.3 capsules
and couplings), whose outputs are put in the program's place on the
int8 grid to show that the comparison fails it.

The products are exact: each conv sums its kernel offsets' float64
products of integers (every partial sum an integer far below 2^53), and
u_hat and the routing sums are int32 products summed in int32.  Float
calibration runs in float32 with TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

MAX_FRAC = 24
GUARD = 10                       # the integer squash's guard bits
EXP_FLOOR = -20                  # the softmax's exponent clamp


@contextlib.contextmanager
def full_fp32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass(frozen=True)
class Geometry:
    convs: tuple             # (kernel, stride) of each relu conv
    pcap: tuple              # (kernel, stride)
    pcap_dim: int
    routings: int

    @classmethod
    def of(cls, cfg: dict) -> "Geometry":
        return cls(convs=tuple(zip(cfg["conv_kernels"], cfg["conv_strides"])),
                   pcap=(cfg["pcap_kernel"], cfg["pcap_stride"]),
                   pcap_dim=cfg["pcap_dim"], routings=cfg["routings"])


# ---------------------------------------------------------------------------
# float face (calibration)
# ---------------------------------------------------------------------------
def _conv_f32(x, w, b, stride):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def squash_f32(s):
    sq = (s * s).sum(dim=-1, keepdim=True)
    return (sq / (1.0 + sq)) * s * torch.rsqrt(sq + 1e-7)


@torch.inference_mode()
def calibrate(geo: Geometry, params: dict, images) -> dict:
    """max|x| at every point the plan reads, over the calibration set."""
    taps = {"input": images}
    with full_fp32():
        h = images
        for i, (_, s) in enumerate(geo.convs):
            p = params[f"conv{i}"]
            y = _conv_f32(h, p["w"], p["b"], s)
            taps[f"conv{i}"] = y
            h = torch.relu(y)
        p = params["pcap"]
        y = _conv_f32(h, p["w"], p["b"], geo.pcap[1])
        taps["pcap"] = y
        u = squash_f32(y.reshape(y.shape[0], -1, geo.pcap_dim))
        u_hat = torch.einsum("jiod,bid->bjio", params["caps"]["W"], u)
        taps["u_hat"] = u_hat
        b = torch.zeros(u_hat.shape[:3], dtype=torch.float32,
                        device=u_hat.device)
        for r in range(geo.routings):
            c = torch.softmax(b, dim=1)
            s = torch.einsum("bji,bjio->bjo", c, u_hat)
            taps[f"s{r}"] = s
            if r < geo.routings - 1:
                b = b + torch.einsum("bjio,bjo->bji", u_hat, squash_f32(s))
                taps[f"logits{r}"] = b
    return {k: float(t.abs().max()) for k, t in taps.items()}


# ---------------------------------------------------------------------------
# the plan (Alg. 6/7) at `bits` bits
# ---------------------------------------------------------------------------
def frac_bits(max_abs: float, bits: int = 8) -> int:
    """The largest n with round(max_abs * 2^n) <= 2^(bits-1) - 1."""
    top = 2 ** (bits - 1) - 1
    if not max_abs > 0:
        return MAX_FRAC
    n = math.floor(math.log2(top / max_abs))
    while round(max_abs * 2.0 ** (n + 1)) <= top and n < MAX_FRAC:
        n += 1
    while round(max_abs * 2.0 ** n) > top and n > -MAX_FRAC:
        n -= 1
    return n


@dataclasses.dataclass(frozen=True)
class Plan:
    bits: int
    input_frac: int
    convs: tuple             # (out_shift, bias_shift) of each conv, pcap last
    pcap_out_frac: int
    uhat_shift: int
    logit_frac: int
    caps_out_shifts: tuple
    caps_out_fracs: tuple
    agree_shift: int


def plan(geo: Geometry, params: dict, stats: dict, bits: int = 8) -> Plan:
    fb = lambda x: frac_bits(x, bits)                      # noqa: E731
    unit = bits - 1                                        # Q0.(bits-1)
    f_in = fb(stats["input"])
    f_act, convs = f_in, []
    for name in [f"conv{i}" for i in range(len(geo.convs))] + ["pcap"]:
        w, b = params[name]["w"], params[name]["b"]
        f_w = fb(float(w.abs().max()))
        f_b = fb(float(b.abs().max())) if b.numel() else f_w
        f_out = fb(stats[name])
        convs.append((f_act + f_w - f_out, f_act + f_w - f_b))
        f_act = f_out
    pcap_out_frac = f_act
    f_W = fb(float(params["caps"]["W"].abs().max()))
    f_uhat = fb(stats["u_hat"])
    logits = [stats[f"logits{r}"] for r in range(geo.routings - 1)]
    f_logit = min(fb(max(logits + [1e-6])), unit)
    f_s = tuple(fb(stats[f"s{r}"]) for r in range(geo.routings))
    return Plan(bits=bits, input_frac=f_in, convs=tuple(convs),
                pcap_out_frac=pcap_out_frac,
                uhat_shift=unit + f_W - f_uhat, logit_frac=f_logit,
                caps_out_shifts=tuple(f_uhat + unit - f for f in f_s),
                caps_out_fracs=f_s, agree_shift=f_uhat + unit - f_logit)


def quantize(x, n: int, bits: int = 8):
    lo, hi = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    return torch.round(x.float() * (2.0 ** n)).clamp(lo, hi).to(torch.int8)


def quantize_weights(geo: Geometry, params: dict, p: Plan) -> dict:
    fb = lambda t: frac_bits(float(t.abs().max()), p.bits)  # noqa: E731
    out = {}
    for name in [f"conv{i}" for i in range(len(geo.convs))] + ["pcap"]:
        w, b = params[name]["w"], params[name]["b"]
        f_w = fb(w)
        f_b = fb(b) if b.numel() else f_w
        out[name] = {"w": quantize(w, f_w, p.bits), "b": quantize(b, f_b, p.bits)}
    out["caps"] = {"W": quantize(params["caps"]["W"], fb(params["caps"]["W"]),
                                 p.bits)}
    return out


# ---------------------------------------------------------------------------
# the integer forward
# ---------------------------------------------------------------------------
def requant(acc, shift: int, bits: int = 8):
    """int32 accumulator -> `bits`-bit value (in int8): arithmetic shift
    (floor rounding, as the program's PTQ is run), saturate."""
    acc = acc.to(torch.int32)
    if shift > 0:
        acc = acc >> shift
    elif shift < 0:
        acc = acc << -shift
    return acc.clamp(-2 ** (bits - 1), 2 ** (bits - 1) - 1).to(torch.int8)


def conv_acc(x, w, stride: int):
    """NHWC int x HWIO int -> NHWC int32, VALID: the sum over the kernel's
    offsets of exact float64 products."""
    B, H, W, _ = x.shape
    KH, KW, _, cout = w.shape
    oh, ow = (H - KH) // stride + 1, (W - KW) // stride + 1
    xf, wf = x.to(torch.float64), w.to(torch.float64)
    acc = torch.zeros((B, oh, ow, cout), dtype=torch.float64, device=x.device)
    for dh in range(KH):
        for dw in range(KW):
            patch = xf[:, dh:dh + stride * (oh - 1) + 1:stride,
                       dw:dw + stride * (ow - 1) + 1:stride, :]
            acc += patch @ wf[dh, dw]
    return acc.to(torch.int64).to(torch.int32)


def isqrt(n):
    """floor(sqrt(n)) of int32 n >= 0, exact: a float64 root corrected
    by one step either way."""
    r = torch.sqrt(n.to(torch.float64)).floor().to(torch.int64)
    n64 = n.to(torch.int64)
    r = torch.where(r * r > n64, r - 1, r)
    r = torch.where((r + 1) * (r + 1) <= n64, r + 1, r)
    return r.to(torch.int32)


def squash_int(s, in_frac: int, out_frac: int, bits: int = 8):
    """Eq. 8 over the last axis: ratio = (S << (o - i + P)) // ((1 << i)
    + (Q >> i)) with Q = sum(s^2), S = isqrt(Q); v = sat((ratio * s) >> P)."""
    s32 = s.to(torch.int32)
    Q = (s32 * s32).sum(dim=-1, keepdim=True, dtype=torch.int32)
    S = isqrt(Q)
    shift = out_frac - in_frac + GUARD
    num = S << shift if shift >= 0 else S >> -shift
    den = ((1 << in_frac) + (Q >> in_frac)).clamp(min=1)
    ratio = torch.div(num, den, rounding_mode="floor")
    v = (ratio * s32) >> GUARD
    return v.clamp(-2 ** (bits - 1), 2 ** (bits - 1) - 1).to(torch.int8)


def softmax_int(x, in_frac: int, bits: int = 8):
    """Over the last axis: powers of two of the integer part of
    x - max(x), normalised to 2^(bits-1) = 1.0."""
    x32 = x.to(torch.int32)
    e = ((x32 - x32.amax(dim=-1, keepdim=True)) >> in_frac).clamp(
        min=EXP_FLOOR)
    p = torch.ones_like(e) << (20 + e)
    tot = p.sum(dim=-1, keepdim=True, dtype=torch.int32).clamp(min=1)
    c = torch.div(p << (bits - 1), tot, rounding_mode="floor")
    return c.clamp(0, 2 ** (bits - 1) - 1).to(torch.int8)


@torch.inference_mode()
def forward(geo: Geometry, qw: dict, p: Plan, images):
    """Float images [B, H, W, C] -> class capsules v [B, J, O] (int8 on
    the `bits`-bit grid, Q0.(bits-1))."""
    bits, unit = p.bits, p.bits - 1
    rq = lambda acc, shift: requant(acc, shift, bits)      # noqa: E731
    h = quantize(images, p.input_frac, bits)
    names = [f"conv{i}" for i in range(len(geo.convs))] + ["pcap"]
    strides = [s for _, s in geo.convs] + [geo.pcap[1]]
    for name, stride, (out_shift, bias_shift) in zip(names, strides, p.convs):
        acc = conv_acc(h, qw[name]["w"], stride)
        b = qw[name]["b"].to(torch.int32)
        acc = acc + (b << bias_shift if bias_shift >= 0 else b >> -bias_shift)
        h = rq(acc, out_shift)
        if name != "pcap":
            h = h.clamp(min=0)
    u = squash_int(h.reshape(h.shape[0], -1, geo.pcap_dim), p.pcap_out_frac,
                   unit, bits)
    W = qw["caps"]["W"].to(torch.int32)                     # [J, I, O, D]
    acc = (W[None] * u.to(torch.int32)[:, None, :, None, :]).sum(
        dim=-1, dtype=torch.int32)                          # [B, J, I, O]
    u_hat = rq(acc, p.uhat_shift).to(torch.int32)
    b = torch.zeros(u_hat.shape[:3], dtype=torch.int32, device=u_hat.device)
    v = None
    for r in range(geo.routings):
        c = softmax_int(b.transpose(1, 2), p.logit_frac, bits).transpose(1, 2)
        s = (c.to(torch.int32)[..., None] * u_hat).sum(dim=2, dtype=torch.int32)
        v = squash_int(rq(s, p.caps_out_shifts[r]),
                       p.caps_out_fracs[r], unit, bits)
        if r < geo.routings - 1:
            a = (u_hat * v.to(torch.int32)[:, :, None, :]).sum(
                dim=-1, dtype=torch.int32)
            a = rq(a, p.agree_shift).to(torch.int32)
            b = (b + a).clamp(-2 ** (bits - 1), 2 ** (bits - 1) - 1)
    return v


def lengths(v, out_frac: int):
    """||v|| a class, dequantized from Q(out_frac)."""
    v32 = v.to(torch.int32)
    ss = (v32 * v32).sum(dim=-1, dtype=torch.int32)
    return torch.sqrt(ss.to(torch.float32)) * (2.0 ** -out_frac)


class Reference:
    """PTQ once (plan and weights), then the forward of any images, as
    the int8 answers the program has to give: v_q on the Q0.7 grid,
    lengths and pred.  With bits < 8 (the control) the capsules are put
    on the int8 grid by a left shift, as the program would return them."""

    def __init__(self, cfg: dict, params: dict, calib, bits: int = 8):
        self.geo = Geometry.of(cfg)
        self.bits = bits
        stats = calibrate(self.geo, params, calib)
        self.plan = plan(self.geo, params, stats, bits)
        self.qw = quantize_weights(self.geo, params, self.plan)

    def answers(self, images, block: int = 512):
        """images [N, H, W, C] on the device -> (v_q int8 [N, J, O],
        lengths float32 [N, J], pred int64 [N]) on the host."""
        outs = []
        for i in range(0, images.shape[0], block):
            v = forward(self.geo, self.qw, self.plan, images[i:i + block])
            v8 = (v.to(torch.int32) << (8 - self.bits)).to(torch.int8)
            ln = lengths(v, self.bits - 1)
            outs.append((v8.cpu(), ln.cpu(), torch.argmax(ln, dim=-1).cpu()))
        return tuple(torch.cat(t).numpy() for t in zip(*outs))
