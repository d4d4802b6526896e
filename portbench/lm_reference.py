"""The plain reference of a language-model configuration: the whole
forward in float32 over each kept wave's prompts and the tokens the
program served, teacher-forced, in plain PyTorch (TF32 off), one layer
at a time.  It imports nothing of the port.

Weights: each layer's leaves drawn again from the seed
(`lm_data.draw_leaf`, the draws the program was handed in set-up) and
quantized here, as W8A8 defines it: per output channel, a power-of-two
exponent floor(log2(127 / max|w|)) clipped to [-24, 24] over the
contraction axis, int8 = round(w * 2^n) saturated.  The norms, the
router and the embedding stay as drawn.

Products: every weight product is W8A8.  Its activation is quantized per
tensor over the product's whole input as the program's schedule hands it
over: the prompts of the wave (all rows, all positions) are one input,
and each generated position (all rows) one more; a position's group is
`groups[t]`.  The int32 sums are exact (`torch._int_mm` on the card,
float64 on the CPU: |sum| < 2^28), dequantized in float32 by
2^-(x exponent + n).  With `act_bits` 4 (the control) the activations
are int4, [-8, 7], exponent floor(log2(7 / amax)).

A block is (mixer, ffn) of the configuration's `blocks`: x += mixer(
norm1(x)); x += ffn(norm2(x)).  Each kind's reference is
`references/<kind>.py`, found by name: `leaves(cfg)` names its weights
and `apply(ctx, p, h)` computes it.  A configuration with a new kind
adds that file.  RMSNorm is x / sqrt(mean(x^2) + eps) * (1 + scale).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
from pathlib import Path

import torch

from portbench import lm_data

PKG = Path(__file__).resolve().parent

EXP_MIN, EXP_MAX = -24, 24


def plain_matmuls() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kind_module(kind: str, pkg: Path | None = None):
    """`references/<kind>.py` of the package at `pkg` (default: `PKG`),
    loaded by path, once."""
    return _load(kind, PKG if pkg is None else pkg)


@functools.cache
def _load(kind: str, pkg: Path):
    spec = importlib.util.spec_from_file_location(
        f"portbench_reference_{kind}", pkg / "references" / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pow2(e):
    """2.0 ** e as float32 for integer-valued e (exact: e in [-126, 127])."""
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                       e.to(torch.int32))


def exponent(amax, top: int = 127):
    """floor(log2(top / max(amax, 1e-30))) clipped to [-24, 24], float32."""
    return torch.clamp(torch.floor(torch.log2(
        top / torch.clamp_min(amax.float(), 1e-30))), EXP_MIN, EXP_MAX)


def quantize_weight(w):
    """[..., K, N] float -> (int8 [..., N, K], int32 [..., N]): the
    per-output-channel pow2 int8 weight, stored transposed."""
    wf = w.float()
    n = exponent(wf.abs().amax(dim=-2))
    q = torch.clamp(torch.round(wf * pow2(n).unsqueeze(-2)), -128, 127)
    return q.to(torch.int8).transpose(-1, -2).contiguous(), n.to(torch.int32)


def int_mm(a, bt):
    """a [M, K] @ bt [N, K]^T of int8 values, exactly, as float64."""
    M, K = a.shape
    N = bt.shape[0]
    if a.is_cuda and M > 16 and K % 8 == 0 and N % 8 == 0:
        return torch._int_mm(a, bt.t()).to(torch.float64)
    return a.to(torch.float64) @ bt.to(torch.float64).t()


@dataclasses.dataclass
class Ctx:
    """What a kind's `apply` reads: the configuration, the rows' token
    positions, each position's activation group, and the W8A8 product."""
    cfg: dict
    B: int
    T: int
    groups: torch.Tensor          # [T] int64: the group of each position
    n_groups: int
    act_bits: int
    notes: dict

    def act_exponents(self, x, row_groups):
        """Per group, the exponent of the per-tensor activation: x [N, K]
        float32 rows, row_groups [N]; each also appended to the notes'
        `act_exponents`, in the order of the products' inputs."""
        amax = torch.zeros(self.n_groups, dtype=torch.float32,
                           device=x.device)
        amax.scatter_reduce_(0, row_groups, x.abs().amax(dim=-1), "amax")
        e = exponent(amax, 2 ** (self.act_bits - 1) - 1)
        self.notes.setdefault("act_exponents", []).append(e)
        return e

    def quantize(self, x, row_groups, e=None):
        """(int8 codes [N, K], float32 exponent of each row [N])."""
        e = self.act_exponents(x, row_groups) if e is None else e
        er = e[row_groups]
        top = 2 ** (self.act_bits - 1)
        q = torch.clamp(torch.round(x * pow2(er)[:, None]), -top, top - 1)
        return q.to(torch.int8), er

    def product(self, xq, er, wq, n):
        """float32 (xq @ wq^T) * 2^-(er + n): xq [N, K] int8, wq [Nout, K]
        int8, n [Nout]."""
        scale = pow2(-(er[:, None] + n[None, :].float())).double()
        return (int_mm(xq, wq) * scale).float()

    def dense(self, x, row_groups, w):
        """The W8A8 product of float32 x [N, K] with a quantized leaf."""
        xq, er = self.quantize(x, row_groups)
        return self.product(xq, er, *w)


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def leaves(cfg: dict, pkg: Path | None = None) -> dict:
    """{path: (shape, dtype)} of every leaf the benchmark draws, each
    block's under blocks/<pattern position>/ (one draw per cycle)."""
    D, V = cfg["d_model"], cfg["vocab_size"]
    out = {"embed/table": ((V, D), torch.bfloat16),
           "final_norm/scale": ((D,), torch.float32),
           "lm_head/w": ((D, V), torch.bfloat16)}
    for i, (mixer, ffn) in enumerate(cfg["blocks"]):
        out[f"blocks/{i}/norm1/scale"] = ((D,), torch.float32)
        for k, v in kind_module(mixer, pkg).leaves(cfg).items():
            out[f"blocks/{i}/{k}"] = v
        if ffn != "none":
            out[f"blocks/{i}/norm2/scale"] = ((D,), torch.float32)
            for k, v in kind_module(ffn, pkg).leaves(cfg).items():
                out[f"blocks/{i}/{k}"] = v
    return out


def sizes_of(cfg: dict) -> dict:
    return {"d": cfg["d_model"], "q": cfg["num_heads"] * cfg["head_dim"],
            "f": cfg["d_ff"]}


class Reference:
    """The reference model of one configuration and one seed."""

    def __init__(self, cfg: dict, seed: int, device, act_bits: int = 8,
                 pkg: Path | None = None):
        self.cfg, self.seed, self.device = cfg, int(seed), torch.device(device)
        self.act_bits, self.pkg = act_bits, pkg
        self.leaves = leaves(cfg, pkg)
        self.sizes = sizes_of(cfg)
        plain_matmuls()

    def draw(self, path: str, cycle: int = 0):
        shape, dtype = self.leaves[path]
        return lm_data.draw_leaf(self.seed, path, cycle, shape, dtype,
                                 self.sizes, self.device)

    def layer(self, i: int, cycle: int) -> dict:
        """Pattern position i's leaves of one cycle, {name: tensor}, the
        products' weights quantized: (int8 [N, K], int32 [N])."""
        pre = f"blocks/{i}/"
        out = {}
        for path in self.leaves:
            if path.startswith(pre):
                w = self.draw(path, cycle)
                name = path[len(pre):]
                out[name] = quantize_weight(w) if w.dtype == torch.bfloat16 \
                    and w.dim() >= 2 else w
        return out

    @torch.no_grad()
    def logits(self, tokens, prompt_len: int):
        """tokens [B, T] int64 (the prompts, then the served tokens but the
        last) -> (float32 logits [B, T - prompt_len + 1, V] at positions
        prompt_len - 1 ... T - 1, notes: {name: tensor}, such as the MoE's
        route margins)."""
        cfg = self.cfg
        B, T = tokens.shape
        P = prompt_len
        t = torch.arange(T, device=self.device)
        groups = torch.where(t < P, 0, t - P + 1)
        ctx = Ctx(cfg=cfg, B=B, T=T, groups=groups,
                  n_groups=T - P + 1, act_bits=self.act_bits, notes={})
        table = self.draw("embed/table").float()
        x = table[tokens.to(self.device)]                 # [B, T, D]
        del table
        eps = cfg["norm_eps"]
        blocks = cfg["blocks"]
        cycles = cfg["num_layers"] // len(blocks)
        for ci in range(cycles):
            for i, (mixer, ffn) in enumerate(blocks):
                p = self.layer(i, ci)
                h = rms_norm(x, p["norm1/scale"], eps)
                x = x + kind_module(mixer, self.pkg).apply(ctx, p, h)
                if ffn != "none":
                    h = rms_norm(x, p["norm2/scale"], eps)
                    x = x + kind_module(ffn, self.pkg).apply(ctx, p, h)
                del p, h
        out = x[:, P - 1:]                                # [B, G, D]
        G = out.shape[1]
        out = rms_norm(out, self.draw("final_norm/scale"), eps)
        head = quantize_weight(self.draw("lm_head/w"))
        # the head's input group: one per logit position, over the rows
        rows = out.reshape(B * G, -1)
        row_groups = torch.arange(G, device=self.device).repeat(B)
        ctx.n_groups = G
        y = ctx.dense(rows, row_groups, head)
        return y.view(B, G, -1), ctx.notes
