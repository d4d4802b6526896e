"""W8A8 quantization of transformer parameters — the paper's Qm.n
framework applied to LM serving; the counterpart of
`repro.quant.lm_quant`.

Weights: int8 with per-output-channel power-of-two exponents, reduced
over the contraction dim (axis -2) only.  Activations: dynamic
per-tensor power-of-two quantization at matmul entry.  A quantized
weight leaf is a dict {"qt": int8 [..., out, in], "n": int32 [..., out]}:
W stored K-major (its contraction dim last), once, at quantization, the
layout the kernels' wgmma loop reads, where the reference keeps {"q":
int8 [..., in, out], "n"} (`convert.lm_params_{from,to}_reference`
turn one into the other).  The key differs from the reference's so that
a leaf of the other layout raises (`is_qweight`) instead of giving a
transposed product: many products are square.  `models.layers.dense`
and the MoE expert products (`models.moe`) dispatch on that structure,
so the same model code runs both float and W8A8 (`launch/serve.py
--quant w8a8`).

Exponents are the reference's, floor(log2(127 / max(max_abs, 1e-30)))
clipped to [-24, 24]; every scale is an exact power of two
(`kernels.w8a8_dense.pow2`).  The reference scales by `jnp.exp2`, which
XLA's CPU backend does not compute exactly at some integer arguments of
magnitude 13 or more, so there its "power-of-two" scales can be off by
up to ~2e-6 relative.  `q_dense` runs `kernels.w8a8_dense` and
`q_einsum` its batched face `w8a8_bmm` (the CUDA kernel on the card,
its plain version on the CPU).

The activation exponent is per tensor: one amax over all of x, which on
the reference's meshes is a global reduction.  Under a mesh the models
hand every product its whole input on the model line, so the amax needs
a reduction only where the rows are split over BATCH
(`dist.api.rows_group`): there it is an all-reduce(max) over that line,
and the exponent, and every int8 bit after it, is the one-device one
whatever the mesh.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.dist import api
from repro_torch.kernels.w8a8_dense import pow2, w8a8_bmm, w8a8_dense

EINSUM_SPECS = ("gecd,edf->gecf", "gecf,efd->gecd")
QUANT_LEAF_NAMES = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "up_proj", "down_proj", "in_proj", "out_proj", "wx",
    "ffn_up", "ffn_down",
}
HEAD_LEAF_NAMES = {"w"}        # lm_head / frontend dense


def exponent(max_abs):
    """The power-of-two exponent that brings max_abs to at most 127:
    float32 floor(log2(127 / max(max_abs, 1e-30))) clipped to [-24, 24]."""
    return torch.clamp(torch.floor(torch.log2(
        127.0 / torch.clamp_min(max_abs.float(), 1e-30))), -24, 24)


OLD_LAYOUT = ("a W8A8 leaf {'q', 'n'} holds W as [..., K, N], the "
              "reference's layout; the port stores it K-major, {'qt': "
              "[..., N, K], 'n'}: quantize with quantize_lm_params, or "
              "carry a reference tree across with "
              "convert.lm_params_from_reference")


def _quantize_2d(w):
    """[K, N] -> (int8 [K, N], int32 [N]); one float32 copy of w is
    scaled, rounded and clamped in place."""
    wf = w.to(torch.float32, copy=True)
    n = exponent(wf.abs().amax(dim=-2)).to(torch.int32)
    wf.mul_(pow2(n)[None, :]).round_().clamp_(-128, 127)
    return wf.to(torch.int8), n


def _quantize_weight(w) -> dict:
    """[..., K, N] -> {"qt" int8 [..., N, K], "n" int32 [..., N]}:
    per-output-channel power-of-two exponents over the contraction dim,
    so stacked-cycle leading dims are kept; quantized one [K, N] slice at
    a time and written transposed, so a stacked leaf never has a float32
    copy nor a second int8 one."""
    K, N = w.shape[-2:]
    qt = torch.empty(w.shape[:-2] + (N, K), dtype=torch.int8,
                     device=w.device)
    n = torch.empty(w.shape[:-2] + (N,), dtype=torch.int32, device=w.device)
    if w.device.type == "meta":          # a struct: no values to compute
        return {"qt": qt, "n": n}
    for idx in itertools.product(*map(range, w.shape[:-2])):
        q, n[idx] = _quantize_2d(w[idx])
        qt[idx] = q.t()
    return {"qt": qt, "n": n}


def _quantize_tree(tree, names: tuple, quantize_head: bool,
                   consume: bool):
    """The W8A8 form of `tree`, found at `names` in a param tree: a leaf
    named in QUANT_LEAF_NAMES of two or more axes, and the lm_head's w
    (if `quantize_head`), become {"qt", "n"}; the others stay as they
    are."""
    if isinstance(tree, dict):
        out = tree if consume else {}
        for k in list(tree):
            out[k] = _quantize_tree(tree[k], names + (str(k),),
                                    quantize_head, consume)
        return out
    if isinstance(tree, (tuple, list)):
        return tuple(_quantize_tree(v, names + (str(i),), quantize_head,
                                    consume)
                     for i, v in enumerate(tree))
    name = names[-1]
    if name in QUANT_LEAF_NAMES and tree.dim() >= 2:
        return _quantize_weight(tree)
    if quantize_head and name in HEAD_LEAF_NAMES and "lm_head" in names:
        return _quantize_weight(tree)
    return tree


def quantize_lm_params(params, quantize_head: bool = True,
                       consume: bool = False):
    """Transform a float param tree into the W8A8 tree (norms,
    embeddings, biases and small vectors stay float).  With consume=True
    each float leaf is dropped from its dict as soon as its int8 leaf
    exists, so the float tree is freed as it goes (given no other
    reference to it); the tuples of the tree are rebuilt."""
    return _quantize_tree(params, (), quantize_head, consume)


def init_quantized(model, gen, device=None, mesh=None):
    """`quantize_lm_params(model.init(gen, device, mesh))` bit for bit,
    without the float tree: each top-level part (embed, lm_head,
    frontend) is quantized as soon as it is drawn, and each block right
    after `model.init` draws it (and, under `mesh`, cuts this rank's
    share), before it is copied into the int8 leaves stacked over the
    cycles.  The generator is drawn in the same order, and a weight's
    exponents are per output column over K, so quantizing a cycle and
    stacking equals stacking and quantizing (no leaf that
    QUANT_LEAF_NAMES names has fewer than two axes within a cycle; the
    CPU tests hold every config to it).  The device holds at most the
    int8 tree so far, one block's float leaves, one leaf's float32 draw
    and the temporaries of quantizing one [K, N] slice."""
    def post(name: str, tree):
        return _quantize_tree(tree, (name,), True, consume=True)
    return model.init(gen, device, mesh, post=post)


def is_qweight(w) -> bool:
    """Whether `w` is a W8A8 leaf {"qt", "n"}; a dict of the reference's
    layout {"q", "n"} raises ValueError (its product would come out
    transposed, or not at all)."""
    if isinstance(w, dict) and "q" in w:
        raise ValueError(OLD_LAYOUT)
    return isinstance(w, dict) and set(w) >= {"qt", "n"}


def _check_leaf(w) -> None:
    if not is_qweight(w):
        raise ValueError(f"not a W8A8 leaf {{'qt', 'n'}}: keys "
                         f"{sorted(w) if isinstance(w, dict) else type(w)}")


def quantize_activation(x):
    """Dynamic per-tensor pow2 activation quantization -> (int8,
    exponent as a float32 0-d tensor on x's device); the amax is taken
    over every rank's rows where they are split (`api.rows_group`)."""
    xf = x.float()
    e = exponent(api.reduce_max(xf.abs().amax(), api.rows_group()))
    q = torch.clamp(torch.round(xf * pow2(e)), -128, 127).to(torch.int8)
    return q, e


def _n_share(w: dict, N: int):
    """The exponents of qt's N rows: under a tensor-parallel mesh a leaf
    of one [N] exponent vector keeps it whole (`param_specs` replicates
    a vector) while qt holds this rank's rows, whose share is taken."""
    n = w["n"]
    if n.shape[-1] == N:
        return n
    lo, hi = api.share(n.shape[-1], api.model_group())
    return n.narrow(-1, lo, hi - lo)


def q_dense(x, w: dict, out_dtype=torch.bfloat16):
    """W8A8 dense: x [..., K] float, w {"qt" [N, K], "n" [N]} ->
    out_dtype [..., N] = out(float32(q(x) @ qt^T) * 2^-(xe + n))."""
    _check_leaf(w)
    xq, xe = quantize_activation(x)
    N, K = w["qt"].shape
    y = w8a8_dense(xq.reshape(-1, K), w["qt"], xe, _n_share(w, N),
                   out_dtype)
    return y.reshape(x.shape[:-1] + (N,))


def q_einsum(spec: str, x, w: dict, out_dtype=torch.bfloat16):
    """Quantized einsum of the MoE expert products (`EINSUM_SPECS`):
    x [G, E, C, K] float, w {"qt" [E, N, K], "n" [E, N]} -> out_dtype
    [G, E, C, N] = out(float32(q(x)[g, e] @ qt[e]^T) * 2^-(xe + n[e])).
    The activation is quantized per tensor over the whole buffer, its
    empty slots' zeros included, as the reference does; the products
    run as one [E, G*C, K] x [E, N, K] `w8a8_bmm` (one copy of the int8
    activation into expert-major order), and the output is a view of
    [E, G, C, N] in the reference's order."""
    if spec not in EINSUM_SPECS:
        raise ValueError(f"q_einsum computes {EINSUM_SPECS}, not {spec!r}")
    _check_leaf(w)
    xq, xe = quantize_activation(x)
    G, E, C, K = xq.shape
    xq = xq.permute(1, 0, 2, 3).contiguous().view(E, G * C, K)
    y = w8a8_bmm(xq, w["qt"], xe, w["n"], out_dtype)
    return y.view(E, G, C, -1).permute(1, 0, 2, 3)


def quantized_bytes(qparams) -> int:
    def walk(tree):
        if isinstance(tree, dict):
            return sum(walk(v) for v in tree.values())
        if isinstance(tree, (tuple, list)):
            return sum(walk(v) for v in tree)
        return tree.numel() * tree.element_size()
    return int(walk(qparams))
