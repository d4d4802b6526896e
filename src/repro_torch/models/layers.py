"""Core layer primitives: norms, RoPE, dense projections, embeddings.

The counterpart of `repro.models.layers`.  Parameters are plain dicts of
tensors in the reference's layouts; every init function takes an
explicit `torch.Generator` (on `device`) and draws each leaf in float32,
scaled, then cast, so an init holds at most one float32 leaf at a time.
The port's draws are not the reference's (the tests carry weights across
with `repro_torch.convert.lm_params_from_reference`).

Where the reference asks `preferred_element_type=float32` of a bf16
product, the port casts the operands to float32.  A bf16 dense product
is bf16 in, bf16 out, rounded once from a float32 accumulation, as XLA
computes it: cuBLAS does so on the card with its reduced-precision bf16
reductions off (`full_bf16_sums`, which the `LM` entry points enter),
and on the CPU, whose bf16 GEMM does not round once, the product runs in
float32 and is cast.

Under a mesh whose model axis is above 1 (`dist.api.model_group`) every
weight holds this rank's share of its last axis (`dist.sharding`), and
every product is column-parallel (`col_dense`): the whole input on every
rank of the model line (`api.copy_to`), this rank's columns of W, and
the output gathered to all its columns (`api.gather_along`) unless the
caller keeps it split.  Every K-sum stays whole on one rank, so an int8
product is exact and a float one differs from the one-device product
only where the library picks another algorithm for the narrower N.  A
leaf the models use whole (a norm's scale, a bias) is gathered where it
is used (`full`).  The embedding [V, D] splits D (gathered after the
lookup), the head [D, V] the vocabulary (`lm_logits` gathers it; the
training loss runs on the split vocabulary, `transformer.lm_loss`).
With no such mesh each helper is the one-device code.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist import api
from repro_torch.dist.op_analysis import counting

DEFAULT_DTYPE = torch.bfloat16


def normal(gen, shape, scale: float, dtype=DEFAULT_DTYPE, device=None):
    """N(0, 1) * scale drawn in float32 from `gen`, cast to dtype."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with fp32 accumulation, cast back to x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def init_norm(d: int, device=None) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


@contextlib.contextmanager
def full_bf16_sums():
    """cuBLAS's reduced-precision bf16 reductions off for the duration,
    the flag restored on exit: every bf16 product on the card is then
    rounded once from a float32 sum."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


def dense(x, w, b=None):
    """Dense projection; dispatches to the W8A8 path when `w` is a
    quantized leaf {"qt","n"} (repro_torch.quant.lm_quant; a leaf of
    the reference's {"q","n"} layout raises there).  A bf16
    product on the card assumes `full_bf16_sums` is in force (the `LM`
    entry points enter it); outside it cuBLAS may round partial sums."""
    if isinstance(w, dict):
        from repro_torch.quant.lm_quant import q_dense
        y = q_dense(x, w, out_dtype=x.dtype)
    else:
        y = _matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def col_dense(x, w, n: int, b=None, keep: bool = False):
    """`dense(x, w, b)` of an n-column weight, column-parallel under a
    tensor-parallel mesh: x whole on the model line, w and b this rank's
    columns, the output gathered to its n columns (keep=True: this
    rank's columns).  With no such mesh, `dense(x, w, b)`."""
    g = api.model_group()
    if g is None:
        return dense(x, w, b)
    y = dense(api.copy_to(x, g), w, b)
    return y if keep else api.gather_along(y, n, g)


def col_matmul(x, w, n: int):
    """`torch.matmul(x, w)` of an n-column weight, column-parallel under a
    tensor-parallel mesh as `col_dense` is."""
    g = api.model_group()
    if g is None:
        return torch.matmul(x, w)
    return api.gather_along(torch.matmul(api.copy_to(x, g), w), n, g)


def full(w, n: int, partial: bool = False):
    """The whole n-long last axis of a leaf split over the model line
    (a norm's scale, a bias, a small weight used whole); `w` itself with
    no tensor-parallel mesh or n 1 (such a leaf is not split).
    `partial`: the ranks use it on different shares of the work (qk-norm
    on each rank's heads), so its gradient is summed over the line."""
    g = api.model_group()
    if g is None or n <= 1 or w.shape[-1] == n:     # whole already
        return w
    return api.gather_along(w, n, g, partial)


def cpu_detour(x) -> bool:
    """Whether a bf16 product of x runs in float32 and is cast: on the
    CPU, but not under an `op_analysis` counter, which counts the card's
    op sequence on any device."""
    return x.device.type == "cpu" and not counting()


def _matmul(x, w):
    """x @ w in the promoted dtype of the two, as jnp promotes them (a
    bf16 input against a float32 weight gives float32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if dt == torch.bfloat16 and cpu_detour(x):
        return torch.matmul(x.float(), w.float()).to(dt)
    return torch.matmul(x.to(dt), w.to(dt))


def init_dense(gen, d_in: int, d_out: int, bias: bool = False,
               dtype=DEFAULT_DTYPE, scale: float | None = None,
               device=None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions, head_dim: int, theta: float):
    """positions [...,] int -> (sin, cos) [..., head_dim/2] fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(theta, exps)      # float32, as theta ** exps
    ang = positions.float()[..., None] * inv_freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, positions, theta: float):
    """x [B, S, N, Dh], positions [B, S] (or [S]) -> rotated x (same
    dtype); split halves, not interleaved."""
    sin, cos = rope_angles(positions, x.shape[-1], theta)
    sin = sin[..., None, :]                 # broadcast over the head axis
    cos = cos[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def init_embed(gen, vocab: int, d: int, dtype=DEFAULT_DTYPE,
               device=None) -> dict:
    return {"table": normal(gen, (vocab, d), d ** -0.5, dtype, device)}


def embed_lookup(params: dict, tokens, d: int | None = None):
    """The rows of `tokens`; under a tensor-parallel mesh the table holds
    this rank's share of its d columns, gathered after the lookup."""
    table = params["table"]
    tokens = torch.as_tensor(tokens, device=table.device)
    out = torch.index_select(table, 0, tokens.reshape(-1))
    out = out.reshape(tuple(tokens.shape) + (table.shape[-1],))
    g = api.model_group()
    return out if g is None else api.gather_along(out, d, g)


def init_lm_head(gen, d: int, vocab: int, dtype=DEFAULT_DTYPE,
                 device=None) -> dict:
    return {"w": normal(gen, (d, vocab), d ** -0.5, dtype, device)}


def lm_logits(params: dict, x, vocab: int | None = None):
    """Logits of all `vocab` columns (gathered under a tensor-parallel
    mesh)."""
    return col_dense(x, params["w"], vocab)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(gen, d: int, f: int, dtype=DEFAULT_DTYPE, device=None) -> dict:
    s_in, s_out = d ** -0.5, f ** -0.5
    return {"w_gate": normal(gen, (d, f), s_in, dtype, device),
            "w_up": normal(gen, (d, f), s_in, dtype, device),
            "w_down": normal(gen, (f, d), s_out, dtype, device)}


def mlp(params: dict, x, d_ff: int | None = None):
    """SwiGLU.  Under a tensor-parallel mesh g and u stay split over the
    model line through silu(g) * u (the reference's `shard(h, ..,
    "model")`) and h is gathered once, before w_down."""
    g = api.model_group()
    if g is not None:
        x = api.copy_to(x, g)
    gt = dense(x, params["w_gate"])
    u = dense(x, params["w_up"])
    h = torch.nn.functional.silu(gt.float()).to(x.dtype) * u
    if g is None:
        return dense(h, params["w_down"])
    h = api.gather_along(h, d_ff, g)
    return col_dense(h, params["w_down"], x.shape[-1])


def silu(x):
    """x * sigmoid(x), as `jax.nn.silu` computes it (closer to its bits
    than F.silu; the recurrent mixers use it)."""
    return x * torch.sigmoid(x)


def softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(logits, labels, mask=None):
    """Mean cross entropy; logits [..., V] (fp32 accum), labels int [...]."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    labels = torch.as_tensor(labels, device=logits.device).long()
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device).float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
