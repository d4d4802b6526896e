"""The benchmark's own arithmetic for a language-model configuration: the
useful int8 operations of a wave and, product by product in the order
the serving path launches them, the least time each W8A8 product could
take.  It reads only a configuration's numbers, never the program.

Useful work is what the tokens need, never a padded capacity: an expert
product counts T x k routed assignments and reads once the weights of
the experts that got at least one of them (the roofline takes their
number from the profiled stretch's own routes; with none given, every
expert's); a dense product counts its M rows.  Bytes: the int8
activation and weights read once, the weights' int32 exponents, the
bf16 output written once.  Peaks are `yardstick.py`'s (H100 SXM, dense,
700 W).
"""
from __future__ import annotations

from portbench.yardstick import PEAK_HBM_BYTES, PEAK_INT8_OPS, union_s

OUT_BYTES = 2            # bf16


def _dense(M: int, K: int, N: int) -> tuple:
    return 2.0 * M * K * N, float(M * K + N * K + 4 * N + M * N * OUT_BYTES)


def _experts(A: int, K: int, N: int, E: int) -> tuple:
    return 2.0 * A * K * N, float(A * K + E * (N * K + 4 * N)
                                  + A * N * OUT_BYTES)


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES)


def step_products(cfg: dict, tokens: int, logit_rows: int,
                  hit=None) -> list:
    """(face, ops, bytes) of one call's W8A8 products, in launch order:
    each block's mixer then its FFN, the head last.  `tokens` rows run
    through the layers; `logit_rows` through the head.  A face is
    "dense" (`w8a8_dense`) or "bmm" (the experts' `w8a8_bmm`).  `hit`,
    an iterator, gives each MoE layer's number of experts reached, in
    order (None: all of them)."""
    D, F, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    q = cfg["num_heads"] * cfg["head_dim"]
    kv = cfg["num_kv_heads"] * cfg["head_dim"]
    E, k = cfg.get("num_experts", 0), cfg.get("experts_per_tok", 0)
    out = []
    for mixer, ffn in cfg["blocks"] * (cfg["num_layers"]
                                       // len(cfg["blocks"])):
        if mixer in ("attn", "swa"):
            out += [("dense", *_dense(tokens, D, n)) for n in (q, kv, kv)]
            out.append(("dense", *_dense(tokens, q, D)))
        else:
            raise KeyError(f"no count for mixer {mixer!r}")
        if ffn == "moe":
            A = tokens * k
            Eh = E if hit is None else next(hit)
            out += [("bmm", *_experts(A, D, F, Eh)),
                    ("bmm", *_experts(A, D, F, Eh)),
                    ("bmm", *_experts(A, F, D, Eh))]
        elif ffn == "mlp":
            out += [("dense", *_dense(tokens, D, F)),
                    ("dense", *_dense(tokens, D, F)),
                    ("dense", *_dense(tokens, F, D))]
        elif ffn != "none":
            raise KeyError(f"no count for ffn {ffn!r}")
    return out + [("dense", *_dense(logit_rows, D, V))]


def wave_products(cfg: dict, batch: int, prompt_len: int, gen: int,
                  experts_hit: list | None = None) -> list:
    """Every W8A8 product of a wave in launch order: the prefill of batch
    x prompt_len tokens (the head on the last position of each row), then
    gen - 1 decode steps of batch tokens.  `experts_hit`: the experts
    reached by each MoE call of the wave, in order (None: all)."""
    hit = None if experts_hit is None else iter(experts_hit)
    out = step_products(cfg, batch * prompt_len, batch, hit)
    for _ in range(gen - 1):
        out += step_products(cfg, batch, batch, hit)
    return out


def wave_ops(cfg: dict, batch: int, prompt_len: int, gen: int) -> float:
    """Useful int8 operations of a wave (two a multiply-accumulate)."""
    return sum(p[1] for p in wave_products(cfg, batch, prompt_len, gen))


W8A8_KERNEL = "Dequant"      # the W8A8 epilogue's name in every kernel of it


def _stretch(run):
    """The profiled stretch (a prefill and `run.profiled_steps` decode
    steps) as products: (products in launch order, each one's device time
    with its split-K reduction, each one's start, products a call), or
    None where the trace holds no stretch, a MoE stretch has no routes,
    or the trace another number of products."""
    p, S = run.profile, run.profiled_steps
    if p is None or S < 1:
        return None
    cfg = run.cell.config
    moe_calls = (S + 1) * sum(f == "moe" for _, f in cfg["blocks"]) \
        * (cfg["num_layers"] // len(cfg["blocks"]))
    hit = run.experts_hit
    if moe_calls and (hit is None or len(hit) != moe_calls):
        return None
    prods = wave_products(cfg, run.batch, run.prompt_len, S + 1, hit)
    calls = sorted((s, d, n) for n, s, d, _ in p.kernels()
                   if W8A8_KERNEL in n)
    mains = [c for c in calls if "reduce" not in c[2]]
    if len(mains) != len(prods):
        return None
    starts = [s for s, _, _ in mains] + [float("inf")]
    times, j = [], 0
    for i in range(len(prods)):
        t = 0.0
        while j < len(calls) and calls[j][0] < starts[i + 1]:
            t += calls[j][1]
            j += 1
        times.append(t)
    return prods, times, starts[:-1], len(prods) // (S + 1)


def roofline(run, face: str) -> float | None:
    """The least time of a wave's `face` products over their device time,
    in %, from the profiled stretch: its W8A8 kernels (their names hold
    W8A8_KERNEL; the split-K reduction is part of its product's time)
    taken as the stretch's products in launch order, each expert
    product's bytes those of the experts its call reached
    (`run.experts_hit`); the prefill's once, and the profiled decode
    steps' (gen - 1) / profiled_steps times, as a wave has them.  None
    where `_stretch` is."""
    st = _stretch(run)
    if st is None:
        return None
    prods, times, _, per_call = st
    scale = (run.gen - 1) / run.profiled_steps
    bound = dev = 0.0
    for i, ((f, ops, nbytes), t) in enumerate(zip(prods, times)):
        if f == face:
            w = 1.0 if i < per_call else scale
            bound += w * bound_s(ops, nbytes)
            dev += w * t
    return 100.0 * bound / dev if dev > 0 else None


def wave_busy_s(run) -> float | None:
    """A wave's device-busy seconds from the profiled stretch: the union
    of its device operations that start before the first decode step's
    first W8A8 product (the prefill, its sample, and that step's few
    operations before its first product), plus (gen - 1) /
    profiled_steps times the union of those after it.  None where
    `_stretch` is."""
    st = _stretch(run)
    if st is None:
        return None
    _, _, starts, per_call = st
    split = starts[per_call]
    ops = [(s, s + d) for _, s, d, _ in run.profile.device_ops]
    pre = union_s(o for o in ops if o[0] < split)
    post = union_s(o for o in ops if o[0] >= split)
    return pre + (run.gen - 1) / run.profiled_steps * post
