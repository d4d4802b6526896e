"""The port's MoE FFN (`repro_torch.models.moe`), `lm_quant.q_einsum` and
the batched `w8a8_bmm`'s plain version against `repro` on the CPU.

Weights are the reference's own `init_moe`, carried across with
`convert.lm_params_from_reference`; inputs come from NumPy seeds.  The
MoE inputs are normal(0, 1) tokens plus one normal(0, 1) direction
shared by every token of the call, as hidden states share a mean: the
router then favours some experts, and at B 2 x S 16 one expert of a row
takes 14 assignments against its capacity of 12, so the drop path runs
(asserted below).

Routing decisions are compared exactly: the top-k experts (`eidx`),
each assignment's slot and whether it was kept.  The reference's slots
are read off its own run, from the arguments of its scatter's
`jax.vmap`, and its top k from its `lax.top_k` call.  Gates and the
aux loss within 1e-6 (float32 router products and softmaxes summed in
other orders: measured 2.4e-7).  y within one bf16 ulp of |y| (the
bound), measured bit-equal at every element on both configs and both
modes: the bf16 expert products and the combine over k run in float32
and are cast once, as XLA's CPU dot rounds them.

`q_einsum` holds the reference's int32 accumulators and, with the
reference's inexact XLA exp2 made exact (as tests/test_torch_lm_quant.py
does), its outputs bit for bit on both specs.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.base import get_config as rget
from repro.launch.train import reduced
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.quant import lm_quant as RQ
from repro_torch.configs.base import get_config as tget
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import w8a8_dense as kd
from repro_torch.launch.train import reduced as treduced
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.quant import int8_ops as q
from repro_torch.quant import lm_quant as TQ

ARCHS = ["phi35_moe", "mixtral_8x22b"]
GATE_TOL = 1e-6


def exact_exp2(x):
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def to_port(tree):
    return lm_params_from_reference(jax.tree.map(np.asarray, tree), "cpu")


def bf16_ulp(a):
    """One bf16 ulp of |a| (float32 array), elementwise."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def moe_setup(arch):
    cfg = reduced(rget(arch), d_model=64)
    rp = RM.init_moe(jax.random.key(1), cfg)
    return cfg, rp, to_port(rp)


def tokens(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, D)) + rng.normal(0, 1, D)
    xr = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    return xr, to_port(xr)


def ref_moe_apply(rp, xr, cfg, is_decode):
    """The reference's moe_apply, run op by op, with its top k and its
    scatter's slots read off the run."""
    seen = {}
    top_k, vmap = jax.lax.top_k, jax.vmap

    def spy_top_k(p, k):
        seen["top_k"] = top_k(p, k)
        return seen["top_k"]

    def spy_vmap(f):
        g = vmap(f)

        def call(*args):
            seen.setdefault("slot", np.asarray(args[1]))
            return g(*args)
        return call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", spy_top_k)
        mp.setattr(jax, "vmap", spy_vmap)
        y, aux = RM.moe_apply(rp, xr, cfg, is_decode=is_decode)
    gates, eidx = (np.asarray(a) for a in seen["top_k"])
    gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    return y, aux, gates, eidx, seen["slot"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [1, 8, 16, 64, 65])
def test_capacity_equals_the_references(arch, T):
    for cfg_r, cfg_t in ((rget(arch), tget(arch)),
                         (reduced(rget(arch), d_model=64),
                          treduced(tget(arch), d_model=64))):
        assert TM.capacity(T, cfg_t) == RM.capacity(T, cfg_r)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_moe_apply_matches_the_reference(arch, mode):
    cfg, rp, tp = moe_setup(arch)
    B, S = (2, 16) if mode == "prefill" else (2, 1)
    decode = mode == "decode"
    xr, xt = tokens(B, S, cfg.d_model)
    y_r, aux_r, gates_r, eidx_r, slot_r = ref_moe_apply(rp, xr, cfg, decode)
    y_t, aux_t = TM.moe_apply(tp, xt, cfg, is_decode=decode)
    r = TM.route(tp, xt.reshape(1, B * S, -1) if decode else xt, cfg)

    assert np.array_equal(r.eidx.numpy(), eidx_r)
    assert np.array_equal(r.slot.numpy(), slot_r)
    E, C = cfg.num_experts, TM.capacity(r.eidx.shape[1], cfg)
    assert np.array_equal(r.keep.numpy(), slot_r < E * C)
    if mode == "prefill":          # the drop path runs
        assert int((~r.keep).sum()) >= 1
    assert np.abs(r.gates.numpy() - gates_r).max() <= GATE_TOL
    assert abs(float(aux_t) - float(aux_r)) <= GATE_TOL
    assert aux_t.dtype == torch.float32 and y_t.dtype == torch.bfloat16

    a = np.asarray(y_r.astype(jnp.float32))
    assert y_t.shape == a.shape
    assert np.all(np.abs(y_t.float().numpy() - a) <= bf16_ulp(a))


def test_a_dropped_assignment_adds_nothing():
    """A token whose every assignment is dropped gets y = 0; its kept
    neighbours do not."""
    cfg, _, tp = moe_setup("phi35_moe")
    xr, xt = tokens(2, 16, cfg.d_model)
    y, _ = TM.moe_apply(tp, xt, cfg)
    keep = TM.route(tp, xt, cfg).keep.reshape(2, 16, cfg.experts_per_tok)
    none = ~keep.any(-1)
    assert bool((y[none] == 0).all())
    assert bool((y[keep.all(-1)].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_router_ties_take_the_lower_expert_as_the_reference(mode):
    """Router columns 1 and 3 bit-equal (and the largest), then 0 and 2
    bit-equal: every token has two pairs of bit-equal probabilities, and
    the port picks the lower expert first, as lax.top_k does."""
    cfg, rp, _ = moe_setup("phi35_moe")
    w = np.array(rp["router"])
    w[:, 3] = w[:, 1]
    w[:, 2] = w[:, 0]
    rp = dict(rp, router=jnp.asarray(w))
    tp = to_port(rp)
    B, S = (2, 16) if mode == "prefill" else (4, 1)
    decode = mode == "decode"
    xr, xt = tokens(B, S, cfg.d_model, seed=3)
    _, _, gates_r, eidx_r, slot_r = ref_moe_apply(rp, xr, cfg, decode)
    r = TM.route(tp, xt.reshape(1, B * S, -1) if decode else xt, cfg)
    probs = torch.softmax(torch.matmul(
        (xt.reshape(1, B * S, -1) if decode else xt).float(),
        tp["router"]), -1)
    assert torch.equal(probs[..., 1], probs[..., 3])
    assert torch.equal(probs[..., 0], probs[..., 2])
    assert np.array_equal(r.eidx.numpy(), eidx_r)
    assert np.array_equal(r.slot.numpy(), slot_r)
    assert np.array_equal(np.sort(eidx_r, -1), eidx_r)   # lower first
    assert np.abs(r.gates.numpy() - gates_r).max() <= GATE_TOL


def q_operands(spec, seed):
    """A [G, E, C, K] activation with empty (zero) slots, and a W8A8
    expert leaf of the reference's quantizer."""
    rng = np.random.default_rng(seed)
    G, E, C, K, N = 2, 3, 4, 40, 24
    x = rng.normal(0, 2, (G, E, C, K)).astype(np.float32)
    x[:, :, 3] = 0.0                                   # empty slots
    w = rng.normal(0, 0.05, (E, K, N)).astype(np.float32)
    w[1] *= 40                       # experts of other exponents
    xr = jnp.asarray(x, jnp.bfloat16)
    qw = RQ._quantize_weight(jnp.asarray(w, jnp.bfloat16))
    return xr, qw


@pytest.mark.parametrize("spec", TQ.EINSUM_SPECS)
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_q_einsum_matches_the_reference(spec, out):
    xr, qw = q_operands(spec, len(spec) + len(out))
    xq_r, xe_r = RQ.quantize_activation(xr)
    acc_r = np.asarray(jnp.einsum(spec, xq_r, qw["q"],
                                  preferred_element_type=jnp.int32))
    xq_t, xe_t = TQ.quantize_activation(to_port(xr))
    assert np.array_equal(xq_t.numpy(), np.asarray(xq_r))
    assert float(xe_t) == float(xe_r)
    acc_t = q.einsum_i32(spec, xq_t, to_port(qw["q"]))
    assert np.array_equal(acc_t.numpy(), acc_r)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RQ.jnp, "exp2", exact_exp2)
        want = np.asarray(RQ.q_einsum(spec, xr, qw,
                                      out_dtype=getattr(jnp, out)),
                          np.float32)
    got = TQ.q_einsum(spec, to_port(xr), to_port(qw),
                      out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == want.shape
    assert np.array_equal(got.float().numpy(), want)


def test_q_einsum_refuses_another_spec():
    xr, qw = q_operands("", 0)
    with pytest.raises(ValueError, match="q_einsum computes"):
        TQ.q_einsum("gecd,efd->gecf", to_port(xr), to_port(qw))


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=str)
def test_batched_plain_is_a_loop_of_the_2d_plain(out):
    """w8a8_bmm's plain version (and ops.w8a8_bmm on the CPU) equals the
    2-D plain version run expert by expert, each with its own n, on W
    stored K-major ([E, N, K])."""
    rng = np.random.default_rng(4)
    E, M, K, N = 3, 7, 100, 33
    xq = torch.from_numpy(rng.integers(-128, 128, (E, M, K)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-128, 128, (E, N, K)).astype(np.int8))
    n = torch.from_numpy(rng.integers(-24, 25, (E, N)).astype(np.int32))
    xe = torch.tensor(-3.0)
    want = torch.stack([kd.w8a8_dense_plain(xq[e], wt[e], xe, n[e], out)
                        for e in range(E)])
    for fn in (kd.w8a8_dense_plain, ops.w8a8_bmm):
        got = fn(xq, wt, xe, n, out)
        assert got.dtype == out and torch.equal(got, want)
    # each expert's exponents matter: expert 0's n everywhere differs
    wrong = kd.w8a8_dense_plain(xq, wt, xe, n[:1].expand(E, N), out)
    assert not torch.equal(wrong, want)


def test_w8a8_bmm_refuses_what_it_does_not_take():
    """A meta tensor gets the output's struct (the dry run's face), but
    only of operands the kernel takes: W here is not K-major [..., N, K]
    of K = 8; a device that is neither the CPU, the card nor meta
    raises."""
    meta = torch.empty((2, 4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="are not"):
        kd.w8a8_bmm(meta, meta.transpose(1, 2).contiguous(),
                    torch.tensor(0.0), torch.zeros((2, 4), dtype=torch.int32))
    other = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(NotImplementedError, match="xla"):
        kd.w8a8_bmm(other, meta.transpose(1, 2).contiguous(),
                    torch.tensor(0.0), torch.zeros((2, 4), dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_cross_the_converter_both_ways(arch):
    """The float32 router, bf16 [C, E, d, f] experts and the W8A8
    {"q", "n"} experts (n [C, E, N]) come across leaf for leaf, and
    `quantize_lm_params` quantizes the expert leaves as the reference,
    its qt [C, E, N, K] the reference's q [C, E, K, N] transposed."""
    from repro_torch.convert import lm_params_to_reference
    cfg = reduced(rget(arch), d_model=64)
    rp = RT.build_model(cfg).init(jax.random.key(0))
    rq = RQ.quantize_lm_params(rp)
    tp = to_port(rp)
    moe_r, moe_t = rp["blocks"][0]["moe"], tp["blocks"][0]["moe"]
    C, E, d, f = cfg.num_cycles, cfg.num_experts, cfg.d_model, cfg.d_ff
    assert moe_t["router"].dtype == torch.float32
    assert tuple(moe_t["router"].shape) == (C, d, E)
    assert moe_t["w_gate"].dtype == torch.bfloat16
    assert tuple(moe_t["w_gate"].shape) == (C, E, d, f)
    assert tuple(moe_t["w_down"].shape) == (C, E, f, d)
    for k, v in moe_r.items():
        back = lm_params_to_reference(moe_t[k])
        assert np.array_equal(back, np.asarray(v, np.float32))
    tq = TQ.quantize_lm_params(tp)["blocks"][0]["moe"]
    for k in ("w_gate", "w_up", "w_down"):
        assert tuple(tq[k]["n"].shape) == (C, E, moe_t[k].shape[-1])
        want = rq["blocks"][0]["moe"][k]
        assert np.array_equal(tq[k]["qt"].swapaxes(-1, -2).numpy(),
                              np.asarray(want["q"]))
        assert np.array_equal(tq[k]["n"].numpy(), np.asarray(want["n"]))
    assert tq["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_adds_the_router_aux_loss_as_the_reference(arch):
    """`LM.train_loss` is the cross entropy plus router_aux_coef x the
    summed aux losses, and equals the reference's: loss within 2e-3 and
    aux within 1e-2 (the reference scans its blocks under one XLA
    compilation, whose fused bf16 code rounds otherwise than its op-by-op
    blocks; measured 2.7e-4 / 4.5e-4 and 2.2e-5 / 2.1e-3)."""
    import dataclasses
    cfg = reduced(rget(arch), d_model=64)
    rp = RT.build_model(cfg).init(jax.random.key(0))
    tp = to_port(rp)
    toks = np.random.default_rng(7).integers(
        1, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :16], "targets": toks[:, 1:]}
    loss_r, m_r = RT.build_model(cfg).train_loss(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t, m_t = TT.build_model(cfg).train_loss(tp, tb)
    assert abs(float(loss_t) - float(loss_r)) <= 2e-3
    assert abs(float(m_t["aux"]) - float(m_r["aux"])) <= 1e-2
    assert float(m_t["aux"]) > 0
    ce, _ = TT.build_model(dataclasses.replace(
        cfg, router_aux_coef=0.0)).train_loss(tp, tb)
    assert abs(float(loss_t - ce) - cfg.router_aux_coef
               * float(m_t["aux"])) <= 1e-6
