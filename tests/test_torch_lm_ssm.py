"""The port's recurrent mixers and the SSM/hybrid LMs against the
reference `repro` on the CPU: `models.scan_utils`, `models.mamba`,
`models.xlstm` (mLSTM, sLSTM) and the `LM` of `jamba_v01_52b` (mamba,
one attention layer in 8, MoE every other layer) and `xlstm_1_3b` (7
mLSTM blocks to 1 sLSTM block), reduced to d_model 64 (one 8-layer
cycle each, 4 heads; jamba 4 experts top-2).

Weights: the reference's own init, carried across with
`convert.lm_params_from_reference`; inputs from NumPy seeds.

Tolerances, as `tests/test_torch_lm_layers.py` and
`tests/test_torch_lm_serve.py` hold the same faces:
- float32 states (mamba's SSM state, mLSTM's C/n/m, sLSTM's c/n/m/h):
  rtol 1e-5 and atol 1e-5 (the two packages' exp, cumsum and products
  round differently; measured at most 1.5e-6 absolute);
- bf16 activations: one bf16 ulp (rtol 2**-7), each mixer's output and
  the input of each of its projections (`close_mixer_output`: measured
  equal except 2 elements of the mLSTM's closed form, one ulp off at
  the output projection's input);
- LM logits: FLOAT_ATOL 0.1 (logits of magnitude ~4); decode after
  prefill(S) against prefill(S+1): atol 0.15 + rtol 0.05, argmax equal;
- W8A8: block by block in lockstep, the port's block on the reference's
  block input, with XLA's inexact CPU exp2 made exact on the reference's
  side: W8A8_ATOL = 0 on every block output and the logits (measured 0
  on every block of both archs), and the port's float tree put in place
  of the W8A8 one fails that bound on every block.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.base import get_config as rget
from repro.launch.train import reduced
from repro.models import layers as RL
from repro.models import mamba as RMB
from repro.models import scan_utils as RS
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.quant import lm_quant as RQ
from repro_torch.configs.base import get_config as tget
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import reduced as treduced
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import scan_utils as TS
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.quant import lm_quant as TQ

ARCHS = ["jamba_v01_52b", "xlstm_1_3b"]
B, S, STEPS = 2, 16, 4
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL = 2.0 ** -7
FLOAT_ATOL = 0.1
W8A8_ATOL = 0.0
CONSIST = dict(atol=0.15, rtol=0.05)


def exact_exp2(x):
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def to_port(tree):
    return lm_params_from_reference(jax.tree.map(np.asarray, tree), "cpu")


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def maxdiff(r, t) -> float:
    return float(np.abs(f32(r) - f32(t)).max())


def bf16(a):
    """NumPy float -> (reference bf16 array, port bf16 tensor), equal."""
    r = jnp.asarray(a, jnp.bfloat16)
    return r, torch.from_numpy(np.array(r.astype(jnp.float32))).bfloat16()


def close_bf16(want, got):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_RTOL, atol=0)


def close_states(want: dict, got: dict):
    assert set(want) == set(got)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == {"float32": torch.float32,
                                "bfloat16": torch.bfloat16}[
                                    str(want[k].dtype)], k
        np.testing.assert_allclose(f32(got[k]), f32(want[k]), **F32_TOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# scan_utils
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,target", [(64, 64), (65, 64), (65, 256),
                                      (16, 256), (96, 64), (1, 64),
                                      (97, 8), (12, 5)])
def test_pick_chunk_equals_the_reference(S, target):
    assert TS.pick_chunk(S, target) == RS.pick_chunk(S, target)


@pytest.mark.parametrize("S,chunk", [(8, 8), (12, 4), (5, 8)])
def test_chunked_scan_equals_the_reference(S, chunk):
    """A float32 recurrence with a tuple carry, a tuple of inputs and a
    tuple of outputs per step: rtol/atol 1e-5."""
    rng = np.random.default_rng(S + chunk)
    a = rng.normal(0, 1, (S, 3, 4)).astype(np.float32)
    b = rng.normal(0, 1, (S, 3)).astype(np.float32)
    h0 = rng.normal(0, 1, (3, 4)).astype(np.float32)

    def body(lib):
        def f(carry, xs):
            h, s = carry
            at, bt = xs
            h = lib.tanh(h * 0.9 + at) + bt[:, None]
            s = s + h.sum(-1)
            return (h, s), (h * 2, s)
        return f
    (rh, rs), (ry1, ry2) = RS.chunked_scan(
        body(jnp), (jnp.asarray(h0), jnp.zeros(3)),
        (jnp.asarray(a), jnp.asarray(b)), chunk=chunk)
    (th, ts), (ty1, ty2) = TS.chunked_scan(
        body(torch), (torch.from_numpy(h0), torch.zeros(3)),
        (torch.from_numpy(a), torch.from_numpy(b)), chunk=chunk)
    for r, t in ((rh, th), (rs, ts), (ry1, ty1), (ry2, ty2)):
        assert tuple(t.shape) == r.shape
        np.testing.assert_allclose(f32(t), f32(r), **F32_TOL)


def test_chunked_scan_refuses_a_chunk_that_does_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        TS.chunked_scan(lambda c, x: (c, x), torch.zeros(()),
                        torch.zeros(10), chunk=4)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------
def mixer_cfg(name, **edit):
    arch = "jamba_v01_52b" if name == "mamba" else "xlstm_1_3b"
    return dataclasses.replace(reduced(rget(arch), d_model=64), **edit)


MIXERS = {
    "mamba": (RMB.init_mamba, RMB.mamba_apply,
              lambda cfg: RMB.init_mamba_cache(cfg, B), TMB.mamba_apply),
    "mlstm": (RX.init_mlstm, RX.mlstm_apply,
              lambda cfg: RX.init_mlstm_cache(cfg, B), TX.mlstm_apply),
    "slstm": (RX.init_slstm, RX.slstm_apply,
              lambda cfg: RX.init_slstm_cache(cfg, B), TX.slstm_apply),
}
MIXER_CASES = [("mamba", {}, 16), ("mamba", {}, 65), ("mlstm", {}, 16),
               ("mlstm", dict(xlstm_chunk=8), 32),
               ("mlstm", dict(xlstm_impl="recurrent"), 16),
               ("slstm", {}, 16)]
MIXER_IDS = ["mamba", "mamba-S65", "mlstm", "mlstm-chunk8-S32",
             "mlstm-recurrent", "slstm"]


def mixer_setup(name, edit, seq):
    cfg = mixer_cfg(name, **edit)
    rinit, rapply, rcache, tapply = MIXERS[name]
    rp = rinit(jax.random.key(len(name)), cfg)
    rng = np.random.default_rng(seq)
    xr, xt = bf16(rng.normal(0, 1, (B, seq + 1, cfg.d_model)))
    return cfg, rp, to_port(rp), rapply, rcache, tapply, xr, xt


@contextlib.contextmanager
def dense_inputs(monkeypatch):
    """Record (x, w) of every projection either package's mixers make
    (`layers.dense`), in call order: {"r": [...], "t": [...]}."""
    seen = {"r": [], "t": []}
    for side, mod in (("r", RL), ("t", TL)):
        def spy(x, w, b=None, _orig=mod.dense, _side=side):
            seen[_side].append((x, w))
            return _orig(x, w, b)
        monkeypatch.setattr(mod, "dense", spy)
    yield seen
    monkeypatch.undo()


def close_mixer_output(seen, yr, yt):
    """Every projection's input within one bf16 ulp of the reference's;
    the output within one ulp of the reference's output projection
    applied to the port's own input, and of the reference's output where
    that input is the reference's bit for bit.  (The float32 recurrences
    round differently, so a bf16 input of the output projection may lie
    one ulp apart; measured on 2 of 4,096 elements of the mLSTM's closed
    form at S = 16, none elsewhere.)"""
    assert len(seen["r"]) == len(seen["t"])
    for (xr, _), (xt, _) in zip(seen["r"], seen["t"]):
        close_bf16(xr, xt)
    (xr, w), (xt, _) = seen["r"][-1], seen["t"][-1]
    close_bf16(RL.dense(jnp.asarray(f32(xt), jnp.bfloat16), w), yt)
    if np.array_equal(f32(xr), f32(xt)):
        close_bf16(yr, yt)


@pytest.mark.parametrize("name,edit,seq", MIXER_CASES, ids=MIXER_IDS)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mixer_matches_the_reference(name, edit, seq, mode, monkeypatch):
    """Output and projection inputs within one bf16 ulp
    (`close_mixer_output`) and, at prefill and decode, the new state
    (float32, rtol/atol 1e-5).  Decode runs one step on the state the
    reference's prefill left, carried across; the port's new state lands
    in the cache buffers it was given.  S = 32 at xlstm_chunk 8 carries
    the closed form's state across four chunks; S = 65 takes mamba's scan
    in chunks of 13."""
    cfg, rp, tp, rapply, rcache, tapply, xr, xt = mixer_setup(name, edit,
                                                              seq)
    if mode == "train":
        with dense_inputs(monkeypatch) as seen:
            yr, rc = rapply(rp, xr[:, :seq], cfg, mode="train")
            yt, tc = tapply(tp, xt[:, :seq], cfg, mode="train")
        assert rc is None and tc is None
        close_mixer_output(seen, yr, yt)
        return
    rc = rcache(cfg)
    if mode == "decode":
        _, rc = rapply(rp, xr[:, :seq], cfg, mode="prefill", cache=rc)
        tc_in = to_port(rc)
        xr, xt = xr[:, seq:], xt[:, seq:]
    else:
        tc_in = to_port(rc)
        xr, xt = xr[:, :seq], xt[:, :seq]
    with dense_inputs(monkeypatch) as seen:
        yr, rc = rapply(rp, xr, cfg, mode=mode, cache=rc)
        yt, tc = tapply(tp, xt, cfg, mode=mode, cache=tc_in)
    assert tc is tc_in
    assert all(tc[k].data_ptr() == tc_in[k].data_ptr() for k in tc)
    close_mixer_output(seen, yr, yt)
    close_states(rc, tc)


@pytest.mark.parametrize("name,edit,seq", MIXER_CASES[:1] + MIXER_CASES[2:],
                         ids=MIXER_IDS[:1] + MIXER_IDS[2:])
def test_mixer_decode_after_prefill_equals_a_longer_prefill(name, edit,
                                                            seq):
    """prefill(x[:S]) then decode(x[S]) against prefill(x[:S+1]): the last
    output within one bf16 ulp, the states within rtol/atol 1e-5 (the
    mLSTM's prefill takes the closed form, its decode the recurrence)."""
    cfg, _, tp, _, _, tapply, _, xt = mixer_setup(name, edit, seq)
    cache = {"mamba": TMB.init_mamba_cache,
             "mlstm": TX.init_mlstm_cache,
             "slstm": TX.init_slstm_cache}[name]
    y_full, c_full = tapply(tp, xt, cfg, mode="prefill",
                            cache=cache(cfg, B, device="cpu"))
    _, c = tapply(tp, xt[:, :seq], cfg, mode="prefill",
                  cache=cache(cfg, B, device="cpu"))
    y_dec, c = tapply(tp, xt[:, seq:], cfg, mode="decode", cache=c)
    close_bf16(y_full[:, -1:], y_dec)
    for k in c:
        np.testing.assert_allclose(f32(c[k]), f32(c_full[k]), **F32_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["recurrent", "chunked"])
def test_mlstm_train_gradients_match_the_reference(impl):
    """Backward through the mLSTM at train (no cache), float32 params and
    input: the gradients of sum(y * g) by the input and by every param
    against `jax.grad` of the reference's, rtol/atol 1e-5 relative to
    each gradient's largest element.  The recurrent impl's train steps
    build a new C each step, so autograd can take them back."""
    cfg = mixer_cfg("mlstm", xlstm_impl=impl)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      RX.init_mlstm(jax.random.key(5), cfg))
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    g = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)

    def ref_loss(p, x):
        y, _ = RX.mlstm_apply(p, x, cfg, mode="train")
        return (y * g).sum()
    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in rp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    yt, _ = TX.mlstm_apply(tp, xt, cfg, mode="train")
    (yt * torch.from_numpy(g)).sum().backward()
    for name, want, got in [("x", want_x, xt.grad)] + [
            (k, want_p[k], tp[k].grad) for k in rp]:
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(f32(got) / scale, want / scale,
                                   **F32_TOL, err_msg=name)


def test_slstm_ffn_width_and_gelu_are_the_references():
    """The 4/3 FFN rounds up to a multiple of 128 (2816 at d 2048), and
    its GELU is the tanh approximation `jax.nn.gelu` defaults to."""
    full = rget("xlstm_1_3b")
    want = jax.eval_shape(lambda k: RX.init_slstm(k, full),
                          jax.random.key(0))
    got = TX.init_slstm(torch.Generator(), full, "meta")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["ffn_down"].shape[0] == 2816
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    np.testing.assert_allclose(
        f32(torch.nn.functional.gelu(torch.from_numpy(x),
                                     approximate="tanh")),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_mixer_params_and_caches_match_the_reference_layout(name):
    """init and init_cache: the reference's leaves, shapes and dtypes
    (mamba's dt_bias, A_log and D float32; its conv window in the
    activations' dtype; every recurrent state float32, m at -1e30 and
    sLSTM's n at 1e-6), at full width."""
    cfg = rget("jamba_v01_52b" if name == "mamba" else "xlstm_1_3b")
    rinit = MIXERS[name][0]
    want = jax.eval_shape(lambda k: rinit(k, cfg), jax.random.key(0))
    tinit = {"mamba": TMB.init_mamba, "mlstm": TX.init_mlstm,
             "slstm": TX.init_slstm}[name]
    got = tinit(torch.Generator(), cfg, "meta")
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert {k: (tuple(v.shape), dt[v.dtype]) for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    small = mixer_cfg(name)
    rc = MIXERS[name][2](small)
    tc = {"mamba": TMB.init_mamba_cache, "mlstm": TX.init_mlstm_cache,
          "slstm": TX.init_slstm_cache}[name](small, B, device="cpu")
    assert {k: (tuple(v.shape), dt[v.dtype]) for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in rc.items()}
    for k in rc:
        assert np.array_equal(f32(tc[k]), f32(rc[k])), k


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setups():
    """Per arch: config, the reference's float and W8A8 params, tokens."""
    out = {}
    for arch in ARCHS:
        cfg = reduced(rget(arch), d_model=64)
        rp = RT.build_model(cfg).init(jax.random.key(0))
        toks = np.random.default_rng(len(arch)).integers(
            1, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
        out[arch] = dict(cfg=cfg, rp=rp, rq=RQ.quantize_lm_params(rp),
                         toks=toks, alloc=RT.decode_alloc(S + STEPS))
    return out


def test_the_configs_build_and_have_the_expected_blocks():
    for arch in ARCHS:
        cfg = tget(arch)
        assert isinstance(TT.build_model(cfg), TT.LM)
    assert [m for m, _ in tget("jamba_v01_52b").blocks].count("mamba") == 7
    assert [m for m, _ in tget("xlstm_1_3b").blocks] == \
        ["mlstm"] * 3 + ["slstm"] + ["mlstm"] * 4


def test_unknown_block_kinds_raise():
    cfg = treduced(tget("jamba_v01_52b"), d_model=64)
    for blocks in ((("rwkv", "mlp"),), (("mamba", "glu"),)):
        bad = dataclasses.replace(cfg, blocks=blocks, num_layers=1)
        with pytest.raises(ValueError, match="unknown"):
            TT.build_model(bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_the_reference_layout(arch):
    """Each block holds only its own mixer's leaves (no "attn" in a
    mamba or xLSTM block), in the reference's nesting, shapes and
    dtypes."""
    cfg = reduced(rget(arch), d_model=64)
    want = jax.eval_shape(RT.build_model(cfg).init, jax.random.key(0))
    got = TT.build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        lm_params_to_reference(got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    leaves = [x for x in jax.tree_util.tree_leaves(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))]
    assert [str(leaf.dtype) for leaf in leaves] == \
        [str(dt[str(w.dtype)]) for _, w in flat_w]
    for kind, p in zip(cfg.blocks, got["blocks"]):
        assert kind[0] in ("attn", "mamba", "mlstm", "slstm")
        assert set(p) - {"norm1", "norm2", "mlp", "moe"} == {kind[0]}


def ref_blocks(cfg, rp, x, mode, caches, pos, prefix_len=0):
    """The reference's blocks evaluated one by one (its `block_apply`),
    caches in its unrolled layout, replaced by the new ones."""
    for ci in range(cfg.num_cycles):
        p_sl = jax.tree.map(lambda a: a[ci], rp["blocks"])
        for i, kind in enumerate(cfg.blocks):
            x, caches[ci][i], _ = RT.block_apply(
                cfg, kind, p_sl[i], x, mode=mode, cache=caches[ci][i],
                pos=None if pos is None else jnp.asarray(pos, jnp.int32),
                prefix_len=prefix_len)
    return x


def ref_logits(cfg, rp, x):
    x = RL.rms_norm(x[:, -1:], rp["final_norm"]["scale"], cfg.norm_eps)
    return RL.lm_logits(rp["lm_head"], x)[:, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_float_prefill_and_decode_match_the_reference(arch, setups):
    """LM.prefill and teacher-forced decode_steps against the reference's
    blocks op by op: logits within FLOAT_ATOL, every state of the caches
    within rtol/atol 1e-5 (attention K/V, bf16, within one ulp), the
    caches the port's prefill made written in place."""
    s = setups[arch]
    cfg, rp, toks = s["cfg"], s["rp"], s["toks"]
    rm, tm = RT.build_model(cfg), TT.build_model(cfg)
    tp = to_port(rp)
    rc = [list(c) for c in rm.init_cache(B, s["alloc"], stacked=False)]
    xr = ref_blocks(cfg, rp, RL.embed_lookup(rp["embed"],
                                             jnp.asarray(toks[:, :S])),
                    "prefill", rc, None)
    tl, tc = tm.prefill(tp, {"inputs": torch.from_numpy(toks[:, :S])},
                        alloc=s["alloc"])
    ptrs = [[{k: v.data_ptr() for k, v in c.items()} for c in row]
            for row in tc]
    diffs = [maxdiff(ref_logits(cfg, rp, xr), tl)]
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        xr = ref_blocks(cfg, rp, RL.embed_lookup(rp["embed"],
                                                 jnp.asarray(tok)),
                        "decode", rc, S + i)
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), S + i)
        assert tc2 is tc
        diffs.append(maxdiff(ref_logits(cfg, rp, xr), tl))
    assert max(diffs) <= FLOAT_ATOL, diffs
    for ci, row in enumerate(tc):
        for i, c in enumerate(row):
            assert {k: v.data_ptr() for k, v in c.items()} == ptrs[ci][i]
            want = rc[ci][i]
            if cfg.blocks[i][0] == "attn":
                for k in ("k", "v"):
                    close_bf16(want[k], c[k])
            else:
                close_states(want, c)


@pytest.mark.parametrize("arch", ARCHS)
def test_float_decode_is_consistent_with_prefill(arch, setups):
    """prefill(t[:S]) then decode_step(t[S]) agrees with prefill(t[:S+1])
    within atol 0.15 + rtol 0.05, argmax equal.  jamba at capacity factor
    E / k, where no expert drops a token on either side (a decode step
    groups the batch, a prefill each row)."""
    s = setups[arch]
    cfg = s["cfg"]
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=(
            cfg.num_experts / cfg.experts_per_tok))
    tm = TT.build_model(cfg)
    tp = to_port(s["rp"])
    toks = torch.from_numpy(s["toks"])
    lg_full, _ = tm.prefill(tp, {"inputs": toks[:, :S + 1]}, alloc=s["alloc"])
    _, cache = tm.prefill(tp, {"inputs": toks[:, :S]}, alloc=s["alloc"])
    lg_dec, _ = tm.decode_step(tp, cache, toks[:, S:S + 1], S)
    a, b = f32(lg_full), f32(lg_dec)
    np.testing.assert_allclose(b, a, **CONSIST)
    assert (a.argmax(-1) == b.argmax(-1)).all()


def lockstep(cfg, rp, tp, toks, alloc) -> list:
    """Prefill and STEPS decode steps, layer by layer: the reference's
    block on its own running state, the port's block on the same input,
    each side with its own caches.  Returns every block output's and
    every step's logits' max |difference|."""
    rm, tm = RT.build_model(cfg), TT.build_model(cfg)
    rc = [list(c) for c in rm.init_cache(B, alloc, stacked=False)]
    tc = tm.init_cache(B, alloc, "cpu")
    diffs = []

    def run(xr, mode, pos):
        for ci in range(cfg.num_cycles):
            pr = jax.tree.map(lambda a: a[ci], rp["blocks"])
            for i, kind in enumerate(cfg.blocks):
                yr, rc[ci][i], _ = RT.block_apply(
                    cfg, kind, pr[i], xr, mode=mode, cache=rc[ci][i],
                    pos=None if pos is None else jnp.asarray(pos, jnp.int32),
                    prefix_len=0)
                yt, _, _ = TT.block_apply(
                    cfg, kind, TT._cycle(tp["blocks"][i], ci),
                    to_port(xr), mode=mode, cache=tc[ci][i], pos=pos,
                    prefix_len=0)
                diffs.append(maxdiff(yr, yt))
                xr = yr
        ht = TT.rms_norm(to_port(xr[:, -1:]), tp["final_norm"]["scale"],
                         cfg.norm_eps)
        diffs.append(maxdiff(ref_logits(cfg, rp, xr)[:, None],
                             TT.layers.lm_logits(tp["lm_head"], ht)))

    run(RL.embed_lookup(rp["embed"], jnp.asarray(toks[:, :S])), "prefill",
        None)
    for i in range(STEPS):
        run(RL.embed_lookup(rp["embed"], jnp.asarray(toks[:, S + i:S + i + 1])),
            "decode", S + i)
    return diffs


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_prefill_and_decode_match_the_reference_layer_by_layer(
        arch, setups, monkeypatch):
    s = setups[arch]
    tp = TQ.quantize_lm_params(to_port(s["rp"]))
    monkeypatch.setattr(RQ.jnp, "exp2", exact_exp2)
    diffs = lockstep(s["cfg"], s["rq"], tp, s["toks"], s["alloc"])
    assert len(diffs) == (1 + STEPS) * (s["cfg"].num_layers + 1)
    assert max(diffs) <= W8A8_ATOL, diffs


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_lockstep_bound_rejects_float_products(arch, setups,
                                                    monkeypatch):
    """With the port's float tree against the reference's W8A8 tree,
    every block output and every step's logits lie beyond W8A8_ATOL."""
    s = setups[arch]
    monkeypatch.setattr(RQ.jnp, "exp2", exact_exp2)
    diffs = lockstep(s["cfg"], s["rq"], to_port(s["rp"]), s["toks"],
                     s["alloc"])
    assert min(diffs) > W8A8_ATOL, diffs


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_lm_params_bit_equal(arch, setups):
    """The W8A8 tree: the reference's leaf set (x_proj, dt_proj, conv_w,
    A_log, D, wi, wf and r stay float), int8 weights and exponents bit
    for bit."""
    s = setups[arch]
    want = s["rq"]
    got = TQ.quantize_lm_params(to_port(s["rp"]))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(lm_params_to_reference(
        got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        key = jax.tree_util.keystr(path)
        assert g.dtype == np.dtype(w.dtype) or w.dtype == jnp.bfloat16, key
        assert np.array_equal(np.asarray(w, g.dtype), g), key
    q_names = {jax.tree_util.keystr(p[:-1]).split("['")[-1].rstrip("']")
               for p, w in flat_w if w.dtype == jnp.int8}
    assert q_names == ({"in_proj", "out_proj", "wq", "wk", "wv", "wo",
                        "w_gate", "w_up", "w_down", "w"}
                       if arch == "jamba_v01_52b" else
                       {"up_proj", "wq", "wk", "wv", "down_proj", "wx",
                        "ffn_up", "ffn_down", "w"})
    assert TQ.quantized_bytes(got) == RQ.quantized_bytes(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_cross_the_converter_both_ways(arch, setups):
    """The reference's params and its filled caches (mamba conv/ssm,
    mLSTM C/n/m, sLSTM c/n/m/h, attention k/v) to the port and back,
    leaf for leaf and bit for bit; the port's caches to the reference's
    layout."""
    s = setups[arch]
    cfg = s["cfg"]
    rm = RT.build_model(cfg)
    for tree in (s["rp"], s["rq"]):
        back = lm_params_to_reference(to_port(tree))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert np.array_equal(np.asarray(a, np.float32)
                                  if a.dtype == jnp.bfloat16
                                  else np.asarray(a), b)
    rc = [list(c) for c in rm.init_cache(B, s["alloc"], stacked=False)]
    ref_blocks(cfg, s["rp"], RL.embed_lookup(
        s["rp"]["embed"], jnp.asarray(s["toks"][:, :S])), "prefill", rc,
        None)
    rc = tuple(tuple(c) for c in rc)
    tc = to_port(rc)
    names = {k for row in tc for c in row for k in c}
    assert names == ({"conv", "ssm", "k", "v"} if arch == "jamba_v01_52b"
                     else {"C", "n", "m", "c", "h"})
    back = lm_params_to_reference(tc)
    assert jax.tree.structure(back) == jax.tree.structure(rc)
    for a, b in zip(jax.tree.leaves(rc), jax.tree.leaves(back)):
        assert np.array_equal(f32(a), f32(b))
    fresh = TT.build_model(cfg).init_cache(B, s["alloc"], "cpu")
    want = rm.init_cache(B, s["alloc"], stacked=False)
    got = lm_params_to_reference(fresh)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.shape == b.shape and np.array_equal(f32(a), f32(b))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_serve_on_the_cpu(arch, quant):
    cfg = treduced(tget(arch), d_model=64)
    res = tserve.serve(cfg, requests=3, prompt_len=8, gen=5, quant=quant,
                       device="cpu", log=lambda *_: None)
    assert res["tokens"].shape == (3, 5)
    assert torch.isfinite(res["logits"].float()).all()
    assert np.array_equal(res["tokens"][:, -1],
                          res["logits"].float().argmax(-1).numpy())
