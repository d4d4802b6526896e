"""The port's LM serving path against the reference `repro` on the CPU:
`LM.prefill` and teacher-forced `decode_step`s of the seven ported
architectures (reduced to d_model 64: `stablelm_3b`, `qwen3_14b`,
`qwen2_72b` with qkv biases, `gemma3_12b` with a window of 8 under a
16-token prompt so the SWA caches wrap, `paligemma_3b` with its
prefix-LM image embeds, and the MoE `phi35_moe` and `mixtral_8x22b`,
4 experts top-2), float and W8A8; decode consistent with prefill;
`launch.serve` end to end, and the CLI serving the SSM, hybrid and
encoder-decoder architectures too (held against the reference in
`tests/test_torch_lm_ssm.py` and `tests/test_torch_lm_encdec.py`).

Weights: the reference's own init, carried across with
`convert.lm_params_from_reference`; inputs from NumPy seeds.

The reference side is its own functions evaluated op by op
(`_embed`, `block_apply` per layer, `rms_norm`, `lm_logits`; its
`decode_step` already runs that way).  Its `prefill` scans the same
blocks under one XLA compilation, whose fused float code rounds
differently: at this size the reference's scanned prefill is up to 0.072
(float) and 0.28 (W8A8) off its own op-by-op logits, as far as its W8A8
logits are from its float ones.

Float: logits of magnitude ~4 held within 0.1 absolute (bf16 ulp 0.016
there; measured ≤ 0.047, on gemma3_12b, most archs bit-equal).  W8A8:
per-tensor int8 activations turn a one-ulp difference upstream into a
different int8 code, so a whole-chain comparison measures chaos, not the
quantizer; every layer is instead run in lockstep, the port's block on
the reference's block input, each block output and the logits held
equal to the reference's (W8A8_ATOL = 0, as measured on every block of
the seven architectures), with XLA's inexact CPU exp2 replaced by an
exact power of two on the reference side (tests/test_torch_lm_quant.py
holds the unpatched `q_dense`).  The float tree put in place of the
W8A8 one is 0.047-0.195 off on each block (measured), so a block whose
products stayed float or were dequantized wrongly fails the bound; a
test below holds that.
"""
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
from repro.models import transformer as RT
from repro.quant import lm_quant as RQ
from repro_torch.configs.base import get_config as tget
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import reduced as treduced
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.quant import lm_quant as TQ

DENSE_ARCHS = ["stablelm_3b", "qwen3_14b", "qwen2_72b", "gemma3_12b",
               "paligemma_3b"]
MOE_ARCHS = ["phi35_moe", "mixtral_8x22b"]
ARCHS = DENSE_ARCHS + MOE_ARCHS
B, S, STEPS = 2, 16, 4
FLOAT_ATOL = 0.1
W8A8_ATOL = 0.0


def exact_exp2(x):
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def to_port(a):
    return lm_params_from_reference(np.array(a), "cpu")


def maxdiff(r, t) -> float:
    return float(np.abs(np.asarray(r, np.float32)
                        - t.float().numpy()).max())


def slice_cfg(arch):
    cfg = reduced(rget(arch), d_model=64)
    if arch == "gemma3_12b":
        cfg = dataclasses.replace(cfg, window_size=8)
    return cfg


@pytest.fixture(scope="module")
def setups():
    """Per arch: config, the reference's float params and W8A8 params,
    tokens and the batch (prefix embeds for the VLM)."""
    out = {}
    for arch in ARCHS:
        cfg = slice_cfg(arch)
        rp = RT.build_model(cfg).init(jax.random.key(0))
        rng = np.random.default_rng(len(arch))
        toks = rng.integers(1, cfg.vocab_size, (B, S + STEPS)).astype(
            np.int32)
        batch = {"inputs": toks[:, :S]}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = rng.normal(
                0, 1, (B, cfg.num_prefix_embeds, cfg.d_model)).astype(
                    np.float32)
        out[arch] = dict(cfg=cfg, rp=rp, rq=RQ.quantize_lm_params(rp),
                         toks=toks, batch=batch,
                         pos0=S + (cfg.num_prefix_embeds
                                   if cfg.family == "vlm" else 0),
                         alloc=RT.decode_alloc(S + STEPS + (
                             cfg.num_prefix_embeds
                             if cfg.family == "vlm" else 0)))
    return out


def ref_prefill(rm, rp, batch, alloc):
    """The reference's `LM.prefill`, its blocks evaluated one by one."""
    cfg = rm.cfg
    x, prefix_len = rm._embed(rp, batch)
    caches = rm.init_cache(x.shape[0], alloc, stacked=False)
    out = []
    for ci in range(cfg.num_cycles):
        p_sl = jax.tree.map(lambda a: a[ci], rp["blocks"])
        row = []
        for i, kind in enumerate(cfg.blocks):
            x, nc, _ = RT.block_apply(cfg, kind, p_sl[i], x, mode="prefill",
                                      cache=caches[ci][i], pos=None,
                                      prefix_len=prefix_len)
            row.append(nc)
        out.append(tuple(row))
    x = RL.rms_norm(x[:, -1:], rp["final_norm"]["scale"], cfg.norm_eps)
    return RL.lm_logits(rp["lm_head"], x)[:, 0], tuple(out)


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_float_prefill_and_decode_match_the_reference(arch, setups):
    s = setups[arch]
    rm, tm = RT.build_model(s["cfg"]), TT.build_model(s["cfg"])
    tp = lm_params_from_reference(jax.tree.map(np.asarray, s["rp"]), "cpu")
    rb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    rl, rc = ref_prefill(rm, s["rp"], rb, s["alloc"])
    tl, tc = tm.prefill(tp, port_batch(s["batch"]), alloc=s["alloc"])
    assert tl.shape == (B, s["cfg"].padded_vocab)
    diffs = [maxdiff(rl, tl)]
    for i in range(STEPS):
        tok = s["toks"][:, S + i:S + i + 1]
        rl, rc = rm.decode_step(s["rp"], rc, jnp.asarray(tok),
                                jnp.asarray(s["pos0"] + i, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                 s["pos0"] + i)
        assert tc2 is tc                            # caches written in place
        diffs.append(maxdiff(rl, tl))
    assert max(diffs) <= FLOAT_ATOL, diffs


def lockstep(cfg, rp, tp, batch, toks, pos0, alloc) -> list:
    """Prefill and STEPS decode steps, layer by layer: the reference's
    block on its own running state, the port's block on the same input,
    each side with its own caches.  Returns every block output's and
    every step's logits' max |difference|."""
    rm, tm = RT.build_model(cfg), TT.build_model(cfg)
    xr, prefix_len = rm._embed(rp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    xt, _ = tm._embed(tp, port_batch(batch))
    diffs = [maxdiff(xr, xt)]
    rc = [list(c) for c in rm.init_cache(B, alloc, stacked=False)]
    tc = tm.init_cache(B, alloc, "cpu")

    def run(xr, mode, pos, prefix_len):
        for ci in range(cfg.num_cycles):
            pr = jax.tree.map(lambda a: a[ci], rp["blocks"])
            for i, kind in enumerate(cfg.blocks):
                yr, rc[ci][i], _ = RT.block_apply(
                    cfg, kind, pr[i], xr, mode=mode, cache=rc[ci][i],
                    pos=None if pos is None else jnp.asarray(pos, jnp.int32),
                    prefix_len=prefix_len)
                yt, _, _ = TT.block_apply(
                    cfg, kind, TT._cycle(tp["blocks"][i], ci), to_port(xr),
                    mode=mode, cache=tc[ci][i], pos=pos,
                    prefix_len=prefix_len)
                diffs.append(maxdiff(yr, yt))
                xr = yr
        hr = RL.rms_norm(xr[:, -1:], rp["final_norm"]["scale"], cfg.norm_eps)
        ht = TT.rms_norm(to_port(xr[:, -1:]), tp["final_norm"]["scale"],
                         cfg.norm_eps)
        diffs.append(maxdiff(RL.lm_logits(rp["lm_head"], hr),
                             TT.layers.lm_logits(tp["lm_head"], ht)))

    run(xr, "prefill", None, prefix_len)
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        run(RL.embed_lookup(rp["embed"], jnp.asarray(tok)), "decode",
            pos0 + i, 0)
    return diffs


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_prefill_and_decode_match_the_reference_layer_by_layer(
        arch, setups, monkeypatch):
    s = setups[arch]
    tp = TQ.quantize_lm_params(lm_params_from_reference(
        jax.tree.map(np.asarray, s["rp"]), "cpu"))
    monkeypatch.setattr(RQ.jnp, "exp2", exact_exp2)
    diffs = lockstep(s["cfg"], s["rq"], tp, s["batch"], s["toks"],
                     s["pos0"], s["alloc"])
    n_blocks = s["cfg"].num_layers
    assert len(diffs) == 1 + (1 + STEPS) * (n_blocks + 1)
    assert max(diffs) <= W8A8_ATOL, diffs


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_lockstep_bound_rejects_float_products(arch, setups,
                                                    monkeypatch):
    """The lockstep's bound is tight enough to see a block whose products
    skip the quantizer: with the port's float tree against the
    reference's W8A8 tree, every block output and every step's logits
    lie beyond W8A8_ATOL."""
    s = setups[arch]
    tp = lm_params_from_reference(jax.tree.map(np.asarray, s["rp"]), "cpu")
    monkeypatch.setattr(RQ.jnp, "exp2", exact_exp2)
    diffs = lockstep(s["cfg"], s["rq"], tp, s["batch"], s["toks"],
                     s["pos0"], s["alloc"])
    assert min(diffs[1:]) > W8A8_ATOL, diffs


def test_lm_entry_points_round_bf16_sums_once_and_restore_the_flag(
        monkeypatch):
    """prefill and decode_step run their blocks with cuBLAS's
    reduced-precision bf16 reductions off and leave the process's flag
    as they found it."""
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    seen = []
    run_stack = TT.run_stack

    def spy(*a, **k):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return run_stack(*a, **k)
    monkeypatch.setattr(TT, "run_stack", spy)
    cfg = treduced(tget("qwen3_14b"), d_model=64)
    tm = TT.build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.ones((1, 4), dtype=torch.int32)
    _, cache = tm.prefill(tp, {"inputs": toks}, alloc=8)
    tm.decode_step(tp, cache, toks[:, :1], 4)
    assert seen == [False, False]
    assert matmul.allow_bf16_reduced_precision_reduction


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_float_decode_is_consistent_with_prefill(arch, setups):
    """prefill(t[:S]) then decode_step(t[S]) agrees with prefill(t[:S+1]),
    within the reference's own tolerance for this check (atol 0.15, rtol
    0.05, argmax equal: bf16 along other reduction orders).  Float only:
    W8A8 quantizes each activation tensor with one dynamic exponent, so
    a decode step (one position) and a prefill of S+1 positions quantize
    the same row differently, in the reference as in the port."""
    check_consistency(setups[arch]["cfg"], setups[arch])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_is_consistent_with_prefill_where_nothing_drops(
        arch, setups):
    """The same check for the MoE archs, at capacity_factor E / k, where
    every expert has a slot for every token of its group.  At the
    config's 1.25 the reference's semantics differ between the two
    sides: a decode step groups the batch (T 2, C 4), a prefill each row
    (T 17, C 12), and here the compared token is dropped at one layer
    (mixtral_8x22b) or both (phi35_moe) of the prefill on every row, and
    kept at decode."""
    s = setups[arch]
    cfg = dataclasses.replace(s["cfg"], capacity_factor=(
        s["cfg"].num_experts / s["cfg"].experts_per_tok))
    assert TM.capacity(S + 1, cfg) >= S + 1
    check_consistency(cfg, s)


def check_consistency(cfg, s):
    tm = TT.build_model(cfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, s["rp"]), "cpu")
    full = dict(port_batch(s["batch"]),
                inputs=torch.from_numpy(s["toks"][:, :S + 1]))
    lg_full, _ = tm.prefill(tp, full, alloc=s["alloc"])
    _, cache = tm.prefill(tp, port_batch(s["batch"]), alloc=s["alloc"])
    lg_dec, _ = tm.decode_step(tp, cache, torch.from_numpy(
        s["toks"][:, S:S + 1]), s["pos0"])
    a, b = lg_full.float().numpy(), lg_dec.float().numpy()
    np.testing.assert_allclose(b, a, atol=0.15, rtol=0.05)
    assert (a.argmax(-1) == b.argmax(-1)).all()


def test_swa_ring_cache_drops_old_positions():
    """With window w, decode attention ignores positions <= pos - w:
    perturbing an old token leaves the decode logits unchanged."""
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=256, blocks=(("swa", "mlp"),),
                      window_size=4)
    tm = TT.build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, 200, (1, 10)).astype(np.int32))
    toks2 = toks.clone()
    toks2[0, 0] = 7
    out = []
    for t in (toks, toks2):
        _, cache = tm.prefill(tp, {"inputs": t}, alloc=TT.decode_alloc(10))
        assert cache[0][0]["k"].shape[1] == 4          # the ring
        one = torch.ones((1, 1), dtype=torch.int32)
        lg, _ = tm.decode_step(tp, cache, one, 10)
        out.append(lg.float().numpy())
    assert np.array_equal(out[0], out[1])


@pytest.mark.parametrize("argv", [
    [], ["--quant", "w8a8"], ["--arch", "paligemma_3b", "--quant", "w8a8"],
    ["--arch", "gemma3_12b"], ["--arch", "phi35_moe", "--quant", "w8a8"],
    ["--arch", "mixtral_8x22b"]], ids=str)
def test_serve_cli_on_the_cpu(argv, capsys):
    rc = tserve.main(["--device", "cpu", "--requests", "2", "--prompt-len",
                      "8", "--gen", "4", "--d-model", "64", *argv])
    out = capsys.readouterr().out
    assert rc == 0
    assert ("[quant] params" in out) == ("w8a8" in argv)
    assert "prefill:" in out and "decode : " in out and "  req1: [" in out


def test_serve_returns_its_greedy_tokens():
    cfg = treduced(tget("qwen3_14b"), d_model=64)
    res = tserve.serve(cfg, requests=3, prompt_len=8, gen=5, quant="w8a8",
                       device="cpu", log=lambda *_: None)
    assert res["tokens"].shape == (3, 5) and res["tokens"].dtype == np.int32
    assert res["param_bytes"] < res["fp_bytes"]
    assert torch.isfinite(res["logits"].float()).all()
    # the last token is the argmax of the last logits
    assert np.array_equal(res["tokens"][:, -1],
                          res["logits"].float().argmax(-1).numpy())
    with pytest.raises(ValueError, match="unknown quant"):
        tserve.serve(cfg, quant="w4", device="cpu")


@pytest.mark.parametrize("arch,model", [
    ("phi35_moe", TT.LM), ("mixtral_8x22b", TT.LM),
    ("jamba_v01_52b", TT.LM), ("xlstm_1_3b", TT.LM),
    ("seamless_m4t_medium", TT.EncDecLM)])
def test_the_moe_ssm_hybrid_and_encdec_architectures_build_and_serve(
        arch, model):
    """The architectures of ROADMAP Queue A item 5, once refused: the MoE
    decoders, jamba_v01_52b (mamba mixers), xlstm_1_3b (mLSTM/sLSTM) and
    the encoder-decoder seamless_m4t_medium build and serve through the
    CLI on the CPU."""
    cfg = treduced(tget(arch), d_model=64)
    assert type(TT.build_model(cfg)) is model
    assert tserve.main(["--arch", arch, "--device", "cpu", "--d-model",
                        "64", "--requests", "2", "--prompt-len", "8",
                        "--gen", "2"]) == 0
