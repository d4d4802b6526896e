"""The port's encoder-decoder (`models.transformer.EncDecLM`, the
seamless_m4t_medium config) against the reference `repro` on the CPU,
reduced to d_model 64 (2 encoder and 2 decoder layers, 4 heads, vocab
4,096): the frame encoder, prefill and decode with self- and
cross-attention caches, float and W8A8, the training loss, the W8A8
tree, caches and params through the converter, and `launch.serve`.

Weights: the reference's own init, carried across with
`convert.lm_params_from_reference`; frame embeddings and tokens from
NumPy seeds.  The source has SRC = 12 frames and the target S = 16
tokens, so the cross caches (SRC slots) and the self caches (`alloc`
slots) differ in length.

Tolerances, as `tests/test_torch_lm_serve.py` holds the same faces:
- bf16 activations (the encoder's output, the caches' K/V): one bf16
  ulp (rtol 2**-7) against the reference's blocks evaluated op by op
  (measured equal);
- logits: FLOAT_ATOL 0.1 against the reference's own `prefill` and
  `decode_step`, whose scanned stacks round differently; decode after
  prefill(S) against prefill(S+1): atol 0.15 + rtol 0.05, argmax equal;
- W8A8: block by block in lockstep (each encoder block, then each
  decoder block at prefill and at every decode step, on the reference's
  block input), with XLA's inexact CPU exp2 made exact on the
  reference's side: W8A8_ATOL = 0 (measured 0 on every block), and the
  port's float tree in place of the W8A8 one fails it on every block;
- the training loss: rtol 2e-3, as `tests/test_torch_lm_layers.py`
  holds the decoder-only one against the reference's rematerialized
  scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.base import get_config as rget
from repro.launch.train import reduced
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.quant import lm_quant as RQ
from repro_torch.configs.base import get_config as tget
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.quant import lm_quant as TQ

ARCH = "seamless_m4t_medium"
B, S, SRC, STEPS = 2, 16, 12, 4
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


def close_bf16(want, got):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_RTOL, atol=0)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(rget(ARCH), d_model=64)
    rp = RT.build_model(cfg).init(jax.random.key(0))
    rng = np.random.default_rng(7)
    return dict(cfg=cfg, rp=rp, rq=RQ.quantize_lm_params(rp),
                frames=rng.normal(0, 1, (B, SRC, cfg.d_model)).astype(
                    np.float32),
                toks=rng.integers(1, cfg.vocab_size, (B, S + STEPS)).astype(
                    np.int32),
                alloc=RT.decode_alloc(S + STEPS))


# the reference's blocks, op by op (its run_stack and _dec_stack bodies)
def ref_enc_block(cfg, p, x):
    h = RL.rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    h, _ = RA.attn_apply(cfg, p["attn"], h, mode="train", cache=None,
                         pos=None, prefix_len=2 ** 30, window=0)
    x = x + h
    return x + RL.mlp(p["mlp"], RL.rms_norm(x, p["norm2"]["scale"],
                                            cfg.norm_eps))


def ref_dec_block(cfg, p, x, enc_out, mode, c, pos):
    h = RL.rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    h, self_c = RA.attn_apply(cfg, p["self"], h, mode=mode, cache=c["self"],
                              pos=pos)
    x = x + h
    h = RL.rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if mode == "decode":
        h, cross_c = RA.attn_apply(cfg, p["cross"], h, mode="decode",
                                   cache=c["cross"], pos=pos, is_cross=True)
    else:
        h, cross_c = RA.attn_apply(cfg, p["cross"], h, mode=mode,
                                   cache=c["cross"], kv_override=enc_out)
    x = x + h
    x = x + RL.mlp(p["mlp"], RL.rms_norm(x, p["norm3"]["scale"],
                                         cfg.norm_eps))
    return x, {"self": self_c, "cross": cross_c}


def ref_frontend(rp, frames):
    return RL.dense(jnp.asarray(frames).astype(RL.DEFAULT_DTYPE),
                    rp["frontend"]["w"])


def cycle(tree, ci):
    return jax.tree.map(lambda a: a[ci], tree)


def ref_encode(cfg, rp, frames):
    x = ref_frontend(rp, frames)
    for ci in range(cfg.num_encoder_layers):
        x = ref_enc_block(cfg, cycle(rp["enc_blocks"][0], ci), x)
    return RL.rms_norm(x, rp["enc_norm"]["scale"], cfg.norm_eps)


def ref_caches(cfg, alloc):
    """The reference's per-layer caches, unstacked from its init_cache."""
    c = RT.EncDecLM(cfg).init_cache(B, alloc, SRC)[0]
    return [cycle(c, ci) for ci in range(cfg.num_cycles)]


def test_the_config_builds_an_encdec_model():
    cfg = tget(ARCH)
    assert cfg.is_encoder_decoder
    assert isinstance(TT.build_model(cfg), TT.EncDecLM)


def test_init_tree_matches_the_reference_layout(setup):
    """frontend, embed, enc_blocks (stacked over the encoder's layers),
    enc_norm, dec_blocks (a 1-tuple stacked over the decoder's cycles),
    final_norm, lm_head: the reference's nesting, shapes and dtypes."""
    cfg = setup["cfg"]
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
    leaves = jax.tree_util.tree_leaves(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert [leaf.dtype for leaf in leaves] == \
        [dt[str(w.dtype)] for _, w in flat_w]
    assert isinstance(got["dec_blocks"], tuple) and \
        len(got["dec_blocks"]) == 1


def test_encode_matches_the_reference(setup):
    """The frontend and bidirectional encoder blocks, one bf16 ulp."""
    cfg, rp = setup["cfg"], setup["rp"]
    got = TT.build_model(cfg).encode(to_port(rp),
                                     torch.from_numpy(setup["frames"]))
    close_bf16(ref_encode(cfg, rp, setup["frames"]), got)
    # bidirectional: the first frame's output sees the last frame
    frames = setup["frames"].copy()
    frames[:, -1] += 1.0
    moved = TT.build_model(cfg).encode(to_port(rp), torch.from_numpy(frames))
    assert maxdiff(got[:, 0], moved[:, 0]) > 0


def test_float_prefill_and_decode_match_the_reference(setup):
    """The port's prefill and teacher-forced decode steps against the
    reference's own: logits within FLOAT_ATOL; every cache written in
    place in the buffers prefill made; the self and cross K/V within one
    bf16 ulp of the reference's blocks op by op."""
    cfg, rp, toks = setup["cfg"], setup["rp"], setup["toks"]
    rm, tm = RT.build_model(cfg), TT.build_model(cfg)
    tp = to_port(rp)
    batch = {"frames": setup["frames"], "inputs": toks[:, :S]}
    rl, rc = rm.prefill(rp, {k: jnp.asarray(v) for k, v in batch.items()},
                        alloc=setup["alloc"])
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
                        alloc=setup["alloc"])
    assert tl.shape == (B, cfg.padded_vocab)
    ptrs = jax.tree.map(lambda t: t.data_ptr(), tc,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    diffs = [maxdiff(rl, tl)]
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        rl, rc = rm.decode_step(rp, rc, jnp.asarray(tok),
                                jnp.asarray(S + i, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), S + i)
        assert tc2 is tc
        diffs.append(maxdiff(rl, tl))
    assert max(diffs) <= FLOAT_ATOL, diffs
    assert jax.tree.map(lambda t: t.data_ptr(), tc, is_leaf=lambda t:
                        isinstance(t, torch.Tensor)) == ptrs
    # the caches against the reference's blocks op by op
    enc = ref_encode(cfg, rp, setup["frames"])
    x = RL.embed_lookup(rp["embed"], jnp.asarray(toks[:, :S]))
    caches = ref_caches(cfg, setup["alloc"])
    for ci in range(cfg.num_cycles):
        x, caches[ci] = ref_dec_block(cfg, cycle(rp["dec_blocks"][0], ci),
                                      x, enc, "prefill", caches[ci], None)
    for i in range(STEPS):
        x = RL.embed_lookup(rp["embed"],
                            jnp.asarray(toks[:, S + i:S + i + 1]))
        for ci in range(cfg.num_cycles):
            x, caches[ci] = ref_dec_block(
                cfg, cycle(rp["dec_blocks"][0], ci), x, None, "decode",
                caches[ci], jnp.asarray(S + i, jnp.int32))
    assert tc[0]["cross"]["k"].shape[2] == SRC
    for ci in range(cfg.num_cycles):
        for kind in ("self", "cross"):
            for kv in ("k", "v"):
                close_bf16(caches[ci][kind][kv], tc[0][kind][kv][ci])


def test_float_decode_is_consistent_with_prefill(setup):
    """prefill(t[:S]) then decode_step(t[S]) agrees with prefill(t[:S+1])
    on the same frames, within atol 0.15 + rtol 0.05, argmax equal."""
    tm = TT.build_model(setup["cfg"])
    tp = to_port(setup["rp"])
    frames = torch.from_numpy(setup["frames"])
    toks = torch.from_numpy(setup["toks"])
    lg_full, _ = tm.prefill(tp, {"frames": frames,
                                 "inputs": toks[:, :S + 1]},
                            alloc=setup["alloc"])
    _, cache = tm.prefill(tp, {"frames": frames, "inputs": toks[:, :S]},
                          alloc=setup["alloc"])
    lg_dec, _ = tm.decode_step(tp, cache, toks[:, S:S + 1], S)
    a, b = f32(lg_full), f32(lg_dec)
    np.testing.assert_allclose(b, a, **CONSIST)
    assert (a.argmax(-1) == b.argmax(-1)).all()


def lockstep(cfg, rp, tp, frames, toks, alloc) -> list:
    """Each block of the port on the reference's block input, each side
    with its own caches: the encoder, the decoder at prefill and at each
    decode step, and the logits.  Returns the max |difference| of every
    block output and of the logits."""
    diffs = []
    xr = ref_frontend(rp, frames)
    diffs.append(maxdiff(xr, TT.layers.dense(
        torch.from_numpy(frames).to(torch.bfloat16), tp["frontend"]["w"])))
    for ci in range(cfg.num_encoder_layers):
        yr = ref_enc_block(cfg, cycle(rp["enc_blocks"][0], ci), xr)
        yt, _, _ = TT.block_apply(
            cfg, TT.ENC_BLOCK[0], TT._cycle(tp["enc_blocks"][0], ci),
            to_port(xr), mode="train", cache=None, pos=None,
            prefix_len=2 ** 30)
        diffs.append(maxdiff(yr, yt))
        xr = yr
    enc_r = RL.rms_norm(xr, rp["enc_norm"]["scale"], cfg.norm_eps)
    rc = ref_caches(cfg, alloc)
    tc = TT.build_model(cfg).init_cache(B, alloc, SRC, "cpu")

    def run(xr, enc, mode, pos):
        for ci in range(cfg.num_cycles):
            yr, rc[ci] = ref_dec_block(
                cfg, cycle(rp["dec_blocks"][0], ci), xr, enc, mode, rc[ci],
                None if pos is None else jnp.asarray(pos, jnp.int32))
            yt = TT.dec_block(
                cfg, TT._cycle(tp["dec_blocks"][0], ci), to_port(xr),
                None if enc is None else to_port(enc), mode=mode, pos=pos,
                cache=TT._cycle(tc[0], ci))
            diffs.append(maxdiff(yr, yt))
            xr = yr
        hr = RL.rms_norm(xr[:, -1:], rp["final_norm"]["scale"],
                         cfg.norm_eps)
        ht = TT.rms_norm(to_port(xr[:, -1:]), tp["final_norm"]["scale"],
                         cfg.norm_eps)
        diffs.append(maxdiff(RL.lm_logits(rp["lm_head"], hr),
                             TT.layers.lm_logits(tp["lm_head"], ht)))

    run(RL.embed_lookup(rp["embed"], jnp.asarray(toks[:, :S])), enc_r,
        "prefill", None)
    for i in range(STEPS):
        run(RL.embed_lookup(rp["embed"], jnp.asarray(toks[:, S + i:S + i + 1])),
            None, "decode", S + i)
    return diffs


def test_w8a8_prefill_and_decode_match_the_reference_layer_by_layer(
        setup, monkeypatch):
    cfg = setup["cfg"]
    tp = TQ.quantize_lm_params(to_port(setup["rp"]))
    monkeypatch.setattr(RQ.jnp, "exp2", exact_exp2)
    diffs = lockstep(cfg, setup["rq"], tp, setup["frames"], setup["toks"],
                     setup["alloc"])
    assert len(diffs) == (1 + cfg.num_encoder_layers
                          + (1 + STEPS) * (cfg.num_layers + 1))
    assert max(diffs) <= W8A8_ATOL, diffs


def test_w8a8_lockstep_bound_rejects_float_products(setup, monkeypatch):
    """The port's float tree against the reference's W8A8 tree: every
    encoder and decoder block and every step's logits lie beyond
    W8A8_ATOL (the frontend stays float in both trees, so its output is
    equal)."""
    monkeypatch.setattr(RQ.jnp, "exp2", exact_exp2)
    diffs = lockstep(setup["cfg"], setup["rq"], to_port(setup["rp"]),
                     setup["frames"], setup["toks"], setup["alloc"])
    assert diffs[0] == 0.0
    assert min(diffs[1:]) > W8A8_ATOL, diffs


def test_quantize_lm_params_bit_equal(setup):
    """The W8A8 tree: the reference's leaf set (the frontend's w stays
    float), int8 weights and exponents bit for bit."""
    want = setup["rq"]
    got = TQ.quantize_lm_params(to_port(setup["rp"]))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(lm_params_to_reference(
        got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert np.array_equal(np.asarray(w, g.dtype), g), \
            jax.tree_util.keystr(path)
    assert not TQ.is_qweight(got["frontend"]["w"])
    assert TQ.is_qweight(got["dec_blocks"][0]["cross"]["wk"])
    assert TQ.quantized_bytes(got) == RQ.quantized_bytes(want)


def test_params_and_caches_cross_the_converter_both_ways(setup):
    """Params (float and W8A8) and the reference's filled caches (a
    1-tuple of {"self", "cross"} K/V stacked over the cycles) to the port
    and back, bit for bit; the port's fresh caches in the reference's
    structure, shapes and dtypes."""
    cfg = setup["cfg"]
    for tree in (setup["rp"], setup["rq"]):
        back = lm_params_to_reference(to_port(tree))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert np.array_equal(f32(a) if a.dtype == jnp.bfloat16
                                  else np.asarray(a), b)
    _, rc = RT.build_model(cfg).prefill(
        setup["rp"], {"frames": jnp.asarray(setup["frames"]),
                      "inputs": jnp.asarray(setup["toks"][:, :S])},
        alloc=setup["alloc"])
    back = lm_params_to_reference(to_port(rc))
    assert jax.tree.structure(back) == jax.tree.structure(rc)
    for a, b in zip(jax.tree.leaves(rc), jax.tree.leaves(back)):
        assert np.array_equal(f32(a), b)
    want = RT.EncDecLM(cfg).init_cache(B, setup["alloc"], SRC)
    got = lm_params_to_reference(TT.build_model(cfg).init_cache(
        B, setup["alloc"], SRC, "cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.shape == b.shape and not b.any()


def test_train_loss_matches_the_reference(setup):
    cfg, rp = setup["cfg"], setup["rp"]
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, (B, 33)).astype(np.int32)
    batch = {"frames": setup["frames"], "inputs": toks[:, :-1],
             "targets": toks[:, 1:],
             "mask": (rng.random((B, 32)) < 0.8).astype(np.float32)}
    want, _ = RT.build_model(cfg).train_loss(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = TT.build_model(cfg).train_loss(
        to_port(rp), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux["aux"]) == 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_serve_gives_the_encoder_zero_frames_of_the_prompts_length(
        quant, monkeypatch):
    """`serve` as the reference's CLI: zero frame embeddings [requests,
    prompt_len, d_model] float32, the decode positions after the
    prompt."""
    cfg = reduced(tget(ARCH), d_model=64)
    seen = []
    encode = TT.EncDecLM.encode

    def spy(self, params, frames):
        seen.append(frames)
        return encode(self, params, frames)
    monkeypatch.setattr(TT.EncDecLM, "encode", spy)
    res = tserve.serve(cfg, requests=3, prompt_len=8, gen=5, quant=quant,
                       device="cpu", log=lambda *_: None)
    assert len(seen) == 1 and seen[0].shape == (3, 8, cfg.d_model)
    assert seen[0].dtype == torch.float32 and not seen[0].any()
    assert res["tokens"].shape == (3, 5) and res["pos0"] == 8
    assert torch.isfinite(res["logits"].float()).all()
