"""The port's LM layers, configs and token stream against the reference
`repro` on the CPU: `repro_torch.models.layers` against
`repro.models.layers`, `repro_torch.configs` against `repro.configs`
(every field, `param_count`, `padded_vocab`), `launch.train.reduced`, and
`data.synthetic.TokenTask` bit for bit.

Inputs come from NumPy seeds and go to both packages.  bf16 outputs are
held within one bf16 ulp (rtol 2**-7: an ulp is at most 2**-7 of a
value); on these inputs they are equal.  float32 reductions (the losses)
are held within rtol 1e-6: the two sum in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.data.synthetic import TokenTask as RTokenTask
from repro.launch.train import reduced as rreduced
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import base as tbase
from repro_torch.data.synthetic import TokenTask as TTokenTask
from repro_torch.launch.train import reduced as treduced
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

BF16_RTOL = 2.0 ** -7


def bf16(a):
    """NumPy float -> (reference bf16 array, port bf16 tensor), equal."""
    r = jnp.asarray(a, jnp.bfloat16)
    return r, torch.from_numpy(np.array(r.astype(jnp.float32))).bfloat16()


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def leaves(tree) -> list:
    """Leaves in the reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def close_bf16(want, got):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_RTOL, atol=0)


@pytest.mark.parametrize("mag,eps", [(1.0, 1e-6), (8.0, 1e-6), (0.01, 1e-5)])
def test_rms_norm(mag, eps):
    rng = np.random.default_rng(int(mag * 100))
    xr, xt = bf16(rng.normal(0, mag, (3, 7, 64)))
    scale = rng.normal(0, 0.2, (64,)).astype(np.float32)
    close_bf16(RL.rms_norm(xr, jnp.asarray(scale), eps),
               TL.rms_norm(xt, torch.from_numpy(scale), eps))


@pytest.mark.parametrize("theta,dh", [(1e4, 16), (1e6, 128), (1e4, 80)])
def test_rope(theta, dh):
    rng = np.random.default_rng(dh)
    xr, xt = bf16(rng.normal(0, 1, (2, 40, 3, dh)))
    pos = rng.integers(0, 4000, (2, 40))
    sr, cr = RL.rope_angles(jnp.asarray(pos), dh, theta)
    st, ct = TL.rope_angles(torch.from_numpy(pos), dh, theta)
    # sin/cos of float32 angles: two libm's, within a few float32 ulps
    np.testing.assert_allclose(f32(st), f32(sr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(ct), f32(cr), rtol=1e-5, atol=1e-5)
    close_bf16(RL.apply_rope(xr, jnp.asarray(pos), theta),
               TL.apply_rope(xt, torch.from_numpy(pos), theta))


@pytest.mark.parametrize("bias", [False, True])
def test_dense_and_mlp(bias):
    rng = np.random.default_rng(7)
    xr, xt = bf16(rng.normal(0, 1, (2, 5, 64)))
    w = {k: bf16(rng.normal(0, s, shape)) for k, s, shape in (
        ("w_gate", 0.125, (64, 256)), ("w_up", 0.125, (64, 256)),
        ("w_down", 0.0625, (256, 64)))}
    b = bf16(rng.normal(0, 0.1, (256,))) if bias else (None, None)
    close_bf16(RL.dense(xr, w["w_gate"][0], b[0]),
               TL.dense(xt, w["w_gate"][1], b[1]))
    close_bf16(RL.mlp({k: v[0] for k, v in w.items()}, xr),
               TL.mlp({k: v[1] for k, v in w.items()}, xt))


def test_embed_lookup_and_lm_logits():
    rng = np.random.default_rng(3)
    tr, tt = bf16(rng.normal(0, 0.1, (300, 64)))
    toks = rng.integers(0, 300, (4, 9)).astype(np.int32)
    got = TL.embed_lookup({"table": tt}, torch.from_numpy(toks))
    assert torch.equal(got.view(torch.int16), torch.from_numpy(
        np.array(RL.embed_lookup({"table": tr}, jnp.asarray(toks)))
        .view(np.int16)))
    hr, ht = bf16(rng.normal(0, 0.1, (64, 300)))
    close_bf16(RL.lm_logits({"w": hr}, RL.embed_lookup({"table": tr},
                                                       jnp.asarray(toks))),
               TL.lm_logits({"w": ht}, got))


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent(masked):
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 3, (4, 6, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (4, 6)).astype(np.int32)
    mask = (rng.random((4, 6)) < 0.6).astype(np.float32) if masked else None
    want = RL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = TL.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss(masked):
    rng = np.random.default_rng(12)
    xr, xt = bf16(rng.normal(0, 1, (2, 24, 64)))
    hr, ht = bf16(rng.normal(0, 0.125, (64, 96)))
    tg = rng.integers(0, 96, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.7).astype(np.float32) if masked else None
    want = RT.lm_loss(xr, hr, jnp.asarray(tg),
                      None if mask is None else jnp.asarray(mask),
                      seq_chunk=8)
    got = TT.lm_loss(xt, ht, torch.from_numpy(tg),
                     None if mask is None else torch.from_numpy(mask),
                     seq_chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("vocab,seq,seed", [(4096, 64, 3), (50304, 17, 0),
                                            (5, 8, 9)])
def test_token_task_bit_equal(vocab, seq, seed):
    r, t = RTokenTask(vocab, seq, seed=seed), TTokenTask(vocab, seq,
                                                         seed=seed)
    for index, bs in ((0, 8), (5, 3)):
        br, bt = r.batch(index, bs), t.batch(index, bs)
        for k in ("inputs", "targets"):
            assert br[k].dtype == bt[k].dtype
            assert np.array_equal(br[k], bt[k])


@pytest.mark.parametrize("arch", rbase.ARCH_IDS)
def test_configs_equal_field_for_field(arch):
    r, t = rbase.get_config(arch), tbase.get_config(arch)
    assert type(t).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for cfg_r, cfg_t in ((r, t), (rreduced(r, d_model=64),
                                  treduced(t, d_model=64))):
        assert dataclasses.asdict(cfg_r) == dataclasses.asdict(cfg_t)
        for prop in ("num_cycles", "padded_vocab", "dt_rank", "ssm_inner",
                     "xlstm_inner", "is_subquadratic",
                     "has_mostly_bounded_context"):
            assert getattr(cfg_r, prop) == getattr(cfg_t, prop), prop
        assert cfg_r.param_count() == cfg_t.param_count()
        assert cfg_r.param_count(active_only=True) == \
            cfg_t.param_count(active_only=True)


def test_the_shape_grid_and_arch_list_equal():
    assert rbase.ARCH_IDS == tbase.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
    assert set(tbase.all_configs()) == set(rbase.ARCH_IDS)


@pytest.mark.parametrize("arch", ["stablelm_3b", "qwen3_14b", "qwen2_72b",
                                  "gemma3_12b", "paligemma_3b"])
def test_init_tree_matches_the_reference_layout(arch):
    """The port's init gives the reference's tree: the same nesting,
    shapes and dtypes (stacked [C, ...] block leaves), zeroed padded
    heads, zero norms and biases."""
    cfg = rreduced(rbase.get_config(arch), d_model=64)
    want = jax.eval_shape(RT.build_model(cfg).init, jax.random.key(0))
    got = TT.build_model(treduced(tbase.get_config(arch), d_model=64)).init(
        torch.Generator().manual_seed(0), "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    from repro_torch.convert import lm_params_to_reference
    flat_g = jax.tree_util.tree_flatten_with_path(
        lm_params_to_reference(got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    torch_dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for (path, w), leaf in zip(flat_w, leaves(got)):
        assert tuple(leaf.shape) == w.shape, jax.tree_util.keystr(path)
        assert leaf.dtype == torch_dt[str(w.dtype)]
    a = got["blocks"][0]["attn"]
    if cfg.head_pad:
        cut = cfg.num_heads * cfg.head_dim
        assert not a["wq"][..., cut:].any() and a["wq"][..., :cut].any()
        assert not a["wo"][:, cut:].any() and a["wo"][:, :cut].any()
    assert not got["final_norm"]["scale"].any()
    assert all(not a[b].any() for b in ("bq", "bk", "bv") if b in a)


@pytest.mark.parametrize("arch", ["paligemma_3b"])
def test_train_loss_matches_the_reference(arch):
    """`LM.train_loss` (the same forward, then the chunked xent over the
    text positions, masked) on the reference's weights: within rtol 2e-3
    of the reference's, whose stack is one scanned, rematerialized XLA
    computation that rounds its bf16 activations differently (measured
    at most 6.1e-4 on gemma3_12b, qwen3_14b and this VLM, whose loss
    skips the image prefix)."""
    from repro_torch.convert import lm_params_from_reference
    cfg = rreduced(rbase.get_config(arch), d_model=64)
    rp = RT.build_model(cfg).init(jax.random.key(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (rng.random((2, 32)) < 0.8).astype(np.float32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            0, 1, (2, cfg.num_prefix_embeds, 64)).astype(np.float32)
    want, _ = RT.build_model(cfg).train_loss(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = TT.build_model(treduced(tbase.get_config(arch), 64)).train_loss(
        lm_params_from_reference(jax.tree.map(np.asarray, rp), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux["aux"]) == 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3)
