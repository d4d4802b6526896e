"""`repro_torch.quant.lm_quant.init_quantized` on the CPU: the W8A8 tree
drawn and quantized one cycle at a time, so that no float tree, and no
float leaf stacked over the cycles, ever exists.

It must give `quantize_lm_params(model.init(...))` bit for bit: for all
ten architectures (d 64, two cycles), on each rank of a gloo world of 2
(a model line: each rank's shares), and, for jamba_v01_52b (attention,
mamba and MoE leaves), the reference's `quantize_lm_params` of the same
float weights carried across by `convert`, with the reference's inexact
XLA exp2 made exact.  `serve(quant="w8a8")` gives the tokens and logits
of the whole-tree path and the same `[quant]` line.  A dispatch mode
watches every op of the init: no float tensor larger than one cycle's
largest leaf (or a top-level leaf) may be made; the same watch on the
whole-tree path must see one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.utils._python_dispatch import TorchDispatchMode

from repro.quant import lm_quant as R
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import lm_params_to_reference
from repro_torch.dist import world as dworld
from repro_torch.launch import serve as TSV
from repro_torch.launch.train import reduced
from repro_torch.models.transformer import build_model
from repro_torch.quant import lm_quant as T
from repro_torch.tree import leaves_with_paths

import torch_tp_ranks as ranks


def cfg_of(arch: str, **edit):
    """d 64, two pattern cycles."""
    c = get_config(arch)
    return dataclasses.replace(reduced(c, d_model=64,
                                       layers=2 * len(c.blocks)), **edit)


def gen():
    return torch.Generator().manual_seed(0)


def same_trees(a, b) -> int:
    """The number of leaves; raises unless paths, dtypes and bits agree."""
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path
    return len(la)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_streamed_tree_equals_the_whole_tree(arch):
    cfg = cfg_of(arch)
    assert cfg.num_cycles == 2
    model = build_model(cfg)
    got = T.init_quantized(model, gen(), "cpu")
    want = T.quantize_lm_params(model.init(gen(), "cpu"))
    n = same_trees(got, want)
    assert n > 2 * len(cfg.blocks)
    assert T.is_qweight(got["lm_head"]["w"])
    assert not T.is_qweight(got["embed"])


def exact_exp2(x):
    """2^x for integer-valued float x, exactly (from the exponent bits)."""
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def test_streamed_tree_equals_the_references_quantization(monkeypatch):
    """jamba_v01_52b's float weights carried to the reference and
    quantized there (exact exp2) equal the streamed tree carried across,
    leaf for leaf."""
    monkeypatch.setattr(R.jnp, "exp2", exact_exp2)
    model = build_model(cfg_of("jamba_v01_52b"))
    rp = jax.tree.map(jnp.asarray, lm_params_to_reference(
        model.init(gen(), "cpu")))
    want = jax.tree_util.tree_flatten_with_path(R.quantize_lm_params(rp))[0]
    got = jax.tree_util.tree_flatten_with_path(lm_params_to_reference(
        T.init_quantized(model, gen(), "cpu")))[0]
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        [jax.tree_util.keystr(p) for p, _ in got]
    n_int = 0
    for (path, w), (_, g) in zip(want, got):
        g = np.asarray(g)
        if w.dtype in (jnp.int8, jnp.int32):
            n_int += 1
            assert g.dtype == np.dtype(w.dtype)
        assert np.array_equal(np.asarray(w.astype(jnp.float32)),
                              g.astype(np.float32)), \
            jax.tree_util.keystr(path)
    assert n_int > 20


@pytest.mark.parametrize("arch", ["qwen3_14b", "phi35_moe",
                                  "seamless_m4t_medium"])
def test_serve_w8a8_gives_the_whole_tree_paths_results(arch, monkeypatch):
    cfg = cfg_of(arch)
    lines = {}

    def run(what):
        lines[what] = []
        return TSV.serve(cfg, requests=2, prompt_len=8, gen=4, quant="w8a8",
                         device="cpu", log=lines[what].append)
    got = run("streamed")
    monkeypatch.setattr(TSV, "init_quantized", lambda model, g, device: (
        T.quantize_lm_params(model.init(g, device), consume=True)))
    want = run("whole")
    assert np.array_equal(got["tokens"], want["tokens"])
    assert torch.equal(got["logits"], want["logits"])
    assert got["fp_bytes"] == want["fp_bytes"] > got["param_bytes"] \
        == want["param_bytes"]
    assert lines["streamed"] == lines["whole"]
    assert lines["streamed"][0].startswith("[quant] params ")


class LargestFloat(TorchDispatchMode):
    """The largest floating-point tensor any op makes, and the op."""

    def __init__(self):
        super().__init__()
        self.numel, self.op = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() > self.numel:
                self.numel, self.op = t.numel(), str(func)
        return out


def cycle_limit(model) -> int:
    """The largest float leaf the streamed init may hold: a top-level
    leaf, or one cycle's share of a stacked block leaf."""
    limit = 0
    for path, t in leaves_with_paths(model.init(torch.Generator(), "meta")):
        stacked = path.split("/")[0] in ("blocks", "enc_blocks",
                                         "dec_blocks")
        limit = max(limit, t.numel() // (t.shape[0] if stacked else 1))
    return limit


@pytest.mark.parametrize("arch", ["qwen3_14b", "phi35_moe", "jamba_v01_52b",
                                  "seamless_m4t_medium"])
def test_no_float_tensor_past_one_cycle(arch):
    """The vocabulary is cut to 256, so the tables are no larger than a
    cycle's largest weight and a stacked float weight (two cycles)
    exceeds every leaf the streamed init may hold."""
    model = build_model(cfg_of(arch, vocab_size=256))
    limit = cycle_limit(model)
    with LargestFloat() as streamed:
        T.init_quantized(model, gen(), "cpu")
    assert 0 < streamed.numel <= limit, streamed.op
    with LargestFloat() as whole:
        T.quantize_lm_params(model.init(gen(), "cpu"), consume=True)
    assert whole.numel >= 2 * limit > limit, (whole.numel, limit)


def test_streamed_tree_equals_each_ranks_quantized_shares():
    """On a gloo world of 2 (model 2): each rank's streamed tree equals
    `quantize_lm_params` of its own float shares, for all ten
    architectures, and holds less than the one-process tree."""
    res = dworld.spawn(ranks.streamed_init_checks, 2, timeout_s=120,
                       args=(list(ARCH_IDS),))
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        for arch in ARCH_IDS:
            n, equal, local, whole = r[arch]
            assert equal and n > 0, arch
            assert local < whole, arch
