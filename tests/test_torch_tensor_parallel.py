"""Tensor parallelism on the model axis in the port, on the CPU: gloo
worlds of 2 ranks (a mesh of model 2) and 4 ranks (data 2 x model 2),
started by `repro_torch.dist.world.spawn`, one world a size for the
whole module (the rank functions in `torch_tp_ranks`, which imports no
JAX).

For qwen3_14b, paligemma_3b, phi35_moe, jamba_v01_52b, xlstm_1_3b and
seamless_m4t_medium, reduced to d 64 (two layers, or one cycle of a
longer pattern), B 4 and S 16, in float32, bf16 and W8A8, every rank
runs `launch.steps.make_cell`'s steps on its shares (params laid out
by `sharding.param_specs`, rows over BATCH, cache slots over the model
line) beside the one-process port in the same process:

  float32  the train loss and every leaf's gradient (shards gathered)
           within 1e-5 of the leaf's largest element (measured at most
           7.9e-6, xlstm_1_3b on the world of 4, 2.5e-6 elsewhere),
           prefill and 4 decode steps' logits within 1e-5 of the
           largest logit (measured at most 3.7e-6);
  bf16     the loss within rtol 1e-5; every gradient within 8e-2 of the
           leaf's largest element, `test_torch_lm_train`'s bound on the
           bf16 step's moments (measured 4.6e-2 on xlstm_1_3b, whose
           eight recurrent layers carry the difference on, at most
           1.2e-2 elsewhere: a product's partial input gradients are
           rounded to bf16 on each rank before they are summed); the
           logits within 0.1, `test_torch_lm_serve`'s float bound
           (measured equal);
  W8A8     every W8A8 product's activation exponent equal to the
           one-process run's wherever its input is (a rank raises
           otherwise); the exponents that differ are counted and must
           follow a differing input (measured: none differed, and one
           product's input on jamba_v01_52b); the logits within 0.1
           (measured equal).

The float32 results of the world of 2 are held against the reference's
unsharded run in this process, on the same weights (`convert`): the
loss within rtol 1e-5, every gradient within 3e-4 of its leaf's largest
element (measured at most 1.6e-4, on xlstm_1_3b's mLSTM gate bias [1,
4], which the one-process port shares to 1.7e-6: the port's distance
from the reference on these weights, where `test_torch_lm_train`'s
bound of 1e-4 holds on its own), the logits within 1e-3 of the largest
(measured at most 1.1e-5).  The world of 4 also runs a batch of 3 (no
BATCH split: the cache's slots over data x model), and the module's
other checks: the Functions' backwards under `gradcheck` in float64,
`local_shard` / `gather_tree` round trips on even, uneven and empty
shares, checkpoints between one process and the mesh and a fault and
resume under it bit for bit, the global norm, and the CapsNet waves,
training and `compressed_psum` on the (data 2, model 2) mesh.
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import base as rbase
from repro.launch.train import reduced as rreduced
from repro.models import attention as RA
from repro.models import mamba as RMB
from repro.models import transformer as RT
from repro.optim import grad_compress as RG
from repro_torch import ckpt
from repro_torch.convert import lm_params_to_reference
from repro_torch.dist import world as dworld
from repro_torch.launch import steps as TS
from repro_torch.serving import default_specs
from repro_torch.tree import leaves, tree_map

import torch_tp_ranks as ranks

ARCHS = ["qwen3_14b", "paligemma_3b", "phi35_moe", "jamba_v01_52b",
         "xlstm_1_3b", "seamless_m4t_medium"]
DTYPES = ["f32", "bf16", "w8a8"]
B = 4
# (world size, data ways): model = size / data
WORLDS = {2: 1, 4: 2}
EXTRA = {4: [("qwen3_14b", "f32", 2, 3)]}        # rows that do not split
GRAD_TOL = {"f32": 1e-5, "bf16": 8e-2}
LOGIT_TOL = {"f32": 1e-5}                        # of the largest logit
FLOAT_ATOL = 0.1
REF_GRAD_TOL = 3e-4
REF_LOGIT_TOL = 1e-3


def cases(n: int) -> list:
    return [(a, d, WORLDS[n], B) for a in ARCHS for d in DTYPES] \
        + EXTRA.get(n, [])


def caps_inputs():
    spec = default_specs()["edge_tiny@torch"]
    images = {b: spec.images(b, seed=b) for b in (1, 3, 4, 16)}
    xs = [np.random.default_rng(i).normal(0, 10.0 ** i, 300).astype(
        np.float32) for i in range(4)]
    return images, xs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results, the reference's computed meanwhile."""
    ckpt_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    images, xs = caps_inputs()
    got, errs = {}, []

    def run():
        try:
            for n in sorted(WORLDS):
                misc = (ckpt_dir, images, xs) if n == 4 else None
                got[n] = dworld.spawn(ranks.tp_checks, n, timeout_s=240,
                                      deadline_s=600, args=(cases(n), misc))
            got["misc"] = got[4]
        except BaseException as e:          # noqa: BLE001 (re-raised)
            errs.append(e)
    t = threading.Thread(target=run)
    t.start()
    ref = {arch: reference(arch) for arch in ARCHS}
    t.join()
    if errs:
        raise errs[0]
    return got, ref, ckpt_dir, images, xs


def reference(arch: str) -> dict:
    """The reference's unsharded float32 run on the port's seed-0
    weights: loss and gradients of the train batch, prefill logits into
    ranks.ALLOC slots and ranks.STEPS decode steps (its attention and
    conv caches made float32, as the port's are under a float32 tree;
    the reference's default to bf16)."""
    c = rbase.get_config(arch)
    rcfg = rreduced(c, d_model=64, layers=2 if len(c.blocks) == 1
                    else len(c.blocks))
    tcfg = ranks.cfg_of(arch)
    rp = jax.tree.map(jnp.asarray, lm_params_to_reference(
        ranks.full_params(tcfg, "f32")))
    data = ranks.make_batch(tcfg, B)
    tb = {k: jnp.asarray(v.numpy()) for k, v in
          ranks.train_batch(data).items()}
    rm = RT.build_model(rcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: rm.train_loss(p, tb), has_aux=True))(rp)
    pb = {k: v for k, v in tb.items() if k != "targets"}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((RA, "init_attn_cache"),
                          (RMB, "init_mamba_cache")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    dtype=jnp.float32))
        logits, cache = jax.jit(lambda p, b: rm.prefill(p, b, ranks.ALLOC))(
            rp, pb)
        dec = [np.asarray(logits, np.float32)]
        step = jax.jit(rm.decode_step)
        p0 = ranks.decode_pos(tcfg)
        for i in range(ranks.STEPS):
            tok = jnp.asarray(data["toks"][:, ranks.S + i:ranks.S + i + 1])
            out, cache = step(rp, cache, tok, jnp.int32(p0 + i))
            dec.append(np.asarray(out, np.float32))
    return {"loss": float(loss),
            "grads": [np.asarray(g, np.float32)
                      for g in jax.tree_util.tree_leaves(grads)],
            "logits": dec}


def case_of(got, n: int, arch: str, dtype: str, batch: int = B):
    """Every rank's result of one case."""
    i = cases(n).index((arch, dtype, WORLDS[n], batch))
    return [r["cases"][i] for r in got[n]]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def logits_of(c) -> list:
    """[(one-process, meshed)] of make_cell's prefill, the model's
    prefill and every decode step."""
    one, cell, again = c["prefill"]
    return [(one, cell), (one, again)] + list(c["decode"])


ALL = [(n, a, d, b) for n in sorted(WORLDS) for a, d, _, b in cases(n)]
IDS = [f"world{n}-{a}-{d}-B{b}" for n, a, d, b in ALL]


@pytest.mark.parametrize("n,arch,dtype,batch", ALL, ids=IDS)
def test_mesh_gives_the_one_process_results(worlds, n, arch, dtype, batch):
    """The cell on the mesh against the one-process port on every rank:
    the loss and every leaf's gradient, prefill and decode logits, the
    W8A8 exponents; the meshed init equals the one-process init's
    shares."""
    rows = case_of(worlds[0], n, arch, dtype, batch)
    assert len(rows) == n
    for c in rows:
        assert c["init_equal"]
        for one, tp in logits_of(c):
            assert tp.shape == one.shape
            if dtype == "f32":
                assert rel(tp, one) <= LOGIT_TOL["f32"]
            else:
                assert float((tp - one).abs().max()) <= FLOAT_ATOL
        if dtype == "w8a8":
            assert c["quantized_share_equal"]
            e = c["exponents"]
            assert e["products"] > 0
            assert e["mismatched"] <= e["inputs_differing"]
            continue
        one, tp = c["loss"]
        assert abs(tp - one) <= 1e-5 * abs(one)
        assert c["grad_err"] <= GRAD_TOL[dtype]


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_every_rank_holds_its_share_of_the_params(worlds, n):
    """The split leaves are the tree's but the final norm's scale: a
    rank holds 1 / model of them, within 5 % (the uneven shares)."""
    model = n // WORLDS[n]
    for arch in ARCHS:
        for c in case_of(worlds[0], n, arch, "bf16"):
            assert abs(c["local_bytes"] / (c["full_bytes"] / model) - 1) \
                < 0.05, (arch, c["local_bytes"], c["full_bytes"])


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_mesh_equals_the_reference_unsharded(worlds, arch):
    """The world of 2's float32 cell against the reference's unsharded
    run on the same weights."""
    got, ref = worlds[0], worlds[1][arch]
    c = case_of(got, 2, arch, "f32")[0]
    assert abs(c["loss"][1] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert len(c["grads"]) == len(ref["grads"])
    for g, w in zip(c["grads"], ref["grads"]):
        assert g.shape == w.shape
        if np.abs(w).max() == 0:
            assert not g.abs().max()
            continue
        assert rel(g.numpy(), w) <= REF_GRAD_TOL
    tp = [c["prefill"][1]] + [t for _, t in c["decode"]]
    for t, w in zip(tp, ref["logits"]):
        assert rel(t.numpy(), w) <= REF_LOGIT_TOL


def test_functions_backwards_pass_gradcheck(worlds):
    for r in worlds[0]["misc"]:
        assert r["gradcheck"] == {"copy_gather": True, "reduce": True,
                                  "partial_gather": True}


def test_local_shard_and_gather_tree_round_trip(worlds):
    """Shares in index order of each axis's line: 7 over 2 as 4 and 3,
    3 over data x model as 1, 1, 1, 0, 7 over 4 as 2, 2, 2, 1."""
    want = {0: {"a": (5, 4), "b": (1,), "c": (3, 3), "d": (2, 2)},
            1: {"a": (5, 3), "b": (1,), "c": (3, 2), "d": (2, 2)},
            2: {"a": (5, 4), "b": (1,), "c": (3, 3), "d": (2, 2)},
            3: {"a": (5, 3), "b": (0,), "c": (3, 2), "d": (1, 2)}}
    for r in worlds[0]["misc"]:
        lay = r["layout"]
        assert lay["equal"]
        assert {k: v for k, v in lay["shapes"].items() if k != "e"} \
            == want[r["rank"]]
        assert lay["shapes"]["e"] == (4, 4)


def test_checkpoints_cross_between_one_process_and_the_mesh(worlds):
    """A one-process checkpoint restores into every rank's shares bit
    for bit; the meshed save, one file written by rank 0, restores into
    one process as the full state gathered, bit for bit, and within
    float32 rounding of the one-process step; a fault and a resume from
    it equal the uninterrupted meshed run bit for bit."""
    got, _, ckpt_dir, _, _ = worlds
    rows = [r["ckpt"] for r in got["misc"]]
    for c in rows:
        assert c["restored_shares_equal"] and c["local_structs_match"]
        assert c["resume_equal"]
    # the meshed save of step 1, restored here, is the one-process step
    # 1 within float32 rounding of the split sums
    cfg = ranks.cfg_of("qwen3_14b")
    ex = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                  TS.init_train_state(cfg, torch.Generator(), "cpu"))
    step, tree = ckpt.restore_latest(f"{ckpt_dir}/tp2", ex)
    assert step == 1
    one = rows[0]["one_step"]
    assert len(leaves(tree)) == len(one) == len(rows[0]["saved"])
    for a, b in zip(leaves(tree), rows[0]["saved"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(leaves(tree), one):
        assert a.shape == b.shape
        if b.dtype.is_floating_point and b.abs().max() > 0:
            assert rel(a.float().numpy(), b.numpy()) <= 1e-4
        else:
            assert torch.equal(a.to(b.dtype), b)


def test_global_norm_on_the_mesh(worlds):
    for r in worlds[0]["misc"]:
        one, tp = r["ckpt"]["norm"]
        assert abs(tp - one) <= 1e-6 * one


def exact_exp2(x):
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def test_capsnet_paths_on_a_data_and_model_mesh(worlds):
    """EDGE_TINY waves at buckets 1, 3, 4, 16 and two CapsTrainer steps
    on the (data 2, model 2) mesh equal the no-mesh runs bit for bit;
    the ranks of a model line hold the same rows.  compressed_psum sums
    over the BATCH line only: every rank's result is the reference's
    psum over the data axis of the ranks with its model index."""
    got, _, _, images, xs = worlds
    rows = [r["caps"] for r in got["misc"]]
    assert [(c["dp_rank"], c["tp_rank"]) for c in rows] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for c in rows:
        assert all(c["waves"][b] for b in images)
        assert c["train_equal"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RG.jnp, "exp2", exact_exp2)
        for c, r in zip(rows, range(4)):
            line = [xs[r % 2], xs[r % 2 + 2]]
            want = np.asarray(jax.vmap(
                lambda v: RG.compressed_psum(v, "d"), axis_name="d")(
                    jnp.asarray(np.stack(line))))[r // 2]
            assert np.array_equal(c["psum"].numpy(), want)
