"""LM training in the port (`repro_torch.launch.{steps,train}`, the
remat of `models.{transformer,scan_utils}`) against the reference
`repro` on the CPU: the dense, VLM and MoE families here, the SSM,
hybrid and encoder-decoder ones in `test_torch_lm_train_recurrent.py`.

Each family runs a reduced config (d_model 64; a one-block pattern at
two cycles, so the stacked gradients of two cycles are summed, a longer
pattern at one cycle), B 2, S 32, on the reference's own weights
carried across with `convert`.  In float32 (every param leaf cast) the
whole-model gradients of `train_loss` and one full `make_train_step`
step (AdamW, cosine schedule, clipping) are held against the
reference's `jax.value_and_grad` and jitted step at rtol/atol 1e-4 of
each leaf's largest element (measured at most 4e-5, the xLSTM's).  The
port's gradients with remat on equal those with it off bit for bit.

In bf16, the params' own dtype, the step is held at looser bounds: the
two backward passes round their bf16 products in other places (the
reference's XLA program is one fused, rematerialized computation), so
the gradients of the two differ by up to 2-3% of a leaf's largest
element on these archs; the test states its bounds beside the measured
values.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import ckpt as r_ckpt
from repro.configs import base as rbase
from repro.launch import steps as RS
from repro.launch.train import reduced as rreduced
from repro.models import transformer as RT
from repro.optim import grad_compress as RG
from repro_torch import ckpt
from repro_torch.configs import base as tbase
from repro_torch.convert import (lm_params_from_reference,
                                 lm_train_state_from_reference,
                                 lm_train_state_to_reference)
from repro_torch.dist import fault
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTR
from repro_torch.launch.train import reduced as treduced
from repro_torch.models import scan_utils
from repro_torch.models import transformer as TT
from repro_torch.optim.adam import AdamW, cosine_schedule
from repro_torch.optim.grad_compress import EFCompressor, compress
from repro_torch.tree import leaves, tree_map, unflatten

F32_TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
FAMILIES = {"dense": ("stablelm_3b", 32), "vlm": ("paligemma_3b", 32),
            "moe": ("phi35_moe", 32)}


def exact_exp2(x):
    """2^x for integer-valued float x, exactly (from the exponent bits):
    XLA's CPU exp2 is not exact at |x| >= 13."""
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def cycle_layers(cfg) -> int:
    n = len(cfg.blocks)
    return 2 if n == 1 else n


def configs(arch: str):
    """(reference cfg, port cfg), reduced alike."""
    r = rbase.get_config(arch)
    t = tbase.get_config(arch)
    layers = cycle_layers(r)
    return (rreduced(r, d_model=64, layers=layers),
            treduced(t, d_model=64, layers=layers))


def make_batch(cfg, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            0, 1, (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            0, 1, (B, S, cfg.d_model)).astype(np.float32)
    return batch


def as_f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def ref_step(cfg, state, batch, compressor=False):
    """The reference's train step on `state`, jitted: `jax.value_and_grad`
    of its `train_loss` and its `make_optimizer().update`, the body of
    `repro.launch.steps.make_train_step` (which returns no gradients;
    `test_ref_step_is_the_reference_make_train_step` holds the two
    equal).  Returns (loss, grads, new state, metrics).  With
    compressor=True, the EF step of `repro.launch.train` (its exp2 made
    exact by the caller), its `EFCompressor.apply` given the flat list of
    leaves."""
    model = RT.build_model(cfg)
    opt = RS.make_optimizer()
    comp = RG.EFCompressor()

    def fn(state, batch):
        (loss, metrics), g = jax.value_and_grad(
            lambda p: model.train_loss(p, batch), has_aux=True)(
                state["params"])
        dq = g
        if compressor:
            # the reference's apply over flat lists: on the LM tree itself
            # it fails (see test_reference_ef_apply_fails_on_tuple_trees)
            flat, tdef = jax.tree_util.tree_flatten(g)
            dq, new_err = comp.apply(flat, tdef.flatten_up_to(state["err"]))
            dq, new_err = tdef.unflatten(dq), tdef.unflatten(new_err)
        p, o, om = opt.update(dq, state["opt"], state["params"])
        new = {"params": p, "opt": o, "step": state["step"] + 1}
        if compressor:
            new["err"] = new_err
        return loss, g, new, dict(metrics, **om)
    return jax.jit(fn)(state, jax.tree.map(jnp.asarray, batch))


def ref_state(cfg, dtype, key: int = 0, compressor=False):
    p = RT.build_model(cfg).init(jax.random.key(key))
    if dtype == "f32":
        p = as_f32(p)
    st = {"params": p, "opt": RS.make_optimizer().init(p),
          "step": jnp.zeros((), jnp.int32)}
    if compressor:
        st["err"] = RG.EFCompressor().init(p)
    return st


def family_case(arch: str, S: int, dtypes=("f32",)) -> dict:
    """The reference's side of one family: per dtype its state, the
    batch, and its step's outputs."""
    rcfg, tcfg = configs(arch)
    batch = make_batch(rcfg, S)
    out = {"rcfg": rcfg, "tcfg": tcfg, "batch": batch}
    for dt in dtypes:
        st = ref_state(rcfg, dt)
        loss, g, new, metrics = ref_step(rcfg, st, batch)
        out[dt] = {"state": np_tree(st), "loss": float(loss),
                   "grads": np_tree(g), "new": np_tree(new),
                   "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


def port_state(np_state):
    return lm_train_state_from_reference(np_state, "cpu")


def ref_leaves(tree) -> list:
    """(key string, NumPy leaf) in the reference's flattening order."""
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def f32(t) -> np.ndarray:
    return t.detach().float().numpy()


def assert_leaves_close(want_tree, got_leaves, rtol, atol, what="",
                        scale_tree=None):
    """Every leaf within rtol/atol of its largest |element| (of the same
    leaf of `scale_tree` when given; zero leaves equal); returns the
    worst relative error."""
    want = ref_leaves(want_tree)
    scales = [np.abs(w).max() for _, w in ref_leaves(
        want_tree if scale_tree is None else scale_tree)]
    assert len(want) == len(got_leaves) == len(scales)
    worst = 0.0
    for (key, w), g, scale in zip(want, got_leaves, scales):
        g = f32(g)
        assert g.shape == w.shape, key
        scale = float(scale)
        if scale == 0:
            assert not np.abs(g).any(), what + key
            continue
        np.testing.assert_allclose(g / scale, w / scale, rtol=rtol,
                                   atol=atol, err_msg=what + key)
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def port_grads(tcfg, np_params, batch):
    params = lm_params_from_reference(np_params, "cpu")
    return TS.loss_and_grads(TT.build_model(tcfg), params,
                             torch_batch(batch))


def check_grads(case):
    c = case["f32"]
    loss, metrics, grads = port_grads(case["tcfg"], c["state"]["params"],
                                      case["batch"])
    np.testing.assert_allclose(float(loss), c["loss"], rtol=1e-5)
    assert float(metrics["loss"]) == float(loss)
    assert_leaves_close(c["grads"], grads, **F32_TOL)


def check_remat_is_exact(case):
    np_params = case["f32"]["state"]["params"]
    _, _, on = port_grads(case["tcfg"], np_params, case["batch"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan_utils, "rematerializing", lambda: False)
        _, _, off = port_grads(case["tcfg"], np_params, case["batch"])
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def check_step(case, dt: str, rtol=1e-4, atol=1e-4, loss_rtol=1e-5,
               gnorm_rtol=1e-5):
    c = case[dt]
    state = port_state(c["state"])
    step = TS.make_train_step(case["tcfg"])
    new, metrics = step(state, torch_batch(case["batch"]))
    assert new is state
    assert int(new["step"]) == 1 and int(new["opt"]["step"]) == 1
    np.testing.assert_allclose(float(metrics["loss"]), c["metrics"]["loss"],
                               rtol=loss_rtol)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               c["metrics"]["grad_norm"], rtol=gnorm_rtol)
    np.testing.assert_allclose(float(metrics["lr"]), c["metrics"]["lr"],
                               rtol=1e-6)
    assert new["params"]["embed"]["table"].dtype == (
        torch.float32 if dt == "f32" else torch.bfloat16)
    worst = {what: assert_leaves_close(c["new"]["opt"][what],
                                       leaves(new["opt"][what]), rtol, atol,
                                       what + ": ") for what in ("m", "v")}
    check_params(c["new"], new, float(metrics["lr"]), dt)
    return worst, new, metrics


def test_ref_step_is_the_reference_make_train_step():
    """`ref_step` gives the state and metrics that the reference's own
    jitted `make_train_step` gives, bit for bit (dense, float32)."""
    arch, S = FAMILIES["dense"]
    rcfg, _ = configs(arch)
    batch = make_batch(rcfg, S)
    st = ref_state(rcfg, "f32")
    _, _, new, metrics = ref_step(rcfg, st, batch)
    want, want_m = jax.jit(RS.make_train_step(rcfg))(
        st, jax.tree.map(jnp.asarray, batch))
    for (key, w), (_, g) in zip(ref_leaves((want, want_m)),
                                ref_leaves((new, metrics))):
        np.testing.assert_array_equal(g, w, key)


def check_params(want, got, lr: float, dt: str) -> None:
    """The params after one step, each element against the reference's.
    At step 1 an element moves by lr * g / (|g| + eps) (+ the decay), a
    few float32 ulps of a weight; where |g| is within ~100 eps of zero
    that direction is ill-conditioned (measured up to 0.29 lr apart on
    the xLSTM).  float32: within 2 ulps + 1e-4 lr where the reference's
    |g| >= 1e-6 (measured 1.3e-5 lr), 2 ulps + lr / 2 elsewhere.  bf16:
    one bf16 ulp + 2 lr (a zero-initialised norm scale moves by
    -lr sign(g), and where g is near 0 its sign may differ)."""
    rows = zip(ref_leaves(want["params"]), leaves(got["params"]),
               ref_leaves(want["opt"]["m"]))
    for (key, w), g, (_, m) in rows:
        g = f32(g)
        if dt == "bf16":
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=2.01 * lr,
                                       err_msg=key)
            continue
        off = np.abs(g - w) - 2 * 2.0 ** -23 * np.abs(w)
        sure = np.abs(m) / 0.1 >= 1e-6           # m = (1 - b1) g at step 1
        assert off[sure].max(initial=0) <= 1e-4 * lr, key
        assert off.max() <= 0.5 * lr, key


@pytest.fixture(scope="module")
def cases():
    return {fam: family_case(arch, S, dtypes=("f32", "bf16")
                             if fam in BF16_FAMILIES else ("f32",))
            for fam, (arch, S) in FAMILIES.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_whole_model_gradients_match_jax_grad(family, cases):
    """`loss_and_grads` (train_loss, autograd through the remat) against
    `jax.value_and_grad` of the reference's, float32 trees, rtol/atol
    1e-4 of each leaf's largest element; the MoE loss holds the router's
    aux term."""
    check_grads(cases[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_on_and_off_give_the_same_gradients(family, cases):
    check_remat_is_exact(cases[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_train_step_matches_the_reference_float32(family, cases):
    """One `make_train_step` step in place against the reference's jitted
    step: loss, grad norm and lr, m and v at rtol/atol 1e-4 of each
    leaf's largest element, the params as `check_params` says."""
    check_step(cases[family], "f32")


# bf16 (the params' own dtype): the worst error over the leaves of m and
# v relative to each leaf's largest element, measured on dense / MoE, and
# the bound held.
BF16_MOMENTS = {"m": 4e-2, "v": 8e-2}    # measured 0.019 and 0.039
BF16_FAMILIES = ("dense", "moe")


@pytest.mark.parametrize("family", BF16_FAMILIES)
def test_one_train_step_matches_the_reference_bf16(family, cases):
    """The same step on the bf16 trees: loss within rtol 2e-3 (the
    forward's bf16 rounding), grad norm within 2e-2, m and v within
    `BF16_MOMENTS` of each leaf's largest element, the params as
    `check_params` says."""
    worst, _, _ = check_step(cases[family], "bf16", rtol=0, atol=2.0,
                             loss_rtol=2e-3, gnorm_rtol=2e-2)
    for what, bound in BF16_MOMENTS.items():
        assert worst[what] <= bound, (what, worst[what])


EF_FLIPS = 4          # measured: 1 of 0.2 M elements


def test_ef_step_matches_the_reference():
    """`make_train_step` with `EFCompressor` (the int8 gradient and its
    error buffer) against `repro.launch.train`'s step with the
    compressor, float32, the reference's exp2 made exact.  The two
    gradients differ by ~1e-6 of their scale, so an element that lies
    within that of a rounding boundary quantizes to the next integer in
    one of them: such flips (at most `EF_FLIPS`, each exactly one
    quantum 2^-e of the dequantized gradient) are counted and left out;
    everywhere else params, m and v agree at rtol/atol 1e-4 of each
    leaf's largest element and the error buffer at 1e-4 of its
    gradient's (the residual's own scale is half a quantum)."""
    arch, S = FAMILIES["dense"]
    rcfg, tcfg = configs(arch)
    batch = make_batch(rcfg, S, seed=3)
    st = ref_state(rcfg, "f32", key=2, compressor=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RG.jnp, "exp2", exact_exp2)
        _, grads, new, metrics = ref_step(rcfg, st, batch, compressor=True)
    state = port_state(np_tree(st))
    assert set(state) == {"params", "opt", "step", "err"}
    _, _, g_port = TS.loss_and_grads(TT.build_model(tcfg), state["params"],
                                     torch_batch(batch))
    step = TS.make_train_step(tcfg, compressor=EFCompressor())
    state, om = step(state, torch_batch(batch))
    np.testing.assert_allclose(float(om["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    new = np_tree(new)
    rows = zip(ref_leaves(grads), g_port, ref_leaves(new["err"]),
               leaves(state["err"]), ref_leaves(new["params"]),
               leaves(state["params"]), ref_leaves(new["opt"]["m"]),
               leaves(state["opt"]["m"]), ref_leaves(new["opt"]["v"]),
               leaves(state["opt"]["v"]))
    flips = 0
    for ((key, gr), gp, (_, er), ep, (_, pr), pp, (_, mr), mp_,
         (_, vr), vp) in rows:
        gp, ep = f32(gp), f32(ep)
        quantum = 2.0 ** -float(compress(torch.from_numpy(gr.copy()))[1])
        d_deq = (gp - ep) - (gr - er)        # err_0 = 0: deq = g - err
        flip = np.abs(d_deq) > quantum / 2
        flips += int(flip.sum())
        np.testing.assert_allclose(np.abs(d_deq[flip]), quantum,
                                   rtol=1e-3, err_msg=key)
        keep = ~flip
        gscale = float(np.abs(gr).max())
        for what, w, g, scale in (
                ("err", er, ep, gscale), ("params", pr, f32(pp), None),
                ("m", mr, f32(mp_), None), ("v", vr, f32(vp), None)):
            scale = scale or float(np.abs(w).max())
            np.testing.assert_allclose(g[keep] / scale, w[keep] / scale,
                                       **F32_TOL, err_msg=what + key)
    assert flips <= EF_FLIPS
    assert any(e.abs().max() > 0 for e in leaves(state["err"]))


@pytest.mark.parametrize("chunk", [37, 1000, 1 << 24])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_in_place_equals_update_at_any_chunk(chunk, clip):
    """`AdamW.update_` run `chunk` elements at a time (leaves of odd
    sizes, bf16 and float32, in dicts and tuples) equals the functional
    `update` bit for bit over three steps, clipped or not, and consumes
    its gradient list."""
    rng = np.random.default_rng(chunk)

    def tree(scale):
        return {"a": torch.from_numpy(rng.normal(0, scale, (7, 129)).astype(
                    np.float32)).bfloat16(),
                "b": (torch.from_numpy(rng.normal(0, scale, (1001,)).astype(
                    np.float32)),
                      {"c": torch.from_numpy(rng.normal(
                          0, scale, (3, 5, 41)).astype(np.float32))})}
    params = tree(0.1)
    opt = AdamW(lr=cosine_schedule(1e-2, 2, 10), weight_decay=0.1,
                   clip_norm=clip)
    p1, s1 = params, opt.init(params)
    p2 = tree_map(lambda t: t.clone(), params)
    s2 = opt.init(p2)
    for _ in range(3):
        grads = tree(3.0)
        p1, s1, m1 = opt.update(grads, s1, p1)
        flat = [g.clone() for g in leaves(grads)]
        m2 = opt.update_(flat, s2, p2, chunk=chunk)
        assert flat == [None] * len(flat)
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for x, y in zip(leaves((p1, s1)), leaves((p2, s2))):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_reference_ef_apply_fails_on_tuple_trees():
    """The reference's `EFCompressor.apply` splits its (deq, err) pairs
    with `is_leaf=isinstance(x, tuple)`, which also takes the LM tree's
    `blocks` tuple for a pair, so on an LM param tree it raises (and
    `repro.launch.train --grad-compress` with it).  The port's walks the
    leaves: the same tree goes through, leaf for leaf as the reference's
    on a flat list."""
    rcfg, tcfg = configs("stablelm_3b")
    p = as_f32(RT.build_model(rcfg).init(jax.random.key(0)))
    comp = RG.EFCompressor()
    with pytest.raises(IndexError):
        comp.apply(p, comp.init(p))
    flat = jax.tree_util.tree_leaves(p)
    want, want_err = comp.apply(flat, comp.init(flat))
    tp = lm_params_from_reference(np_tree(p), "cpu")
    got, got_err = EFCompressor().apply(tp, EFCompressor().init(tp))
    assert isinstance(got["blocks"], tuple)
    for w, g in zip(want + want_err, leaves(got) + leaves(got_err)):
        # exp2 exact in the port, XLA's within 4e-6 of it
        np.testing.assert_allclose(f32(g), np.asarray(w), rtol=4e-6,
                                   atol=1e-9)


def test_in_place_step_equals_the_functional_update():
    """`make_train_step` (AdamW.update_, EFCompressor.apply_ in place)
    against the functional `AdamW.update` / `EFCompressor.apply` on the
    same gradients, bf16 params: bit for bit."""
    arch, S = FAMILIES["moe"]
    rcfg, tcfg = configs(arch)
    np_state = np_tree(ref_state(rcfg, "bf16", key=4, compressor=True))
    batch = torch_batch(make_batch(rcfg, S, seed=5))
    a = port_state(np_state)
    b = port_state(np_state)
    opt = TS.make_optimizer()
    comp = EFCompressor()
    _, _, grads = TS.loss_and_grads(TT.build_model(tcfg), b["params"], batch)
    g_tree, err = comp.apply(unflatten(b["params"], grads), b["err"])
    p, o, om = opt.update(g_tree, b["opt"], b["params"])
    TS.make_train_step(tcfg, opt, comp)(a, batch)
    for x, y in zip(leaves({"params": p, "opt": o, "err": err}),
                    leaves({"params": a["params"], "opt": a["opt"],
                            "err": a["err"]})):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_the_backward_runs_inside_full_bf16_sums():
    """`loss_and_grads` holds `full_bf16_sums` around the backward (and
    the recompute in it), not only around `train_loss`'s forward: a
    backward function sees cuBLAS's reduced-precision bf16 flag off, and
    the caller's setting is restored after."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(torch.backends.cuda.matmul
                        .allow_bf16_reduced_precision_reduction)
            return g * 2

    class Model:
        def train_loss(self, params, batch):
            loss = Probe.apply(params["w"]).sum()
            return loss, {"loss": loss}

    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        _, _, grads = TS.loss_and_grads(Model(), {"w": torch.ones(3)}, {})
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old
    assert seen == [False]
    assert torch.equal(grads[0], torch.full((3,), 2.0))


def test_init_train_state_and_structs_match_the_reference_layout():
    """`init_train_state` / `train_state_structs`: the reference's leaves,
    shapes and dtypes (bf16 params, float32 m and v, int32 steps); the
    structs hold no storage."""
    rcfg, tcfg = configs("stablelm_3b")
    want = jax.eval_shape(lambda k: RS.init_train_state(rcfg, k),
                          jax.random.key(0))
    got = TS.init_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    structs = TS.train_state_structs(tcfg)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    for tree in (got, structs):
        gl = leaves(tree)
        assert len(gl) == len(wl)
        for (path, w), g in zip(wl, gl):
            assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert all(t.device.type == "meta" for t in leaves(structs))
    assert int(got["step"]) == 0 and not got["opt"]["m"]["embed"][
        "table"].any()


def cli(argv, capsys):
    res = TTR.main(argv)
    return res, capsys.readouterr().out


def test_cli_resumes_bit_for_bit(tmp_path, capsys):
    """The CLI on the CPU: 4 steps with a checkpoint every 2, then the
    same command with --steps 6 prints `[resume] from step 4`, and its
    final state equals a straight 6-step run bit for bit (so does the
    last checkpoint it writes)."""
    common = ["--reduce", "--d-model", "64", "--batch", "2", "--seq", "32",
              "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    a = str(tmp_path / "a")
    _, out = cli(common + ["--steps", "4", "--ckpt-dir", a], capsys)
    assert re.findall(r"^step (\d+): loss=\S+ gnorm=\S+ \d+ms", out,
                      re.M) == ["0", "1", "2", "3"]
    resumed, out = cli(common + ["--steps", "6", "--ckpt-dir", a], capsys)
    assert "[resume] from step 4" in out
    assert [r["step"] for r in resumed["log"]] == [4, 5]
    straight, out = cli(common + ["--steps", "6", "--ckpt-dir",
                                  str(tmp_path / "b")], capsys)
    assert "[resume]" not in out
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "LATEST", "step_00000002.npz", "step_00000004.npz",
        "step_00000006.npz"]
    for x, y in zip(leaves(resumed["state"]), leaves(straight["state"])):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(resumed["state"]["step"]) == 6
    assert resumed["log"][-1] == {**straight["log"][-1],
                                  "ms": resumed["log"][-1]["ms"]}
    got = ckpt.restore(a, 6, straight["state"])
    for x, y in zip(leaves(got), leaves(straight["state"])):
        assert torch.equal(x, y)


def fault_before(step: int):
    """`launch.train.make_batch` that raises once, for batch `step`."""
    real = TTR.make_batch
    armed = [True]

    def make_batch(cfg, task, i, batch, device):
        if armed[0] and i == step:
            armed[0] = False
            raise RuntimeError(f"injected fault before step {i}")
        return real(cfg, task, i, batch, device)
    return make_batch


def test_cli_restarts_after_a_fault(tmp_path, capsys, monkeypatch):
    """A fault before step 3 of the first attempt: `run_with_restarts`
    builds the run again, which resumes from the step-2 checkpoint and
    ends where an uninterrupted run ends, bit for bit."""
    monkeypatch.setattr(TTR, "run_with_restarts", functools.partial(
        fault.run_with_restarts, backoff_s=0))
    common = ["--reduce", "--d-model", "64", "--batch", "2", "--seq", "32",
              "--ckpt-every", "2", "--steps", "4", "--device", "cpu",
              "--arch", "paligemma_3b"]
    with monkeypatch.context() as mp:
        mp.setattr(TTR, "make_batch", fault_before(3))
        res = TTR.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "[restart 1/2] RuntimeError: injected fault before step 3" in out
    assert "[resume] from step 2" in out and res["attempts"] == 2
    ref = TTR.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    for x, y in zip(leaves(res["state"]), leaves(ref["state"])):
        assert torch.equal(x, y)


def test_reference_checkpoint_restores_and_continues(tmp_path):
    """A training checkpoint of the reference's LM state restores into the
    port's `ckpt`, in place into a state the port built: the bf16 state
    of the reference's init bit for bit, and a float32 state after one
    reference step, from which one port step matches the reference's
    next step at rtol/atol 1e-4 of each leaf's largest element; the
    port's checkpoint of it restores in the reference, equal."""
    arch, S = FAMILIES["vlm"]
    rcfg, tcfg = configs(arch)
    bf = ref_state(rcfg, "bf16", key=6)
    r_ckpt.save(tmp_path / "bf16", 0, bf)
    port = TS.init_train_state(tcfg, torch.Generator().manual_seed(1), "cpu")
    step, got = ckpt.restore_latest(tmp_path / "bf16", port, into=True)
    assert step == 0 and got is port
    want = ref_leaves(bf)
    for (key, w), g in zip(want, leaves(got)):
        assert np.array_equal(np.asarray(w), f32(g)), key

    batch = make_batch(rcfg, S, seed=9)
    st = ref_state(rcfg, "f32", key=7)
    _, _, st1, _ = ref_step(rcfg, st, batch)
    r_ckpt.save(tmp_path / "ref", 1, st1)
    port = TS.init_train_state(tcfg, torch.Generator().manual_seed(1), "cpu")
    port["params"] = tree_map(lambda t: t.float(), port["params"])
    step, got = ckpt.restore_latest(tmp_path / "ref", port, into=False)
    assert step == 1 and int(got["step"]) == 1
    assert_leaves_close(np_tree(st1), leaves(got), rtol=0, atol=0)
    batch2 = make_batch(rcfg, S, seed=10)
    _, _, st2, _ = ref_step(rcfg, st1, batch2)
    TS.make_train_step(tcfg)(got, torch_batch(batch2))
    want = np_tree(st2)
    assert_leaves_close(want["params"], leaves(got["params"]), **F32_TOL)
    assert_leaves_close(want["opt"]["m"], leaves(got["opt"]["m"]),
                        **F32_TOL)
    assert_leaves_close(want["opt"]["v"], leaves(got["opt"]["v"]),
                        **F32_TOL)
    ckpt.save(tmp_path / "port", 2, got)
    back = r_ckpt.restore(tmp_path / "port", 2, jax.eval_shape(lambda: st2))
    for (key, w), g in zip(ref_leaves(back),
                           leaves(lm_train_state_to_reference(got))):
        np.testing.assert_array_equal(w, np.asarray(g, np.float32), key)
