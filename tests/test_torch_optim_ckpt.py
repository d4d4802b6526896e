"""The port's optimizers (repro_torch.optim) and checkpoints
(repro_torch.ckpt) against the reference's repro.optim and repro.ckpt,
and the trainer's checkpoint/resume determinism.

* AdamW / SGDM / cosine_schedule on identical gradients (made from a
  NumPy seed): the updated params and moments within rtol 1e-5 and an
  atol of 1e-6 times the leaf's largest magnitude over several steps
  (float32; the bias corrections' pow and the norm's sum may round
  differently), step counters and clip decisions equal.
* Checkpoints cross-load both ways bit-for-bit: a reference-written npz
  restores in the port, a port-written one in the reference.
* The fault protocol: a `.tmp` is ignored, a lost LATEST falls back to
  the scan, gc_keep_n keeps the newest snapshots and the trainer drops
  the orphaned plan side-cars.
* Same-step resume is bit-exact within the port on the CPU, float and
  mid-interval QAT (the plan side-car).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as r_ckpt
from repro.optim import adam as r_adam
from repro_torch import ckpt
from repro_torch.captrain import CapsTrainer, TrainConfig
from repro_torch.convert import state_from_reference, state_to_reference
from repro_torch.nn import EDGE_TINY
from repro_torch.optim import (SGDM, AdamW, clip_by_global_norm,
                               cosine_schedule, global_norm)

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
TINY = TrainConfig(dataset="edge_tiny", batch=32, microbatches=8,
                   calib_n=16, lr=3e-3, recalib_every=4)
SHAPES = {"caps": {"conv0": {"w": (5, 5, 1, 8), "b": (8,)},
                   "caps": {"W": (4, 16, 4, 4)}},
          "dec": {"fc0": {"w": (16, 8), "b": (8,)}}}


def np_tree(rng, scale=1.0):
    return jax.tree.map(lambda s: (rng.normal(0, scale, s))
                        .astype(np.float32), SHAPES,
                        is_leaf=lambda s: isinstance(s, tuple))


def close_trees(ours, theirs):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
            state_to_reference(ours))[0], jax.tree.leaves(theirs)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=ATOL * max(np.abs(b).max(), 1e-30),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("opt_kw", [
    dict(), dict(weight_decay=0.01, clip_norm=0.5),
    dict(lr="cosine", clip_norm=0.0)], ids=["default", "wd_clip", "cosine"])
def test_adamw_matches_the_reference(opt_kw):
    rng = np.random.default_rng(0)
    params = np_tree(rng)
    sched = (cosine_schedule(1e-2, 2, 6), r_adam.cosine_schedule(1e-2, 2, 6))
    kw = dict(opt_kw)
    lr = kw.pop("lr", 1e-2)
    ours = AdamW(lr=sched[0] if lr == "cosine" else lr, **kw)
    theirs = r_adam.AdamW(lr=sched[1] if lr == "cosine" else lr, **kw)
    p = state_from_reference(params, device=CPU)
    s = ours.init(p)
    rp = jax.tree.map(jnp.asarray, params)
    rs = theirs.init(rp)
    for _ in range(5):
        g = np_tree(rng, 0.3)
        p, s, info = ours.update(state_from_reference(g, device=CPU), s, p)
        rp, rs, rinfo = theirs.update(jax.tree.map(jnp.asarray, g), rs, rp)
        close_trees(p, rp)
        close_trees(s["m"], rs["m"])
        close_trees(s["v"], rs["v"])
        assert s["step"].dtype == torch.int32
        assert int(s["step"]) == int(rs["step"])
        np.testing.assert_allclose(float(info["grad_norm"]),
                                   float(rinfo["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(info["lr"]), float(rinfo["lr"]),
                                   rtol=RTOL)


def test_sgdm_schedule_and_clipping_match_the_reference():
    rng = np.random.default_rng(1)
    params = np_tree(rng)
    ours, theirs = SGDM(lr=0.05, clip_norm=1.0), \
        r_adam.SGDM(lr=0.05, clip_norm=1.0)
    p, rp = state_from_reference(params, device=CPU), \
        jax.tree.map(jnp.asarray, params)
    s, rs = ours.init(p), theirs.init(rp)
    for _ in range(3):
        g = np_tree(rng, 2.0)                 # norms above the clip
        p, s, _ = ours.update(state_from_reference(g, device=CPU), s, p)
        rp, rs, _ = theirs.update(jax.tree.map(jnp.asarray, g), rs, rp)
        close_trees(p, rp)
        close_trees(s["m"], rs["m"])
    g = np_tree(rng, 2.0)
    tg, jg = state_from_reference(g, device=CPU), jax.tree.map(jnp.asarray, g)
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(r_adam.global_norm(jg)), rtol=RTOL)
    clipped, norm = clip_by_global_norm(tg, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    close_trees(clipped, r_adam.clip_by_global_norm(jg, 1.0)[0])
    steps = np.arange(0, 12, dtype=np.int32)
    np.testing.assert_allclose(
        cosine_schedule(3e-3, 3, 10)(torch.from_numpy(steps)).numpy(),
        np.asarray(r_adam.cosine_schedule(3e-3, 3, 10)(jnp.asarray(steps))),
        rtol=RTOL)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _train_state(seed=0):
    rng = np.random.default_rng(seed)
    params = np_tree(rng)
    return {"params": params,
            "opt": {"m": np_tree(rng), "v": np_tree(rng, 0.1),
                    "step": np.asarray(7, np.int32)}}


def _example():
    zero = jax.tree.map(np.zeros_like, _train_state())
    return state_from_reference(zero, device=CPU)


def _same(ours, theirs):
    for a, b in zip(jax.tree.leaves(state_to_reference(ours)),
                    jax.tree.leaves(theirs)):
        assert np.asarray(b).dtype == a.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoints_cross_load_both_ways(tmp_path):
    state = _train_state()
    r_ckpt.save(tmp_path / "ref", 7, jax.tree.map(jnp.asarray, state))
    restored = ckpt.restore(tmp_path / "ref", 7, _example())
    _same(restored, state)
    assert restored["opt"]["step"].dtype == torch.int32
    assert restored["opt"]["step"].shape == ()

    ckpt.save(tmp_path / "port", 7, state_from_reference(state, device=CPU))
    with np.load(tmp_path / "port" / "step_00000007.npz") as ours, \
            np.load(tmp_path / "ref" / "step_00000007.npz") as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        assert "params/caps/conv0/w" in ours.files
        assert "opt/step" in ours.files
    back = r_ckpt.restore(tmp_path / "port", 7,
                          jax.tree.map(jnp.asarray, _train_state(1)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_restore_takes_the_examples_dtype_and_layout(tmp_path):
    state = state_from_reference(_train_state(), device=CPU)
    ckpt.save(tmp_path, 3, state)
    example = _example()
    example["params"]["caps"]["conv0"]["b"] = torch.zeros(
        8, dtype=torch.float64)
    out = ckpt.restore(tmp_path, 3, example)
    assert out["params"]["caps"]["conv0"]["b"].dtype == torch.float64
    np.testing.assert_array_equal(
        out["params"]["caps"]["conv0"]["b"].numpy(),
        state["params"]["caps"]["conv0"]["b"].numpy().astype(np.float64))
    assert out["params"]["caps"]["caps"]["W"].device == torch.device(CPU)


def test_ckpt_fault_protocol(tmp_path):
    state = state_from_reference(_train_state(), device=CPU)
    for step in (2, 4, 6):
        ckpt.save(tmp_path, step, state)
    assert ckpt.latest_step(tmp_path) == 6
    # a crash mid-write leaves a .tmp that restore ignores
    (tmp_path / "step_00000008.npz.tmp").write_bytes(b"partial")
    assert ckpt.latest_step(tmp_path) == 6
    # LATEST lost (or pointing at a missing snapshot): scan the snapshots
    (tmp_path / "LATEST").unlink()
    assert ckpt.latest_step(tmp_path) == 6
    (tmp_path / "LATEST").write_text("10")
    assert ckpt.latest_step(tmp_path) == 6
    (tmp_path / "LATEST").write_text("garbage")
    step, restored = ckpt.restore_latest(tmp_path, _example())
    assert step == 6
    _same(restored, _train_state())
    ckpt.gc_keep_n(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000004.npz", "step_00000006.npz"]
    assert not list(tmp_path.glob("*.tmp"))
    assert ckpt.restore_latest(tmp_path / "none", _example()) == (None, None)


def test_trainer_save_drops_orphaned_side_cars(tmp_path):
    tc = dataclasses.replace(TINY, ckpt_dir=str(tmp_path), ckpt_every=1,
                             ckpt_keep=2)
    trainer = CapsTrainer(EDGE_TINY, tc, device=CPU)
    state, _, _ = trainer.fit(trainer.init_state(), 3, qat=True)
    assert sorted(p.name for p in tmp_path.glob("*.json")) == \
        ["plan_00000002.json", "plan_00000003.json"]
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002.npz", "step_00000003.npz"]
    # a float save at the same step removes that step's stale side-car
    trainer.save(state)
    assert not (tmp_path / "plan_00000003.json").exists()
    with pytest.raises(ValueError, match="ckpt_dir"):
        CapsTrainer(EDGE_TINY, TINY, device=CPU).save(state)


# ---------------------------------------------------------------------------
# same-step resume
# ---------------------------------------------------------------------------
def _leaves(state):
    return jax.tree.leaves(state_to_reference(state))


@pytest.mark.parametrize("qat", [False, True])
def test_resume_same_step_same_loss(qat, tmp_path):
    """Resume from step 2 of a 6-step run (for QAT, inside the interval of
    the plan derived at step 0, so the resumed run must take the side-car
    plan): the loss stream and final state repeat bit for bit."""
    tc = dataclasses.replace(TINY, ckpt_dir=str(tmp_path), ckpt_every=2)
    a = CapsTrainer(EDGE_TINY, tc, device=CPU)
    sa, plan_a, hist_a = a.fit(a.init_state(), 6, qat=qat)

    for step in (4, 6):
        (tmp_path / f"step_{step:08d}.npz").unlink()
    (tmp_path / "LATEST").write_text("2")

    b = CapsTrainer(EDGE_TINY, tc, device=CPU)
    sb, plan_b = b.resume_or_init()
    assert b.step_index(sb) == 2
    if qat:
        assert plan_b is not None and plan_b != plan_a
    else:
        assert plan_b is None
    sb, _, hist_b = b.fit(sb, 4, qat=qat, plan=plan_b)
    assert [h["step"] for h in hist_b] == [3, 4, 5, 6]
    for ha, hb in zip(hist_a[2:], hist_b):
        assert ha == hb
    for la, lb in zip(_leaves(sa), _leaves(sb)):
        np.testing.assert_array_equal(la, lb)


def test_resume_or_init_fresh_when_no_ckpt(tmp_path):
    tc = dataclasses.replace(TINY, ckpt_dir=str(tmp_path / "empty"))
    trainer = CapsTrainer(EDGE_TINY, tc, device=CPU)
    state, plan = trainer.resume_or_init()
    assert trainer.step_index(state) == 0 and plan is None
    for la, lb in zip(_leaves(state), _leaves(trainer.init_state())):
        np.testing.assert_array_equal(la, lb)
