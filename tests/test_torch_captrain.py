"""The port's training stack (repro_torch.captrain and the fake-quant
faces it trains through) against the reference's repro.captrain.

Weights and train states cross with `repro_torch.convert`
(`state_to_reference` / `state_from_reference`, NumPy leaves); inputs
come from `np.random.default_rng` or the shared synthetic datasets.
Everything runs at EDGE_TINY size on the CPU.  Tolerances:

* bit-identical to the reference: `fake_quant` / `fake_quant_with_fracs`
  forward (both roundings) and their identity gradient; the variants'
  `fq` faces; conv `fwd_fq` (and, within the port, conv `fwd_fq` ==
  dequantized `fwd_q7`); `derive_plan`; `qat_clip_rates`; the
  `train.*` spans and `qat.clip_rate` gauge points; the Table-2 row's
  static columns (MCU latency estimates, flash and RAM bytes);
* the variants' `f32` faces, `margin_loss`, `decoder.loss`, and one
  float or QAT step's loss and gradients: rtol 1e-4, atol 1e-6 (the
  gradients' atol is 1e-6 times the leaf's largest magnitude);
* routing `fwd_fq` and `forward_fq`: within one grid step of the output
  format, on at most 1 % of the elements.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.captrain import CapsTrainer as RTrainer
from repro.captrain import TrainConfig as RTrainConfig
from repro.captrain import losses as r_losses
from repro.captrain import make_train_step as r_make_train_step
from repro.data.synthetic import make_image_dataset
from repro.nn.layers import CapsuleRouting as RCapsuleRouting
from repro.nn.plans import plan_to_json as r_plan_to_json
from repro.nn.variants import REGISTRY as R_REGISTRY
from repro.obs import Tracer as RTracer
from repro.obs import tracing as r_tracing
from repro.quant import int8_ops as r_q
from repro.quant import qformat as r_qf
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro_torch.captrain import (CapsTrainer, TrainConfig, eval_float,
                                  eval_q7, losses, make_train_step,
                                  pairwise_reduce, table2_rows,
                                  tree_pairwise_mean)
from repro_torch.captrain.steps import deterministic_fp32
from repro_torch.convert import (params_from_reference, state_from_reference,
                                 state_to_reference)
from repro_torch.nn import EDGE_TINY
from repro_torch.nn.layers import CapsuleRouting
from repro_torch.nn.plans import plan_to_json
from repro_torch.nn.variants import REGISTRY
from repro_torch.obs import Tracer, tracing
from repro_torch.quant import qformat as qf

CPU = "cpu"
ROUNDINGS = ("floor", "nearest")
TINY = dict(dataset="edge_tiny", batch=32, microbatches=8, calib_n=32,
            lr=3e-3, recalib_every=20)
RTOL, ATOL = 1e-4, 1e-6
VARIANTS = [("softmax", "q7"), ("softmax", "precise"), ("softmax", "approx"),
            ("squash", "exact"), ("squash", "approx")]


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    """A short float + QAT run of the port, and the reference trainer
    holding the same state (carried across)."""
    trainer = CapsTrainer(EDGE_TINY, TrainConfig(**TINY), device=CPU)
    state = trainer.init_state()
    state, _, hist_f = trainer.fit(state, 30)
    qstate, plan, hist_q = trainer.fit(state, 10, qat=True)
    rtrainer = RTrainer(R_EDGE_TINY, RTrainConfig(**TINY))
    return trainer, state, qstate, plan, hist_f, hist_q, rtrainer


# ---------------------------------------------------------------------------
# fake-quant primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_fake_quant_forward_is_the_references_grid(rounding):
    """Bit-identical to the reference's fake_quant, and on the grid
    quantize -> dequantize gives (nearest)."""
    x = np.random.default_rng(0).normal(0, 1.5, (257,)).astype(np.float32)
    for n in (-2, 0, 2, 5, 7, 12):
        got = qf.fake_quant(torch.from_numpy(x), n, rounding).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(r_qf.fake_quant(jnp.asarray(x), n, rounding)))
        if rounding == "nearest":
            np.testing.assert_array_equal(
                got, qf.dequantize(qf.quantize(torch.from_numpy(x), n),
                                   n).numpy())


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_fake_quant_with_fracs_is_the_references_grid(rounding):
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.3, (3, 3, 2, 4)).astype(np.float32)
    q, ns = qf.quantize_per_channel(torch.from_numpy(w), axis=-1)
    got = qf.fake_quant_with_fracs(torch.from_numpy(w), ns, axis=-1,
                                   rounding=rounding).numpy()
    np.testing.assert_array_equal(got, np.asarray(r_qf.fake_quant_with_fracs(
        jnp.asarray(w), np.asarray(ns), axis=-1, rounding=rounding)))
    if rounding == "nearest":
        want = q.numpy().astype(np.float32) * \
            (2.0 ** -ns.numpy().astype(np.float32)).reshape(1, 1, 1, -1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_fake_quant_gradient_is_identity(rounding):
    x = torch.tensor([-3.0, -0.51, 0.0, 0.26, 0.75, 9.9],
                     requires_grad=True)
    qf.fake_quant(x, 7, rounding).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(6, np.float32))
    t = (torch.arange(6, dtype=torch.float32) / 7).requires_grad_(True)
    qf.fake_quant_with_fracs(t.reshape(3, 2), (3, 7), axis=1,
                             rounding=rounding).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones(6, np.float32))


def test_qtensor_round_trip():
    x = torch.tensor([0.5, -0.25, 0.125, 0.0])
    t = qf.qtensor(x)
    r = r_qf.qtensor(jnp.asarray(x.numpy()))
    assert t.n == r.n and t.nbytes == r.nbytes == 4
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(r.q))
    np.testing.assert_array_equal(t.float.numpy(), np.asarray(r.float))


# ---------------------------------------------------------------------------
# variant faces
# ---------------------------------------------------------------------------
def _variant_inputs():
    rng = np.random.default_rng(5)
    b = (rng.integers(-128, 128, (3, 7, 9)) * 2.0 ** -5).astype(np.float32)
    s = rng.normal(0, 1.0, (64, 16, 4)).astype(np.float32)
    return b, s


@pytest.mark.parametrize("kind,name", VARIANTS)
def test_variant_f32_and_fq_faces_agree_with_reference(kind, name):
    """f32 faces within rtol/atol; fq faces bit-identical (their forward
    snaps to the grid the reference's does)."""
    b, s = _variant_inputs()
    ours, theirs = REGISTRY.get(kind, name), R_REGISTRY.get(kind, name)
    if kind == "softmax":
        f32 = ours.f32(torch.from_numpy(b), axis=1).numpy()
        r_f32 = np.asarray(theirs.f32(jnp.asarray(b), axis=1))
        fq = ours.fq(torch.from_numpy(b)).numpy()
        r_fq = np.asarray(theirs.fq(jnp.asarray(b)))
    else:
        f32 = ours.f32(torch.from_numpy(s)).numpy()
        r_f32 = np.asarray(theirs.f32(jnp.asarray(s)))
        fq = ours.fq(torch.from_numpy(s), 7, "floor").numpy()
        r_fq = np.asarray(theirs.fq(jnp.asarray(s), 7, "floor"))
    np.testing.assert_allclose(f32, r_f32, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(fq, r_fq)


def test_softmax_fq_q7_is_within_one_code_of_the_integer_softmax():
    """The "q7" couplings reproduce int8_ops.softmax_q7's powers of two
    (within 1 code of the integer division), as the reference pins."""
    rng = np.random.default_rng(5)
    f = 5
    b_q = rng.integers(-128, 128, (2, 7, 9)).astype(np.int8)
    b = torch.from_numpy(b_q.astype(np.float32) * 2.0 ** -f)
    c_fq = CapsuleRouting._softmax_fq(b, "q7").numpy()
    np.testing.assert_array_equal(
        c_fq, np.asarray(RCapsuleRouting._softmax_fq(jnp.asarray(b.numpy()),
                                                     "q7")))
    c_int = np.asarray(r_q.softmax_q7(jnp.asarray(b_q).swapaxes(1, 2),
                                      in_frac=f)).swapaxes(1, 2)
    assert np.abs(c_fq * 128.0 - c_int).max() <= 1.0


# ---------------------------------------------------------------------------
# layer and pipeline fake-quant faces
# ---------------------------------------------------------------------------
def _carried(trained):
    trainer, state, *_, rtrainer = trained
    rstate = to_jax(state_to_reference(state))
    return trainer, state, rtrainer, rstate


@pytest.mark.parametrize("per_channel", [False, True])
def test_conv_fwd_fq_is_the_dequantized_fwd_q7(per_channel, trained):
    """At EDGE_TINY sizes the int32 conv accumulator is exact in float32,
    so under floor rounding conv fwd_fq reproduces the int8 conv bit for
    bit, and equals the reference's conv fwd_fq."""
    trainer, state, rtrainer, rstate = _carried(trained)
    if per_channel:
        tc = dataclasses.replace(trainer.tcfg, per_channel=True)
        trainer = CapsTrainer(EDGE_TINY, tc, device=CPU)
        rtrainer = RTrainer(R_EDGE_TINY, RTrainConfig(**dict(
            TINY, per_channel=True)))
    plan = trainer.derive_plan(state)
    rplan = rtrainer.derive_plan(rstate)
    assert plan_to_json(plan) == r_plan_to_json(rplan)
    layer, lp = trainer.pipeline.layer("conv0"), plan["conv0"]
    assert lp.per_channel == per_channel
    params = state["params"]["caps"]["conv0"]
    x = trainer.calib_images()[:4]
    y_fq = layer.fwd_fq(params, lp, qf.fake_quant(x, plan.input_frac),
                        rounding="floor").numpy()
    qw = layer.quantize(params, lp)
    y_q7 = layer.fwd_q7(qw, lp, qf.quantize(x, plan.input_frac),
                        rounding="floor").numpy().astype(np.float32)
    np.testing.assert_array_equal(y_fq, y_q7 * 2.0 ** -lp.out_frac)
    r_y = rtrainer.pipeline.layer("conv0").fwd_fq(
        rstate["params"]["caps"]["conv0"], rplan["conv0"],
        r_qf.fake_quant(jnp.asarray(x.numpy()), rplan.input_frac),
        rounding="floor")
    np.testing.assert_array_equal(y_fq, np.asarray(r_y))


def _close_on_grid(got, want, frac: int):
    """Within one grid step 2^-frac everywhere, and equal on all but at
    most 1 % of the elements."""
    d = np.abs(got - want)
    assert d.max() <= 2.0 ** -frac * (1 + 1e-6), d.max()
    assert (d > 0).mean() <= 0.01, (d > 0).mean()


@pytest.mark.parametrize("softmax", ["q7", "precise", "approx"])
def test_routing_fwd_fq_within_one_grid_step(softmax, trained):
    trainer, state, rtrainer, rstate = _carried(trained)
    plan = trainer.derive_plan(state)
    rp = dataclasses.replace(plan["caps"], softmax_impl=softmax)
    params = state["params"]["caps"]
    u, _ = trainer.pipeline.layer("pcap").fwd_f32(
        params["pcap"], trainer.pipeline.layer("conv0").fwd_f32(
            params["conv0"], trainer.calib_images()[:8])[0])
    v = trainer.pipeline.layer("caps").fwd_fq(params["caps"], rp, u)
    r_rp = dataclasses.replace(rtrainer.derive_plan(rstate)["caps"],
                               softmax_impl=softmax)
    r_v = rtrainer.pipeline.layer("caps").fwd_fq(
        rstate["params"]["caps"]["caps"], r_rp, jnp.asarray(u.numpy()))
    _close_on_grid(v.numpy(), np.asarray(r_v), rp.squash_out_frac)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_forward_fq_within_one_grid_step(rounding, trained):
    trainer, state, rtrainer, rstate = _carried(trained)
    plan = trainer.derive_plan(state)
    x = trainer.calib_images()[:16]
    v = trainer.pipeline.forward_fq(state["params"]["caps"], x, plan,
                                    rounding=rounding)
    r_v = rtrainer.pipeline.forward_fq(
        rstate["params"]["caps"], jnp.asarray(x.numpy()),
        rtrainer.derive_plan(rstate), rounding=rounding)
    _close_on_grid(v.numpy(), np.asarray(r_v), plan["caps"].out_frac)


# ---------------------------------------------------------------------------
# losses and decoder
# ---------------------------------------------------------------------------
def test_margin_loss_decoder_and_metrics_agree(trained):
    trainer, state, rtrainer, rstate = _carried(trained)
    x, y = trainer.task.batch(3, 32)
    v = trainer.pipeline.forward(state["params"]["caps"],
                                 torch.from_numpy(x))
    yt = torch.from_numpy(y.astype(np.int64))
    vj, yj = jnp.asarray(v.numpy()), jnp.asarray(y)
    np.testing.assert_allclose(
        float(losses.margin_loss(v, yt, 4)),
        float(r_losses.margin_loss(vj, yj, 4)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(trainer.decoder.loss(state["params"]["dec"], v, yt,
                                   torch.from_numpy(x))),
        float(rtrainer.decoder.loss(rstate["params"]["dec"], vj, yj,
                                    jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses.class_lengths(v).numpy(),
                               np.asarray(r_losses.class_lengths(vj)),
                               rtol=RTOL, atol=ATOL)
    count = losses.accuracy_count(v, yt)
    assert count.dtype == torch.int32
    assert int(count) == int(r_losses.accuracy_count(vj, yj))
    assert float(losses.accuracy(v, yt)) == \
        float(r_losses.accuracy(vj, yj))


# ---------------------------------------------------------------------------
# one step against the reference
# ---------------------------------------------------------------------------
class _GradsOut:
    """An optimizer whose update returns the reduced gradients as the new
    params, so both packages' steps expose their gradients."""

    def update(self, grads, state, params):
        zero = state["step"] * 0
        return grads, {"step": state["step"] + 1}, \
            {"grad_norm": zero, "lr": zero}


@pytest.mark.parametrize("qat", [False, True])
def test_one_step_loss_and_grads_agree_with_reference(qat, trained):
    trainer, state, rtrainer, rstate = _carried(trained)
    plan = trainer.derive_plan(state) if qat else None
    rplan = rtrainer.derive_plan(rstate) if qat else None
    x, y = trainer.task.batch(7, 32)
    kw = dict(num_classes=4, microbatches=8, recon_weight=0.0005)
    step = make_train_step(trainer.pipeline, trainer.decoder, _GradsOut(),
                           plan=plan, **kw)
    grads, m = step({"params": state["params"],
                     "opt": {"step": torch.zeros((), dtype=torch.int32)}},
                    torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    rstep = r_make_train_step(rtrainer.pipeline, rtrainer.decoder,
                              _GradsOut(), plan=rplan, **kw)
    rgrads, rm = rstep({"params": rstate["params"],
                        "opt": {"step": jnp.zeros((), jnp.int32)}},
                       jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=RTOL, atol=ATOL)
    assert float(m["accuracy"]) == float(rm["accuracy"])
    theirs = state_from_reference(
        jax.tree.map(np.asarray, rgrads["params"]), device=CPU)
    for layer in ("caps", "dec"):
        for name, ws in grads["params"][layer].items():
            for k, g in ws.items():
                want = theirs[layer][name][k].numpy()
                np.testing.assert_allclose(
                    g.numpy(), want, rtol=RTOL,
                    atol=ATOL * np.abs(want).max(), err_msg=f"{name}/{k}")


def test_pairwise_reduce_sums_and_validates():
    assert float(pairwise_reduce(torch.arange(8.0))) == 28.0
    m = torch.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(pairwise_reduce(m).numpy(),
                                  m.sum(0).numpy())
    with pytest.raises(ValueError, match="power of two"):
        pairwise_reduce(torch.arange(6.0))
    tree = {"a": torch.ones(4, 2), "b": {"c": torch.arange(4.0)}}
    mean = tree_pairwise_mean(tree, 4)
    assert float(mean["b"]["c"]) == 1.5
    np.testing.assert_array_equal(mean["a"].numpy(), np.ones(2))


def test_step_validates_batch_geometry(trained):
    trainer, state, *_ = trained
    x, y = trainer.task.batch(0, 12)          # 12 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        trainer.train_step(state, x, y)
    with pytest.raises(ValueError, match="power of two"):
        CapsTrainer(EDGE_TINY, TrainConfig(**dict(TINY, microbatches=6)),
                    device=CPU).train_step(state, *trainer.task.batch(0, 30))


def _flags():
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
            b.cudnn.deterministic, b.cudnn.benchmark)


class _FlagSpy:
    """A pipeline wrapper recording the numerics flags while its forward
    and the backward through its output run."""

    def __init__(self, pipeline):
        self.pipeline, self.seen = pipeline, []

    def forward(self, params, x):
        self.seen.append(("forward", _flags()))
        v = self.pipeline.forward(params, x)
        v.register_hook(lambda g: self.seen.append(("backward", _flags())))
        return v


@pytest.mark.parametrize("before", [(True, True, False, True),
                                    (False, False, True, False)])
def test_step_runs_deterministic_fp32_and_restores_flags(before, trained):
    """Forward and backward run with TF32 off and deterministic,
    non-benchmarking cuDNN; every flag is back as it was after the step
    returns (and after a step that raises)."""
    trainer, state, *_ = trained
    b = torch.backends
    old = _flags()
    try:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = before
        spy = _FlagSpy(trainer.pipeline)
        step = make_train_step(spy, None, trainer.opt, num_classes=4,
                               microbatches=2)
        x, y = trainer.task.batch(0, 4)
        step(state, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
        assert [w for w, _ in spy.seen] == ["forward", "backward"] * 2
        assert {f for _, f in spy.seen} == {(False, False, True, False)}
        assert _flags() == before
        with pytest.raises(RuntimeError, match="boom"):
            with deterministic_fp32():
                raise RuntimeError("boom")
        assert _flags() == before
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = old


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------
def test_trainer_needs_a_device_when_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CapsTrainer(EDGE_TINY, TrainConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        table2_rows(EDGE_TINY, TrainConfig(**TINY), float_steps=0,
                    qat_steps=0)


def test_trainer_loss_decreases(trained):
    *_, hist_f, hist_q, _ = trained
    assert hist_f[-1]["loss"] < hist_f[0]["loss"]
    assert hist_f[-1]["step"] == 30
    assert hist_q[-1]["step"] == 40          # QAT continues the counter
    assert all(np.isfinite(h["loss"]) for h in hist_f + hist_q)


def test_init_state_is_seeded_and_has_the_references_layout(trained):
    trainer, state, *_, rtrainer = trained
    a, b = trainer.init_state(), trainer.init_state()

    def layout(tree):
        return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype))
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert layout(state_to_reference(a)) == \
        layout(jax.eval_shape(rtrainer.init_state))
    for pa, pb in zip(jax.tree.leaves(state_to_reference(a)),
                      jax.tree.leaves(state_to_reference(b))):
        np.testing.assert_array_equal(pa, pb)


def test_derive_plan_equals_the_references(trained):
    trainer, _, qstate, *_ = trained
    rtrainer = trained[-1]
    rq = to_jax(state_to_reference(qstate))
    assert plan_to_json(trainer.derive_plan(qstate)) == \
        r_plan_to_json(rtrainer.derive_plan(rq))


def test_calib_images_with_an_explicit_rng_match_the_reference(trained):
    trainer, *_, rtrainer = trained
    t = CapsTrainer(EDGE_TINY, trainer.tcfg, rng=np.random.default_rng(7),
                    device=CPU)
    r = RTrainer(R_EDGE_TINY, rtrainer.tcfg, rng=np.random.default_rng(7))
    for _ in range(2):                       # successive draws agree too
        np.testing.assert_array_equal(t.calib_images().numpy(),
                                      np.asarray(r.calib_images()))


def test_qat_plan_equals_ptq_plan(trained):
    trainer, _, qstate, *_ = trained
    assert trainer.derive_plan(qstate) == trainer.quantize(qstate).plan


def test_qat_model_lowers_and_reverifies(tmp_path, trained):
    from repro_torch.edge import export_artifacts

    trainer, _, qstate, *_ = trained
    for rounding in ROUNDINGS:
        qnet = trainer.quantize(qstate, rounding=rounding)
        result = export_artifacts(
            qnet, tmp_path, stem=f"qat_{rounding}",
            verify_images=trainer.calib_images()[:4].numpy())
        assert result["verified"] == 4


def test_eval_float_and_eval_q7_agree_with_reference(trained):
    trainer, state, rtrainer, rstate = _carried(trained)
    from repro.captrain import eval_float as r_eval_float
    from repro.captrain import eval_q7 as r_eval_q7
    from repro_torch.convert import qnet_from_reference

    images, labels = make_image_dataset("edge_tiny", 48, seed=123)
    acc_f = eval_float(trainer.pipeline, state["params"]["caps"], images,
                       labels)
    assert acc_f == r_eval_float(rtrainer.pipeline, rstate["params"]["caps"],
                                 images, labels)
    assert eval_float(trainer.pipeline, state["params"]["caps"], images,
                      labels, batch=20) == acc_f   # partial batches
    rq = rtrainer.quantize(rstate)
    qnet = qnet_from_reference(
        r_plan_to_json(rq.plan),
        jax.tree.map(np.asarray, rq.qweights), EDGE_TINY, device=CPU)
    acc = eval_q7(qnet, images, labels)
    assert acc == r_eval_q7(rq, images, labels)
    assert eval_q7(qnet, images, labels, batch=10) == acc
    lengths = qnet.class_lengths(qnet.forward(qnet.quantize_input(
        torch.from_numpy(images)))).numpy()
    assert acc == pytest.approx(float((lengths.argmax(-1) == labels).mean()))


# ---------------------------------------------------------------------------
# obs hooks: clip rates, spans, gauges
# ---------------------------------------------------------------------------
def test_qat_clip_rates_equal_the_references(trained):
    """On carried-across weights, with a plan whose input and conv grids
    are 3 bits finer than calibration allows (so that they clip)."""
    trainer, state, rtrainer, rstate = _carried(trained)
    plan = trainer.derive_plan(state)
    rplan = rtrainer.derive_plan(rstate)

    def finer(p):
        conv = dataclasses.replace(p["conv0"],
                                   out_frac=p["conv0"].out_frac + 3)
        return dataclasses.replace(p, input_frac=p.input_frac + 3,
                                   layers={**p.layers, "conv0": conv})
    rates = trainer.qat_clip_rates(state, finer(plan))
    assert rates == rtrainer.qat_clip_rates(rstate, finer(rplan))
    assert rates["input"] > 0 and rates["conv0"] > 0
    assert trainer.qat_clip_rates(state, plan) == \
        rtrainer.qat_clip_rates(rstate, rplan)


def test_fit_spans_and_clip_rate_gauges_equal_the_references():
    """From one carried-across initial state, two float and three QAT
    steps (a recalibration on entry and one at step 4), checkpointing
    every 2 steps: the same spans with the same args in the same tree,
    and the same `qat.clip_rate` series."""
    tc = dict(TINY, recalib_every=4, calib_n=16, ckpt_every=2)

    def run(trainer, state, tracer, ctx):
        with ctx(tracer):
            state, _, _ = trainer.fit(state, 2)
            trainer.fit(state, 3, qat=True)
        return [_span_tree(r) for r in tracer.roots], \
            _gauge_points(trainer.metrics.snapshot())

    import tempfile
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        trainer = CapsTrainer(EDGE_TINY, TrainConfig(**tc, ckpt_dir=a),
                              device=CPU)
        state = trainer.init_state()
        rstate = to_jax(state_to_reference(state))
        ours = run(trainer, state, Tracer(), tracing)
        theirs = run(RTrainer(R_EDGE_TINY, RTrainConfig(**tc, ckpt_dir=b)),
                     rstate, RTracer(), r_tracing)
    assert ours[0] == theirs[0]
    names = [t[0] for t in ours[0]]
    assert names.count("train.step") == 5
    assert names.count("train.recalibrate") == 2
    assert names.count("train.ckpt") == 2
    assert ours[1] == theirs[1]
    assert len(ours[1]) == 8                 # 4 layers x 2 recalibrations


def _span_tree(span):
    return (span.name, tuple(sorted(span.args.items())),
            tuple(_span_tree(c) for c in span.children))


def _gauge_points(snapshot: dict) -> list:
    series = snapshot["qat.clip_rate"]["series"]
    return sorted((tuple(sorted(s["labels"].items())), s["value"])
                  for s in series)


# ---------------------------------------------------------------------------
# the Table-2 harness
# ---------------------------------------------------------------------------
def test_table2_rows_smoke_and_static_columns_equal_the_references():
    """8 float / 4 QAT steps, eval_n=64.  The MCU latency estimates and
    the flash/RAM bytes equal the reference's for a model the reference
    quantizes from the same carried-across weights."""
    from repro.edge import lower as r_lower
    from repro.edge import total_latency_ms as r_total_latency_ms
    from repro.edge.arena import memory_report as r_memory_report
    from repro_torch.captrain import format_rows

    tc = TrainConfig(**TINY)
    (row,) = table2_rows(EDGE_TINY, tc, float_steps=8, qat_steps=4,
                         eval_n=64, roundings=("floor",), device=CPU)
    assert row.name == EDGE_TINY.name and row.rounding == "floor"
    assert row.variant == "q7+exact" and row.source == "ptq"
    for acc in (row.acc_f32, row.acc_ptq, row.acc_qat):
        assert 0.0 <= acc <= 1.0 and (acc * 64) == int(acc * 64)
    assert row.saving_pct >= 70.0
    assert np.isfinite(row.sat_pct) and row.snr_db is not None
    assert "capsnet_edge_tiny" in format_rows([row])

    trainer = CapsTrainer(EDGE_TINY, tc, device=CPU)
    state = trainer.init_state()
    rtrainer = RTrainer(R_EDGE_TINY, RTrainConfig(**TINY))
    rprog = r_lower(rtrainer.quantize(to_jax(state_to_reference(state))))
    assert row.est_ms_m7 == r_total_latency_ms(rprog, "cortex-m7")
    assert row.est_ms_gap8 == r_total_latency_ms(rprog, "gap8")
    mem = r_memory_report(rprog)
    assert (row.flash_bytes, row.ram_bytes) == \
        (int(mem["flash_bytes"]), int(mem["ram_bytes"]))
    params = params_from_reference(
        jax.tree.map(np.asarray, to_jax(state_to_reference(state))
                     ["params"]["caps"]), device=CPU)
    assert trainer.pipeline.param_bytes(params) == \
        rtrainer.pipeline.param_bytes(state_to_reference(state)
                                      ["params"]["caps"])
