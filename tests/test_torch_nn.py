"""The port's typed network (repro_torch.nn) against the reference
(repro.nn) on the same weights.

Weights cross with `repro_torch.convert`: the reference's float params
and its `plan_to_json` + int8 qweights, as NumPy and JSON.  Inputs come
from `np.random.default_rng` or the shared synthetic dataset.

* int8 faces (per-layer `fwd_q7`, `QuantCapsNet.forward`,
  `class_lengths`) are held BIT-EXACT: EDGE_TINY with both roundings,
  per-channel convs, per-out W and all 6 softmax x squash variants,
  against the reference's `jnp` and `pallas` backends; MNIST with floor
  rounding on a 2-image batch against `jnp`.
* float faces (`fwd_f32` taps, calibration maxima) agree within rtol
  1e-5 (float32 on the CPU; the sums run in another order).  Element
  taps near zero are compared with an absolute tolerance of 1e-5 times
  the tap's largest magnitude.
* plans derived from the same stats are equal, and PTQ run by the port
  on the converted params gives the reference's plans and int8 weights.
"""
import collections
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_image_dataset
from repro.nn import CIFAR10 as R_CIFAR10
from repro.nn import MNIST as R_MNIST
from repro.nn import SMALLNORB as R_SMALLNORB
from repro.nn import CapsPipeline as RPipeline
from repro.nn import VariantSet as RVariantSet
from repro.nn import all_variant_sets as r_all_variant_sets
from repro.nn.plans import plan_scalars as r_plan_scalars
from repro.nn.plans import plan_to_json as r_plan_to_json
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro_torch.convert import params_from_reference, qnet_from_reference
from repro_torch.nn import (CIFAR10, EDGE_TINY, MNIST, SMALLNORB, CapsPipeline,
                            VariantSet)
from repro_torch.nn.backend import CudaBackend, TorchBackend, get_backend
from repro_torch.nn.plans import (RoutingPlan, TapStats, plan_from_json,
                                  plan_scalars, plan_to_json)
from repro_torch.nn.variants import REGISTRY, all_variant_sets

ROUNDINGS = ("floor", "nearest")
CPU = "cpu"
# (per_channel convs, per-out routing W)
PLAN_KINDS = {"per_tensor": (False, False), "per_channel": (True, False),
              "per_out": (False, True)}


def np_tree(tree):
    return {k: {n: np.asarray(v) for n, v in d.items()}
            for k, d in tree.items()}


def to_torch(x):
    return torch.from_numpy(np.array(x))


def same(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def port_qnet(rq, cfg, backend="torch"):
    return qnet_from_reference(r_plan_to_json(rq.plan), np_tree(rq.qweights),
                               cfg, rounding=rq.rounding, backend=backend,
                               device=CPU)


def build_ref(cfg, calib, *, per_channel=False, per_channel_w=False,
              rounding="floor", seed=0):
    pipe = RPipeline.from_config(cfg, per_channel=per_channel,
                                 per_channel_w=per_channel_w)
    params = pipe.init(jax.random.key(seed))
    rq = pipe.quantize(params, jnp.asarray(calib), rounding=rounding)
    return pipe, params, rq


@pytest.fixture(scope="module")
def edge():
    rng = np.random.default_rng(0)
    calib = rng.uniform(0, 1, (16,) + EDGE_TINY.input_shape) \
        .astype(np.float32)
    images = rng.uniform(0, 1, (5,) + EDGE_TINY.input_shape) \
        .astype(np.float32)
    built = {kind: build_ref(R_EDGE_TINY, calib, per_channel=pc,
                             per_channel_w=pw)
             for kind, (pc, pw) in PLAN_KINDS.items()}
    return calib, images, built


@pytest.fixture(scope="module")
def mnist():
    calib = make_image_dataset("mnist", 8, seed=1)[0]
    images = make_image_dataset("mnist", 2, seed=2)[0]
    return calib, images, build_ref(R_MNIST, calib)


# ---------------------------------------------------------------------------
# configs, variants, plans
# ---------------------------------------------------------------------------
def test_configs_and_variant_registry_mirror_the_reference():
    for ours, theirs in ((MNIST, R_MNIST), (EDGE_TINY, R_EDGE_TINY)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.num_input_caps == theirs.num_input_caps
    assert [v.tag for v in all_variant_sets()] == \
        [v.tag for v in r_all_variant_sets()]
    assert len(all_variant_sets()) == 6
    with pytest.raises(ValueError, match="registered"):
        VariantSet(softmax="nope")
    with pytest.raises(ValueError, match="registered"):
        RoutingPlan(0, 7, (1,), (7,), (), squash_impl="nope")


def test_plan_json_round_trip_and_scalars(edge):
    for _, _, rq in edge[2].values():
        d = r_plan_to_json(rq.plan)
        plan = plan_from_json(d)
        assert plan_to_json(plan) == d
        assert plan_scalars(plan) == r_plan_scalars(rq.plan)
        assert plan.variants.tag == rq.plan.variants.tag


@pytest.mark.parametrize("cfg_name", ["edge_tiny", "mnist"])
def test_fwd_f32_taps_and_calibration_stats_agree(cfg_name, edge, mnist):
    cfg = EDGE_TINY if cfg_name == "edge_tiny" else MNIST
    calib, images, (rpipe, rparams, rq) = \
        (edge[0], edge[1], edge[2]["per_tensor"]) if cfg_name == "edge_tiny" \
        else mnist
    pipe = CapsPipeline.from_config(cfg)
    params = params_from_reference(np_tree(rparams), device=CPU)
    _, taps = pipe.forward(params, to_torch(images), with_taps=True)
    _, rtaps = rpipe.forward(rparams, jnp.asarray(images), with_taps=True)
    assert set(taps) == set(rtaps)
    for k, t in taps.items():
        want = np.asarray(rtaps[k])
        np.testing.assert_allclose(t.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)
    stats = pipe.calibrate(params, calib, batch=8)
    rstats = rpipe.calibrate(rparams, jnp.asarray(calib), batch=8)
    assert set(stats.max_abs) == set(rstats.max_abs)
    for k, v in rstats.max_abs.items():
        assert stats[k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("kind", sorted(PLAN_KINDS))
def test_plans_from_the_same_stats_are_equal(kind, edge):
    calib, _, built = edge
    rpipe, rparams, rq = built[kind]
    pc, pw = PLAN_KINDS[kind]
    pipe = CapsPipeline.from_config(EDGE_TINY, per_channel=pc,
                                    per_channel_w=pw)
    params = params_from_reference(np_tree(rparams), device=CPU)
    rstats = rpipe.calibrate(rparams, jnp.asarray(calib))
    plan = pipe.plan(params, TapStats(dict(rstats.max_abs)))
    assert plan_to_json(plan) == r_plan_to_json(rq.plan)
    assert pipe.tap_names() == rpipe.tap_names()


@pytest.mark.parametrize("kind", sorted(PLAN_KINDS) + ["mnist"])
def test_ptq_from_converted_params_gives_equal_plans_and_weights(
        kind, edge, mnist):
    if kind == "mnist":
        calib, _, (_, rparams, rq) = mnist
        pipe = CapsPipeline.from_config(MNIST)
    else:
        calib, _, built = edge
        _, rparams, rq = built[kind]
        pc, pw = PLAN_KINDS[kind]
        pipe = CapsPipeline.from_config(EDGE_TINY, per_channel=pc,
                                        per_channel_w=pw)
    params = params_from_reference(np_tree(rparams), device=CPU)
    qnet = pipe.quantize(params, calib)
    assert plan_to_json(qnet.plan) == r_plan_to_json(rq.plan)
    for layer, ws in rq.qweights.items():
        for name, w in ws.items():
            assert qnet.qweights[layer][name].dtype == torch.int8
            same(qnet.qweights[layer][name], w)
    assert qnet.memory_bytes() == rq.memory_bytes()


# ---------------------------------------------------------------------------
# int8 faces, bit-exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("kind", sorted(PLAN_KINDS))
def test_layer_fwd_q7_bit_exact(kind, rounding, edge):
    _, images, built = edge
    rpipe, _, rq = built[kind]
    qnet = port_qnet(rq, EDGE_TINY)
    h = np.asarray(rq.quantize_input(jnp.asarray(images)))
    same(qnet.quantize_input(to_torch(images)), h)
    for rl, l in zip(rpipe.layers, qnet.pipeline.layers):
        assert type(l).__name__ == type(rl).__name__ and l.name == rl.name
        want = np.asarray(rl.fwd_q7(rq.qweights[rl.name], rq.plan[rl.name],
                                    jnp.asarray(h), backend="jnp",
                                    rounding=rounding))
        got = l.fwd_q7(qnet.qweights[l.name], qnet.plan[l.name], to_torch(h),
                       backend="torch", rounding=rounding)
        assert got.dtype == torch.int8
        same(got, want)
        h = want


def _check_forward(qnet, rq, images, backends):
    x_q = qnet.quantize_input(to_torch(images))
    v = qnet.forward(x_q)
    rx = rq.quantize_input(jnp.asarray(images))
    for be in backends:
        rv = rq.with_backend(be).forward(rx)
        same(v, rv)
        same(qnet.class_lengths(v), rq.class_lengths(rv))
    return v


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("variants", [v.tag for v in r_all_variant_sets()])
def test_quantcapsnet_forward_edge_tiny_all_variants(variants, rounding,
                                                     edge):
    _, images, built = edge
    sm, sq = variants.split("+")
    rq = dataclasses.replace(built["per_tensor"][2], rounding=rounding) \
        .with_variants(RVariantSet(softmax=sm, squash=sq))
    qnet = port_qnet(rq, EDGE_TINY)
    assert qnet.variants.tag == variants and qnet.rounding == rounding
    with warnings.catch_warnings():
        # the reference's pallas backend warns once per non-default
        # variant that it falls back to its jnp loop
        warnings.simplefilter("ignore", RuntimeWarning)
        _check_forward(qnet, rq, images, ("jnp", "pallas"))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("kind", ["per_channel", "per_out"])
def test_quantcapsnet_forward_edge_tiny_per_channel_plans(kind, rounding,
                                                          edge):
    _, images, built = edge
    rq = dataclasses.replace(built[kind][2], rounding=rounding)
    qnet = port_qnet(rq, EDGE_TINY)
    pc, pw = PLAN_KINDS[kind]
    assert qnet.pipeline.layer("conv0").per_channel == pc
    assert qnet.pipeline.layer("caps").per_channel == pw
    _check_forward(qnet, rq, images, ("jnp", "pallas"))


def test_quantcapsnet_forward_mnist(mnist):
    _, images, (_, _, rq) = mnist
    qnet = port_qnet(rq, MNIST)
    v = _check_forward(qnet, rq, images, ("jnp",))
    assert tuple(v.shape) == (2, 10, 6)


@pytest.mark.parametrize("name", ["smallnorb", "cifar10"])
def test_quantcapsnet_forward_smallnorb_and_cifar10(name):
    """The paper's other two configs, floor rounding, a 2-image batch,
    against the reference's jnp backend on converted qweights."""
    rcfg, cfg = {"smallnorb": (R_SMALLNORB, SMALLNORB),
                 "cifar10": (R_CIFAR10, CIFAR10)}[name]
    calib = make_image_dataset(name, 8, seed=1)[0]
    images = make_image_dataset(name, 2, seed=2)[0]
    _, _, rq = build_ref(rcfg, calib)
    qnet = port_qnet(rq, cfg)
    v = _check_forward(qnet, rq, images, ("jnp",))
    assert tuple(v.shape) == (2, cfg.num_classes, cfg.caps_dim)


# ---------------------------------------------------------------------------
# the cuda backend: CPU refusal and the counted variant fallback
# ---------------------------------------------------------------------------
class CardlessCudaBackend(CudaBackend):
    """CudaBackend whose CUDA check passes, so its fallback decisions can
    be driven with CPU tensors (its default-variant path then reaches the
    kernel wrappers, which take CPU tensors to their plain versions)."""

    def _require_cuda(self, op, t):
        pass


VARIANT_EDITS = {"softmax_approx": dict(softmax_impl="approx"),
                 "softmax_precise": dict(softmax_impl="precise"),
                 "squash_approx": dict(squash_impl="approx"),
                 "out_frac_6": dict(squash_out_frac=6)}


def test_cuda_backend_refuses_what_its_kernels_do_not_implement(edge):
    """A tensor that is not on a CUDA device is refused for every plan:
    the variant fallback never leaves the card."""
    _, images, built = edge
    rq = built["per_tensor"][2]
    qnet = port_qnet(rq, EDGE_TINY, backend="cuda")
    be = get_backend("cuda")
    assert isinstance(be, CudaBackend)
    x_q = qnet.quantize_input(to_torch(images))
    n0 = sum(be.fallbacks.values())
    with pytest.raises(NotImplementedError, match="CUDA tensors"):
        qnet.forward(x_q)                       # CPU tensors
    s = torch.zeros((4, 4), dtype=torch.int8)
    for impl in (None, "approx"):
        with pytest.raises(NotImplementedError, match="CUDA tensors"):
            be.squash_q7(s, in_frac=5, impl=impl)
    u_hat = torch.zeros((1, 4, 16, 4), dtype=torch.int8)
    plan = qnet.plan["caps"]
    for edit in [{}] + list(VARIANT_EDITS.values()):
        with pytest.raises(NotImplementedError, match="CUDA tensors"):
            be.routing_q7(u_hat, dataclasses.replace(plan, **edit),
                          rounding="floor")
    assert sum(be.fallbacks.values()) == n0     # refusals are not counted
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("pallas")
    assert REGISTRY.default("softmax") == "q7"
    assert REGISTRY.default("squash") == "exact"


@pytest.mark.parametrize("edit", sorted(VARIANT_EDITS))
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_cuda_backend_variant_plans_return_the_torch_backends_result(
        edit, rounding):
    rng = np.random.default_rng(21)
    u_hat = torch.from_numpy(rng.integers(-128, 128, (3, 4, 16, 4))
                             .astype(np.int8))
    plan = dataclasses.replace(
        RoutingPlan(7, 7, (8, 8), (7, 6), (8,)), **VARIANT_EDITS[edit])
    be = CardlessCudaBackend()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = be.routing_q7(u_hat, plan, rounding=rounding)
    want = get_backend("torch").routing_q7(u_hat, plan, rounding=rounding)
    assert torch.equal(got, want)
    assert sum(be.fallbacks.values()) == (0 if edit == "out_frac_6" else 1)


@pytest.mark.parametrize("variants", [v.tag for v in r_all_variant_sets()])
def test_cuda_backend_forward_of_every_variant_equals_the_torch_backend(
        variants, edge):
    _, images, built = edge
    sm, sq = variants.split("+")
    rq = built["per_tensor"][2].with_variants(RVariantSet(softmax=sm,
                                                          squash=sq))
    qnet = port_qnet(rq, EDGE_TINY)
    be = CardlessCudaBackend()
    x_q = qnet.quantize_input(to_torch(images))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = qnet.with_backend(be).forward(x_q)
    assert torch.equal(got, qnet.forward(x_q))
    # one decision per face that has no kernel: squash (primary caps) and
    # the routing loop (its softmax checked first)
    want = {}
    if sq != "exact":
        want[("squash", sq)] = 1
    if sm != "q7":
        want[("routing.softmax", sm)] = 1
    elif sq != "exact":
        want[("routing.squash", sq)] = 1
    assert dict(be.fallbacks) == want


def test_cuda_backend_counts_every_decision_and_warns_once_per_label():
    be = CardlessCudaBackend()
    s = torch.from_numpy(np.random.default_rng(2).integers(
        -128, 128, (6, 4)).astype(np.int8))
    u_hat = torch.zeros((1, 4, 16, 4), dtype=torch.int8)
    plan = RoutingPlan(7, 7, (8, 8), (7, 6), (8,))
    approx = dataclasses.replace(plan, softmax_impl="approx")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            got = be.squash_q7(s, in_frac=5, impl="approx")
            be.routing_q7(u_hat, approx, rounding="floor")
        be.squash_q7(s, in_frac=5)                       # default: kernel
        be.routing_q7(u_hat, plan, rounding="floor")
        be.routing_q7(u_hat, dataclasses.replace(plan, squash_out_frac=6),
                      rounding="floor")                  # uncounted
    assert torch.equal(got, TorchBackend().squash_q7(s, in_frac=5,
                                                     impl="approx"))
    assert be.fallbacks == {("squash", "approx"): 3,
                            ("routing.softmax", "approx"): 3}
    msgs = sorted(str(w.message) for w in caught
                  if issubclass(w.category, RuntimeWarning))
    assert len(msgs) == 2
    assert "squash kernel for variant 'approx'" in msgs[1]
    assert "routing.softmax kernel for variant 'approx'" in msgs[0]
    assert isinstance(get_backend("cuda").fallbacks, collections.Counter)


def test_torch_backend_keeps_logits_format_when_out_frac_is_edited(edge):
    """The agreement shift gains `out_frac - 7` when a plan's squash
    output format is edited, as in the reference's jnp backend."""
    _, images, built = edge
    rq = built["per_tensor"][2]
    caps = dataclasses.replace(rq.plan["caps"], squash_out_frac=6)
    rq6 = dataclasses.replace(rq, plan=dataclasses.replace(
        rq.plan, layers={**rq.plan.layers, "caps": caps}))
    _check_forward(port_qnet(rq6, EDGE_TINY), rq6, images, ("jnp", "pallas"))
