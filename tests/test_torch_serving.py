"""The port's serving stack (repro_torch.serving) on the CPU.

Pinned guarantees, as tests/test_serving.py pins them for the reference:
  * engine waves are bit-identical to a direct QuantCapsNet.forward —
    bucket padding cannot perturb real rows;
  * scheduling is deterministic: same submissions -> same waves, buckets
    and bits;
  * a wave that raises leaves its requests queued;
  * the registry builds lazily (once) and reuses wave functions per
    (model, bucket), and its counters show it;
  * a reference-built QuantCapsNet carried across with
    `repro_torch.convert` and served by the port gives the reference
    engine's v_q and pred;
  * a served model exported with `ModelRegistry.export` and installed
    back with `install_artifact` serves the same bits through the
    engine, and a reference-exported artifact installed in the port
    serves the reference engine's bits.

Everything runs on the EDGE_TINY geometry with the `torch` backend.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.nn.plans import plan_to_json as r_plan_to_json
from repro.serving import CapsServeEngine as RCapsServeEngine
from repro.serving import ModelRegistry as RModelRegistry
from repro.serving import ModelSpec as RModelSpec
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro_torch.convert import qnet_from_reference
from repro_torch.launch import serve_caps
from repro_torch.nn import EDGE_TINY, VariantSet
from repro_torch.serving import (CapsServeEngine, ModelRegistry, ModelSpec,
                                 ServeMetrics, default_specs, serve_window,
                                 wave_fn)

MID = "edge_tiny@torch"
BUCKETS = (1, 4, 16)


class FakeClock:
    """Monotone fake clock: every read advances 1 s."""
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def registry():
    return ModelRegistry({MID: default_specs()[MID]}, device="cpu")


@pytest.fixture(scope="module")
def served():
    reg = registry()
    images = reg.specs[MID].images(23, seed=5)
    return reg, reg.model(MID), images


def direct(qnet, images):
    with torch.inference_mode():
        v = qnet.forward(qnet.quantize_input(torch.from_numpy(images)))
        pred = torch.argmax(qnet.class_lengths(v), dim=-1)
    return v.numpy(), pred.numpy()


def test_default_specs_cover_every_config_on_both_backends():
    specs = default_specs()
    assert sorted(specs) == sorted(
        f"{ds}@{be}" for ds in ("mnist", "smallnorb", "cifar10", "edge_tiny")
        for be in ("torch", "cuda"))
    assert specs["mnist@cuda"].backend == "cuda"
    assert specs["edge_tiny@torch"].config == EDGE_TINY
    assert specs["edge_tiny@torch"].dataset == "uniform"


def test_waves_are_bit_identical_to_a_direct_forward(served):
    reg, qnet, images = served
    engine = CapsServeEngine(reg, buckets=BUCKETS)
    engine.submit_many(images, MID)
    done = engine.drain()
    assert [c.rid for c in done] == list(range(len(images)))
    # a wave takes at most the largest bucket and pads to the smallest
    # that fits: 23 = 16 + 7, the 7 padded to 16
    assert [(c.wave, c.bucket) for c in done] == \
        [(0, 16)] * 16 + [(1, 16)] * 7
    v, pred = direct(qnet, images)
    np.testing.assert_array_equal(np.stack([c.v_q for c in done]), v)
    np.testing.assert_array_equal([c.pred for c in done], pred)
    lengths = np.stack([c.lengths for c in done])
    np.testing.assert_array_equal(
        lengths, qnet.class_lengths(torch.from_numpy(v)).numpy())
    assert engine.queue_depth() == 0


def test_bucketing_is_deterministic(served):
    reg, _, images = served
    runs = []
    for _ in range(2):
        engine = CapsServeEngine(reg, buckets=(16, 4, 1), clock=FakeClock())
        for n in (3, 7, 13):
            engine.submit_many(images[:n], MID)
        done = engine.drain()
        runs.append([(c.rid, c.wave, c.bucket, c.v_q.tobytes(), c.pred)
                     for c in done])
    assert runs[0] == runs[1]
    assert engine.buckets == (1, 4, 16)
    assert [engine.bucket_for(n) for n in (1, 2, 4, 5, 16)] == \
        [1, 4, 4, 16, 16]
    with pytest.raises(ValueError):
        engine.bucket_for(17)
    with pytest.raises(ValueError):
        CapsServeEngine(reg, buckets=(0, 4))


def test_a_failing_wave_leaves_the_queue_intact(served):
    reg, qnet, images = served
    reg2 = registry()
    # the cuda backend refuses CPU tensors: every wave raises
    reg2.install(MID, qnet.with_backend("cuda"))
    engine = CapsServeEngine(reg2, buckets=BUCKETS)
    engine.submit_many(images[:6], MID)
    with pytest.raises(NotImplementedError):
        engine.step()
    assert engine.queue_depth() == 6
    assert engine.metrics.waves_run == 0
    reg2.install(MID, qnet)
    done = engine.drain()
    assert [c.rid for c in done] == list(range(6))
    v, _ = direct(qnet, images[:6])
    np.testing.assert_array_equal(np.stack([c.v_q for c in done]), v)


def test_registry_caches_and_counters(served):
    _, qnet, images = served
    reg = registry()
    assert reg.input_shape(MID) == EDGE_TINY.input_shape
    assert reg.quantize_count == 0             # input_shape never builds
    m = reg.model(MID)
    assert reg.model(MID) is m and reg.quantize_count == 1
    e4 = reg.executable(MID, 4)
    assert reg.executable(MID, 4) is e4
    reg.executable(MID, 1)
    assert (reg.compile_count, reg.exec_hits) == (2, 1)
    # install drops the model's wave functions; register drops the model
    reg.install(MID, qnet)
    assert reg.executable(MID, 4) is not e4 and reg.compile_count == 3
    reg.register(reg.specs[MID])
    reg.model(MID)
    assert reg.quantize_count == 2
    with pytest.raises(KeyError, match="unknown model"):
        reg.model("nope@torch")
    with pytest.raises(ValueError, match="wave bound to"):
        wave_fn(qnet, 4)(np.zeros((1,) + EDGE_TINY.input_shape, np.float32))
    engine = CapsServeEngine(reg, buckets=BUCKETS)
    with pytest.raises(KeyError):
        engine.submit(images[0], "nope@torch")
    with pytest.raises(ValueError, match="expects image shape"):
        engine.submit(np.zeros((3, 3, 1), np.float32), MID)


def test_lazy_build_matches_an_explicit_spec_build(served):
    _, qnet, images = served
    built = ModelSpec(MID, EDGE_TINY, dataset="uniform").build("cpu")
    assert built.plan == qnet.plan
    for layer, ws in qnet.qweights.items():
        for name, w in ws.items():
            assert torch.equal(built.qweights[layer][name], w)


def test_reference_model_served_by_the_port_matches_the_reference_engine():
    rspec = RModelSpec("edge_tiny@jnp", R_EDGE_TINY, backend="jnp",
                       dataset="uniform")
    rreg = RModelRegistry({rspec.model_id: rspec})
    rq = rreg.model(rspec.model_id)
    images = rspec.images(11, seed=9)
    rengine = RCapsServeEngine(rreg, buckets=BUCKETS)
    rengine.submit_many(images, rspec.model_id)
    rdone = rengine.drain()

    qnet = qnet_from_reference(
        r_plan_to_json(rq.plan),
        {k: {n: np.asarray(v) for n, v in d.items()}
         for k, d in rq.qweights.items()},
        EDGE_TINY, rounding=rq.rounding, device="cpu")
    reg = ModelRegistry({}, device="cpu")
    reg.install("carried", qnet)
    engine = CapsServeEngine(reg, buckets=BUCKETS)
    engine.submit_many(images, "carried")
    done = engine.drain()
    assert [c.bucket for c in done] == [c.bucket for c in rdone]
    np.testing.assert_array_equal(np.stack([c.v_q for c in done]),
                                  np.stack([c.v_q for c in rdone]))
    assert [c.pred for c in done] == [c.pred for c in rdone]


def test_serve_metrics_on_a_fake_clock(served):
    reg, _, images = served
    engine = CapsServeEngine(reg, buckets=BUCKETS, clock=FakeClock())
    assert engine.metrics.summary()["empty"]
    assert "no completed requests" in engine.metrics.report()
    engine.submit_many(images[:3], MID)
    engine.drain()                        # one wave of 3 in bucket 4
    engine.submit(images[3], MID)
    engine.drain()                        # one wave of 1 in bucket 1
    s = engine.metrics.summary()
    assert (s["images"], s["waves"], s["max_queue_depth"]) == (4, 2, 3)
    assert s["occupancy"] == pytest.approx((3 / 4 + 1 / 1) / 2)
    assert s["images_per_s"] > 0 and s["p99_ms"] >= s["p50_ms"]
    assert "4 imgs in 2 waves" in engine.metrics.report()
    m = ServeMetrics()
    m.record_submit(1.0, 1)
    m.record_wave(bucket=4, n_real=1, exec_s=0.5, t_done=1.0,
                  latencies_s=[0.5])
    assert m.images_per_s() == pytest.approx(2.0)     # zero-width window


def test_serve_window_and_the_cli(served, capsys):
    reg, _, images = served
    engine, done, wall = serve_window(reg, BUCKETS, images[:9], MID)
    assert len(done) == 9 and wall > 0
    assert engine.metrics.images_done == 9
    assert serve_caps.main(["--model", MID, "--requests", "6",
                            "--buckets", "1,4", "--device", "cpu",
                            "--compare-b1"]) == 0
    out = capsys.readouterr().out
    assert "6 imgs in" in out and "batched speedup over b1 loop" in out
    assert "device=cpu" in out


def test_registry_notes_cuda_variant_fallbacks(served):
    """A `cuda` model with non-default variants is listed, counted per
    (model, variant) and warned about once; default variants, the `torch`
    backend and a re-register clear the entry."""
    reg = registry()
    qnet = served[1]
    approx = qnet.with_variants(VariantSet(softmax="approx"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reg.install("x@cuda", approx.with_backend("cuda"))
        reg.install("x@cuda", approx.with_backend("cuda"))
        reg.install("y@torch", approx)
    assert reg.variant_fallbacks == {"x@cuda": "approx+exact"}
    assert reg.fallback_counts == {("x@cuda", "approx+exact"): 2}
    assert [str(w.message).startswith("model 'x@cuda'") for w in caught
            if issubclass(w.category, RuntimeWarning)] == [True]
    reg.install("x@cuda", qnet.with_backend("cuda"))
    assert reg.variant_fallbacks == {}
    reg.install("x@cuda", approx.with_backend("cuda"))
    reg.register(ModelSpec("x@cuda", EDGE_TINY, backend="cuda"))
    assert reg.variant_fallbacks == {}


def test_cli_variant_flags(capsys):
    assert serve_caps.main(["--model", MID, "--requests", "3",
                            "--buckets", "1,4", "--device", "cpu",
                            "--softmax", "approx", "--squash", "approx"]) == 0
    assert "variants=approx+approx" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_caps.main(["--model", MID, "--softmax", "nope"])


def test_an_exported_model_installed_back_serves_the_same_bits(served,
                                                              tmp_path):
    reg, qnet, images = served
    result = reg.export(MID, tmp_path)
    assert result["verified"] == 4 and result["checked"]
    assert result["paths"]["capsbin"].name == "edge_tiny_torch.capsbin"
    other = ModelRegistry({}, device="cpu")
    q2 = other.install_artifact(result["paths"]["capsbin"])
    assert other.has("edge_tiny_torch") and q2.plan == qnet.plan
    outs = []
    for r, mid in ((reg, MID), (other, "edge_tiny_torch")):
        engine = CapsServeEngine(r, buckets=BUCKETS)
        engine.submit_many(images[:9], mid)
        outs.append(engine.drain())
    assert [c.bucket for c in outs[0]] == [c.bucket for c in outs[1]]
    np.testing.assert_array_equal(np.stack([c.v_q for c in outs[0]]),
                                  np.stack([c.v_q for c in outs[1]]))
    assert [c.pred for c in outs[0]] == [c.pred for c in outs[1]]


def test_a_reference_artifact_serves_the_reference_engines_bits(tmp_path):
    rspec = RModelSpec("edge_tiny@jnp", R_EDGE_TINY, backend="jnp",
                       dataset="uniform")
    rreg = RModelRegistry({rspec.model_id: rspec})
    path = rreg.export(rspec.model_id, tmp_path)["paths"]["capsbin"]
    rreg.install_artifact(path, model_id="shipped")
    images = rspec.images(7, seed=4)
    rengine = RCapsServeEngine(rreg, buckets=BUCKETS)
    rengine.submit_many(images, "shipped")
    rdone = rengine.drain()

    reg = ModelRegistry({}, device="cpu")
    reg.install_artifact(path, model_id="shipped")
    engine = CapsServeEngine(reg, buckets=BUCKETS)
    engine.submit_many(images, "shipped")
    done = engine.drain()
    np.testing.assert_array_equal(np.stack([c.v_q for c in done]),
                                  np.stack([c.v_q for c in rdone]))
    assert [c.pred for c in done] == [c.pred for c in rdone]
