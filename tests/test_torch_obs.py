"""The port's observability layer (repro_torch.obs spans and metrics)
against the reference's (repro.obs), and the counters the port moved
into it.

Pinned, on the CPU:
  * the same span calls under the same fake clock give the same span
    tree and the same Chrome trace-event document in both packages;
    tracing off hands out the one shared NULL_SPAN;
  * the same metric operations give equal `snapshot()`s, views,
    percentiles and summaries (the tiny-sample percentile policy
    included);
  * `CudaBackend.fallbacks` and the serving registry's counts are views
    over metrics registries; `ServeMetrics(registry=)` mirrors into the
    reference's series;
  * a traced EDGE_TINY serving window on the port's `torch` backend
    gives the reference's span tree (names, nesting and args, model ids
    mapped `@torch` <-> `@jnp`), bit-identical to an untraced one;
  * the `cuda` backend on the geometries its kernels took only after
    they were widened (capsule dim 18 or 20, 9 routing iterations)
    calls the kernels' wrappers and counts no fallback; the routing
    wrapper's geometry check takes what the widened kernel takes
    (capsule dim 1..32, 1..16 iterations, u_hat unstaged where a slice
    does not fit shared memory) and raises on the rest; every config
    stages u_hat; a kernel that raises still raises.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.serving import CapsServeEngine as RCapsServeEngine
from repro.serving import ModelRegistry as RModelRegistry
from repro.serving import ModelSpec as RModelSpec
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro.serving import ServeMetrics as RServeMetrics
from repro_torch import obs
from repro_torch.kernels import routing as kroute
from repro_torch.kernels import squash as ksquash
from repro_torch.nn import CIFAR10, EDGE_TINY, MNIST, SMALLNORB, VariantSet
from repro_torch.nn.backend import BACKENDS, CudaBackend, get_backend
from repro_torch.serving import (CapsServeEngine, ModelRegistry, ModelSpec,
                                 ServeMetrics)


class FakeClock:
    """Monotone fake clock: every read advances 1 s."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.fixture(autouse=True)
def _no_ambient_tracer_and_fresh_process_metrics():
    """Every test starts and ends with tracing off in both packages and
    the port's process registry (the cuda backend's counts) empty."""
    obs.set_tracer(None)
    robs.set_tracer(None)
    obs.METRICS.reset()
    yield
    obs.set_tracer(None)
    robs.set_tracer(None)
    obs.METRICS.reset()


# ---------------------------------------------------------------------------
# spans: the same calls give the same tree and the same Chrome document
# ---------------------------------------------------------------------------
def _nested(m):
    tr = m.Tracer(clock=FakeClock())
    with tr.span("serve.wave", bucket=4, model="m") as w:
        with tr.span("serve.bucket"):
            pass
        with tr.span("serve.execute", n_real=3):
            with tr.span("edgevm.run", batch=3):
                pass
        w.note(req_ids="0,1,2", n_real=3)
    return tr


def _forest(m):
    tr = m.Tracer(clock=FakeClock())
    for i in range(3):
        with tr.span("serve.enqueue", req_id=i):
            pass
    with tr.span("a", shape=(2, 3), none=None, flag=True, x=1.5):
        pass
    return tr


def _unwound(m):
    tr = m.Tracer(clock=FakeClock())
    try:
        with tr.span("outer"):
            with tr.span("inner"):
                raise RuntimeError("boom")
    except RuntimeError:
        pass
    with tr.span("after"):
        pass
    return tr


def _open(m):
    tr = m.Tracer(clock=FakeClock())
    outer = tr.span("outer")
    outer.__enter__()
    with tr.span("closed"):
        pass
    return tr                        # "outer" never exits


def _ambient(m):
    tr = m.Tracer(clock=FakeClock())
    with m.tracing(tr):
        with m.span("root", k=1):
            with m.span("child"):
                pass
        with m.span("explicit", tracer=m.Tracer()):
            pass
    return tr


SPAN_SCRIPTS = {"nested": _nested, "forest": _forest, "unwound": _unwound,
                "open": _open, "ambient": _ambient}


def _tree(span):
    return (span.name, dict(span.args), span.t0, span.t1,
            [_tree(c) for c in span.children])


@pytest.mark.parametrize("script", sorted(SPAN_SCRIPTS))
def test_span_trees_and_chrome_docs_equal_the_reference(script, tmp_path):
    port, ref = SPAN_SCRIPTS[script](obs), SPAN_SCRIPTS[script](robs)
    assert [_tree(r) for r in port.roots] == [_tree(r) for r in ref.roots]
    assert port.chrome_trace() == ref.chrome_trace()
    assert port.span_count() == ref.span_count()
    assert port._stack == [] or script == "open"
    a = port.write_chrome_trace(tmp_path / "port" / "t.json")
    b = ref.write_chrome_trace(tmp_path / "ref" / "t.json")
    assert a.read_bytes() == b.read_bytes()
    for name in ("serve.execute", "inner", "child", "edgevm.run"):
        assert len(port.find(name)) == len(ref.find(name))


def test_ambient_span_is_null_when_off():
    assert obs.get_tracer() is None
    s = obs.span("anything", arg=1)
    assert s is obs.NULL_SPAN                    # shared, no allocation
    with s as inner:
        assert inner is obs.NULL_SPAN
    s.note(x=1)
    assert s.find("anything") == []


def test_tracing_scopes_restore_and_explicit_tracer_wins():
    tr, other = obs.Tracer(clock=FakeClock()), obs.Tracer(clock=FakeClock())
    with obs.tracing(tr):
        assert obs.get_tracer() is tr
        with obs.tracing(other):
            assert obs.get_tracer() is other
        assert obs.get_tracer() is tr
        with obs.span("explicit", tracer=other):
            pass
    assert obs.get_tracer() is None
    assert tr.span_count() == 0 and other.span_count() == 1
    with pytest.raises(RuntimeError):
        with obs.tracing(tr):
            raise RuntimeError("boom")
    assert obs.get_tracer() is None
    tr.reset()
    assert tr.roots == [] and tr.span_count() == 0


# ---------------------------------------------------------------------------
# metrics: the same operations give the same snapshot
# ---------------------------------------------------------------------------
def _counters(m):
    reg = m.MetricsRegistry("t")
    c = reg.counter("hits", help="h")
    c.inc(op="a", variant="x")
    c.inc(2, op="a", variant="y")
    c.inc(op="a", variant="x")
    reg.counter("plain").inc(3)
    return reg, [c.value(op="a", variant="x"), c.value(op="never"),
                 c.total(), dict(c.view("op", "variant")),
                 dict(c.view("variant"))]


def _gauges(m):
    reg = m.MetricsRegistry("t")
    g = reg.gauge("depth")
    g.set(3)
    g.set(7, model="m@x")
    return reg, [g.value(), g.value(model="m@x")]


def _histograms(m):
    reg = m.MetricsRegistry("t")
    h = reg.histogram("lat", buckets=(1.0, 2.0, 4.0, 8.0))
    out = [h.percentile(50)]                     # empty: None
    h.observe(3.0, bucket="1")
    out += [h.percentile(50, bucket="1"), h.summary(bucket="1")]
    for v in (0.5, 1.5, 3.0, 5.0):
        h.observe(v)
    out += [h.percentile(p) for p in (50, 95, 99)]
    out += [h.summary(), h.summary(bucket="none"), h.count(), h.sum()]
    d = reg.histogram("default")
    d.observe(0.2)
    d.observe(float("inf"))
    return reg, out + [h.buckets, d.buckets]


def _reset(m):
    reg, _ = _counters(m)
    reg.histogram("h").observe(0.3)
    reg.reset()
    reg.counter("hits").inc(model="again")
    return reg, [reg.names()]


METRIC_SCRIPTS = {"counters": _counters, "gauges": _gauges,
                  "histograms": _histograms, "reset": _reset}


@pytest.mark.parametrize("script", sorted(METRIC_SCRIPTS))
def test_metric_snapshots_equal_the_reference(script):
    (port, pvals), (ref, rvals) = (METRIC_SCRIPTS[script](obs),
                                   METRIC_SCRIPTS[script](robs))
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert json.loads(json.dumps(snap)) == snap           # JSON-safe
    assert pvals == rvals
    assert port.names() == ref.names()


def test_metric_kind_conflicts_and_negative_increments_are_loud():
    for m in (obs, robs):
        reg = m.MetricsRegistry("t")
        c = reg.counter("hits")
        assert reg.counter("hits") is c                   # get-or-create
        with pytest.raises(ValueError):
            reg.gauge("hits")
        with pytest.raises(ValueError):
            c.inc(-1)


def test_series_view_is_counter_shaped():
    c = obs.MetricsRegistry("t").counter("f")
    view = c.view("op", "variant")
    assert not view                                       # falsy when empty
    c.inc(op="squash", variant="approx")
    assert view and view[("squash", "approx")] == 1      # live view
    assert ("routing.squash", "approx") not in view
    assert dict(view) == {("squash", "approx"): 1}
    assert view == {("squash", "approx"): 1}
    assert sum(view.values()) == 1
    assert c.view("op")["squash"] == 1
    with pytest.raises(KeyError):
        view[("routing", "approx")]


# ---------------------------------------------------------------------------
# the counters that became views
# ---------------------------------------------------------------------------
def test_cuda_backend_fallbacks_are_registry_backed():
    be = CudaBackend()                                    # private registry
    assert not be.fallbacks
    with pytest.warns(RuntimeWarning):
        be._fallback("squash", "approx")
    assert be.fallbacks[("squash", "approx")] == 1
    assert be.metrics.counter("cuda.fallback_decisions").total() == 1
    assert be.metrics is not obs.METRICS
    # the BACKENDS singleton records into the process registry
    assert BACKENDS["cuda"].metrics is obs.METRICS
    assert get_backend("cuda").fallbacks._ins is \
        obs.METRICS.counter("cuda.fallback_decisions")


def test_model_registry_counts_are_views():
    spec = ModelSpec("tiny", EDGE_TINY, dataset="uniform", calib_n=4)
    reg = ModelRegistry(specs={"tiny": spec}, device="cpu")
    assert (reg.quantize_count, reg.compile_count, reg.exec_hits) == (0, 0, 0)
    with pytest.raises(AttributeError):                   # read-only views
        reg.quantize_count = 5
    reg.executable("tiny", 1)
    reg.executable("tiny", 1)
    assert (reg.quantize_count, reg.compile_count, reg.exec_hits) == (1, 1, 1)
    assert reg.metrics.counter("serving.quantize_builds") \
        .value(model="tiny") == 1
    snap = reg.metrics.snapshot()
    assert snap["serving.wave_compiles"]["series"][0]["labels"] == {
        "bucket": "1", "model": "tiny"}
    assert snap["serving.wave_cache_hits"]["series"][0]["labels"] == {
        "bucket": "1", "model": "tiny"}
    # a shared registry sees the model registry's counters by name
    shared = obs.MetricsRegistry("run")
    ModelRegistry(specs={"tiny": spec}, device="cpu",
                  metrics=shared).model("tiny")
    assert shared.counter("serving.quantize_builds").total() == 1
    # the variant-fallback counts are a (model, variant) view
    approx = reg.model("tiny").with_variants(VariantSet(softmax="approx"))
    with pytest.warns(RuntimeWarning):
        reg.install("x@cuda", approx.with_backend("cuda"))
    assert reg.fallback_counts == {("x@cuda", "approx+exact"): 1}
    assert reg.metrics.counter("serving.variant_fallbacks").value(
        model="x@cuda", variant="approx+exact") == 1


def test_serve_metrics_mirror_equals_the_reference():
    port_reg, ref_reg = obs.MetricsRegistry("t"), robs.MetricsRegistry("t")
    port, ref = ServeMetrics(registry=port_reg), RServeMetrics(
        registry=ref_reg)
    for m in (port, ref):
        m.record_submit(1.0, 3)
        m.record_submit(1.5, 4)
        m.record_wave(bucket=4, n_real=2, exec_s=0.5, t_done=2.0,
                      latencies_s=[0.5, 1.0])
        m.record_wave(bucket=16, n_real=9, exec_s=0.25, t_done=3.0,
                      latencies_s=[0.01 * i for i in range(9)])
    assert port_reg.snapshot() == ref_reg.snapshot()
    assert port.summary() == ref.summary()
    assert port_reg.counter("serve.requests_total").value(bucket="4") == 2
    assert ServeMetrics().registry is None


# ---------------------------------------------------------------------------
# a traced serving window: the reference's span tree
# ---------------------------------------------------------------------------
def _serve_traced(engine_cls, registry, mid, images):
    tracer = robs.Tracer() if engine_cls is RCapsServeEngine \
        else obs.Tracer()
    m = robs if engine_cls is RCapsServeEngine else obs
    with m.tracing(tracer):
        engine = engine_cls(registry, buckets=(1, 4))
        engine.submit_many(images[:5], mid)
        done = engine.drain()
        engine.submit_many(images[5:], mid)
        done += engine.drain()
    return tracer, done


# the port's own spans inside `serve.execute`, which the reference does
# not open (tests/test_torch_wave_spans.py pins them)
PORT_SPANS = ("wave.h2d", "layer.conv0", "layer.pcap", "layer.caps",
              "serve.d2h")


def _shape(span, mid):
    """A span's name, args (the served model id mapped to "M") and
    children, the port's own spans left out: what the two packages must
    agree on."""
    args = {k: ("M" if v == mid else v) for k, v in span.args.items()}
    return (span.name, args, [_shape(c, mid) for c in span.children
                              if c.name not in PORT_SPANS])


def test_traced_serving_gives_the_references_span_tree():
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (7,) + tuple(EDGE_TINY.input_shape)) \
        .astype(np.float32)
    pmid, rmid = "edge_tiny@torch", "edge_tiny@jnp"
    preg = ModelRegistry(specs={pmid: ModelSpec(
        pmid, EDGE_TINY, dataset="uniform", calib_n=8)}, device="cpu")
    rreg = RModelRegistry(specs={rmid: RModelSpec(
        rmid, R_EDGE_TINY, dataset="uniform", calib_n=8)})
    ptr, pdone = _serve_traced(CapsServeEngine, preg, pmid, images)
    rtr, rdone = _serve_traced(RCapsServeEngine, rreg, rmid, images)
    assert [_shape(r, pmid) for r in ptr.roots] == \
        [_shape(r, rmid) for r in rtr.roots]
    # 7 requests in waves of 4 + 1 (the first burst) and 2
    waves = [r for r in ptr.roots if r.name == "serve.wave"]
    assert [w.args["req_ids"] for w in waves] == ["0,1,2,3", "4", "5,6"]
    assert [[c.name for c in w.children] for w in waves] == [
        ["serve.bucket", "serve.compile", "serve.execute",
         "serve.complete"]] * 3
    assert [s.name for s in waves[0].find("serving.ptq_build")[0]
            .children] == ["ptq.calibrate", "ptq.plan",
                           "ptq.quantize_weights"]
    assert len(ptr.find("serve.enqueue")) == 7
    assert ptr.chrome_trace()["traceEvents"][0]["name"] == "serve.enqueue"
    assert [(c.rid, c.wave, c.bucket) for c in pdone] == \
        [(c.rid, c.wave, c.bucket) for c in rdone]

    # tracing observes only: an untraced engine serves the same bits,
    # and an explicit engine tracer takes the spans from the ambient one
    engine = CapsServeEngine(preg, buckets=(1, 4))
    engine.submit_many(images, pmid)
    base = engine.drain()
    explicit, ambient = obs.Tracer(), obs.Tracer()
    with obs.tracing(ambient):
        engine = CapsServeEngine(preg, buckets=(1, 4), tracer=explicit)
        engine.submit_many(images, pmid)
        again = engine.drain()
    assert ambient.span_count() == 0
    assert len(explicit.find("serve.wave")) == 2
    # the wave function's spans go to the explicit tracer too
    assert [[c.name for c in e.children]
            for e in explicit.find("serve.execute")] == [list(PORT_SPANS)] * 2
    for a, b, c in zip(base, pdone, again):
        assert np.array_equal(a.v_q, b.v_q) and np.array_equal(a.v_q, c.v_q)
        assert a.pred == b.pred == c.pred


# ---------------------------------------------------------------------------
# the cuda backend on the geometries the widened kernels take
# ---------------------------------------------------------------------------
class CardlessCudaBackend(CudaBackend):
    """CudaBackend whose CUDA check passes, so its decisions can be
    driven with CPU tensors (the kernel wrappers then take CPU tensors to
    their plain versions)."""

    def _require_cuda(self, op, t):
        pass


# edits of EDGE_TINY past the kernels' former limits (capsule dim 16,
# 8 routing iterations)
WIDENED = {"pcap_dim=18": dict(pcap_dim=18), "caps_dim=20": dict(caps_dim=20),
           "routings=9": dict(routings=9)}


def _edge_net(edit):
    cfg = dataclasses.replace(EDGE_TINY, **edit)
    spec = ModelSpec("e", cfg, dataset="uniform", calib_n=8)
    return spec, ModelRegistry(specs={"e": spec}, device="cpu").model("e")


@pytest.mark.parametrize("name", sorted(WIDENED))
def test_widened_geometry_calls_the_kernels_and_counts_no_fallback(
        name, monkeypatch):
    spec, qnet = _edge_net(WIDENED[name])
    cfg = spec.config
    kroute.check_geometry(cfg.num_classes, cfg.num_input_caps, cfg.caps_dim,
                          cfg.routings)
    calls = []
    for mod, fn in ((ksquash, "squash_q7"), (kroute, "routing_q7")):
        def spy(*a, _f=getattr(mod, fn), _n=fn, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    be = CardlessCudaBackend()
    x_q = qnet.quantize_input(torch.from_numpy(spec.images(5, seed=3)))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = qnet.with_backend(be).forward(x_q)
    assert torch.equal(got, qnet.forward(x_q))        # the torch backend
    assert calls == ["squash_q7", "routing_q7"]
    assert dict(be.fallbacks) == {}


@pytest.mark.parametrize("cfg", [MNIST, SMALLNORB, CIFAR10, EDGE_TINY],
                         ids=lambda c: c.name)
def test_every_config_fits_the_kernels_with_u_hat_staged(cfg):
    J, I, O = cfg.num_classes, cfg.num_input_caps, cfg.caps_dim
    kroute.check_geometry(J, I, O, cfg.routings)
    assert 1 <= cfg.pcap_dim <= ksquash.MAX_DIM
    for B in (1, 4, 16, 64):
        assert kroute.stages(J, I, O, kroute.cluster_size(B, J, I, O))


def test_default_edge_tiny_on_the_cuda_backend_counts_nothing():
    spec, qnet = _edge_net({})
    be = CardlessCudaBackend()
    x_q = qnet.quantize_input(torch.from_numpy(spec.images(3, seed=4)))
    assert torch.equal(qnet.with_backend(be).forward(x_q),
                       qnet.forward(x_q))
    assert dict(be.fallbacks) == {}


@pytest.mark.parametrize("geom,takes", [
    ((10, 1152, 32, 3), True), ((10, 1152, 33, 3), False),
    ((4, 16, 4, 16), True), ((4, 16, 4, 17), False),
    ((4, 16, 4, 0), False), ((0, 16, 4, 2), False),
    ((10, 1024, 6, 3), True), ((64, 4096, 16, 2), True),
    ((512, 8192, 16, 3), False)], ids=str)
def test_routing_geometry_check_takes_what_the_kernel_takes(geom, takes):
    if takes:
        kroute.check_geometry(*geom)
    else:
        with pytest.raises(ValueError, match="routing_q7"):
            kroute.check_geometry(*geom)


def test_routing_stages_u_hat_only_where_it_fits():
    assert kroute.stages(10, 1024, 6, 4)
    assert kroute.routing_smem_bytes(10, 40_000, 6, 8) > kroute.SMEM_LIMIT
    assert kroute.cluster_size(64, 10, 40_000, 6) == 8
    assert not kroute.stages(10, 40_000, 6, 8)
    assert kroute.routing_smem_bytes(10, 40_000, 6, 8, staged=False) == \
        2 * 50_000 + 3 * 240
    # (64, 4096, 16): unstaged at 8 CTAs, the logits and couplings fit
    assert not kroute.stages(64, 4096, 16, 8)
    assert kroute.routing_smem_bytes(64, 4096, 16, 8, staged=False) <= \
        kroute.SMEM_LIMIT


def test_a_failing_kernel_still_raises(monkeypatch):
    """Nothing catches what a kernel's build or launch raises: the cuda
    backend never falls back on an error."""
    def broken(*a, **k):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(kroute, "routing_q7", broken)
    monkeypatch.setattr(ksquash, "squash_q7", broken)
    be = CardlessCudaBackend()
    _, qnet = _edge_net({})
    with pytest.raises(RuntimeError, match="kernel build failed"):
        be.squash_q7(torch.zeros((2, 4), dtype=torch.int8), in_frac=5)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        be.routing_q7(torch.zeros((1, 4, 16, 4), dtype=torch.int8),
                      qnet.plan["caps"], rounding="floor")
    assert dict(be.fallbacks) == {}
