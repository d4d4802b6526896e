"""The spans inside the port's int8 serving wave, on the CPU (the
`torch` backend, EDGE_TINY and a two-conv edit of it).

Pinned:
  * a traced engine's every `serve.execute` holds exactly `wave.h2d`,
    one `layer.<name>` per layer of the pipeline (arg `kind`, the
    layer's class) and `serve.d2h`, in that order, whether the tracer is
    ambient or the engine's explicit `tracer=` (which then takes every
    span of the wave and leaves the ambient one empty);
  * set-up's `warmup` opens the wave function's spans and no
    `serve.execute`;
  * traced, probed and untraced waves give the same bits;
  * with no tracer and no probe installed, `forward_q7` and the wave
    function call `obs.span` zero times; the layer span names are built
    once per pipeline.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.nn import EDGE_TINY
from repro_torch.obs import numerics as nh
from repro_torch.serving import (CapsServeEngine, ModelRegistry, ModelSpec,
                                 wave_fn)

TWO_CONVS = dataclasses.replace(EDGE_TINY, name="capsnet_edge_tiny2",
                                conv_filters=(4, 8), conv_kernels=(3, 3),
                                conv_strides=(1, 2))
CONFIGS = {"edge_tiny": EDGE_TINY, "two_convs": TWO_CONVS}
KINDS = {"edge_tiny": [("layer.conv0", "QuantConv2D"),
                       ("layer.pcap", "PrimaryCaps"),
                       ("layer.caps", "CapsuleRouting")],
         "two_convs": [("layer.conv0", "QuantConv2D"),
                       ("layer.conv1", "QuantConv2D"),
                       ("layer.pcap", "PrimaryCaps"),
                       ("layer.caps", "CapsuleRouting")]}
MID = "m"


@pytest.fixture(autouse=True)
def _tracing_and_probing_off():
    obs.set_tracer(None)
    nh.set_probe(None)
    yield
    obs.set_tracer(None)
    nh.set_probe(None)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def served(request):
    cfg = CONFIGS[request.param]
    reg = ModelRegistry(specs={MID: ModelSpec(MID, cfg, dataset="uniform",
                                              calib_n=8)}, device="cpu")
    images = np.random.default_rng(11).uniform(
        0, 1, (6,) + tuple(cfg.input_shape)).astype(np.float32)
    reg.model(MID)                      # PTQ outside every test's tracer
    return request.param, reg, images


def _serve(reg, images, tracer=None):
    engine = CapsServeEngine(reg, buckets=(1, 4), tracer=tracer)
    engine.submit_many(images, MID)
    return engine.drain()


def _children(tracer):
    return [[(c.name, c.args.get("kind")) for c in e.children]
            for e in tracer.find("serve.execute")]


def _expected(name):
    return [("wave.h2d", None)] + KINDS[name] + [("serve.d2h", None)]


@pytest.mark.parametrize("how", ["ambient", "explicit"])
def test_execute_holds_h2d_layers_d2h_in_order(served, how):
    name, reg, images = served
    tracer, ambient = obs.Tracer(), obs.Tracer()
    with obs.tracing(tracer if how == "ambient" else ambient):
        _serve(reg, images, tracer=tracer if how == "explicit" else None)
    # waves of 4 and 2
    assert _children(tracer) == [_expected(name)] * 2
    assert ambient.span_count() == 0
    for e in tracer.find("serve.execute"):
        assert all(e.t0 <= c.t0 <= c.t1 <= e.t1 for c in e.children)
        assert all(a.t1 <= b.t0 for a, b in zip(e.children, e.children[1:]))


def test_warmup_opens_the_wave_functions_spans_only(served):
    name, reg, _ = served
    for b in (1, 4):                    # bound outside the tracer
        reg.executable(MID, b)
    tracer = obs.Tracer()
    with obs.tracing(tracer):
        CapsServeEngine(reg, buckets=(1, 4)).warmup(MID)
    assert [(r.name, r.args.get("kind")) for r in tracer.roots] == \
        [e for e in _expected(name) if e[0] != "serve.d2h"] * 2
    assert tracer.find("serve.execute") == []


def test_traced_probed_and_untraced_waves_are_bit_identical(served):
    _, reg, images = served
    base = _serve(reg, images)
    with obs.tracing(obs.Tracer()):
        traced = _serve(reg, images)
    with obs.tracing(obs.Tracer()), nh.probing(nh.NumericsProbe()):
        both = _serve(reg, images)
    for a, b, c in zip(base, traced, both):
        assert np.array_equal(a.v_q, b.v_q) and np.array_equal(a.v_q, c.v_q)
        assert np.array_equal(a.lengths, b.lengths)
        assert np.array_equal(a.lengths, c.lengths)
        assert a.pred == b.pred == c.pred


def test_a_probe_and_a_tracer_together_keep_both(served):
    """Under both, each layer's span opens and the probe still sees the
    layer's output and requantizations."""
    name, reg, images = served
    qnet = reg.model(MID)
    x = qnet.quantize_input(torch.as_tensor(images))
    tracer, probe = obs.Tracer(), nh.NumericsProbe()
    with obs.tracing(tracer), nh.probing(probe), torch.inference_mode():
        qnet.forward(x)
    assert [(r.name, r.args["kind"]) for r in tracer.roots] == KINDS[name]
    with nh.probing(nh.NumericsProbe()) as alone, torch.inference_mode():
        qnet.forward(x)
    assert probe.rows() and probe.rows() == alone.rows()


def test_untraced_unprobed_wave_calls_no_span(served, monkeypatch):
    _, reg, images = served
    qnet = reg.model(MID)
    calls = []
    real = obs.span

    def counting(name, **kw):
        calls.append(name)
        return real(name, **kw)

    monkeypatch.setattr(obs, "span", counting)
    fn = wave_fn(qnet, 4)
    fn(images[:4])
    with torch.inference_mode():
        qnet.forward(qnet.quantize_input(torch.as_tensor(images[:4])))
    assert calls == []
    # the count sees the spans once a tracer is installed
    with obs.tracing(obs.Tracer()):
        fn(images[:4])
    assert calls[0] == "wave.h2d" and calls[1:] == \
        [n for n, _ in qnet.pipeline._layer_spans]


def test_layer_span_names_are_built_once_per_pipeline(served):
    name, reg, _ = served
    pipe = reg.model(MID).pipeline
    assert pipe._layer_spans is pipe._layer_spans
    assert list(pipe._layer_spans) == KINDS[name]
