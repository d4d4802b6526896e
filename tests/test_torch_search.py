"""The port's search components (repro_torch.search) against the
reference's repro.search, on the CPU.

Weights cross with `repro_torch.convert.params_from_reference`; specs,
plans and candidates cross as JSON.  Two fixtures: an untrained EDGE_TINY
space on the reference's `pipe.init(jax.random.key(0))` params (the
reference test's `tiny_space`), and a short float run of the reference's
own `setup_space` (8 steps), whose trained params, calibration draw and
64-image eval set both packages' objectives score.  Tolerances:

* equal to the reference: `CandidateSpec.key`/`to_json`, `axes()`,
  `plan_to_json` of every built plan, the requantized weights, plancheck
  findings, every `Candidate.to_json()` field but `snr_db`, the
  strategies' evaluation order, `pareto`/`dominates`/`dominated_pairs`,
  `build_doc`, `frontier_table_rows` and the spans' nesting;
* `snr_db` (a float forward against the int8 one): rtol 1e-4.
"""
import copy
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.nn.pipeline import CapsPipeline as RPipeline
from repro.nn.plans import plan_to_json as r_plan_to_json
from repro.obs import Tracer as RTracer
from repro.obs import tracing as r_tracing
from repro.search import STRATEGIES as R_STRATEGIES
from repro.search import CandidateSpec as RSpec
from repro.search import Objective as RObjective
from repro.search import SearchConfig as RSearchConfig
from repro.search import SearchSpace as RSpace
from repro.search import build_doc as r_build_doc
from repro.search import dominated_pairs as r_dominated_pairs
from repro.search import dominates as r_dominates
from repro.search import frontier_table_rows as r_frontier_table_rows
from repro.search import pareto as r_pareto
from repro.search import setup_space as r_setup_space
from repro.search.objective import Candidate as RCandidate
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro_torch.convert import params_from_reference
from repro_torch.nn import EDGE_TINY
from repro_torch.nn.plans import plan_to_json
from repro_torch.obs import Tracer, tracing
from repro_torch.search import (STRATEGIES, Candidate, CandidateSpec,
                                Objective, SearchConfig, SearchSpace,
                                build_doc, dominated_pairs, dominates,
                                frontier_table_rows, pareto)

CPU = "cpu"
RTOL = 1e-4
BUDGET = {"coordinate": 24, "random": 8}
# (per_channel, per_channel_w, softmax, squash): every flag pair at the
# default variants, then every variant pair at per-tensor formats
STRUCTS = [(pc, pcw, "", "") for pc in (False, True) for pcw in (False, True)]
STRUCTS += [(False, False, sm, sq) for sm in ("", "precise", "approx")
            for sq in ("", "approx") if (sm, sq) != ("", "")]
SPEC_CASES = [
    dict(),
    dict(softmax="approx", w_frac_deltas=(("pcap", -2), ("conv0", -1)),
         out_frac_deltas=(("conv0", -1),)),
    dict(softmax="precise", squash="approx", per_channel=True,
         per_channel_w=True, w_frac_deltas=(("caps", -3),),
         out_frac_deltas=(("pcap", -2), ("conv0", -3))),
    dict(per_channel_w=True, w_frac_deltas=[["conv0", 0], ["caps", -1]]),
]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_spec(rspec) -> CandidateSpec:
    return CandidateSpec.from_json(json.loads(json.dumps(rspec.to_json())))


def port_candidate(rc) -> Candidate:
    return Candidate(port_spec(rc.spec), dict(rc.metrics), rc.ok,
                     rc.reject_reason)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    """The reference test's untrained EDGE_TINY space, and the port's on
    the same params and calibration images."""
    params = RPipeline.from_config(R_EDGE_TINY).init(jax.random.key(0))
    calib = np.random.default_rng(0).uniform(
        0, 1, (16, 16, 16, 1)).astype(np.float32)
    return (RSpace(R_EDGE_TINY, params, calib),
            SearchSpace(EDGE_TINY, params_from_reference(to_np(params), CPU),
                        calib))


class Memo:
    """Each package's objectives share their verdicts through one memo
    per package (an Objective still counts its own unique evaluations,
    so a strategy's budget is spent as on a fresh one)."""

    def __init__(self):
        self.cands: dict = {}

    def objective(self, cls, space, st):
        obj = cls(space, st.images, st.labels, rounding="floor",
                  numerics_n=64)
        inner = obj._evaluate

        def memoized(spec):
            if spec.key not in self.cands:
                self.cands[spec.key] = inner(spec)
            return self.cands[spec.key]
        obj._evaluate = memoized
        return obj


@pytest.fixture(scope="module")
def trained():
    """The reference's own setup (8 float steps of EDGE_TINY, its
    calibration draw) and its two strategies' walks; the port's space
    and objective on the converted params and the same images."""
    cfg = RSearchConfig(model="edge_tiny", float_steps=8, eval_n=64,
                        verify_n=2, seed=0)
    rtr = RTracer()
    with r_tracing(rtr):
        st = r_setup_space(cfg)
    rng0 = copy.deepcopy(st.rng)
    space = SearchSpace(
        EDGE_TINY, params_from_reference(to_np(st.space.params), CPU),
        np.array(st.space.calib_images))
    rmemo, pmemo = Memo(), Memo()
    walks = {}
    for name, budget in BUDGET.items():
        robj = rmemo.objective(RObjective, st.space, st)
        R_STRATEGIES[name](st.space, robj, budget, copy.deepcopy(rng0),
                           cfg.acc_tol)
        walks[name] = list(robj.cache.values())
    return dict(cfg=cfg, st=st, rng0=rng0, space=space, walks=walks,
                pmemo=pmemo, setup_tracer=rtr)


# ---------------------------------------------------------------------------
# CandidateSpec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fields", SPEC_CASES)
def test_spec_key_and_json_are_the_references(fields):
    r, p = RSpec(**fields), CandidateSpec(**fields)
    assert p.key == r.key
    assert p.to_json() == r.to_json()
    assert CandidateSpec.from_json(json.loads(json.dumps(p.to_json()))) == p
    assert CandidateSpec.from_json(r.to_json()) == p
    for field in ("w_frac_deltas", "out_frac_deltas"):
        for layer in ("conv0", "pcap", "caps"):
            assert p.delta(field, layer) == r.delta(field, layer)
            for d in (0, -1, -3):
                assert p.with_delta(field, layer, d).key == \
                    r.with_delta(field, layer, d).key
    for kind, names in (("softmax", ("q7", "precise", "approx")),
                        ("squash", ("exact", "approx"))):
        for name in names:
            assert p.with_variant(kind, name).key == \
                r.with_variant(kind, name).key
    for flag in ("per_channel", "per_channel_w"):
        assert p.with_flag(flag, True).key == r.with_flag(flag, True).key


@pytest.mark.parametrize("bad", [dict(w_frac_deltas=(("conv0", -4),)),
                                 dict(out_frac_deltas=(("pcap", 1),)),
                                 dict(softmax="nope"), dict(squash="nope")])
def test_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        RSpec(**bad)
    with pytest.raises(ValueError):
        CandidateSpec(**bad)


# ---------------------------------------------------------------------------
# SearchSpace: axes, plans, weights
# ---------------------------------------------------------------------------
def test_axes_are_the_references(tiny):
    rspace, space = tiny
    assert space.axes() == rspace.axes()
    for kind in ("softmax", "squash"):
        assert space.variant_names(kind) == rspace.variant_names(kind)


@pytest.mark.parametrize("struct", STRUCTS, ids=lambda s: "-".join(
    str(v) or "default" for v in s))
def test_every_plan_and_weight_is_the_references(tiny, struct):
    """Each frac axis at -1, -2 and -3 on one structural pipeline (flags
    x variants): the same plan JSON, a clean plancheck, and the same
    int8 weights."""
    rspace, space = tiny
    pc, pcw, sm, sq = struct
    base = dict(per_channel=pc, per_channel_w=pcw, softmax=sm, squash=sq)
    specs = [base] + [
        dict(base, **{f"{kind}_deltas": ((layer, d),)})
        for kind, layer in space.axes() if kind in ("w_frac", "out_frac")
        for d in (-1, -2, -3)]
    specs.append(dict(base, w_frac_deltas=(("conv0", -1), ("pcap", -2),
                                           ("caps", -3)),
                      out_frac_deltas=(("conv0", -2), ("pcap", -1))))
    for fields in specs:
        plan = space.build_plan(CandidateSpec(**fields))
        assert plan.check() == []
        assert plan_to_json(plan) == \
            r_plan_to_json(rspace.build_plan(RSpec(**fields)))
        qnet = space.build_qnet(CandidateSpec(**fields))
        rq = rspace.build_qnet(RSpec(**fields))
        assert qnet.backend == "torch"
        assert plan_to_json(qnet.plan) == r_plan_to_json(rq.plan)
        for layer, ws in rq.qweights.items():
            for k, w in ws.items():
                np.testing.assert_array_equal(
                    qnet.qweights[layer][k].numpy(), np.asarray(w))


def test_build_qnet_takes_the_backend_asked_for(tiny):
    _, space = tiny
    assert space.backend == "torch"
    assert space.build_qnet(CandidateSpec(), backend="cuda").backend == "cuda"
    assert space.calib_images.device.type == "cpu"


def test_per_out_corruption_findings_are_the_references(tiny):
    """The reference test's tampered per-out plan: the port's
    `PipelinePlan.check` gives the reference's findings."""
    rspace, space = tiny
    spec = dict(per_channel_w=True)
    plans = (space.build_plan(CandidateSpec(**spec)),
             rspace.build_plan(RSpec(**spec)))
    edits = (lambda c: dict(uhat_shift_per_out=tuple(
        s + 1 for s in c.uhat_shift_per_out)),
        lambda c: dict(W_frac_per_out=c.W_frac_per_out[:-1]))
    for edit in edits:
        found = []
        for plan in plans:
            caps = plan["caps"]
            bad = dataclasses.replace(caps, **edit(caps))
            found.append([dataclasses.astuple(d) for d in dataclasses.replace(
                plan, layers={**plan.layers, "caps": bad}).check()])
        assert found[0] == found[1] and found[0]
    assert any("uhat-shift" in f[0] for f in found[0]) or \
        any("per-out-length" in f[0] for f in found[0])


@pytest.mark.parametrize("edit", [("with_softmax", "approx"),
                                  ("with_softmax", "precise"),
                                  ("with_squash", "approx")])
def test_with_softmax_and_with_squash_are_the_references(tiny, edit):
    rspace, space = tiny
    method, impl = edit
    qnet = getattr(space.build_qnet(CandidateSpec()), method)(impl)
    rq = getattr(rspace.build_qnet(RSpec()), method)(impl)
    assert plan_to_json(qnet.plan) == r_plan_to_json(rq.plan)
    assert qnet.plan.check() == []


# ---------------------------------------------------------------------------
# Objective: every candidate of the reference's walks
# ---------------------------------------------------------------------------
def assert_same_candidate(got: dict, want: dict) -> None:
    got, want = copy.deepcopy(got), copy.deepcopy(want)
    g, w = got["metrics"].pop("snr_db", None), want["metrics"].pop(
        "snr_db", None)
    assert (g is None) == (w is None)
    if w is not None:
        assert g == pytest.approx(w, rel=RTOL)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("walk", sorted(BUDGET))
def test_every_candidate_of_the_walk_is_the_references(trained, walk):
    """The port's objective on the same trained params, calibration and
    eval images scores each spec the reference's walk visited exactly as
    the reference did (`snr_db` within rtol 1e-4)."""
    obj = trained["pmemo"].objective(Objective, trained["space"],
                                     trained["st"])
    for rc in trained["walks"][walk]:
        cand = obj.evaluate(port_spec(rc.spec))
        assert_same_candidate(cand.to_json(), rc.to_json())
        for v in cand.metrics.values():
            assert type(v) in (int, float)
    assert obj.evaluations == len(trained["walks"][walk])


def test_the_walks_cover_the_space(trained):
    """What the candidate test covers: rejected and accepted specs, every
    kind of axis."""
    cands = [c for w in trained["walks"].values() for c in w]
    assert any(c.ok for c in cands)
    kinds = {k for c in cands for k, v in c.spec.to_json().items() if v}
    assert {"w_frac_deltas", "softmax"} <= kinds


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("walk", sorted(BUDGET))
def test_strategy_walks_the_references_specs_in_order(trained, walk):
    obj = trained["pmemo"].objective(Objective, trained["space"],
                                     trained["st"])
    STRATEGIES[walk](trained["space"], obj, BUDGET[walk],
                     copy.deepcopy(trained["rng0"]), trained["cfg"].acc_tol)
    assert list(obj.cache) == [c.spec.key for c in trained["walks"][walk]]
    assert 1 < obj.evaluations <= BUDGET[walk]


# ---------------------------------------------------------------------------
# frontier math and the doc
# ---------------------------------------------------------------------------
def synthetic(cls, spec_cls):
    def cand(acc, flash, ram=1, ms=1.0, ok=True):
        return cls(spec_cls(), {"acc": acc, "flash_packed_bytes": flash,
                                "ram_bytes": ram, "est_ms_m7": ms}, ok)
    return [cand(0.9, 100), cand(0.8, 100), cand(0.8, 50), cand(0.9, 100),
            cand(0.99, 10, ok=False), cand(0.85, 60, ram=2),
            cand(0.8, 50, ms=0.5)]


@pytest.mark.parametrize("source", ["synthetic", "coordinate", "random"])
def test_frontier_and_doc_are_the_references(trained, source):
    if source == "synthetic":
        rcands = synthetic(RCandidate, RSpec)
    else:
        rcands = trained["walks"][source]
    cands = [port_candidate(c) for c in rcands]
    front, rfront = pareto(cands), r_pareto(rcands)
    assert [c.to_json() for c in front] == [c.to_json() for c in rfront]
    assert [[dominates(a.metrics, b.metrics) for b in cands] for a in cands] \
        == [[r_dominates(a.metrics, b.metrics) for b in rcands]
            for a in rcands]
    for pts in ([c.to_json() for c in cands], [c.metrics for c in cands]):
        assert dominated_pairs([p for p in pts if "acc" in json.dumps(p)]) \
            == r_dominated_pairs([p for p in pts if "acc" in json.dumps(p)])
    if source == "synthetic":
        return
    ver = {i: {"verified": True, "checked": i % 2 == 0,
               "plan": {"kind": "PipelinePlan", "i": i}}
           for i in range(len(front))}
    config = SearchConfig(model="edge_tiny", float_steps=8, eval_n=64,
                          verify_n=2).to_json()
    assert config == trained["cfg"].to_json()
    doc = build_doc(config, cands[0], cands, front, verification=ver)
    rdoc = r_build_doc(config, rcands[0], rcands, rfront, verification=ver)
    assert json.dumps(doc, sort_keys=True) == json.dumps(rdoc, sort_keys=True)
    doc["float_acc"] = rdoc["float_acc"] = 0.5
    assert [dataclasses.asdict(r) for r in frontier_table_rows(doc)] == \
        [dataclasses.asdict(r) for r in r_frontier_table_rows(rdoc)]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
# the port's own spans: its int8 forward's, one a layer, which the
# reference does not open (tests/test_torch_wave_spans.py pins them)
PORT_SPANS = ("layer.conv0", "layer.pcap", "layer.caps")


def span_tree(span, search_only=True):
    kids = [span_tree(c, search_only) for c in span.children
            if (not search_only or c.name.startswith("search."))
            and c.name not in PORT_SPANS]
    return (span.name, sorted(span.args), kids)


def test_objective_spans_nest_as_the_references(trained):
    """One unique evaluation: `search.candidate` (spec) over
    `search.evaluate`, with the reference's whole subtree under it and
    the port's int8 forward's layer spans beside it; a cached revisit
    opens no span."""
    st = trained["st"]
    rspec = RSpec(per_channel=True, w_frac_deltas=(("caps", -1),))
    robj = RObjective(st.space, st.images, st.labels, numerics_n=16)
    obj = Objective(trained["space"], st.images, st.labels, numerics_n=16)
    rtr, tr = RTracer(), Tracer()
    with r_tracing(rtr):
        robj.evaluate(rspec)
        robj.evaluate(rspec)
    with tracing(tr):
        obj.evaluate(port_spec(rspec))
        obj.evaluate(port_spec(rspec))
    assert [span_tree(r, False) for r in tr.roots] == \
        [span_tree(r, False) for r in rtr.roots]
    (root,) = tr.roots
    assert root.name == "search.candidate"
    assert root.args == {"spec": rspec.key} == rtr.roots[0].args
    assert [c.name for c in root.children] == ["search.evaluate"]
    assert [c.name for c in root.children[0].children
            if c.name in PORT_SPANS] == list(PORT_SPANS)


def test_setup_span_is_the_references(trained):
    """`search.setup` (model, steps) over the float fit, as the
    reference's (the port's own run is in test_torch_search_run.py)."""
    (rroot,) = [r for r in trained["setup_tracer"].roots
                if r.name == "search.setup"]
    assert rroot.args == {"model": "edge_tiny", "steps": 8}
    from repro_torch.search import setup_space
    tr = Tracer()
    with tracing(tr):
        setup_space(SearchConfig(model="edge_tiny", float_steps=2,
                                 eval_n=8, calib_n=8), device=CPU)
    (root,) = [r for r in tr.roots if r.name == "search.setup"]
    assert root.args == {"model": "edge_tiny", "steps": 2}
    assert sorted({c.name for c in root.children}) == \
        sorted({c.name for c in rroot.children})
