"""The port's search end to end on the CPU: `run_search`, `rebuild_point`
and the two CLIs (`search_caps`, `export_caps --from-search`), with the
doc's shape, its `config` block and the `search.*` spans held against
one run of the reference's `repro.search.run_search` at the reference
test's configuration (EDGE_TINY, coordinate, budget 8, 8 float steps,
64 eval images, 2 verify images, seed 0).

Within the port, one seed gives byte-identical docs (both strategies).
Across packages the float weights differ (each package's own seeded
init), so the walks' contents may differ; their shape may not.
"""
import json

import pytest

from repro.obs import Tracer as RTracer
from repro.obs import tracing as r_tracing
from repro.search import SearchConfig as RSearchConfig
from repro.search import run_search as r_run_search
from repro_torch import analysis
from repro_torch.analysis import Diagnostic
from repro_torch.edge import export_artifacts
from repro_torch.launch import export_caps, search_caps
from repro_torch.nn.plans import plan_to_json
from repro_torch.obs import Tracer, tracing
from repro_torch.search import (SearchConfig, dominated_pairs,
                                frontier_table_rows, load_doc,
                                rebuild_point, run_search, save_doc)

CPU = "cpu"
FIXTURE = dict(model="edge_tiny", strategy="coordinate", budget=8,
               float_steps=8, eval_n=64, verify_n=2, seed=0)


def search_tree(span):
    return (span.name, sorted(span.args),
            [search_tree(c) for c in span.children
             if c.name.startswith("search.")])


def keys(doc) -> dict:
    """The doc's key set, entry by entry kind."""
    return {"doc": sorted(doc), "config": sorted(doc["config"]),
            "baseline": sorted(doc["baseline"]),
            "baseline.metrics": sorted(doc["baseline"]["metrics"]),
            "evaluated": sorted({k for c in doc["evaluated"] for k in c}),
            "frontier": sorted({k for p in doc["frontier"] for k in p})}


@pytest.fixture(scope="module")
def ref():
    rtr = RTracer()
    with r_tracing(rtr):
        doc = r_run_search(RSearchConfig(**FIXTURE))
    return doc, rtr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two traced coordinate runs and two random runs, each saved."""
    d = tmp_path_factory.mktemp("search")
    out = {}
    for name, cfg in (("coordinate", SearchConfig(**FIXTURE)),
                      ("random", SearchConfig(**dict(
                          FIXTURE, strategy="random", budget=6)))):
        for i in range(2):
            tr = Tracer()
            with tracing(tr):
                doc = run_search(cfg, device=CPU)
            path = d / f"{name}{i}.json"
            save_doc(doc, path)
            out[name, i] = dict(doc=doc, path=path, tracer=tr)
    return out


# ---------------------------------------------------------------------------
# run_search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["coordinate", "random"])
def test_run_search_is_byte_identical_per_seed(runs, strategy):
    a, b = runs[strategy, 0], runs[strategy, 1]
    assert a["path"].read_bytes() == b["path"].read_bytes()
    assert len(a["doc"]["evaluated"]) >= 2
    assert a["path"].read_text().endswith("}\n")


def test_the_doc_has_the_references_shape_and_config(runs, ref):
    doc, rdoc = runs["coordinate", 0]["doc"], ref[0]
    assert doc["schema"] == rdoc["schema"] == "repro.search/v1"
    assert doc["config"] == rdoc["config"] == SearchConfig(**FIXTURE).to_json()
    assert keys(doc) == keys(rdoc)
    assert len(doc["evaluated"]) == len(rdoc["evaluated"]) == 8
    assert doc["baseline"] == doc["evaluated"][0]
    for d in (doc, rdoc):        # what the doc claims, in both packages
        assert d["frontier"]
        for p in d["frontier"]:
            assert p["verified"] and p["checked"] and p["plan"]
            assert p["metrics"]["checker_findings"] == 0
        assert dominated_pairs(d["frontier"]) == 0
    for c in doc["evaluated"]:
        for v in c["metrics"].values():
            assert type(v) in (int, float)


def test_the_search_spans_nest_as_the_references(runs, ref):
    tr, rtr = runs["coordinate", 0]["tracer"], ref[1]
    got = [search_tree(r) for r in tr.roots if r.name.startswith("search.")]
    want = [search_tree(r) for r in rtr.roots if r.name.startswith("search.")]
    assert got == want
    assert [r.name for r in tr.roots if r.name.startswith("search.")] == \
        ["search.setup"] + ["search.candidate"] * 8 + ["search.frontier"]
    (setup,) = tr.find("search.setup")
    assert setup.args == {"model": "edge_tiny", "steps": 8}
    (front,) = tr.find("search.frontier")
    assert front.args == {"candidates": 8}
    assert [s.args["spec"] for s in tr.find("search.candidate")] == \
        [json.dumps(c["spec"], sort_keys=True)
         for c in runs["coordinate", 0]["doc"]["evaluated"]]


def test_frontier_table_rows_of_the_ports_doc(runs):
    from repro_torch.captrain import format_rows
    doc = runs["coordinate", 0]["doc"]
    rows = frontier_table_rows(doc)
    assert len(rows) == len(doc["frontier"])
    for r in rows:
        assert r.source == "search" and r.acc_f32 == doc["float_acc"]
        assert r.flash_bytes > 0 and r.ram_bytes > 0
    assert "search" in format_rows(rows)


def test_rebuild_point_matches_the_doc(runs):
    doc = runs["coordinate", 0]["doc"]
    for entry in doc["frontier"]:
        qnet, got, st = rebuild_point(doc, entry["point"], device=CPU)
        assert got is entry
        assert plan_to_json(qnet.plan) == entry["plan"]
        assert qnet.plan.check() == [] and qnet.backend == "torch"
        assert st.float_acc == doc["float_acc"]
    with pytest.raises(ValueError, match="no frontier point"):
        rebuild_point(doc, 10_000, device=CPU)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def test_search_caps_writes_the_doc(tmp_path, capsys):
    out = tmp_path / "doc.json"
    rc = search_caps.main(["--model", "edge_tiny", "--budget", "4",
                           "--float-steps", "4", "--eval-n", "32",
                           "--out", str(out), "--seed", "1",
                           "--device", CPU])
    assert rc == 0
    doc = load_doc(out)
    assert doc["frontier"] and doc["config"]["seed"] == 1
    assert "frontier points" in capsys.readouterr().out
    assert search_caps.main(["--model", "nope", "--out", str(out),
                             "--device", CPU]) == 2


def test_export_from_search_writes_the_rebuilt_points_bytes(runs, tmp_path):
    doc, path = runs["coordinate", 0]["doc"], runs["coordinate", 0]["path"]
    out = tmp_path / "export"
    rc = export_caps.main(["--from-search", str(path), "--point", "0",
                           "--out", str(out), "--verify-n", "2",
                           "--device", CPU])
    assert rc == 0
    (capsbin,) = out.glob("*.capsbin")
    assert capsbin.name == "edge_tiny_p0.capsbin"
    qnet, _, _ = rebuild_point(doc, 0, device=CPU)
    want = export_artifacts(qnet, tmp_path / "direct", stem="edge_tiny_p0")
    assert capsbin.read_bytes() == want["paths"]["capsbin"].read_bytes()


@pytest.mark.parametrize("fault", ["point", "schema", "plan", "missing"])
def test_export_from_search_refuses_a_bad_doc(runs, tmp_path, fault):
    doc = json.loads(runs["coordinate", 0]["path"].read_text())
    point = "0"
    if fault == "point":
        point = "10000"
    elif fault == "schema":
        doc["schema"] = "repro.search/v0"
    elif fault == "plan":
        doc["frontier"][0]["plan"]["input_frac"] += 1
    bad = tmp_path / "bad.json"
    if fault != "missing":
        save_doc(doc, bad)
    out = tmp_path / "out"
    rc = export_caps.main(["--from-search", str(bad), "--point", point,
                           "--out", str(out), "--device", CPU])
    assert rc == 2
    assert not out.exists()


def test_export_from_search_stops_on_a_static_finding(runs, tmp_path,
                                                      monkeypatch, capsys):
    """A checker that finds something on the rebuilt program blocks the
    export before anything is written: exit 1."""
    real = analysis.check_program

    def finding(program, **kw):
        result = real(program, **kw)
        result.add(Diagnostic.of("plan.test-finding", "planted"))
        return result
    monkeypatch.setattr(analysis, "check_program", finding)
    out = tmp_path / "out"
    rc = export_caps.main(["--from-search", str(runs["coordinate", 0]["path"]),
                           "--out", str(out), "--device", CPU])
    assert rc == 1
    assert not out.exists()
    assert "STATIC CHECK FAILED" in capsys.readouterr().err
