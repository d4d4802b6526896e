"""The port's trace analyzer and baseline gate (repro_torch.obs.analyze,
repro_torch.obs.baseline) against the reference's, and the CLIs that
write what they read.

Pinned, on the CPU:
  * under a fake clock, the port's `analyze` gives exact numbers and the
    same report from a live tracer as from its Chrome export; on the
    port's Chrome doc of a real EDGE_TINY serving window it gives the
    reference's report, and every request's timeline is rebuilt;
  * `costmodel_drift` on the same program and measured rows equals the
    reference's, with full join coverage on every config x rounding;
  * `compare_docs` gives the reference's findings on the committed
    benchmarks/baselines (read only) and on an injected 3x slowdown
    written to tmp_path; `record` writes only where it is told;
  * `serve_caps --trace/--trace-summary/--metrics-out/--numerics-out
    /--profile` and `export_caps --drift/--numerics/--numerics-out` on
    the CPU, read back by both packages' analyzers; `--numerics` exits
    1 on a finding.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import test_edge
from repro import obs as robs
from repro.edge import costmodel as r_costmodel
from repro.edge import lower as r_lower
from repro.obs import analyze as r_analyze
from repro.obs import baseline as r_baseline
from repro_torch import obs
from repro_torch.edge import EdgeProgram, EdgeVM
from repro_torch.launch import export_caps, serve_caps
from repro_torch.nn import EDGE_TINY
from repro_torch.obs import analyze, baseline
from repro_torch.serving import CapsServeEngine, ModelRegistry, ModelSpec
from test_torch_obs import FakeClock

REPO = pathlib.Path(__file__).resolve().parent.parent
BASELINES = REPO / "benchmarks" / "baselines"


@pytest.fixture(autouse=True)
def _no_ambient_tracer_and_fresh_process_metrics():
    """Tracing off, and the process registry (which the CLIs snapshot)
    empty, around every test."""
    obs.set_tracer(None)
    obs.METRICS.reset()
    yield
    obs.set_tracer(None)
    obs.METRICS.reset()


def _fake_serve_trace() -> obs.Tracer:
    """A serve-shaped forest under the fake clock:

      enqueue#0 [1,2]  enqueue#1 [3,4]
      wave [5,16]: bucket [6,7]  compile [8,9]
                   execute [10,13] > edgevm.run [11,12]
                   complete [14,15]
    """
    tr = obs.Tracer(clock=FakeClock())
    with tr.span("serve.enqueue", model="m", req_id=0):
        pass
    with tr.span("serve.enqueue", model="m", req_id=1):
        pass
    with tr.span("serve.wave", wave=0, model="m") as w:
        with tr.span("serve.bucket"):
            pass
        with tr.span("serve.compile"):
            pass
        with tr.span("serve.execute"):
            with tr.span("edgevm.run"):
                pass
        with tr.span("serve.complete", req_ids="0,1"):
            pass
        w.note(bucket=4, n_real=2, req_ids="0,1")
    return tr


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------
def test_analyzer_is_exact_under_the_fake_clock(tmp_path):
    tr = _fake_serve_trace()
    report = analyze.analyze(tr)
    assert report["span_count"] == 8
    s = report["spans"]
    assert s["serve.enqueue"] == {
        "count": 2, "total_s": 2.0, "mean_s": 1.0, "p50_s": 1.0,
        "p95_s": 1.0, "max_s": 1.0, "self_s": 2.0}
    assert (s["serve.wave"]["total_s"], s["serve.wave"]["self_s"]) == \
        (11.0, 5.0)
    assert (s["serve.execute"]["total_s"], s["serve.execute"]["self_s"]) \
        == (3.0, 2.0)
    (w,) = report["waves"]
    assert (w["wave"], w["model"], w["bucket"], w["n_real"], w["req_ids"]) \
        == (0, "m", 4, 2, [0, 1])
    assert [p["name"] for p in w["critical_path"]] == \
        ["serve.wave", "serve.execute", "edgevm.run"]
    r0, r1 = report["requests"]
    assert (r0["t_enq"], r0["t_done"], r0["e2e_s"], r0["queue_s"]) == \
        (0.0, 14.0, 14.0, 3.0)
    assert (r1["t_enq"], r1["e2e_s"], r1["queue_s"]) == (2.0, 12.0, 1.0)
    (b,) = report["breakdown"]
    assert (b["waves"], b["images"], b["wave_s"], b["queue_s"]) == \
        (1, 2, 11.0, 4.0)
    assert (b["bucket_s"], b["compile_s"], b["execute_s"],
            b["complete_s"]) == (1.0, 1.0, 3.0, 1.0)
    # a live tracer, its Chrome dict and its file give one report, and
    # the reference's analyzer gives it too
    path = tr.write_chrome_trace(tmp_path / "trace.json")
    for source in (tr.chrome_trace(), path, str(path)):
        assert analyze.analyze(source) == report
    assert r_analyze.analyze(tr.chrome_trace()) == report
    assert analyze.format_analysis(report) == \
        r_analyze.format_analysis(report)
    json.loads(json.dumps(report))
    with pytest.raises(TypeError):
        analyze.load_trace(42)


def test_percentile_policy_matches_the_reference():
    for vals in ([], [7.0], [1.0, 9.0], [float(i) for i in range(1, 11)],
                 [0.5, 0.25, 3.0, 3.0, 9.5]):
        v = sorted(vals)
        for p in (50, 95, 99):
            assert analyze._pctl(v, p) == r_analyze._pctl(v, p)
    assert analyze._pctl([1.0, 9.0], 50) == 9.0          # n < 3: the max


def _served_trace(n=7):
    """A real EDGE_TINY serving window on the port's torch backend,
    traced by an engine-scoped tracer."""
    mid = "edge_tiny@torch"
    registry = ModelRegistry(specs={mid: ModelSpec(
        mid, EDGE_TINY, dataset="uniform", calib_n=8)}, device="cpu")
    images = np.random.default_rng(3).uniform(
        0, 1, (n,) + tuple(EDGE_TINY.input_shape)).astype(np.float32)
    tracer = obs.Tracer()
    engine = CapsServeEngine(registry, buckets=(1, 4), tracer=tracer)
    rids = [engine.submit(img, mid) for img in images]
    done = {c.rid: c for c in engine.drain()}
    return tracer, rids, done


def test_the_reference_analyzes_the_ports_serving_trace_alike():
    tracer, rids, done = _served_trace()
    doc = json.loads(json.dumps(tracer.chrome_trace()))
    report = analyze.analyze(doc)
    assert report == r_analyze.analyze(doc)
    assert analyze.format_analysis(report) == \
        r_analyze.format_analysis(report)
    rows = {r["req_id"]: r for r in report["requests"]}
    assert set(rows) == set(rids) == set(done)
    for rid, c in done.items():
        assert (rows[rid]["wave"], rows[rid]["bucket"]) == (c.wave, c.bucket)
        assert 0.0 <= rows[rid]["queue_s"] <= rows[rid]["e2e_s"]
    member = [rid for w in report["waves"] for rid in w["req_ids"]]
    assert sorted(member) == sorted(rids)
    assert [(b["bucket"], b["waves"], b["images"])
            for b in report["breakdown"]] == [(4, 2, 7)]


# ---------------------------------------------------------------------------
# cost-model drift on the same program and the same measured rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounding", ["floor", "nearest"])
@pytest.mark.parametrize("name", sorted(test_edge.CONFIGS))
def test_costmodel_drift_equals_the_reference(name, rounding, tmp_path):
    qnet, x_q = test_edge.built(name, rounding)
    rp = r_lower(qnet)
    pp = EdgeProgram.load(rp.save(tmp_path / "m")["capsbin"])
    rows: list = []
    out = EdgeVM(pp).run(x_q, profile=rows)
    np.testing.assert_array_equal(out, EdgeVM(pp).run(x_q))
    assert [(r["op_index"], r["name"], r["kind"]) for r in rows] == \
        [(i, op.name, op.kind) for i, op in enumerate(pp.ops)]
    drift = analyze.costmodel_drift(pp, rows, batch=2)
    assert drift == r_analyze.costmodel_drift(rp, rows, batch=2)
    assert drift["coverage"] == 1.0 and drift["unmatched"] == []
    assert set(drift["profiles"]) == set(r_costmodel.MCU_PROFILES)
    for p in drift["profiles"].values():
        assert sum(r["est_share"] for r in p["rows"]) == pytest.approx(1.0)
    assert analyze.format_drift(drift) == r_analyze.format_drift(drift)
    partial = analyze.costmodel_drift(pp, rows[:-1])
    assert partial["coverage"] < 1.0
    assert partial == r_analyze.costmodel_drift(rp, rows[:-1])


def test_profiled_and_traced_vm_runs_keep_their_bits(tmp_path):
    qnet, x_q = test_edge.built("capsnet_edge_tiny", "nearest")
    pp = EdgeProgram.load(r_lower(qnet).save(tmp_path / "m")["capsbin"])
    vm = EdgeVM(pp)
    tracer = obs.Tracer()
    with obs.tracing(tracer):
        traced = vm.run(x_q)
    np.testing.assert_array_equal(traced, vm.run(x_q))
    (run,) = tracer.find("edgevm.run")
    assert run.args == {"program": pp.name, "batch": 2}
    assert [c.name for c in run.children] == \
        [f"edgevm.{op.name}" for op in pp.ops]


# ---------------------------------------------------------------------------
# the baseline gate
# ---------------------------------------------------------------------------
def _docs(d):
    return {p.name: json.loads(p.read_text())
            for p in sorted(pathlib.Path(d).glob("BENCH_*.json"))}


def test_committed_baselines_give_the_references_findings():
    docs = _docs(BASELINES)
    assert docs                                    # read only, never written
    for doc in docs.values():
        assert baseline.compare_docs(doc, doc) == []
        assert baseline.validate_doc(doc, "x") == []
        assert baseline.validate_invariants(doc, "x") == []
    assert baseline.compare_dirs(BASELINES, BASELINES) == \
        r_baseline.compare_dirs(BASELINES, BASELINES) == ([], [])


def test_injected_3x_slowdown_gives_the_references_findings(tmp_path,
                                                            capsys):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    for name, doc in _docs(BASELINES).items():
        if name == "BENCH_serving.json":
            for row in doc["rows"]:
                row["us_per_call"] *= 3.0
                figs = row["figures"]
                for k in ("images_per_s", "speedup"):
                    if k in figs:
                        figs[k] /= 3.0
                if "p95_ms" in figs:
                    figs["p95_ms"] *= 3.0
        (run_dir / name).write_text(json.dumps(doc))
    base = _docs(BASELINES)["BENCH_serving.json"]
    new = _docs(run_dir)["BENCH_serving.json"]
    for slack in (1.0, 2.0, 10.0):
        assert baseline.compare_docs(base, new, slack=slack) == \
            r_baseline.compare_docs(base, new, slack=slack)
    findings, notes = baseline.compare_dirs(run_dir, BASELINES)
    assert (findings, notes) == r_baseline.compare_dirs(run_dir, BASELINES)
    assert any("us_per_call" in f for f in findings)
    assert any("images_per_s" in f for f in findings)
    assert all(f.startswith("BENCH_serving") for f in findings)
    assert baseline.main(["compare", str(run_dir),
                          "--baselines", str(BASELINES)]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert baseline.main(["compare", str(BASELINES),
                          "--baselines", str(BASELINES)]) == 0
    with pytest.raises(SystemExit):              # no default directory
        baseline.main(["compare", str(run_dir)])


def test_gate_is_direction_aware_like_the_reference():
    base = {"schema": baseline.BENCH_SCHEMA, "section": "serving",
            "stamp": "s", "smoke": True, "config": {}, "figures": {},
            "rows": [{"name": "r", "us_per_call": 100.0, "derived": "",
                      "figures": {"images_per_s": 1000.0, "p95_ms": 2.0,
                                  "occupancy": 0.5, "snr_db": -6.0}}]}
    cases = []
    for edit in ({"us_per_call": 10.0}, {"us_per_call": 300.0},
                 {"figures": {"images_per_s": 9000.0, "p95_ms": 0.5,
                              "occupancy": 0.5, "snr_db": -6.0}},
                 {"figures": {"images_per_s": 1000.0, "p95_ms": 2.0,
                              "occupancy": 0.9, "snr_db": -9.0}},
                 {"figures": {}}, {"name": "renamed"}):
        new = json.loads(json.dumps(base))
        new["rows"][0].update(edit)
        cases.append(new)
    cases.append(dict(base, smoke=False))
    cases.append(dict(base, section="edge_vm"))
    for new in cases:
        for slack in (1.0, 2.0):
            assert baseline.compare_docs(base, new, slack=slack) == \
                r_baseline.compare_docs(base, new, slack=slack)
    assert baseline.compare_docs(base, cases[0]) == []   # better: fine
    assert baseline.compare_docs(base, cases[1], slack=2.0) == []
    assert {k: dataclasses.astuple(v)
            for k, v in baseline.METRIC_POLICY.items()} == \
        {k: dataclasses.astuple(v)
         for k, v in r_baseline.METRIC_POLICY.items()}


def test_record_writes_only_where_it_is_told(tmp_path):
    out_dir, base_dir = tmp_path / "out", tmp_path / "base"
    out_dir.mkdir()
    bad = {"schema": baseline.BENCH_SCHEMA, "section": "serving",
           "stamp": "", "smoke": True, "config": {}, "figures": {},
           "rows": []}
    (out_dir / "BENCH_serving.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="stamp"):
        baseline.record(out_dir, base_dir)
    with pytest.raises(ValueError, match="nothing to record"):
        baseline.record(out_dir, base_dir, sections={"edge_vm"})
    (out_dir / "BENCH_serving.json").write_text(json.dumps(
        dict(bad, stamp="s")))
    unknown = dict(bad, stamp="s", section="made_up")
    assert any("unknown section" in f
               for f in baseline.validate_doc(unknown, "t"))
    written = baseline.record(out_dir, base_dir)
    assert written == [base_dir / "BENCH_serving.json"]
    assert baseline.compare_dirs(out_dir, base_dir) == ([], [])
    assert baseline.main(["record", str(out_dir), "--baselines",
                          str(tmp_path / "cli")]) == 0
    assert (tmp_path / "cli" / "BENCH_serving.json").is_file()
    with pytest.raises(TypeError):               # no default directory
        baseline.record(out_dir)
    gated = dict(bad, stamp="s", section="numerics",
                 figures={"int32_clip_total": 3})
    assert baseline.validate_invariants(gated, "x") and \
        baseline.validate_invariants(gated, "x")[0].startswith(
            "x: int32_clip_total == 3")


# ---------------------------------------------------------------------------
# the CLIs, on the CPU
# ---------------------------------------------------------------------------
def test_serve_caps_obs_flags_on_the_cpu(tmp_path, capsys):
    paths = {k: tmp_path / f"{k}.json"
             for k in ("trace", "metrics", "numerics")}
    rc = serve_caps.main([
        "--model", "edge_tiny@torch", "--device", "cpu", "--requests", "6",
        "--buckets", "1,4", "--trace", str(paths["trace"]),
        "--trace-summary", "--metrics-out", str(paths["metrics"]),
        "--numerics-out", str(paths["numerics"]), "--profile"])
    out = capsys.readouterr().out
    assert rc == 0
    assert obs.get_tracer() is None                  # restored
    assert "static MCU latency estimate" in out
    assert "trace summary:" in out and "requests: 6 reconstructed" in out
    assert "numerics: int32 clips 0" in out

    trace = json.loads(paths["trace"].read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("serve.enqueue") == 6
    assert names.count("serve.wave") == 2            # 4 + 2
    assert {"serving.ptq_build", "ptq.calibrate", "edgevm.run"} <= set(names)
    metrics = json.loads(paths["metrics"].read_text())
    assert metrics["schema"] == "repro.metrics/v1"
    assert metrics["serve_summary"]["images"] == 6
    assert metrics["run"]["serve.requests_total"]["series"]
    assert "cuda.fallback_decisions" in metrics["process"]
    assert analyze._format_metrics(metrics) == \
        r_analyze._format_metrics(metrics)
    numerics = json.loads(paths["numerics"].read_text())
    assert numerics["schema"] == "repro.numerics/v1"
    assert [r["layer"] for r in numerics["snr"]] == ["conv0", "pcap", "caps"]
    assert numerics["summary"]["int32_clip_total"] == 0

    for main in (analyze.main, r_analyze.main):
        assert main([str(paths["trace"]), "--metrics",
                     str(paths["metrics"])]) == 0
        assert "serve.wave > serve.execute" in capsys.readouterr().out
        assert main([str(paths["numerics"]), "--gate-clips"]) == 0
        capsys.readouterr()
    assert analyze.main([str(paths["trace"]), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["span_count"] == \
        len(names)
    with pytest.raises(SystemExit):                  # a trace, not numerics
        analyze.main([str(paths["trace"]), "--gate-clips"])


def test_export_caps_drift_and_numerics_on_the_cpu(tmp_path, capsys,
                                                   monkeypatch):
    npath = tmp_path / "n" / "numerics.json"
    rc = export_caps.main([
        "--model", "edge_tiny@torch", "--device", "cpu", "--out",
        str(tmp_path / "e"), "--verify-n", "2", "--drift", "--drift-n", "2",
        "--numerics", "--numerics-n", "3", "--numerics-out", str(npath)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "join coverage 3/3 ops = 100%" in out
    assert "gap8" in out and "cortex-m7" in out
    assert "numerics report" in out and "int32 clips: 0" in out
    doc = json.loads(npath.read_text())
    assert doc["batch"] == 3 and len(doc["snr"]) == 3
    assert robs.numerics.NumericsReport.from_doc(doc).total_int32_clip() == 0

    # a containment finding or an int32 clip is exit 1
    monkeypatch.setattr(obs.numerics, "check_containment",
                        lambda program, report: ["op[0] conv0: made up"])
    rc = export_caps.main(["--model", "edge_tiny@torch", "--device", "cpu",
                           "--out", str(tmp_path / "f"), "--verify-n", "0",
                           "--numerics"])
    assert rc == 1
    assert "NUMERICS: op[0] conv0: made up" in capsys.readouterr().err
