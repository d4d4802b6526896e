"""The port's numeric-health probes (repro_torch.obs.numerics) against
the reference's (repro.obs.numerics).

Pinned, on the CPU:
  * probes off are free: the module hooks return at once, and leave no
    ambient probe behind;
  * on every config of tests/test_edge.py::CONFIGS x both roundings, on
    the same program (the reference's `.capsbin`, loaded by the port):
    the port's `requant_bounds` equals the reference's; the probed
    EdgeVM pass gives the reference's rows (integer fields exact, the
    `repro.numerics/v1` docs equal); the report is contained with 0
    int32 clips (by both packages' `check_containment`); probed output
    is bit-identical to unprobed;
  * the probed `forward_q7` on the `torch` backend is bit-identical to
    the unprobed one, and its rows equal the reference's eager `jnp`
    rows (the same `requant[seq]` sites in the same order);
  * a shrunk shift makes the saturation telemetry point at the op the
    static checker flags;
  * per-layer SNR rows agree with the reference's within the `fwd_f32`
    tolerance (below); the report's doc round-trips, and the reference's
    `NumericsReport.from_doc` and analyze CLI read the port's doc.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_edge
import test_torch_edge
from repro.analysis.ranges import requant_bounds as r_requant_bounds
from repro.edge import lower as r_lower
from repro.nn import CapsPipeline as RPipeline
from repro.obs import MetricsRegistry as RMetricsRegistry
from repro.obs import analyze as r_analyze
from repro.obs import numerics as rnh
from repro_torch.analysis import check_program
from repro_torch.analysis.ranges import requant_bounds
from repro_torch.convert import params_from_reference
from repro_torch.edge import EdgeProgram, EdgeVM, lower
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import analyze
from repro_torch.obs import numerics as nh

# The float faces of the two packages agree within rtol 1e-5 (atol 1e-5
# of the peak; tests/test_torch_nn.py, `fwd_f32` taps).  A power is a sum
# of squares, so a relative error of 1e-5 in each value is at most
# 2e-5 in the signal power.  The noise power sums squares of ref - deq,
# where deq is bit-exact and |ref| spans at most 128 grid steps of the
# int8 output, so its relative error is at most 2 * 128 * 1e-5.
F32_RTOL = 1e-5
SIGNAL_RTOL = 2 * F32_RTOL
NOISE_RTOL = 2 * 128 * F32_RTOL


@pytest.fixture(autouse=True)
def _no_ambient_probe():
    """Probing is always scoped; a leaked probe would observe (and slow)
    every later test."""
    assert nh.get_probe() is None and rnh.get_probe() is None
    yield
    assert nh.get_probe() is None and rnh.get_probe() is None


def test_probes_off_hooks_are_noops():
    nh.observe_requant(torch.tensor([1, 2]), 3, "floor")
    nh.observe_fq(np.array([999.0]))
    with nh.scope("anything"):
        pass
    assert nh.get_probe() is None


def test_probing_restores_previous_probe_on_exception():
    p = nh.NumericsProbe()
    with pytest.raises(RuntimeError):
        with nh.probing(p):
            assert nh.get_probe() is p
            raise RuntimeError("boom")
    assert nh.get_probe() is None


def test_fq_clip_count_is_exact():
    """`observe_fq` comes with the module; its caller, the fake-quant
    face, comes with the port of the trainer."""
    probe, rprobe = nh.NumericsProbe(), rnh.NumericsProbe()
    for p, m in ((probe, nh), (rprobe, rnh)):
        with m.probing(p):
            with m.scope("conv0"):
                m.observe_fq(np.array([0.1, 300.0, -300.0, 127.0]))
    assert probe.rows() == rprobe.rows()
    assert probe.fq_clip_rates() == {"conv0": 0.5}


# ---------------------------------------------------------------------------
# the EdgeVM on the same program: every config x both roundings
# ---------------------------------------------------------------------------
def _same_program(name, rounding, tmp_path):
    """(reference program, the port's load of its .capsbin, x_q)."""
    qnet, x_q = test_edge.built(name, rounding)
    rp = r_lower(qnet)
    path = rp.save(tmp_path / "m")["capsbin"]
    return rp, EdgeProgram.load(path), x_q


def _doc(report) -> str:
    return json.dumps(report.to_doc(), sort_keys=True)


@pytest.mark.parametrize("rounding", ["floor", "nearest"])
@pytest.mark.parametrize("name", sorted(test_edge.CONFIGS))
def test_vm_numerics_equal_the_reference_and_are_contained(name, rounding,
                                                           tmp_path):
    rp, pp, x_q = _same_program(name, rounding, tmp_path)
    assert requant_bounds(pp) == r_requant_bounds(rp)

    out, report = nh.run_program_numerics(pp, x_q)
    rout, rreport = rnh.run_program_numerics(rp, x_q)
    np.testing.assert_array_equal(out, rout)
    np.testing.assert_array_equal(out, EdgeVM(pp).run(x_q))  # unprobed
    ints = ("op_index", "calls", "n", "sat_lo", "sat_hi", "int32_clip",
            "acc_peak", "acc_bits", "acc_bound", "bound_bits", "out_min",
            "out_max", "frac")
    assert len(report.rows) == len(rreport.rows)
    for row, rrow in zip(report.rows, rreport.rows):
        assert (row["family"], row["op"], row["site"]) == \
            (rrow["family"], rrow["op"], rrow["site"])
        for k in ints:
            assert row.get(k) == rrow.get(k), (row["op"], row["site"], k)
    assert _doc(report) == _doc(rreport)

    assert report.total_int32_clip() == 0
    assert nh.check_containment(pp, report) == []
    assert rnh.check_containment(rp, report) == []
    sites, out_ivs = requant_bounds(pp)
    for row in report.rows:
        if row["family"] == "requant":
            assert (row["op_index"], row["site"]) in sites
            tight = row.get("bound_tightness")
            assert tight is None or 0.0 < tight <= 1.0
        else:
            assert row["op_index"] in out_ivs


def test_containment_reports_a_value_outside_its_bound(tmp_path):
    _, pp, x_q = _same_program("capsnet_edge_tiny", "floor", tmp_path)
    _, report = nh.run_program_numerics(pp, x_q)
    sites, _ = requant_bounds(pp)
    rows = [dict(r) for r in report.rows]
    req = next(r for r in rows if r["family"] == "requant")
    req["acc_peak"] = sites[(req["op_index"], req["site"])] + 1
    out = next(r for r in rows if r["family"] == "output"
               and r["op"] == "conv0")
    out["out_min"] = -1                      # relu output is [0, 127]
    bad = dataclasses.replace(report, rows=rows)
    findings = nh.check_containment(pp, bad)
    assert len(findings) == 2
    assert any("exceeds the static bound" in f for f in findings)
    assert any("outside the static interval [0, 127]" in f
               for f in findings)


# ---------------------------------------------------------------------------
# the probed forward_q7 on the torch backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", [("edge_tiny", "floor", "per_tensor"),
                                 ("edge_tiny", "nearest", "per_tensor"),
                                 ("edge_tiny", "nearest", "per_channel"),
                                 ("edge_tiny", "floor", "per_out"),
                                 ("mnist", "floor", "per_tensor")],
                         ids=test_torch_edge.net_id)
def test_probed_forward_q7_equals_the_references_eager_rows(key):
    rq, q, x_q = test_torch_edge.pair(*key)
    xt = torch.from_numpy(x_q)
    base = test_torch_edge.forward(q, x_q)
    probe, rprobe = nh.NumericsProbe(), rnh.NumericsProbe()
    with nh.probing(probe), torch.inference_mode():
        probed = q.forward(xt).numpy()
    with rnh.probing(rprobe):
        rout = np.asarray(rq.forward(jnp.asarray(x_q)))
    np.testing.assert_array_equal(probed, base)          # bit-identical
    np.testing.assert_array_equal(probed, rout)
    rows = probe.rows()
    assert rows == rprobe.rows()
    assert {r["op"] for r in rows} == {l.name for l in q.pipeline.layers}
    assert sum(r.get("int32_clip", 0) for r in rows) == 0
    caps = [r["site"] for r in rows if r["op"] == "caps"
            and r["family"] == "requant"]
    # u_hat, then s[r] and agree[r] of each routing iteration, in order
    assert len(caps) == 2 * q.plan["caps"].routings


# ---------------------------------------------------------------------------
# mutation localization: the telemetry agrees with the static checker
# ---------------------------------------------------------------------------
def _mutate_attr(program, op_index, **edits):
    op = program.ops[op_index]
    ops = list(program.ops)
    ops[op_index] = dataclasses.replace(op, attrs={**op.attrs, **edits})
    return dataclasses.replace(program, ops=tuple(ops))


@pytest.mark.parametrize("mutate,site", [
    (lambda p: _mutate_attr(p, 0, out_shift=p.ops[0].attrs["out_shift"] - 4),
     "out"),
    (lambda p: _mutate_attr(p, 2, uhat_shift=p.ops[2].attrs["uhat_shift"] - 4),
     "uhat"),
], ids=["conv-out-shift", "routing-uhat-shift"])
def test_mutation_saturation_localizes_checker_finding(mutate, site,
                                                       tmp_path):
    _, pp, x_q = _same_program("capsnet_edge_tiny", "floor", tmp_path)
    bad = mutate(pp)
    result = check_program(bad)
    assert not result.ok
    flagged = {d.op_index for d in result.diagnostics
               if d.check.startswith("plan.") and d.op_index is not None}
    assert flagged, [str(d) for d in result.diagnostics]
    _, report = nh.run_program_numerics(bad, x_q)
    worst = max((r for r in report.rows if r["family"] == "requant"),
                key=lambda r: r["saturation_rate"])
    assert worst["saturation_rate"] > 0.0
    assert worst["op_index"] in flagged
    (mutated,) = [r for r in report.rows if r["family"] == "requant"
                  and r["op_index"] in flagged and r["site"] == site]
    assert mutated["saturation_rate"] > 0.0


# ---------------------------------------------------------------------------
# SNR rows and the report document
# ---------------------------------------------------------------------------
def _reports(key, n=4, metrics=False):
    """The port's and the reference's run_numerics (with the float
    weights, so with SNR rows) on the same net and images."""
    rq, q, _ = test_torch_edge.pair(*key)
    rcfg, _ = test_torch_edge.CFGS[key[0]]
    pc, pw = test_torch_edge.PLAN_KINDS[key[2]]
    rparams = RPipeline.from_config(rcfg, per_channel=pc, per_channel_w=pw) \
        .init(jax.random.key(0))            # the params pair() quantized
    params = params_from_reference(test_torch_edge.np_tree(rparams),
                                   device="cpu")
    images = np.random.default_rng(11).uniform(
        0, 1, (n,) + rcfg.input_shape).astype(np.float32)
    reg = MetricsRegistry("run") if metrics else None
    rreg = RMetricsRegistry("run") if metrics else None
    return (nh.run_numerics(q, images, params=params, metrics=reg),
            rnh.run_numerics(rq, images, params=rparams, metrics=rreg),
            reg, rreg)


@pytest.mark.parametrize("key", [("edge_tiny", "floor", "per_tensor"),
                                 ("edge_tiny", "nearest", "per_channel"),
                                 ("mnist", "floor", "per_tensor")],
                         ids=test_torch_edge.net_id)
def test_snr_rows_agree_with_the_reference(key):
    report, rreport, _, _ = _reports(key)
    assert report.rows == rreport.rows
    assert [r["layer"] for r in report.snr] == \
        [r["layer"] for r in rreport.snr]
    for row, rrow in zip(report.snr, rreport.snr):
        assert row["out_frac"] == rrow["out_frac"]
        assert row["signal_power"] == pytest.approx(rrow["signal_power"],
                                                    rel=SIGNAL_RTOL)
        assert row["noise_power"] == pytest.approx(rrow["noise_power"],
                                                   rel=NOISE_RTOL)
        snr_db_tol = 10 * np.log10((1 + SIGNAL_RTOL) * (1 + NOISE_RTOL))
        assert row["snr_db"] == pytest.approx(rrow["snr_db"],
                                              abs=snr_db_tol)
    assert report.snr[0]["snr_db"] > 10.0   # the conv front quantizes well


def test_run_numerics_streams_the_references_metrics():
    report, rreport, reg, rreg = _reports(
        ("edge_tiny", "floor", "per_tensor"), n=2, metrics=True)
    snap = reg.snapshot()
    assert snap == rreg.snapshot()
    ops = {s["labels"]["op"]
           for s in snap["numerics.range_utilization"]["series"]}
    assert ops == {"conv0", "pcap", "caps"}


def test_the_reference_reads_the_ports_numerics_doc(tmp_path, capsys):
    report, rreport, _, _ = _reports(("edge_tiny", "floor", "per_tensor"))
    doc = json.loads(_doc(report))
    back = nh.NumericsReport.from_doc(doc)
    assert (back.rows, back.snr) == (report.rows, report.snr)
    assert back.summary() == report.summary()
    assert back.format() == report.format()
    rback = rnh.NumericsReport.from_doc(doc)
    assert rback.rows == report.rows
    assert rback.format() == report.format()
    assert rback.summary()["int32_clip_total"] == 0
    with pytest.raises(ValueError):
        nh.NumericsReport.from_doc({"schema": "repro.trace/v1"})

    path = tmp_path / "numerics.json"
    path.write_text(json.dumps(doc, sort_keys=True))
    for main in (analyze.main, r_analyze.main):
        assert main([str(path), "--gate-clips"]) == 0
        assert "numerics report" in capsys.readouterr().out
    doc["rows"] = [dict(r, int32_clip=5) if r["family"] == "requant"
                   else r for r in doc["rows"]]
    bad = tmp_path / "clipped.json"
    bad.write_text(json.dumps(doc, sort_keys=True))
    for main in (analyze.main, r_analyze.main):
        assert main([str(bad)]) == 0                     # report only
        assert main([str(bad), "--gate-clips"]) == 1


def test_run_numerics_without_params_has_no_snr_rows():
    rq, q, _ = test_torch_edge.pair("edge_tiny", "floor", "per_tensor")
    images = np.random.default_rng(5).uniform(
        0, 1, (2,) + tuple(q.pipeline.cfg.input_shape)).astype(np.float32)
    report = nh.run_numerics(q, images, program=lower(q))
    assert report.snr == [] and report.batch == 2
    assert report.rows == rnh.run_numerics(rq, images).rows
    s = report.summary()
    assert s["min_snr"] is None and s["int32_clip_total"] == 0
