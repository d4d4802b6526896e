"""The port's static verifier (repro_torch.analysis) against the
reference (repro.analysis) on the same programs.

Each program is lowered by both packages from the same net (see
tests/test_torch_edge.py), then the same edit is applied to both, and
`check_program` must give the same diagnostics — check id, message, op,
tensor, detail, in the same order — whether the program is clean or
tampered with.  The tamper cases are tests/test_analysis.py's mutation
corpus.  Also: `annotate_acc_bounds` stamps the reference's
`acc_bound`s, `check_pipeline_plan` lints typed plans as the reference
does, `install_artifact` refuses a tampered `.capsbin` with a
CheckError, and `python -m repro_torch.analysis` exits 1 on one.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.analysis import check_arena as r_check_arena
from repro.analysis import check_pipeline_plan as r_check_pipeline_plan
from repro.analysis import check_program as r_check_program
from repro.edge import EdgeOp as REdgeOp
from repro.edge import EdgeProgram as REdgeProgram
from repro.edge import TensorSpec as RTensorSpec
from repro.edge import lower as r_lower
from repro.edge import plan_arena as r_plan_arena
from repro.nn import VariantSet as RVariantSet
from repro_torch.analysis import (CheckError, annotate_acc_bounds,
                                  check_arena, check_pipeline_plan,
                                  check_program)
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.edge import (EdgeOp, EdgeProgram, TensorSpec, load_qnet,
                              lower, plan_arena)
from repro_torch.nn import VariantSet
from repro_torch.nn.variants import REGISTRY
from repro_torch.serving import ModelRegistry
from test_torch_edge import NETS, net_id, pair

CPU = "cpu"


def diags(result_or_list):
    """Every field of every diagnostic, in order, as plain values."""
    ds = getattr(result_or_list, "diagnostics", result_or_list)
    return [(d.check, d.message, d.op_index, d.op_name, d.tensor, d.detail,
             str(d)) for d in ds]


def both(key=("edge_tiny", "floor", "per_tensor"), variants=None):
    """(port program, reference program) lowered from the same net."""
    rq, q, _ = pair(*key)
    if variants is not None:
        sm, sq = variants
        rq = rq.with_variants(RVariantSet(softmax=sm, squash=sq))
        q = q.with_variants(VariantSet(softmax=sm, squash=sq))
    return lower(q), r_lower(rq)


def tamper_attrs(program, op_idx, **attrs):
    ops = list(program.ops)
    ops[op_idx] = dataclasses.replace(
        ops[op_idx], attrs={**ops[op_idx].attrs, **attrs})
    return dataclasses.replace(program, ops=tuple(ops))


def tamper_io(program, op_idx, **io):
    ops = list(program.ops)
    ops[op_idx] = dataclasses.replace(ops[op_idx], **io)
    return dataclasses.replace(program, ops=tuple(ops))


def same_findings(pp, rp, **kw):
    ours, theirs = check_program(pp, **kw), r_check_program(rp)
    assert diags(ours) == diags(theirs)
    assert ours.format() == theirs.format()
    return ours


# ---------------------------------------------------------------------------
# clean programs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", NETS, ids=net_id)
def test_clean_programs_give_the_references_empty_findings(key):
    result = same_findings(*both(key))
    assert result.ok, result.format()


@pytest.mark.parametrize("variants", sorted(itertools.product(
    REGISTRY.names("softmax"), REGISTRY.names("squash"))), ids=str)
def test_every_variant_pair_checks_clean(variants):
    assert same_findings(*both(variants=variants)).ok


def test_acc_bounds_are_the_references():
    pp, rp = both()
    again = annotate_acc_bounds(pp)
    assert again.same_as(pp)
    stamped = [op.attrs.get("acc_bound") for op in pp.ops]
    assert stamped == [op.attrs.get("acc_bound") for op in rp.ops]
    assert stamped[0] > 0 and stamped[-1] is None
    stripped = dataclasses.replace(pp, ops=tuple(
        dataclasses.replace(op, attrs={k: v for k, v in op.attrs.items()
                                       if k != "acc_bound"})
        for op in pp.ops))
    assert annotate_acc_bounds(stripped).same_as(pp)


def test_typed_plans_lint_as_the_reference():
    rq, q, _ = pair("edge_tiny", "nearest", "per_channel")
    assert check_pipeline_plan(q.plan) == []
    assert r_check_pipeline_plan(rq.plan) == []
    conv = q.plan["conv0"]
    rconv = rq.plan["conv0"]
    bad = dataclasses.replace(q.plan, layers={
        **q.plan.layers, "conv0": dataclasses.replace(
            conv, out_shift=conv.out_shift + 1,
            out_shift_per_channel=conv.out_shift_per_channel[:-1])})
    rbad = dataclasses.replace(rq.plan, layers={
        **rq.plan.layers, "conv0": dataclasses.replace(
            rconv, out_shift=rconv.out_shift + 1,
            out_shift_per_channel=rconv.out_shift_per_channel[:-1])})
    found = check_pipeline_plan(bad)
    assert [d.check for d in found] == ["plan.out-shift-mismatch",
                                        "plan.per-channel-length"]
    assert diags(found) == diags(r_check_pipeline_plan(rbad))


# ---------------------------------------------------------------------------
# the mutation corpus: the same tamper, the same findings
# ---------------------------------------------------------------------------
def _attr_tampers(pp):
    """name -> (op index, attrs) of tests/test_analysis.py's attr
    tampers, computed from the port's program (both are equal)."""
    a0 = pp.ops[0].attrs
    r = next(i for i, op in enumerate(pp.ops)
             if op.kind == "CAPS_ROUTING_Q7")
    ar = pp.ops[r].attrs
    return {
        "shrunk-out-shift": (0, dict(out_shift=a0["out_shift"] - 1)),
        "shift-out-of-domain": (0, dict(out_shift=45)),
        "shift-past-31": (0, dict(out_shift=a0["out_shift"] + 40)),
        "swapped-fracs": (0, dict(in_frac=a0["out_frac"],
                                  out_frac=a0["in_frac"])),
        "broken-frac-threading": (0, dict(in_frac=a0["in_frac"] + 1)),
        "unregistered-variant": (r, dict(softmax_impl="turbo")),
        "acc-bound": (0, dict(acc_bound=7)),
        "caps-out-shift": (r, dict(caps_out_shifts=(
            ar["caps_out_shifts"][0] + 1,) + ar["caps_out_shifts"][1:])),
        "agree-shift": (r, dict(agree_shifts=(ar["agree_shifts"][0] - 2,))),
        "routing-table-length": (r, dict(caps_out_shifts=(
            ar["caps_out_shifts"] + ar["caps_out_shifts"][:1]))),
        "logit-frac": (r, dict(logit_frac=9)),
        "missing-attr": (0, {}),
    }


ATTR_TAMPERS = ("acc-bound", "agree-shift", "broken-frac-threading",
                "caps-out-shift", "logit-frac", "missing-attr",
                "routing-table-length", "shift-out-of-domain",
                "shift-past-31", "shrunk-out-shift", "swapped-fracs",
                "unregistered-variant")


@pytest.mark.parametrize("tamper", ATTR_TAMPERS)
def test_attr_tampers_give_the_references_findings(tamper):
    pp, rp = both()
    assert sorted(_attr_tampers(pp)) == sorted(ATTR_TAMPERS)
    i, attrs = _attr_tampers(pp)[tamper]
    if tamper == "missing-attr":
        pp, rp = (dataclasses.replace(p, ops=tuple(
            dataclasses.replace(o, attrs={k: v for k, v in o.attrs.items()
                                          if k != "kernel"})
            if j == i else o for j, o in enumerate(p.ops))) for p in (pp, rp))
    else:
        pp, rp = tamper_attrs(pp, i, **attrs), tamper_attrs(rp, i, **attrs)
    result = same_findings(pp, rp)
    assert not result.ok


def test_per_channel_table_tamper_gives_the_references_findings():
    pp, rp = both(("edge_tiny", "nearest", "per_channel"))
    table = pp.ops[0].attrs["out_shift_per_channel"]
    result = same_findings(
        tamper_attrs(pp, 0, out_shift_per_channel=table[:-1]),
        tamper_attrs(rp, 0, out_shift_per_channel=table[:-1]))
    (d,) = result.by_check("plan.per-channel-length")
    assert d.op_index == 0


def test_dataflow_tampers_give_the_references_findings():
    pp, rp = both()
    for io in (dict(inputs=(3,)), dict(output=pp.ops[0].output),
               dict(inputs=(0, 1)), dict(inputs=(9,))):
        result = same_findings(tamper_io(pp, 1, **io), tamper_io(rp, 1, **io))
        assert not result.ok
    result = same_findings(dataclasses.replace(pp, rounding="stochastic"),
                           dataclasses.replace(rp, rounding="stochastic"))
    assert result.by_check("ir.bad-rounding")


def test_weight_blob_tampers_give_the_references_findings():
    pp, rp = both()
    for w in (np.zeros((2, 2), np.int8),
              pp.ops[0].weights["w"].astype(np.int16)):
        result = same_findings(
            dataclasses.replace(pp, ops=(dataclasses.replace(
                pp.ops[0], weights={**pp.ops[0].weights, "w": w}),)
                + pp.ops[1:]),
            dataclasses.replace(rp, ops=(dataclasses.replace(
                rp.ops[0], weights={**rp.ops[0].weights, "w": w}),)
                + rp.ops[1:]))
        assert not result.ok


def test_arena_tampers_give_the_references_findings():
    pp, rp = both()
    plan, rplan = plan_arena(pp), r_plan_arena(rp)
    for edit in (dict(offsets={**plan.offsets, 2: plan.offsets[1]}),
                 dict(offsets={**plan.offsets, 0: 0}),
                 dict(offsets={k: v for k, v in plan.offsets.items()
                               if k != 2}),
                 dict(scratch_bytes=0),
                 dict(scratch_bytes=plan.scratch_bytes + 1),
                 dict(arena_bytes=1)):
        ours = check_arena(pp, dataclasses.replace(plan, **edit))
        theirs = r_check_arena(rp, dataclasses.replace(rplan, **edit))
        assert ours and diags(ours) == diags(theirs)
    assert check_arena(pp, plan) == []


def _oversized_conv(pkg_op, pkg_tensor, pkg_program, w):
    attrs = {"kernel": 3, "stride": 1, "in_ch": 16384, "out_ch": 1,
             "relu": False, "in_frac": 7, "w_frac": 7, "b_frac": 14,
             "out_frac": 7, "out_shift": 7, "bias_shift": 0}
    op = pkg_op("CONV_Q7", "conv_huge", (0,), 1, attrs, {
        "w": np.full((3, 3, 16384, 1), w, np.int8),
        "b": np.zeros((1,), np.int8)})
    return pkg_program(name="huge", rounding="floor", input_frac=7,
                       tensors=(pkg_tensor(0, "input", (3, 3, 16384), 7),
                                pkg_tensor(1, "out", (1, 1, 1), 7)),
                       ops=(op,))


@pytest.mark.parametrize("w", [127, 1])
def test_an_int32_wrap_is_found_as_the_reference_finds_it(w):
    result = same_findings(
        _oversized_conv(EdgeOp, TensorSpec, EdgeProgram, w),
        _oversized_conv(REdgeOp, RTensorSpec, REdgeProgram, w))
    assert result.ok == (w == 1)


def test_a_squash_overflow_is_found_as_the_reference_finds_it():
    pp, rp = both()
    result = same_findings(tamper_attrs(pp, 1, squash_in_frac=40,
                                        out_frac=40),
                           tamper_attrs(rp, 1, squash_in_frac=40,
                                        out_frac=40))
    assert not result.ok


# ---------------------------------------------------------------------------
# wiring: the importer, the registry and the command line refuse
# ---------------------------------------------------------------------------
def test_install_artifact_refuses_a_tampered_capsbin(tmp_path):
    pp, _ = both()
    bad = tamper_attrs(pp, 0, out_shift=pp.ops[0].attrs["out_shift"] - 1)
    path = bad.save(tmp_path / "bad")["capsbin"]
    reg = ModelRegistry(specs={}, device=CPU)
    with pytest.raises(CheckError, match="out-shift-mismatch"):
        reg.install_artifact(path)
    with pytest.raises(ValueError):
        load_qnet(path, device=CPU)
    assert not reg.has("capsnet_edge_tiny")
    q = load_qnet(path, check=False, device=CPU)
    assert q.plan["conv0"].out_shift == pp.ops[0].attrs["out_shift"] - 1


def test_registry_serves_an_installed_artifact_as_the_vm(tmp_path):
    from repro_torch.edge import EdgeVM
    _, q, x_q = pair("edge_tiny", "nearest", "per_channel")
    path = lower(q).save(tmp_path / "shipped")["capsbin"]
    reg = ModelRegistry(specs={}, device=CPU)
    q2 = reg.install_artifact(path, model_id="shipped")
    assert reg.has("shipped") and q2.backend == "torch"
    assert reg.input_shape("shipped") == tuple(q.pipeline.cfg.input_shape)
    reg.install_artifact(path)
    assert reg.has("capsnet_edge_tiny")
    images = np.random.default_rng(11).uniform(
        0, 1, (2,) + reg.input_shape("shipped")).astype(np.float32)
    v_q = reg.executable("shipped", 2)(images)[0]
    x2 = q2.quantize_input(torch.from_numpy(images))
    np.testing.assert_array_equal(v_q.numpy(),
                                  EdgeVM(EdgeProgram.load(path))
                                  .run(x2.numpy()))


def test_the_analysis_cli_exits_1_on_a_finding(tmp_path, capsys):
    pp, _ = both()
    good = pp.save(tmp_path / "good")["capsbin"]
    bad = tamper_attrs(pp, 0, out_shift=45).save(tmp_path / "bad")["capsbin"]
    assert analysis_main([str(good), "--profile"]) == 0
    out = capsys.readouterr().out
    assert "static checks clean" in out and "gap8" in out
    assert analysis_main([str(good), str(bad)]) == 1
    assert "ranges.shift-range" in capsys.readouterr().out
