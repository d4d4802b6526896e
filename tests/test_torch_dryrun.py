"""The port's dry run (`repro_torch.launch.dryrun`), against the
reference's `repro.launch.dryrun`: the record's keys (less the two
renames), the skip reasons, the artifact names, resume and --force, the
exit codes, the meshes (`--mesh multi` / `both`: the multi-card mesh's
records; its counts are `test_torch_dryrun_multi.py`'s); and the small
repairs it needed: the meta face of `w8a8_dense` / `w8a8_bmm`,
`make_decode_step`'s pos, the production meshes.  Cells run a reduced config (d_model 64, four layers) at the
reference's full shapes, on meta tensors.
"""
import json
import types

import pytest
import torch

from repro.configs import base as rbase
from repro.launch import roofline as RR
from repro_torch.configs import base as tbase
from repro_torch.dist import op_analysis as oa
from repro_torch.kernels import w8a8_dense as kd
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.train import reduced
from repro_torch.models.transformer import build_model
from repro_torch.tree import leaves

META = torch.device("meta")
RENAMED = {"xla_cost_analysis_raw": "flop_counter_raw",
           "n_whiles": "n_loops"}
HLO = """HloModule m

ENTRY %main (a: f32[8,16]) -> f32[8,16] {
  ROOT %a = f32[8,16]{1,0} parameter(0)
}
"""


def reference_record_keys() -> set:
    """The keys of an `ok` record of the reference's `run_cell`."""
    compiled = types.SimpleNamespace(
        cost_analysis=lambda: {}, as_text=lambda: HLO,
        memory_analysis=lambda: types.SimpleNamespace())
    rec = RR.analyze_cell(compiled, rbase.get_config("qwen3_14b"),
                          rbase.SHAPES["decode_32k"],
                          types.SimpleNamespace(shape={"data": 1}), "single")
    return set(rec) | {"quant", "tag", "status", "lower_s", "compile_s"}


def small(arch="qwen3_14b"):
    return reduced(tbase.get_config(arch), d_model=64, layers=4)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_record_has_the_reference_keys(tmp_path, shape):
    cfg = small()
    rec = dryrun.run_cell("qwen3_14b", shape, "single", tmp_path,
                          arch_override=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == {RENAMED.get(k, k) for k in reference_record_keys()}
    assert (tmp_path / f"qwen3_14b__{shape}__single.json").exists()
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["chips"] == 1 and rec["collective_bytes_per_dev"] == 0
    mem = rec["memory"]
    kind = tbase.SHAPES[shape].kind
    args = steps.input_specs(cfg, tbase.SHAPES[shape])
    if kind == "train":        # the state is updated in place, its two
        # step counters made anew
        assert mem["alias_size_in_bytes"] == nbytes(args["state"]) - 8
    elif kind == "decode":     # so is the cache
        assert mem["alias_size_in_bytes"] == nbytes(args["cache"])
    else:
        assert mem["alias_size_in_bytes"] == 0
    assert mem["temp_size_in_bytes"] > 0
    assert rec["hbm_bytes_per_dev"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])


def test_quant_cell_counts_its_w8a8_products(tmp_path):
    rec = dryrun.run_cell("qwen3_14b", "decode_32k", "single", tmp_path,
                          arch_override=small(), quant=True, tag="t")
    assert rec["status"] == "ok", rec.get("traceback")
    assert (tmp_path / "qwen3_14b__decode_32k__single__w8a8__t.json").exists()
    # int8 peak for the whole cell, as the reference
    assert rec["terms"]["compute_s"] == pytest.approx(
        rec["flops_per_dev"] / 1.979e15)


def test_skip_reasons_are_the_references(tmp_path):
    rec = dryrun.run_cell("qwen3_14b", "long_500k", "single", tmp_path)
    ok, why = rbase.cell_is_runnable(rbase.get_config("qwen3_14b"),
                                     rbase.SHAPES["long_500k"])
    assert not ok and rec == {"arch": "qwen3_14b", "shape": "long_500k",
                              "mesh": "single", "quant": False, "tag": "",
                              "status": "skipped", "reason": why}
    rec = dryrun.run_cell("qwen3_14b", "train_4k", "single", tmp_path,
                          quant=True)
    assert rec["status"] == "skipped"
    assert rec["reason"] == "W8A8 is a serving path (PTQ after training)"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen3_14b__long_500k__single.json",
        "qwen3_14b__train_4k__single__w8a8.json"]


def test_resume_and_force(tmp_path, capsys):
    cfg = small()
    first = dryrun.run_cell("qwen3_14b", "decode_32k", "single", tmp_path,
                            arch_override=cfg)
    path = tmp_path / "qwen3_14b__decode_32k__single.json"
    path.write_text(json.dumps(dict(first, status="stale")))
    again = dryrun.run_cell("qwen3_14b", "decode_32k", "single", tmp_path,
                            arch_override=cfg)
    assert again["status"] == "stale"
    assert "[skip-existing] qwen3_14b__decode_32k__single.json: stale" in \
        capsys.readouterr().out
    forced = dryrun.run_cell("qwen3_14b", "decode_32k", "single", tmp_path,
                             force=True, arch_override=cfg)
    assert forced["status"] == "ok"
    assert json.loads(path.read_text())["status"] == "ok"


@pytest.mark.parametrize("mesh", ["multi", "both"])
def test_multi_and_both_write_multi_records(tmp_path, capsys, mesh):
    """qwen3_14b in full at decode_32k (ok) and long_500k (the
    reference's skip) on the mesh(es) asked for."""
    for shape in ("decode_32k", "long_500k"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "qwen3_14b", "--shape", shape, "--mesh",
                         mesh, "--out", str(tmp_path)])
        assert e.value.code == 0
    kinds = ["multi"] if mesh == "multi" else ["multi", "single"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"qwen3_14b__{s}__{k}.json" for s in ("decode_32k", "long_500k")
        for k in kinds)
    rec = json.loads((tmp_path / "qwen3_14b__decode_32k__multi.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 512 and rec["rank"] == 0
    assert rec["collective_bytes_per_dev"] > 0
    assert rec["terms"]["collective_s"] > 0
    skip = json.loads((tmp_path / "qwen3_14b__long_500k__multi.json")
                      .read_text())
    _, why = rbase.cell_is_runnable(rbase.get_config("qwen3_14b"),
                                    rbase.SHAPES["long_500k"])
    assert skip["status"] == "skipped" and skip["reason"] == why
    assert "x decode_32k x multi: dominant=" in capsys.readouterr().out


def test_main_exit_codes_and_the_error_record(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:       # default mesh: both
        dryrun.main(["--arch", "qwen3_14b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    assert (tmp_path / "qwen3_14b__long_500k__single.json").exists()
    assert (tmp_path / "qwen3_14b__long_500k__multi.json").exists()

    def broken(*a, **k):
        raise RuntimeError("no cell")
    monkeypatch.setattr(steps, "make_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3_14b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads(
        (tmp_path / "qwen3_14b__decode_32k__single.json").read_text())
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: no cell" and rec["traceback"]
    assert "[ERROR   ] qwen3_14b x decode_32k x single" in \
        capsys.readouterr().out


def test_donate_for_is_the_references():
    assert [dryrun.donate_for(k) for k in ("train", "prefill", "decode")] \
        == [(0,), (), (1,)]


def test_production_mesh_is_one_card():
    mesh = make_production_mesh()
    assert mesh_chips(mesh) == 1 and mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == (torch.device("cuda", 0),) and mesh.world is None


def test_multi_pod_mesh_is_2_32_8_at_8_cards_a_node():
    """The reference's axes and 512 devices, the model axis on one
    node's NVLink (see `launch.mesh`)."""
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.sizes == (2, 32, 8) and mesh_chips(mesh) == 512
    assert mesh.devices == tuple(torch.device("cuda", r % 8)
                                 for r in range(512))
    assert mesh.world is None


# ---------------------------------------------------------------------------
# the repairs: W8A8 on meta, decode pos
# ---------------------------------------------------------------------------
def _operands(E=None, M=5, K=48, N=24):
    g = torch.Generator().manual_seed(1)
    lead = () if E is None else (E,)
    xq = torch.randint(-128, 128, lead + (M, K), generator=g,
                       dtype=torch.int8)
    wt = torch.randint(-128, 128, lead + (N, K), generator=g,
                       dtype=torch.int8)
    n = torch.randint(-4, 5, lead + (N,), generator=g, dtype=torch.int32)
    return xq, wt, torch.tensor([3.0]), n


@pytest.mark.parametrize("out_dtype", kd.OUT_DTYPES)
@pytest.mark.parametrize("fn,E", [(kd.w8a8_dense, None), (kd.w8a8_bmm, 3)])
def test_w8a8_meta_face_has_the_plain_shape_and_dtype(fn, E, out_dtype):
    ops = _operands(E)
    plain = fn(*ops, out_dtype)
    n0 = fn.launches
    on_meta = [t.to(META) for t in ops]
    meta = fn(*on_meta, out_dtype)
    assert meta.device == META and fn.launches == n0
    assert (meta.shape, meta.dtype) == (plain.shape, plain.dtype)
    with oa.OpCounter() as c:
        fn(*on_meta, out_dtype)
    M, K, N = ops[0].shape[-2], ops[0].shape[-1], ops[1].shape[-2]
    e = E or 1
    assert c.cost.ops == {fn.__name__: 1}
    assert c.cost.flops == 2 * e * M * N * K
    assert c.cost.hbm_bytes == (e * M * K + e * N * K + 4 * e * N + 4
                                + e * M * N * plain.element_size())


@pytest.mark.parametrize("fn,E", [(kd.w8a8_dense, None), (kd.w8a8_bmm, 3)])
def test_w8a8_other_devices_still_raise(fn, E):
    xq, wt, xe, n = _operands(E)
    other = types.SimpleNamespace(device=torch.device("xla"), shape=xq.shape)
    with pytest.raises(NotImplementedError, match="xla"):
        fn(other, wt, xe, n)


def test_decode_step_takes_an_int_pos_and_refuses_a_meta_one():
    cfg = small()
    shape = tbase.ShapeSpec("d", "decode", 16, 2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cache = model.init_cache(2, 512, "cpu")
    tok = torch.ones((2, 1), dtype=torch.int32)
    step = steps.make_decode_step(cfg)
    logits, _ = step(params, cache, tok, shape.seq_len - 1)
    logits2, _ = step(params, cache, tok, torch.tensor(shape.seq_len - 1))
    assert torch.equal(logits, logits2) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="meta"):
        step(params, cache, tok, torch.empty((), dtype=torch.int32,
                                             device=META))
