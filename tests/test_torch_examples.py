"""The port's four examples (`examples/torch_*.py`) and the last public
functions of `repro` that had no counterpart, against the reference on
the CPU.

* quickstart: the reference's MNIST params (`CapsPipeline.init(
  jax.random.key(0))`) carried across with `convert.params_from_reference`;
  the footprint, the caps plan's shifts, sample 0's class lengths, the
  served preds and the artifact's flash / RAM / arena bytes equal the
  reference's quickstart steps computed on its `jnp` backend (the Pallas
  interpret path is too slow here);
* the footprints of MNIST, smallNORB and CIFAR-10 in full: fp32 bytes,
  int8 `memory_bytes` and `saving_pct` equal the reference's exactly, and
  equal the numbers `chip_smoke.py` holds the card's Table-2 rows to;
* train_capsnet at EDGE_TINY: the printed table has the reference's
  `format_rows` columns, and its footprint and latency columns equal the
  reference's `table2_rows` at the same settings; the float state its
  `--ckpt-dir` keeps, quantized by `tools/table2_witness.py`, gives the
  row's acc_ptq on the port's oracle and on the reference, from equal
  plans;
* serve_quantized_lm at d_model 64 on carried weights: bf16 and W8A8 bytes
  exact, greedy tokens equal to the reference example's `run_wave`, with
  XLA's inexact CPU exp2 made exact on the reference side as
  tests/test_torch_lm_quant.py does (float and W8A8);
* train_lm: `sized_config` gives the reference's (d, L, n), and a rerun
  prints `[resume] step N`;
* `core.routing.dynamic_routing` within atol 1e-5 of the reference,
  `edge.vm.execute` equal to `EdgeVM(program).run`,
  `serving.registry.config_for_dataset`, `VariantSet.to_json` /
  `from_json`, the `CapsLayer` protocol and `lm_quant.HEAD_LEAF_NAMES`.
"""
import dataclasses
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.captrain import TrainConfig as RTrainConfig
from repro.captrain import format_rows as r_format_rows
from repro.captrain import table2_rows as r_table2_rows
from repro.configs.base import get_config as rget
from repro.core.routing import dynamic_routing as r_dynamic_routing
from repro.data.synthetic import make_image_dataset
from repro.edge import lower as r_lower
from repro.edge import memory_report as r_memory_report
from repro.launch.train import reduced as r_reduced
from repro.models.transformer import build_model as r_build_model
from repro.models.transformer import decode_alloc as r_decode_alloc
from repro.nn import CIFAR10 as R_CIFAR10
from repro.nn import MNIST as R_MNIST
from repro.nn import SMALLNORB as R_SMALLNORB
from repro.nn import CapsPipeline as RPipeline
from repro.nn import VariantSet as RVariantSet
from repro.nn import all_variant_sets as r_all_variant_sets
from repro.quant import lm_quant as RQ
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro.serving.registry import config_for_dataset as r_config_for_dataset
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_reference, \
    params_from_reference
from repro_torch.core.routing import dynamic_routing
from repro_torch.edge import EdgeVM, execute, lower
from repro_torch.launch.train import reduced
from repro_torch.nn import (CIFAR10, EDGE_TINY, MNIST, SMALLNORB, CapsLayer,
                            CapsPipeline, VariantSet)
from repro_torch.nn.variants import all_variant_sets
from repro_torch.quant import lm_quant as TQ
from repro_torch.serving import ModelRegistry, default_specs
from repro_torch.serving.registry import config_for_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
NETS = {"mnist": (MNIST, R_MNIST), "smallnorb": (SMALLNORB, R_SMALLNORB),
        "cifar10": (CIFAR10, R_CIFAR10)}
# the paper's three networks in full: (fp32 bytes, int8 memory_bytes);
# chip_smoke.py holds the card's Table-2 rows to the same numbers
FOOTPRINTS = {"mnist": (1_187_200, 296_912),
              "smallnorb": (1_182_336, 295_696),
              "cifar10": (461_184, 115_480)}


def load(name: str):
    """A script as a module (examples/NAME.py, tools/NAME.py or
    ROOT/NAME.py)."""
    path = next(p for p in (ROOT / "examples" / f"{name}.py",
                            ROOT / "tools" / f"{name}.py",
                            ROOT / f"{name}.py") if p.exists())
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def exact_exp2(x):
    """2^x for integer-valued float x, exactly (from the exponent bits)."""
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def test_quickstart_on_carried_weights_equals_the_references():
    rpipe = RPipeline.from_config(R_MNIST)
    rparams = rpipe.init(jax.random.key(0))
    calib = jnp.asarray(make_image_dataset("mnist", 64, seed=1)[0])
    rq = rpipe.quantize(rparams, calib, rounding="nearest")
    fp32, int8 = rpipe.param_bytes(rparams), rq.memory_bytes()
    x = make_image_dataset("mnist", 4, seed=2)[0]
    v = rq.forward(rq.quantize_input(jnp.asarray(x)))
    lengths0 = np.asarray(rq.class_lengths(v))[0]
    images = make_image_dataset("mnist", 6, seed=3)[0]
    preds = np.asarray(jnp.argmax(rq.class_lengths(
        rq.forward(rq.quantize_input(jnp.asarray(images)))), -1)).tolist()
    rmem = r_memory_report(r_lower(rq, name="mnist_L"))

    lines = []
    got = load("torch_quickstart").quickstart(
        params=params_from_reference(np_tree(rparams), device=CPU),
        device=CPU, log=lines.append)
    assert got["footprint"] == {"fp32_kb": fp32 / 1024.0,
                                "int8_kb": int8 / 1024.0,
                                "saving_pct": 100.0 * (1 - int8 / fp32)}
    rplan, plan = rq.plan["caps"], got["plan"]
    assert (plan.uhat_shift, plan.logit_frac, plan.caps_out_shifts) == \
        (rplan.uhat_shift, rplan.logit_frac, tuple(rplan.caps_out_shifts))
    np.testing.assert_array_equal(got["lengths0"], lengths0)
    assert got["preds"] == preds
    assert got["match"] is None            # the cuda backend: card only
    for k in ("flash_bytes", "ram_bytes", "arena_bytes"):
        assert got["report"][k] == rmem[k], k
    assert got["verified"] == 4
    assert lines[-1] == "quickstart OK"
    assert any(line.startswith("   footprint: fp32 ") for line in lines)


@pytest.mark.parametrize("net", sorted(NETS))
def test_footprints_of_the_three_networks_equal_the_references(net):
    """Table 2's columns are geometry: any weights give them.  The
    reference quantizes its own init, the port its own, each calibrated
    on two images."""
    cfg, rcfg = NETS[net]
    calib = make_image_dataset(net, 2, seed=1)[0]
    rpipe = RPipeline.from_config(rcfg)
    rparams = rpipe.init(jax.random.key(0))
    r_fp32 = rpipe.param_bytes(rparams)
    r_int8 = rpipe.quantize(rparams, jnp.asarray(calib)).memory_bytes()
    pipe = CapsPipeline.from_config(cfg)
    params = pipe.init(torch.Generator().manual_seed(0), CPU)
    fp32 = pipe.param_bytes(params)
    int8 = pipe.quantize(params, calib).memory_bytes()
    assert (fp32, int8) == (r_fp32, r_int8) == FOOTPRINTS[net]
    assert 100.0 * (1 - int8 / fp32) == 100.0 * (1 - r_int8 / r_fp32)


def test_chip_smoke_holds_the_card_to_the_pinned_footprints():
    assert load("chip_smoke").TABLE2_FOOTPRINTS == FOOTPRINTS


# ---------------------------------------------------------------------------
# train_capsnet
# ---------------------------------------------------------------------------
def test_train_capsnet_at_edge_tiny_prints_the_references_table():
    settings = dict(float_steps=4, qat_steps=2, eval_n=32)
    lines = []
    rows = load("torch_train_capsnet").train_capsnet(
        "edge_tiny", steps=settings["float_steps"],
        qat_steps=settings["qat_steps"], batch=32,
        eval_n=settings["eval_n"], device=CPU, log=lines.append)
    rrows = r_table2_rows(R_EDGE_TINY,
                          RTrainConfig(dataset="edge_tiny", batch=32,
                                       lr=R_EDGE_TINY.lr), **settings)
    assert [r.rounding for r in rows] == [r.rounding for r in rrows] == \
        ["floor", "nearest"]
    table = "\n".join(lines)
    rtable = r_format_rows(rrows).splitlines()
    assert rtable[0] in table                  # the same columns
    for r, rr in zip(rows, rrows):
        for col in ("name", "variant", "source", "saving_pct", "est_ms_m7",
                    "est_ms_gap8", "flash_bytes", "ram_bytes"):
            assert getattr(r, col) == getattr(rr, col), col
        for acc in (r.acc_f32, r.acc_ptq, r.acc_qat):
            assert 0.0 <= acc <= 1.0


def test_table2_witness_quantizes_the_kept_float_state_as_the_reference(
        tmp_path):
    rows = load("torch_train_capsnet").train_capsnet(
        "edge_tiny", steps=50, qat_steps=1, batch=32, eval_n=32,
        ckpt_dir=str(tmp_path), device=CPU, log=lambda *a: None)
    res = load("table2_witness").witness(str(tmp_path), "edge_tiny",
                                         eval_n=32)
    assert res["step"] == 50                  # the float run's last step
    assert res["acc_f32"] == rows[0].acc_f32
    for row in rows:
        assert res["port"][row.rounding] == row.acc_ptq
        assert res["reference"][row.rounding] == row.acc_ptq
        assert res["plans_equal"][row.rounding]


# ---------------------------------------------------------------------------
# serve_quantized_lm
# ---------------------------------------------------------------------------
def test_serve_quantized_lm_on_carried_weights_equals_the_references(
        monkeypatch):
    monkeypatch.setattr(RQ.jnp, "exp2", exact_exp2)
    requests, prompt_len, gen = 2, 16, 6
    rcfg = r_reduced(rget("stablelm_3b"), d_model=64)
    rmodel = r_build_model(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    rq = RQ.quantize_lm_params(rparams)
    fp_bytes = sum(l.size * l.dtype.itemsize
                   for l in jax.tree_util.tree_leaves(rparams))
    ref = load("serve_quantized_lm")
    prompts = jnp.asarray(ref.TokenTask(
        rcfg.vocab_size, prompt_len, seed=3).batch(0, requests)["inputs"])
    run_wave = ref.run_wave
    alloc = r_decode_alloc(prompt_len + gen)
    g_f, _, _ = run_wave(rmodel, rparams, prompts, gen, alloc, {})
    g_q, _, _ = run_wave(rmodel, rq, prompts, gen, alloc, {})

    cfg = reduced(get_config("stablelm_3b"), d_model=64)
    lines = []
    got = load("torch_serve_quantized_lm").serve_quantized_lm(
        cfg, params=lm_params_from_reference(np_tree(rparams), device=CPU),
        requests=requests, prompt_len=prompt_len, gen=gen, device=CPU,
        log=lines.append)
    assert got["fp_bytes"] == fp_bytes
    assert got["q_bytes"] == RQ.quantized_bytes(rq)
    np.testing.assert_array_equal(got["tokens_float"], g_f)
    np.testing.assert_array_equal(got["tokens_w8a8"], g_q)
    assert got["agree"] == float((g_f == g_q).mean())
    assert lines[-1].startswith("  greedy-token agreement float vs w8a8: ")


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("target", [1e6, 25e6, 100e6, 350e6])
def test_sized_config_is_the_references(target):
    ref = load("train_lm")
    rlines, lines = [], []
    with mock.patch("builtins.print", rlines.append):
        rcfg = ref.sized_config(target)
    cfg = load("torch_train_lm").sized_config(target, log=lines.append)
    assert lines == rlines
    fields = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "blocks")
    assert {f: getattr(cfg, f) for f in fields} == \
        {f: getattr(rcfg, f) for f in fields}


def test_train_lm_rerun_resumes_from_its_checkpoint(tmp_path):
    ex = load("torch_train_lm")
    kw = dict(target_params=1e6, batch=2, seq=32, ckpt_dir=tmp_path,
              device=CPU)
    lines = []
    first = ex.train_lm(steps=2, log=lines.append, **kw)
    assert first["start"] == 0 and len(first["log"]) == 2
    assert not any("[resume]" in line for line in lines)
    lines.clear()
    second = ex.train_lm(steps=3, log=lines.append, **kw)
    assert "[resume] step 2" in lines
    assert second["start"] == 2 and [r["step"] for r in second["log"]] == [2]
    assert np.isfinite(second["log"][0]["loss"])


# ---------------------------------------------------------------------------
# the last public functions of repro
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 10, 32, 6), (3, 5, 17, 8)])
@pytest.mark.parametrize("iters", [1, 3])
def test_dynamic_routing_matches_the_reference(shape, iters):
    u = np.random.default_rng(0).normal(0, 0.3, shape).astype(np.float32)
    rv, rc = r_dynamic_routing(jnp.asarray(u), num_iters=iters)
    v, c = dynamic_routing(torch.from_numpy(u), num_iters=iters)
    assert c is None and rc is None
    assert v.dtype == torch.float32 and v.shape == shape[:2] + shape[3:]
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0, atol=1e-5)


def test_dynamic_routing_casts_back_to_u_hats_dtype():
    u = np.random.default_rng(1).normal(0, 0.3, (2, 4, 8, 4))
    u16 = torch.from_numpy(u.astype(np.float32)).to(torch.bfloat16)
    v, _ = dynamic_routing(u16)
    rv, _ = r_dynamic_routing(jnp.asarray(u.astype(np.float32))
                              .astype(jnp.bfloat16))
    assert v.dtype == torch.bfloat16 and rv.dtype == jnp.bfloat16
    np.testing.assert_allclose(v.float().numpy(),
                               np.asarray(rv.astype(jnp.float32)),
                               rtol=0, atol=1e-2)


def test_execute_is_edge_vm_run():
    reg = ModelRegistry({"e": default_specs()["edge_tiny@torch"]},
                        device=CPU)
    program = lower(reg.model("e"))
    x = np.random.default_rng(2).integers(
        -128, 128, (3,) + tuple(program.input_tensor.shape), dtype=np.int8)
    np.testing.assert_array_equal(execute(program, x),
                                  EdgeVM(program).run(x))
    np.testing.assert_array_equal(execute(program, x[0]),
                                  EdgeVM(program).run(x[0]))


@pytest.mark.parametrize("dataset", ["mnist", "smallnorb", "cifar10",
                                     "edge_tiny"])
def test_config_for_dataset_is_the_references_geometry(dataset):
    """The reference's `config_for_dataset` knows the paper's three
    datasets; its EDGE_TINY lives in `repro.serving.registry`, which the
    port's CAPSNET_CONFIGS also holds."""
    ref = r_config_for_dataset(dataset) if dataset != "edge_tiny" \
        else R_EDGE_TINY
    assert dataclasses.asdict(config_for_dataset(dataset)) == \
        dataclasses.asdict(ref)


def test_variant_set_json_is_the_references():
    sets = all_variant_sets()
    assert len(sets) == len(r_all_variant_sets()) > 1
    for vs, rvs in zip(sets, r_all_variant_sets()):
        assert vs.to_json() == rvs.to_json()
        assert VariantSet.from_json(vs.to_json()) == vs
        assert VariantSet.from_json(rvs.to_json()).tag == rvs.tag
    assert VariantSet.from_json({}) == VariantSet()
    assert VariantSet.from_json({}).to_json() == \
        RVariantSet.from_json({}).to_json()
    assert VariantSet.from_json({"squash": "approx"}).to_json() == \
        RVariantSet.from_json({"squash": "approx"}).to_json()


def test_every_port_layer_is_a_caps_layer():
    layers = [l for cfg in (MNIST, SMALLNORB, CIFAR10, EDGE_TINY)
              for kw in ({}, dict(per_channel=True, per_channel_w=True))
              for l in CapsPipeline.from_config(cfg, **kw).layers]
    assert {type(l).__name__ for l in layers} == \
        {"QuantConv2D", "PrimaryCaps", "CapsuleRouting"}
    assert all(isinstance(l, CapsLayer) for l in layers)
    assert not isinstance(object(), CapsLayer)


def test_head_leaf_names_are_the_references():
    assert TQ.HEAD_LEAF_NAMES == RQ.HEAD_LEAF_NAMES
    assert TQ.QUANT_LEAF_NAMES == RQ.QUANT_LEAF_NAMES
