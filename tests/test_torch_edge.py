"""The port's MCU export compiler (repro_torch.edge) against the
reference (repro.edge) on the same nets.

Float params come from the reference's initializer, cross as NumPy with
`repro_torch.convert`, and both packages PTQ them on the same
calibration images (`tests/test_torch_nn.py` holds the plans and int8
weights equal).  Then, bit for bit and byte for byte:

  * `lower` + `save` write the reference's `.capsbin` and manifest
    bytes; `emit_c` writes its `.c`/`.h` text and reproduces the golden
    files; `plan_arena`, `memory_report` and `estimate_program` (every
    MCU profile) are equal;
  * the port's EdgeVM equals the port's `torch`-backend forward and the
    reference's VM, op by op;
  * artifacts cross-load: a reference-written `.capsbin` serves in the
    port like the reference model, a port-written one loads in
    `repro.edge.load_qnet`; `lower(to_qnet(p))` is `p`;
  * `export_artifacts` and the `export_caps` CLI write the reference's
    files; `serve_caps --capsbin` serves an artifact on the CPU and
    refuses a tampered one.

Nets: EDGE_TINY (floor and nearest, per-tensor, per-channel convs,
per-out routing W, all 6 variant pairs) and the MNIST "L" net.
"""
import dataclasses
import json
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_image_dataset
from repro.edge import EdgeProgram as REdgeProgram
from repro.edge import EdgeVM as REdgeVM
from repro.edge import assign_offsets as r_assign_offsets
from repro.edge import emit_c as r_emit_c
from repro.edge import estimate_program as r_estimate_program
from repro.edge import export_artifacts as r_export_artifacts
from repro.edge import load_qnet as r_load_qnet
from repro.edge import lower as r_lower
from repro.edge import memory_report as r_memory_report
from repro.edge import plan_arena as r_plan_arena
from repro.launch import export_caps as r_export_caps
from repro.nn import MNIST as R_MNIST
from repro.nn import CapsPipeline as RPipeline
from repro.nn import VariantSet as RVariantSet
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro_torch.convert import params_from_reference
from repro_torch.edge import (MCU_PROFILES, EdgeOp, EdgeProgram, EdgeVM,
                              TensorSpec, assign_offsets, emit_c,
                              estimate_program, export_artifacts,
                              format_report, load_qnet, lower,
                              memory_report, plan_arena, program_config,
                              to_qnet)
from repro_torch.launch import export_caps, serve_caps
from repro_torch.nn import EDGE_TINY, MNIST, CapsPipeline, VariantSet
from repro_torch.nn import pipeline as port_pipeline
from repro_torch.nn.variants import all_variant_sets

CPU = "cpu"
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
# (per_channel convs, per-out routing W)
PLAN_KINDS = {"per_tensor": (False, False), "per_channel": (True, False),
              "per_out": (False, True)}
CFGS = {"edge_tiny": (R_EDGE_TINY, EDGE_TINY), "mnist": (R_MNIST, MNIST)}
NETS = [("edge_tiny", "floor", "per_tensor"),
        ("edge_tiny", "nearest", "per_tensor"),
        ("edge_tiny", "floor", "per_channel"),
        ("edge_tiny", "nearest", "per_channel"),
        ("edge_tiny", "floor", "per_out"),
        ("mnist", "floor", "per_tensor")]

_cache = {}


def np_tree(tree):
    return {k: {n: np.asarray(v) for n, v in d.items()}
            for k, d in tree.items()}


def pair(name, rounding="floor", kind="per_tensor"):
    """(reference QuantCapsNet, port QuantCapsNet on the CPU, int8 probe
    images [3, H, W, C]) for one net: the reference's params PTQ'd by
    each package on the same calibration images; cached."""
    key = (name, rounding, kind)
    if key not in _cache:
        rcfg, cfg = CFGS[name]
        pc, pw = PLAN_KINDS[kind]
        rng = np.random.default_rng(7)
        if name == "mnist":
            calib = make_image_dataset("mnist", 8, seed=1)[0]
        else:
            calib = rng.uniform(0, 1, (16,) + rcfg.input_shape) \
                .astype(np.float32)
        x = rng.uniform(0, 1, (3,) + rcfg.input_shape).astype(np.float32)
        rpipe = RPipeline.from_config(rcfg, per_channel=pc,
                                      per_channel_w=pw)
        rparams = rpipe.init(jax.random.key(0))
        rq = rpipe.quantize(rparams, jnp.asarray(calib), rounding=rounding)
        pipe = CapsPipeline.from_config(cfg, per_channel=pc,
                                        per_channel_w=pw)
        q = pipe.quantize(params_from_reference(np_tree(rparams),
                                                device=CPU),
                          calib, rounding=rounding)
        _cache[key] = (rq, q, np.array(rq.quantize_input(jnp.asarray(x))))
    return _cache[key]


def forward(q, x_q):
    with torch.inference_mode():
        return q.forward(torch.from_numpy(x_q)).numpy()


def net_id(key):
    return "-".join(key)


def assert_same_files(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert pathlib.Path(a[k]).read_bytes() == \
            pathlib.Path(b[k]).read_bytes(), k


# ---------------------------------------------------------------------------
# lowering and files, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", NETS, ids=net_id)
def test_lowered_artifacts_are_the_references_bytes(key, tmp_path):
    rq, q, _ = pair(*key)
    rp, pp = r_lower(rq), lower(q)
    assert pp.header() == rp.header()
    assert_same_files(pp.save(tmp_path / "port" / "m"),
                      rp.save(tmp_path / "ref" / "m"))
    assert emit_c(pp) == r_emit_c(rp)
    plan, rplan = plan_arena(pp), r_plan_arena(rp)
    assert dataclasses.asdict(plan) == dataclasses.asdict(rplan)
    assert memory_report(pp) == r_memory_report(rp)
    assert format_report(memory_report(pp, profile="gap8")) == \
        format_report(r_memory_report(rp, profile="gap8"))
    for profile in MCU_PROFILES:
        assert estimate_program(pp, profile) == \
            r_estimate_program(rp, profile)


def _golden_arr(shape, lo=-90):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.int32) * 37 % 181 + lo) \
        .astype(np.int8).reshape(shape)


def golden_program() -> EdgeProgram:
    """tests/test_edge.py's hand-built golden program, built with the
    port's classes."""
    tensors = (
        TensorSpec(0, "input", (8, 8, 1), 7),
        TensorSpec(1, "conv0.out", (6, 6, 4), 5),
        TensorSpec(2, "pcap.caps", (8, 2), 7),
        TensorSpec(3, "caps.v", (2, 2), 7),
    )
    conv = EdgeOp("CONV_Q7", "conv0", (0,), 1, {
        "kernel": 3, "stride": 1, "in_ch": 1, "out_ch": 4, "relu": True,
        "in_frac": 7, "w_frac": 7, "b_frac": 8, "out_frac": 5,
        "out_shift": 9, "bias_shift": 6,
        "w_frac_per_channel": (7, 8, 7, 7),
        "out_shift_per_channel": (9, 10, 9, 9),
        "bias_shift_per_channel": (6, 7, 6, 6),
    }, {"w": _golden_arr((3, 3, 1, 4)), "b": _golden_arr((4,))})
    pcap = EdgeOp("PRIMARY_CAPS_Q7", "pcap", (1,), 2, {
        "kernel": 3, "stride": 2, "in_ch": 4, "out_ch": 4, "relu": False,
        "in_frac": 5, "w_frac": 7, "b_frac": 8, "out_frac": 6,
        "out_shift": 6, "bias_shift": 4, "caps": 2, "dim": 2,
        "squash_in_frac": 6, "squash_out_frac": 7,
    }, {"w": _golden_arr((3, 3, 4, 4)), "b": _golden_arr((4,))})
    caps = EdgeOp("CAPS_ROUTING_Q7", "caps", (2,), 3, {
        "num_out": 2, "num_in": 8, "out_dim": 2, "in_dim": 2,
        "routings": 2, "in_frac": 7, "W_frac": 7, "uhat_frac": 7,
        "uhat_shift": 7, "logit_frac": 7,
        "caps_out_shifts": (5, 5), "caps_out_fracs": (9, 9),
        "agree_shifts": (7,), "softmax_impl": "q7",
        "squash_out_frac": 7,
    }, {"W": _golden_arr((2, 8, 2, 2))})
    return EdgeProgram(name="golden_caps", rounding="floor",
                       input_frac=7, tensors=tensors,
                       ops=(conv, pcap, caps))


def golden_program_approx() -> EdgeProgram:
    base = golden_program()
    ops = []
    for op in base.ops:
        attrs = dict(op.attrs)
        if op.kind == "PRIMARY_CAPS_Q7":
            attrs["squash_impl"] = "approx"
        elif op.kind == "CAPS_ROUTING_Q7":
            attrs["softmax_impl"] = "approx"
            attrs["squash_impl"] = "approx"
        ops.append(dataclasses.replace(op, attrs=attrs))
    return dataclasses.replace(base, name="golden_caps_approx",
                               ops=tuple(ops))


@pytest.mark.parametrize("make", [golden_program, golden_program_approx])
def test_emit_c_reproduces_the_golden_files(make, tmp_path):
    program = make()
    src = emit_c(program)
    for ext in ("c", "h"):
        golden = (GOLDEN_DIR / f"{program.name}.{ext}").read_text()
        assert src[ext] + "\n" == golden
    # the golden program also runs in the VM as the reference's does
    ref = REdgeProgram.load(program.save(tmp_path / "g")["capsbin"])
    x = (np.arange(64, dtype=np.int32) % 201 - 100).astype(np.int8)
    np.testing.assert_array_equal(EdgeVM(program).run(x.reshape(8, 8, 1)),
                                  REdgeVM(ref).run(x.reshape(8, 8, 1)))


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", NETS, ids=net_id)
def test_vm_equals_the_port_forward_and_the_reference_vm(key):
    rq, q, x_q = pair(*key)
    trace, rtrace = {}, {}
    v = EdgeVM(lower(q)).run(x_q, trace=trace)
    assert v.dtype == np.int8 and v.shape == (3,) + \
        (q.pipeline.cfg.num_classes, q.pipeline.cfg.caps_dim)
    np.testing.assert_array_equal(v, forward(q, x_q))
    np.testing.assert_array_equal(v, REdgeVM(r_lower(rq))
                                  .run(x_q, trace=rtrace))
    assert list(trace) == list(rtrace)
    for name in trace:
        np.testing.assert_array_equal(trace[name], rtrace[name])


@pytest.mark.parametrize("tag", [v.tag for v in all_variant_sets()])
def test_every_variant_lowers_and_runs_as_the_reference(tag, tmp_path):
    rq, q, x_q = pair("edge_tiny", "nearest")
    sm, sq = tag.split("+")
    rqv = rq.with_variants(RVariantSet(softmax=sm, squash=sq))
    qv = q.with_variants(VariantSet(softmax=sm, squash=sq))
    rp, pp = r_lower(rqv), lower(qv)
    assert_same_files(pp.save(tmp_path / "port" / "m"),
                      rp.save(tmp_path / "ref" / "m"))
    assert emit_c(pp) == r_emit_c(rp)
    v = EdgeVM(pp).run(x_q)
    np.testing.assert_array_equal(v, REdgeVM(rp).run(x_q))
    # "precise" is float32 in both faces: matched in value, and on these
    # images to the bit
    np.testing.assert_array_equal(v, forward(qv, x_q))
    q2 = to_qnet(pp, device=CPU)
    assert q2.variants == qv.variants
    assert lower(q2, name=pp.name).same_as(pp)


def test_vm_single_sample_and_bad_input():
    _, q, x_q = pair("edge_tiny")
    vm = EdgeVM(lower(q))
    np.testing.assert_array_equal(vm.run(x_q[0]), vm.run(x_q)[0])
    with pytest.raises(TypeError):
        vm.run(x_q.astype(np.float32))
    with pytest.raises(ValueError):
        vm.run(x_q[:, :4])
    images = np.random.default_rng(3).uniform(0, 1, (2, 16, 16, 1))
    np.testing.assert_array_equal(
        vm.quantize_input(images),
        q.quantize_input(torch.from_numpy(images).float()).numpy())


def test_vm_asserts_a_tampered_acc_bound():
    _, q, x_q = pair("edge_tiny")
    program = lower(q)
    ops = list(program.ops)
    ops[0] = dataclasses.replace(ops[0], attrs={**ops[0].attrs,
                                                "acc_bound": 7})
    with pytest.raises(AssertionError, match="acc_bound"):
        EdgeVM(dataclasses.replace(program, ops=tuple(ops))).run(x_q)


# ---------------------------------------------------------------------------
# artifacts across the two packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["per_tensor", "per_channel", "per_out"])
def test_a_reference_artifact_serves_in_the_port(kind, tmp_path):
    rq, _, x_q = pair("edge_tiny", "nearest", kind)
    paths = r_lower(rq).save(tmp_path / "ref")
    q2 = load_qnet(paths["capsbin"], device=CPU)
    assert q2.backend == "torch" and q2.device.type == "cpu"
    np.testing.assert_array_equal(forward(q2, x_q),
                                  np.asarray(rq.forward(jnp.asarray(x_q))))
    program = EdgeProgram.load(paths["capsbin"])
    assert lower(q2, name=program.name).same_as(program)


@pytest.mark.parametrize("key", [NETS[1], NETS[3], NETS[5]], ids=net_id)
def test_a_port_artifact_loads_in_the_reference(key, tmp_path):
    _, q, x_q = pair(*key)
    paths = lower(q).save(tmp_path / "port")
    rq2 = r_load_qnet(paths["capsbin"])
    np.testing.assert_array_equal(np.asarray(rq2.forward(jnp.asarray(x_q))),
                                  forward(q, x_q))


@pytest.mark.parametrize("key", NETS, ids=net_id)
def test_importer_round_trip(key):
    _, q, x_q = pair(*key)
    program = lower(q)
    q2 = to_qnet(program, device=CPU)
    assert lower(q2, name=program.name).same_as(program)
    np.testing.assert_array_equal(forward(q2, x_q), forward(q, x_q))
    assert program_config(program) == dataclasses.replace(
        q.pipeline.cfg, name=program.name)


def test_importer_rejects_malformed_schedules():
    _, q, _ = pair("edge_tiny")
    program = lower(q)
    doubled = dataclasses.replace(program,
                                  ops=program.ops + (program.ops[-1],))
    with pytest.raises(ValueError, match="CAPS_ROUTING_Q7"):
        program_config(doubled)
    with pytest.raises(ValueError):
        to_qnet(doubled, device=CPU)


def _rewrite_header(capsbin, edit):
    """Re-serialize a .capsbin with `edit(header_dict)` applied."""
    raw = pathlib.Path(capsbin).read_bytes()
    (hlen,) = struct.unpack_from("<I", raw, 8)
    header = json.loads(raw[12:12 + hlen].decode())
    payload = raw[(12 + hlen + 15) // 16 * 16:]
    edit(header)
    hbytes = json.dumps(header, sort_keys=True).encode()
    blob = raw[:8] + struct.pack("<I", len(hbytes)) + hbytes
    blob += b"\x00" * (-len(blob) % 16) + payload
    out = pathlib.Path(capsbin).with_suffix(".tampered.capsbin")
    out.write_bytes(blob)
    return out


def test_load_refuses_what_the_reference_refuses(tmp_path):
    _, q, _ = pair("edge_tiny")
    program = lower(q)
    paths = program.save(tmp_path / "m")
    garbage = tmp_path / "x.capsbin"
    garbage.write_bytes(b"not a capsbin at all")

    def bad_nbytes(h):
        h["ops"][0]["weights"]["w"]["nbytes"] += 1

    def bad_offset(h):
        h["ops"][0]["weights"]["w"]["offset"] = 1 << 30

    def bad_version(h):
        h["version"] = 2

    for path in (garbage,) + tuple(
            _rewrite_header(paths["capsbin"], e)
            for e in (bad_nbytes, bad_offset, bad_version)):
        with pytest.raises(ValueError) as ours:
            EdgeProgram.load(path)
        with pytest.raises(ValueError) as theirs:
            REdgeProgram.load(path)
        assert str(ours.value) == str(theirs.value)
    blob = bytearray(paths["capsbin"].read_bytes())
    blob[-3] ^= 0x55                 # a bit inside the last weight
    paths["capsbin"].write_bytes(bytes(blob))
    assert not program.same_as(EdgeProgram.load(paths["capsbin"]))


def test_assign_offsets_equals_the_reference_on_random_blocks():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 25))
        blocks = []
        for i in range(n):
            a, b = (int(v) for v in rng.integers(0, 10, 2))
            blocks.append((i, int(rng.integers(1, 501)),
                           (min(a, b), max(a, b))))
        assert assign_offsets(blocks) == r_assign_offsets(blocks)


# ---------------------------------------------------------------------------
# export and the command lines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", [NETS[0], NETS[3]], ids=net_id)
def test_export_artifacts_writes_the_references_files(key, tmp_path):
    rq, q, _ = pair(*key)
    images = np.random.default_rng(5).uniform(
        0, 1, (4,) + tuple(q.pipeline.cfg.input_shape)).astype(np.float32)
    ours = export_artifacts(q, tmp_path / "port", stem="m",
                            verify_images=images)
    theirs = r_export_artifacts(rq, tmp_path / "ref", stem="m",
                                verify_images=jnp.asarray(images))
    assert ours["verified"] == theirs["verified"] == 4
    assert ours["checked"] is True
    assert ours["report"] == theirs["report"]
    assert {p.suffix for p in ours["paths"].values()} == \
        {".capsbin", ".json", ".c", ".h"}
    assert_same_files(ours["paths"], theirs["paths"])


@pytest.fixture
def reference_init(monkeypatch):
    """The port's CapsPipeline.init drawing the reference's params for the
    same seed (jax.random.key), so a registry build PTQs the net the
    reference's registry builds."""
    def init(self, generator, device=None):
        seed = generator.initial_seed()
        rpipe = RPipeline.from_config(R_EDGE_TINY)
        return params_from_reference(
            np_tree(rpipe.init(jax.random.key(seed))), device=device)
    monkeypatch.setattr(port_pipeline.CapsPipeline, "init", init)


@pytest.mark.parametrize("flags", [[], ["--rounding", "nearest",
                                        "--per-channel"],
                                   ["--softmax", "approx"]], ids=str)
def test_export_caps_cli_writes_the_reference_clis_files(
        flags, reference_init, tmp_path, capsys):
    assert r_export_caps.main(["--model", "edge_tiny", "--stem", "e",
                               "--out", str(tmp_path / "ref"), *flags]) == 0
    assert export_caps.main(["--model", "edge_tiny", "--stem", "e",
                             "--out", str(tmp_path / "port"),
                             "--device", CPU, "--profile", *flags]) == 0
    out = capsys.readouterr().out
    assert "VM re-verified bit-exact on 4 images" in out
    assert "cortex-m7" in out and "gap8" in out
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == ["e.c", "e.capsbin", "e.h", "e.manifest.json"]
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "ref" / n).read_bytes(), n


def test_export_caps_cli_refuses_an_unknown_model(tmp_path, capsys):
    assert export_caps.main(["--model", "nope", "--out", str(tmp_path),
                             "--device", CPU]) == 2
    assert "unknown model" in capsys.readouterr().err


def test_serve_caps_serves_an_artifact_and_refuses_a_tampered_one(
        tmp_path, capsys):
    _, q, _ = pair("edge_tiny")
    program = lower(q)
    good = program.save(tmp_path / "good")["capsbin"]
    assert serve_caps.main(["--capsbin", str(good), "--requests", "5",
                            "--buckets", "1,4", "--device", CPU,
                            "--export", str(tmp_path / "again")]) == 0
    out = capsys.readouterr().out
    assert "imported" in out and "backend=torch" in out
    assert "serve: 5 imgs" in out
    # re-exported from the served artifact: the same program, renamed
    again = EdgeProgram.load(tmp_path / "again" / "capsnet_edge_tiny.capsbin")
    assert again.same_as(dataclasses.replace(program,
                                             name="capsnet_edge_tiny"))

    ops = list(program.ops)
    ops[0] = dataclasses.replace(ops[0], attrs={
        **ops[0].attrs, "out_shift": ops[0].attrs["out_shift"] + 40})
    bad = dataclasses.replace(program, ops=tuple(ops)).save(
        tmp_path / "bad")["capsbin"]
    assert serve_caps.main(["--capsbin", str(bad), "--requests", "2",
                            "--device", CPU]) == 1
    err = capsys.readouterr().err
    assert "STATIC CHECK FAILED" in err and "ranges.shift-range" in err
    # the plan edit of --softmax on an artifact
    assert serve_caps.main(["--capsbin", str(good), "--requests", "2",
                            "--softmax", "approx", "--device", CPU]) == 0
    assert "variants=approx+exact" in capsys.readouterr().out
