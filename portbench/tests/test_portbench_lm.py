"""Language-model cells on the CPU (the harness's look for a card
skipped), at reduced(mixtral_8x22b) widths and 2 layers: a whole run is
correct, the control and every planted fault are not, the program agrees
with the plain reference (bit for bit where its activations are float32),
the LM configuration loads beside the CapsNets, the yardstick's counts
match hand counts at the published widths, and a configuration, a cell
and a block kind's reference are added by files alone."""
import contextlib
import json
import shutil

import pytest
import torch

from portbench import (lm_data, lm_faults, lm_harness, lm_reference,
                       lm_yardstick, spec)

CELL = "mixtral_8x22b_w8a8_14L-offline"
# reduced(get_config("mixtral_8x22b")) of repro_torch.launch.train, 2 layers
REDUCED = {"num_layers": 2, "d_model": 256, "num_heads": 4, "num_kv_heads": 4,
           "head_dim": 64, "d_ff": 1024, "vocab_size": 4096, "num_experts": 4,
           "capacity_factor": 2.0, "window_size": 64}
TRAFFIC = {"kind": "waves", "batch": 4, "prompt_len": 16, "gen": 32,
           "pool": 16}
SEED = 2 ** 33 + 21
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _cell(**cfg):
    c = spec.cell(CELL)
    return spec.Cell(name="tiny-offline", config_name="tiny", chips=1,
                     config={**c.config, **REDUCED, **cfg}, traffic=TRAFFIC,
                     end_to_end=c.end_to_end, per_layer=c.per_layer)


def _run(cell=None, trace=False, seed=SEED, seconds=0.05):
    return lm_harness.run_cell(cell or _cell(), seed, seconds, trace,
                               device="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_lm_run_is_correct_and_result_keys(trace):
    res, det = _run(trace=trace)
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == det["waves"] * TRAFFIC["batch"]
    assert det["compared"] == TRAFFIC["batch"] * TRAFFIC["gen"]
    if trace:
        assert {"lm.prefill_ms.offline", "lm.decode_step_ms.offline",
                "lm.decode_host_ms.offline", "mfu_int8.offline",
                "ptq_s.offline"} <= set(res["metrics"])
        # no profile on the CPU: the device readers read nothing
        assert not {"w8a8_bmm_roofline.offline",
                    "device.idle_pct.offline"} & set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"setup_s", "tokens_per_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


def test_lm_window_is_whole_waves():
    res, det = _run(seconds=0.05)
    assert det["waves"] >= 1 and abs(sum(det["wave_s"]) - det["window_s"]) \
        < 0.05 * det["window_s"] + 1e-3
    tps = res["metrics"]["tokens_per_s"]["value"]
    assert tps == pytest.approx(det["waves"] * TRAFFIC["batch"]
                                * TRAFFIC["gen"] / det["window_s"])


def test_lm_control_fails():
    with lm_faults.control():
        res, _ = _run()
    assert res["correct"] is False


@pytest.mark.parametrize("kind", lm_faults.CAUGHT)
def test_lm_planted_fault_fails(kind):
    with lm_faults.fault(kind):
        res, _ = _run()
    assert res["correct"] is False


@pytest.mark.parametrize("kind", sorted(set(lm_faults.KINDS)
                                        - set(lm_faults.CAUGHT)))
def test_lm_fault_under_the_noise_changes_the_wave(kind):
    """The two one-position faults change what the wave serves (at the
    cell's size they stay within what sound runs read, PERF.md)."""
    sound, _ = _run(seconds=1e-6)
    with lm_faults.fault(kind):
        res, _ = _run(seconds=1e-6)
    assert res["checks"] != sound["checks"]


def test_setup_warms_a_prefill_and_two_decode_steps(monkeypatch):
    """Set-up runs one prefill and `WARM_STEPS` decode steps, the window
    whole waves, and PTQ is timed apart (`lm.ptq` spans)."""
    from repro_torch.models.transformer import LM
    calls = {"prefill": 0, "decode": 0}
    real_p, real_d = LM.prefill, LM.decode_step

    def prefill(self, *a, **kw):
        calls["prefill"] += 1
        return real_p(self, *a, **kw)

    def decode_step(self, *a, **kw):
        calls["decode"] += 1
        return real_d(self, *a, **kw)

    monkeypatch.setattr(LM, "prefill", prefill)
    monkeypatch.setattr(LM, "decode_step", decode_step)
    res, det = _run()
    assert calls == {"prefill": 1 + det["waves"],
                     "decode": lm_harness.WARM_STEPS
                     + det["waves"] * (TRAFFIC["gen"] - 1)}
    assert 0 < det["ptq_s"] < det["setup_s"]


def _wave(cfg, seed, f32_activations, rec=None):
    from repro_torch.models.transformer import build_model, decode_alloc
    t = lm_data.Waves.of(TRAFFIC)
    model = build_model(lm_harness.program_config(cfg))
    params = lm_harness.program_tree(model, cfg, seed, "cpu",
                                     lm_harness.Spans())
    if f32_activations:        # the whole forward in float32, W8A8 kept
        params["embed"]["table"] = params["embed"]["table"].float()
    pool = lm_data.prompts(seed, t, cfg["vocab_size"], "cpu")
    runner = lm_harness.WaveRunner(model, params, t, pool,
                                   decode_alloc(t.prompt_len + t.gen))
    rows = t.rows(seed, 0)
    ctx = lm_harness.recorded(rec) if rec is not None \
        else contextlib.nullcontext()
    with torch.inference_mode(), ctx:
        tokens, logits = runner.wave(rows)
    seq = torch.cat([pool[rows], tokens[:, :-1]], 1)
    return tokens, logits, seq


@pytest.mark.parametrize("seed", [3, SEED])
def test_reference_equals_program_in_float32(seed):
    """With float32 activations the port's prefill and every decode step
    through its cache give the reference's full forward bit for bit at
    nearly every position (the same int8 weights, exponents, groups and
    exact int32 sums; float32's other order of sums puts an int8 code on
    the other side of its rounding now and then), and its tokens."""
    cfg = _cell().config
    tokens, logits, seq = _wave(cfg, seed, True)
    ref, _ = lm_reference.Reference(cfg, seed, "cpu").logits(
        seq, TRAFFIC["prompt_len"])
    d = (logits.transpose(0, 1) - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert (d == 0).float().mean() >= 0.9 and d.max() < 0.03
    assert torch.equal(tokens, ref.argmax(-1))


@pytest.mark.parametrize("f32", [True, False])
def test_recorded_routes_against_the_reference(f32):
    """The port's routes and activation exponents recorded over a wave
    change nothing it serves, count the experts each call reached, and
    agree with the reference's over the same tokens: all in float32, most
    in bf16."""
    cfg = _cell().config
    rec = {}
    tokens, logits, seq = _wave(cfg, SEED, f32, rec)
    routes = rec["routes"]
    plain, plain_logits, _ = _wave(cfg, SEED, f32)
    assert torch.equal(tokens, plain) and torch.equal(logits, plain_logits)
    L, E = cfg["num_layers"], cfg["num_experts"]
    assert len(routes) == TRAFFIC["gen"] * L
    hit = lm_harness.experts_hit(routes, E)
    assert hit[:L] == [E] * L and all(1 <= h <= E for h in hit)
    _, notes = lm_reference.Reference(cfg, SEED, "cpu").logits(
        seq, TRAFFIC["prompt_len"])
    m = lm_harness.route_mismatch(routes, notes["routes"],
                                  TRAFFIC["prompt_len"])
    assert m["route_mismatch"] <= (0.01 if f32 else 0.05), m
    # one exponent a distinct input: q/k/v, o, w_gate/w_up, w_down a
    # layer, the head, at the prefill and every decode step
    assert len(rec["exponents"]) == TRAFFIC["gen"] * (4 * L + 1)
    f = lm_harness.exponent_flips(rec["exponents"], notes["act_exponents"])
    assert f["inputs"] == len(rec["exponents"])
    assert f["exponent_flips"] <= (0.01 if f32 else 0.05), f
    assert f["most"] <= 1
    moved = [e + 1 for e in notes["act_exponents"]]
    assert lm_harness.exponent_flips(rec["exponents"],
                                     moved)["exponent_flips"] > 0.9
    moved = [r.roll(1, -1) for r in notes["routes"]]
    assert lm_harness.route_mismatch(
        routes, [(r + 1) % E for r in moved], TRAFFIC["prompt_len"]
    )["route_mismatch"] > 0.5


def test_reference_against_program_in_bf16():
    """The served path (bf16 activations): every number within its limit,
    and the error far from the int4 control's."""
    from portbench import lm_judge
    cfg = _cell().config
    tokens, logits, seq = _wave(cfg, SEED, False)
    ref, notes = lm_reference.Reference(cfg, SEED, "cpu").logits(
        seq, TRAFFIC["prompt_len"])
    checks, out = lm_judge.compare(logits, tokens, ref, notes, 0)
    assert lm_judge.passed(checks), checks
    low, _ = lm_reference.Reference(cfg, SEED, "cpu", act_bits=4).logits(
        seq, TRAFFIC["prompt_len"])
    c4, _ = lm_judge.compare(low.transpose(0, 1), low.argmax(-1), ref, {}, 0)
    assert c4["logit_err_median"][0] > 3 * checks["logit_err_median"][0]


def test_lm_and_capsnet_cells_load():
    c = spec.cell(CELL)
    assert spec.family(c.config) == "lm" and c.config["num_layers"] == 14
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "tokens_per_s"]
    assert {m["moves"] for m in c.per_layer} == {"tokens_per_s", "setup_s"}
    assert [m["name"] for m in c.per_layer if m["moves"] == "setup_s"] \
        == ["ptq_s.offline"]
    assert lm_data.Waves.of(c.traffic).batch == 8
    for name in ("capsnet_mnist_L-bulk", "capsnet_cifar10_S-bulk"):
        caps = spec.cell(name)
        assert spec.family(caps.config) == "capsnet"
        assert caps.config == json.loads(
            (spec.PKG / "configs" / f"{caps.config_name}.json").read_text())
        assert [m["name"] for m in caps.end_to_end] == ["setup_s",
                                                        "images_per_s"]
        assert len(caps.per_layer) == 14
        assert {m["moves"] for m in caps.per_layer} == {"setup_s",
                                                        "images_per_s"}


def test_program_config_holds_the_files_sizes():
    c = spec.cell(CELL)
    pc = lm_harness.program_config(c.config)
    for k in spec.LM_KEYS[2:]:
        v = getattr(pc, k)
        want = c.config[k]
        assert (tuple(map(tuple, want)) if k == "blocks" else want) == v, k
    assert pc.capacity_factor * pc.experts_per_tok == pc.num_experts


def test_yardstick_counts_one_layer_at_published_widths():
    cfg = spec.cell(CELL).config
    one = {**cfg, "num_layers": 1}
    M = 32
    prods = lm_yardstick.step_products(one, M, M)
    faces = [p[0] for p in prods]
    assert faces == ["dense"] * 4 + ["bmm"] * 3 + ["dense"]
    macs = [p[1] / 2 for p in prods]
    assert macs[:4] == [M * 6144 * 6144, M * 6144 * 1024, M * 6144 * 1024,
                        M * 6144 * 6144]
    assert macs[4:7] == [M * 2 * 6144 * 16384] * 3      # top-2, not capacity
    assert macs[7] == M * 6144 * 32768
    # w_gate at decode: 64 assignments in, all 8 experts' weights once
    assert prods[4][2] == 64 * 6144 + 8 * (16384 * 6144 + 4 * 16384) \
        + 64 * 16384 * 2
    assert prods[0][2] == M * 6144 + 6144 * 6144 + 4 * 6144 + M * 6144 * 2
    per_token = 2 * (6144 * (6144 + 2 * 1024) + 6144 * 6144
                     + 2 * 3 * 6144 * 16384)
    assert lm_yardstick.wave_ops(one, 1, 1, 1) == per_token + 2 * 6144 * 32768
    # only the experts a call reached count their weights' bytes
    five = lm_yardstick.step_products(one, M, M, iter([5]))
    assert five[4][1] == prods[4][1] and five[4][2] == prods[4][2] \
        - 3 * (16384 * 6144 + 4 * 16384)
    assert [p[2] for p in five[:4] + five[7:]] \
        == [p[2] for p in prods[:4] + prods[7:]]
    # decode-step products are bound by their bytes, the prefill's by ops
    assert lm_yardstick.bound_s(*prods[4][1:]) == prods[4][2] / 3.35e12
    big = lm_yardstick.step_products(one, 32 * 1024, 32)[4]
    assert lm_yardstick.bound_s(*big[1:]) == big[1] / 1979e12


MLP_REFERENCE = '''
import torch
import torch.nn.functional as F


def leaves(cfg):
    D, Fd = cfg["d_model"], cfg["d_ff"]
    bf = torch.bfloat16
    return {"mlp/w_gate": ((D, Fd), bf), "mlp/w_up": ((D, Fd), bf),
            "mlp/w_down": ((Fd, D), bf)}


def apply(ctx, p, h):
    B, T, D = h.shape
    rg = ctx.groups.repeat(B)
    xq, er = ctx.quantize(h.reshape(B * T, D), rg)
    a = F.silu(ctx.product(xq, er, *p["mlp/w_gate"])) \\
        * ctx.product(xq, er, *p["mlp/w_up"])
    return ctx.dense(a, rg, p["mlp/w_down"]).view(B, T, D)
'''


def test_new_lm_config_cell_and_kind_are_files(tmp_path, monkeypatch):
    """A configuration with a block kind no cell has (a dense SwiGLU
    FFN), its cell and its kind's reference added as new files and
    entries, no existing file edited: the cell loads, and the kind's
    reference, found by name, gives the port's float32 logits."""
    pkg = tmp_path / "portbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    cfg = {**spec.cell(CELL).config, **REDUCED, "name": "dense_swa_lm",
           "blocks": [["swa", "mlp"]]}
    (pkg / "configs" / "dense_swa_lm.json").write_text(json.dumps(cfg))
    (pkg / "workloads" / "dense_swa_lm-offline.json").write_text(
        json.dumps(TRAFFIC))
    (pkg / "references" / "mlp.py").write_text(MLP_REFERENCE)
    bench = json.loads(json.dumps(spec.benchmark()))
    bench["configs"].append({"name": "dense_swa_lm", "source": "x",
                             "file": "portbench/configs/dense_swa_lm.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dense_swa_lm-offline",
                               "config": "dense_swa_lm", "traffic": "offline",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tokens_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append("dense_swa_lm-offline")
    c = spec.cell("dense_swa_lm-offline", bench, pkg)
    assert c.config["blocks"] == [["swa", "mlp"]]
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "tokens_per_s"]
    assert lm_reference.leaves(c.config, pkg)["blocks/0/mlp/w_down"][0] \
        == (1024, 256)
    monkeypatch.setattr(lm_reference, "PKG", pkg)
    tokens, logits, seq = _wave(c.config, 5, True)
    ref, _ = lm_reference.Reference(c.config, 5, "cpu").logits(
        seq, TRAFFIC["prompt_len"])
    d = (logits.transpose(0, 1) - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert (d == 0).float().mean() >= 0.9 and d.max() < 0.03
    assert all(p.read_bytes() == b for p, b in before.items())


def test_waves_rows_are_the_seeds():
    t = lm_data.Waves.of(TRAFFIC)
    a = [t.rows(2 ** 40 + 1, w) for w in range(8)]
    assert a == [t.rows(2 ** 40 + 1, w) for w in range(8)]
    assert sorted(sum(a[:4], [])) == list(range(16))      # one pass
    assert a != [t.rows(2 ** 40 + 2, w) for w in range(8)]
    with pytest.raises(ValueError):
        lm_data.Waves.of({**TRAFFIC, "kind": "poisson"})


def test_roofline_and_busy_count_a_wave_from_the_profiled_stretch():
    """A hand-built trace of a 1-layer stretch (the prefill and 2 decode
    steps): each product's kernel and its split-K reduction are its
    time, the expert products' bytes follow the experts reached, and the
    decode steps count (gen - 1) / 2 times, as a wave has them."""
    import types

    from portbench.profiling import Profile
    cfg = {**spec.cell(CELL).config, "num_layers": 1}
    B, P, gen, S = 8, 1024, 128, 2
    hit = [8, 7, 5]
    prods = lm_yardstick.wave_products(cfg, B, P, S + 1, hit)
    per_call = len(prods) // (S + 1)
    ops, times = [], []
    for i in range(len(prods)):
        d = 0.5 if i < per_call else 0.25
        ops.append(("i8sm90::wgmma_kernel<Dequant>", float(i), d, "kernel"))
        ops.append(("elementwise_kernel", i + 0.6, 0.1, "kernel"))
        times.append(d)
    ops.append(("i8sm90::reduce_kernel<Dequant>", 0.52, 0.02, "kernel"))
    times[0] += 0.02
    run = types.SimpleNamespace(
        cell=types.SimpleNamespace(config=cfg), batch=B, prompt_len=P,
        gen=gen, profiled_steps=S, experts_hit=hit,
        profile=Profile(device_ops=ops, host_ranges=[], wall_s=30.0,
                        waves=[]))
    scale = (gen - 1) / S
    for face in ("bmm", "dense"):
        bound = dev = 0.0
        for i, (f, o, nb) in enumerate(prods):
            if f == face:
                w = 1.0 if i < per_call else scale
                bound += w * lm_yardstick.bound_s(o, nb)
                dev += w * times[i]
        assert lm_yardstick.roofline(run, face) == pytest.approx(
            100 * bound / dev)
    # the second decode step reached 5 experts: its w_gate reads 5's weights
    assert prods[2 * per_call + 4][2] == 8 * 2 * 6144 + 5 * (
        16384 * 6144 + 4 * 16384) + 8 * 2 * 16384 * 2
    pre = per_call * 0.6 + 0.02
    post = 2 * per_call * 0.35
    assert lm_yardstick.wave_busy_s(run) == pytest.approx(pre + scale * post)
    run.experts_hit = hit[:2]
    assert lm_yardstick.roofline(run, "bmm") is None
