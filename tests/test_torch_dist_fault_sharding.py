"""The port's fault tolerance and spec rules against the reference on
the CPU: `repro_torch.dist.fault` (`choose_mesh`, `run_with_restarts`,
`StepTimer`) against `repro.dist.fault`, `repro_torch.dist.sharding`'s
spec trees against `repro.dist.sharding`'s `PartitionSpec`s for every
architecture's reduced trees, and `launch.steps`' structs and cells
(`batch_structs`, `input_specs`, `cache_structs`, `make_cell`) against
`repro.launch.steps`' `ShapeDtypeStruct`s and shardings.

A spec of the port is the tuple the reference's `PartitionSpec` holds.
The batch and cache rules depend on the data-parallel width alone; a
width above one is given to both packages by a mesh record (the port's
`Mesh` of several devices, a stand-in with `shape` and `axis_names` for
the reference), since this process holds one device.  The cells on
meshes of several ranks are held in `test_torch_tensor_parallel.py`.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.dist import fault as rfault
from repro.dist import sharding as rshd
from repro.launch import steps as RS
from repro.launch.mesh import make_host_mesh as rmesh
from repro.launch.train import reduced as rreduced
from repro_torch.configs import base as tbase
from repro_torch.dist import api, fault, sharding
from repro_torch.dist.api import Mesh
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import reduced as treduced
from repro_torch.tree import leaves

ARCHS = tbase.ARCH_IDS
AXES = ("pod", "data", "model")
SHAPES = {"train": rbase.ShapeSpec("t", "train", 64, 4),
          "prefill": rbase.ShapeSpec("p", "prefill", 64, 4),
          "decode": rbase.ShapeSpec("d", "decode", 64, 4)}


def cfgs(arch):
    return (rreduced(rbase.get_config(arch), d_model=64),
            treduced(tbase.get_config(arch), d_model=64))


def tshape(shape):
    return tbase.ShapeSpec(shape.name, shape.kind, shape.seq_len,
                           shape.global_batch)


def ref_specs(tree) -> list:
    """[(path, spec tuple)] of a reference tree of PartitionSpecs (or of
    NamedShardings, read through their spec)."""
    def spec(x):
        return tuple(x.spec if isinstance(x, jax.sharding.NamedSharding)
                     else x)
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(
            x, (jax.sharding.PartitionSpec, jax.sharding.NamedSharding)))[0]
    return [(jax.tree_util.keystr(p), spec(x)) for p, x in flat]


def port_specs(tree) -> list:
    out = []
    sharding.map_specs(out.append, tree)
    return out


def same_specs(want, got):
    want = ref_specs(want)
    got = port_specs(got)
    assert [s for _, s in want] == got, [
        (p, w, g) for (p, w), g in zip(want, got) if w != g][:5]


def ref_structs(tree) -> list:
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def reference_layout(tree):
    """The port's W8A8 leaves {"qt" [..., N, K], "n"} as the reference's
    {"q" [..., K, N], "n"} (views; meta tensors stay on meta)."""
    if isinstance(tree, dict) and set(tree) == {"qt", "n"}:
        return {"n": tree["n"], "q": tree["qt"].transpose(-1, -2)}
    if isinstance(tree, dict):
        return {k: reference_layout(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(reference_layout(v) for v in tree)
    return tree


def same_structs(want, got):
    from repro_torch.tree import leaves
    gl = leaves(got)
    want = ref_structs(want)
    assert len(gl) == len(want)
    for (path, shape, dt), g in zip(want, gl):
        assert g.device.type == "meta", path
        assert (tuple(g.shape), str(g.dtype).removeprefix("torch.")) == \
            (shape, dt), path


def ref_mesh(dp: int):
    """A stand-in mesh for the reference's rules (they read shape and
    axis_names only)."""
    return types.SimpleNamespace(shape={"pod": 1, "data": dp, "model": 1},
                                 axis_names=AXES)


def port_mesh(dp: int):
    return Mesh(AXES, (1, dp, 1), ["cpu"] * dp)


# ---------------------------------------------------------------------------
# fault
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", [16, 8, 1])
def test_choose_mesh_matches_the_reference_over_1_to_1024_chips(model):
    for chips in range(0, 1025):
        try:
            want = rfault.choose_mesh(chips, model)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                fault.choose_mesh(chips, model)
            continue
        assert fault.choose_mesh(chips, model) == want, chips


def test_choose_mesh_elastic_cases():
    assert fault.choose_mesh(512) == (2, 16, 16)
    assert fault.choose_mesh(256) == (1, 16, 16)
    assert fault.choose_mesh(480) == (2, 15, 16)
    for bad in (100, 0, -16, 15):
        with pytest.raises(ValueError, match="do not factor"):
            fault.choose_mesh(bad)


@pytest.mark.parametrize("fail_until,max_restarts", [(0, 2), (2, 3), (2, 2),
                                                     (3, 2)])
def test_run_with_restarts_matches_the_reference(fail_until, max_restarts,
                                                 capsys):
    """The same attempts, return value or re-raised error, and printed
    lines as the reference's, backoff 0."""
    def run(mod):
        calls = []

        def flaky(attempt):
            calls.append(attempt)
            if attempt < fail_until:
                raise RuntimeError(f"simulated node failure {attempt}")
            return 42
        try:
            got = mod.run_with_restarts(flaky, max_restarts=max_restarts,
                                        backoff_s=0)
        except RuntimeError as e:
            got = f"raised {e}"
        return got, calls, capsys.readouterr().out
    want = run(rfault)
    assert run(fault) == want
    assert want[0] == (42 if fail_until <= max_restarts
                       else f"raised simulated node failure {max_restarts}")


def test_step_timer_on_a_fed_clock_matches_the_reference(monkeypatch):
    """Step times, the running mean past the warmup, and the straggler
    verdicts equal the reference's on the same clock readings."""
    durations = [5.0, 0.9, 1.1, 1.0, 1.0, 1.2, 3.5, 0.8, 2.9, 9.0, 1.0]
    stamps = []
    t = 100.0
    for d in durations:
        stamps += [t, t + d]
        t += d + 0.25

    def run(mod):
        it = iter(stamps)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        tm, out = mod.StepTimer(), []
        for _ in durations:
            tm.start()
            dt = tm.stop()
            out.append((dt, tm.is_straggler(dt), tm._mean))
        return out
    want = run(rfault)
    got = run(fault)
    assert got == want
    assert [s for _, s, _ in got].count(True) == 1      # the 9 s step


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_the_reference(arch):
    rcfg, tcfg = cfgs(arch)
    want = jax.eval_shape(lambda: RS.init_train_state(
        rcfg, jax.random.key(0)))
    got = TS.train_state_structs(tcfg)
    same_specs(rshd.param_specs(want["params"]),
               sharding.param_specs(got["params"]))
    same_specs(rshd.opt_state_specs(want["opt"], want["params"]),
               sharding.opt_state_specs(got["opt"], got["params"]))
    specs = port_specs(sharding.param_specs(got["params"]))
    assert ("model",) not in specs and () in specs
    assert (None, "model") in specs and (None, None, "model") in specs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dp", [1, 2, 4, 3])
def test_batch_and_cache_specs_match_the_reference(arch, dp):
    """Batch specs of each shape kind and decode-cache specs (a leading
    layer axis when stacked, the encoder-decoder's) at DP widths that
    divide the batch of 4 and one that does not."""
    rcfg, tcfg = cfgs(arch)
    for kind, shape in SHAPES.items():
        same_specs(rshd.batch_specs(RS.batch_structs(rcfg, shape), 4,
                                    ref_mesh(dp)),
                   sharding.batch_specs(TS.batch_structs(tcfg, tshape(shape)),
                                        4, port_mesh(dp)))
    shape = SHAPES["decode"]
    stacked = RS.cache_is_stacked(rcfg)
    assert TS.cache_is_stacked(tcfg) == stacked
    same_specs(rshd.cache_specs(RS.cache_structs(rcfg, shape), 4,
                                ref_mesh(dp), stacked=stacked),
               sharding.cache_specs(TS.cache_structs(tcfg, tshape(shape)), 4,
                                    port_mesh(dp), stacked=stacked))


@pytest.mark.parametrize("arch", ["stablelm_3b", "phi35_moe"])
def test_param_specs_of_a_w8a8_tree_shard_the_reference_axis(arch):
    """The reference shards q [..., K, N] on its output axis N; the port's
    qt [..., N, K] shards the same axis, its second to last, and every
    other leaf as the reference does."""
    rcfg, tcfg = cfgs(arch)
    want = RS.input_specs(rcfg, SHAPES["prefill"], quant=True)["params"]
    got = TS.input_specs(tcfg, tshape(SHAPES["prefill"]),
                         quant=True)["params"]
    specs = port_specs(sharding.param_specs(got))
    ref = ref_specs(rshd.param_specs(want))
    assert len(specs) == len(ref)
    n_q = 0
    for (path, w), g in zip(ref, specs):
        if path.endswith("['q']"):
            n_q += 1
            assert g == w[:-2] + (w[-1], w[-2]) and g[-2] == "model", path
        else:
            assert g == w, path
    assert n_q > 0


def test_to_shardings_on_one_device_and_more():
    ref = rmesh(AXES)
    port = make_host_mesh(AXES, device="cpu")
    for spec in [(), (None, "model"), (("pod", "data"), None),
                 (None, ("data", "model")), ("zzz", "model")]:
        want = tuple(rshd.to_shardings(jax.sharding.PartitionSpec(*spec),
                                       ref).spec)
        assert sharding.to_shardings(spec, port) == want, spec
        # a data-parallel mesh of two devices filters the same spec
        assert sharding.to_shardings(spec, port_mesh(2)) == \
            api.fspec(port_mesh(2), *spec), spec
    assert sharding.to_shardings((("pod", "data"), None), port_mesh(2)) \
        == (("pod", "data"), None)
    # a mesh that splits the model axis filters a spec as one device does
    tp = Mesh(AXES, (1, 1, 2), ["cpu"] * 2)
    assert sharding.to_shardings((None, "model"), tp) == \
        sharding.to_shardings((None, "model"), port) == (None, "model")


# ---------------------------------------------------------------------------
# structs and cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_input_and_cache_structs_match_the_reference(arch):
    """Every struct's shape and dtype, for train, prefill and decode (the
    W8A8 param tree at prefill too, the port's K-major qt leaves seen in
    the reference's layout); the port's hold no storage."""
    rcfg, tcfg = cfgs(arch)
    for kind, shape in SHAPES.items():
        same_structs(RS.batch_structs(rcfg, shape),
                     TS.batch_structs(tcfg, tshape(shape)))
        same_structs(RS.input_specs(rcfg, shape),
                     TS.input_specs(tcfg, tshape(shape)))
    same_structs(RS.cache_structs(rcfg, SHAPES["decode"]),
                 TS.cache_structs(tcfg, tshape(SHAPES["decode"])))
    if rcfg.family != "ssm":
        same_structs(RS.input_specs(rcfg, SHAPES["prefill"], quant=True),
                     reference_layout(TS.input_specs(
                         tcfg, tshape(SHAPES["prefill"]), quant=True)))


@pytest.mark.parametrize("arch", ["stablelm_3b", "seamless_m4t_medium",
                                  "jamba_v01_52b"])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_make_cell_matches_the_reference_on_one_device(arch, kind):
    """The cell's argument structs and its input and output specs, each
    filtered to the mesh of the one device, against the reference's
    `make_cell` shardings on the one CPU device; the step is callable."""
    rcfg, tcfg = cfgs(arch)
    shape = SHAPES[kind]
    _, rargs, rin, rout = RS.make_cell(rcfg, shape, rmesh(AXES))
    fn, args, tin, tout = TS.make_cell(tcfg, tshape(shape),
                                       make_host_mesh(AXES, device="cpu"))
    same_structs(rargs, args)
    same_specs(rin, tin)
    same_specs(rout, tout)
    assert callable(fn)
    # on a mesh of two devices the cell takes the one device's global
    # structs and params' specs, and each rank half the batch's rows
    two = port_mesh(2)
    fn2, args2, tin2, _ = TS.make_cell(tcfg, tshape(shape), two)
    same_structs(rargs, args2)
    assert callable(fn2)
    assert tin2[0] == tin[0]
    local = TS.local_structs(args2, tin2, two)
    rows = [t.shape[0] for t in leaves(local[2 if kind == "decode" else 1])]
    assert rows and all(r == shape.global_batch // 2 for r in rows)


def test_cell_steps_run_on_the_cpu():
    """make_cell's train, prefill and decode callables run on real
    tensors of their structs' shapes (d 64, B 2, S 16)."""
    _, tcfg = cfgs("qwen3_14b")
    mesh = make_host_mesh(AXES, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = TS.init_train_state(tcfg, gen, "cpu")
    shape = tbase.ShapeSpec("t", "train", 16, 2)
    fn, _, _, _ = TS.make_cell(tcfg, shape, mesh)
    toks = torch.randint(0, tcfg.vocab_size, (2, 17), generator=gen)
    state, metrics = fn(state, {"inputs": toks[:, :-1],
                                "targets": toks[:, 1:]})
    assert int(state["step"]) == 1 and np.isfinite(float(metrics["loss"]))
    pre, _, _, _ = TS.make_cell(tcfg, tbase.ShapeSpec("p", "prefill", 16, 2),
                                mesh)
    logits, cache = pre(state["params"], {"inputs": toks[:, :-1]})
    assert logits.shape == (2, tcfg.padded_vocab)
    dec, _, _, _ = TS.make_cell(tcfg, tbase.ShapeSpec("d", "decode", 16, 2),
                                mesh)
    big, _ = TS.make_prefill_step(tcfg, None)(state["params"],
                                              {"inputs": toks})
    from repro_torch.models.transformer import build_model
    cache = build_model(tcfg).prefill(state["params"],
                                      {"inputs": toks[:, :-1]}, alloc=32)[1]
    step_logits, _ = dec(state["params"], cache, toks[:, -1:],
                         torch.tensor(16, dtype=torch.int32))
    np.testing.assert_allclose(step_logits.float().numpy(),
                               big.float().numpy(), atol=0.15, rtol=0.05)
