"""The port's one-device sharded-wave layer against the reference on the
CPU: `repro_torch.dist.api` (`BATCH`, `SEQ`, `fspec`, `dp_size`, `shard`,
`current_mesh`) against `repro.dist.api` on a mesh of the one CPU device,
`launch.mesh.make_host_mesh`, `serving.sharded.compile_wave` with and
without a mesh (bit-identical waves), the registry carrying a mesh, and
`serve_caps --mesh host`.  A data-parallel mesh of more devices runs over
a world of processes (`tests/test_torch_multicard_serving.py` holds it
against the reference); a mesh that splits the model axis raises
NotImplementedError wherever it is used.
"""
import numpy as np
import pytest
import torch

from repro.dist import api as rapi
from repro.launch.mesh import make_host_mesh as rmesh
from repro_torch.dist import api
from repro_torch.launch import serve_caps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.nn import EDGE_TINY
from repro_torch.serving import (CapsServeEngine, ModelRegistry,
                                 default_specs, serve_window)
from repro_torch.serving import sharded

SPECS = [(None,), ("pod",), (("pod", "data"),), (api.BATCH, None, None),
         (api.BATCH, api.SEQ, None), (None, ("data", "model")),
         (("pod", "zzz"),), ("zzz", None), ((),), (api.BATCH, "model")]
AXES = [("pod", "data", "model"), ("data", "model"), ("pod", "model", "data"),
        ("model",)]


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_fspec_dp_size_and_mesh_shape_match_the_reference(axes):
    ref, port = rmesh(axes), make_host_mesh(axes, device="cpu")
    assert port.shape == dict(ref.shape)
    assert port.axis_names == tuple(ref.axis_names)
    assert port.size == 1
    assert api.dp_size(port) == rapi.dp_size(ref)
    for spec in SPECS:
        assert api.fspec(port, *spec) == tuple(rapi.fspec(ref, *spec)), spec
    assert api.BATCH == rapi.BATCH and api.SEQ == rapi.SEQ
    assert api.dp_size(None) == rapi.dp_size(None) == 1


def test_shard_is_the_identity_on_one_device():
    x = torch.arange(12.0).reshape(3, 4)
    assert api.current_mesh() is None
    assert api.shard(x, api.BATCH, None) is x
    mesh = make_host_mesh(device="cpu")
    with mesh:
        assert api.current_mesh() is mesh
        assert api.shard(x, api.BATCH, api.SEQ) is x
        with api.use_mesh(None):
            assert api.current_mesh() is mesh
    assert api.current_mesh() is None


def test_a_mesh_of_more_devices_raises():
    """A data-parallel mesh of two devices works: as a record (specs,
    `with`, `shard`), and over a gloo world of two processes, where a
    registry's wave equals the one-device wave; without a world it binds
    no wave.  So does a mesh that splits the model axis."""
    two = api.Mesh(("pod", "data", "model"), (1, 2, 1),
                   [torch.device("cpu")] * 2)
    assert two.shape == {"pod": 1, "data": 2, "model": 1}
    assert api.dp_size(two) == 2
    assert api.fspec(two, api.BATCH) == (("pod", "data"),)
    x = torch.arange(6.0).reshape(3, 2)
    with two:
        assert api.current_mesh() is two and api.shard(x, api.BATCH) is x
    qnet = ModelRegistry({"e": default_specs()["edge_tiny@torch"]},
                         device="cpu").model("e")
    with pytest.raises(ValueError, match="without a world"):
        sharded.compile_wave(qnet, 4, mesh=two)
    images = default_specs()["edge_tiny@torch"].images(4, seed=4)
    from repro_torch.dist import world as dworld
    import torch_multicard_ranks as ranks
    got = dworld.spawn(ranks.registry_wave, 2, backend="gloo", device="cpu",
                       timeout_s=60, deadline_s=120, args=(images,))
    want = sharded.compile_wave(qnet, 4)(images)
    for g in got:
        assert g["device"] == "cpu" and g["mesh"]
        for a, b in zip(g["out"], want):
            assert torch.equal(a, b)
    # a mesh that splits the model axis: as the data-parallel one, it
    # binds no wave without a world; over a world of two (its ranks on
    # the model axis) its wave equals the one-device wave
    tp = api.Mesh(("pod", "data", "model"), (1, 1, 2),
                  [torch.device("cpu")] * 2)
    with tp:
        assert api.current_mesh() is tp and api.tp_size(tp) == 2
    with pytest.raises(ValueError, match="without a world"):
        sharded.compile_wave(qnet, 4, mesh=tp)
    for g in got:
        assert g["tp_mesh"] == {"pod": 1, "data": 1, "model": 2}
        for a, b in zip(g["tp_out"], want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="devices"):
        api.Mesh(("data",), (3,), [torch.device("cpu")])


@pytest.fixture(scope="module")
def tiny():
    reg = ModelRegistry({"e": default_specs()["edge_tiny@torch"]},
                        device="cpu")
    images = default_specs()["edge_tiny@torch"].images(9, seed=4)
    return reg.model("e"), images


@pytest.mark.parametrize("bucket", [1, 4, 16])
def test_compile_wave_with_and_without_a_mesh_is_bit_identical(tiny,
                                                               bucket):
    qnet, images = tiny
    x = np.zeros((bucket,) + tuple(EDGE_TINY.input_shape), np.float32)
    n = min(bucket, len(images))
    x[:n] = images[:n]
    plain = sharded.compile_wave(qnet, bucket)
    meshed = sharded.compile_wave(qnet, bucket,
                                  mesh=make_host_mesh(device="cpu"))
    assert plain.mesh is None and meshed.input_shape == (bucket,) + \
        tuple(EDGE_TINY.input_shape)
    for a, b in zip(plain(x), meshed(x)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="wave bound to"):
        meshed(x[:0])


def test_the_registry_carries_its_mesh_through_every_wave(tiny):
    qnet, images = tiny
    mesh = make_host_mesh(("pod", "model", "data"), device="cpu")
    out = []
    for m in (None, mesh):
        reg = ModelRegistry(specs={}, device="cpu", mesh=m)
        reg.install("e", qnet)
        assert reg.executable("e", 4).mesh is m
        engine = CapsServeEngine(reg, buckets=(1, 4))
        engine.submit_many(images, "e")
        out.append(sorted((c.rid, c.v_q.tobytes(), c.pred)
                          for c in engine.drain()))
    assert out[0] == out[1] and len(out[0]) == len(images)
    _, done, _ = serve_window(reg, (4,), images, "e")
    assert [c.pred for c in done] == [p for _, _, p in out[0]]


def test_serve_caps_mesh_host_on_the_cpu(capsys):
    rc = serve_caps.main(["--model", "edge_tiny@torch", "--device", "cpu",
                          "--requests", "8", "--buckets", "1,4",
                          "--mesh", "host"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mesh={'pod': 1, 'model': 1, 'data': 1}" in out
    rc = serve_caps.main(["--model", "edge_tiny@torch", "--device", "cpu",
                          "--requests", "4", "--buckets", "4"])
    assert rc == 0 and "mesh=none" in capsys.readouterr().out
