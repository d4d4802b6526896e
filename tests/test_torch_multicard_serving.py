"""The port's serving waves split over a data-parallel mesh of processes,
on the CPU: gloo worlds of 2 and 4 ranks (`repro_torch.dist.world.spawn`,
a deadline on each) stand in for the devices.

Held bit for bit against the reference's unsharded `compile_wave(qnet, B)`
on the same quantized net, carried across by `repro_torch.convert`: the
CIFAR10 wave at B 8 (the reference's own 8-device parity test's
geometry) and EDGE_TINY at buckets 1, 3 and 4, whose shares are uneven
and, at 1 and 3 over 4 ranks, empty.  Ranks bound to different buckets
raise ValueError (and the world goes on), and `serve_caps --mesh host`
prints rank 0's report only, its completions those of `--mesh none`.
Every check runs inside one world per size; the rank functions live in
`torch_multicard_ranks`, which imports no JAX.
"""
import jax
import numpy as np
import pytest
import torch

from repro.nn import CIFAR10 as R_CIFAR10
from repro.nn import CapsPipeline as RCapsPipeline
from repro.nn.plans import plan_to_json
from repro.serving import EDGE_TINY as R_EDGE_TINY
from repro.serving import compile_wave as r_compile_wave
from repro_torch.dist import world as dworld
from repro_torch.dist.api import row_share
from repro_torch.launch import serve_caps

import torch_multicard_ranks as ranks

WORLDS = (2, 4)
EDGE_BUCKETS = (1, 3, 4)
SERVE_ARGV = ["--model", "edge_tiny@torch", "--device", "cpu",
              "--requests", "11", "--buckets", "1,4", "--mesh", "host"]


def reference_net(cfg, seed: int):
    pipe = RCapsPipeline.from_config(cfg)
    params = pipe.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 3)
    calib = rng.uniform(0, 1, (8,) + tuple(cfg.input_shape)).astype(
        np.float32)
    return pipe.quantize(params, calib)


@pytest.fixture(scope="module")
def reference():
    """The reference's quantized nets, the waves' inputs and its
    unsharded outputs."""
    nets, qnets, waves = {}, {}, []
    for name, cfg, seed in (("cifar10", R_CIFAR10, 0),
                            ("edge_tiny", R_EDGE_TINY, 1)):
        q = reference_net(cfg, seed)
        qnets[name] = q
        nets[name] = (name, plan_to_json(q.plan),
                      jax.tree.map(np.asarray, q.qweights))
    rng = np.random.default_rng(7)
    for name, bucket in [("cifar10", 8)] + [("edge_tiny", b)
                                            for b in EDGE_BUCKETS]:
        shape = (bucket,) + tuple(qnets[name].pipeline.cfg.input_shape)
        waves.append((name, bucket,
                      rng.uniform(0, 1, shape).astype(np.float32)))
    want = [[np.asarray(t) for t in r_compile_wave(qnets[n], b)(x)]
            for n, b, x in waves]
    return nets, waves, want


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, reference):
    nets, waves, want = reference
    got = dworld.spawn(ranks.serving_checks, request.param, backend="gloo",
                       device="cpu", timeout_s=60, deadline_s=240,
                       args=(nets, waves, SERVE_ARGV))
    return request.param, got, waves, want


def test_waves_equal_the_references_unsharded_wave_on_every_rank(world):
    n, got, waves, want = world
    assert [g["rank"] for g in got] == list(range(n))
    for g in got:
        assert g["dp_rank"] == g["rank"]
        assert g["shape"] == {"pod": 1, "model": 1, "data": n}
        assert g["dp_size"] == n
        assert g["mesh"] == f"{{'pod': 1, 'model': 1, 'data': {n}}} over " \
            f"{n}xcpu/gloo"
        for (name, bucket, _), w, outs in zip(waves, want, g["waves"]):
            assert [o.shape[0] for o in outs] == [bucket] * 3
            assert outs[0].dtype == torch.int8 and \
                outs[2].dtype == torch.int32
            for a, b in zip(outs, w):
                assert np.array_equal(a.numpy(), b), (name, bucket)


def test_the_rows_split_in_contiguous_uneven_and_empty_shares(world):
    n, got, waves, _ = world
    for i, (_, bucket, _) in enumerate(waves):
        shares = [g["rows"][i] for g in got]
        assert shares == [hi - lo for lo, hi in
                          (row_share(bucket, n, r) for r in range(n))]
        assert sum(shares) == bucket
    # bucket 1 leaves every rank but the first empty; bucket 3 over 4
    # ranks one of them
    assert [g["rows"][1] for g in got] == [1] + [0] * (n - 1)
    assert [g["rows"][2] for g in got].count(0) == (1 if n == 4 else 0)


def test_ranks_bound_to_different_buckets_raise_and_the_world_goes_on(
        world):
    n, got, waves, want = world
    for g in got:
        msg = g["mismatch"]
        assert msg is not None and "ranks disagree" in msg, msg
        wave = len(waves) + 1
        assert f"('edge_tiny', 3, {wave})" in msg, msg
        assert f"('edge_tiny', 4, {wave})" in msg, msg
        for a, b in zip(g["after"], want[-1]):
            assert np.array_equal(a.numpy(), b)


def test_serve_caps_mesh_host_prints_rank_0_only_and_equals_mesh_none(
        world, capsys):
    n, got, _, _ = world
    assert [g["serve_rc"] for g in got] == [0] * n
    lead = got[0]["serve_out"]
    assert f"over {n}xcpu/gloo" in lead and "[serve_caps] serve:" in lead
    assert all(g["serve_out"] == "" for g in got[1:])
    assert serve_caps.main(SERVE_ARGV[:-2]) == 0
    alone = capsys.readouterr().out
    digest = [line for line in alone.splitlines()
              if line.startswith("[serve_caps] completions:")]
    assert len(digest) == 1 and digest[0] in lead.splitlines()
