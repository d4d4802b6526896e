"""The port's dry run on meshes of more than one card
(`repro_torch.launch.dryrun` over `dist.world.fake_world`), on the CPU.

(a) The counterpart of the reference's `test_tiny_multipod_dryrun_compiles`:
qwen3_14b at d 128 trains on a (pod 2, data 2, model 2) mesh with real
collective traffic.  (b) The count held against a real run: on gloo
worlds of 2 (model 2) and 4 (data 2, model 2) ranks, every rank runs
`make_cell`'s train, prefill and decode steps of a dense family
(qwen3_14b) and of the MoE one (phi35_moe) at d 64, two layers, B 4, S
32, on CPU tensors of its shares under an unweighted `OpCounter` (the
rank functions in `torch_dryrun_ranks`, which imports no JAX); the dry
run's trip-weighted meta count of the same rank in a fake world of the
same shape, made in processes of its own while the worlds run, must
equal it in flops, bytes, and the collectives' count and bytes by kind
and fabric.  (c) A
fake world never outlives its cell, raised or not, and a one-card cell
counted after multi-card ones equals the one a fresh process (rank 0 of
the world of 2, first thing) counted.  (d) On the production layout the model
line is NVLink and the BATCH and (data, model) lines are InfiniBand, and
the collective term is the two-term sum.
"""
import multiprocessing as mp
import sys
import threading
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.dist import api
from repro_torch.dist import op_analysis as oa
from repro_torch.dist import world as dworld
from repro_torch.dist.api import Mesh
from repro_torch.launch import dryrun, steps
from repro_torch.launch import roofline as TR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import reduced

import torch_dryrun_ranks as ranks

ARCHS = ("qwen3_14b", "phi35_moe")
WORLDS = {2: 1, 4: 2}            # world size: data ways (model = the rest)


tiny = ranks.tiny


def test_tiny_multipod_dryrun_counts():
    cfg, shape = tiny()
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2),
                [torch.device("meta")] * 8)
    rec, cost = dryrun.analyze_step(cfg, shape, "tiny", mesh=mesh)
    assert rec["collective_bytes_per_dev"] > 0, rec["collectives"]
    assert rec["flops_per_dev"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["chips"] == 8 and rec["rank"] == 0
    # the grads' all-reduce over BATCH, the activations' gathers over model
    assert set(cost.collective_count_by_kind) == {"all-reduce", "all-gather"}
    assert not dist.is_initialized() and dworld.current_world() is None


# ---------------------------------------------------------------------------
# (b) the meta count of a rank against its real run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def counts():
    """(the worlds' real counts, the dry run's), the latter counted in
    three processes of their own (a fake world a process at a time)
    while the worlds run, one thread each."""
    real, errs = {}, []

    def run(n, data):
        try:
            real[n] = dworld.spawn(ranks.count_cells, n, timeout_s=120,
                                   deadline_s=240, args=(ARCHS, data, n == 2))
        except BaseException as e:          # noqa: BLE001 (re-raised)
            errs.append(e)
    threads = [threading.Thread(target=run, args=item)
               for item in WORLDS.items()]
    for t in threads:
        t.start()
    jobs = [(n, r) for n in WORLDS for r in range(n)]
    with ProcessPoolExecutor(3, mp_context=mp.get_context("spawn")) as ex:
        futs = {job: ex.submit(ranks.meta_count, ARCHS, job[0],
                               WORLDS[job[0]], job[1]) for job in jobs}
        meta = {job: f.result(timeout=240) for job, f in futs.items()}
    for t in threads:
        t.join(240)
    if errs:
        raise errs[0]
    assert not any(t.is_alive() for t in threads)
    return real, meta


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", sorted(WORLDS))
def test_meta_count_of_each_rank_equals_its_real_run(counts, n, arch):
    real, meta = counts
    for rank in range(n):
        for kind in ranks.KINDS:
            want = real[n][rank][arch, kind]
            assert meta[n, rank][arch, kind] == want, (rank, kind)
            assert sum(want["count_by_kind"].values()) > 0
            assert set(want["bytes_by_fabric"]) == {"nvlink"}


# ---------------------------------------------------------------------------
# (c) no stale world
# ---------------------------------------------------------------------------
def test_a_multi_cell_that_raises_leaves_no_world(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no cell")
    monkeypatch.setattr(steps, "make_cell", broken)
    cfg, _ = tiny()
    rec = dryrun.run_cell("qwen3_14b", "decode_32k", "multi", tmp_path,
                          arch_override=cfg)
    assert rec["status"] == "error" and "no cell" in rec["error"]
    assert not dist.is_initialized() and dworld.current_world() is None
    hook = sys.excepthook         # torch wraps it at every init
    with pytest.raises(RuntimeError, match="no cell"):
        with dworld.fake_world(4, 1) as w:
            assert (w.rank, w.size, w.backend) == (1, 4, "fake")
            assert dist.get_world_size() == 4
            broken()
    assert not dist.is_initialized() and dworld.current_world() is None
    assert sys.excepthook is hook


def test_whole_sizes_under_a_fake_world_are_the_known_ones():
    """A fake group moves no values: the whole lengths of a rank's shares
    come from `known_sizes`, checked against the shares."""
    with dworld.fake_world(2, 1) as w:
        mesh = Mesh(("pod", "data", "model"), (1, 1, 2), w.devices, world=w)
        group = mesh.group(api.MODEL)
        with pytest.raises(ValueError, match="known_sizes"):
            api.whole_sizes([3], group)
        with api.known_sizes([7]):        # rank 1's share of 7 is 3
            assert api.whole_sizes([3], group) == [7]
        with api.known_sizes([8]), pytest.raises(ValueError):
            api.whole_sizes([3], group)
    assert not dist.is_initialized()


def test_fake_world_refuses_a_second_world():
    with dworld.fake_world(2):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dworld.fake_world(2):
                pass
        with pytest.raises(RuntimeError, match="already initialised"):
            dworld.init_world(rank=0, world_size=1, device="cpu")
    assert not dist.is_initialized()


def test_single_cell_after_multi_cells_equals_a_fresh_process(counts):
    cfg, shape = tiny()
    dryrun.analyze_step(cfg, shape, "multi", mesh=Mesh(
        ("pod", "data", "model"), (1, 2, 2), [torch.device("meta")] * 4))
    rec, _ = dryrun.analyze_step(cfg, shape)
    assert ranks.one_card_record(rec) == counts[0][2][0]["fresh"]
    assert rec["chips"] == 1 and "rank" not in rec


# ---------------------------------------------------------------------------
# (d) fabrics
# ---------------------------------------------------------------------------
def test_production_lines_and_their_fabrics():
    layout = make_production_mesh(multi_pod=True)
    with dworld.fake_world(layout.size, 0) as w:
        mesh = Mesh(layout.axis_names, layout.sizes, w.devices, world=w)
        fabric = {axes: oa.fabric(dist.get_process_group_ranks(
            mesh.group(axes).handle))
            for axes in (api.MODEL, api.BATCH, api.SEQ_WIDE)}
    assert fabric == {api.MODEL: "nvlink", api.BATCH: "infiniband",
                      api.SEQ_WIDE: "infiniband"}
    assert [oa.fabric(r) for r in ([0, 7], [8, 15], [7, 8], range(512))] \
        == ["nvlink", "nvlink", "infiniband", "infiniband"]


@pytest.mark.parametrize("kind,B", [("train", 64), ("decode", 1)])
def test_collective_term_is_the_two_fabric_sum(kind, B):
    """A BATCH line (train: the grads' all-reduce) and a (data, model)
    line (decode at B 1: the cache's slots over 256 ranks) cross nodes;
    the model line's gathers do not."""
    cfg = reduced(get_config("qwen3_14b"), d_model=64, layers=2)
    rec, cost = dryrun.analyze_step(cfg, ShapeSpec("r", kind, 32, B),
                                    "multi")
    by = rec["collectives"]["bytes_by_fabric"]
    assert by["nvlink"] > 0 and by["infiniband"] > 0
    assert by == cost.collective_bytes_by_fabric
    assert sum(by.values()) == rec["collective_bytes_per_dev"]
    assert rec["terms"]["collective_s"] == \
        by["nvlink"] / TR.LINK_BW + by["infiniband"] / TR.IB_BW
    assert rec["chips"] == 512 and rec["rank"] == 0
