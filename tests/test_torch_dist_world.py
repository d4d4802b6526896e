"""`repro_torch.dist.world` on the CPU: the backend rule, the device of a
rank, torchrun's environment, `make_host_mesh` outside a world, and
`spawn`'s failure paths (a rank that raises, a rank that hangs), each
within a deadline.  Worlds that compute are in `test_torch_multicard_*`.
"""
import time

import pytest
import torch

from repro_torch.dist import api
from repro_torch.dist import world as dworld
from repro_torch.launch.mesh import make_host_mesh

import torch_multicard_ranks as ranks

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")


@pytest.mark.parametrize("cards", [0, 1, 2, 4])
def test_the_backend_rule(cards, monkeypatch):
    """NCCL only when every rank of the host owns a card; gloo on the CPU
    and for ranks that share one; NCCL asked for either raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for n in (1, 2, 4):
        assert dworld.choose_backend(None, CPU, n) == "gloo"
        assert dworld.choose_backend("gloo", CPU, n) == "gloo"
        with pytest.raises(ValueError, match="nccl needs CUDA"):
            dworld.choose_backend("nccl", CPU, n)
        own = 0 < n <= cards
        assert dworld.choose_backend(None, CUDA, n) == \
            ("nccl" if own else "gloo")
        assert dworld.choose_backend("gloo", CUDA, n) == "gloo"
        if own:
            assert dworld.choose_backend("nccl", CUDA, n) == "nccl"
        else:
            with pytest.raises(ValueError, match="share a card"):
                dworld.choose_backend("nccl", CUDA, n)
    with pytest.raises(ValueError, match="use gloo or nccl"):
        dworld.choose_backend("mpi", CPU, 1)


def test_device_for_rank_and_the_nccl_refusal_before_any_group(monkeypatch):
    assert dworld.device_for_rank(3, "cpu") == CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dworld.device_for_rank(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [dworld.device_for_rank(r) for r in range(4)] == \
        [torch.device("cuda", i) for i in (0, 1, 0, 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses ranks that share"):
        dworld.init_world(rank=0, world_size=2, backend="nccl",
                          device="cuda")
    assert dworld.current_world() is None
    assert not torch.distributed.is_initialized()


def test_init_world_reads_torchrun_and_asks_for_it(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="RANK is not set: launch under "
                       "torchrun"):
        dworld.init_world(device="cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE is not set"):
        dworld.init_world(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses"):
        dworld.init_world(backend="nccl", device="cuda")


def test_make_host_mesh_outside_a_world(monkeypatch):
    """One device, or a ValueError that asks for torchrun when more than
    one card is visible; a record of two devices runs no collective."""
    mesh = make_host_mesh(("pod", "model", "data"), device="cpu")
    assert mesh.size == 1 and mesh.world is None and mesh.device == CPU
    assert api.dp_rank(mesh) == 0 and mesh.tag() == \
        "{'pod': 1, 'model': 1, 'data': 1}"
    x = torch.arange(5)
    assert api.split_rows(x, mesh) is x and api.gather_rows(x, mesh, 5) is x
    assert api.gather_shares(x, mesh, [5]) is x
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_host_mesh(device="cuda")
    two = api.Mesh(("data", "model"), (2, 1), [CPU, CPU])
    for call in (lambda: api.split_rows(x, two), lambda: api.dp_rank(two),
                 lambda: api.gather_rows(x, two, 5),
                 lambda: api.gather_shares(x, two, [5, 0])):
        with pytest.raises(ValueError, match="torch.distributed world"):
            call()


@pytest.mark.parametrize("n,ways", [(8, 2), (3, 2), (1, 2), (3, 4), (2, 4),
                                    (0, 3), (13, 4)])
def test_row_shares_are_contiguous_and_cover_the_rows(n, ways):
    shares = [api.row_share(n, ways, i) for i in range(ways)]
    assert shares[0][0] == 0 and shares[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [hi - lo for lo, hi in shares]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_spawn_reraises_the_first_ranks_exception_and_kills_the_rest():
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 1 refuses") as info:
        dworld.spawn(ranks.raise_on, 2, timeout_s=60, deadline_s=60,
                     args=(1,))
    assert time.monotonic() - t0 < 45
    assert any("raised on rank 1 of 2" in n for n in info.value.__notes__)


def test_spawn_kills_a_world_whose_rank_hangs_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0\] of 2"):
        dworld.spawn(ranks.hang_on, 2, timeout_s=30, deadline_s=12,
                     args=(0,))
    assert time.monotonic() - t0 < 40
