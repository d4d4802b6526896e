"""The port's CapsNet training split over a data-parallel mesh of
processes, on the CPU: gloo worlds of 2 and 4 ranks
(`repro_torch.dist.world.spawn`, a deadline on each).

The reference test's recipe (`tests/test_captrain.py`,
`test_sharded_step_bit_parity_on_8device_mesh`): EDGE_TINY, batch 32,
8 microbatches, 3 float steps then 2 QAT steps; also 2 microbatches over
4 ranks, whose shares are uneven and empty.  The losses, accuracies and
every leaf of the state equal the no-mesh run's bit for bit (run in the
same process, so both see the same CPU kernels); the port's no-mesh step
is held to the reference's by `test_torch_captrain.py`.  A checkpoint
written under the mesh (rank 0 alone) resumes the same bits on every
rank, and `table2_rows(mesh=)` gives the rows of the one-rank harness.
"""
import numpy as np
import pytest
import torch

from repro_torch.captrain.steps import pairwise_reduce, tree_blocks, tree_push
from repro_torch.dist import api
from repro_torch.dist import world as dworld
from repro_torch.tree import leaves

import torch_multicard_ranks as ranks

# (world size, [(microbatches, float steps, qat steps)])
RUNS = {2: [(8, 3, 2)], 4: [(8, 3, 2), (2, 3, 2)]}


@pytest.fixture(scope="module", params=sorted(RUNS),
                ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    n = request.param
    ckpt = tmp_path_factory.mktemp(f"ckpt{n}")
    got = dworld.spawn(ranks.train_checks, n, backend="gloo", device="cpu",
                       timeout_s=60, deadline_s=300,
                       args=(RUNS[n], str(ckpt)))
    return n, got, ckpt


def same_state(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_losses_and_state_equal_the_no_mesh_run_bit_for_bit(world):
    n, got, _ = world
    assert [g["rank"] for g in got] == list(range(n))
    for g in got:
        for (S, nf, nq), row in zip(RUNS[n], g["runs"]):
            mesh, none = row["mesh"], row["none"]
            assert len(mesh["losses"]) == nf + nq
            assert mesh["losses"] == none["losses"], (S, n)
            assert mesh["accuracy"] == none["accuracy"], (S, n)
            assert same_state(mesh["state"], none["state"]), (S, n)
            assert int(mesh["state"]["opt"]["step"]) == nf + nq
    # every rank holds the same replicated state
    for row0, row in zip(got[0]["runs"], got[-1]["runs"]):
        assert same_state(row0["mesh"]["state"], row["mesh"]["state"])


def test_a_checkpoint_written_by_rank_0_resumes_on_every_rank(world):
    n, got, ckpt = world
    assert sorted(p.name for p in ckpt.iterdir()) == ["LATEST",
                                                      "step_00000002.npz"]
    for g in got:
        assert same_state(g["saved"], g["resumed"])
        assert same_state(g["resumed"], got[0]["resumed"])
        assert g["resumed_plan"] is None


def test_table2_rows_under_a_mesh_equal_the_one_rank_rows(world):
    n, got, _ = world
    for g in got:
        assert len(g["table2"]) == 1
        assert g["table2"] == g["table2_none"] == got[0]["table2"]


SHARES = [(S, ways) for S in (1, 2, 4, 8, 16) for ways in (1, 2, 3, 4, 5)]


@pytest.mark.parametrize("S,ways", SHARES)
def test_tree_blocks_tile_each_share_with_whole_subtrees(S, ways):
    for r in range(ways):
        lo, hi = api.row_share(S, ways, r)
        blocks = tree_blocks(lo, hi)
        assert sum(n for _, n in blocks) == hi - lo
        at = lo
        for b, n in blocks:
            assert b == at and n & (n - 1) == 0 and b % n == 0
            at += n
        # no two neighbours are siblings: each block is as large as it can be
        for (b0, n0), (b1, n1) in zip(blocks, blocks[1:]):
            assert not (n0 == n1 and b0 % (2 * n0) == 0)


@pytest.mark.parametrize("S,ways", SHARES)
def test_the_tree_finished_from_the_shares_sums_equals_pairwise_reduce(
        S, ways):
    """Each rank sums its share's blocks row by row, the blocks of every
    rank are pushed in order: the very bits of `pairwise_reduce` over
    the S rows (on rows whose sum depends on the order of the adds)."""
    rng = np.random.default_rng(S * 10 + ways)
    rows = torch.from_numpy((rng.standard_normal((S, 257)) * 10.0 **
                             rng.integers(-6, 7, (S, 257))).astype(
                                 np.float32))
    want = pairwise_reduce(rows.clone())
    blocks, sums = [], []
    for r in range(ways):
        for b, n in tree_blocks(*api.row_share(S, ways, r)):
            stack = []
            for s in range(b, b + n):
                tree_push(stack, s, 1, [rows[s]])
            assert [(b_, n_) for b_, n_, _ in stack] == [(b, n)]
            blocks.append((b, n))
            sums.append(stack[0][2])
    stack = []
    for (b, n), total in zip(blocks, sums):
        tree_push(stack, b, n, total)
    assert [(b, n) for b, n, _ in stack] == [(0, S)]
    assert torch.equal(stack[0][2][0], want)
    if S >= 4:      # the data tells the tree from a left-to-right sum
        left = rows[0].clone()
        for s in range(1, S):
            left = left + rows[s]
        assert not torch.equal(left, want)
