"""The int8 GEMM's route choice and its split-K and stream-K arithmetic,
on the CPU.

* `gemm_plan` sends every shape TMA can describe (K % 16 == 0, A 16-byte
  aligned, and a B read K-major as it is aligned too) to the wgmma loop
  and the rest to the mma.sync loop; on the wgmma loop it takes the
  stream-K schedule exactly at M <= 64, and above it cuts K exactly where
  the output has fewer tiles than the card has SMs and K is long;
* the stream-K shares cover every (tile, K block) iteration exactly
  once, contiguous, non-empty and within one iteration of each other
  (every SM's share of B's bytes within 10 % at the LM's decode shapes);
* a numpy mirror of the stream-K schedule (each block's share cut at
  tile boundaries, a whole tile stored by its block, a cut tile's
  partials added modulo 2^32 into the sum tile of its first owner, one
  cut tile a first owner) equals the int32 accumulator of both packages, on
  random, all -128 and wrap-and-return operands, batched and not;
* a numpy mirror of the split-K decomposition (K cut as the kernel cuts
  it, each part an int32 sum, the parts added modulo 2^32) equals the
  int32 accumulator of both packages for every split count from 1 to 8,
  on random operands, on all -128 operands and on a wrap-and-return
  pair (a running sum that overflows int32 partway through K and comes
  back), where a saturating sum would not;
* the transpose the wgmma route feeds B through equals b.t() and is
  what a CPU tensor takes;
* the wrap-and-return pair goes through `repro.kernels.ops.matmul_q7`
  (interpret mode) and `repro_torch.kernels.ops.matmul_q7` bit-equal.

The CUDA kernels themselves run only on a GPU (tests/test_torch_gpu.py).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.quant import int8_ops as R
from repro_torch.kernels import ops
from repro_torch.kernels import q7_matmul as kq
from repro_torch.kernels import w8a8_matmul as kw
from repro_torch.quant import int8_ops as T

INT32_MAX = 2 ** 31 - 1
WRAP_SHAPE = (4, 140_000, 8)               # all -128: the sum wraps once
WRAP_RETURN_SHAPE = (8, 265_296, 16)       # wraps and comes back
ALIGNED = 1 << 20                          # a 16-byte aligned address


def wrap_and_return(M: int, K: int, N: int, seed: int = 0):
    """a [M, K], b [K, N] int8: 132,000 products of (-128)(-128), then
    133,040 of (-128)(127), then random ones.  The running int32 sum of
    every output passes 2^31 - 1 after 131,072 products and is back near
    -10,240 before the random tail, whose sum fits easily: wrapping gives
    the exact result, saturating anywhere does not."""
    k1, k2 = 132_000, 133_040
    rng = np.random.default_rng(seed)
    a = np.full((M, K), -128, np.int8)
    b = np.full((K, N), -128, np.int8)
    b[k1:k1 + k2] = 127
    a[:, k1 + k2:] = rng.integers(-128, 128, (M, K - k1 - k2))
    b[k1 + k2:] = rng.integers(-128, 128, (K - k1 - k2, N))
    return a, b


def operands(kind: str):
    if kind == "random":
        rng = np.random.default_rng(7)
        return (rng.integers(-128, 128, (33, 1296)).astype(np.int8),
                rng.integers(-128, 128, (1296, 21)).astype(np.int8))
    if kind == "all -128":
        M, K, N = WRAP_SHAPE
        return np.full((M, K), -128, np.int8), np.full((K, N), -128, np.int8)
    return wrap_and_return(*WRAP_RETURN_SHAPE)


def part_bounds(K: int, split: int):
    """The K range of each split-K part, cut as wgmma_gemm_kernel cuts
    it: part p walks K blocks [p * kb // split, (p + 1) * kb // split)."""
    kb = -(-K // kq.K_BLOCK)
    return [(p * kb // split * kq.K_BLOCK,
             min(K, (p + 1) * kb // split * kq.K_BLOCK))
            for p in range(split)]


def to_i32(x):
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)


def split_k_mirror(a, b, split: int):
    """Each part an int32 sum (exact modulo 2^32), the parts added as
    uint32, i.e. modulo 2^32, as splitk_reduce_kernel adds them."""
    total = np.zeros((a.shape[0], b.shape[1]), np.uint32)
    for k0, k1 in part_bounds(a.shape[1], split):
        part = to_i32(a[:, k0:k1].astype(np.int64) @ b[k0:k1].astype(np.int64))
        total += part.view(np.uint32)
    return total.view(np.int32)


def streamk_mirror(a, b, ctas: int):
    """a [batch, M, K] x b [batch, K, N] int8 -> int32, as
    wgmma_streamk_kernel sums it on `ctas` blocks: block c walks its share
    of the (tile, K block) iterations tile by tile; a tile whose K blocks
    all lie in the share is its block's; every owner of a tile cut between
    shares adds its int32 partial, as uint32, to the sum tile of the
    tile's first owner sk_owner(t0), and no two cut tiles share one."""
    batch, M, K = a.shape
    N = b.shape[-1]
    BM, BN = kq.SK_TILE
    kb = -(-K // kq.K_BLOCK)
    m_tiles, n_tiles = -(-M // BM), -(-N // BN)
    iters = batch * m_tiles * n_tiles * kb
    assert iters == kq.streamk_iterations(M, K, N, batch)
    shares = kq.streamk_shares(iters, ctas)
    out = np.zeros((batch, M, N), np.uint32)
    sums, owners = {}, collections.defaultdict(list)

    def block(t):
        z, mn = divmod(t, m_tiles * n_tiles)
        mt, nt = divmod(mn, n_tiles)
        return z, slice(mt * BM, (mt + 1) * BM), slice(nt * BN, (nt + 1) * BN)

    for c, (begin, end) in enumerate(shares):
        i = begin
        while i < end:
            t = i // kb
            t0, stop = t * kb, min(end, (t + 1) * kb)
            z, rows, cols = block(t)
            ks = slice((i - t0) * kq.K_BLOCK, (stop - t0) * kq.K_BLOCK)
            part = to_i32(a[z, rows, ks].astype(np.int64)
                          @ b[z, ks, cols].astype(np.int64)).view(np.uint32)
            if i == t0 and stop == t0 + kb:
                out[z, rows, cols] = part
            else:
                first = ((t0 + 1) * ctas - 1) // iters        # sk_owner
                assert shares[first][0] <= t0 < shares[first][1]
                key = sums.setdefault(first, (t, np.zeros_like(part)))
                assert key[0] == t, (first, key[0], t)   # one cut tile each
                sums[first] = (t, key[1] + part)
                owners[t].append(c)
            i = stop
    for first, (t, total) in sums.items():
        last = ((t * kb + kb) * ctas - 1) // iters
        assert owners[t] == list(range(first, last + 1)), (t, owners[t])
        z, rows, cols = block(t)
        out[z, rows, cols] = total
    return out.view(np.int32)


# ---------------------------------------------------------------------------
# route choice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mknb", [(4096, 4096, 4096, 1), (4096, 784, 64, 1),
                                  (4, 140_000, 8, 1), (256, 256, 256, 8),
                                  (*WRAP_RETURN_SHAPE, 1), (128, 128, 128, 1)],
                         ids=str)
def test_gemm_plan_takes_wgmma_where_tma_describes_a(mknb):
    M, K, N, batch = mknb
    plan = kq.gemm_plan(M, K, N, batch, ALIGNED)
    assert plan.route == "wgmma" and plan.tile[0] == \
        (kq.SK_TILE[0] if M <= kq.SMALL_M else kq.TILE_M)
    assert plan.tile[1] in (128, 256) and plan.split >= 1


@pytest.mark.parametrize("K", [30, 257, 5, 49])
def test_gemm_plan_keeps_mma_sync_where_k_is_not_16_byte_rows(K):
    assert kq.gemm_plan(4096, K, 64, 1, ALIGNED) == \
        kq.GemmPlan("mma.sync", (128, 128), 1)


@pytest.mark.parametrize("offset", [1, 8, 15])
def test_gemm_plan_keeps_mma_sync_for_a_misaligned_a(offset):
    assert kq.gemm_plan(4096, 784, 64, 1, ALIGNED + offset).route == \
        "mma.sync"
    assert kq.gemm_plan(4096, 784, 64, 1, ALIGNED + 16).route == "wgmma"


@pytest.mark.parametrize("offset", [1, 8, 15])
def test_gemm_plan_keeps_mma_sync_for_a_misaligned_k_major_b(offset):
    """A B read K-major as it is must be 16-byte aligned too."""
    for M in (8, 512):
        assert kq.gemm_plan(M, 784, 64, 1, ALIGNED,
                            b_ptr=ALIGNED + offset).route == "mma.sync"
        assert kq.gemm_plan(M, 784, 64, 1, ALIGNED,
                            b_ptr=ALIGNED + 16).route == "wgmma"


def test_gemm_plan_keeps_mma_sync_for_empty_and_too_wide_products():
    for mknb in ((0, 16, 8, 1), (8, 0, 8, 1), (8, 16, 0, 1), (8, 16, 8, 0),
                 (8, 16, kq.MAX_TRANSPOSE_N + 1, 1)):
        assert kq.gemm_plan(*mknb, ALIGNED).route == "mma.sync", mknb


def test_the_headline_shapes_plan():
    """What chip_smoke.py's route lines show for its headline shapes."""
    plan = kq.gemm_plan
    assert plan(4096, 4096, 4096, 1, ALIGNED) == \
        kq.GemmPlan("wgmma", (128, 256), 1)
    assert plan(4096, 784, 64, 1, ALIGNED) == kq.GemmPlan("wgmma",
                                                          (128, 128), 3)
    assert plan(4, 140_000, 8, 1, ALIGNED) == kq.GemmPlan(
        "wgmma", (64, 128), 1, "stream-k", 132)
    assert plan(256, 256, 256, 8, ALIGNED) == kq.GemmPlan("wgmma",
                                                          (128, 128), 1)
    # the LM's W8A8 products: qwen3_14b's down projection at a decode
    # step and its gate/up at a prefill, phi35_moe's experts at both
    assert plan(8, 17408, 5120, 1, ALIGNED, b_ptr=ALIGNED) == kq.GemmPlan(
        "wgmma", (64, 128), 1, "stream-k", 132)
    assert plan(512, 5120, 17408, 1, ALIGNED, b_ptr=ALIGNED) == \
        kq.GemmPlan("wgmma", (128, 256), 1)
    assert plan(4, 4096, 6400, 16, ALIGNED, b_ptr=ALIGNED) == kq.GemmPlan(
        "wgmma", (64, 128), 1, "stream-k", 132)
    assert plan(96, 4096, 6400, 16, ALIGNED, b_ptr=ALIGNED) == \
        kq.GemmPlan("wgmma", (128, 256), 1)


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_split_exactly_where_tiles_are_fewer_than_sms_and_k_is_long(sms):
    """Above SMALL_M rows (at or below it the stream-K schedule takes
    every shape, and never splits)."""
    for M in (1, 64, 65, 128, 129, 1000, 4096, 20_000):
        for N in (8, 128, 256, 300, 4096):
            for K in (16, 256, 384, 512, 784, 4096, 140_000):
                for batch in (1, 3):
                    plan = kq.gemm_plan(M, K, N, batch, ALIGNED, sms)
                    if M <= kq.SMALL_M:
                        assert plan.schedule == "stream-k" and \
                            plan.split == 1, (M, K, N, batch, plan)
                        continue
                    assert plan.schedule == "tiles" and plan.ctas == 0
                    tiles = batch * -(-M // 128) * -(-N // plan.tile[1])
                    kblocks = -(-K // kq.K_BLOCK)
                    long_k = kblocks >= 2 * kq.MIN_SPLIT_KBLOCKS
                    assert (plan.split > 1) == (tiles < sms and long_k), \
                        (M, K, N, batch, plan)
                    # every part walks at least MIN_SPLIT_KBLOCKS blocks
                    assert plan.split == 1 or \
                        kblocks // plan.split >= kq.MIN_SPLIT_KBLOCKS
                    assert batch * plan.split <= kq.MAX_GRID_YZ
                    if plan.tile[1] == 256:
                        assert N >= 256 and tiles >= sms


@pytest.mark.parametrize("M", [1, 4, 8, 16, 64, 65, 96, 512])
def test_gemm_plan_takes_stream_k_exactly_at_small_m(M):
    """Both sides of the switch, at a qwen3_14b decode shape: 64 x 128
    tiles on min(sms, iterations // MIN_SPLIT_KBLOCKS) blocks at M <= 64,
    128-row tiles above."""
    for K, N, batch in ((17408, 5120, 1), (5120, 1024, 1), (4096, 6400, 16),
                        (256, 8, 1), (16, 8, 3)):
        for sms in (132, 114, 8):
            plan = kq.gemm_plan(M, K, N, batch, ALIGNED, sms, ALIGNED)
            if M > kq.SMALL_M:
                assert plan.schedule == "tiles" and plan.tile[0] == 128
                continue
            iters = kq.streamk_iterations(M, K, N, batch)
            assert plan == kq.GemmPlan(
                "wgmma", kq.SK_TILE, 1, "stream-k",
                min(sms, max(1, iters // kq.MIN_SPLIT_KBLOCKS)))
            assert iters == batch * -(-N // 128) * -(-K // kq.K_BLOCK)


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_stream_k_shares_cover_every_iteration_once_and_balance(sms):
    for M in (1, 8, 64):
        for N in (8, 128, 300, 5120, 17408):
            for K in (16, 256, 784, 5120, 17408, 140_000):
                for batch in (1, 3, 16):
                    plan = kq.gemm_plan(M, K, N, batch, ALIGNED, sms)
                    iters = kq.streamk_iterations(M, K, N, batch)
                    shares = kq.streamk_shares(iters, plan.ctas)
                    assert 1 <= plan.ctas <= sms
                    assert shares[0][0] == 0 and shares[-1][1] == iters
                    assert all(e == b for (_, e), (b, _) in
                               zip(shares, shares[1:]))
                    sizes = [e - b for b, e in shares]
                    assert min(sizes) >= 1
                    assert max(sizes) - min(sizes) <= 1
                    if iters >= sms * kq.MIN_SPLIT_KBLOCKS:
                        assert plan.ctas == sms
                    if iters >= kq.MIN_SPLIT_KBLOCKS:
                        assert min(sizes) >= kq.MIN_SPLIT_KBLOCKS
                    assert kq.streamk_work_ints(plan, M) == \
                        plan.ctas * (1 + M * 128)


@pytest.mark.parametrize("mknb", [(8, 17408, 5120, 1), (8, 5120, 17408, 1),
                                  (8, 5120, 152064, 1), (4, 4096, 6400, 16),
                                  (4, 6400, 4096, 16), (8, 1024, 256256, 1)],
                         ids=str)
def test_stream_k_balances_the_bytes_of_b_at_the_decode_shapes(mknb):
    """Every block's share of B's bytes (a K block of a tile is 128 x 128
    bytes of B, fewer on a ragged edge) within 10 % of every other's."""
    M, K, N, batch = mknb
    plan = kq.gemm_plan(M, K, N, batch, ALIGNED, b_ptr=ALIGNED)
    kb, n_tiles = -(-K // kq.K_BLOCK), -(-N // 128)

    def b_bytes(i):
        nt, k = (i // kb) % n_tiles, i % kb
        return min(128, N - 128 * nt) * min(kq.K_BLOCK, K - kq.K_BLOCK * k)
    iters = kq.streamk_iterations(M, K, N, batch)
    loads = [sum(map(b_bytes, range(b, e)))
             for b, e in kq.streamk_shares(iters, plan.ctas)]
    assert plan.ctas == kq.H100_SMS and sum(loads) == batch * K * N
    assert max(loads) <= 1.1 * min(loads), (min(loads), max(loads))


# ---------------------------------------------------------------------------
# split-K and stream-K arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("kind", ["random", "all -128", "wrap-and-return"])
def test_split_k_mirror_equals_the_int32_accumulator(kind, split):
    a, b = operands(kind)
    got = split_k_mirror(a, b, split)
    want = np.asarray(R.matmul_q7_acc(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, T.matmul_q7_acc(torch.from_numpy(a), torch.from_numpy(b))
        .numpy())
    if split == 1:
        np.testing.assert_array_equal(got, split_k_mirror(a, b, 132))


@pytest.mark.parametrize("ctas", [1, 2, 7, 49, 132])
@pytest.mark.parametrize("kind", ["random", "all -128", "wrap-and-return",
                                  "batched"])
def test_stream_k_mirror_equals_the_int32_accumulator(kind, ctas):
    if kind == "batched":
        rng = np.random.default_rng(8)
        a = rng.integers(-128, 128, (3, 40, 1296)).astype(np.int8)
        b = rng.integers(-128, 128, (3, 1296, 300)).astype(np.int8)
    else:
        a, b = (x[None] for x in operands(kind))
    iters = kq.streamk_iterations(a.shape[1], a.shape[2], b.shape[2],
                                  a.shape[0])
    ctas = min(ctas, iters)
    got = streamk_mirror(a, b, ctas)
    for z in range(a.shape[0]):
        want = np.asarray(R.matmul_q7_acc(jnp.asarray(a[z]),
                                          jnp.asarray(b[z])))
        np.testing.assert_array_equal(got[z], want)
        np.testing.assert_array_equal(
            got[z], T.matmul_q7_acc(torch.from_numpy(a[z]),
                                    torch.from_numpy(b[z])).numpy())


def test_the_wrap_and_return_pair_needs_wrapping_everywhere():
    """Its running sum overflows int32 partway through K and comes back;
    saturating the running sum at any K block, or the sum of split-K
    parts, gives another result."""
    a, b = wrap_and_return(*WRAP_RETURN_SHAPE)
    K = a.shape[1]
    blocks = [a[:, k0:k0 + kq.K_BLOCK].astype(np.int64)
              @ b[k0:k0 + kq.K_BLOCK].astype(np.int64)
              for k0 in range(0, K, kq.K_BLOCK)]
    running = np.cumsum(blocks, axis=0)
    exact = running[-1]
    assert running.max() > INT32_MAX and np.abs(exact).max() <= INT32_MAX
    np.testing.assert_array_equal(to_i32(exact), split_k_mirror(a, b, 1))

    def saturating(terms):
        acc = np.zeros_like(terms[0])
        for t in terms:
            acc = np.clip(acc + t, -INT32_MAX - 1, INT32_MAX)
        return acc

    assert not np.array_equal(saturating(blocks), exact)
    for split in (2, 8, 132):
        parts = [a[:, k0:k1].astype(np.int64) @ b[k0:k1].astype(np.int64)
                 for k0, k1 in part_bounds(K, split)]
        assert not np.array_equal(saturating(parts), exact), split


# ---------------------------------------------------------------------------
# the transpose and the CPU side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(16, 3), (784, 64), (3, 272, 130)],
                         ids=str)
def test_transpose_kn_on_the_cpu_is_the_plain_transpose(shape):
    b = torch.from_numpy(np.random.default_rng(len(shape)).integers(
        -128, 128, shape).astype(np.int8))
    n0 = kq.transpose_kn.launches
    got = kq.transpose_kn(b)
    assert got.is_contiguous() and kq.transpose_kn.launches == n0
    assert torch.equal(got, b.transpose(-1, -2).contiguous())
    if b.dim() == 2:
        assert torch.equal(got, b.t().contiguous())
    with pytest.raises(NotImplementedError):
        kq.transpose_kn(b.to("meta"))


@pytest.mark.parametrize("rounding", ["floor", "nearest"])
def test_wrap_and_return_through_both_packages(rounding):
    a, b = wrap_and_return(*WRAP_RETURN_SHAPE)
    K = a.shape[1]
    for shift in (0, 9, 13, 20, 31, -2):
        # 16 K blocks: the interpret-mode kernel's int32 scratch wraps
        # across grid steps, as the one-block sum would
        want = np.asarray(r_ops.matmul_q7(jnp.asarray(a), jnp.asarray(b),
                                          shift, rounding, bk=K // 16))
        got = ops.matmul_q7(torch.from_numpy(a), torch.from_numpy(b), shift,
                            rounding)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(got.numpy())) > 1


def test_route_counters_start_at_zero_for_every_route():
    for fn in (kq.matmul_q7, kq.bmm_q7, kw.w8a8_matmul):
        assert set(fn.launches_by_route) == set(kq.ROUTES)
    before = {fn: dict(fn.launches_by_route)
              for fn in (kq.matmul_q7, kw.w8a8_matmul)}
    a, b = operands("random")
    ops.matmul_q7(torch.from_numpy(a), torch.from_numpy(b), 3)
    ops.w8a8_matmul(torch.from_numpy(a), torch.from_numpy(b),
                    torch.zeros(b.shape[1], dtype=torch.int32))
    assert {fn: fn.launches_by_route for fn in before} == before
