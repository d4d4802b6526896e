"""The port's kernel library entry point (repro_torch.kernels.ops) and its
oracles (repro_torch.kernels.ref) against the reference's
(repro.kernels.ops in interpret mode, as tests/test_kernels.py runs it,
and repro.kernels.ref), on the same inputs from a seeded NumPy generator.

* int8 GEMMs (`matmul_q7`, `bmm_q7`, `w8a8_matmul`) and the tensordot
  face of `int8_ops.matmul_q7` are held BIT-EXACT, over the reference's
  shape corpus, both roundings, shifts over [-31, 31] and an int32
  accumulator that wraps;
* `squash_float` is held within atol 1e-5, the reference's own tolerance
  (tests/test_kernels.py), and keeps a bfloat16 input's dtype;
* the entry points take CPU tensors to the plain versions (no launch is
  counted) and refuse a tensor on any other device but CUDA.

The CUDA kernels run only on a GPU: tests/test_torch_gpu.py holds them
against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.quant import int8_ops as R
from repro_torch.kernels import ops, ref
from repro_torch.kernels import q7_matmul as kq
from repro_torch.kernels import squash as ks
from repro_torch.kernels import w8a8_dense as kd
from repro_torch.kernels import w8a8_matmul as kw
from repro_torch.quant import int8_ops as T

ROUNDINGS = ("floor", "nearest")
MKN = [(20, 30, 40), (128, 128, 128), (7, 257, 130), (1, 5, 3),
       (200, 64, 96)]                      # tests/test_kernels.py's corpus
W8A8_MKN = [(33, 65, 19), (128, 128, 128), (4, 16, 300)]


def i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.numpy().dtype == np.asarray(j).dtype


# ---------------------------------------------------------------------------
# matmul_q7 / bmm_q7
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("mkn", MKN, ids=lambda m: "x".join(map(str, m)))
def test_matmul_q7_matches_pallas_and_oracle(mkn, rounding):
    M, K, N = mkn
    rng = np.random.default_rng(M * 1000 + K)
    a, b = i8(rng, (M, K)), i8(rng, (K, N))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for shift in (0, 3, 9, -2):
        got = ops.matmul_q7(torch.from_numpy(a), torch.from_numpy(b), shift,
                            rounding)
        same(got, r_ops.matmul_q7(ja, jb, shift, rounding))
        same(got, r_ref.matmul_q7(ja, jb, shift, rounding))


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_matmul_q7_every_shift(rounding):
    rng = np.random.default_rng(3)
    a, b = i8(rng, (33, 70)), i8(rng, (70, 17))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for shift in range(-31, 32):
        same(ops.matmul_q7(ta, tb, shift, rounding),
             r_ref.matmul_q7(jnp.asarray(a), jnp.asarray(b), shift,
                             rounding))


@pytest.mark.parametrize("batch", [(), (3,), (2, 5)], ids=str)
def test_bmm_q7_matches_pallas_and_einsum_oracle(batch):
    rng = np.random.default_rng(len(batch))
    a, b = i8(rng, batch + (12, 20)), i8(rng, batch + (20, 8))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got = ops.bmm_q7(torch.from_numpy(a), torch.from_numpy(b), 4)
    acc = jnp.einsum("...mk,...kn->...mn", ja.astype(jnp.int32),
                     jb.astype(jnp.int32))
    same(got, r_ref.rshift_sat8(acc, 4))
    same(got, r_ops.bmm_q7(ja, jb, 4))
    assert tuple(got.shape) == batch + (12, 8)


def test_int8_ops_matmul_on_a_3d_operand_is_dot_generals_not_a_batch():
    """No batch axes in the reference's dot_general: [B,M,K] x [B,K,N]
    gives [B,M,B,N], a's free axes then b's."""
    rng = np.random.default_rng(4)
    a, b = i8(rng, (2, 5, 7)), i8(rng, (2, 7, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for rounding in ROUNDINGS:
        got = T.matmul_q7(ta, tb, 6, rounding)
        assert tuple(got.shape) == (2, 5, 2, 3)
        same(got, R.matmul_q7(ja, jb, 6, rounding))
    same(T.matmul_q7_acc(ta, tb), R.matmul_q7_acc(ja, jb))
    same(T.matmul_q7_acc(ta[0], tb), R.matmul_q7_acc(ja[0], jb))


def test_int32_accumulator_wraps_as_xlas_dot():
    """K = 140,000 products of (-128)^2 sum to 2,293,760,000 > 2^31 - 1:
    the int32 accumulator wraps, as XLA's int32 dot does (the plain ref
    only: interpret mode is too slow at this K)."""
    a = np.full((2, 140_000), -128, np.int8)
    b = np.full((140_000, 3), -128, np.int8)
    acc = T.matmul_q7_acc(torch.from_numpy(a), torch.from_numpy(b))
    assert int(acc[0, 0]) == 140_000 * 128 * 128 - 2 ** 32
    same(acc, R.matmul_q7_acc(jnp.asarray(a), jnp.asarray(b)))
    for shift in (0, 20, 31, -3):
        same(ops.matmul_q7(torch.from_numpy(a), torch.from_numpy(b), shift),
             r_ref.matmul_q7(jnp.asarray(a), jnp.asarray(b), shift))


# ---------------------------------------------------------------------------
# w8a8_matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("mkn", W8A8_MKN, ids=lambda m: "x".join(map(str, m)))
def test_w8a8_matches_pallas_and_oracle(mkn, rounding):
    M, K, N = mkn
    rng = np.random.default_rng(M + K + N)
    a, w = i8(rng, (M, K)), i8(rng, (K, N))
    ja, jw = jnp.asarray(a), jnp.asarray(w)
    for lo, hi in ((-2, 12), (-31, 32)):
        sh = rng.integers(lo, hi, (N,)).astype(np.int32)
        got = ops.w8a8_matmul(torch.from_numpy(a), torch.from_numpy(w),
                              torch.from_numpy(sh), rounding)
        jsh = jnp.asarray(sh)
        same(got, r_ref.w8a8_matmul_ref(ja, jw, jsh, rounding))
        if (lo, hi) == (-2, 12):
            same(got, r_ops.w8a8_matmul(ja, jw, jsh, rounding))
        same(ref.w8a8_matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                                 tuple(sh.tolist()), rounding), got.numpy())


# ---------------------------------------------------------------------------
# squash_float and the re-exported oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64, 6), (300, 4), (2, 7, 16)], ids=str)
def test_squash_float_matches_pallas(shape):
    s = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    got = ops.squash_float(torch.from_numpy(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), r_ops.squash_float(
        jnp.asarray(s)), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), r_ref.squash_float_ref(
        jnp.asarray(s)), atol=1e-5)


def test_squash_float_keeps_bfloat16():
    s = np.random.default_rng(6).normal(0, 1, (64, 6)).astype(np.float32)
    tb = torch.from_numpy(s).to(torch.bfloat16)
    got = ops.squash_float(tb)
    assert got.dtype == torch.bfloat16
    want = r_ops.squash_float(jnp.asarray(s, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    # both squash in float32 and round once to bfloat16 (8 bits of
    # mantissa): within one bfloat16 ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("case", [
    ((4, 4, 4, 0), ("packed", 1, 1)),      # [R, 4] f32: a float4 a row
    ((4, 2, 4, 16), ("packed", 1, 2)),     # [R, 4] bf16: two rows a word
    ((8, 2, 8, 0), ("packed", 1, 1)),      # [R, 8] bf16/f16: a word a row
    ((1, 4, 1, 0), ("packed", 1, 4)),
    ((8, 4, 8, 0), ("lanes", 2, 1)),
    ((16, 4, 16, 0), ("lanes", 4, 1)),     # [R, 16] f32: 4 lanes a row
    ((160, 4, 160, 0), ("lanes", 32, 4)),
    ((4, 4, 5, 4), ("element", 4, 1)),     # s[:, 1:] of a [R, 5] tensor
    ((4, 4, 4, 8), ("element", 4, 1)),     # 8 bytes past a boundary
    ((16, 4, 17, 0), ("element", 16, 1)),  # rows 68 bytes apart
    ((6, 4, 6, 0), ("element", 8, 1)),     # [64, 6]: 24-byte rows
    ((1000, 4, 1000, 0), ("element", 32, 32)),
], ids=str)
def test_squash_float_plan(case):
    (D, itemsize, row_stride, ptr), want = case
    assert tuple(ks.squash_float_plan(D, itemsize, row_stride, ptr)) == want


def squash_float_visits(R, D, itemsize, plan, grid, threads=256):
    """How often csrc/squash_float.cu reads each (row, element) of an
    [R, D] input on `grid` blocks of `threads`, by the kernels' own index
    arithmetic (packed words with their leftover rows; lane groups whose
    loop bound is shared by a warp)."""
    seen = np.zeros((R, D), np.int64)
    if plan.path == "packed":
        rpv = plan.chunks
        nvec = R // rpv
        for i in range(nvec):
            seen[i * rpv:(i + 1) * rpv] += 1
        seen[nvec * rpv:] += 1
        return seen
    v = 16 // itemsize if plan.path == "lanes" else 1
    G, groups = plan.lanes, threads // plan.lanes
    for b in range(grid):
        for t in range(threads):
            lane, in_warp = t & (G - 1), (t & 31) // G
            for r0 in range(b * groups + (t & ~31) // G, R, grid * groups):
                row = r0 + in_warp
                for c in range(plan.chunks):
                    j = lane + c * G
                    if row < R and j < D // v:
                        seen[row, j * v:(j + 1) * v] += 1
    return seen


@pytest.mark.parametrize("shape", [(37, 4, 4), (37, 4, 2), (13, 8, 2),
                                   (29, 16, 4), (9, 160, 4), (33, 6, 4),
                                   (5, 1000, 4)], ids=str)
def test_squash_float_paths_read_every_element_once(shape):
    R, D, itemsize = shape
    plan = ks.squash_float_plan(D, itemsize, D, 0)
    for grid in (1, 3):
        assert (squash_float_visits(R, D, itemsize, plan, grid) == 1).all()


def test_squash_float_reads_a_strided_view_where_it_lies():
    s = np.random.default_rng(7).normal(0, 2, (50, 5)).astype(np.float32)
    got = ops.squash_float(torch.from_numpy(s)[:, 1:])
    np.testing.assert_allclose(got.numpy(), r_ops.squash_float(
        jnp.asarray(s[:, 1:])), atol=1e-5)


@pytest.mark.parametrize("softmax_impl", ["q7", "approx"])
def test_routing_ref_matches_the_reference_oracle(softmax_impl):
    u = i8(np.random.default_rng(8), (2, 5, 24, 6))
    kw_ = dict(num_iters=3, caps_out_shifts=(8, 9, 9),
               caps_out_fracs=(7, 6, 6), agree_shifts=(8, 8), logit_frac=7)
    got = ref.routing_q7_ref(torch.from_numpy(u), softmax_impl=softmax_impl,
                             **kw_)
    same(got, r_ref.routing_q7_ref(jnp.asarray(u), softmax_impl=softmax_impl,
                                   **kw_))
    same(ops.routing_q7(torch.from_numpy(u), **kw_),
         r_ops.routing_q7(jnp.asarray(u), **kw_))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def _calls(dev):
    a = torch.zeros((8, 16), dtype=torch.int8, device=dev)
    b = torch.zeros((16, 4), dtype=torch.int8, device=dev)
    sh = torch.zeros((4,), dtype=torch.int32, device=dev)
    return {
        "matmul_q7": lambda: ops.matmul_q7(a, b, 3),
        "bmm_q7": lambda: ops.bmm_q7(a[None], b[None], 3),
        "w8a8_matmul": lambda: ops.w8a8_matmul(a, b, sh),
        "w8a8_dense": lambda: ops.w8a8_dense(
            a, b.t().contiguous(), torch.zeros((), device=dev), sh),
        "w8a8_bmm": lambda: ops.w8a8_bmm(
            a[None], b.t().contiguous()[None], torch.zeros((), device=dev),
            sh[None]),
        "squash_q7": lambda: ops.squash_q7(a.reshape(32, 4), in_frac=5),
        "squash_float": lambda: ops.squash_float(
            torch.zeros((8, 4), device=dev)),
        "routing_q7": lambda: ops.routing_q7(
            torch.zeros((2, 4, 16, 4), dtype=torch.int8, device=dev),
            num_iters=2, caps_out_shifts=(8, 8), caps_out_fracs=(7, 7),
            agree_shifts=(8,), logit_frac=7),
    }


def _launches():
    return (kq.matmul_q7.launches, kq.bmm_q7.launches,
            kw.w8a8_matmul.launches, kd.w8a8_dense.launches,
            kd.w8a8_bmm.launches,
            ks.squash_q7.launches, ks.squash_float.launches)


def test_ops_take_cpu_tensors_to_the_plain_versions():
    before = _launches()
    for name, call in _calls("cpu").items():
        assert call().device.type == "cpu", name
    assert _launches() == before
    assert sorted(ops.__all__) == sorted(_calls("cpu"))


@pytest.mark.parametrize("name", sorted(_calls("meta")))
def test_ops_refuse_a_meta_tensor(name):
    """Every op refuses a meta tensor but the W8A8 faces, whose meta face
    (the dry run's) gives the plain version's struct and launches
    nothing."""
    if name in ("w8a8_bmm", "w8a8_dense"):
        before = _launches()
        got, want = _calls("meta")[name](), _calls("cpu")[name]()
        assert got.device.type == "meta" and _launches() == before
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        return
    with pytest.raises(NotImplementedError):
        _calls("meta")[name]()


def test_wrappers_check_what_the_kernels_take():
    a = torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(TypeError):
        kq.check_operands("m", a.to(torch.int32), a.T, "floor")
    with pytest.raises(ValueError, match="not"):
        kq.check_operands("m", a, a, "floor")
    with pytest.raises(ValueError, match="not"):
        kq.check_operands("m", a[None].expand(2, 8, 16), a.T[None], "floor")
    with pytest.raises(ValueError, match="rounding"):
        kq.check_operands("m", a, a.T, "up")
    with pytest.raises(ValueError, match="grid"):
        kq.check_operands("m", torch.zeros((70_000, 1, 2), dtype=torch.int8),
                          torch.zeros((70_000, 2, 1), dtype=torch.int8),
                          "floor")
    kq.check_operands("m", a, a.T, "nearest")
