"""The port's kernel modules (repro_torch.kernels): the plain versions
against the reference's Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and its jnp oracles, the wrappers'
device routing, and the launch-side checks that run on the host.

The CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py
holds them against the plain versions there (chip_smoke.py runs the
same checks at the main path's shapes).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.quant import int8_ops as R
from repro_torch.kernels import build
from repro_torch.kernels import routing as kr
from repro_torch.kernels import squash as ks
from repro_torch.quant import int8_ops as T
from repro_torch.serving import default_specs

ROUNDINGS = ("floor", "nearest")
MNIST_LIKE = dict(num_iters=3, caps_out_shifts=(8, 8, 9),
                  caps_out_fracs=(7, 7, 6), agree_shifts=(8, 8), logit_frac=7)
KERNEL_TEST = dict(num_iters=3, caps_out_shifts=(8, 9, 9),
                   caps_out_fracs=(7, 6, 6), agree_shifts=(8, 8),
                   logit_frac=7)           # tests/test_kernels.py's tables


def i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# plain versions against the reference kernels and oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rd", [(100, 4), (1024, 6), (3, 8), (64, 16)])
def test_squash_plain_matches_pallas_and_oracle(rd):
    s = i8(np.random.default_rng(rd[0]), rd)
    for in_frac in (3, 5, 7, 9):
        got = ks.squash_q7(torch.from_numpy(s), in_frac=in_frac).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref.squash_q7(jnp.asarray(s), in_frac=in_frac)))
        if in_frac in (3, 9):
            np.testing.assert_array_equal(
                got, np.asarray(ops.squash_q7(jnp.asarray(s),
                                              in_frac=in_frac)))


def test_squash_plain_batched_shape():
    s = i8(np.random.default_rng(1), (2, 7, 11, 4))
    got = ks.squash_q7(torch.from_numpy(s), in_frac=5)
    assert got.shape == s.shape and got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ops.squash_q7(jnp.asarray(s), in_frac=5)))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("tables", [KERNEL_TEST, MNIST_LIKE],
                         ids=["kernel_test", "mnist_like"])
def test_routing_plain_matches_pallas_and_oracle(rounding, tables):
    u = i8(np.random.default_rng(7), (3, 10, 64, 6))
    got = kr.routing_q7(torch.from_numpy(u), rounding=rounding,
                        **tables).numpy()
    ju = jnp.asarray(u)
    np.testing.assert_array_equal(
        got, np.asarray(ops.routing_q7(ju, rounding=rounding, **tables)))
    np.testing.assert_array_equal(
        got, np.asarray(ref.routing_q7_ref(
            ju, tables["num_iters"], tables["caps_out_shifts"],
            tables["caps_out_fracs"], tables["agree_shifts"],
            tables["logit_frac"], rounding=rounding)))


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_routing_plain_shift_domain_sweep(rounding):
    """Random shift tables over [-31, 31] and other geometries."""
    rng = np.random.default_rng(11)
    for (B, J, I, O) in ((2, 5, 40, 6), (1, 7, 9, 16)):
        u = i8(rng, (B, J, I, O))
        for r in (1, 3):
            kw = dict(num_iters=r,
                      caps_out_shifts=tuple(rng.integers(-31, 32, r).tolist()),
                      caps_out_fracs=tuple(rng.integers(0, 13, r).tolist()),
                      agree_shifts=tuple(
                          rng.integers(-31, 32, r - 1).tolist()),
                      logit_frac=int(rng.integers(-3, 8)))
            got = kr.routing_q7_plain(torch.from_numpy(u), rounding=rounding,
                                      **kw)
            want = ref.routing_q7_ref(
                jnp.asarray(u), r, kw["caps_out_shifts"],
                kw["caps_out_fracs"], kw["agree_shifts"], kw["logit_frac"],
                rounding=rounding)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# wrappers: device routing, counts, refusals
# ---------------------------------------------------------------------------
def test_wrappers_take_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(3)
    s = torch.from_numpy(i8(rng, (50, 4)))
    u = torch.from_numpy(i8(rng, (2, 4, 16, 4)))
    before = (ks.squash_q7.launches, kr.routing_q7.launches)
    assert torch.equal(ks.squash_q7(s, in_frac=4),
                       ks.squash_q7_plain(s, in_frac=4))
    assert torch.equal(kr.routing_q7(u, **MNIST_LIKE),
                       kr.routing_q7_plain(u, **MNIST_LIKE))
    n = torch.arange(0, 5000, dtype=torch.int32)
    assert torch.equal(ks.isqrt(n), torch.sqrt(n.double()).floor()
                       .to(torch.int32))
    assert (ks.squash_q7.launches, kr.routing_q7.launches) == before


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    quietly computed elsewhere."""
    s = torch.empty((8, 4), dtype=torch.int8, device="meta")
    u = torch.empty((2, 4, 16, 4), dtype=torch.int8, device="meta")
    with pytest.raises(NotImplementedError):
        ks.squash_q7(s, in_frac=3)
    with pytest.raises(NotImplementedError):
        kr.routing_q7(u, **MNIST_LIKE)


def test_every_served_geometry_fits_the_routing_kernel():
    for spec in default_specs().values():
        cfg = spec.config
        kr.check_geometry(cfg.num_classes, cfg.num_input_caps, cfg.caps_dim,
                          cfg.routings)
    # one CTA per sample holds it all; an 8-CTA cluster an eighth of it
    assert kr.routing_smem_bytes(10, 1024, 6) == 61440 + 2 * 10240 + 3 * 240
    assert kr.routing_smem_bytes(10, 1024, 6, 8) == \
        10 * 768 + 2 * 1280 + 3 * 240
    kr.check_geometry(10, 4096, 6, 3)          # fits as 8 slices of 512
    kr.check_geometry(10, 40_000, 6, 3)        # 8 slices, u_hat unstaged
    assert not kr.stages(10, 40_000, 6, 8)
    with pytest.raises(ValueError, match="8-CTA cluster.*shared memory"):
        kr.check_geometry(10, 1_000_000, 6, 3)
    kr.check_geometry(10, 64, 32, 16)
    with pytest.raises(ValueError):
        kr.check_geometry(10, 64, 33, 3)
    with pytest.raises(ValueError):
        kr.check_geometry(10, 64, 6, 17)
    with pytest.raises(ValueError):
        ks.check_in_frac(31)


@pytest.mark.parametrize("mid", sorted(default_specs()))
def test_cluster_size_and_slices_for_every_served_geometry(mid):
    """For every bucket the wrapper picks a cluster of at most 4 CTAs
    and at most one CTA per SM that fits shared memory, and every size a
    caller may force has non-empty slices that tile [0, I)."""
    cfg = default_specs()[mid].config
    J, I, O = cfg.num_classes, cfg.num_input_caps, cfg.caps_dim
    for B in (1, 4, 16, 64):
        cs = kr.cluster_size(B, J, I, O)
        assert cs in kr.CLUSTER_SIZES and cs <= min(I, kr.CHOSEN_MAX)
        assert B * cs <= kr.NUM_SMS
        assert 2 * cs > min(I, kr.CHOSEN_MAX) or B * 2 * cs > kr.NUM_SMS
        assert kr.routing_smem_bytes(J, I, O, cs) <= kr.SMEM_LIMIT
        for c in (c for c in kr.CLUSTER_SIZES if c <= I):
            sl = kr.slice_bounds(I, c)
            assert sl[0][0] == 0 and sl[-1][1] == I
            assert all(lo < hi for lo, hi in sl)
            assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
            assert max(hi - lo for lo, hi in sl) == -(-I // c)


def test_cluster_size_choice_at_the_mnist_geometry():
    assert [kr.cluster_size(B, 10, 1024, 6) for B in (1, 4, 16, 64)] == \
        [4, 4, 4, 2]
    assert kr.cluster_size(128, 10, 1024, 6) == 1
    assert kr.cluster_size(1, 4, 3, 4) == 2        # never more CTAs than I
    # a slice too large for shared memory takes a larger cluster
    assert kr.routing_smem_bytes(10, 16_000, 6, 4) > kr.SMEM_LIMIT
    assert kr.cluster_size(64, 10, 16_000, 6) == 8
    for I in (1, 2, 3, 9, 33):
        assert all(hi > lo for lo, hi in kr.slice_bounds(I, min(I, 8)))


def test_launch_plan_is_checked_once_per_geometry():
    kr.launch_plan.cache_clear()
    assert kr.launch_plan(64, 10, 1024, 6, 3) == (2, True)
    assert kr.launch_plan(64, 10, 1024, 6, 3) == (2, True)
    assert kr.launch_plan.cache_info().hits == 1
    assert kr.launch_plan(2, 10, 40_000, 6, 3) == (8, False)
    assert kr.launch_plan(4, 10, 1024, 6, 3, cs=8, stage=False) == (8, False)
    with pytest.raises(ValueError, match="cluster size 9"):
        kr.launch_plan(4, 10, 1024, 6, 3, cs=9)
    with pytest.raises(ValueError, match="staged needs more"):
        kr.launch_plan(2, 10, 40_000, 6, 3, stage=True)
    with pytest.raises(ValueError, match="capsule dim"):
        kr.launch_plan(2, 10, 64, 33, 3)


def test_routing_args_check_their_tables_when_built():
    with pytest.raises(ValueError, match="do not match"):
        kr._routing_args(3, (8, 8), (7, 7, 6), (8, 8), 7, 0)
    with pytest.raises(ValueError, match="in_frac 31"):
        kr._routing_args(2, (8, 8), (7, 31), (8,), 7, 0)


def test_routing_args_are_built_once_per_table():
    a = kr._routing_args(3, (8, 8, 9), (7, 7, 6), (8, 8), 7, 0)
    assert kr._routing_args(3, [8, 8, 9], [7, 7, 6], [8, 8, 99], 7, 0) is a
    assert kr._routing_args(3, (8, 8, 9), (7, 7, 6), (8, 8), 7, 1) is not a
    assert ctypes.sizeof(kr.RoutingArgs) == 4 * (3 + 3 * kr.MAX_ITERS)
    assert list(a.caps_out_shifts) == [8, 8, 9] + [0] * (kr.MAX_ITERS - 3)
    assert list(a.agree_shifts)[:3] == [8, 8, 0]
    assert (a.num_iters, a.logit_frac, a.nearest) == (3, 7, 0)


# ---------------------------------------------------------------------------
# numpy mirrors of the kernels' shortcuts against the reference oracles
# ---------------------------------------------------------------------------
def isqrt_mirror(n):
    """q7::isqrt: n <= 1 -> n; else the truncated float32 root of n
    rounded to float32, one step down or up with the squares in int64."""
    n = np.asarray(n, dtype=np.int64)
    pos = np.maximum(n, 2)
    r = np.sqrt(pos.astype(np.float32)).astype(np.int64)
    r = np.where(r * r > pos, r - 1,
                 np.where((r + 1) * (r + 1) <= pos, r + 1, r))
    return np.where(n <= 1, n, r).astype(np.int32)


def softmax_mirror(x, logit_frac):
    """The kernel's softmax over the last axis: one division a row,
    c = min((2^27 // tot) >> -e, 127)."""
    x = x.astype(np.int64)
    d = x - x.max(axis=-1, keepdims=True)
    e = d >> logit_frac if 0 <= logit_frac < 32 else np.where(d < 0, -1, 0)
    e = np.maximum(e, -20)
    tot = (np.int64(1) << (20 + e)).sum(axis=-1, keepdims=True)
    q = (1 << 27) // np.maximum(tot, 1)
    return np.minimum(q >> -e, 127).astype(np.int8)


def test_isqrt_mirror_equals_newton_on_the_squash_range_and_int31():
    n = np.arange(0, 16 * 128 * 128 + 1, dtype=np.int32)
    want = np.asarray(R.isqrt_newton(jnp.asarray(n)))
    np.testing.assert_array_equal(isqrt_mirror(n), want)
    # on the squash range the truncated root needs no correction
    np.testing.assert_array_equal(
        np.sqrt(n.astype(np.float32)).astype(np.int32), want)
    rng = np.random.default_rng(13)
    k = np.arange(40_000, 46_341, dtype=np.int64)
    big = np.concatenate([
        rng.integers(0, 2 ** 31, 200_000), k * k - 1, k * k, k * k + 1,
        [2 ** 31 - 1, 2 ** 31 - 2, 46_340 ** 2, 1 << 30, (1 << 24) + 1]])
    big = big[big < 2 ** 31].astype(np.int32)
    np.testing.assert_array_equal(
        isqrt_mirror(big), np.asarray(R.isqrt_newton(jnp.asarray(big))))
    neg = np.array([-2 ** 31, -2 ** 31 + 1, -46_341, -5, -1, 0, 1],
                   np.int32)
    np.testing.assert_array_equal(isqrt_mirror(neg), np.asarray(
        R.isqrt_newton(jnp.asarray(neg))))
    np.testing.assert_array_equal(isqrt_mirror(neg)[:-2], neg[:-2])


@pytest.mark.parametrize("logit_frac", range(-3, 8))
def test_one_division_softmax_mirror_equals_softmax_q7(logit_frac):
    rng = np.random.default_rng(100 + logit_frac)
    rows = [i8(rng, (512, 10)), i8(rng, (64, 5)), i8(rng, (32, 1)),
            np.full((4, 10), -128, np.int8), np.full((4, 10), 127, np.int8)]
    sat = np.full((64, 10), -128, np.int8)
    sat[np.arange(64), rng.integers(0, 10, 64)] = 127
    mixed = rng.choice(np.array([-128, -127, 0, 126, 127], np.int8),
                       (256, 10))
    for x in rows + [sat, mixed]:
        got = softmax_mirror(x, logit_frac)
        np.testing.assert_array_equal(
            got, np.asarray(R.softmax_q7(jnp.asarray(x), logit_frac)))
        np.testing.assert_array_equal(
            got, T.softmax_q7(torch.from_numpy(x), logit_frac).numpy())


def routing_cluster_mirror(u, cs, *, num_iters, caps_out_shifts,
                           caps_out_fracs, agree_shifts, logit_frac,
                           rounding):
    """routing_q7.cu's decomposition on the CPU: each of cs slices of I
    keeps its own logits, runs the one-division softmax and its partial
    s; the partials' int32 sum is squashed once, the agreement stays in
    the slice."""
    B, J, I, O = u.shape
    slices = kr.slice_bounds(I, cs)
    b = [torch.zeros((B, J, hi - lo), dtype=torch.int8) for lo, hi in slices]
    v = None
    for r in range(num_iters):
        acc = torch.zeros((B, J, O), dtype=torch.int32)
        for k, (lo, hi) in enumerate(slices):
            if r > 0:
                a = T.einsum_i32("bjio,bjo->bji", u[:, :, lo:hi], v)
                b[k] = T.add_q7(b[k], T.rshift_sat8(a, agree_shifts[r - 1],
                                                    rounding))
            c = softmax_mirror(b[k].transpose(1, 2).numpy(), logit_frac)
            c = torch.from_numpy(c).transpose(1, 2)
            acc = acc + T.einsum_i32("bji,bjio->bjo", c, u[:, :, lo:hi])
        s_q = T.rshift_sat8(acc, caps_out_shifts[r], rounding)
        v = T.squash_q7(s_q, in_frac=caps_out_fracs[r])
    return v


@pytest.mark.parametrize("cs", range(1, 9))
def test_cluster_decomposition_equals_the_plain_routing(cs):
    rng = np.random.default_rng(cs)
    for (B, J, I, O) in ((2, 10, 64, 6), (1, 7, 33, 16), (2, 3, 9, 6)):
        u = torch.from_numpy(i8(rng, (B, J, I, O)))
        for rounding in ROUNDINGS:
            kw = dict(num_iters=3,
                      caps_out_shifts=tuple(rng.integers(-31, 32, 3).tolist()),
                      caps_out_fracs=tuple(rng.integers(0, 13, 3).tolist()),
                      agree_shifts=tuple(rng.integers(-31, 32, 2).tolist()),
                      logit_frac=int(rng.integers(-3, 8)), rounding=rounding)
            for tables in (kw, dict(kw, **MNIST_LIKE)):
                assert torch.equal(
                    routing_cluster_mirror(u, min(cs, I), **tables),
                    kr.routing_q7_plain(u, **tables))


def test_kernel_sources_name_what_they_replace():
    names = sorted(p.stem for p in build.sources())
    assert names == ["conv_q7", "q7_matmul", "routing_q7", "squash_float",
                     "squash_q7", "w8a8_dense", "w8a8_matmul"]
    notes = {"routing_q7": "src/repro/kernels/routing.py",
             "squash_q7": "src/repro/kernels/squash.py",
             "squash_float": "src/repro/kernels/squash.py",
             "q7_matmul": "src/repro/kernels/q7_matmul.py",
             "w8a8_matmul": "src/repro/kernels/w8a8_matmul.py",
             # no TPU kernel: the XLA product it takes the place of
             "w8a8_dense": "src/repro/quant/lm_quant.py:76",
             "conv_q7": "src/repro/quant/int8_ops.py"}
    for p in build.sources():
        text = p.read_text()
        what = {"w8a8_dense": "(q_dense)",
                "conv_q7": "conv2d_q7_per_channel"}.get(p.stem,
                                                        f"{p.stem}_pallas")
        assert notes[p.stem] in text and what in text
        assert "Bound on the H100" in text
        assert f'extern "C" int {p.stem}_launch' in text
    for gemm in ("q7_matmul", "w8a8_matmul", "w8a8_dense"):
        text = (build.CSRC / f"{gemm}.cu").read_text()
        assert '#include "i8_gemm.cuh"' in text and "i8gemm::launch" in text
    h = build.source_hash()
    assert h == build.source_hash() and len(h) == 16
    assert str(build.BUILD_ROOT).endswith("build/repro_torch_kernels")


@pytest.mark.parametrize("header", ["i8_gemm.cuh", "i8_gemm_sm90.cuh",
                                    "q7.cuh"])
def test_source_hash_covers_the_shared_headers(header, tmp_path,
                                               monkeypatch):
    """An edit to a header alone must rebuild every kernel."""
    for p in build.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.source_hash()
    with open(tmp_path / header, "a") as f:
        f.write("\n// edited\n")
    assert build.source_hash() != before


def test_the_wgmma_main_loop_names_what_it_replaces_and_wraps():
    """i8_gemm_sm90.cuh: the note of what it replaces and its bound,
    wgmma on .s8 without .satfinite (XLA's int32 dot wraps), the TMA
    maps taken through the runtime's driver entry point (no libcuda
    link), and both GEMM sources exporting the route's C entries."""
    text = (build.CSRC / "i8_gemm_sm90.cuh").read_text()
    for note in ("src/repro/kernels/q7_matmul.py", "q7_matmul_pallas",
                 "src/repro/kernels/w8a8_matmul.py", "w8a8_matmul_pallas",
                 "Bound on the H100", "modulo 2^32"):
        assert note in text, note
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" in text
    assert "satfinite" not in text.replace("WITHOUT .satfinite", "")
    assert "cp.async.bulk.tensor.3d" in text and "SWIZZLE_128B" in text
    assert "cudaGetDriverEntryPoint" in text
    assert "-lcuda" not in build.NVCC_FLAGS
    for gemm in ("q7_matmul", "w8a8_matmul"):
        src = (build.CSRC / f"{gemm}.cu").read_text()
        assert '#include "i8_gemm_sm90.cuh"' in src
        for entry in (f"{gemm}_launch", f"{gemm}_wgmma_launch",
                      f"{gemm}_reduce_launch"):
            assert f'extern "C" int {entry}(' in src, entry
    assert 'extern "C" int i8_transpose_launch(' in \
        (build.CSRC / "q7_matmul.cu").read_text()


def test_every_gemm_entry_has_its_argtypes():
    """Each C entry a GEMM wrapper binds takes a pointer for every
    pointer and an int for every int of its C signature."""
    import re
    from repro_torch.kernels import q7_matmul as kq
    for lib in ("q7_matmul", "w8a8_matmul", "w8a8_dense"):
        src = (build.CSRC / f"{lib}.cu").read_text()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     src):
            kinds = [ctypes.c_void_p if "*" in a else ctypes.c_int
                     for a in args.split(",")]
            assert kq.ARGTYPES[name] == kinds, name


def test_build_error_check_raises():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        build.check(98, "kernel")
    assert ctypes.sizeof(ctypes.c_void_p) == 8       # pointers are not cut
