"""The port's CUDA kernels on the card, held bit for bit against their
plain torch versions.  Every case needs a CUDA device and skips without
one; the file imports torch and the port only, so the GPU host runs it
without JAX and without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import q7_matmul as kq
from repro_torch.kernels import routing as kr
from repro_torch.kernels import squash as ks
from repro_torch.kernels import w8a8_matmul as kw
from repro_torch.nn.backend import get_backend
from repro_torch.serving import ModelRegistry, default_specs

ROUNDINGS = ("floor", "nearest")
GEMM_MKN = [(20, 30, 40), (128, 128, 128), (7, 257, 130), (1, 5, 3),
            (200, 64, 96), (4096, 784, 64), (256, 256, 256)]
MNIST_LIKE = dict(num_iters=3, caps_out_shifts=(8, 8, 9),
                  caps_out_fracs=(7, 7, 6), agree_shifts=(8, 8), logit_frac=7)


def i8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_squash_matches_plain(cuda):
    s = i8(np.random.default_rng(5), (64 * 1024, 4))
    n0 = ks.squash_q7.launches
    for in_frac in range(13):
        got = ks.squash_q7(s.to(cuda), in_frac=in_frac)
        assert torch.equal(got.cpu(), ks.squash_q7_plain(s, in_frac=in_frac))
    assert ks.squash_q7.launches == n0 + 13
    n = torch.arange(0, 16 * 128 * 128 + 1, dtype=torch.int32)
    assert torch.equal(ks.isqrt(n.to(cuda)).cpu(), ks.isqrt(n))


@pytest.mark.gpu
def test_cuda_isqrt_equals_newton_on_every_int31(cuda):
    """q7::isqrt against int8_ops.isqrt_newton run on the card, over every
    n in [0, 2^31 - 1] in chunks, and on negative n."""
    from repro_torch.quant import int8_ops as q
    chunk = 1 << 27
    for lo in range(0, 1 << 31, chunk):
        n = torch.arange(lo, lo + chunk, dtype=torch.int64,
                         device=cuda).to(torch.int32)
        assert int((ks.isqrt(n) != q.isqrt_newton(n)).sum()) == 0, lo
    neg = torch.from_numpy(np.random.default_rng(2).integers(
        -2 ** 31, 0, 1 << 16).astype(np.int32)).to(cuda)
    assert torch.equal(ks.isqrt(neg), neg)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 16, 64])
def test_cuda_routing_every_bucket_and_cluster_size(cuda, B):
    u = i8(np.random.default_rng(B), (B, 10, 1024, 6)).to(cuda)
    for rounding in ROUNDINGS:
        want = kr.routing_q7_plain(u, rounding=rounding, **MNIST_LIKE)
        for cs in (None,) + kr.CLUSTER_SIZES:
            got = kr.routing_q7(u, rounding=rounding, cs=cs, **MNIST_LIKE)
            assert torch.equal(got, want), (cs, rounding)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [(3, 7, 33, 16), (2, 3, 9, 6),
                                  (4, 5, 1600, 6)], ids=str)
def test_cuda_routing_ragged_slices(cuda, geom):
    """I not divisible by the cluster size, every size up to min(I, 8)."""
    u = i8(np.random.default_rng(sum(geom)), geom)
    kw = dict(num_iters=3, caps_out_shifts=(5, -3, 9),
              caps_out_fracs=(4, 0, 12), agree_shifts=(-7, 11),
              logit_frac=-2)
    for rounding in ROUNDINGS:
        want = kr.routing_q7_plain(u, rounding=rounding, **kw)
        for cs in range(1, min(geom[2], kr.MAX_CLUSTER) + 1):
            got = kr.routing_q7(u.to(cuda), rounding=rounding, cs=cs, **kw)
            assert torch.equal(got.cpu(), want), (cs, rounding)


@pytest.mark.gpu
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_cuda_routing_matches_plain(cuda, rounding):
    u = i8(np.random.default_rng(6), (16, 10, 1024, 6))
    n0 = kr.routing_q7.launches
    got = kr.routing_q7(u.to(cuda), rounding=rounding, **MNIST_LIKE)
    assert kr.routing_q7.launches == n0 + 1
    assert torch.equal(got.cpu(), kr.routing_q7_plain(u, rounding=rounding,
                                                      **MNIST_LIKE))


@pytest.mark.gpu
def test_cuda_backend_forward_equals_the_torch_backend(cuda):
    spec = default_specs()["edge_tiny@cuda"]
    qnet = ModelRegistry({spec.model_id: spec}, device=cuda) \
        .model(spec.model_id)
    x = torch.from_numpy(spec.images(9, seed=3)).to(cuda)
    x_q = qnet.quantize_input(x)
    n0 = (ks.squash_q7.launches, kr.routing_q7.launches)
    v = qnet.forward(x_q)
    assert (ks.squash_q7.launches, kr.routing_q7.launches) == \
        (n0[0] + 1, n0[1] + 1)
    assert torch.equal(v, qnet.with_backend("torch").forward(x_q))


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", GEMM_MKN, ids=lambda m: "x".join(map(str, m)))
def test_cuda_matmul_q7_and_w8a8_match_plain(cuda, mkn):
    M, K, N = mkn
    rng = np.random.default_rng(M + K + N)
    a, b = i8(rng, (M, K)), i8(rng, (K, N))
    sh = torch.from_numpy(rng.integers(-40, 41, (N,)).astype(np.int32))
    ad, bd, shd = a.to(cuda), b.to(cuda), sh.to(cuda)
    n0 = (kq.matmul_q7.launches, kw.w8a8_matmul.launches)
    for rounding in ROUNDINGS:
        for shift in (0, 3, 9, -2, 12):
            got = ops.matmul_q7(ad, bd, shift, rounding)
            assert torch.equal(got.cpu(), kq.matmul_q7_plain(a, b, shift,
                                                             rounding))
        got = ops.w8a8_matmul(ad, bd, shd, rounding)
        assert torch.equal(got.cpu(), kw.w8a8_matmul_plain(a, b, sh,
                                                           rounding))
    assert (kq.matmul_q7.launches, kw.w8a8_matmul.launches) == \
        (n0[0] + 10, n0[1] + 2)


@pytest.mark.gpu
def test_cuda_matmul_q7_every_shift_and_the_int32_wrap(cuda):
    rng = np.random.default_rng(9)
    a, b = i8(rng, (33, 70)), i8(rng, (70, 17))
    for rounding in ROUNDINGS:
        for shift in range(-40, 41):
            assert torch.equal(
                ops.matmul_q7(a.to(cuda), b.to(cuda), shift, rounding).cpu(),
                kq.matmul_q7_plain(a, b, shift, rounding))
    a = torch.full((4, 140_000), -128, dtype=torch.int8)
    b = torch.full((140_000, 8), -128, dtype=torch.int8)
    for shift in (0, 20, 31):
        assert torch.equal(ops.matmul_q7(a.to(cuda), b.to(cuda), shift).cpu(),
                           kq.matmul_q7_plain(a, b, shift))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [(), (3,), (2, 5)], ids=str)
def test_cuda_bmm_q7_is_one_launch(cuda, batch):
    rng = np.random.default_rng(len(batch))
    a, b = i8(rng, batch + (70, 90)), i8(rng, batch + (90, 33))
    n0 = kq.bmm_q7.launches
    for rounding in ROUNDINGS:
        got = ops.bmm_q7(a.to(cuda), b.to(cuda), 7, rounding)
        assert torch.equal(got.cpu(), kq.bmm_q7_plain(a, b, 7, rounding))
    assert kq.bmm_q7.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_cuda_squash_float_matches_plain(cuda, dtype):
    s = torch.from_numpy(np.random.default_rng(4).normal(
        0, 2, (64 * 1024, 4)).astype(np.float32)).to(dtype).to(cuda)
    n0 = ks.squash_float.launches
    got = ops.squash_float(s)
    assert got.dtype == dtype and ks.squash_float.launches == n0 + 1
    want = ks.squash_float_plain(s)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:      # float32 results a rounding apart may round one ulp apart
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        torch.testing.assert_close(got.float(), want.float(), rtol=ulp,
                                   atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("shape,cut", [((4096, 4), 0), ((4097, 8), 0),
                                       ((4096, 16), 0), ((999, 160), 0),
                                       ((64, 6), 0), ((4099, 5), 1),
                                       ((7, 1000), 0), ((37, 2), 0),
                                       ((2, 33, 5), 1)], ids=str)
def test_cuda_squash_float_every_path_is_one_launch(cuda, dtype, shape, cut):
    """Each path of csrc/squash_float.cu (packed words, lane groups,
    element loads, a view whose rows are misaligned) in one launch at
    every dtype, within 1e-6 (float32) or one ulp of its plain version."""
    s = torch.from_numpy(np.random.default_rng(shape[-1]).normal(
        0, 2, shape).astype(np.float32)).to(dtype).to(cuda)[..., cut:]
    n0 = ks.squash_float.launches
    got = ops.squash_float(s)
    torch.cuda.synchronize()
    assert ks.squash_float.launches == n0 + 1
    assert got.dtype == dtype and got.shape == s.shape
    want = ks.squash_float_plain(s)
    tol = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=1e-6)


@pytest.mark.gpu
def test_cuda_installed_artifact_serves_its_source_models_bits(cuda,
                                                               tmp_path):
    from repro_torch.edge import EdgeProgram, EdgeVM
    from repro_torch.serving import CapsServeEngine
    reg = ModelRegistry({"edge_tiny@cuda": default_specs()["edge_tiny@cuda"]},
                        device=cuda)
    path = reg.export("edge_tiny@cuda", tmp_path)["paths"]["capsbin"]
    other = ModelRegistry({}, device=cuda)
    q2 = other.install_artifact(path, model_id="shipped")
    assert q2.backend == "cuda" and q2.device.type == "cuda"
    images = default_specs()["edge_tiny@cuda"].images(21, seed=6)
    outs = []
    n0 = (kr.routing_q7.launches, ks.squash_q7.launches)
    for r, mid in ((reg, "edge_tiny@cuda"), (other, "shipped")):
        engine = CapsServeEngine(r, buckets=(1, 4, 16))
        engine.submit_many(images, mid)
        outs.append(np.stack([c.v_q for c in engine.drain()]))
    assert kr.routing_q7.launches > n0[0] and ks.squash_q7.launches > n0[1]
    np.testing.assert_array_equal(outs[0], outs[1])
    x_q = q2.quantize_input(torch.from_numpy(images).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(outs[1],
                                  EdgeVM(EdgeProgram.load(path)).run(x_q))


@pytest.mark.gpu
def test_cuda_backend_serves_a_variant_plan_through_the_oracle(cuda):
    spec = dataclasses.replace(default_specs()["edge_tiny@cuda"],
                               softmax_impl="approx")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        reg = ModelRegistry({spec.model_id: spec}, device=cuda)
        qnet = reg.model(spec.model_id)
        x_q = qnet.quantize_input(torch.from_numpy(spec.images(9, seed=3))
                                  .to(cuda))
        n0 = get_backend("cuda").fallbacks.get(("routing.softmax", "approx"),
                                                0)
        v = qnet.forward(x_q)
    assert reg.variant_fallbacks == {spec.model_id: "approx+exact"}
    assert get_backend("cuda").fallbacks[("routing.softmax", "approx")] \
        == n0 + 1
    assert v.device.type == "cuda"
    assert torch.equal(v, qnet.with_backend("torch").forward(x_q))


# ---------------------------------------------------------------------------
# the two GEMM routes
# ---------------------------------------------------------------------------
def wrap_and_return(M, K, N, rng):
    """132,000 products of (-128)(-128), 133,040 of (-128)(127), then
    random ones: the running int32 sum wraps and comes back."""
    k1, k2 = 132_000, 133_040
    a = np.full((M, K), -128, np.int8)
    b = np.full((K, N), -128, np.int8)
    b[k1:k1 + k2] = 127
    a[:, k1 + k2:] = rng.integers(-128, 128, (M, K - k1 - k2))
    b[k1 + k2:] = rng.integers(-128, 128, (K - k1 - k2, N))
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.gpu
@pytest.mark.parametrize("mkn_offset", [
    (20, 32, 40, 0), (4096, 784, 64, 0), (4, 2048, 8, 0), (300, 512, 300, 0),
    (1024, 1024, 1024, 0), (7, 257, 130, 0), (4096, 49, 16, 0),
    (256, 784, 64, 1), (256, 784, 64, 8)], ids=str)
def test_cuda_each_route_matches_plain_and_is_counted(cuda, mkn_offset):
    """A at `offset` bytes past a 16-byte boundary (a contiguous view);
    every call counts one launch on the route gemm_plan names."""
    M, K, N, offset = mkn_offset
    rng = np.random.default_rng(M + K + N + offset)
    a, b = i8(rng, (M, K)), i8(rng, (K, N))
    sh = torch.from_numpy(rng.integers(-40, 41, (N,)).astype(np.int32))
    buf = torch.zeros(M * K + 16, dtype=torch.int8, device=cuda)
    ad = buf[offset:offset + M * K].view(M, K)
    ad.copy_(a)
    bd, shd = b.to(cuda), sh.to(cuda)
    plan = kq.plan_for(ad, bd)
    assert plan.route == ("mma.sync" if offset or K % 16 else "wgmma")
    for fn, call, want in (
            (kq.matmul_q7, lambda r: ops.matmul_q7(ad, bd, 9, r),
             lambda r: kq.matmul_q7_plain(a, b, 9, r)),
            (kw.w8a8_matmul, lambda r: ops.w8a8_matmul(ad, bd, shd, r),
             lambda r: kw.w8a8_matmul_plain(a, b, sh, r))):
        for rounding in ROUNDINGS:
            before = dict(fn.launches_by_route)
            got = call(rounding)
            before[plan.route] += 1
            assert fn.launches_by_route == before
            assert torch.equal(got.cpu(), want(rounding)), (fn, rounding)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_split", [(128, 1), (256, 1), (128, 3),
                                        (256, 2), (128, 8)], ids=str)
def test_cuda_wgmma_every_tile_and_split_matches_plain(cuda, tile_split):
    """gemm_plan picks one tile and split a shape; any other the kernel
    takes gives the same bits."""
    tile_n, split = tile_split
    plan = kq.GemmPlan("wgmma", (128, tile_n), split)
    rng = np.random.default_rng(tile_n + split)
    for M, K, N in ((4, 2048, 8), (200, 784, 300), (129, 1040, 257)):
        a, b = i8(rng, (M, K)), i8(rng, (K, N))
        sh = torch.from_numpy(rng.integers(-40, 41, (N,)).astype(np.int32))
        got, used = kq._launch(a.to(cuda), b.to(cuda), 11, "nearest", plan)
        assert used == plan
        assert torch.equal(got.cpu(), kq.matmul_q7_plain(a, b, 11,
                                                         "nearest"))
        got, _ = kw._launch(a.to(cuda), b.to(cuda), sh.to(cuda), "floor",
                            plan)
        assert torch.equal(got.cpu(), kw.w8a8_matmul_plain(a, b, sh,
                                                           "floor"))


@pytest.mark.gpu
def test_cuda_transpose_kn_matches_the_plain_transpose(cuda):
    rng = np.random.default_rng(3)
    for shape in ((16, 3), (784, 64), (272, 130), (2, 4096, 8), (64, 17),
                  (3, 528, 33)):
        b = i8(rng, shape)
        n0 = kq.transpose_kn.launches
        got = kq.transpose_kn(b.to(cuda))
        assert kq.transpose_kn.launches == n0 + 1
        assert torch.equal(got.cpu(), kq.transpose_kn_plain(b)), shape
    # B starting one byte past a word boundary: byte loads
    b = i8(rng, (257, 130))
    buf = torch.zeros(257 * 130 + 1, dtype=torch.int8, device=cuda)
    view = buf[1:].view(257, 130)
    view.copy_(b)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kq.transpose_kn(view)                   # K % 4 != 0 is refused
    b = i8(rng, (256, 130))
    view = buf[1:1 + 256 * 130].view(256, 130)
    view.copy_(b)
    assert torch.equal(kq.transpose_kn(view).cpu(), b.t().contiguous())


@pytest.mark.gpu
def test_cuda_wrap_and_return_on_every_route(cuda):
    """The running int32 sum overflows partway through K and comes back:
    the split-K plan gemm_plan picks, one wgmma block per tile and the
    mma.sync loop all wrap, so all equal the plain version."""
    a, b = wrap_and_return(8, 265_296, 16, np.random.default_rng(11))
    ad, bd = a.to(cuda), b.to(cuda)
    sh = torch.arange(-8, 8, dtype=torch.int32)
    planned = kq.plan_for(ad, bd)
    assert planned.route == "wgmma" and planned.split > 1
    for plan in (None, kq.GemmPlan("wgmma", (128, 128), 1),
                 kq.GemmPlan("mma.sync", (128, 128), 1)):
        for shift in (0, 20, 31):
            got, _ = kq._launch(ad, bd, shift, "floor", plan)
            assert torch.equal(got.cpu(), kq.matmul_q7_plain(a, b, shift)), \
                (plan, shift)
        got, _ = kw._launch(ad, bd, sh.to(cuda), "nearest", plan)
        assert torch.equal(got.cpu(), kw.w8a8_matmul_plain(a, b, sh))


@pytest.mark.gpu
def test_cuda_bmm_q7_takes_the_3d_map_in_one_call(cuda):
    rng = np.random.default_rng(12)
    a, b = i8(rng, (8, 256, 256)), i8(rng, (8, 256, 256))
    ad, bd = a.to(cuda), b.to(cuda)
    assert kq.plan_for(ad, bd).route == "wgmma"
    n0, r0 = kq.bmm_q7.launches, kq.bmm_q7.launches_by_route["wgmma"]
    t0 = kq.transpose_kn.launches
    for rounding in ROUNDINGS:
        got = ops.bmm_q7(ad, bd, 13, rounding)
        assert torch.equal(got.cpu(), kq.bmm_q7_plain(a, b, 13, rounding))
    assert kq.bmm_q7.launches == n0 + 2
    assert kq.bmm_q7.launches_by_route["wgmma"] == r0 + 2
    assert kq.transpose_kn.launches == t0 + 2      # one transpose a call


# ---------------------------------------------------------------------------
# the widened kernels, and the numerics probe on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 5, 17, 18, 20, 32])
def test_cuda_squash_every_width_up_to_32(cuda, D):
    s = i8(np.random.default_rng(D), (3000, D))
    for in_frac in (0, 5, 12):
        got = ks.squash_q7(s.to(cuda), in_frac=in_frac)
        assert torch.equal(got.cpu(), ks.squash_q7_plain(s, in_frac=in_frac))


@pytest.mark.gpu
@pytest.mark.parametrize("geom,iters", [((3, 10, 64, 20), 3),
                                        ((2, 7, 33, 32), 4),
                                        ((4, 4, 16, 4), 16),
                                        ((2, 5, 40, 17), 9)], ids=str)
def test_cuda_routing_wide_capsules_and_many_iterations(cuda, geom, iters):
    """O up to 32 and up to 16 iterations, staged and unstaged, at every
    cluster size."""
    g = np.random.default_rng(sum(geom) + iters)
    u = i8(g, geom)
    kw = dict(num_iters=iters,
              caps_out_shifts=tuple(int(x) for x in g.integers(-31, 32, iters)),
              caps_out_fracs=tuple(int(x) for x in g.integers(0, 13, iters)),
              agree_shifts=tuple(int(x) for x in g.integers(-31, 32,
                                                            iters - 1)),
              logit_frac=int(g.integers(-3, 8)))
    for rounding in ROUNDINGS:
        want = kr.routing_q7_plain(u, rounding=rounding, **kw)
        for cs in range(1, min(geom[2], kr.MAX_CLUSTER) + 1):
            for stage in (True, False):
                got = kr.routing_q7(u.to(cuda), rounding=rounding, cs=cs,
                                    stage=stage, **kw)
                assert torch.equal(got.cpu(), want), (cs, stage, rounding)


@pytest.mark.gpu
def test_cuda_routing_reads_u_hat_unstaged_where_it_does_not_fit(cuda):
    J, I, O = 10, 40_000, 6
    assert not kr.stages(J, I, O, kr.cluster_size(2, J, I, O))
    u = i8(np.random.default_rng(9), (2, J, I, O))
    for rounding in ROUNDINGS:
        got = kr.routing_q7(u.to(cuda), rounding=rounding, **MNIST_LIKE)
        assert torch.equal(got.cpu(), kr.routing_q7_plain(
            u, rounding=rounding, **MNIST_LIKE))


@pytest.mark.gpu
@pytest.mark.parametrize("edit", [dict(pcap_dim=18), dict(caps_dim=20),
                                  dict(routings=9)],
                         ids=["pcap_dim=18", "caps_dim=20", "routings=9"])
def test_cuda_backend_serves_a_widened_geometry_like_the_torch_backend(
        cuda, edit):
    from repro_torch.serving import serve_window
    base = default_specs()["edge_tiny@cuda"]
    spec = dataclasses.replace(base, config=dataclasses.replace(
        base.config, **edit))
    reg = ModelRegistry({spec.model_id: spec}, device=cuda)
    images = spec.images(16, seed=5)
    fallbacks = dict(get_backend("cuda").fallbacks)
    n0 = (ks.squash_q7.launches, kr.routing_q7.launches)
    _, done, _ = serve_window(reg, (1, 4, 16), images, spec.model_id)
    assert ks.squash_q7.launches > n0[0] and kr.routing_q7.launches > n0[1]
    assert dict(get_backend("cuda").fallbacks) == fallbacks
    qnet = reg.model(spec.model_id).with_backend("torch")
    with torch.inference_mode():
        want = qnet.forward(qnet.quantize_input(
            torch.from_numpy(images).to(cuda))).cpu().numpy()
    np.testing.assert_array_equal(np.stack([c.v_q for c in done]), want)


@pytest.mark.gpu
def test_cuda_probed_forward_is_bit_identical_to_unprobed(cuda):
    from repro_torch.obs import numerics as nh
    spec = default_specs()["mnist@cuda"]
    qnet = ModelRegistry({spec.model_id: spec}, device=cuda) \
        .model(spec.model_id)
    x_q = qnet.quantize_input(torch.from_numpy(spec.images(16, seed=2))
                              .to(cuda))
    with torch.inference_mode():
        base = qnet.forward(x_q)
        probe = nh.NumericsProbe()
        with nh.probing(probe):
            probed = qnet.forward(x_q)
    assert torch.equal(base, probed)
    rows = probe.rows()
    assert {r["op"] for r in rows} == {"conv0", "pcap", "caps"}
    assert sum(r.get("int32_clip", 0) for r in rows) == 0
    # the squash and the routing loop run inside the kernels: the probe
    # sees conv0's and the primary caps' requants, u_hat's, and outputs
    assert sorted((r["op"], r["site"]) for r in rows
                  if r["family"] == "requant") == [
        ("caps", "requant[0]"), ("conv0", "requant[0]"),
        ("pcap", "requant[0]")]
