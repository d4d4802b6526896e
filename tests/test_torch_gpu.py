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

from repro_torch.kernels import conv as kc
from repro_torch.kernels import ops
from repro_torch.kernels import q7_matmul as kq
from repro_torch.kernels import routing as kr
from repro_torch.kernels import squash as ks
from repro_torch.kernels import w8a8_matmul as kw
from repro_torch.nn.backend import get_backend
from repro_torch.nn.config import CIFAR10, MNIST, SMALLNORB
from repro_torch.quant import int8_ops as q
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


# ---------------------------------------------------------------------------
# the int8 conv kernel (csrc/conv_q7.cu)
# ---------------------------------------------------------------------------
PAPER_CONVS = [(cfg.name.split("_")[1], g) for cfg in (MNIST, SMALLNORB,
                                                        CIFAR10)
               for g in cfg.conv_geometries]
# past the paper's nets: a ragged Cout (byte stores), Cout over 64 (two
# columns of blocks), Cin 5 (byte gathers), Cin 4 (4-byte gathers)
RAGGED_CONVS = [(7, 9, 4, 3, 2, 49), (6, 6, 8, 3, 1, 80), (9, 9, 5, 5, 1, 3)]


def conv_faces(x, w, b, stride, rounding, relu, rng):
    """Each face of the wrapper on the card beside its plain version on
    the same CUDA tensors: [(got, want), ...]."""
    Cout = w.shape[3]
    out_shift, bias_shift = int(rng.integers(4, 13)), int(rng.integers(0, 7))
    os_ = tuple(int(s) for s in rng.integers(-8, 41, Cout))
    bs = tuple(int(s) for s in rng.integers(-8, 41, Cout))
    kw = dict(stride=stride, rounding=rounding)
    pairs = []
    for face, plain, shifts in (
            (kc.conv2d_q7, kc.conv2d_q7_plain, (out_shift, bias_shift)),
            (kc.conv2d_q7_per_channel, kc.conv2d_q7_per_channel_plain,
             (os_, bs))):
        want = plain(x, w, b, *shifts, **kw)
        pairs.append((face(x, w, b, *shifts, relu=relu, **kw),
                      q.relu_q7(want) if relu else want))
    return pairs


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 37, 256])
@pytest.mark.parametrize("net_geom", PAPER_CONVS + [("ragged", g)
                                                    for g in RAGGED_CONVS],
                         ids=lambda p: f"{p[0]}-{'x'.join(map(str, p[1]))}")
def test_cuda_conv_every_geometry_matches_plain(cuda, net_geom, B):
    H, W, Cin, k, stride, Cout = net_geom[1]
    rng = np.random.default_rng(B * 1000 + H * 10 + Cin)
    x = i8(rng, (B, H, W, Cin)).to(cuda)
    w, b = i8(rng, (k, k, Cin, Cout)).to(cuda), i8(rng, (Cout,)).to(cuda)
    n0 = (kc.conv2d_q7.launches, kc.conv2d_q7_per_channel.launches)
    calls = 0
    for rounding in ROUNDINGS:
        for relu in (False, True):
            for got, want in conv_faces(x, w, b, stride, rounding, relu, rng):
                assert torch.equal(got, want), (rounding, relu)
            calls += 1
    assert (kc.conv2d_q7.launches, kc.conv2d_q7_per_channel.launches) == \
        (n0[0] + calls, n0[1] + calls)
    nb = kc.conv2d_q7(x, w, None, 9, 0, stride=stride)
    assert torch.equal(nb, kc.conv2d_q7_plain(x, w, None, 9, 0,
                                              stride=stride))


@pytest.mark.gpu
def test_cuda_conv_every_shift_and_the_int32_wrap(cuda):
    """Every out and bias shift in [-8, 40] on both faces (the scalar
    face at every pair, the per-channel face with all 49 in one table),
    with x and w at the int8 extremes and K = 1,152, so that a bias
    shifted by 24 wraps the int32 accumulator both ways."""
    shifts = list(range(-8, 41))
    Cout = len(shifts)
    x = torch.full((2, 5, 5, 128), -128, dtype=torch.int8)
    x[1] = 127
    w = torch.full((3, 3, 128, Cout), -128, dtype=torch.int8)
    b = torch.tensor([127, -128] * (Cout // 2) + [127], dtype=torch.int8)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    perm = tuple(int(s) for s in np.random.default_rng(40)
                 .permutation(shifts))
    for rounding in ROUNDINGS:
        for relu in (False, True):
            want = kc.conv2d_q7_per_channel_plain(
                x, w, b, tuple(shifts), perm, rounding=rounding)
            assert torch.equal(
                kc.conv2d_q7_per_channel(x, w, b, tuple(shifts), perm,
                                         rounding=rounding, relu=relu),
                q.relu_q7(want) if relu else want), (rounding, relu)
        for bias_shift in shifts:
            for out_shift in shifts:
                assert torch.equal(
                    kc.conv2d_q7(x, w, b, out_shift, bias_shift,
                                 rounding=rounding),
                    kc.conv2d_q7_plain(x, w, b, out_shift, bias_shift,
                                       rounding=rounding)), \
                    (rounding, out_shift, bias_shift)


@pytest.mark.gpu
def test_cuda_conv_entry_refuses_what_it_does_not_take(cuda):
    """The C entry checks what the wrapper hands it and launches nothing
    on a shift table of another length or a Cout over its tables."""
    rng = np.random.default_rng(11)
    x = i8(rng, (2, 9, 9, 16)).to(cuda)
    w = i8(rng, (3, 3, 16, 32)).to(cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kc.conv2d_q7_per_channel(x, w, None, (8,) * 31, (0,))
    wide = i8(rng, (1, 1, 16, 1025)).to(cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kc.conv2d_q7(x, wide, None, 8, 0)
    good = kc.conv2d_q7(x, w, None, 8, 0)             # the card is sound
    assert torch.equal(good, kc.conv2d_q7_plain(x, w, None, 8, 0))


@pytest.mark.gpu
def test_cuda_conv_over_48kb_on_every_card(cuda):
    """MNIST's primary caps (K 784, a 64 x 64 tile: 65,408 bytes of shared
    memory) on each card in turn, with card 0 current throughout: the
    opt-in above 48 KB holds per card, and the current card is put
    back.  One card runs it on itself alone."""
    H, W, Cin, k, stride, Cout = MNIST.conv_geometries[-1]
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        rng = np.random.default_rng(index)
        x = i8(rng, (256, H, W, Cin)).to(dev)
        w, b = i8(rng, (k, k, Cin, Cout)).to(dev), i8(rng, (Cout,)).to(dev)
        with torch.cuda.device(0):
            y = kc.conv2d_q7(x, w, b, 11, 2, stride=stride, relu=True)
            assert torch.cuda.current_device() == 0
        assert y.device == dev
        assert torch.equal(y, q.relu_q7(kc.conv2d_q7_plain(
            x, w, b, 11, 2, stride=stride)))


@pytest.mark.gpu
@pytest.mark.parametrize("mid,convs", [("mnist@cuda", 2),
                                       ("cifar10@cuda", 5)])
def test_cuda_backend_b256_forward_is_one_conv_launch_a_layer(cuda, mid,
                                                              convs):
    """A B 256 wave on the cuda backend equals the torch backend's bits,
    launches the conv kernel once a conv layer (the primary capsules'
    included) and runs no im2col kernel."""
    from torch.profiler import ProfilerActivity, profile
    spec = default_specs()[mid]
    qnet = ModelRegistry({spec.model_id: spec}, device=cuda) \
        .model(spec.model_id)
    x_q = qnet.quantize_input(torch.from_numpy(spec.images(256, seed=5))
                              .to(cuda))
    with torch.inference_mode():
        want = qnet.with_backend("torch").forward(x_q)
        qnet.forward(x_q)                               # warm
        n0 = (kc.conv2d_q7.launches, kc.conv2d_q7_per_channel.launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            v = qnet.forward(x_q)
            torch.cuda.synchronize()
    assert torch.equal(v, want)
    assert (kc.conv2d_q7.launches, kc.conv2d_q7_per_channel.launches) == \
        (n0[0] + convs, n0[1])
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert any("conv_q7" in n for n in names), names
    assert not any("im2col" in n for n in names), names


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
    the stream-K plan gemm_plan picks (K cut between 132 blocks), a
    split-K plan, one wgmma block per tile and the mma.sync loop all
    wrap, so all equal the plain version."""
    a, b = wrap_and_return(8, 265_296, 16, np.random.default_rng(11))
    ad, bd = a.to(cuda), b.to(cuda)
    sh = torch.arange(-8, 8, dtype=torch.int32)
    planned = kq.plan_for(ad, bd)
    assert planned.route == "wgmma" and planned.schedule == "stream-k" \
        and planned.ctas > 1
    for plan in (None, kq.GemmPlan("wgmma", (128, 128), 8),
                 kq.GemmPlan("wgmma", (128, 128), 1),
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
        n0 = kc.conv2d_q7.launches + kc.conv2d_q7_per_channel.launches
        probe = nh.NumericsProbe()
        with nh.probing(probe):
            probed = qnet.forward(x_q)
        n1 = kc.conv2d_q7.launches + kc.conv2d_q7_per_channel.launches
        oracle = nh.NumericsProbe()
        with nh.probing(oracle):
            qnet.with_backend("torch").forward(x_q)
    assert torch.equal(base, probed)
    # the convs stay on their kernel under a probe, which is handed the
    # oracle's accumulators: the torch backend's conv records, bit for bit
    assert n1 - n0 == 2
    assert [r for r in probe.rows() if r["op"] != "caps"] == \
        [r for r in oracle.rows() if r["op"] != "caps"]
    rows = probe.rows()
    assert {r["op"] for r in rows} == {"conv0", "pcap", "caps"}
    assert sum(r.get("int32_clip", 0) for r in rows) == 0
    # the squash and the routing loop run inside the kernels: the probe
    # sees conv0's and the primary caps' requants, u_hat's, and outputs
    assert sorted((r["op"], r["site"]) for r in rows
                  if r["family"] == "requant") == [
        ("caps", "requant[0]"), ("conv0", "requant[0]"),
        ("pcap", "requant[0]")]


# ---------------------------------------------------------------------------
# training (repro_torch.captrain) on the card
# ---------------------------------------------------------------------------
def _edge_tiny_trainer(cuda, **edit):
    from repro_torch.captrain import CapsTrainer, TrainConfig
    from repro_torch.nn import EDGE_TINY
    tc = TrainConfig(dataset="edge_tiny", batch=32, microbatches=8,
                     calib_n=32, lr=3e-3, recalib_every=20, **edit)
    return CapsTrainer(EDGE_TINY, tc, device=cuda)


def _state_leaves(state):
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _state_leaves(state[k])]
    return [state]


@pytest.mark.gpu
@pytest.mark.parametrize("qat", [False, True])
def test_cuda_train_step_repeats_its_bits_after_save_and_restore(
        cuda, qat, tmp_path):
    """A full-fp32, deterministic-cuDNN step on the card from a restored
    checkpoint equals the same step of the uninterrupted run, in loss and
    in every leaf of the state; the global flags are as before."""
    from repro_torch import ckpt
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    trainer = _edge_tiny_trainer(cuda)
    state, _, _ = trainer.fit(trainer.init_state(), 3)
    plan = trainer.derive_plan(state) if qat else None
    ckpt.save(tmp_path, 3, state)
    x, y = trainer.task.batch(3, 32)
    a, ma = trainer.train_step(state, x, y, plan)
    fresh = _edge_tiny_trainer(cuda)
    restored = ckpt.restore(tmp_path, 3, fresh.init_state())
    b, mb = fresh.train_step(restored, x, y, plan)
    assert float(ma["loss"]) == float(mb["loss"])
    for la, lb in zip(_state_leaves(a), _state_leaves(b)):
        assert torch.equal(la, lb)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == flags


@pytest.mark.gpu
def test_cuda_qat_model_serves_like_the_torch_backend(cuda):
    """A QAT-trained EDGE_TINY quantized on the card serves bit-identical
    on the `cuda` and `torch` backends, through both kernels."""
    from repro_torch.captrain import eval_q7
    from repro_torch.data.synthetic import make_image_dataset
    trainer = _edge_tiny_trainer(cuda)
    state, _, _ = trainer.fit(trainer.init_state(), 4)
    state, _, _ = trainer.fit(state, 2, qat=True)
    qnet = trainer.quantize(state, backend="cuda")
    images, labels = make_image_dataset("edge_tiny", 64, seed=3)
    xq = qnet.quantize_input(torch.from_numpy(images).to(cuda))
    n_sq, n_rt = ks.squash_q7.launches, kr.routing_q7.launches
    fallbacks = sum(get_backend("cuda").fallbacks.values())
    got = qnet.forward(xq)
    assert ks.squash_q7.launches > n_sq and kr.routing_q7.launches > n_rt
    assert sum(get_backend("cuda").fallbacks.values()) == fallbacks
    assert torch.equal(got, qnet.with_backend("torch").forward(xq))
    assert eval_q7(qnet, images, labels) == \
        eval_q7(qnet.with_backend("torch"), images, labels)


# ---------------------------------------------------------------------------
# the search (repro_torch.search) on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_search_candidates_equal_the_torch_backends(cuda):
    """The objective scores the default spec and an approx-softmax spec
    the same on the `cuda` backend (the space's own on the card) and on
    the `torch` backend over the same space; only the approx spec counts
    a fallback, and the default spec launches both kernels."""
    from repro_torch.search import (CandidateSpec, Objective, SearchConfig,
                                    SearchSpace, setup_space)

    class TorchOnCard(SearchSpace):
        backend = "torch"

    st = setup_space(SearchConfig(model="edge_tiny", float_steps=8,
                                  eval_n=64), device=cuda)
    assert st.space.backend == "cuda"
    twin = TorchOnCard(st.space.cfg, st.space.params, st.space.calib_images)
    fb = get_backend("cuda").fallbacks
    for spec in (CandidateSpec(), CandidateSpec(softmax="approx")):
        n = (ks.squash_q7.launches, kr.routing_q7.launches)
        f0 = dict(fb)
        got = Objective(st.space, st.images, st.labels).evaluate(spec)
        moved = dict(fb) != f0
        assert moved == bool(spec.softmax)
        if not spec.softmax:
            assert ks.squash_q7.launches > n[0]
            assert kr.routing_q7.launches > n[1]
        want = Objective(twin, st.images, st.labels).evaluate(spec)
        assert got.to_json() == want.to_json()


# ---------------------------------------------------------------------------
# the LM path: w8a8_dense and a reduced qwen3_14b
# ---------------------------------------------------------------------------
def dense_operands(rng, M, K, N):
    """xq [M, K], W stored K-major (wt [N, K]) and the exponents."""
    xq, wt = i8(rng, (M, K)), i8(rng, (N, K))
    xe = torch.tensor(float(rng.integers(-24, 25)))
    n = torch.from_numpy(rng.integers(-24, 25, (N,)).astype(np.int32))
    return xq, wt, xe, n


@pytest.mark.gpu
@pytest.mark.parametrize("mkn_offset", [
    (8, 5120, 1024, 0), (512, 512, 640, 0), (7, 100, 33, 0),
    (4, 2048, 8, 0), (130, 784, 300, 1), (1, 64, 3, 0)], ids=str)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=str)
def test_cuda_w8a8_dense_matches_plain_on_each_route(cuda, mkn_offset, out):
    """Bit for bit on the route gemm_plan names (A `offset` bytes past a
    16-byte boundary takes mma.sync), one launch counted per call, no
    transpose of W."""
    from repro_torch.kernels import w8a8_dense as kd
    M, K, N, offset = mkn_offset
    rng = np.random.default_rng(M + K + N + offset)
    xq, wt, xe, n = dense_operands(rng, M, K, N)
    buf = torch.zeros(M * K + 16, dtype=torch.int8, device=cuda)
    xd = buf[offset:offset + M * K].view(M, K)
    xd.copy_(xq)
    plan = kq.plan_for(xd, wt.to(cuda), b_kmajor=True)
    before = dict(kd.w8a8_dense.launches_by_route)
    t0 = kq.transpose_kn.launches
    got = ops.w8a8_dense(xd, wt.to(cuda), xe.to(cuda), n.to(cuda), out)
    before[plan.route] += 1
    assert kd.w8a8_dense.launches_by_route == before
    assert kq.transpose_kn.launches == t0
    assert got.dtype == out
    assert torch.equal(got.cpu(), kd.w8a8_dense_plain(xq, wt, xe, n, out))


@pytest.mark.gpu
@pytest.mark.parametrize("tile_split", [(128, 1), (256, 1), (128, 3),
                                        (256, 2), (128, 8)], ids=str)
def test_cuda_w8a8_dense_every_tile_and_split(cuda, tile_split):
    from repro_torch.kernels import w8a8_dense as kd
    tile_n, split = tile_split
    plan = kq.GemmPlan("wgmma", (128, tile_n), split)
    rng = np.random.default_rng(tile_n * split)
    for M, K, N in ((8, 2048, 8), (200, 784, 300), (129, 1040, 257)):
        xq, wt, xe, n = dense_operands(rng, M, K, N)
        for out in (torch.bfloat16, torch.float32):
            got, used = kd._launch(xq.to(cuda), wt.to(cuda), xe.to(cuda),
                                   n.to(cuda), out, plan)
            assert used == plan
            assert torch.equal(got.cpu(),
                               kd.w8a8_dense_plain(xq, wt, xe, n, out))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 16, 64, 65, 512])
def test_cuda_w8a8_faces_across_the_small_m_switch_on_both_routes(cuda, M):
    """Both faces on K-major W at M on both sides of the stream-K switch,
    on the route gemm_plan picks and on mma.sync (forced), bit for bit;
    no call launches transpose_kn."""
    from repro_torch.kernels import w8a8_dense as kd
    rng = np.random.default_rng(M)
    mma = kq.GemmPlan("mma.sync", (128, 128), 1)
    t0 = kq.transpose_kn.launches
    for K, N in ((2048, 640), (1040, 257)):
        xq, wt, xe, n = dense_operands(rng, M, K, N)
        args = [t.to(cuda) for t in (xq, wt, xe, n)]
        plan = kq.plan_for(args[0], args[1], b_kmajor=True)
        assert plan.route == "wgmma"
        assert plan.schedule == ("stream-k" if M <= 64 else "tiles")
        want = kd.w8a8_dense_plain(xq, wt, xe, n)
        assert torch.equal(ops.w8a8_dense(*args).cpu(), want)
        assert torch.equal(kd._launch(*args, torch.bfloat16, mma)[0].cpu(),
                           want)
        E = 3
        xq, wt, xe, n = bmm_operands(rng, E, M, K, N)
        args = [t.to(cuda) for t in (xq, wt, xe, n)]
        want = kd.w8a8_dense_plain(xq, wt, xe, n)
        assert torch.equal(ops.w8a8_bmm(*args).cpu(), want)
        assert torch.equal(kd._launch(*args, torch.bfloat16, mma)[0].cpu(),
                           want)
    assert kq.transpose_kn.launches == t0


@pytest.mark.gpu
@pytest.mark.parametrize("ctas", [1, 2, 7, 50, 132])
def test_cuda_stream_k_any_block_count_matches_plain(cuda, ctas):
    """The stream-K schedule on any number of blocks (every tile whole,
    tiles cut between two blocks, tiles cut between many, shares across
    tile and batch boundaries) gives the plain version's bits, in all
    four libraries that share it."""
    from repro_torch.kernels import w8a8_dense as kd
    rng = np.random.default_rng(ctas)
    for E, M, K, N in ((1, 8, 2048, 300), (3, 64, 1040, 257),
                       (2, 1, 4096, 8)):
        iters = kq.streamk_iterations(M, K, N, E)
        plan = kq.GemmPlan("wgmma", kq.SK_TILE, 1, "stream-k",
                           min(ctas, iters))
        xq, wt, xe, n = bmm_operands(rng, E, M, K, N)
        for out in (torch.bfloat16, torch.float32):
            got, used = kd._launch(xq.to(cuda), wt.to(cuda), xe.to(cuda),
                                   n.to(cuda), out, plan)
            assert used == plan
            assert torch.equal(got.cpu(),
                               kd.w8a8_dense_plain(xq, wt, xe, n, out))
        a, b = xq[0], wt[0].t().contiguous()
        sh = torch.from_numpy(rng.integers(-40, 41, (N,)).astype(np.int32))
        plan = plan._replace(ctas=min(ctas, kq.streamk_iterations(M, K, N,
                                                                  1)))
        got, _ = kq._launch(a.to(cuda), b.to(cuda), 11, "nearest", plan)
        assert torch.equal(got.cpu(), kq.matmul_q7_plain(a, b, 11,
                                                         "nearest"))
        got, _ = kw._launch(a.to(cuda), b.to(cuda), sh.to(cuda), "floor",
                            plan)
        assert torch.equal(got.cpu(), kw.w8a8_matmul_plain(a, b, sh,
                                                           "floor"))


def lm_setup(quant: str):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced
    from repro_torch.models.transformer import build_model
    from repro_torch.quant.lm_quant import quantize_lm_params
    cfg = reduced(get_config("qwen3_14b"), d_model=64)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    if quant == "w8a8":
        params = quantize_lm_params(params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 20)).astype(np.int32))
    return cfg, model, params, toks


def on(tree, device):
    if isinstance(tree, dict):
        return {k: on(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(on(v, device) for v in tree)
    return tree.to(device)


@pytest.fixture
def f32_sums():
    """bf16 products rounded once from float32 sums, as the `LM` entry
    points run them (the blocks below are called directly)."""
    from repro_torch.models.layers import full_bf16_sums
    with full_bf16_sums():
        yield


@pytest.mark.gpu
def test_cuda_reduced_qwen3_float_prefill_decode_matches_the_cpu(cuda,
                                                                 f32_sums):
    """The port on the card against the port on the CPU: logits of
    magnitude ~4 within the CPU tests' 0.1 (cuBLAS and the CPU sum bf16
    products in other orders)."""
    cfg, model, params, toks = lm_setup("none")
    pc = on(params, cuda)
    lc, cc = model.prefill(params, {"inputs": toks[:, :16]}, alloc=512)
    lg, cg = model.prefill(pc, {"inputs": toks[:, :16].to(cuda)}, alloc=512)
    diffs = [float((lc.float() - lg.float().cpu()).abs().max())]
    for i in range(4):
        t = toks[:, 16 + i:17 + i]
        lc, cc = model.decode_step(params, cc, t, 16 + i)
        lg, cg = model.decode_step(pc, cg, t.to(cuda), 16 + i)
        diffs.append(float((lc.float() - lg.float().cpu()).abs().max()))
    assert max(diffs) <= 0.1, diffs


@pytest.mark.gpu
def test_cuda_reduced_qwen3_w8a8_blocks_match_the_cpu(cuda, f32_sums):
    """W8A8 layer by layer (the card's block on the CPU's block input,
    each with its own caches; a whole chain of per-tensor int8
    activations amplifies one-ulp float differences): every block output
    and the logits within 0.1, and every dense product on w8a8_dense."""
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.models import layers, transformer as tt
    cfg, model, params, toks = lm_setup("w8a8")
    pc = on(params, cuda)
    cache_c = model.init_cache(2, 512, "cpu")
    cache_g = model.init_cache(2, 512, cuda)
    n0 = kd.w8a8_dense.launches
    diffs = []

    def run(x, mode, pos):
        for ci in range(cfg.num_cycles):
            for i, kind in enumerate(cfg.blocks):
                y, _, _ = tt.block_apply(
                    cfg, kind, tt._cycle(params["blocks"][i], ci), x,
                    mode=mode, cache=cache_c[ci][i], pos=pos, prefix_len=0)
                yg, _, _ = tt.block_apply(
                    cfg, kind, tt._cycle(pc["blocks"][i], ci), x.to(cuda),
                    mode=mode, cache=cache_g[ci][i], pos=pos, prefix_len=0)
                diffs.append(float((y.float() - yg.float().cpu()).abs()
                                   .max()))
                x = y
        h = layers.rms_norm(x[:, -1:], params["final_norm"]["scale"])
        diffs.append(float((layers.lm_logits(params["lm_head"], h).float()
                            - layers.lm_logits(pc["lm_head"], h.to(cuda))
                            .float().cpu()).abs().max()))

    run(layers.embed_lookup(params["embed"], toks[:, :16]), "prefill", None)
    for i in range(4):
        run(layers.embed_lookup(params["embed"], toks[:, 16 + i:17 + i]),
            "decode", 16 + i)
    assert max(diffs) <= 0.1, diffs
    assert kd.w8a8_dense.launches - n0 == 5 * (7 * cfg.num_layers + 1)


@pytest.mark.gpu
def test_cuda_meta_counted_w8a8_dense_calls_equal_the_cards_launches(cuda):
    """The dry run's count of `w8a8_dense` calls in a reduced W8A8 decode
    step (`dist.op_analysis` on meta tensors, trip-weighted over the
    cycles) equals the launches the same step makes on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import analyze_step
    from repro_torch.launch.train import reduced
    from repro_torch.models.transformer import build_model
    from repro_torch.quant.lm_quant import quantize_lm_params
    cfg = reduced(get_config("qwen3_14b"), d_model=64, layers=6)
    model = build_model(cfg)
    params = on(quantize_lm_params(
        model.init(torch.Generator().manual_seed(0), "cpu")), cuda)
    toks = torch.ones((2, 1), dtype=torch.int32)
    _, cost = analyze_step(cfg, ShapeSpec("d", "decode", 20, 2), quant=True)
    cache = model.init_cache(2, 512, cuda)
    n0 = kd.w8a8_dense.launches
    steps.make_decode_step(cfg)(params, cache, toks.to(cuda), 19)
    torch.cuda.synchronize()
    assert cost.ops["w8a8_dense"] == kd.w8a8_dense.launches - n0 \
        == 7 * cfg.num_layers + 1


# ---------------------------------------------------------------------------
# the MoE path: w8a8_bmm (the batched face of w8a8_dense) and a reduced
# phi35_moe
# ---------------------------------------------------------------------------
def bmm_operands(rng, E, M, K, N):
    """Operands of E expert products, W stored K-major (wt [E, N, K]),
    each expert its own exponents."""
    xq, wt = i8(rng, (E, M, K)), i8(rng, (E, N, K))
    xe = torch.tensor(float(rng.integers(-24, 25)))
    n = torch.from_numpy(rng.integers(-24, 25, (E, N)).astype(np.int32))
    return xq, wt, xe, n


@pytest.mark.gpu
@pytest.mark.parametrize("emkn", [
    (16, 4, 512, 640), (16, 96, 512, 640), (8, 160, 1024, 256),
    (3, 7, 100, 33), (2, 4, 2048, 8), (5, 1, 64, 3)], ids=str)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=str)
def test_cuda_w8a8_bmm_matches_plain_on_each_route(cuda, emkn, out):
    """Decode- and prefill-like expert products (wgmma), a ragged one
    (mma.sync) and a split-K one, bit for bit, one launch counted a
    call; an epilogue that read expert 0's exponents for every expert
    would differ (checked)."""
    from repro_torch.kernels import w8a8_dense as kd
    rng = np.random.default_rng(sum(emkn))
    xq, wt, xe, n = bmm_operands(rng, *emkn)
    args = [t.to(cuda) for t in (xq, wt, xe, n)]
    plan = kq.plan_for(args[0], args[1], b_kmajor=True)
    before = dict(kd.w8a8_bmm.launches_by_route)
    t0 = kq.transpose_kn.launches
    got = ops.w8a8_bmm(*args, out)
    before[plan.route] += 1
    assert kd.w8a8_bmm.launches_by_route == before
    assert kq.transpose_kn.launches == t0
    want = kd.w8a8_dense_plain(xq, wt, xe, n, out)
    assert got.dtype == out and torch.equal(got.cpu(), want)
    if emkn[0] > 1:
        assert not torch.equal(want, kd.w8a8_dense_plain(
            xq, wt, xe, n[:1].expand_as(n), out))


@pytest.mark.gpu
@pytest.mark.parametrize("tile_split", [(128, 1), (256, 1), (128, 3),
                                        (256, 2), (128, 8)], ids=str)
def test_cuda_w8a8_bmm_every_tile_and_split(cuda, tile_split):
    """Each expert's exponents reach the epilogue of the product (split
    1) and of the split-K reduction (its own z) on every tile."""
    from repro_torch.kernels import w8a8_dense as kd
    tile_n, split = tile_split
    plan = kq.GemmPlan("wgmma", (128, tile_n), split)
    rng = np.random.default_rng(tile_n + split)
    for E, M, K, N in ((4, 8, 2048, 8), (3, 200, 784, 300),
                       (2, 129, 1040, 257)):
        xq, wt, xe, n = bmm_operands(rng, E, M, K, N)
        got, used = kd._launch(xq.to(cuda), wt.to(cuda), xe.to(cuda),
                               n.to(cuda), torch.bfloat16, plan)
        assert used == plan
        assert torch.equal(got.cpu(), kd.w8a8_dense_plain(xq, wt, xe, n))


@pytest.mark.gpu
def test_cuda_reduced_phi35_moe_w8a8_decode_matches_the_cpu(cuda,
                                                            f32_sums):
    """A reduced phi35_moe in W8A8, prefill and one decode step layer by
    layer (the card's block on the CPU's block input, each with its own
    caches): every block output and the logits within 0.1, as the
    qwen3_14b case, with every expert product on w8a8_bmm and every
    dense one on w8a8_dense."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.launch.train import reduced
    from repro_torch.models import layers, transformer as tt
    from repro_torch.quant.lm_quant import quantize_lm_params
    cfg = reduced(get_config("phi35_moe"), d_model=64)
    model = tt.build_model(cfg)
    params = quantize_lm_params(model.init(torch.Generator().manual_seed(0),
                                           "cpu"))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 17)).astype(np.int32))
    pc = on(params, cuda)
    cache_c = model.init_cache(2, 512, "cpu")
    cache_g = model.init_cache(2, 512, cuda)
    n_bmm, n_dense = kd.w8a8_bmm.launches, kd.w8a8_dense.launches
    diffs = []

    def run(x, mode, pos):
        for ci in range(cfg.num_cycles):
            for i, kind in enumerate(cfg.blocks):
                y, _, _ = tt.block_apply(
                    cfg, kind, tt._cycle(params["blocks"][i], ci), x,
                    mode=mode, cache=cache_c[ci][i], pos=pos, prefix_len=0)
                yg, _, _ = tt.block_apply(
                    cfg, kind, tt._cycle(pc["blocks"][i], ci), x.to(cuda),
                    mode=mode, cache=cache_g[ci][i], pos=pos, prefix_len=0)
                diffs.append(float((y.float() - yg.float().cpu()).abs()
                                   .max()))
                x = y
        h = layers.rms_norm(x[:, -1:], params["final_norm"]["scale"])
        diffs.append(float((layers.lm_logits(params["lm_head"], h).float()
                            - layers.lm_logits(pc["lm_head"], h.to(cuda))
                            .float().cpu()).abs().max()))

    run(layers.embed_lookup(params["embed"], toks[:, :16]), "prefill", None)
    run(layers.embed_lookup(params["embed"], toks[:, 16:]), "decode", 16)
    assert max(diffs) <= 0.1, diffs
    assert kd.w8a8_bmm.launches - n_bmm == 2 * 3 * cfg.num_layers
    assert kd.w8a8_dense.launches - n_dense == 2 * (4 * cfg.num_layers + 1)


# ---------------------------------------------------------------------------
# the SSM, hybrid and encoder-decoder LMs: mamba, mLSTM, sLSTM, EncDecLM
# ---------------------------------------------------------------------------
SSM_DENSE_KN = [(2048, 8192), (4096, 4096), (2816, 2048), (4096, 16384),
                (8192, 4096), (1024, 256256)]


@pytest.mark.gpu
@pytest.mark.parametrize("kn", SSM_DENSE_KN, ids=str)
def test_cuda_w8a8_dense_at_the_ssm_and_encdec_products(cuda, kn):
    """Products of xlstm_1_3b (up_proj, wq, ffn_down), jamba_v01_52b
    (in_proj, out_proj) and seamless_m4t_medium (its 256,256-wide
    lm_head) at a decode step's M = 8, bit for bit."""
    from repro_torch.kernels import w8a8_dense as kd
    K, N = kn
    xq, wt, xe, n = dense_operands(np.random.default_rng(K + N), 8, K, N)
    got = ops.w8a8_dense(xq.to(cuda), wt.to(cuda), xe.to(cuda), n.to(cuda))
    assert torch.equal(got.cpu(), kd.w8a8_dense_plain(xq, wt, xe, n))


def mixer_case(name):
    """A reduced config, the mixer's params (CPU, seed 0) and its module."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced
    from repro_torch.models import mamba, xlstm
    arch = "jamba_v01_52b" if name == "mamba" else "xlstm_1_3b"
    cfg = reduced(get_config(arch), d_model=64)
    init, apply, cache = {
        "mamba": (mamba.init_mamba, mamba.mamba_apply,
                  mamba.init_mamba_cache),
        "mlstm": (xlstm.init_mlstm, xlstm.mlstm_apply,
                  xlstm.init_mlstm_cache),
        "slstm": (xlstm.init_slstm, xlstm.slstm_apply,
                  xlstm.init_slstm_cache)}[name]
    return cfg, init(torch.Generator().manual_seed(0), cfg, "cpu"), apply, \
        cache


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_cuda_recurrent_mixer_matches_the_cpu(cuda, f32_sums, name):
    """Prefill of 16 positions, then 4 decode steps, on the card and on
    the CPU: outputs and float32 states within atol 0.05 + rtol 0.05
    (cuBLAS and the CPU sum the bf16 products in other orders, so a bf16
    activation may round one ulp apart), the states written in place in
    the card's cache buffers."""
    cfg, p, apply, init_cache = mixer_case(name)
    pc = on(p, cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 20, cfg.d_model)).astype(np.float32)).bfloat16()
    cc = init_cache(cfg, 2, device="cpu")
    cg = on(cc, cuda)
    ptrs = {k: v.data_ptr() for k, v in cg.items()}
    yc, _ = apply(p, x[:, :16], cfg, mode="prefill", cache=cc)
    yg, _ = apply(pc, x[:, :16].to(cuda), cfg, mode="prefill", cache=cg)
    outs = [(yc, yg)]
    for t in range(16, 20):
        yc, _ = apply(p, x[:, t:t + 1], cfg, mode="decode", cache=cc)
        yg, _ = apply(pc, x[:, t:t + 1].to(cuda), cfg, mode="decode",
                      cache=cg)
        outs.append((yc, yg))
    for a, b in outs + [(cc[k], cg[k]) for k in cc]:
        torch.testing.assert_close(b.float().cpu(), a.float(), atol=0.05,
                                   rtol=0.05)
    assert {k: v.data_ptr() for k, v in cg.items()} == ptrs


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dense,bmm", [
    ("xlstm_1_3b", 39, 0), ("jamba_v01_52b", 31, 12)])
def test_cuda_reduced_ssm_w8a8_blocks_match_the_cpu(cuda, f32_sums, arch,
                                                    dense, bmm):
    """A reduced xlstm_1_3b (7 mLSTM + 1 sLSTM) and jamba_v01_52b (one
    cycle) in W8A8, prefill and one decode step layer by layer (the
    card's block on the CPU's block input, each with its own caches):
    every block output and the logits within 0.1, as the qwen3_14b case,
    every dense product on w8a8_dense and every expert product on
    w8a8_bmm (`dense` and `bmm` a forward pass)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.launch.train import reduced
    from repro_torch.models import layers, transformer as tt
    from repro_torch.quant.lm_quant import quantize_lm_params
    cfg = reduced(get_config(arch), d_model=64)
    model = tt.build_model(cfg)
    params = quantize_lm_params(model.init(torch.Generator().manual_seed(0),
                                           "cpu"))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 17)).astype(np.int32))
    pc = on(params, cuda)
    cache_c = model.init_cache(2, 512, "cpu")
    cache_g = model.init_cache(2, 512, cuda)
    n_bmm, n_dense = kd.w8a8_bmm.launches, kd.w8a8_dense.launches
    diffs = []

    def run(x, mode, pos):
        for ci in range(cfg.num_cycles):
            for i, kind in enumerate(cfg.blocks):
                y, _, _ = tt.block_apply(
                    cfg, kind, tt._cycle(params["blocks"][i], ci), x,
                    mode=mode, cache=cache_c[ci][i], pos=pos, prefix_len=0)
                yg, _, _ = tt.block_apply(
                    cfg, kind, tt._cycle(pc["blocks"][i], ci), x.to(cuda),
                    mode=mode, cache=cache_g[ci][i], pos=pos, prefix_len=0)
                diffs.append(float((y.float() - yg.float().cpu()).abs()
                                   .max()))
                x = y
        h = layers.rms_norm(x[:, -1:], params["final_norm"]["scale"])
        diffs.append(float((layers.lm_logits(params["lm_head"], h).float()
                            - layers.lm_logits(pc["lm_head"], h.to(cuda))
                            .float().cpu()).abs().max()))

    run(layers.embed_lookup(params["embed"], toks[:, :16]), "prefill", None)
    run(layers.embed_lookup(params["embed"], toks[:, 16:]), "decode", 16)
    assert max(diffs) <= 0.1, diffs
    assert kd.w8a8_dense.launches - n_dense == 2 * dense
    assert kd.w8a8_bmm.launches - n_bmm == 2 * bmm


@pytest.mark.gpu
def test_cuda_reduced_seamless_w8a8_blocks_match_the_cpu(cuda, f32_sums):
    """A reduced seamless_m4t_medium (2 encoder and 2 decoder layers) in
    W8A8: each encoder block, then each decoder block at prefill and at
    one decode step, on the CPU's block input, within 0.1; the encoder's
    and decoder's products on w8a8_dense, 37 at the prefill and 19 at the
    decode step (the cross K/V cached)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import w8a8_dense as kd
    from repro_torch.launch.train import reduced
    from repro_torch.models import layers, transformer as tt
    from repro_torch.quant.lm_quant import quantize_lm_params
    cfg = reduced(get_config("seamless_m4t_medium"), d_model=64)
    model = tt.build_model(cfg)
    params = quantize_lm_params(model.init(torch.Generator().manual_seed(0),
                                           "cpu"))
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.normal(0, 1, (2, 12, 64)).astype(
        np.float32)).bfloat16()
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 17)).astype(
        np.int32))
    pc = on(params, cuda)
    cache_c = model.init_cache(2, 512, 12, "cpu")
    cache_g = model.init_cache(2, 512, 12, cuda)
    n0 = kd.w8a8_dense.launches
    diffs = []
    x = layers.dense(frames, params["frontend"]["w"])
    for ci in range(cfg.num_encoder_layers):
        y, _, _ = tt.block_apply(
            cfg, tt.ENC_BLOCK[0], tt._cycle(params["enc_blocks"][0], ci), x,
            mode="train", cache=None, pos=None, prefix_len=2 ** 30)
        yg, _, _ = tt.block_apply(
            cfg, tt.ENC_BLOCK[0], tt._cycle(pc["enc_blocks"][0], ci),
            x.to(cuda), mode="train", cache=None, pos=None,
            prefix_len=2 ** 30)
        diffs.append(float((y.float() - yg.float().cpu()).abs().max()))
        x = y
    enc = layers.rms_norm(x, params["enc_norm"]["scale"])

    def run(x, enc, mode, pos):
        for ci in range(cfg.num_cycles):
            y = tt.dec_block(cfg, tt._cycle(params["dec_blocks"][0], ci), x,
                             enc, mode=mode, pos=pos,
                             cache=tt._cycle(cache_c[0], ci))
            yg = tt.dec_block(cfg, tt._cycle(pc["dec_blocks"][0], ci),
                              x.to(cuda), None if enc is None
                              else enc.to(cuda), mode=mode, pos=pos,
                              cache=tt._cycle(cache_g[0], ci))
            diffs.append(float((y.float() - yg.float().cpu()).abs().max()))
            x = y
        h = layers.rms_norm(x[:, -1:], params["final_norm"]["scale"])
        diffs.append(float((layers.lm_logits(params["lm_head"], h).float()
                            - layers.lm_logits(pc["lm_head"], h.to(cuda))
                            .float().cpu()).abs().max()))

    run(layers.embed_lookup(params["embed"], toks[:, :16]), enc, "prefill",
        None)
    run(layers.embed_lookup(params["embed"], toks[:, 16:]), None, "decode",
        16)
    assert max(diffs) <= 0.1, diffs
    assert kd.w8a8_dense.launches - n0 == 37 + 19


# ---------------------------------------------------------------------------
# LM training (launch.steps, launch.train): no kernel of the port runs on it
# ---------------------------------------------------------------------------
def train_cfg(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced
    return reduced(get_config(arch), d_model=64)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_3b", "phi35_moe", "jamba_v01_52b",
                                  "seamless_m4t_medium"])
def test_cuda_train_step_in_place_matches_functional_and_cpu(cuda, arch):
    """One `make_train_step` step on the card: the in-place update equals
    the functional `AdamW.update` on the same gradients bit for bit, and
    the loss and grad norm lie within 1e-2 / 5e-2 of the port's CPU step
    on the same weights and batch."""
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_batch
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adam import global_norm
    from repro_torch.tree import leaves, tree_map, unflatten
    cfg = train_cfg(arch)
    task = TokenTask(cfg.vocab_size, 32, seed=7)
    state = steps.init_train_state(cfg, torch.Generator(cuda).manual_seed(0),
                                   cuda)
    ref = tree_map(lambda t: t.clone(), state)
    cpu_params = tree_map(lambda t: t.cpu(), state["params"])
    batch = make_batch(cfg, task, 0, 2, cuda)
    opt = steps.make_optimizer()
    _, _, grads = steps.loss_and_grads(build_model(cfg), ref["params"], batch)
    p, o, _ = opt.update(unflatten(ref["params"], grads), ref["opt"],
                         ref["params"])
    state, m = steps.make_train_step(cfg, opt)(state, batch)
    for x, y in zip(leaves({"params": p, "opt": o}),
                    leaves({"params": state["params"], "opt": state["opt"]})):
        assert torch.equal(x, y)
    loss, _, g_cpu = steps.loss_and_grads(
        build_model(cfg), cpu_params, make_batch(cfg, task, 0, 2, "cpu"))
    assert abs(float(m["loss"]) - float(loss)) <= 1e-2 * float(loss)
    gn = float(global_norm(g_cpu))
    assert abs(float(m["grad_norm"]) - gn) <= 5e-2 * gn


@pytest.mark.gpu
def test_cuda_train_cli_resumes_bit_for_bit(cuda, tmp_path, monkeypatch):
    """`launch.train.main` on the card at d 64 under deterministic
    algorithms: a fault before step 3, the restart resumes from the
    step-2 checkpoint, and the final state equals a straight run's."""
    import functools
    from repro_torch.dist import fault
    from repro_torch.launch import train
    from repro_torch.tree import leaves
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(train, "run_with_restarts", functools.partial(
        fault.run_with_restarts, backoff_s=0))
    argv = ["--reduce", "--d-model", "64", "--steps", "4", "--batch", "2",
            "--seq", "32", "--ckpt-every", "2", "--arch", "paligemma_3b"]
    real, armed = train.make_batch, [True]

    def make_batch(cfg, task, i, batch, device):
        if armed[0] and i == 3:
            armed[0] = False
            raise RuntimeError("injected fault before step 3")
        return real(cfg, task, i, batch, device)
    torch.use_deterministic_algorithms(True)
    try:
        with monkeypatch.context() as mp:
            mp.setattr(train, "make_batch", make_batch)
            a = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
        b = train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    finally:
        torch.use_deterministic_algorithms(False)
    assert a["attempts"] == 2 and b["attempts"] == 1
    for x, y in zip(leaves(a["state"]), leaves(b["state"])):
        assert x.is_cuda and torch.equal(x, y)
