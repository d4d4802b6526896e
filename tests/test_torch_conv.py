"""The int8 conv kernel's wrapper (`repro_torch.kernels.conv`) on the CPU.

A CPU tensor takes the plain versions (`int8_ops.conv2d_q7` /
`conv2d_q7_per_channel`, then `relu_q7`); the CUDA kernel itself runs in
tests/test_torch_gpu.py.  Here: the wrapper's faces and refusals, the
backends' fused relu, what the `cuda` backend hands a numerics probe,
the tile `conv_plan` picks, and a numpy mirror of `csrc/conv_q7.cu`'s
arithmetic (its patch-offset tables, the zero-padded K, its shared
memory and its epilogue with q7.cuh's shift semantics) held against the
oracle at every out and bias shift in [-8, 40].
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import conv as kc
from repro_torch.nn.backend import CudaBackend, TorchBackend
from repro_torch.nn.config import CAPSNET_CONFIGS, CIFAR10, MNIST, SMALLNORB
from repro_torch.obs import numerics
from repro_torch.quant import int8_ops as q

ROUNDINGS = ("floor", "nearest")
H100_SMS = 132
# (H, W, Cin, k, stride, Cout) at small size: the paper's kernel and
# channel shapes on smaller images, a ragged Cout and a Cout over 64
SMALL_GEOMS = [(12, 12, 1, 7, 1, 16), (11, 11, 16, 7, 2, 64),
               (9, 9, 3, 3, 1, 32), (9, 9, 32, 3, 2, 64), (8, 8, 2, 7, 1, 32),
               (7, 9, 4, 3, 2, 49), (6, 6, 8, 3, 1, 80), (5, 5, 5, 5, 1, 3)]


def i8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))


def operands(geom, B, seed):
    H, W, Cin, k, s, Cout = geom
    rng = np.random.default_rng(seed)
    return i8(rng, (B, H, W, Cin)), i8(rng, (k, k, Cin, Cout)), \
        i8(rng, (Cout,)), rng


# ---------------------------------------------------------------------------
# a numpy mirror of csrc/conv_q7.cu
# ---------------------------------------------------------------------------
def wrap32(v):
    return (np.asarray(v, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def shl(a, s):
    """q7::shl: 0 for amounts outside [0, 31], else the wrapped shift."""
    a, s = np.asarray(a, np.int64), np.asarray(s, np.int64)
    return np.where((s < 0) | (s >= 32), 0, wrap32(a << np.clip(s, 0, 31)))


def sar(a, s):
    """q7::sar: the sign fill for amounts outside [0, 31]."""
    a, s = np.asarray(a, np.int64), np.asarray(s, np.int64)
    return np.where((s < 0) | (s >= 32), np.where(a < 0, -1, 0),
                    a >> np.clip(s, 0, 31))


def rshift_sat8(acc, s, nearest):
    """q7::rshift_sat8, elementwise over broadcast shifts."""
    s = np.asarray(s, np.int64)
    v = np.asarray(acc, np.int64)
    if nearest:
        v = np.where(s > 0, wrap32(v + shl(1, s - 1)), v)
    v = np.where(s > 0, sar(v, s), np.where(s < 0, shl(v, -s), v))
    return np.clip(v, -128, 127)


def patch_tables(H, W, Cin, k, stride, B):
    """The kernel's two tables: each padded k's offset inside a receptive
    field (-1 past K) and each output pixel's first byte."""
    K = k * k * Cin
    K_pad = -(-K // 32) * 32
    kk = np.arange(K_pad)
    koff = np.where(kk < K, (kk // (k * Cin)) * W * Cin + kk % (k * Cin), -1)
    OH, OW = (H - k) // stride + 1, (W - k) // stride + 1
    m = np.arange(B * OH * OW)
    b, p = np.divmod(m, OH * OW)
    oh, ow = np.divmod(p, OW)
    rowbase = ((b * H + oh * stride) * W + ow * stride) * Cin
    return koff, rowbase, (OH, OW)


def kernel_smem(bm, bn, K):
    """A block's dynamic shared memory: the weight slab [BN][K_pad + 16],
    the patch rows [BM][128 + 16] and the int32 tables (k offsets, row
    bases, the epilogue's biases and shifts)."""
    k_pad = -(-K // 32) * 32
    return bn * (k_pad + 16) + bm * (128 + 16) + 4 * (k_pad + bm + 2 * bn)


KERNEL_MAX_SMEM = 232_448              # a block's shared memory on sm_90


def kernel_mirror(x, w, bias, out_shifts, bias_shifts, stride, nearest,
                  relu):
    B, H, W, Cin = x.shape
    k, _, _, Cout = w.shape
    koff, rowbase, (OH, OW) = patch_tables(H, W, Cin, k, stride, B)
    xf = x.numpy().reshape(-1).astype(np.int64)
    patches = np.where(koff >= 0,
                       xf[rowbase[:, None] + np.maximum(koff, 0)[None]], 0)
    wpad = np.zeros((len(koff), Cout), np.int64)
    wpad[:k * k * Cin] = w.numpy().reshape(-1, Cout)
    acc = wrap32(patches @ wpad)

    def table(s):
        return np.clip(np.broadcast_to(np.asarray(s, np.int64), (Cout,)),
                       -kc.SHIFT_CLAMP, kc.SHIFT_CLAMP)
    os_, bs = table(out_shifts), table(bias_shifts)
    bt = 0 if bias is None else np.where(
        bs >= 0, shl(bias.numpy(), bs), sar(bias.numpy(), -bs))
    v = rshift_sat8(wrap32(acc + bt), os_, nearest)
    if relu:
        v = np.maximum(v, 0)
    return torch.from_numpy(v.reshape(B, OH, OW, Cout).astype(np.int8))


@pytest.mark.parametrize("geom", SMALL_GEOMS, ids=str)
def test_mirror_of_the_kernel_equals_the_oracle(geom):
    x, w, b, rng = operands(geom, 3, sum(geom))
    for rounding in ROUNDINGS:
        out_shift, bias_shift = int(rng.integers(2, 12)), \
            int(rng.integers(-2, 6))
        assert torch.equal(
            kernel_mirror(x, w, b, out_shift, bias_shift, geom[4],
                          rounding == "nearest", False),
            q.conv2d_q7(x, w, b, out_shift, bias_shift, stride=geom[4],
                        rounding=rounding))


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_mirror_every_shift_both_faces_and_the_int32_wrap(rounding):
    """Every out and bias shift in [-8, 40], on each face, with a bias
    and an accumulator at the int8 extremes, so that the shifted bias
    wraps the int32 accumulator: one epilogue serves both faces."""
    shifts = np.arange(-8, 41)
    Cout = len(shifts)
    x = torch.full((2, 5, 5, 128), -128, dtype=torch.int8)
    x[1] = 127
    w = torch.full((3, 3, 128, Cout), -128, dtype=torch.int8)
    b = torch.tensor([127, -128] * (Cout // 2) + [127], dtype=torch.int8)
    nearest = rounding == "nearest"
    perm = np.random.default_rng(4).permutation(shifts)
    assert torch.equal(
        kernel_mirror(x, w, b, shifts, perm, 1, nearest, False),
        q.conv2d_q7_per_channel(x, w, b, tuple(shifts.tolist()),
                                tuple(perm.tolist()), rounding=rounding))
    for bias_shift in (-8, 0, 7, 24, 31, 40):
        for out_shift in shifts.tolist():
            assert torch.equal(
                kernel_mirror(x, w, b, out_shift, bias_shift, 1, nearest,
                              False),
                q.conv2d_q7(x, w, b, out_shift, bias_shift,
                            rounding=rounding)), (out_shift, bias_shift)
    acc = q._conv_acc(x, w, 1, "VALID").to(torch.int64)  # both adds wrap
    assert int(acc.max()) + (127 << 24) > 2 ** 31 - 1
    assert int(acc.min()) - (128 << 24) < -2 ** 31


@pytest.mark.parametrize("Cin", [1, 2, 3, 4, 8, 16, 32, 64])
def test_patch_offsets_are_contiguous_where_the_kernel_loads_words(Cin):
    """A 16-byte load at k % 16 == 0 needs Cin % 16 == 0, a 4-byte load at
    k % 4 == 0 Cin % 4 == 0: there the offsets of the word's k run
    consecutively, and a word past K is padding throughout."""
    koff, _, _ = patch_tables(13, 11, Cin, 3, 2, 1)
    for vec in (16, 4):
        if Cin % vec:
            continue
        for k0 in range(0, len(koff), vec):
            run = koff[k0:k0 + vec]
            assert (run < 0).all() or (run == run[0] + np.arange(vec)).all()


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("geom", SMALL_GEOMS, ids=str)
def test_wrapper_on_cpu_equals_the_plain_versions(geom, rounding, relu):
    x, w, b, rng = operands(geom, 2, 7)
    stride, Cout = geom[4], geom[5]
    want = q.conv2d_q7(x, w, b, 9, 2, stride=stride, rounding=rounding)
    assert torch.equal(kc.conv2d_q7(x, w, b, 9, 2, stride=stride,
                                    rounding=rounding, relu=relu),
                       q.relu_q7(want) if relu else want)
    os_ = tuple(int(s) for s in rng.integers(-3, 14, Cout))
    bs = tuple(int(s) for s in rng.integers(-3, 6, Cout))
    want = q.conv2d_q7_per_channel(x, w, b, os_, bs, stride=stride,
                                   rounding=rounding)
    assert torch.equal(
        kc.conv2d_q7_per_channel(x, w, b, os_, bs, stride=stride,
                                 rounding=rounding, relu=relu),
        q.relu_q7(want) if relu else want)


def test_wrapper_without_bias_and_counts_no_cpu_launch():
    x, w, _, _ = operands((9, 9, 3, 3, 1, 32), 2, 1)
    n = (kc.conv2d_q7.launches, kc.conv2d_q7_per_channel.launches)
    assert torch.equal(kc.conv2d_q7(x, w, None, 8, 0),
                       q.conv2d_q7(x, w, None, 8, 0))
    assert torch.equal(kc.conv2d_q7_per_channel(x, w, None, (8,) * 32,
                                                (0,) * 32),
                       q.conv2d_q7_per_channel(x, w, None, (8,) * 32,
                                               (0,) * 32))
    assert (kc.conv2d_q7.launches, kc.conv2d_q7_per_channel.launches) == n


@pytest.mark.parametrize("face", ["scalar", "per_channel"])
def test_wrapper_refuses_what_the_kernel_does_not_take(face):
    x, w, b, _ = operands((9, 9, 3, 3, 1, 32), 1, 2)

    def call(x, w, b, **kw):
        if face == "scalar":
            return kc.conv2d_q7(x, w, b, 8, 0, **kw)
        return kc.conv2d_q7_per_channel(x, w, b, (8,) * 32, (0,) * 32, **kw)
    for args in ((x.to(torch.int32), w, b), (x, w.float(), b),
                 (x, w, b.to(torch.int16))):
        with pytest.raises(TypeError, match="int8"):
            call(*args)
    with pytest.raises(NotImplementedError, match="VALID"):
        call(x, w, b, padding="SAME")
    with pytest.raises(ValueError, match="Cin"):
        call(x, w[:, :, :2], b)
    with pytest.raises(ValueError, match="bias"):
        call(x, w, b[:7])
    with pytest.raises(NotImplementedError, match="meta"):
        call(x.to("meta"), w.to("meta"), b.to("meta"))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_torch_backend_fuses_the_relu_on_both_faces(rounding, relu):
    x, w, b, rng = operands((11, 11, 16, 7, 2, 64), 2, 3)
    be = TorchBackend()
    y = be.conv2d_q7(x, w, b, 10, 3, stride=2, rounding=rounding, relu=relu)
    want = q.conv2d_q7(x, w, b, 10, 3, stride=2, rounding=rounding)
    assert torch.equal(y, q.relu_q7(want) if relu else want)
    os_ = tuple(int(s) for s in rng.integers(6, 14, 64))
    bs = tuple(int(s) for s in rng.integers(0, 6, 64))
    y = be.conv2d_q7_per_channel(x, w, b, os_, bs, stride=2,
                                 rounding=rounding, relu=relu)
    want = q.conv2d_q7_per_channel(x, w, b, os_, bs, stride=2,
                                   rounding=rounding)
    assert torch.equal(y, q.relu_q7(want) if relu else want)


# ---------------------------------------------------------------------------
# the tile conv_plan picks
# ---------------------------------------------------------------------------
def test_conv_geometries_follow_the_paper():
    assert MNIST.conv_geometries == ((28, 28, 1, 7, 1, 16),
                                     (22, 22, 16, 7, 2, 64))
    assert CIFAR10.conv_geometries == (
        (32, 32, 3, 3, 1, 32), (30, 30, 32, 3, 1, 32), (28, 28, 32, 3, 2, 64),
        (13, 13, 64, 3, 2, 64), (6, 6, 64, 3, 2, 64))
    assert SMALLNORB.conv_geometries[-1] == (26, 26, 32, 7, 2, 64)


@pytest.mark.parametrize("B", [1, 4, 37, 256])
@pytest.mark.parametrize("name", sorted(CAPSNET_CONFIGS))
def test_conv_plan_fills_the_card_and_fits_a_block(name, B):
    for H, W, Cin, k, s, Cout in CAPSNET_CONFIGS[name].conv_geometries:
        M = B * ((H - k) // s + 1) * ((W - k) // s + 1)
        p = kc.conv_plan(M, Cout, H100_SMS)
        assert kc.tile_fits(p.bm, p.bn) and p.bn >= min(Cout, 64)
        assert kernel_smem(p.bm, p.bn, k * k * Cin) <= KERNEL_MAX_SMEM
        fits = [bm for bm in kc.BLOCK_ROWS if kc.tile_fits(bm, p.bn)]
        # the largest tile whose grid gives every SM a block, else the least
        assert p.blocks >= H100_SMS or p.bm == fits[-1]
        larger = [bm for bm in fits if bm > p.bm]
        assert all(-(-M // bm) < H100_SMS for bm in larger)


def test_conv_plan_at_the_cells_b256_waves():
    """MNIST's primary caps (16,384 pixels) take 64-row tiles, CIFAR-10's
    (1,024) the 16-row tile; the large early convs 128 rows."""
    got = {}
    for cfg in (MNIST, CIFAR10):
        for H, W, Cin, k, s, Cout in cfg.conv_geometries:
            M = 256 * ((H - k) // s + 1) * ((W - k) // s + 1)
            got[(cfg.name, H, Cin)] = kc.conv_plan(M, Cout, H100_SMS)[:2]
    assert got == {("capsnet_mnist", 28, 1): (128, 16),
                   ("capsnet_mnist", 22, 16): (64, 64),
                   ("capsnet_cifar10", 32, 3): (128, 32),
                   ("capsnet_cifar10", 30, 32): (128, 32),
                   ("capsnet_cifar10", 28, 32): (128, 64),
                   ("capsnet_cifar10", 13, 64): (64, 64),
                   ("capsnet_cifar10", 6, 64): (16, 64)}


def test_conv_plan_refuses_no_tile_of_four_warps():
    assert not kc.tile_fits(16, 16)
    assert all(kc.tile_fits(bm, bn) for bm in kc.BLOCK_ROWS
               for bn in kc.BLOCK_COLS if (bm, bn) != (16, 16))
    assert kc.conv_plan(16, 8, H100_SMS)[:2] == (32, 16)


def test_launch_args_are_packed_once_a_geometry(monkeypatch):
    """The C entry's ints: the geometry, the flags, the tile and the shift
    tables clamped to [-64, 64]; worked out once a geometry and table,
    and a geometry with no output refused before any launch (a table of
    the wrong length the C entry refuses, tests/test_torch_gpu.py)."""
    monkeypatch.setattr(kc, "_sm_count", lambda index: H100_SMS)
    kc._launch_args.cache_clear()
    try:
        xs, ws = torch.Size((256, 22, 22, 16)), torch.Size((7, 7, 16, 64))
        shape, args, plan = kc._launch_args(xs, ws, 2, 0, (9,), (70,), True,
                                            False)
        assert shape == (256, 8, 8, 64)
        assert plan == kc.conv_plan(256 * 64, 64, H100_SMS)
        assert list(args) == [256, 22, 22, 16, 7, 7, 64, 2, 1, 0, plan.bm,
                              plan.bn, 1, 1, 9, 64]
        assert kc._launch_args(xs, ws, 2, 0, (9,), (70,), True, False)[1] \
            is args
        table = tuple(range(-70, 58, 2))
        _, args, _ = kc._launch_args(xs, ws, 2, 0, table, (0,), False, True)
        assert list(args)[12:14] == [64, 1]
        assert list(args)[14:78] == [max(-64, s) for s in table]
        with pytest.raises(ValueError, match="stride"):
            kc._launch_args(torch.Size((1, 5, 5, 16)), ws, 2, 0, (9,), (0,),
                            False, False)
    finally:
        kc._launch_args.cache_clear()


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_cuda_backend_hands_a_probe_the_oracles_accumulators(monkeypatch,
                                                             rounding):
    """Under a numerics probe the `cuda` backend's convs keep their kernel
    for the output and hand the probe the oracle's accumulator, the
    shifted bias added, as the `torch` backend's requantization does: the
    same records and the same bits on both faces.  (The CPU stands in for
    the card: the wrapper runs its plain version there with the probe
    taken away, as a kernel's interior is out of a probe's sight.)"""
    monkeypatch.setattr(CudaBackend, "_require_cuda", lambda *a: None)
    for face in ("conv2d_q7", "conv2d_q7_per_channel"):
        def unseen(*a, _f=getattr(kc, face), **k):
            prev = numerics.set_probe(None)
            try:
                return _f(*a, **k)
            finally:
                numerics.set_probe(prev)
        monkeypatch.setattr(kc, face, unseen)
    x, w, b, rng = operands((11, 11, 16, 7, 2, 64), 2, 8)
    os_ = tuple(int(s) for s in rng.integers(6, 14, 64))
    bs = tuple(int(s) for s in rng.integers(-2, 6, 64))
    seen = {}
    for be in (TorchBackend(), CudaBackend()):
        probe = numerics.NumericsProbe()
        with numerics.probing(probe), numerics.scope("conv0"):
            y = (be.conv2d_q7(x, w, b, 10, 3, stride=2, rounding=rounding,
                              relu=True),
                 be.conv2d_q7_per_channel(x, w, b, os_, bs, stride=2,
                                          rounding=rounding))
        seen[be.name] = y, probe._recs
    (yt, rt), (yc, rc) = seen["torch"], seen["cuda"]
    assert all(torch.equal(a, c) for a, c in zip(yt, yc))
    assert len(rt) == 2 and rt == rc


def test_cuda_backend_without_a_probe_computes_no_accumulator(monkeypatch):
    """Probes off, the `cuda` backend's conv is the wrapper alone: the
    oracle's accumulator is never built."""
    monkeypatch.setattr(CudaBackend, "_require_cuda", lambda *a: None)
    x, w, b, _ = operands((9, 9, 3, 3, 1, 32), 1, 9)

    def refuse(*a, **k):
        raise AssertionError("accumulator built with no probe")
    monkeypatch.setattr(q, "conv_acc_q7", refuse)
    monkeypatch.setattr(q, "conv_acc_q7_per_channel", refuse)
    calls = []
    monkeypatch.setattr(kc, "conv2d_q7", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(kc, "conv2d_q7_per_channel",
                        lambda *a, **k: calls.append(2))
    be = CudaBackend()
    be.conv2d_q7(x, w, b, 8, 0, stride=1, rounding="floor")
    be.conv2d_q7_per_channel(x, w, b, (8,) * 32, (0,) * 32, stride=1,
                             rounding="floor")
    assert calls == [1, 2]
