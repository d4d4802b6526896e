"""The torch integer oracle (repro_torch.quant.int8_ops) against the
reference's jnp oracle (repro.quant.int8_ops), on the same inputs.

Every op is held BIT-EXACT, including the edge semantics the CUDA
kernels copy: shift amounts over the static checker's domain [-31, 31]
(and beyond), int32 wrap-around, floor division, both roundings, the
integer square root over every value a squash can reach, and the
reference's kernel shape corpus.  The one exception is
`softmax_q7_precise`, which goes through a float32 `exp`: it is held to
a mismatch budget of at most 1 LSB.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import int8_ops as R
from repro_torch.quant import int8_ops as T

ROUNDINGS = ("floor", "nearest")
# the reference's kernel shape corpus (tests/test_kernels.py)
SQUASH_SHAPES = [(100, 4), (1024, 6), (3, 8), (64, 16), (2, 7, 11, 4)]


def i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def i32(rng, shape):
    x = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
    edges = np.array([-2 ** 31, -2 ** 31 + 1, -(1 << 20), -129, -128, -1, 0,
                      1, 127, 128, 1 << 20, 2 ** 31 - 2, 2 ** 31 - 1])
    x.reshape(-1)[:edges.size] = edges
    return x.astype(np.int32)


def same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_rshift_sat8_every_shift(rounding):
    acc = i32(np.random.default_rng(0), (64, 33))
    for shift in range(-31, 32):
        same(T.rshift_sat8(torch.from_numpy(acc), shift, rounding),
             R.rshift_sat8(jnp.asarray(acc), shift, rounding))
    # beyond the checker's domain: XLA's shift rules (floor; nearest's
    # half-LSB no longer fits int32 there)
    for shift in (32, 33, 40, -32, -40):
        if rounding == "floor" or shift < 0:
            same(T.rshift_sat8(torch.from_numpy(acc), shift, rounding),
                 R.rshift_sat8(jnp.asarray(acc), shift, rounding))


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_rshift_sat8_vec_per_lane_shifts(rounding):
    rng = np.random.default_rng(1)
    acc = i32(rng, (5, 7, 63))
    shifts = np.arange(-31, 32, dtype=np.int32)
    same(T.rshift_sat8_vec(torch.from_numpy(acc), torch.from_numpy(shifts),
                           rounding),
         R.rshift_sat8_vec(jnp.asarray(acc), jnp.asarray(shifts), rounding))
    sh = rng.integers(-31, 32, (7, 1)).astype(np.int32)
    same(T.rshift_sat8_vec(torch.from_numpy(acc), tuple(sh.ravel()[:, None]
                                                        .tolist()), rounding),
         R.rshift_sat8_vec(jnp.asarray(acc), sh, rounding))


def test_sat8_relu_add_q7():
    rng = np.random.default_rng(2)
    x = i32(rng, (300,))
    same(T.sat8(torch.from_numpy(x)), R.sat8(jnp.asarray(x)))
    a, b = i8(rng, (257,)), i8(rng, (257,))
    same(T.relu_q7(torch.from_numpy(a)), R.relu_q7(jnp.asarray(a)))
    for sa in range(-8, 9, 2):
        for sb in range(-8, 9, 3):
            same(T.add_q7(torch.from_numpy(a), torch.from_numpy(b), sa, sb),
                 R.add_q7(jnp.asarray(a), jnp.asarray(b), sa, sb))


def test_int32_arithmetic_wraps_like_xla():
    a = np.array([2 ** 31 - 1, -2 ** 31, 123456789], np.int32)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    same(ta * 7 + 1, ja * 7 + 1)
    # an int32 einsum whose sum leaves int32 wraps the same way, as long
    # as the exact sum stays below 2^53 (float64's exact integers)
    b = np.full((1000,), 50_000, np.int32)
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    same(T.einsum_i32("i,i->", tb, tb), jnp.einsum("i,i->", jb, jb))


CONV_CASES = [  # (B, H, W, Cin, K, Cout, stride)
    (2, 9, 9, 1, 3, 4, 1), (1, 12, 10, 3, 5, 8, 2), (3, 8, 8, 16, 7, 2, 1),
    (2, 11, 11, 4, 3, 6, 2), (1, 28, 28, 1, 7, 16, 1),
]


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_conv2d_q7(case, rounding):
    B, H, W, Cin, K, Cout, stride = case
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    x, w, b = i8(rng, (B, H, W, Cin)), i8(rng, (K, K, Cin, Cout)), \
        i8(rng, (Cout,))
    for out_shift, bias_shift in ((9, -11), (3, 2), (0, 0), (-2, 5),
                                  (14, -3)):
        same(T.conv2d_q7(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), out_shift, bias_shift,
                         stride=stride, rounding=rounding),
             R.conv2d_q7(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         out_shift, bias_shift, stride=stride,
                         rounding=rounding))


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_conv2d_q7_per_channel(rounding):
    rng = np.random.default_rng(3)
    x, w, b = i8(rng, (2, 10, 10, 3)), i8(rng, (3, 3, 3, 6)), i8(rng, (6,))
    out_s = rng.integers(-3, 15, 6).astype(np.int32)
    bias_s = rng.integers(-12, 6, 6).astype(np.int32)
    same(T.conv2d_q7_per_channel(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        tuple(out_s.tolist()), tuple(bias_s.tolist()), stride=2,
        rounding=rounding),
        R.conv2d_q7_per_channel(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), jnp.asarray(out_s),
                                jnp.asarray(bias_s), stride=2,
                                rounding=rounding))


def test_isqrt_newton_exhaustive_over_squash_range():
    """Every Q = sum(s^2) a D <= 16 int8 capsule can produce."""
    n = np.arange(0, 16 * 128 * 128 + 1, dtype=np.int32)
    got = T.isqrt_newton(torch.from_numpy(n))
    same(got, R.isqrt_newton(jnp.asarray(n)))
    np.testing.assert_array_equal(
        got.numpy(), np.floor(np.sqrt(n.astype(np.float64))).astype(np.int32))
    big = np.array([2 ** 31 - 1, (1 << 30) + 12345, 1 << 24, 999_999_999],
                   np.int32)
    same(T.isqrt_newton(torch.from_numpy(big)),
         R.isqrt_newton(jnp.asarray(big)))


@pytest.mark.parametrize("shape", SQUASH_SHAPES)
def test_squash_q7_both_variants(shape):
    rng = np.random.default_rng(sum(shape))
    s = i8(rng, shape)
    ts, js = torch.from_numpy(s), jnp.asarray(s)
    for in_frac, out_frac in ((0, 7), (3, 7), (5, 7), (7, 7), (9, 7),
                              (12, 7), (5, 5), (5, 9), (24, 7)):
        same(T.squash_q7(ts, in_frac, out_frac),
             R.squash_q7(js, in_frac, out_frac))
        same(T.squash_q7_approx(ts, in_frac, out_frac),
             R.squash_q7_approx(js, in_frac, out_frac))


def test_squash_divisions_have_nonnegative_numerator_and_positive_divisor():
    """Floor (jnp `//`) and C's truncating `/` agree only there: every
    squash numerator S << (o - i + P) is >= 0 and every divisor >= 1,
    over all Q an int8 capsule can produce and the formats plans use."""
    Q = torch.arange(0, 16 * 128 * 128 + 1, dtype=torch.int32)
    S = T.isqrt_newton(Q)
    for in_frac in range(0, 25):
        for out_frac in (5, 6, 7, 8, 9):
            shift = out_frac - in_frac + T.SQUASH_GUARD_BITS
            num = S << shift if shift >= 0 else S >> -shift
            den = (1 << in_frac) + (Q >> in_frac)
            if shift <= 21:                # S < 2^10: no int32 wrap
                assert int(num.min()) >= 0
            assert int(den.min()) >= 1


@pytest.mark.parametrize("variant", ["q7", "approx"])
def test_softmax_q7_integer_variants(variant):
    rng = np.random.default_rng(5)
    x = i8(rng, (6, 37, 10))
    x[0, 0] = 0                                  # all-tied row
    x[0, 1] = np.arange(-128, 127, 26)[:10]
    t_fn, r_fn = (T.softmax_q7, R.softmax_q7) if variant == "q7" \
        else (T.softmax_q7_approx, R.softmax_q7_approx)
    for in_frac in range(-3, 10):
        same(t_fn(torch.from_numpy(x), in_frac),
             r_fn(jnp.asarray(x), in_frac))


def test_softmax_divisions_have_nonnegative_numerator_and_positive_divisor():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(i8(rng, (50, 16, 10)).astype(np.int32))
    for in_frac in range(0, 8):
        p = T._pow2_probs(x, in_frac)
        tot = p.sum(-1, dtype=torch.int32)
        assert int((p << 7).min()) >= 0 and int(tot.min()) >= 1
        assert int((p << 7).max()) <= 1 << 27


def test_ceil_log2_int():
    rng = np.random.default_rng(7)
    t = np.concatenate([rng.integers(1, 2 ** 31 - 1, 500),
                        [1, 2, 3, 4, 5, 1 << 20, (1 << 20) + 1,
                         (1 << 30) - 1, 1 << 30, 2 ** 31 - 1]]).astype(np.int32)
    got = T.ceil_log2_int(torch.from_numpy(t))
    same(got, R.ceil_log2_int(jnp.asarray(t)))
    np.testing.assert_array_equal(
        got.numpy(), np.ceil(np.log2(t.astype(np.float64))).astype(np.int32))


def test_softmax_q7_precise_within_one_lsb():
    """fp32 `exp` differs between torch and XLA in the last bit, which
    can move round(p * 128) across a half: the budget is max |diff| <= 1
    LSB, and at most 1% of the outputs may differ at all."""
    rng = np.random.default_rng(8)
    x = i8(rng, (40, 64, 10))
    for in_frac in (0, 3, 5, 7):
        got = T.softmax_q7_precise(torch.from_numpy(x), in_frac).numpy()
        want = np.asarray(R.softmax_q7_precise(jnp.asarray(x), in_frac))
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).mean() <= 0.01


def test_einsum_i32_matches_jnp_int32_einsum():
    rng = np.random.default_rng(9)
    W, u = i8(rng, (10, 64, 6, 4)), i8(rng, (3, 64, 4))
    same(T.einsum_i32("jiod,bid->bjio", torch.from_numpy(W),
                      torch.from_numpy(u)),
         jnp.einsum("jiod,bid->bjio", jnp.asarray(W, jnp.int32),
                    jnp.asarray(u, jnp.int32)))
