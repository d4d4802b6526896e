"""`repro_torch.optim.grad_compress` against `repro.optim.grad_compress`
on the CPU: the int8 wire format bit for bit, the error-feedback
transform, the one-worker `compressed_psum`, and the reference's own
convergence tests ported.

The port reads the exponent off the float32 quotient's exponent bits and
scales by exact powers of two.  The reference takes floor(jnp.log2(.))
and scales by jnp.exp2, which XLA's CPU backend does not compute exactly
at integer |x| >= 13 (off by up to ~2e-6 relative) and whose log2 floors
2^13 and 2^15 to one less.  So: where the exponent lies in [-12, 12]
every int8 value, exponent and dequantized value is equal bit for bit;
at exponents of 13 and more the reference's scaled values are off by
its exp2's error, which moves a value that lies within that of a
rounding boundary to the next integer (counted and bounded here); with
the reference's exp2 made exact everything is equal except at the
quotients 2^13 and 2^15 (counted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.optim import grad_compress as R
from repro_torch.optim import SGDM
from repro_torch.optim import grad_compress as T


def exact_exp2(x):
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def both(g):
    """(reference (q, e), port (q, e)) of a NumPy float32 tensor."""
    rq, re_ = R.compress(jnp.asarray(g))
    tq, te = T.compress(torch.from_numpy(g))
    return (np.asarray(rq), float(re_)), (tq.numpy(), float(te))


def sample(mag: float, seed: int, n: int = 4096) -> np.ndarray:
    return (np.random.default_rng(seed).normal(0, 1, n) * mag).astype(
        np.float32)


@pytest.mark.parametrize("mag", [2.0 ** k for k in range(-4, 12, 3)]
                         + [0.37, 3.1, 77.0, 900.0])
def test_compress_bit_equal_where_the_exponent_is_small(mag):
    g = sample(mag, int(mag * 1000) % 97)
    (rq, re_), (tq, te) = both(g)
    assert abs(te) <= 12
    assert te == re_ and np.array_equal(rq, tq) and tq.dtype == np.int8
    np.testing.assert_array_equal(
        np.asarray(R.decompress(jnp.asarray(rq), re_)),
        T.decompress(torch.from_numpy(tq), torch.tensor(te)).numpy())
    assert np.abs(tq).max() >= 64      # the scale uses the int8 range


@pytest.mark.parametrize("mag", [1e-3, 3e-4, 2e-5, 1e-6])
def test_compress_at_large_exponents_counts_exp2_flips(mag):
    """Exponents 13 to 24: the same exponent; the int8 values differ only
    where the reference's inexact exp2 moved g * 2^e across a rounding
    boundary, by one, on at most 1 in 500 elements; with its exp2 made
    exact they are equal."""
    g = sample(mag, 5, n=1 << 15)
    (rq, re_), (tq, te) = both(g)
    assert te == re_ and 13 <= te <= 24
    diff = np.abs(rq.astype(np.int32) - tq.astype(np.int32))
    assert diff.max() <= 1 and diff.sum() <= g.size // 500
    scaled = g.astype(np.float64) * 2.0 ** te
    near = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) < 1e-4 * \
        np.abs(scaled).max()
    assert not (diff.astype(bool) & ~near).any()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R.jnp, "exp2", exact_exp2)
        (rq, _), _ = both(g)
    assert np.array_equal(rq, tq)


@pytest.mark.parametrize("k", list(range(-24, 25)))
def test_exponent_at_exact_powers_of_two(k):
    """max |g| = 127 * 2^-k: the quotient 127 / max is exactly 2^k, whose
    floor(log2) is k.  The port gives k (clipped to [-24, 24]); so does
    the reference but at 2^13 and 2^15, where its log2 gives k - 1."""
    g = np.full(64, 0.3 * 127.0 * 2.0 ** -k, np.float32)
    g[7] = -127.0 * 2.0 ** -k
    (rq, re_), (tq, te) = both(g)
    assert te == k and int(tq[7]) == -127
    if k in (13, 15):
        assert re_ == k - 1
    else:
        assert re_ == k
        if abs(k) <= 12:
            assert np.array_equal(rq, tq)


def test_exponent_clips_and_zero():
    for v, want in ((0.0, 24.0), (1e-30, 24.0), (1e30, -24.0),
                    (3.0e38, -24.0)):
        g = np.array([v, -v / 2], np.float32)
        (rq, re_), (tq, te) = both(g)
        assert te == re_ == want and np.array_equal(rq, tq)


def test_compress_roundtrip_small_error():
    g = torch.from_numpy(sample(3.0, 0, 128))
    q, e = T.compress(g)
    assert q.dtype == torch.int8
    err = (T.decompress(q, e) - g).abs().max()
    assert float(err) <= 0.5 * 2.0 ** -float(e) + 1e-7


@pytest.mark.parametrize("mag", [0.05, 4.0, 1e-4])
def test_ef_apply_matches_the_reference_and_apply_in_place(mag):
    """Three EF steps over a tree of leaves: dequantized gradients and
    error buffers equal the reference's (its exp2 made exact) bit for
    bit, and `apply_` in place equals `apply`."""
    rng = np.random.default_rng(int(mag * 1e4))
    shapes = {"a": (33, 7), "b": {"c": (129,), "d": (4, 4, 4)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.normal(0, 1, s) * mag).astype(np.float32)
    steps = [draw(shapes) for _ in range(3)]
    rc, tc = R.EFCompressor(), T.EFCompressor()
    r_err = rc.init(jax.tree.map(jnp.asarray, steps[0]))
    t_err = tc.init(jax.tree.map(torch.from_numpy, steps[0]))
    from repro_torch.tree import leaves
    flat_err = [e.clone() for e in leaves(t_err)]
    for g in steps:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(R.jnp, "exp2", exact_exp2)
            r_deq, r_err = rc.apply(jax.tree.map(jnp.asarray, g), r_err)
        tg = jax.tree.map(torch.from_numpy, g)
        t_deq, t_err = tc.apply(tg, t_err)
        flat = leaves(tg)
        tc.apply_(flat, flat_err)
        for w, x, y in zip(jax.tree_util.tree_leaves(r_deq), leaves(t_deq),
                           flat):
            assert np.array_equal(np.asarray(w), x.numpy())
            assert torch.equal(x, y)
        for w, x, y in zip(jax.tree_util.tree_leaves(r_err), leaves(t_err),
                           flat_err):
            assert np.array_equal(np.asarray(w), x.numpy())
            assert torch.equal(x, y)


def psum_inputs(n: int) -> list:
    """Per-rank inputs whose exponents differ across the ranks, for a
    world of n: one rank at zero in the third; in the fourth the
    exponents -24 and 24, so a payload shifts right by 48 (past 31: its
    sign is left)."""
    return [[sample(0.7 * 4.0 ** r, 11 + r, 300) for r in range(n)],
            [sample(3e-3 * 9.0 ** (n - r), 29 + r, 64) for r in range(n)],
            [np.zeros(64, np.float32) if r == n - 1 else
             sample(50.0 / (r + 1), 41 + r, 64) for r in range(n)],
            [sample(2e9 if r == 0 else 1e-7, 53 + r, 64)
             for r in range(n)]]


@pytest.fixture(scope="module")
def psum_worlds():
    """compressed_psum on every rank of gloo worlds of 2 and 4 processes,
    the rank functions in `torch_multicard_ranks` (no JAX)."""
    import torch_multicard_ranks as ranks
    from repro_torch.dist import world as dworld
    return {n: dworld.spawn(ranks.psum_checks, n, backend="gloo",
                            device="cpu", timeout_s=60, deadline_s=180,
                            args=(psum_inputs(n),))
            for n in (2, 4)}


def reference_psum(xs) -> np.ndarray:
    """The reference's collective over an axis of len(xs) workers (its
    exp2 made exact): every worker's row."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R.jnp, "exp2", exact_exp2)
        return np.asarray(jax.vmap(lambda v: R.compressed_psum(v, "w"),
                                   axis_name="w")(jnp.asarray(np.stack(xs))))


def test_compressed_psum_one_worker_and_more(psum_worlds):
    """With no process group the sum over the one worker is
    decompress(compress(x)), equal to the reference's collective over an
    axis of one (its exp2 made exact); over a world of two workers it is
    the reference's collective over two; a mesh that splits the model
    axis sums over its BATCH line."""
    x = sample(0.7, 11, 300)
    want = reference_psum([x])[0]
    got = T.compressed_psum(torch.from_numpy(x))
    assert np.array_equal(want, got.numpy())
    xs = psum_inputs(2)[0]
    want = reference_psum(xs)
    for g in psum_worlds[2]:
        assert np.array_equal(want[g["rank"]], g["world"][0].numpy())
    from repro_torch.dist.api import Mesh
    one = Mesh(("data", "model"), (1, 1), ["cpu"])
    assert torch.equal(T.compressed_psum(torch.from_numpy(x), one), got)
    # a mesh that splits the model axis sums over its BATCH line alone,
    # here of one worker: the one-worker result
    tp = Mesh(("data", "model"), (1, 2), ["cpu"] * 2)
    assert torch.equal(T.compressed_psum(torch.from_numpy(x), tp), got)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_over_ranks_equals_the_references_vmap(n,
                                                               psum_worlds):
    """compressed_psum over gloo worlds of 2 and 4 ranks, on the default
    group and on a data-parallel mesh's BATCH group, equals the
    reference's `vmap(axis_name=)` collective on the stacked inputs, bit
    for bit on every rank: the exponents' minimum, the int32 sum of the
    aligned payloads (shifts past 31 included), one power-of-two scale."""
    got = psum_worlds[n]
    assert [g["rank"] for g in got] == list(range(n))
    for i, xs in enumerate(psum_inputs(n)):
        want = reference_psum(xs)
        assert np.all(want == want[0])
        for g in got:
            for key in ("world", "mesh"):
                y = g[key][i]
                assert y.dtype == torch.float32
                assert np.array_equal(want[g["rank"]], y.numpy()), (i, key)


def test_ef_training_converges_like_uncompressed():
    """The reference's test, ported: least squares with SGD-momentum;
    int8 + EF reaches (near) the loss of uncompressed gradients."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(0, 1, (64, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))

    def loss(w):
        return torch.mean((A @ w - y) ** 2)

    opt = SGDM(lr=2e-2, momentum=0.9)

    def train(compressed: bool, steps=300):
        w = torch.zeros(16)
        state = opt.init({"w": w})
        comp = T.EFCompressor()
        err = comp.init({"w": w})
        for _ in range(steps):
            wv = w.clone().requires_grad_()
            g, = torch.autograd.grad(loss(wv), wv)
            g = {"w": g}
            if compressed:
                g, err = comp.apply(g, err)
            p, state, _ = opt.update(g, state, {"w": w})
            w = p["w"]
        return float(loss(w))

    l_plain = train(False)
    l_comp = train(True)
    assert l_comp <= l_plain * 1.05 + 1e-4, (l_plain, l_comp)


def test_ef_error_buffer_carries_residual():
    """The reference's test, ported: gradients below one quantum
    accumulate in the buffer and flush through."""
    comp = T.EFCompressor()
    g = {"g": torch.tensor([1e-8, 2e-8])}
    err = comp.init(g)
    out, err = comp.apply(g, err)
    assert not out["g"].any()           # below one quantum: all held back
    flushed = torch.zeros(2)
    for _ in range(100):
        out, err = comp.apply(g, err)
        flushed += out["g"]
    assert float(err["g"].abs().max()) < 1.0
    # what went through plus what is held is what came in
    torch.testing.assert_close(flushed + err["g"], 101 * g["g"],
                               rtol=1e-5, atol=0)
