"""`repro_torch.quant.lm_quant` and `kernels.w8a8_dense`'s plain version
against `repro.quant.lm_quant` on the CPU.

`quantize_lm_params` gives the reference's int8 weights and exponents
bit for bit.  Every scale in the port is an exact power of two, while
the reference scales by `jnp.exp2`, which XLA's CPU backend does not
compute exactly at integer arguments of magnitude 13 or more (x = 13,
15, 17, ... off by up to ~2e-6 relative; checked here).  So where a
weight or activation exponent lies in [-12, 12] the quantized values are
equal bit for bit, and `q_dense`'s bf16 output may differ by one bf16
ulp exactly where |xe + n| >= 13 (a float32 output by exp2's own 4e-6):
the tests count those elements, bound them, and require equality
everywhere else.  XLA's CPU log2 is likewise off at 2^13 and 2^15, where
the reference's exponent is one less than the port's.  With the
reference's exp2 replaced by an exact power of two, the outputs are
equal bit for bit.

The port stores a W8A8 leaf K-major, {"qt": [..., N, K], "n"}, where the
reference keeps {"q": [..., K, N], "n"}: qt is q transposed bit for bit
(stacked leaves included), `convert.lm_params_{from,to}_reference`
carry a W8A8 tree across both ways bit for bit, and a leaf of the
reference's layout in the port raises.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.base import get_config as rget
from repro.launch.train import reduced
from repro.models.transformer import build_model as rbuild
from repro.quant import lm_quant as R
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference
from repro_torch.kernels import ops
from repro_torch.kernels import w8a8_dense as kd
from repro_torch.quant import lm_quant as T

ARCHS = ["stablelm_3b", "qwen3_14b", "qwen2_72b", "gemma3_12b",
         "paligemma_3b"]


def exact_exp2(x):
    """2^x for integer-valued float x, exactly (from the exponent bits)."""
    e = jnp.asarray(x).astype(jnp.int32)
    return lax.bitcast_convert_type((e + 127) << 23, jnp.float32)


def bf16(a):
    r = jnp.asarray(a, jnp.bfloat16)
    return r, torch.from_numpy(np.array(r.astype(jnp.float32))).bfloat16()


def same(a, b) -> bool:
    return np.array_equal(np.asarray(a), b.numpy())


def qt_as_q(w: dict):
    """The port's K-major qt [..., N, K] as the reference's q [..., K, N]."""
    return w["qt"].swapaxes(-1, -2)


def w8a8_leaves(tree, path=()):
    """(path, leaf) of every W8A8 leaf dict of a port or reference tree."""
    if isinstance(tree, dict) and set(tree) in ({"q", "n"}, {"qt", "n"}):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in w8a8_leaves(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in w8a8_leaves(v, path + (i,))]
    return []


@pytest.fixture(scope="module")
def ref_params():
    """The reference's own init of each reduced architecture."""
    return {arch: rbuild(reduced(rget(arch), d_model=64)).init(
        jax.random.key(1)) for arch in ARCHS}


def test_xla_cpu_exp2_is_inexact_where_the_tests_say():
    xs = np.arange(-30, 31).astype(np.float32)
    got = np.asarray(jnp.exp2(jnp.asarray(xs)))
    off = xs[got != 2.0 ** xs]
    assert off.size and np.abs(off).min() >= 13
    assert np.all(np.abs(got / 2.0 ** xs - 1) < 4e-6)
    assert np.array_equal(np.asarray(exact_exp2(xs)), 2.0 ** xs)
    e = torch.arange(-126, 128)
    assert torch.equal(kd.pow2(e), torch.tensor(2.0, dtype=torch.float64)
                       .pow(e.double()).float())


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_lm_params_bit_equal(arch, ref_params):
    """The port's W8A8 tree, in the reference's layout
    (`lm_params_to_reference`), equals the reference's leaf for leaf."""
    rp = ref_params[arch]
    want = R.quantize_lm_params(rp)
    got = T.quantize_lm_params(lm_params_from_reference(
        jax.tree.map(np.asarray, rp), "cpu"))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        lm_params_to_reference(got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    n_q = 0
    for (path, w), (_, g) in zip(flat_w, flat_g):
        key = jax.tree_util.keystr(path)
        if key.endswith("['n']"):        # zero (padded-head) columns: 24
            n = np.asarray(w)
            assert np.abs(n[n != 24]).max() <= 12, key
        if w.dtype in (jnp.int8, jnp.int32):
            n_q += 1
            assert g.dtype == np.dtype(w.dtype), key
            assert np.array_equal(np.asarray(w), g), key
    assert n_q == 2 * (7 * len(rget(arch).blocks) + 1)    # + lm_head
    assert T.quantized_bytes(got) == R.quantized_bytes(want)
    assert T.is_qweight(got["lm_head"]["w"])
    assert not T.is_qweight(got["embed"])


def test_quantize_consume_frees_the_float_leaves(ref_params):
    tp = lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params["qwen3_14b"]), "cpu")
    blocks = tp["blocks"][0]
    wq = blocks["attn"]["wq"]
    kept = T.quantize_lm_params(tp, consume=False)
    assert blocks["attn"]["wq"] is wq                 # untouched
    out = T.quantize_lm_params(tp, consume=True)
    assert blocks["attn"]["wq"] is out["blocks"][0]["attn"]["wq"]
    assert T.is_qweight(blocks["attn"]["wq"])
    assert torch.equal(out["blocks"][0]["attn"]["wq"]["qt"],
                       kept["blocks"][0]["attn"]["wq"]["qt"])


@pytest.mark.parametrize("k", list(range(-24, 25, 3)) + [13, 15, -13])
def test_exponent_at_exact_powers_of_two(k):
    """max |x| = 127 * 2^-k gives exponent k (floor(log2) of an exact
    power of two), for weights and activations, and the reference's
    exponent wherever XLA's CPU log2 floors to k at 2^k: it does not at
    2^13 and 2^15 (12.999999..., 14.999999...), where the reference
    takes k-1."""
    x = np.full((8, 4), 0.25 * 127.0 * 2.0 ** -k, np.float32)
    x[3, 1] = -127.0 * 2.0 ** -k
    xr, xt = jnp.asarray(x), torch.from_numpy(x)
    assert float(T.exponent(torch.tensor(127.0 * 2.0 ** -k))) == k
    qr, er = R.quantize_activation(xr)
    qt, et = T.quantize_activation(xt)
    wr, wt = R._quantize_weight(xr), T._quantize_weight(xt)
    assert float(et) == k and int(wt["n"][1]) == k
    assert int(qt[3, 1]) == -127 and int(wt["qt"][1, 3]) == -127
    if np.floor(float(jnp.log2(jnp.float32(2.0 ** k)))) == k:
        assert float(er) == k and same(wr["n"], wt["n"])
        if abs(k) <= 12:
            assert same(qr, qt) and same(wr["q"], qt_as_q(wt))
    else:
        assert k in (13, 15) and float(er) == k - 1


@pytest.mark.parametrize("x_mag,w_mag", [(1.0, 0.125), (4.0, 0.02),
                                         (0.5, 0.125)])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_q_dense_within_one_ulp_only_where_exp2_is_inexact(x_mag, w_mag,
                                                           out):
    rng = np.random.default_rng(int(x_mag * 100 + w_mag * 1000))
    xr, xt = bf16(rng.normal(0, x_mag, (2, 12, 64)))
    wr, wt = bf16(rng.normal(0, w_mag, (64, 96)))
    dt_r, dt_t = getattr(jnp, out), getattr(torch, out)
    qwr = R._quantize_weight(wr)
    qwt = T._quantize_weight(wt)
    assert same(qwr["q"], qt_as_q(qwt)) and same(qwr["n"], qwt["n"])
    want = np.asarray(R.q_dense(xr, qwr, out_dtype=dt_r), np.float32)
    got = T.q_dense(xt, qwt, out_dtype=dt_t).float().numpy()
    _, xe = R.quantize_activation(xr)
    inexact = np.broadcast_to(np.abs(float(xe) + np.asarray(qwr["n"])) >= 13,
                              want.shape)
    assert np.array_equal(want[~inexact], got[~inexact])
    # bf16: one ulp; float32: exp2's own error, 4e-6 relative
    bound = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7) \
        if out == "bfloat16" else 4e-6 * np.abs(want)
    assert np.all(np.abs(want - got)[inexact] <= bound[inexact])
    n_diff = int((want != got).sum())
    assert n_diff <= int(inexact.sum())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R.jnp, "exp2", exact_exp2)
        exact = np.asarray(R.q_dense(xr, qwr, out_dtype=dt_r), np.float32)
    assert np.array_equal(exact, got)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_w8a8_dense_plain_is_q_dense_product(out):
    """The kernel's plain version on the reference's own int8 operands
    equals the reference's q_dense (its exp2 made exact), and ops
    dispatches a CPU tensor to it."""
    rng = np.random.default_rng(9)
    xr, _ = bf16(rng.normal(0, 2, (7, 100)))
    wr, _ = bf16(rng.normal(0, 0.05, (100, 33)))
    qw = R._quantize_weight(wr)
    xq, xe = R.quantize_activation(xr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R.jnp, "exp2", exact_exp2)
        want = np.asarray(R.q_dense(xr, qw, out_dtype=getattr(jnp, out)),
                          np.float32)
    args = (torch.from_numpy(np.array(xq)),
            torch.from_numpy(np.ascontiguousarray(np.array(qw["q"]).T)),
            torch.tensor(float(xe)),
            torch.from_numpy(np.array(qw["n"])), getattr(torch, out))
    for fn in (kd.w8a8_dense_plain, ops.w8a8_dense):
        got = fn(*args)
        assert got.dtype == getattr(torch, out)
        assert np.array_equal(got.float().numpy(), want)


def test_w8a8_dense_plain_wraps_like_the_int32_dot():
    """An accumulator past 2^31 wraps modulo 2^32, as XLA's int32 dot."""
    K = 140_000
    xq = torch.full((1, K), 127, dtype=torch.int8)
    wt = torch.full((2, K), 127, dtype=torch.int8)
    got = kd.w8a8_dense_plain(xq, wt, torch.tensor(0.0),
                              torch.zeros(2, dtype=torch.int32),
                              torch.float32)
    acc = (127 * 127 * K + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert got.tolist() == [[float(np.float32(acc))] * 2]


def test_w8a8_dense_refuses_what_it_does_not_take():
    """A meta tensor gets the output's struct (the dry run's face), but
    only of operands the kernel takes: W here is not K-major [..., N, K]
    of K = 8; a device that is neither the CPU, the card nor meta
    raises."""
    meta = torch.empty((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="are not"):
        kd.w8a8_dense(meta, meta.T.contiguous(), torch.tensor(0.0),
                      torch.zeros(4, dtype=torch.int32))
    other = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(NotImplementedError, match="xla"):
        kd.w8a8_dense(other, meta.T.contiguous(), torch.tensor(0.0),
                      torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_tree_stores_w_k_major(arch, ref_params):
    """Every W8A8 leaf of the port's tree holds qt [..., N, K], contiguous,
    equal bit for bit to the reference's q [..., K, N] transposed, its
    stacked cycles included, and n as the reference's."""
    rp = ref_params[arch]
    want = w8a8_leaves(R.quantize_lm_params(rp))
    got = w8a8_leaves(T.quantize_lm_params(lm_params_from_reference(
        jax.tree.map(np.asarray, rp), "cpu")))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(np.asarray(w["q"]).ndim == 3 for _, w in want)   # stacked
    for (path, w), (_, g) in zip(want, got):
        assert set(g) == {"qt", "n"} and g["qt"].is_contiguous(), path
        q = np.asarray(w["q"])
        assert tuple(g["qt"].shape) == q.shape[:-2] + q.shape[:-3:-1], path
        assert same(q, qt_as_q(g)) and same(w["n"], g["n"]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_tree_round_trips_through_the_converter(arch, ref_params):
    """The reference's W8A8 tree to the port (qt K-major) and back is the
    reference's tree bit for bit, and the port's own quantization of the
    carried-across float tree equals the carried-across W8A8 tree."""
    rq = R.quantize_lm_params(ref_params[arch])
    tq = lm_params_from_reference(jax.tree.map(np.asarray, rq), "cpu")
    for path, g in w8a8_leaves(tq):
        assert set(g) == {"qt", "n"} and g["qt"].is_contiguous(), path
    back = lm_params_to_reference(tq)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, rq))
    for a, b in zip(jax.tree.leaves(rq), jax.tree.leaves(back)):
        want = np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 \
            else np.asarray(a)
        assert b.dtype == want.dtype and np.array_equal(want, b)
    mine = T.quantize_lm_params(lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params[arch]), "cpu"))
    for (path, w), (_, g) in zip(w8a8_leaves(tq), w8a8_leaves(mine)):
        assert torch.equal(w["qt"], g["qt"]), path
        assert torch.equal(w["n"], g["n"]), path


@pytest.mark.parametrize("where", ["is_qweight", "q_dense", "q_einsum",
                                   "layers.dense"])
def test_a_leaf_in_the_reference_layout_raises(where):
    """A {"q", "n"} leaf in the port's tree raises, naming the K-major
    layout, instead of giving a transposed product (the leaf here is
    square, as qwen3_14b's wq and wo are)."""
    from repro_torch.models import layers
    rng = np.random.default_rng(5)
    w = T._quantize_weight(torch.from_numpy(
        rng.normal(0, 0.05, (2, 32, 32)).astype(np.float32)))
    stale = {"q": qt_as_q(w).contiguous(), "n": w["n"]}
    x = torch.from_numpy(rng.normal(0, 1, (1, 2, 3, 32)).astype(np.float32))
    calls = {"is_qweight": lambda: T.is_qweight(stale),
             "q_dense": lambda: T.q_dense(x[0, 0], {k: v[0] for k, v in
                                                    stale.items()}),
             "q_einsum": lambda: T.q_einsum(T.EINSUM_SPECS[0], x, stale),
             "layers.dense": lambda: layers.dense(x[0, 0], {
                 k: v[0] for k, v in stale.items()})}
    with pytest.raises(ValueError, match="K-major"):
        calls[where]()
    assert T.is_qweight(w) and not T.is_qweight(w["qt"])
    assert T.q_einsum(T.EINSUM_SPECS[0], x, w).shape == (1, 2, 3, 32)
