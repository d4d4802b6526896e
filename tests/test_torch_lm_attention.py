"""`repro_torch.models.attention` against `repro.models.attention` on the
CPU: the chunked online-softmax `flash_attention` (causal, sliding
window, prefix-LM, GQA and MQA, several q and KV chunks), the cached
decode attention, the SWA ring (`ring_positions`, `_fill_cache`'s roll),
the int8 KV cache (`quantize_kv` bit for bit, `_int8_cached_attention`)
and `attn_apply`'s decode step against the reference's.

Inputs come from NumPy seeds.  bf16 outputs are held within one bf16 ulp
(rtol 2**-7); on these inputs they are equal, since the port repeats the
reference's order of roundings (the scaled query cast to bf16 before
the QK product, float32 softmax, the probabilities cast to v's dtype
before the PV product).  Cache writes are data movement and are exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import attention as TA

BF16_RTOL = 2.0 ** -7


def bf16(a):
    r = jnp.asarray(a, jnp.bfloat16)
    return r, torch.from_numpy(np.array(r.astype(jnp.float32))).bfloat16()


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close_bf16(want, got):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_RTOL, atol=0)


def bits(a):
    """Exact comparison key of a tensor/array (bf16 by its bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def qkv(seed, B, S, H, K, Dh):
    rng = np.random.default_rng(seed)
    return (bf16(rng.normal(0, 1, (B, S, H, Dh))),
            bf16(rng.normal(0, 1, (B, S, K, Dh))),
            bf16(rng.normal(0, 1, (B, S, K, Dh))))


@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False), dict(window=5), dict(prefix_len=6),
    dict(window=5, prefix_len=6), dict(window=40),
    dict(q_chunk=8, kv_chunk=8), dict(window=5, q_chunk=8, kv_chunk=4),
    dict(prefix_len=12, q_chunk=8, kv_chunk=8)], ids=str)
@pytest.mark.parametrize("heads", [(4, 4), (6, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_flash_attention(kw, heads):
    H, K = heads
    (qr, qt), (kr, kt), (vr, vt) = qkv(H * 10 + K, 2, 24, H, K, 16)
    close_bf16(RA.flash_attention(qr, kr, vr, **kw),
               TA.flash_attention(qt, kt, vt, **kw))


@pytest.mark.parametrize("heads", [(4, 4), (6, 2), (12, 4)], ids=str)
def test_cached_attention(heads):
    H, K = heads
    rng = np.random.default_rng(H)
    qr, qt = bf16(rng.normal(0, 1, (2, 1, H, 128)))
    kr, kt = bf16(rng.normal(0, 1, (2, 20, K, 128)))
    vr, vt = bf16(rng.normal(0, 1, (2, 20, K, 128)))
    kv_pos = np.where(rng.random(20) < 0.2, -1, np.arange(20))
    for q_pos in (3, 11, 19):
        close_bf16(RA.cached_attention(qr, kr, vr, jnp.asarray(kv_pos),
                                       q_pos, H // K),
                   TA.cached_attention(qt, kt, vt, torch.from_numpy(kv_pos),
                                       q_pos, H // K))


@pytest.mark.parametrize("alloc", [1, 4, 8, 13])
def test_ring_positions(alloc):
    for q_pos in (0, 3, alloc - 1, alloc, 2 * alloc + 1, 100):
        assert np.array_equal(np.asarray(RA.ring_positions(q_pos, alloc)),
                              TA.ring_positions(q_pos, alloc).numpy())


@pytest.mark.parametrize("S,alloc,window", [(10, 4, 4), (12, 8, 8),
                                            (5, 8, 8), (8, 8, 8),
                                            (6, 16, 0), (6, 16, 32)],
                         ids=str)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_fill_cache_ring_and_linear(S, alloc, window, int8):
    """Prefill writes into the cache: a ring when the window is at most
    the allocation (position p in slot p % alloc), linear otherwise."""
    cfg = dataclasses.make_dataclass("C", [("num_kv_heads", int),
                                           ("head_dim", int),
                                           ("kv_cache_int8", bool)])(
        2, 8, int8)
    rng = np.random.default_rng(S * alloc + window)
    kr, kt = bf16(rng.normal(0, 1, (2, S, 2, 8)))
    vr, vt = bf16(rng.normal(0, 1, (2, S, 2, 8)))
    want = RA._fill_cache(RA.init_attn_cache(cfg, 2, alloc), kr, vr, window)
    cache = TA.init_attn_cache(cfg, 2, alloc)
    got = TA._fill_cache(cache, kt, vt, window)
    assert got is cache                        # written in place
    assert set(got) == set(want)
    for name in want:
        assert np.array_equal(bits(want[name]), bits(got[name])), name


@pytest.mark.parametrize("mag", [1.0, 100.0, 0.05])
def test_quantize_kv_bit_equal(mag):
    """Exponents here lie in [-12, 12], where XLA's CPU exp2 is exact."""
    rng = np.random.default_rng(int(mag * 7))
    xr, xt = bf16(rng.normal(0, mag, (2, 9, 3, 16)))
    qr, er = RA.quantize_kv(xr)
    qt, et = TA.quantize_kv(xt)
    assert np.abs(np.asarray(er)).max() <= 12
    assert np.array_equal(np.asarray(qr), qt.numpy())
    assert np.array_equal(np.asarray(er), et.numpy())


def test_quantize_kv_at_exact_powers_of_two():
    """A row whose max |x| is 127 * 2^-k takes exponent k exactly."""
    ks = np.arange(-12, 13)
    x = np.zeros((1, len(ks), 1, 4), np.float32)
    x[0, :, 0, 0] = 127.0 * 2.0 ** -ks
    x[0, :, 0, 1] = -0.5 * 2.0 ** -ks
    qr, er = RA.quantize_kv(jnp.asarray(x))
    qt, et = TA.quantize_kv(torch.from_numpy(x))
    assert np.array_equal(et.numpy()[0, :, 0], ks.astype(np.int8))
    assert np.array_equal(np.asarray(er), et.numpy())
    assert np.array_equal(np.asarray(qr), qt.numpy())


@pytest.mark.parametrize("heads", [(4, 4), (6, 2)], ids=str)
def test_int8_cached_attention(heads):
    H, K = heads
    rng = np.random.default_rng(H + 40)
    qr, qt = bf16(rng.normal(0, 1, (2, 1, H, 16)))
    cache_r, cache_t = {}, {}
    for name in ("k", "v"):
        xr, xt = bf16(rng.normal(0, 1, (2, 12, K, 16)))
        cache_r[name], cache_r[name + "_e"] = RA.quantize_kv(xr)
        cache_t[name], cache_t[name + "_e"] = TA.quantize_kv(xt)
    kv_pos = np.arange(12)
    want = RA._int8_cached_attention(qr, cache_r, jnp.asarray(kv_pos), 7,
                                     None)
    got = TA._int8_cached_attention(qt, cache_t, torch.from_numpy(kv_pos), 7)
    close_bf16(want, got)


@pytest.mark.parametrize("case", ["attn", "swa_ring", "swa_linear",
                                  "int8", "qkv_bias"])
def test_attn_apply_prefill_then_decode(case):
    """attn_apply's prefill (flash + cache fill) and three decode steps
    (rope at the position, in-place cache write, cached attention) on
    the same weights and inputs; the port returns its cache tensors."""
    from tests.conftest import tiny_lm_config
    kw = dict(qk_norm=True, head_pad=2, num_heads=4, num_kv_heads=2)
    window, alloc = 0, 16
    if case == "swa_ring":
        window, alloc = 4, 4
    elif case == "swa_linear":
        window = 6
    elif case == "int8":
        kw["kv_cache_int8"] = True
    elif case == "qkv_bias":
        kw = dict(qkv_bias=True)
    cfg = tiny_lm_config(**kw)
    import jax
    p_ref = RA.init_attn(jax.random.key(3), cfg)
    p_ref = jax.tree.map(
        lambda a: a if a.ndim > 1 else jnp.asarray(
            np.random.default_rng(a.size).normal(0, 0.1, a.shape), a.dtype),
        p_ref)
    p_t = lm_params_from_reference(jax.tree.map(np.asarray, p_ref), "cpu")
    rng = np.random.default_rng(5)
    xr, xt = bf16(rng.normal(0, 1, (2, 9, cfg.d_model)))
    cr = RA.init_attn_cache(cfg, 2, alloc)
    ct = TA.init_attn_cache(cfg, 2, alloc)
    yr, cr = RA.attn_apply(cfg, p_ref, xr, mode="prefill", cache=cr,
                           window=window)
    yt, ct2 = TA.attn_apply(cfg, p_t, xt, mode="prefill", cache=ct,
                            window=window)
    assert ct2 is ct
    close_bf16(yr, yt)
    for pos in (9, 10, 11):
        dr, dt = bf16(rng.normal(0, 1, (2, 1, cfg.d_model)))
        yr, cr = RA.attn_apply(cfg, p_ref, dr, mode="decode", cache=cr,
                               pos=jnp.asarray(pos, jnp.int32),
                               window=window)
        yt, ct2 = TA.attn_apply(cfg, p_t, dt, mode="decode", cache=ct,
                                pos=pos, window=window)
        assert ct2 is ct
        close_bf16(yr, yt)
        for name in cr:
            if name.endswith("_e") or cr[name].dtype == jnp.int8:
                assert np.array_equal(np.asarray(cr[name]),
                                      ct[name].numpy()), name
            else:
                close_bf16(cr[name], ct[name])


def test_attn_apply_cross_attention():
    """The cross branch: prefill attends (not causally) to encoder states
    and fills the cache with their K/V; decode reads that cache only."""
    from tests.conftest import tiny_lm_config
    import jax
    cfg = tiny_lm_config()
    p_ref = RA.init_attn(jax.random.key(4), cfg)
    p_t = lm_params_from_reference(jax.tree.map(np.asarray, p_ref), "cpu")
    rng = np.random.default_rng(8)
    xr, xt = bf16(rng.normal(0, 1, (2, 5, cfg.d_model)))
    er, et = bf16(rng.normal(0, 1, (2, 7, cfg.d_model)))
    yr, cr = RA.attn_apply(cfg, p_ref, xr, mode="prefill", kv_override=er,
                           cache=RA.init_attn_cache(cfg, 2, 7))
    yt, ct = TA.attn_apply(cfg, p_t, xt, mode="prefill", kv_override=et,
                           cache=TA.init_attn_cache(cfg, 2, 7))
    close_bf16(yr, yt)
    dr, dt = bf16(rng.normal(0, 1, (2, 1, cfg.d_model)))
    yr, _ = RA.attn_apply(cfg, p_ref, dr, mode="decode", cache=cr,
                          pos=jnp.asarray(5, jnp.int32), is_cross=True)
    yt, _ = TA.attn_apply(cfg, p_t, dt, mode="decode", cache=ct, pos=5,
                          is_cross=True)
    close_bf16(yr, yt)


def test_decode_beyond_the_cache_raises():
    from tests.conftest import tiny_lm_config
    cfg = tiny_lm_config()
    import jax
    p = lm_params_from_reference(jax.tree.map(
        np.asarray, RA.init_attn(jax.random.key(0), cfg)), "cpu")
    cache = TA.init_attn_cache(cfg, 1, 4)
    with pytest.raises(ValueError, match="outside the cache"):
        TA.attn_apply(cfg, p, torch.zeros((1, 1, 64), dtype=torch.bfloat16),
                      mode="decode", cache=cache, pos=4)
