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
from repro_torch.kernels import build
from repro_torch.kernels import routing as kr
from repro_torch.kernels import squash as ks
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
    assert torch.equal(ks.isqrt_newton(n), torch.sqrt(n.double()).floor()
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
    assert kr.routing_smem_bytes(10, 1024, 6) == 61440 + 2 * 10240 + 240
    with pytest.raises(ValueError, match="shared memory"):
        kr.check_geometry(10, 4096, 6, 3)
    with pytest.raises(ValueError):
        kr.check_geometry(10, 64, 17, 3)
    with pytest.raises(ValueError):
        kr.check_geometry(10, 64, 6, 9)
    with pytest.raises(ValueError):
        ks.check_in_frac(31)


def test_kernel_sources_name_what_they_replace():
    names = sorted(p.stem for p in build.sources())
    assert names == ["q7_matmul", "routing_q7", "squash_float", "squash_q7",
                     "w8a8_matmul"]
    notes = {"routing_q7": "src/repro/kernels/routing.py",
             "squash_q7": "src/repro/kernels/squash.py",
             "squash_float": "src/repro/kernels/squash.py",
             "q7_matmul": "src/repro/kernels/q7_matmul.py",
             "w8a8_matmul": "src/repro/kernels/w8a8_matmul.py"}
    for p in build.sources():
        text = p.read_text()
        assert notes[p.stem] in text and f"{p.stem}_pallas" in text
        assert "Bound on the H100" in text
        assert f'extern "C" int {p.stem}_launch' in text
    for gemm in ("q7_matmul", "w8a8_matmul"):
        text = (build.CSRC / f"{gemm}.cu").read_text()
        assert '#include "i8_gemm.cuh"' in text and "i8gemm::launch" in text
    h = build.source_hash()
    assert h == build.source_hash() and len(h) == 16
    assert str(build.BUILD_ROOT).endswith("build/repro_torch_kernels")


@pytest.mark.parametrize("header", ["i8_gemm.cuh", "q7.cuh"])
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


def test_build_error_check_raises():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        build.check(98, "kernel")
    assert ctypes.sizeof(ctypes.c_void_p) == 8       # pointers are not cut
