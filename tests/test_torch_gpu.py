"""The port's CUDA kernels on the card, held bit for bit against their
plain torch versions.  Every case needs a CUDA device and skips without
one; the file imports torch and the port only, so the GPU host runs it
without JAX and without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import routing as kr
from repro_torch.kernels import squash as ks
from repro_torch.serving import ModelRegistry, default_specs

ROUNDINGS = ("floor", "nearest")
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
    assert torch.equal(ks.isqrt_newton(n.to(cuda)).cpu(),
                       ks.isqrt_newton(n))


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
