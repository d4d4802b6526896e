"""The plain reference against the port's `torch` backend (the only place
that imports both): the same plan and the same int8 answers from the same
float weights, calibration images and pool, at both configurations'
full geometry on a small pool.  The int4 control differs."""
import numpy as np
import pytest
import torch

from portbench import data, reference, spec


def _port(cfg, params, calib, images):
    from portbench.harness import program_config
    from repro_torch.nn.pipeline import CapsPipeline
    pipe = CapsPipeline.from_config(program_config(cfg))
    qnet = pipe.quantize(params, calib, rounding="floor", backend="torch")
    with torch.inference_mode():
        v = qnet.forward(qnet.quantize_input(images))
        ln = qnet.class_lengths(v)
    return qnet, v.numpy(), ln.numpy(), torch.argmax(ln, -1).numpy()


@pytest.mark.parametrize("config", ["capsnet_mnist_L", "capsnet_cifar10_S"])
def test_reference_equals_port(config):
    cfg = spec.load_config(config)
    params, calib, pool = data.draw(cfg, 2 ** 33 + 5, 24, "cpu")
    qnet, v, ln, pred = _port(cfg, params, calib, pool)
    ref = reference.Reference(cfg, params, calib)
    p = qnet.plan
    assert ref.plan.input_frac == p.input_frac
    names = [n for n in p.layers if n != "caps"]
    assert ref.plan.convs == tuple(
        (p[n].out_shift, p[n].bias_shift) if n != "pcap" else
        (p[n].conv.out_shift, p[n].conv.bias_shift) for n in names)
    assert ref.plan.caps_out_shifts == p["caps"].caps_out_shifts
    assert ref.plan.agree_shift == p["caps"].agree_shifts[0]
    assert ref.plan.uhat_shift == p["caps"].uhat_shift
    for n in names:
        assert torch.equal(ref.qw[n]["w"], qnet.qweights[n]["w"])
        assert torch.equal(ref.qw[n]["b"], qnet.qweights[n]["b"])
    rv, rl, rp = ref.answers(pool, block=10)
    assert np.array_equal(rv, v) and np.array_equal(rl, ln)
    assert np.array_equal(rp, pred)
    assert (v != 0).mean() > 0.3 and len(set(pred.tolist())) > 1


def test_control_int4_differs():
    cfg = spec.load_config("capsnet_mnist_L")
    params, calib, pool = data.draw(cfg, 3, 8, "cpu")
    v8 = reference.Reference(cfg, params, calib).answers(pool)[0]
    v4 = reference.Reference(cfg, params, calib, bits=4).answers(pool)[0]
    assert (v8 != v4).sum() > 100


def test_isqrt_exact():
    n = torch.cat([torch.arange(0, 70000), torch.tensor([2 ** 31 - 1,
                                                          2 ** 30])]).int()
    r = reference.isqrt(n).long()
    assert torch.all(r * r <= n.long())
    assert torch.all((r + 1) * (r + 1) > n.long())


def test_draw_is_seeded():
    cfg = spec.load_config("capsnet_cifar10_S")
    a = data.draw(cfg, 2 ** 40 + 1, 4, "cpu")
    b = data.draw(cfg, 2 ** 40 + 1, 4, "cpu")
    c = data.draw(cfg, 2 ** 40 + 2, 4, "cpu")
    assert torch.equal(a[2], b[2]) and not torch.equal(a[2], c[2])
    assert torch.equal(a[0]["caps"]["W"], b[0]["caps"]["W"])
