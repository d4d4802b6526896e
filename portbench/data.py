"""The inputs of a run, drawn from `--seed` on the device in a few large
calls: the float weights (in the `{layer: {name: tensor}}` layout of
`CapsPipeline.init`), the calibration images and the pool of request
images.  The same seed gives the same tensors; both the program and the
reference are handed them.

Weights follow the paper's initialisation (he-normal convs, 1/fan_in for
the primary capsules' conv, 0.1 for the capsule transform W), with
biases drawn too (0.1 a standard deviation), so that every conv's bias
shift carries values.  Images are uniform in [0, 1), the scale the
calibration and the served requests share.
"""
from __future__ import annotations

import torch

from portbench.yardstick import num_input_caps

BIAS_STD = 0.1
CALIB_N = 32


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    return g


def shapes(cfg: dict) -> list:
    """(layer, name, shape, scale) of every float parameter, in draw
    order."""
    out, cin = [], cfg["input_shape"][2]
    for i, (f, k) in enumerate(zip(cfg["conv_filters"], cfg["conv_kernels"])):
        out += [(f"conv{i}", "w", (k, k, cin, f), (2.0 / (k * k * cin)) ** 0.5),
                (f"conv{i}", "b", (f,), BIAS_STD)]
        cin = f
    k, cout = cfg["pcap_kernel"], cfg["pcap_caps"] * cfg["pcap_dim"]
    out += [("pcap", "w", (k, k, cin, cout), (1.0 / (k * k * cin)) ** 0.5),
            ("pcap", "b", (cout,), BIAS_STD)]
    out += [("caps", "W", (cfg["num_classes"], num_input_caps(cfg),
                           cfg["caps_dim"], cfg["pcap_dim"]), 0.1)]
    return out


def draw(cfg: dict, seed: int, pool_n: int, device) -> tuple:
    """(params, calib [32, H, W, C], pool [pool_n, H, W, C]) on `device`,
    float32: one normal draw for every weight, one uniform draw for all
    images."""
    g = generator(seed, device)
    spec = shapes(cfg)
    sizes = [torch.Size(s).numel() for _, _, s, _ in spec]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    params, at = {}, 0
    for (layer, name, shape, scale), n in zip(spec, sizes):
        params.setdefault(layer, {})[name] = flat[at:at + n].view(shape) * scale
        at += n
    hw = tuple(cfg["input_shape"])
    images = torch.rand((CALIB_N + pool_n,) + hw, generator=g, device=device)
    return params, images[:CALIB_N], images[CALIB_N:]
