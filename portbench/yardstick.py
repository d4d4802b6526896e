"""The benchmark's own arithmetic: the card's peaks, the operations and
bytes a CapsNet and its kernels need, interval unions.
It reads only a configuration's numbers, never the program.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit (a card set lower reaches less; the run prints the limit).
"""
from __future__ import annotations

import math

PEAK_INT8_OPS = 1979e12          # int8 tensor-core operations a second
PEAK_HBM_BYTES = 3.35e12         # HBM3 bytes a second


def _out(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


def layer_macs(cfg: dict) -> dict:
    """Multiply-accumulates an image, by layer, of the int8 forward:
    each VALID conv, the primary capsules' conv, u_hat, and the routing
    loop's products (r couplings sums s_j and r - 1 agreements)."""
    h, w, cin = cfg["input_shape"]
    out = {}
    for i, (f, k, s) in enumerate(zip(cfg["conv_filters"], cfg["conv_kernels"],
                                      cfg["conv_strides"])):
        h, w = _out(h, k, s), _out(w, k, s)
        out[f"conv{i}"] = h * w * f * k * k * cin
        cin = f
    k, s = cfg["pcap_kernel"], cfg["pcap_stride"]
    h, w = _out(h, k, s), _out(w, k, s)
    cout = cfg["pcap_caps"] * cfg["pcap_dim"]
    out["pcap"] = h * w * cout * k * k * cin
    J, O, D = cfg["num_classes"], cfg["caps_dim"], cfg["pcap_dim"]
    I = num_input_caps(cfg)
    out["u_hat"] = J * I * O * D
    r = cfg["routings"]
    out["routing"] = (2 * r - 1) * J * I * O
    return out


def num_input_caps(cfg: dict) -> int:
    h, w, _ = cfg["input_shape"]
    for k, s in zip(cfg["conv_kernels"], cfg["conv_strides"]):
        h, w = _out(h, k, s), _out(w, k, s)
    k, s = cfg["pcap_kernel"], cfg["pcap_stride"]
    return _out(h, k, s) * _out(w, k, s) * cfg["pcap_caps"]


def image_ops(cfg: dict) -> int:
    """Operations an image: two a multiply-accumulate."""
    return 2 * sum(layer_macs(cfg).values())


def kernel_bound_s(kernel: str, cfg: dict, batch: int) -> float:
    """The least time one call of `kernel` on `batch` images could take:
    the larger of its operations at the int8 peak and its bytes (each
    input byte read once, each output byte written once) at the HBM
    peak."""
    J, O = cfg["num_classes"], cfg["caps_dim"]
    I, D = num_input_caps(cfg), cfg["pcap_dim"]
    if kernel == "routing_q7":
        nbytes = batch * (J * I * O + J * O)
        ops = 2 * batch * layer_macs(cfg)["routing"]
    elif kernel == "squash_q7":
        nbytes = 2 * batch * I * D
        ops = 0
    else:
        raise KeyError(kernel)
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_INT8_OPS)


def union_s(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals) -> list:
    """The idle [end, next start) gaps between the union's pieces."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out
