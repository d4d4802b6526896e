"""The benchmark's operation and byte counts against hand counts, and its
interval arithmetic."""
import pytest

from portbench import spec, yardstick


def test_mnist_macs_by_hand():
    macs = yardstick.layer_macs(spec.load_config("capsnet_mnist_L"))
    assert macs == {"conv0": 22 * 22 * 16 * 49,          # 379,456
                    "pcap": 8 * 8 * 64 * 7 * 7 * 16,     # 3,211,264
                    "u_hat": 10 * 1024 * 6 * 4,          # 245,760
                    "routing": 5 * 10 * 1024 * 6}        # 307,200
    assert sum(macs.values()) == 4_143_680
    assert macs["conv0"] == 379_456 and macs["pcap"] == 3_211_264
    assert macs["u_hat"] == 245_760 and macs["routing"] == 307_200


def test_cifar10_macs_by_hand():
    macs = yardstick.layer_macs(spec.load_config("capsnet_cifar10_S"))
    assert macs == {"conv0": 30 * 30 * 32 * 27, "conv1": 28 * 28 * 32 * 288,
                    "conv2": 13 * 13 * 64 * 288, "conv3": 6 * 6 * 64 * 576,
                    "pcap": 2 * 2 * 64 * 576, "u_hat": 10 * 64 * 5 * 4,
                    "routing": 5 * 10 * 64 * 5}
    assert macs["conv1"] == 7_225_344
    assert sum(macs.values()) == 12_621_312


def test_input_capsules():
    assert yardstick.num_input_caps(spec.load_config("capsnet_mnist_L")) == 1024
    assert yardstick.num_input_caps(spec.load_config("capsnet_cifar10_S")) == 64


@pytest.mark.parametrize("kernel,nbytes", [
    ("routing_q7", 256 * (10 * 1024 * 6 + 10 * 6)),
    ("squash_q7", 2 * 256 * 1024 * 4)])
def test_kernel_bounds_are_bytes_bound_at_mnist(kernel, nbytes):
    cfg = spec.load_config("capsnet_mnist_L")
    assert yardstick.kernel_bound_s(kernel, cfg, 256) == pytest.approx(
        nbytes / yardstick.PEAK_HBM_BYTES, rel=1e-12)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert yardstick.union_s(iv) == 4
    assert yardstick.gaps(iv) == [(3, 5)]
    assert yardstick.union_s([]) == 0
