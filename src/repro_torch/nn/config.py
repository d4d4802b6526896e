"""CapsNet geometry configs (paper Table 1 / Table 7), plus the deep-edge
micro geometry the serving registry uses.

With VALID padding:
  MNIST    28x28x1: conv16 k7 s1 -> 22x22; pcap k7 s2 -> 8x8x(16x4)
           -> 1024 input capsules  => caps layer 10x1024x6x4   (Table 7 "L")
  smallNORB 32x32x2: conv32 k7 -> 26x26; pcap k7 s2 -> 10x10 -> 1600 caps
           => 5x1600x6x4 ("M")
  CIFAR-10 32x32x3: convs 32,32,64,64 k3 s1,1,2,2 -> 6x6; pcap k3 s2 ->
           2x2 -> 64 caps => 10x64x5x4 ("S")
  EDGE_TINY 16x16x1: conv8 k5 s2 -> 6x6; pcap k3 s2 -> 2x2x(4x4) -> 16
           caps => 4x16x4x4, 2 routing iterations
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CapsNetConfig:
    name: str
    input_shape: tuple                     # (H, W, C)
    conv_filters: tuple                    # e.g. (16,) or (32,32,64,64)
    conv_kernels: tuple
    conv_strides: tuple
    pcap_caps: int = 16
    pcap_dim: int = 4
    pcap_kernel: int = 7
    pcap_stride: int = 2
    num_classes: int = 10
    caps_dim: int = 6
    routings: int = 3
    lr: float = 1e-3

    @property
    def conv_out_hw(self) -> tuple:
        h, w = self.input_shape[0], self.input_shape[1]
        for k, s in zip(self.conv_kernels, self.conv_strides):
            h = (h - k) // s + 1
            w = (w - k) // s + 1
        return h, w

    @property
    def pcap_out_hw(self) -> tuple:
        h, w = self.conv_out_hw
        k, s = self.pcap_kernel, self.pcap_stride
        return (h - k) // s + 1, (w - k) // s + 1

    @property
    def num_input_caps(self) -> int:
        h, w = self.pcap_out_hw
        return h * w * self.pcap_caps

    @property
    def conv_geometries(self) -> tuple:
        """(H, W, Cin, kernel, stride, Cout) of each conv, the primary
        capsules' last: the shapes the int8 conv kernel serves."""
        (h, w, c), out = self.input_shape, []
        for f, k, s in zip(self.conv_filters + (self.pcap_caps
                                                * self.pcap_dim,),
                           self.conv_kernels + (self.pcap_kernel,),
                           self.conv_strides + (self.pcap_stride,)):
            out.append((h, w, c, k, s, f))
            h, w, c = (h - k) // s + 1, (w - k) // s + 1, f
        return tuple(out)


MNIST = CapsNetConfig("capsnet_mnist", (28, 28, 1), (16,), (7,), (1,),
                      num_classes=10, caps_dim=6, lr=1e-3)
SMALLNORB = CapsNetConfig("capsnet_smallnorb", (32, 32, 2), (32,), (7,), (1,),
                          num_classes=5, caps_dim=6, lr=2.5e-4)
CIFAR10 = CapsNetConfig("capsnet_cifar10", (32, 32, 3), (32, 32, 64, 64),
                        (3, 3, 3, 3), (1, 1, 2, 2), pcap_kernel=3,
                        num_classes=10, caps_dim=5, lr=2.5e-4)
EDGE_TINY = CapsNetConfig("capsnet_edge_tiny", (16, 16, 1), (8,), (5,),
                          (2,), pcap_caps=4, pcap_dim=4, pcap_kernel=3,
                          pcap_stride=2, num_classes=4, caps_dim=4,
                          routings=2)
CAPSNET_CONFIGS = {c.name: c for c in (MNIST, SMALLNORB, CIFAR10, EDGE_TINY)}
