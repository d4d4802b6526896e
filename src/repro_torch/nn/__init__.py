"""Typed capsule layers, plans, variants, backends and the pipeline."""
from repro_torch.nn.config import (CAPSNET_CONFIGS, CIFAR10, EDGE_TINY,
                                   MNIST, SMALLNORB, CapsNetConfig)
from repro_torch.nn.layers import (CapsLayer, CapsuleRouting, PrimaryCaps,
                                   QuantConv2D)
from repro_torch.nn.pipeline import CapsPipeline, QuantCapsNet
from repro_torch.nn.variants import REGISTRY, VariantSet

__all__ = ["CAPSNET_CONFIGS", "CIFAR10", "EDGE_TINY", "MNIST", "SMALLNORB",
           "CapsLayer", "CapsNetConfig", "CapsPipeline", "CapsuleRouting",
           "PrimaryCaps", "QuantCapsNet", "QuantConv2D", "REGISTRY",
           "VariantSet"]
