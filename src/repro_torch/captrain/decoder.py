"""Reconstruction-decoder regularizer (paper §3.1 / Sabour et al. §4.1).

The class capsules are masked to the true class and decoded back to the
input image through a small fully connected stack; the summed squared
reconstruction error, scaled far down (0.0005 in the paper's setup),
regularizes the capsule lengths.  The decoder trains alongside the
pipeline but is not part of the deployed model: `CapsTrainer` keeps its
params in a separate branch of the train state, so PTQ and the edge
export never see them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.captrain.losses import one_hot
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ReconDecoder:
    """FC(h0) relu -> FC(h1) relu -> FC(H*W*C) sigmoid over the masked
    class capsules."""
    num_classes: int
    caps_dim: int
    image_shape: tuple                   # (H, W, C)
    hidden: tuple = (64, 128)

    @property
    def in_dim(self) -> int:
        return self.num_classes * self.caps_dim

    @property
    def out_dim(self) -> int:
        h, w, c = self.image_shape
        return h * w * c

    def init(self, generator: torch.Generator, device=None) -> dict:
        """He-normal weights drawn from `generator` (a CPU generator, so
        a seed gives the same weights on every device), zero biases."""
        device = resolve_device(device)
        dims = (self.in_dim,) + tuple(self.hidden) + (self.out_dim,)
        params = {}
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((din, dout), generator=generator,
                            dtype=torch.float32) * (2.0 / din) ** 0.5
            params[f"fc{i}"] = {
                "w": w.to(device),
                "b": torch.zeros((dout,), dtype=torch.float32,
                                 device=device)}
        return params

    def apply(self, params, v, labels):
        """v [B,J,O] class capsules + labels [B] -> reconstruction
        [B,H,W,C] in [0,1]."""
        mask = one_hot(labels, self.num_classes, dtype=v.dtype)
        h = (v * mask[:, :, None]).reshape(v.shape[0], -1)
        n_fc = len(self.hidden) + 1
        for i in range(n_fc):
            p = params[f"fc{i}"]
            h = h @ p["w"] + p["b"]
            if i < n_fc - 1:
                h = torch.relu(h)
        return torch.sigmoid(h).reshape((v.shape[0],) + self.image_shape)

    def loss(self, params, v, labels, x):
        """Mean (over the batch) summed squared reconstruction error."""
        recon = self.apply(params, v, labels)
        return torch.mean(torch.sum(torch.square(recon - x), dim=(1, 2, 3)))
