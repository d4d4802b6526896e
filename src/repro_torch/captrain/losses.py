"""Training losses on the pipeline's class capsules: margin loss
(Sabour et al. eq. 4, the paper's training objective) and the accuracy
metrics.  The reconstruction regularizer lives in `captrain.decoder`."""
from __future__ import annotations

import torch


def one_hot(labels, num_classes: int, dtype=torch.float32):
    """[B] integer labels -> [B, num_classes] in `dtype`."""
    return (labels[..., None] == torch.arange(
        num_classes, device=labels.device)).to(dtype)


def class_lengths(v):
    """||v_j|| per class capsule; eps keeps the sqrt differentiable."""
    return torch.sqrt(torch.sum(torch.square(v), dim=-1) + 1e-9)


def margin_loss(v, labels, num_classes: int,
                m_pos: float = 0.9, m_neg: float = 0.1, lam: float = 0.5):
    L = class_lengths(v)                              # [B, J]
    T = one_hot(labels, num_classes)
    pos = T * torch.square(torch.clamp(m_pos - L, min=0.0))
    neg = lam * (1 - T) * torch.square(torch.clamp(L - m_neg, min=0.0))
    return torch.mean(torch.sum(pos + neg, dim=-1))


def predictions(v):
    return torch.argmax(class_lengths(v), dim=-1)


def accuracy_count(v, labels):
    """Number of correct rows as int32: an integer, so summing counts
    across microbatches is exact in any order."""
    return torch.sum((predictions(v) == labels).to(torch.int32),
                     dtype=torch.int32)


def accuracy(v, labels):
    return accuracy_count(v, labels) / labels.shape[0]
