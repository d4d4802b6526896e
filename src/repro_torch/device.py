"""Device resolution for the port's entry points.

Every entry point runs on CUDA unless the caller asks for the CPU
(`device="cpu"`, as the tests do).  With `device=None` and no GPU it
raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the torch oracle on the CPU")
        return torch.device("cuda")
    return torch.device(device)
