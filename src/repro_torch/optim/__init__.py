"""Optimizers over nested dicts of tensors (the reference's
`repro.optim.adam`)."""
from repro_torch.optim.adam import (SGDM, AdamW,  # noqa: F401
                                    clip_by_global_norm, cosine_schedule,
                                    global_norm)
