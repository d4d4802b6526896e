"""Batched int8 serving: FIFO queue, bucketed waves, multi-model registry."""
from repro_torch.serving.engine import (DEFAULT_BUCKETS, CapsServeEngine,
                                        Completion, serve_window)
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.registry import (ModelRegistry, ModelSpec,
                                          default_specs, wave_fn)

__all__ = ["DEFAULT_BUCKETS", "CapsServeEngine", "Completion",
           "ModelRegistry", "ModelSpec", "ServeMetrics", "default_specs",
           "serve_window", "wave_fn"]
