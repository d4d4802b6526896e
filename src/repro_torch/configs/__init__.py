from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, all_configs, cell_is_runnable,
    get_config)
