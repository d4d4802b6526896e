"""mixtral-8x22b [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts top-2,
sliding-window attention (assignment specifies SWA) -> window-bounded cache,
so long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    blocks=(("swa", "moe"),),
    window_size=4096,
    num_experts=8,
    experts_per_tok=2,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)
