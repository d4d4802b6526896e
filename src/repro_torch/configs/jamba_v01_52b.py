"""jamba-v0.1-52b [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Mamba:attention 7:1 interleave (1 attention layer per 8-layer block, at index
4 per the Jamba paper), MoE every other layer.
Hybrid with 4/32 attention layers -> long_500k runs (attention caches are
sequence-sharded).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba_v01_52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    blocks=(
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
        ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ),
    num_experts=16,
    experts_per_tok=2,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    rope_theta=10_000.0,
    source="arXiv:2403.19887",
)
