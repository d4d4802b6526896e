"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
Pure full attention -> long_500k skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi35_moe",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    blocks=(("attn", "moe"),),
    num_experts=16,
    experts_per_tok=2,
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
