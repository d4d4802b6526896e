"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b family; unverified].

32L d_model=2560 32H (kv=32 -> full MHA) d_ff=6912 vocab=50304.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    blocks=(("attn", "mlp"),),
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
)
