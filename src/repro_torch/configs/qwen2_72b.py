"""qwen2-72b [arXiv:2407.10671; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, GQA with QKV bias.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    blocks=(("attn", "mlp"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)
