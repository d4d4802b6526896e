"""gemma3-12b [hf:google/gemma-3-1b-pt scaled family; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144, 5:1 local:global
attention (window 1024), 128k context.  Mostly bounded context -> long_500k
runs (8/48 global layers use a sequence-sharded KV cache).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    blocks=(
        ("swa", "mlp"), ("swa", "mlp"), ("swa", "mlp"),
        ("swa", "mlp"), ("swa", "mlp"), ("attn", "mlp"),
    ),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt",
)
