"""qwen3-14b [hf:Qwen/Qwen3-8B family config; hf].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, qk_norm, GQA.
Pure full attention -> long_500k skipped.

Note: 40 query heads are not divisible by the 16-way model axis; GSPMD pads
the head dim in attention einsums (48/40 = 1.2x attention-FLOP overhead,
recorded in EXPERIMENTS.md §Roofline).  Projection weights shard on the flat
H*head_dim = 5120 dim, which is divisible.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    blocks=(("attn", "mlp"),),
    qk_norm=True,
    head_pad=8,   # 40 -> 48 query heads for the 16-way model axis (zeroed)
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)
