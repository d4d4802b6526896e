"""LM training driver of the port: for now only `reduced`, the
reference's config shrinker (`repro.launch.train.reduced`), which
`launch/serve.py` uses; the training loop joins it in a later slice
(ROADMAP Queue A item 5)."""
from __future__ import annotations


def reduced(cfg, d_model=256, layers=None):
    """Shrink an assigned config to a CPU-trainable scale (same family)."""
    n_blocks = len(cfg.blocks)
    num_layers = layers or n_blocks * max(1, 2 // max(n_blocks // 4, 1))
    num_layers = max(n_blocks, (num_layers // n_blocks) * n_blocks)
    return cfg.scaled(
        num_layers=num_layers, d_model=d_model,
        num_heads=4, num_kv_heads=min(4, cfg.num_kv_heads),
        head_dim=d_model // 4,
        d_ff=d_model * 4 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 4096),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        window_size=min(cfg.window_size, 64) if cfg.window_size else 0,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        num_prefix_embeds=min(cfg.num_prefix_embeds, 16),
    )
