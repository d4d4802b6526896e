"""seamless-m4t-medium [arXiv:2308.11596; hf].

12L d_model=1024 16H (kv=16 MHA) d_ff=4096 vocab=256206, encoder-decoder,
multimodal.  The speech frontend is a STUB per assignment: input_specs()
provides precomputed frame embeddings [B, S_src, d_model].
Shapes are interpreted as src_len = tgt_len = seq_len.  Enc-dec (not
encoder-only) -> decode shapes run against the decoder.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    blocks=(("attn", "mlp"),),
    is_encoder_decoder=True,
    num_encoder_layers=12,
    frontend="frame",
    rope_theta=10_000.0,
    source="arXiv:2308.11596",
)
