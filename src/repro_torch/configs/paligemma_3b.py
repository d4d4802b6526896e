"""paligemma-3b [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1 -> MQA) d_ff=16384 vocab=257216.
SigLIP frontend is a STUB per assignment: input_specs() provides precomputed
patch embeddings [B, 256, d_model]; attention is prefix-bidirectional over the
patch prefix (prefix-LM), causal over text.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma_3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    blocks=(("attn", "mlp"),),
    prefix_bidir=True,
    frontend="patch",
    num_prefix_embeds=256,
    rope_theta=10_000.0,
    source="arXiv:2407.07726",
)
