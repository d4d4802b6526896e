"""xlstm-1.3b [arXiv:2405.04517; unverified].

48 blocks d_model=2048 4H d_ff=0 vocab=50304, xLSTM[7:1] — 7 mLSTM blocks per
sLSTM block.  Blocks carry their own up/down projections (d_ff=0 in the
assignment means no separate FFN): mLSTM uses projection factor 2, sLSTM a
gated FFN with factor 4/3, per the xLSTM paper.
Recurrent (O(1) decode state) -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm_1_3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    blocks=(
        ("mlstm", "none"), ("mlstm", "none"), ("mlstm", "none"),
        ("slstm", "none"), ("mlstm", "none"), ("mlstm", "none"),
        ("mlstm", "none"), ("mlstm", "none"),
    ),
    xlstm_expand=2,
    source="arXiv:2405.04517",
)
