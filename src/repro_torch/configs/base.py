"""Config system: model architecture configs + assigned input-shape grid.

A copy of the reference package's `repro.configs.base` (pure data, no
JAX): every assigned architecture is a `ModelConfig`; every assigned
input shape is a `ShapeSpec`.  `get_config(arch)` imports
`repro_torch.configs.<arch>`, whose CONFIG equals the reference's field
for field.  The port builds and serves all ten
(`repro_torch.models.transformer`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------
# mixer kinds: "attn" (global causal), "swa" (sliding-window), "mamba",
#              "mlstm", "slstm"
# ffn kinds:   "mlp", "moe", "none"
BlockSpec = tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # block pattern, cycled over the depth.  len must divide num_layers.
    blocks: tuple[BlockSpec, ...] = (("attn", "mlp"),)
    # --- attention options -------------------------------------------------
    window_size: int = 0             # for "swa" blocks
    qk_norm: bool = False
    qkv_bias: bool = False
    # extra all-zero query heads so the head count divides the 16-way model
    # axis (function-preserving: zero wq rows -> uniform attention ->
    # killed by zero wo rows).  qwen3 40H -> +8; §Perf B1.
    head_pad: int = 0
    rope_theta: float = 10_000.0
    prefix_bidir: bool = False       # VLM prefix-LM attention over the prefix
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gshard_sort"    # gshard_sort | ep (shard_map all-to-all)
    # --- SSM (mamba) --------------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    # --- xLSTM --------------------------------------------------------------
    xlstm_expand: int = 2
    xlstm_impl: str = "chunked"      # chunked (closed form) | recurrent
    xlstm_chunk: int = 256
    # --- enc-dec ------------------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # --- modality frontend stub ---------------------------------------------
    frontend: Optional[str] = None   # "patch" (vlm) | "frame" (audio)
    num_prefix_embeds: int = 256     # patches per image for vlm
    # --- numerics -----------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # decode: unroll the layer loop so per-layer caches are top-level
    # donated buffers updated IN PLACE — a scanned cache (xs/ys) rewrites
    # the full cache every step (§Perf C3).  Train/prefill stay scanned.
    decode_unroll: bool = True
    # int8 KV cache (§Perf C5): the paper's Qm.n power-of-two format
    # applied to the decode cache — K/V stored int8 with per-(pos, head)
    # exponents; attention probabilities re-quantized per-row to Q0.7
    # (exactly the coupling-coefficient pattern of the routing kernel).
    kv_cache_int8: bool = False
    # --- provenance ---------------------------------------------------------
    source: str = ""

    def __post_init__(self):
        assert self.num_layers % len(self.blocks) == 0, (
            f"{self.name}: pattern len {len(self.blocks)} must divide "
            f"num_layers {self.num_layers}")

    @property
    def num_cycles(self) -> int:
        return self.num_layers // len(self.blocks)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables are padded to a multiple of 256 so the
        16-way model axis (and data*model=256) always divides them
        (e.g. seamless 256206 -> 256256).  Logical vocab is unchanged."""
        return -(-self.vocab_size // 256) * 256

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def xlstm_inner(self) -> int:
        return self.xlstm_expand * self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """True if no block is unbounded full attention (cycled pattern)."""
        return all(m != "attn" for m, _ in self.blocks)

    @property
    def has_mostly_bounded_context(self) -> bool:
        """True if the arch is SSM/hybrid/local-attn enough for long_500k.

        gemma3 (5 local : 1 global), jamba (28 mamba : 4 attn) and mixtral
        (SWA everywhere) qualify; pure full-attention stacks do not.
        """
        n_full = sum(1 for m, _ in self.blocks if m == "attn")
        return n_full == 0 or n_full / len(self.blocks) <= 0.25

    def scaled(self, **kw) -> "ModelConfig":
        """Return a reduced copy (for smoke tests)."""
        return dataclasses.replace(self, **kw)

    # Rough parameter count (embeddings included), used for roofline
    # MODEL_FLOPS = 6 * N * D  (N_active for MoE).
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        qdim = self.num_heads * self.head_dim
        kdim = self.num_kv_heads * self.head_dim
        total = v * d + d * v  # embed + head (untied)
        if self.tie_embeddings:
            total -= d * v
        def block_params(mixer: str, ffn: str) -> int:
            p = 2 * d  # norms
            if mixer in ("attn", "swa"):
                p += d * (qdim + 2 * kdim) + qdim * d
                if self.qkv_bias:
                    p += qdim + 2 * kdim
            elif mixer == "mamba":
                ed, n, r = self.ssm_inner, self.ssm_state_dim, self.dt_rank
                p += d * 2 * ed + ed * self.ssm_conv_dim + ed * (r + 2 * n)
                p += r * ed + ed * n + ed + ed * d
            elif mixer == "mlstm":
                ed = self.xlstm_inner
                p += d * 2 * ed + 3 * ed * ed + 2 * ed * self.num_heads + ed * d
            elif mixer == "slstm":
                dh = d // self.num_heads
                p += 4 * d * d + 4 * self.num_heads * dh * dh
                p += 2 * d * (4 * d // 3)   # pf=4/3 FFN
            if ffn == "mlp":
                p += 3 * d * f
            elif ffn == "moe":
                e = self.num_experts if not active_only else self.experts_per_tok
                p += d * self.num_experts  # router (always resident)
                p += e * 3 * d * f
            return p
        per_cycle = sum(block_params(m, fk) for m, fk in self.blocks)
        total += per_cycle * self.num_cycles
        if self.is_encoder_decoder:
            # encoder self-attn+mlp plus decoder cross-attn per layer
            enc = self.num_encoder_layers * (
                d * (qdim + 2 * kdim) + qdim * d + 3 * d * f + 2 * d)
            cross = self.num_layers * (d * (qdim + 2 * kdim) + qdim * d + d)
            total += enc + cross
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}

ARCH_IDS = (
    "phi35_moe", "mixtral_8x22b", "qwen2_72b", "qwen3_14b", "gemma3_12b",
    "stablelm_3b", "paligemma_3b", "xlstm_1_3b", "jamba_v01_52b",
    "seamless_m4t_medium",
)

# long_500k runs only for archs with mostly bounded context (DESIGN.md §5).
def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.has_mostly_bounded_context:
        return False, "long_500k skipped: pure full-attention arch (DESIGN.md §5)"
    return True, ""


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
