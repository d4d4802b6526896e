"""Roofline terms of a dry-run cell on one H100; the counterpart of
`repro.launch.roofline`.

Hardware constants (H100 SXM data sheet, dense tensor-core rates):
  989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3; for the collective
  term NVLink 4 at 450 GB/s one way per card within a node, and
  InfiniBand NDR at 400 Gb/s = 50 GB/s one way per card (one NIC a card)
  across nodes.

The counts come from `repro_torch.dist.op_analysis` (trip-weighted, per
card), so:
  compute_term    = flops_per_dev / PEAK
  memory_term     = bytes_per_dev / HBM_BW
  collective_term = nvlink_bytes / LINK_BW + infiniband_bytes / IB_BW
where a collective's bytes are NVLink's when every rank of its group
lies on one node, else InfiniBand's (`op_analysis.fabric`);
`collective_bytes_per_dev` is their sum, as the reference's, and
`collectives.bytes_by_fabric` their split.
MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), 2*N*D forward-only, as
in the reference.  Its record's keys are the reference's but two:
`xla_cost_analysis_raw` is `flop_counter_raw` (the total of
`torch.utils.flop_counter.FlopCounterMode` over the ops that ran, not
trip-weighted: the counterpart of XLA's count of each loop body once) and
`n_whiles` is `n_loops`.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.dist.op_analysis import OpCost

PEAK_BF16 = 989e12      # FLOP/s per card, dense bf16 tensor cores
PEAK_INT8 = 1.979e15    # OP/s per card, dense int8 tensor cores
HBM_BW = 3.35e12        # B/s per card
LINK_BW = 450e9         # B/s one way per card, NVLink 4
IB_BW = 50e9            # B/s one way per card, InfiniBand NDR 400 Gb/s


def active_param_count(cfg: ModelConfig) -> int:
    """Non-embedding active parameters (MoE counts top-k experts only)."""
    n = cfg.param_count(active_only=True)
    n -= cfg.vocab_size * cfg.d_model          # input embedding
    return max(n, 1)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Useful model FLOPs per step, whole job (all cards)."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per row + attention over the cache
    flops = 2.0 * n * shape.global_batch
    per_layer_kv = {"attn": shape.seq_len,
                    "swa": min(cfg.window_size, shape.seq_len)}
    kv_positions = sum(per_layer_kv.get(m, 0)
                       for m, _ in cfg.blocks) * cfg.num_cycles
    flops += 4.0 * cfg.num_heads * cfg.head_dim * kv_positions \
        * shape.global_batch
    return flops


MEMORY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "alias_size_in_bytes",
                 "generated_code_size_in_bytes")


def analyze_cell(cost: OpCost, memory: dict, cfg: ModelConfig,
                 shape: ShapeSpec, chips: int, mesh_kind: str,
                 int8: bool = False, flop_counter_raw: float = 0.0) -> dict:
    """The reference's record of a cell from its `OpCost`, its memory
    dict (`MEMORY_FIELDS`) and FlopCounterMode's total; the int8 peak for
    the whole cell when int8, as the reference does."""
    peak = PEAK_INT8 if int8 else PEAK_BF16
    flops_dev = float(cost.flops)
    bytes_dev = float(cost.hbm_bytes)
    coll_dev = float(cost.collective_bytes)
    fabric = {f: float(cost.collective_bytes_by_fabric.get(f, 0.0))
              for f in ("nvlink", "infiniband")}
    mem = {f: int(memory.get(f, 0)) for f in MEMORY_FIELDS}
    hbm_dev = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
               + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])

    mf = model_flops(cfg, shape)
    terms = {
        "compute_s": flops_dev / peak,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": fabric["nvlink"] / LINK_BW
        + fabric["infiniband"] / IB_BW,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mfu = (mf / chips / peak) / bound if bound > 0 else 0.0
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
        "kind": shape.kind, "chips": chips,
        "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": coll_dev,
        "collectives": {"total_bytes": coll_dev,
                        "bytes_by_kind": cost.collective_bytes_by_kind,
                        "count_by_kind": cost.collective_count_by_kind,
                        "bytes_by_fabric": fabric},
        "flop_counter_raw": {"flops": float(flop_counter_raw)},
        "n_loops": cost.n_loops,
        "memory": mem, "hbm_bytes_per_dev": hbm_dev,
        "hbm_gib_per_dev": hbm_dev / 2**30,
        "model_flops_total": mf,
        "model_flops_per_dev": mf / chips,
        "useful_flop_ratio": (mf / chips) / flops_dev if flops_dev else 0.0,
        "terms": terms,
        "dominant": dominant,
        "roofline_fraction": mfu,
        "step_time_lower_bound_s": bound,
    }
