"""Distribution layer of the port: the data-parallel subset of
`repro.dist`, over a `torch.distributed` world of processes.

Submodules:
  world    — the process-group life cycle JAX keeps implicit:
             `init_world` (torchrun's environment, or explicit ranks),
             the backend rule (NCCL only when every rank owns a card,
             gloo otherwise), `device_for_rank`, `shutdown`, and `spawn`
             (a world of child processes, for tests and the smoke run).
  api      — logical axis names (BATCH/SEQ), `Mesh` (a record of devices,
             or the ranks of a world), `shard`, mesh introspection
             (`current_mesh`, `dp_size`, `dp_rank`, `fspec`), and the
             explicit data-parallel collectives (`split_rows`,
             `gather_rows`, `gather_shares`, `all_reduce`, `agree`).
  sharding — the spec rules for params, optimizer state, batches and
             caches; `to_shardings` for a data-parallel mesh.
  fault    — `choose_mesh`, `run_with_restarts` and `StepTimer`.
  op_analysis — the counterpart of `hlo_analysis`: a trip-weighted
             count of a step's flops, bytes, collective bytes and ops,
             and its peak live bytes, read off the aten ops it
             dispatches (the port has no HLO).

A mesh whose `model` axis is larger than 1 (tensor parallelism) raises
NotImplementedError (ROADMAP Queue A, multi-card).
"""
from repro_torch.dist.api import (BATCH, SEQ, Mesh, dp_rank, dp_size,
                                  gather_rows, gather_shares,
                                  require_data_parallel, split_rows)
from repro_torch.dist.world import (World, current_world, device_for_rank,
                                    init_world, shutdown, spawn)

__all__ = ["BATCH", "SEQ", "Mesh", "World", "current_world",
           "device_for_rank", "dp_rank", "dp_size", "gather_rows",
           "gather_shares", "init_world", "require_data_parallel",
           "shutdown", "spawn", "split_rows"]
