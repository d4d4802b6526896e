"""Distribution layer of the port: `repro.dist` over a
`torch.distributed` world of processes, data and tensor parallel.

Submodules:
  world    — the process-group life cycle JAX keeps implicit:
             `init_world` (torchrun's environment, or explicit ranks),
             the backend rule (NCCL only when every rank owns a card,
             gloo otherwise), `device_for_rank`, `shutdown`, and `spawn`
             (a world of child processes, for tests and the smoke run).
  api      — logical axis names (BATCH/SEQ), `Mesh` (a record of devices,
             or the ranks of a world, with its process groups), `shard`,
             mesh introspection (`current_mesh`, `dp_size`, `dp_rank`,
             `tp_size`, `tp_rank`, `fspec`), the explicit data-parallel
             collectives (`split_rows`, `gather_rows`, `gather_shares`,
             `all_reduce`, `agree`) and the model axis's autograd
             Functions (`copy_to`, `gather_along`, `reduce_sum`).
  sharding — the spec rules for params, optimizer state, batches and
             caches; `to_shardings`, and `local_shard` / `gather_tree`,
             which lay a tree out by its specs and back.
  fault    — `choose_mesh`, `run_with_restarts` and `StepTimer`.
  op_analysis — the counterpart of `hlo_analysis`: a trip-weighted
             count of a step's flops, bytes, collective bytes and ops,
             and its peak live bytes, read off the aten ops it
             dispatches (the port has no HLO).
"""
from repro_torch.dist.api import (BATCH, SEQ, Mesh, dp_rank, dp_size,
                                  gather_rows, gather_shares, split_rows,
                                  tp_rank, tp_size)
from repro_torch.dist.world import (World, current_world, device_for_rank,
                                    init_world, shutdown, spawn)

__all__ = ["BATCH", "SEQ", "Mesh", "World", "current_world",
           "device_for_rank", "dp_rank", "dp_size", "gather_rows",
           "gather_shares", "init_world", "shutdown", "spawn", "split_rows",
           "tp_rank", "tp_size"]
