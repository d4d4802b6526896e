"""Distribution layer of the port: the one-device subset of `repro.dist`.

Submodules:
  api      — logical axis names (BATCH/SEQ), `shard`, and mesh
             introspection (`current_mesh`, `dp_size`, `fspec`) for a
             mesh of one device.
  sharding — the spec rules for params, optimizer state, batches and
             caches; `to_shardings` for a mesh of one device.
  fault    — `choose_mesh`, `run_with_restarts` and `StepTimer`.
  op_analysis — the counterpart of `hlo_analysis`: a trip-weighted
             count of a step's flops, bytes, collective bytes and ops,
             and its peak live bytes, read off the aten ops it
             dispatches (the port has no HLO).

A mesh of more than one device raises NotImplementedError (ROADMAP
Queue A, multi-card).
"""
