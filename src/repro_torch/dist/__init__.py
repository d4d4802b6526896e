"""Distribution layer of the port: the one-device subset of `repro.dist`.

Submodules:
  api      — logical axis names (BATCH/SEQ), `shard`, and mesh
             introspection (`current_mesh`, `dp_size`, `fspec`) for a
             mesh of one device.
  sharding — the spec rules for params, optimizer state, batches and
             caches; `to_shardings` for a mesh of one device.
  fault    — `choose_mesh`, `run_with_restarts` and `StepTimer`.

`hlo_analysis` is not ported, and a mesh of more than one device raises
NotImplementedError (ROADMAP Queue A).
"""
