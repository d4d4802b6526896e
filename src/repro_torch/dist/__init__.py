"""Distribution layer of the port: the one-device subset of `repro.dist`.

Submodules:
  api — logical axis names (BATCH/SEQ), `shard`, and mesh introspection
        (`current_mesh`, `dp_size`, `fspec`) for a mesh of one device.

`sharding`, `fault` and `hlo_analysis` are not ported, and a mesh of more
than one device raises NotImplementedError (ROADMAP Queue A).
"""
