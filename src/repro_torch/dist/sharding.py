"""Partition-spec rules for every tree the launch layer ships to
devices; the counterpart of `repro.dist.sharding`.

A spec is the tuple `api.fspec` returns, one entry per axis of the leaf
(None, an axis name, or a tuple of names), the contents of the
reference's `PartitionSpec`; `()` replicates.  The policy is the
reference's:
  params     — tensor parallel: the trailing (output-feature) axis of
               every >=2D weight shards over "model"; vectors replicate.
  opt state  — moment trees mirror the param rule; scalars replicate.
  batches    — leading axis over the BATCH (pod x data) axes when the
               global batch divides the DP ways, else replicated.
  caches     — batch over DP plus seq over "model" when the batch
               shards, otherwise seq over ("data", "model").
Spec trees take their structure from the tree they describe (dicts and
tuples); `to_shardings` filters a spec to a mesh's axes.  Data-parallel
meshes are ported (each rank holds its share of the BATCH axes and the
whole of every other axis); a mesh that splits the model axis raises
(ROADMAP Queue A, multi-card).
"""
from __future__ import annotations

from repro_torch.dist.api import (BATCH, dp_size, fspec,
                                  require_data_parallel)
from repro_torch.tree import is_leaf, tree_map


def _leaf_spec(leaf) -> tuple:
    if len(leaf.shape) >= 2 and leaf.shape[-1] > 1:
        return (None,) * (len(leaf.shape) - 1) + ("model",)
    return ()


def param_specs(tree):
    """One spec per parameter leaf (ndim-matched, see policy).  A W8A8
    leaf {"qt", "n"} stores W K-major ([..., N, K]), so its qt shards
    the same output axis as the reference's q [..., K, N]."""
    if isinstance(tree, dict) and set(tree) == {"qt", "n"}:
        spec = _leaf_spec(tree["qt"].transpose(-1, -2))   # q's spec
        return {"n": _leaf_spec(tree["n"]),
                "qt": spec and spec[:-2] + (spec[-1], spec[-2])}
    if isinstance(tree, dict):
        return {k: param_specs(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(param_specs(v) for v in tree)
    return _leaf_spec(tree)


def _structure(tree):
    if is_leaf(tree):
        return None
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return tuple(_structure(v) for v in tree)


def opt_state_specs(opt_state, params):
    """Specs for an optimizer-state dict: entries shaped like the param
    tree (m/v moments) inherit param specs; everything else replicates."""
    ptree = _structure(params)

    def per_entry(sub):
        if _structure(sub) == ptree:
            return param_specs(sub)
        return tree_map(lambda _: (), sub)

    return {k: per_entry(v) for k, v in opt_state.items()}


def _dp_shardable(global_batch: int, mesh) -> bool:
    dp = dp_size(mesh)
    return dp > 1 and global_batch % dp == 0 and global_batch >= dp


def batch_specs(batch, global_batch: int, mesh):
    """Shard the leading axis of every batch leaf over DP when it divides."""
    shardable = _dp_shardable(global_batch, mesh)

    def spec(leaf):
        if shardable and len(leaf.shape) >= 1 \
                and leaf.shape[0] == global_batch:
            return (BATCH,) + (None,) * (len(leaf.shape) - 1)
        return ()

    return tree_map(spec, batch)


def cache_specs(cache, global_batch: int, mesh, stacked: bool = True):
    """Decode-cache specs (stacked caches carry a leading layer axis)."""
    off = 1 if stacked else 0
    b_ax, s_ax = (BATCH, "model") if _dp_shardable(global_batch, mesh) \
        else (None, ("data", "model"))

    def spec(leaf):
        nd = len(leaf.shape)
        if nd < off + 2:
            return ()
        ent = [None] * nd
        ent[off] = b_ax
        ent[off + 1] = s_ax
        return tuple(ent)

    return tree_map(spec, cache)


def to_shardings(spec: tuple, mesh) -> tuple:
    """A spec filtered to the axes `mesh` has (the spec of the
    reference's NamedSharding); a mesh whose model axis is larger than 1
    raises NotImplementedError."""
    require_data_parallel(mesh)
    return fspec(mesh, *spec)


def is_spec(x) -> bool:
    """Whether `x` is a spec: a tuple of None, axis names, and tuples of
    axis names (the empty tuple replicates)."""
    def entry(e):
        return e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
    return isinstance(x, tuple) and all(map(entry, x))


def map_specs(fn, tree):
    """fn over the specs of a spec tree (dicts and tuples of specs), in
    flattening order (dict keys sorted)."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k]) for k in sorted(tree)}
    return tuple(map_specs(fn, v) for v in tree)
