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
tuples); `to_shardings` filters a spec to a mesh's axes.

Over a mesh of a world, `local_shard(tree, specs, mesh)` keeps this
rank's contiguous share of every axis a spec names (`api.row_share`
along the line of the named axes, uneven or empty where the axis does
not divide) and `gather_tree` is its inverse.  A W8A8 leaf {"qt", "n"}
splits N, qt on axis -2 and n on -1; its exponents are per output
channel, so the share of a quantized leaf is the quantized leaf of the
share.  Every tree the models run on is laid out by these specs,
caches included: the recurrent mixers' caches too (mamba's conv window
[B, kc-1, ED] splits its axis 1, its state [B, ED, N] and the sLSTM's
[B, D] their axis 1, the mLSTM's C, n and m their heads), although
their recurrences run on whole states: a decode step gathers the state
of its layer, steps it on every rank of the line, and keeps the share
(`models.transformer`).
"""
from __future__ import annotations

import torch

from repro_torch.dist import api
from repro_torch.dist.api import BATCH, dp_size, fspec
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


def dp_shardable(global_batch: int, mesh) -> bool:
    dp = dp_size(mesh)
    return dp > 1 and global_batch % dp == 0 and global_batch >= dp


def batch_specs(batch, global_batch: int, mesh):
    """Shard the leading axis of every batch leaf over DP when it divides."""
    shardable = dp_shardable(global_batch, mesh)

    def spec(leaf):
        if shardable and len(leaf.shape) >= 1 \
                and leaf.shape[0] == global_batch:
            return (BATCH,) + (None,) * (len(leaf.shape) - 1)
        return ()

    return tree_map(spec, batch)


def cache_specs(cache, global_batch: int, mesh, stacked: bool = True):
    """Decode-cache specs (stacked caches carry a leading layer axis)."""
    off = 1 if stacked else 0
    b_ax, s_ax = (BATCH, "model") if dp_shardable(global_batch, mesh) \
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
    reference's NamedSharding)."""
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


def zip_specs(fn, tree, specs):
    """fn(leaf, spec) over the leaves of `tree` and the specs at the same
    places of the spec tree `specs`, in a tree of `tree`'s structure."""
    if is_leaf(tree):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: zip_specs(fn, tree[k], specs[k]) for k in sorted(tree)}
    return tuple(zip_specs(fn, v, s) for v, s in zip(tree, specs))


def flat_specs(tree, specs) -> list:
    """The specs of `tree`'s leaves, in `leaves(tree)` order."""
    out = []
    zip_specs(lambda _, spec: out.append(spec), tree, specs)
    return out


def _split_axes(spec, mesh):
    """[(axis of the leaf, the mesh axes that split it)] of `spec`, for
    the entries naming axes of more than one device."""
    out = []
    for i, ent in enumerate(spec):
        if ent is None:
            continue
        axes = (ent,) if isinstance(ent, str) else tuple(ent)
        if mesh.ways(axes) > 1:
            out.append((i, axes))
    return out


def local_shard(tree, specs, mesh):
    """This rank's share of a full tree laid out by `specs`: along each
    axis a spec names, the `api.row_share` of this rank's index on the
    line of those axes (views of the full leaves; clone them to free the
    rest).  The tree itself with no mesh or a mesh of one device."""
    if mesh is None or mesh.size == 1:
        return tree

    def leaf(t, spec):
        for i, axes in _split_axes(spec, mesh):
            lo, hi = api.row_share(t.shape[i], mesh.ways(axes),
                                   mesh.index(axes))
            t = t.narrow(i, lo, hi - lo)
        return t
    return zip_specs(leaf, tree, specs)


def gather_leaf(t, spec, mesh):
    """The full leaf of which every rank holds its `local_shard` share,
    on every rank of its lines (no gradient).  The shares' sizes are
    gathered first, so they may be uneven."""
    for i, axes in _split_axes(spec, mesh):
        group = mesh.group(axes)
        n = torch.tensor([t.shape[i]], dtype=torch.int64)
        sizes = [int(p) for p in api.gather_parts(n, group)]
        t = api.gather_cat(t.detach(), i, sizes, group)
    return t


def gather_tree(tree, specs, mesh):
    """The inverse of `local_shard`: every leaf whole on every rank
    (`gather_leaf`).  The tree itself with no mesh or a mesh of one
    device."""
    if mesh is None or mesh.size == 1:
        return tree
    return zip_specs(lambda t, spec: gather_leaf(t, spec, mesh), tree, specs)
