"""Nested dicts of tensors as trees: the port's counterpart of the few
`jax.tree_util` calls the training code makes.

Leaves are visited in sorted key order, as `jax.tree_util` flattens a
dict, and an empty dict holds no leaf; a leaf's path is its keys joined
by "/", the form `repro.ckpt` writes into a checkpoint.
"""
from __future__ import annotations


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf), ...] in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaves_with_paths(tree[k], f"{prefix}/{k}" if prefix
                                 else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (same structure), in a tree of `tree`'s structure; leaves are
    visited in sorted key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """A tree of `tree`'s structure holding `new_leaves` (in the order
    `leaves(tree)` gives)."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)
