"""Nested dicts and tuples of tensors as trees: the port's counterpart of
the few `jax.tree_util` calls the training code makes.

Leaves are visited as `jax.tree_util` flattens a tree: a dict in sorted
key order, a tuple (or list) in index order; an empty dict or tuple
holds no leaf.  A leaf's path is its keys and indices joined by "/"
(`params/blocks/0/attn/wq`), the form `repro.ckpt` writes into a
checkpoint.  `tree_map` keeps tuples as tuples.
"""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, tuple, list))


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf), ...] in flattening order."""
    if is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for k, sub in _children(tree):
        out += leaves_with_paths(sub, f"{prefix}/{k}" if prefix else k)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (same structure), in a tree of `tree`'s structure; leaves are
    visited in flattening order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """A tree of `tree`'s structure holding `new_leaves` (in the order
    `leaves(tree)` gives)."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)
