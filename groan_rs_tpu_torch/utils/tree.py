"""Nested containers of arrays ("trees"): the part of `jax.tree` the
map-reduce engine and its checkpoints use.

A tree is a dict (its keys visited in sorted order, as `jax.tree` does),
list or tuple of trees, or a leaf (a tensor, array or number); None is an
empty tree.
"""

from __future__ import annotations

__all__ = ["tree_flatten", "tree_unflatten", "tree_map"]


def tree_flatten(tree):
    """-> (leaves in order, spec that `tree_unflatten` rebuilds from)."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return [x for p in parts for x in p[0]], ("dict", keys, [p[1] for p in parts])
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(x) for x in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree).__name__, len(tree), [p[1] for p in parts]))
    return [tree], "leaf"


def _count(spec) -> int:
    if spec is None:
        return 0
    if spec == "leaf":
        return 1
    return sum(_count(s) for s in spec[2])


def tree_unflatten(spec, leaves):
    leaves = list(leaves)
    if spec is None:
        return None
    if spec == "leaf":
        return leaves[0]
    kind, keys, subs = spec
    out, off = [], 0
    for s in subs:
        n = _count(s)
        out.append(tree_unflatten(s, leaves[off:off + n]))
        off += n
    if kind == "dict":
        return dict(zip(keys, out))
    return tuple(out) if kind == "tuple" else out


def tree_map(fn, tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(x) for x in leaves])
