"""Nested dicts, lists and tuples of tensors: the port's parameter,
optimizer-state and checkpoint trees.

The JAX package handles these with ``jax.tree``; the port keeps the same
order: a dict's entries by sorted key, a list's or tuple's in order, so
a leaf's path (and a checkpoint's file names) read the same in both
packages.  ``None`` is an empty subtree, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves_with_path", "leaves", "tree_map", "unflatten"]


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_path(tree) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` in flattening order; a path is the tuple of dict
    keys and list indices from the root."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for key, child in kids:
            walk(child, path + (key,))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` in flattening order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (the same structure), leaf by leaf."""
    others = [leaves(t) for t in rest]
    mine = leaves(tree)
    if any(len(o) != len(mine) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*args) for args in zip(mine, *others)])
