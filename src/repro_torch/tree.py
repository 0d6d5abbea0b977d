"""Trees of tensors in the JAX package's leaf order.

The port's param and optimizer trees are dicts, lists, tuples and
NamedTuples around tensors, with None for an absent subtree, as the JAX
package's pytrees are. These functions walk them as ``jax.tree_util`` does:
a dict's keys in sorted order, a sequence's items in order, a NamedTuple's
fields in order, None holding no leaf. That order is what a manifest
checkpoint lists its leaves in, so a checkpoint written by either package
restores in the other (``checkpoint/manifest.py``); the optimizer and the
trainers pair the leaves of their trees by it.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "leaves_with_paths", "unflatten_like", "tree_map"]


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key string, child) of a node as ``jax.tree_util.keystr`` spells its
    key, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's order; a path is what
    ``jax.tree_util.keystr`` gives for it, e.g. ``['p']['embed']``."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for key, child in kids
            for pl in leaves_with_paths(child, prefix + key)]


def leaves(tree) -> list:
    """The leaves in the JAX package's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten_like(like, new_leaves: list):
    """A tree of ``like``'s structure holding ``new_leaves`` in the order
    ``leaves(like)`` lists ``like``'s (dicts keep ``like``'s key order)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure), in a tree of ``tree``'s structure."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    if any(len(o) != len(mine) for o in others):
        raise ValueError("trees of different leaf counts")
    return unflatten_like(tree, [fn(*xs) for xs in zip(mine, *others)])
