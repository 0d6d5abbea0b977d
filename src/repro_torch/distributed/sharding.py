"""Logical -> physical sharding resolution with divisibility fallbacks
(counterpart of ``repro/distributed/sharding.py``), over a
``torch.distributed.device_mesh.DeviceMesh``.

A spec names, for each tensor dimension, the mesh axis (or axes) it is
split over, or None: ``P("shard", None)`` splits dim 0 over the mesh's
"shard" axis. ``resolve_spec`` makes a spec legal for a shape on a mesh
with the JAX package's fallbacks: an axis the mesh lacks is dropped, and a
dimension the axis size does not divide is replicated. It returns one
placement per mesh dimension, as ``torch.distributed.tensor`` takes them:
``Shard(d)`` where the axis splits tensor dim d, ``Replicate()`` where it
splits none.

``resolve_spec`` and ``resolve_tree`` read only the mesh's axis names and
sizes (``mesh_dim_names``, ``shape``), so they take any object that has
them. ``constrain`` and ``shardings_tree`` serve the sharded LM and are not
ported yet (ROADMAP A6).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Sequence

from torch.distributed.tensor import Replicate, Shard

__all__ = ["P", "current_mesh", "use_mesh", "resolve_entries",
           "resolve_spec", "resolve_tree", "tree_flatten", "tree_unflatten"]

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dimension, each a mesh axis
    name, a tuple of names, or None (the JAX package's ``PartitionSpec``).
    A tuple subclass, so a spec is a leaf of a spec tree."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def current_mesh():
    """The mesh of the innermost ``use_mesh``, else the mesh of an active
    ``with mesh:`` block, else None."""
    mesh = getattr(_state, "mesh", None)
    if mesh is not None:
        return mesh
    from torch.distributed import device_mesh
    stack = getattr(getattr(device_mesh, "_mesh_resources", None),
                    "mesh_stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= _axis_size(sizes, a)
        return n
    return sizes.get(axis, 0)                  # 0 = axis absent


def _clean_axis(sizes: dict, axis):
    """Drop absent axes from an entry; None if nothing remains."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in sizes)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in sizes else None


def resolve_entries(mesh, spec: Sequence, shape: Sequence[int]) -> P:
    """``spec`` made legal for ``shape`` on ``mesh``, as a spec: absent axes
    dropped, dims the axis size does not divide replicated (None). The JAX
    package's ``resolve_spec``, entry for entry."""
    sizes = _sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries[:len(shape)]):
        axis = _clean_axis(sizes, axis)
        n = _axis_size(sizes, axis)
        out.append(axis if axis is not None and n > 0 and dim % max(n, 1) == 0
                   else None)
    return P(*out)


def resolve_spec(mesh, spec: Sequence, shape: Sequence[int]) -> tuple:
    """The placements of ``shape`` on ``mesh`` under ``spec``, after the
    fallbacks of ``resolve_entries``: one per mesh dimension, ``Shard(d)``
    where that mesh axis splits tensor dim d, else ``Replicate()``."""
    entries = resolve_entries(mesh, spec, shape)
    placements = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(entries)
                if e == name or (isinstance(e, tuple) and name in e)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return tuple(placements)


def tree_flatten(tree, is_leaf=None) -> tuple[list, Any]:
    """(leaves, structure) of a tree of dicts, lists, tuples and
    NamedTuples; the structure pickles (NamedTuple types by reference)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree], None
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [tree_flatten(tree[k], is_leaf) for k in keys]
        return ([x for p in parts for x in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [tree_flatten(v, is_leaf) for v in tree]
        return ([x for p in parts for x in p[0]],
                ("namedtuple", type(tree), [p[1] for p in parts]))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        parts = [tree_flatten(v, is_leaf) for v in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree).__name__, None, [p[1] for p in parts]))
    return [tree], None


def tree_unflatten(structure, leaves: list):
    """The inverse of ``tree_flatten``."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, meta, children = s
        vals = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(meta, vals))
        if kind == "namedtuple":
            return meta(*vals)
        return list(vals) if kind == "list" else tuple(vals)
    return build(structure)


def resolve_tree(mesh, params: Any, specs: Any) -> Any:
    """Pairwise ``resolve_spec`` of a spec tree against a tree of tensors
    (or of shapes)."""
    shapes, structure = tree_flatten(
        params, is_leaf=lambda x: hasattr(x, "shape")
        or (isinstance(x, tuple) and all(isinstance(d, int) for d in x)))
    spec_leaves, _ = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))
    if len(spec_leaves) != len(shapes):
        raise ValueError(f"{len(spec_leaves)} specs for {len(shapes)} "
                         f"leaves")
    return tree_unflatten(structure, [
        resolve_spec(mesh, s, p.shape if hasattr(p, "shape") else tuple(p))
        for p, s in zip(shapes, spec_leaves)])
