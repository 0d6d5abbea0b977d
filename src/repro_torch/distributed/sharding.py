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

``resolve_spec``, ``resolve_tree`` and ``shardings_tree`` read only the
mesh's axis names and sizes (``mesh_dim_names``, ``shape``), so they take
any object that has them (``launch.mesh.production_shape``: accounting on
the production shapes without processes).

``constrain`` is the sharded LM's layout change (the JAX package's
``with_sharding_constraint``). The port runs one process a rank on plain
local tensors, so no propagation decides a layout: the caller says how its
local tensor lies (``have``: the resolved entries of its split dims;
``partial``: the mesh axis over which it is a partial sum), and
``constrain`` issues the one collective that turns that layout into the
target, resolved with ``resolve_entries``' fallbacks on the tensor's global
shape:

  partial -> replicated  all_reduce         split -> replicated  all_gather
  partial -> split       reduce_scatter     replicated -> split  a local slice

Outside a mesh it returns its input and issues nothing. Collectives run
in the tensor's dtype on the mesh's device type (gloo: staged through
host memory) and are counted by kind (``collectives``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

__all__ = ["P", "NamedSharding", "Collectives", "current_mesh", "use_mesh",
           "resolve_entries", "resolve_spec", "resolve_tree",
           "shardings_tree", "tree_flatten", "tree_unflatten", "constrain",
           "collectives", "axis_size", "axis_index", "local_shape",
           "block_of", "blocks_of", "broadcast_from", "staged"]

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dimension, each a mesh axis
    name, a tuple of names, or None (the JAX package's ``PartitionSpec``).
    A tuple subclass, so a spec is a leaf of a spec tree."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A leaf's layout on a mesh (the JAX package's ``NamedSharding``):
    ``mesh``, ``spec`` (the resolved spec, which keeps the order of the
    axes that split one dim) and ``placements`` (``resolve_spec``'s, one
    per mesh dimension). ``elastic.place`` takes a tree of these in place
    of a tree of specs."""
    mesh: Any
    spec: "P"
    placements: tuple


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
    """(leaves, structure) of a tree of dicts, lists, tuples, NamedTuples
    and dataclasses (fields in order); the structure pickles (NamedTuple
    and dataclass types by reference). A dict's leaves come in its keys'
    sorted order, as JAX flattens it, so a tree and its spec tree pair
    leaf for leaf whatever order their dicts were built in; unflattening
    rebuilds each dict in its own key order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k], is_leaf) for k in keys]
        return ([x for p in parts for x in p[0]],
                ("dict", (keys, list(tree)), [p[1] for p in parts]))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = [f.name for f in dataclasses.fields(tree)]
        parts = [tree_flatten(getattr(tree, f), is_leaf) for f in fields]
        return ([x for p in parts for x in p[0]],
                ("dataclass", type(tree), [p[1] for p in parts]))
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
            got = dict(zip(meta[0], vals))
            return {k: got[k] for k in meta[1]}
        if kind in ("namedtuple", "dataclass"):
            return meta(*vals)
        return list(vals) if kind == "list" else tuple(vals)
    return build(structure)


def _is_shape(x) -> bool:
    return hasattr(x, "shape") or (
        type(x) is tuple and all(isinstance(d, int) for d in x))


def resolve_tree(mesh, params: Any, specs: Any) -> Any:
    """Pairwise ``resolve_spec`` of a spec tree against a tree of tensors
    (or of shapes)."""
    shapes, structure = tree_flatten(params, is_leaf=_is_shape)
    spec_leaves, _ = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))
    if len(spec_leaves) != len(shapes):
        raise ValueError(f"{len(spec_leaves)} specs for {len(shapes)} "
                         f"leaves")
    return tree_unflatten(structure, [
        resolve_spec(mesh, s, p.shape if hasattr(p, "shape") else tuple(p))
        for p, s in zip(shapes, spec_leaves)])


def shardings_tree(mesh, params: Any, specs: Any) -> Any:
    """A ``NamedSharding`` for every leaf of ``params`` (tensors, meta
    tensors or shapes) under its spec, resolved with ``resolve_entries``'
    fallbacks: what ``elastic.place`` consumes, and what accounting reads
    (``launch/anns_step.footprint``)."""
    shapes, structure = tree_flatten(params, is_leaf=_is_shape)
    spec_leaves, _ = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))
    if len(spec_leaves) != len(shapes):
        raise ValueError(f"{len(spec_leaves)} specs for {len(shapes)} "
                         f"leaves")
    out = []
    for p, s in zip(shapes, spec_leaves):
        shape = p.shape if hasattr(p, "shape") else tuple(p)
        out.append(NamedSharding(mesh, resolve_entries(mesh, s, shape),
                                 resolve_spec(mesh, s, shape)))
    return tree_unflatten(structure, out)


# ---------------------------------------------------------------------------
# constrain: the layout changes of the sharded LM, as explicit collectives
# ---------------------------------------------------------------------------

class Collectives:
    """Counts of collectives on this rank: by kind, the calls and the bytes
    of the tensors this rank holds after each call."""

    def __init__(self):
        self.counts: dict[str, list[int]] = {}

    def reset(self) -> None:
        self.counts = {}

    def _add(self, kind: str, nbytes: int) -> None:
        c = self.counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += int(nbytes)

    def as_dict(self) -> dict:
        return {k: {"calls": c, "bytes": b}
                for k, (c, b) in sorted(self.counts.items())}


_COUNTS = Collectives()


def collectives() -> Collectives:
    """The sharded LM's collectives on this rank since the last
    ``reset()``: every ``constrain`` and ``broadcast_from`` call that
    moved data, by kind."""
    return _COUNTS


def axis_size(axis, mesh=None) -> int:
    """Ranks along mesh axis ``axis`` (1 when it is absent or there is no
    mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis is None:
        return 1
    return _sizes(mesh).get(axis, 1)


def axis_index(axis, mesh=None) -> int:
    """This rank's coordinate along ``axis`` (0 when absent)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis not in _sizes(mesh):
        return 0
    return mesh.get_local_rank(axis)


def _single(entry, what: str):
    """The one mesh axis of a resolved entry; a dim split over several
    axes at once moves through no collective here."""
    if isinstance(entry, tuple):
        if len(entry) != 1:
            raise NotImplementedError(
                f"{what} of a dim split over {entry} at once is not ported: "
                f"ROADMAP A6 (the sharded LM)")
        return entry[0]
    return entry


def _factor(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes.get(a, 1) for a in axes)


def _global_shape(shape: Sequence[int], have: Sequence, mesh=None) -> tuple:
    """The global shape of a local block of ``shape`` laid out as ``have``
    (resolved entries, one a dim)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return tuple(shape)
    sizes = _sizes(mesh)
    have = list(have) + [None] * (len(shape) - len(have))
    return tuple(n * _factor(sizes, e) for n, e in zip(shape, have))


def local_shape(shape: Sequence[int], spec: Sequence, mesh=None) -> tuple:
    """The block of a global ``shape`` that a rank holds under ``spec``,
    resolved on the current mesh (``shape`` itself without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return tuple(shape)
    sizes = _sizes(mesh)
    res = resolve_entries(mesh, spec, shape)
    return tuple(n // _factor(sizes, e) for n, e in zip(shape, res))


def block_of(x: torch.Tensor, spec: Sequence, mesh=None) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` resolved
    on the mesh (``x`` itself without a mesh): a view, no collective."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return x
    res = resolve_entries(mesh, spec, x.shape)
    for d, e in enumerate(res):
        if e is not None:
            x = _slice_dim(x, mesh, _single(e, "a slice"), d)
    return x


def _is_leaf(x) -> bool:
    return x is None or hasattr(x, "shape") or isinstance(x, P)


def blocks_of(tree: Any, specs: Any, mesh=None) -> Any:
    """``block_of`` of every leaf of ``tree`` under its spec in ``specs``
    (a tree of the same structure; None subtrees pass through): a rank's
    share of a tree every rank holds whole, with no collective, each
    block a contiguous copy."""
    mesh = mesh if mesh is not None else current_mesh()
    leaves, structure = tree_flatten(tree, is_leaf=_is_leaf)
    spec_leaves, _ = tree_flatten(specs, is_leaf=_is_leaf)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                         f"leaves")
    return tree_unflatten(structure, [
        None if x is None else block_of(x, s, mesh).contiguous()
        for x, s in zip(leaves, spec_leaves)])


def _slice_dim(x: torch.Tensor, mesh, axis, d: int) -> torch.Tensor:
    n = axis_size(axis, mesh)
    size = x.shape[d] // n
    return x.narrow(d, axis_index(axis, mesh) * size, size)


def staged(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` contiguous on the device the mesh's collectives run on (gloo:
    the host)."""
    return x.to(mesh.device_type).contiguous()


def _all_reduce(x, mesh, axis):
    buf = x.to(mesh.device_type, copy=True).contiguous()
    dist.all_reduce(buf, group=mesh.get_group(axis))
    _COUNTS._add("all_reduce", buf.nbytes)
    return buf.to(x.device)


def _all_gather(x, mesh, axis, d):
    xs = staged(x.movedim(d, 0), mesh)
    out = xs.new_empty((axis_size(axis, mesh) * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=mesh.get_group(axis))
    _COUNTS._add("all_gather", out.nbytes)
    return out.to(x.device).movedim(0, d).contiguous()


def _reduce_scatter(x, mesh, axis, d):
    xs = staged(x.movedim(d, 0), mesh)
    out = xs.new_empty((xs.shape[0] // axis_size(axis, mesh),
                        *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=mesh.get_group(axis))
    _COUNTS._add("reduce_scatter", out.nbytes)
    return out.to(x.device).movedim(0, d).contiguous()


def constrain(x: torch.Tensor, *spec_entries, have: Sequence = (),
              partial: str | None = None) -> torch.Tensor:
    """``x`` in the layout ``spec_entries`` resolve to on its global shape
    (the JAX package's ``constrain``, ``sharding.py:103-110``): ``x`` is
    this rank's block laid out as ``have`` (resolved entries; a dim left
    out is whole) and, with ``partial``, a partial sum over that mesh
    axis. One collective a transition (see the module's docstring): a
    partial sum is reduced first (scattered onto the target's dim split
    over the same axis, else all-reduced), then each dim whose entry
    changes is gathered and / or sliced. Returns ``x`` itself without a
    mesh, or when nothing changes."""
    mesh = current_mesh()
    if mesh is None:
        return x
    sizes = _sizes(mesh)
    have = list(have) + [None] * (x.ndim - len(have))
    want = list(resolve_entries(mesh, spec_entries,
                                _global_shape(x.shape, have, mesh)))
    if partial is not None and sizes.get(partial, 1) > 1:
        dims = [d for d, e in enumerate(want) if e == partial
                and have[d] is None]
        if dims:
            x = _reduce_scatter(x, mesh, partial, dims[0])
            have[dims[0]] = partial
        else:
            x = _all_reduce(x, mesh, partial)
    for d, (h, w) in enumerate(zip(have, want)):
        if h == w:
            continue
        if h is not None and _factor(sizes, h) > 1:
            x = _all_gather(x, mesh, _single(h, "a gather"), d)
        if w is not None and _factor(sizes, w) > 1:
            x = _slice_dim(x, mesh, _single(w, "a slice"), d).contiguous()
    return x


def broadcast_from(x: torch.Tensor, axis: str, index: int) -> torch.Tensor:
    """``x`` as the rank at coordinate ``index`` along ``axis`` holds it,
    on every rank of this rank's group along ``axis`` (each passes a
    tensor of the same shape and type); ``x`` itself without a mesh or
    when the axis has one rank."""
    mesh = current_mesh()
    if mesh is None or axis_size(axis, mesh) == 1:
        return x
    group = mesh.get_group(axis)
    buf = x.to(mesh.device_type, copy=True).contiguous()
    dist.broadcast(buf, group=group,
                   src=dist.get_global_rank(group, index))
    _COUNTS._add("broadcast", buf.nbytes)
    return buf.to(x.device)
