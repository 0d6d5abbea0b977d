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
host memory) and are counted by kind (``collectives``), those of a
backward too.

Gradients (the sharded train step). Every collective is differentiable,
under one rule for cotangents: a replicated tensor's cotangent is the
whole cotangent, the same on every rank; a split tensor's is the rank's
block; a partial sum's is the whole cotangent of the sum. The transposes:

  partial -> replicated  identity           split -> replicated  slice
  partial -> split       all_gather         replicated -> split  all_gather

A replicated tensor read by compute split over an axis (a column-parallel
product, one head block of a replicated K / V, a param used on rows split
over the axis) gets from it only a partial sum of its cotangent. Where
such a tensor enters that compute, ``sum_grad`` all-reduces its gradient
(Megatron's "f": the identity forward, an all_reduce backward); inside
the compute, until its row-parallel output is reduced, replicated tensors
carry partial cotangents, and a ``constrain`` there says so
(``grad_partial``): its transposes are then the exact adjoints,

  partial -> replicated  all_reduce         split -> replicated  reduce_scatter
  replicated -> split    zeros outside the rank's block

(Megatron-SP's entry is that all_gather, a reduce_scatter backward). A
replicated value with a whole cotangent handed into such compute goes
through ``grad_once`` (kept on the axis' first rank). ``psum`` reduces
over the batch axes, ('pod', 'data') in one group over both.

Accounting (the dry-run, ``launch/dryrun.py``): an ``AccountingMesh`` is
a mesh with no processes, its axis names and sizes and one rank's
coordinate on it (the origin unless told). Under ``use_mesh`` of one the
model runs unchanged on meta tensors as that rank: every collective
returns a meta tensor of the shape the real one returns and adds the
bytes the real one adds to ``collectives()``, ``axis_index`` gives the
rank's coordinate, and nothing is sent. It is never chosen for a caller:
a caller passes it.

Every rank builds the same graph, so autograd issues the backward's
collectives in one order on all of them (its sequence numbers order
independent branches alike), and remat's recompute issues the forward's
again as it meets them; a rank whose order differed would wait, and the
group's timeout (``launch/mesh.TIMEOUT_S``) turns that into a failure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import pickle
import threading
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

__all__ = ["P", "NamedSharding", "Collectives", "AccountingMesh",
           "is_accounting",
           "current_mesh", "use_mesh",
           "resolve_entries", "resolve_spec", "resolve_tree",
           "shardings_tree", "tree_flatten", "tree_unflatten", "constrain",
           "collectives", "axis_size", "axis_index", "local_shape",
           "block_of", "blocks_of", "broadcast_from", "staged", "sum_grad",
           "grad_once", "psum", "all_reduce", "all_gather", "gather_whole",
           "broadcast_object",
           "fsdp_specs"]

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


class AccountingMesh:
    """A mesh with no processes: axis names, sizes and the coordinate of
    the one rank whose program runs (the origin by default). Its device
    type is "meta": the collectives of this module run on it as meta
    tensors and count what the real ones count (the module's docstring).
    """

    device_type = "meta"

    def __init__(self, names: Sequence[str], shape: Sequence[int],
                 coord: Sequence[int] | None = None):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(int(n) for n in shape)
        self.coord = tuple(coord) if coord is not None else \
            (0,) * len(self.shape)
        if len(self.mesh_dim_names) != len(self.shape) or \
                len(self.coord) != len(self.shape) or \
                not all(0 <= c < n for c, n in zip(self.coord, self.shape)):
            raise ValueError(f"accounting mesh {self.shape} over "
                             f"{self.mesh_dim_names} at {self.coord}")
        self.mesh = torch.arange(math.prod(self.shape)).reshape(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)

    def get_local_rank(self, axis: str) -> int:
        return self.coord[self.mesh_dim_names.index(axis)]

    def get_coordinate(self) -> list[int]:
        return list(self.coord)

    def __repr__(self) -> str:
        return (f"AccountingMesh({self.mesh_dim_names}, {self.shape}, "
                f"coord={self.coord})")


def is_accounting(mesh) -> bool:
    """Whether ``mesh`` is an ``AccountingMesh`` (no processes)."""
    return isinstance(mesh, AccountingMesh)



def _meta(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=like.dtype, device="meta")


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


def fsdp_specs(specs: Any, shapes: Any, mesh) -> Any:
    """ZeRO-3 / FSDP (the JAX package's dry-run ``_apply_fsdp``): every
    weight of two dims or more also split over 'data', by three
    preferences: a tensor that stays over 256 MB a rank even split over
    'model' and 'data' (the MoE expert stacks) takes ('model', 'data') on
    its 'model' dim where that dim divides; else 'data' on the first spare
    trailing dim 'data' divides; else on dim 0 (a stacked layer dim).
    ``shapes``: the tree's tensors (meta ones too), whole."""
    sizes = _sizes(mesh)
    dp, tp = sizes.get("data", 1), sizes.get("model", 1)
    leaves, structure = tree_flatten(shapes, is_leaf=_is_shape)
    spec_leaves, _ = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))

    def one(spec, t):
        dims = tuple(t.shape)
        if len(dims) < 2:
            return spec
        entries = list(spec) + [None] * (len(dims) - len(spec))
        if t.numel() * t.element_size() / (tp * dp) > 256e6:
            for i, e in enumerate(entries):
                if e == "model" and dims[i] % (tp * dp) == 0:
                    entries[i] = ("model", "data")
                    return P(*entries)
        for i in list(range(1, len(dims))) + [0]:
            if entries[i] is None and dims[i] % dp == 0 and dims[i] >= dp:
                entries[i] = "data"
                return P(*entries)
        return spec
    return tree_unflatten(structure, [one(sp, t) for sp, t in
                                      zip(spec_leaves, leaves)])


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


def _axes(axis) -> tuple:
    """The mesh axes of an entry (a name or a tuple of names)."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(axis, mesh=None) -> int:
    """Ranks along mesh axis ``axis``, or along the axes of a tuple of
    them together (1 for an absent axis, or without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis is None:
        return 1
    sizes = _sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in _axes(axis))


def axis_index(axis, mesh=None) -> int:
    """This rank's coordinate along ``axis`` (0 when absent); along a tuple
    of axes, the coordinate of the block they split a dim into together,
    the first axis outermost."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return 0
    sizes, idx = _sizes(mesh), 0
    for a in _axes(axis):
        if a in sizes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _single(entry, what: str):
    """The one mesh axis of a resolved entry; a dim split over several
    axes at once is scattered (a partial sum onto it, a slice's gradient)
    through no collective here; it is gathered one axis at a time
    (``_gather_axes``)."""
    if isinstance(entry, tuple):
        if len(entry) != 1:
            raise NotImplementedError(
                f"{what} of a dim split over {entry} at once is not ported: "
                f"ROADMAP A6 (the sharded LM)")
        return entry[0]
    return entry


def _factor(sizes: dict, entry) -> int:
    return math.prod(sizes.get(a, 1) for a in _axes(entry))


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
            x = _slice_dim(x, mesh, e, d)
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
    the host); a meta tensor stays where it is."""
    if x.device.type == "meta":
        return x.contiguous()
    return x.to(mesh.device_type).contiguous()


_GROUPS: dict = {}


def _group(mesh, axis):
    """The process group of this rank along ``axis``, or along a tuple of
    axes together (made once a mesh, by every rank, in the same order: the
    ranks that share their coordinates on the other axes)."""
    axes = tuple(a for a in _axes(axis) if a in _sizes(mesh))
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh.permute(
            [i for i, a in enumerate(names) if a not in axes]
            + [names.index(a) for a in axes])
        rows = grid.reshape(-1, math.prod(_sizes(mesh)[a] for a in axes))
        mine, _ = dist.new_subgroups_by_enumeration(rows.tolist())
        _GROUPS[key] = (mesh, mine)      # the mesh kept: its id stays its own
    return _GROUPS[key][1]


# ``counts``: the ``Collectives`` a call adds to (the module's by default)

def _all_reduce(x, mesh, axis, op=dist.ReduceOp.SUM, kind="all_reduce",
                counts=None):
    counts = _COUNTS if counts is None else counts
    if is_accounting(mesh):
        counts._add(kind, x.nbytes)
        return _meta(x.shape, x)
    buf = x.to(mesh.device_type, copy=True).contiguous()
    dist.all_reduce(buf, op=op, group=_group(mesh, axis))
    counts._add(kind, buf.nbytes)
    return buf.to(x.device)


def _all_gather(x, mesh, axis, d, counts=None):
    """The blocks of every rank along ``axis`` concatenated on dim ``d``:
    along a tuple of axes, in the group's rank order (ascending global
    rank)."""
    counts = _COUNTS if counts is None else counts
    if is_accounting(mesh):
        shape = list(x.shape)
        shape[d] *= axis_size(axis, mesh)
        out = _meta(shape, x)
        counts._add("all_gather", out.nbytes)
        return out
    xs = staged(x.movedim(d, 0), mesh)
    out = xs.new_empty((axis_size(axis, mesh) * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=_group(mesh, axis))
    counts._add("all_gather", out.nbytes)
    return out.to(x.device).movedim(0, d).contiguous()


def _reduce_scatter(x, mesh, axis, d):
    if is_accounting(mesh):
        shape = list(x.shape)
        shape[d] //= axis_size(axis, mesh)
        out = _meta(shape, x)
        _COUNTS._add("reduce_scatter", out.nbytes)
        return out
    xs = staged(x.movedim(d, 0), mesh)
    out = xs.new_empty((xs.shape[0] // axis_size(axis, mesh),
                        *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=mesh.get_group(axis))
    _COUNTS._add("reduce_scatter", out.nbytes)
    return out.to(x.device).movedim(0, d).contiguous()


def _zero_padded(g, mesh, axis, d):
    """A block's gradient ``g`` in the rank's place of the whole dim ``d``,
    zeros elsewhere (a local slice's own transpose)."""
    whole = list(g.shape)
    whole[d] *= axis_size(axis, mesh)
    out = g.new_zeros(whole)
    _slice_dim(out, mesh, axis, d).copy_(g)
    return out


# Each collective is an autograd Function whose backward is its transpose
# under the cotangent rule of the module's docstring. ``part``: the
# replicated tensors on both sides have partial cotangents over the axis.

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, part):
        ctx.mesh, ctx.axis, ctx.part = mesh, axis, part
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.part:
            g = _all_reduce(g, ctx.mesh, ctx.axis)
        return g, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, d, part):
        ctx.mesh, ctx.axis, ctx.d, ctx.part = mesh, axis, d, part
        return _all_gather(x, mesh, axis, d)

    @staticmethod
    def backward(ctx, g):
        g = _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.d) if ctx.part else \
            _slice_dim(g, ctx.mesh, ctx.axis, ctx.d).contiguous()
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, d):
        ctx.mesh, ctx.axis, ctx.d = mesh, axis, d
        return _reduce_scatter(x, mesh, axis, d)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.d), None, None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, d, part):
        ctx.mesh, ctx.axis, ctx.d, ctx.part = mesh, axis, d, part
        return _slice_dim(x, mesh, axis, d).contiguous()

    @staticmethod
    def backward(ctx, g):
        g = _zero_padded(g, ctx.mesh, ctx.axis, ctx.d) if ctx.part else \
            _all_gather(g, ctx.mesh, _single(ctx.axis, "a slice's "
                                             "gradient"), ctx.d)
        return g, None, None, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _GradOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.first = axis_index(axis, mesh) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None, None


def constrain(x: torch.Tensor, *spec_entries, have: Sequence = (),
              partial=None, grad_partial: str | None = None
              ) -> torch.Tensor:
    """``x`` in the layout ``spec_entries`` resolve to on its global shape
    (the JAX package's ``constrain``, ``sharding.py:103-110``): ``x`` is
    this rank's block laid out as ``have`` (resolved entries; a dim left
    out is whole) and, with ``partial``, a partial sum over that mesh
    axis (or those axes together). One collective a transition (see the
    module's docstring): a partial sum is reduced first (scattered onto
    the target's dim split over the same axis, else all-reduced), then
    each dim whose entry changes is gathered and / or sliced.
    ``grad_partial``: the call sits where replicated tensors have partial
    cotangents over that axis (their readers compute a part a rank), which
    picks the transposes of the second table. Returns ``x`` itself without
    a mesh, or when nothing changes."""
    mesh = current_mesh()
    if mesh is None:
        return x
    sizes = _sizes(mesh)
    have = list(have) + [None] * (x.ndim - len(have))
    want = list(resolve_entries(mesh, spec_entries,
                                _global_shape(x.shape, have, mesh)))
    part = grad_partial if _factor(sizes, grad_partial) > 1 else None
    partial = _clean_axis(sizes, partial)
    if partial is not None and _factor(sizes, partial) > 1:
        dims = [d for d, e in enumerate(want) if e == partial
                and have[d] is None]
        if dims:
            x = _ReduceScatter.apply(x, mesh, _single(partial, "a scatter"),
                                     dims[0])
            have[dims[0]] = partial
        else:
            x = _AllReduce.apply(x, mesh, partial, part == partial)
    for d, (h, w) in enumerate(zip(have, want)):
        if h == w:
            continue
        hs, ws = _axes(h), _axes(w)
        keep = ws if ws and hs[:len(ws)] == ws else ()
        x = _gather_axes(x, mesh, hs[len(keep):], d, part)
        if not keep and w is not None and _factor(sizes, w) > 1:
            x = _Slice.apply(x, mesh, w, d,
                             part is not None and part in _axes(w))
    return x


def _gather_axes(x, mesh, axes: tuple, d: int, part) -> torch.Tensor:
    """``x``'s dim ``d``, split over ``axes`` at once (the first
    outermost), gathered over them: one all_gather an axis, the innermost
    first, each over its own axis' group (a tuple group's ranks come in
    the mesh's order, which need not be the entry's); ``axes`` may be the
    inner part of an entry whose outer axes stay split (FSDP's ('model',
    'data') read as 'model')."""
    sizes = _sizes(mesh)
    for ax in reversed(axes):
        if sizes.get(ax, 1) > 1:
            x = _AllGather.apply(x, mesh, ax, d, part == ax)
    return x


def sum_grad(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself in the forward; in the backward its gradient is
    all-reduced over ``axis`` (Megatron's "f"): where ``x`` is replicated
    over the axis but read by compute split over it (a column-parallel
    product, a param used on rows split over it), each rank's gradient is
    a partial sum. ``x`` itself without a mesh or when the axis has one
    rank."""
    mesh = current_mesh()
    if mesh is None or axis_size(axis, mesh) == 1:
        return x
    return _SumGrad.apply(x, mesh, axis)


def grad_once(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself in the forward; in the backward its gradient is kept on
    the axis' first rank and zero on the others: a replicated value whose
    cotangent is whole on every rank, handed to compute whose cotangents
    are partial sums over the axis, counted once."""
    mesh = current_mesh()
    if mesh is None or axis_size(axis, mesh) == 1:
        return x
    return _GradOnce.apply(x, mesh, axis)


def psum(x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the largest element) of ``x`` over ``axis``
    (a name or a tuple of names, one group over them together), on every
    rank; its gradient (the sum's only) passes through unchanged, the
    cotangent of the replicated sum being whole on every rank. ``x``
    itself without a mesh or when the axis has one rank."""
    mesh = current_mesh()
    if mesh is None or axis_size(axis, mesh) == 1:
        return x
    if op != "sum":
        return all_reduce(x, axis, op, mesh=mesh)
    return _AllReduce.apply(x, mesh, axis, False)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, axis, op: str = "sum", *, mesh=None,
               kind: str = "all_reduce", counts: Collectives | None = None
               ) -> torch.Tensor:
    """``x`` reduced by ``op`` ("sum", "max" or "min") over ``axis`` of
    ``mesh`` (the current mesh by default) on every rank, counted in
    ``counts`` as ``kind``; no gradient. ``x`` itself without a mesh or
    when the axis has one rank."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis_size(axis, mesh) == 1:
        return x
    return _all_reduce(x.detach(), mesh, axis, _REDUCE_OPS[op], kind,
                       counts)


def all_gather(x: torch.Tensor, axis, *, mesh=None,
               counts: Collectives | None = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` of ``mesh`` (the current mesh by
    default; along a tuple of axes, in the group's rank order, ascending
    global rank), stacked on a new dim 0, counted in ``counts``; no
    gradient."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis_size(axis, mesh) == 1:
        return x.unsqueeze(0)
    return _all_gather(x.detach().unsqueeze(0), mesh, axis, 0, counts)


def gather_whole(x: torch.Tensor, entries: Sequence) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block, laid out as
    ``entries`` (a resolved spec): each split dim all-gathered over its
    axis, in the rank's own memory. ``x`` itself without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    for d, e in enumerate(entries):
        for ax in reversed(_axes(e)):
            if axis_size(ax, mesh) > 1:
                x = _all_gather(x, mesh, ax, d)
    return x


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, index, counts):
        ctx.mine = axis_index(axis, mesh) == index
        counts = _COUNTS if counts is None else counts
        if is_accounting(mesh):
            counts._add("broadcast", x.nbytes)
            return _meta(x.shape, x)
        group = _group(mesh, axis)
        buf = x.to(mesh.device_type, copy=True).contiguous()
        dist.broadcast(buf, group=group,
                       src=dist.get_global_rank(group, index))
        counts._add("broadcast", buf.nbytes)
        return buf.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None, None, \
            None


def broadcast_from(x: torch.Tensor, axis, index: int, *, mesh=None,
                   counts: Collectives | None = None) -> torch.Tensor:
    """``x`` as the rank at coordinate ``index`` along ``axis`` (a name,
    or a tuple of names: ``axis_index``'s coordinate, which is the group
    rank where the mesh's global ranks ascend) of ``mesh`` (the current
    mesh by default) holds it, on every rank of this rank's group along
    ``axis`` (each passes a tensor of the same shape and type), counted
    in ``counts``; ``x`` itself without a mesh or when the axis has one
    rank. Its backward gives the source rank the (whole) cotangent of the
    replicated output and the others zero."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis_size(axis, mesh) == 1:
        return x
    return _Broadcast.apply(x, mesh, axis, index, counts)


def broadcast_object(obj: Any) -> Any:
    """The Python object the origin of the current mesh (flat position 0)
    passes, on every rank of the mesh (counted as a "broadcast_object" of
    its pickled bytes); ``obj`` itself without a mesh."""
    mesh = current_mesh()
    if mesh is None or mesh.size() == 1:
        return obj
    if is_accounting(mesh):
        _COUNTS._add("broadcast_object", len(pickle.dumps(obj)))
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=int(mesh.mesh.reshape(-1)[0]),
                               group=_group(mesh, tuple(mesh.mesh_dim_names)))
    _COUNTS._add("broadcast_object", len(pickle.dumps(box[0])))
    return box[0]
