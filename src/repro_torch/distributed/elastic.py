"""Place tensors on a mesh of ranks, and move them between meshes
(counterpart of ``repro/distributed/elastic.py``).

``place`` resolves each leaf's spec against the mesh (``sharding.
resolve_spec``, with its divisibility fallbacks) and hands every rank its
block: one placement per mesh dimension, ``Replicate()`` or ``Shard(d)``.
A tensor dim split over several mesh axes (``P(("pod", "data"), None)``)
is split with the first axis outermost, as JAX's ``NamedSharding`` splits
it: the block of the rank at (i_pod, i_data) is i_pod |data| + i_data.
The data comes from one rank, the origin; the other ranks pass no tree
and learn its structure, shapes and types from the origin. Leaves come
back as DTensors on the mesh, so ``replace_mesh`` and ``reshard_like``
can read where they came from.

A mesh of one axis may be a subgroup; a mesh of more spans the whole
process group. The collectives run on the mesh's device type: ``"cpu"``
for a gloo group, whose tensors are staged through host memory, ``"cuda"``
for NCCL. A caller moves ``to_local()`` to the device it computes on.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from .sharding import (P, NamedSharding, resolve_entries, resolve_spec,
                       tree_flatten, tree_unflatten)

__all__ = ["place", "replace_mesh", "reshard_like", "block_slices",
           "mesh_ranks"]


def block_slices(shape, placements, mesh_shape, coord) -> tuple:
    """The block of a ``shape`` tensor that the rank at mesh coordinate
    ``coord`` holds under ``placements`` (one per mesh dimension), as one
    slice a tensor dim. Mesh dimensions that split the same tensor dim
    nest in mesh order, the first outermost."""
    lo, size = [0] * len(shape), list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            size[pl.dim] //= mesh_shape[i]
            lo[pl.dim] += coord[i] * size[pl.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def mesh_ranks(mesh) -> tuple[Any, list[int]]:
    """(the process group over every rank of ``mesh``, the global rank at
    each flat mesh position). A 1-D mesh brings its own group; a mesh of
    more axes must span the whole process group, whose default group then
    serves."""
    ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
    if mesh.ndim == 1:
        return mesh.get_group(), ranks
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError(
            f"a {mesh.ndim}-D mesh must span the whole process group: its "
            f"ranks are {ranks}, the group has {dist.get_world_size()}")
    return dist.group.WORLD, ranks


def _in_mesh_order(mesh, entries) -> None:
    """Refuse a tensor dim split over mesh axes out of the mesh's order:
    a DTensor nests its blocks in mesh order, so it could not say where
    such a block lies."""
    names = list(mesh.mesh_dim_names)
    for e in entries:
        if isinstance(e, tuple) and \
                [names.index(a) for a in e] != sorted(names.index(a)
                                                      for a in e):
            raise NotImplementedError(
                f"a dim split over {e}, out of the mesh's axis order "
                f"{tuple(names)}, is not ported: ROADMAP A6 (the sharded "
                f"LM)")


def _resolved(mesh, spec, shape) -> tuple:
    if isinstance(spec, NamedSharding):
        if spec.mesh is not mesh:
            raise ValueError("a NamedSharding of another mesh")
        entries, placements = spec.spec, spec.placements
    else:
        entries = resolve_entries(mesh, spec, shape)
        placements = resolve_spec(mesh, spec, shape)
    _in_mesh_order(mesh, entries)
    return tuple(placements)


def place(tree: Any, specs: Any, mesh, *, src: int = 0) -> Any:
    """Every leaf of ``tree`` as a DTensor on ``mesh``, placed as its spec
    resolves (``specs``: a tree of ``P`` or of ``sharding.NamedSharding``,
    as ``shardings_tree`` gives): a leaf replicated on every mesh axis is
    one broadcast, any other one scatter of each rank's block. Rank ``src``
    (a flat mesh position) passes the tree and its specs; the others pass
    None for both and receive the structure with the data. Collective:
    every rank of the mesh calls it."""
    group, ranks = mesh_ranks(mesh)
    me = ranks.index(dist.get_rank())
    g_src = ranks[src]
    stage = torch.device(mesh.device_type)
    leaves, header = None, [None, None, None]
    if me == src:
        leaves, structure = tree_flatten(tree,
                                         is_leaf=lambda x: hasattr(x, "shape"))
        spec_leaves, _ = tree_flatten(
            specs, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))
        try:
            if len(spec_leaves) != len(leaves):
                raise ValueError(f"{len(spec_leaves)} specs for "
                                 f"{len(leaves)} leaves")
            header = [structure, [
                (tuple(x.shape), x.dtype, _resolved(mesh, s, x.shape))
                for x, s in zip(leaves, spec_leaves)], None]
        except (ValueError, NotImplementedError) as e:
            header = [None, None, e]
    # a refusal reaches every rank, which raises it too: none is left
    # waiting for the data
    dist.broadcast_object_list(header, src=g_src, group=group)
    structure, meta, refused = header
    if refused is not None:
        raise refused
    coords = [np.unravel_index(p, tuple(mesh.shape)) for p in
              range(len(ranks))]
    out = []
    for i, (shape, dtype, placements) in enumerate(meta):
        x = leaves[i].to(stage).contiguous() if me == src else None
        mine = block_slices(shape, placements, mesh.shape, coords[me])
        if any(isinstance(pl, Shard) for pl in placements):
            local = torch.empty([s.stop - s.start for s in mine],
                                dtype=dtype, device=stage)
            chunks = None
            if me == src:
                chunks = [None] * len(ranks)
                for p, g in enumerate(ranks):
                    chunks[dist.get_group_rank(group, g)] = x[block_slices(
                        shape, placements, mesh.shape,
                        coords[p])].contiguous()
            dist.scatter(local, chunks, src=g_src, group=group)
            del chunks
        else:
            # the origin's copy is its own: a later reshard_like writes
            # into it, never into the caller's tensor
            local = x.clone() if me == src else torch.empty(
                shape, dtype=dtype, device=stage)
            dist.broadcast(local, src=g_src, group=group)
        del x
        out.append(DTensor.from_local(local, mesh, placements,
                                      run_check=False))
    return tree_unflatten(structure, out)


def replace_mesh(tree: Any, specs: Any, new_mesh, *, src: int = 0) -> Any:
    """Move placed leaves onto another mesh (a grow / shrink event): each
    leaf is gathered whole once (``full_tensor``) and placed anew from rank
    ``src`` of ``new_mesh``. Collective over both meshes."""
    leaves, structure = tree_flatten(tree,
                                     is_leaf=lambda x: hasattr(x, "shape"))
    full = [x.full_tensor() if isinstance(x, DTensor) else x for x in leaves]
    _, ranks = mesh_ranks(new_mesh)
    mine = ranks.index(dist.get_rank()) == src
    return place(tree_unflatten(structure, full) if mine else None,
                 specs if mine else None, new_mesh, src=src)


def reshard_like(template: Any, tree: Any) -> Any:
    """Put NEW tensors in an OLD tree's exact layout: the live-swap path,
    where a compacted or rebuilt index drops into the placement the tier
    serves from. Leaves must keep the template's shapes (the mutable
    tier's shape-stability contract), else ValueError before anything
    moves. A DTensor template is refilled in place from each rank's local
    part of the new leaf's block; a plain tensor template is copied
    into."""
    t_leaves, structure = tree_flatten(template,
                                       is_leaf=lambda x: hasattr(x, "shape"))
    x_leaves, _ = tree_flatten(tree, is_leaf=lambda x: hasattr(x, "shape"))
    for t, x in zip(t_leaves, x_leaves):
        if getattr(t, "shape", None) != getattr(x, "shape", None):
            raise ValueError(
                f"reshard_like: shape {tuple(getattr(x, 'shape', ()))} != "
                f"template {tuple(getattr(t, 'shape', ()))} — live swaps "
                f"demand shape stability (pre-allocate slabs/capacity)")
    out = []
    for t, x in zip(t_leaves, x_leaves):
        if isinstance(t, DTensor):
            local = t.to_local()
            new = x.to_local() if isinstance(x, DTensor) \
                else _block_of(x, t)
            local.copy_(new)
            out.append(t)
        else:
            t.copy_(x)
            out.append(t)
    return tree_unflatten(structure, out)


def _block_of(x: torch.Tensor, t: DTensor) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``t``'s
    placements."""
    mesh = t.device_mesh
    return x[block_slices(x.shape, t.placements, mesh.shape,
                          mesh.get_coordinate())]
