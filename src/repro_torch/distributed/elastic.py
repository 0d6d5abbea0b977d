"""Place tensors on a mesh of ranks, and move them between meshes
(counterpart of ``repro/distributed/elastic.py``).

``place`` resolves each leaf's spec against the mesh (``sharding.
resolve_spec``, with its divisibility fallbacks) and hands every rank its
part: the whole leaf where the placement is ``Replicate()``, its block
along dim d where it is ``Shard(d)``. The data comes from one rank, the
origin; the other ranks pass no tree and learn its structure, shapes and
types from the origin. Leaves come back as DTensors on the mesh, so
``replace_mesh`` and ``reshard_like`` can read where they came from.

The collectives run on the mesh's device type: ``"cpu"`` for a gloo
group, whose tensors are staged through host memory, ``"cuda"`` for NCCL.
A caller moves ``to_local()`` to the device it computes on.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .sharding import P, resolve_spec, tree_flatten, tree_unflatten

__all__ = ["place", "replace_mesh", "reshard_like"]


def _one_dim(mesh) -> None:
    if mesh.ndim != 1:
        raise NotImplementedError(
            f"placing on a {mesh.ndim}-D mesh is not ported yet: ROADMAP A6 "
            f"(the sharded LM); the serving mesh has one axis")


def place(tree: Any, specs: Any, mesh, *, src: int = 0) -> Any:
    """Every leaf of ``tree`` as a DTensor on the 1-D ``mesh``, placed as
    its spec resolves: ``Replicate()`` -> a copy on every rank (one
    broadcast), ``Shard(d)`` -> each rank's equal block along d (one
    scatter; ``resolve_spec`` replicates a dim the mesh does not divide).
    Rank ``src`` passes the tree and its specs; the others pass None for
    both and receive the structure with the data. Collective: every rank
    of the mesh calls it."""
    _one_dim(mesh)
    group = mesh.get_group()
    rank = dist.get_rank(group)
    stage = torch.device(mesh.device_type)
    if rank == src:
        leaves, structure = tree_flatten(tree,
                                         is_leaf=lambda x: hasattr(x, "shape"))
        spec_leaves, _ = tree_flatten(specs,
                                      is_leaf=lambda x: isinstance(x, P))
        if len(spec_leaves) != len(leaves):
            raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                             f"leaves")
        meta = [(tuple(x.shape), x.dtype, resolve_spec(mesh, s, x.shape))
                for x, s in zip(leaves, spec_leaves)]
        header = [structure, meta]
    else:
        leaves, header = None, [None, None]
    dist.broadcast_object_list(header, src=dist.get_global_rank(group, src),
                               group=group)
    structure, meta = header
    out = []
    for i, (shape, dtype, placements) in enumerate(meta):
        x = leaves[i].to(stage).contiguous() if rank == src else None
        (pl,) = placements
        if isinstance(pl, Shard):
            n = mesh.size()
            block = list(shape)
            block[pl.dim] //= n
            local = torch.empty(block, dtype=dtype, device=stage)
            chunks = [c.contiguous() for c in x.chunk(n, dim=pl.dim)] \
                if rank == src else None
            dist.scatter(local, chunks, src=dist.get_global_rank(group, src),
                         group=group)
            del chunks
        else:
            local = x if rank == src else torch.empty(shape, dtype=dtype,
                                                      device=stage)
            dist.broadcast(local, src=dist.get_global_rank(group, src),
                           group=group)
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
    mine = dist.get_rank(new_mesh.get_group()) == src
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
    placement."""
    (pl,) = t.placements
    if isinstance(pl, Replicate):
        return x
    n = t.device_mesh.size()
    return x.chunk(n, dim=pl.dim)[t.device_mesh.get_local_rank()]
