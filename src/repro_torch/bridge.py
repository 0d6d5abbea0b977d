"""Carry the JAX package's built state into the port.

The functions take plain numpy arrays (``np.asarray`` of the JAX package's
``CompactIndex`` fields, ``HostStore`` and ``Placement``, or of an LM's
param tree), so this module
imports neither JAX nor the JAX package, and return the port's types on
the requested device. Both packages can then search the identical index.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.compact_index import CompactIndex, HostStore
from .core.placement import Placement

__all__ = ["compact_index_from_numpy", "host_store_from_numpy",
           "placement_from_numpy", "placed_index_from_numpy",
           "lm_params_from_numpy", "lm_params_onto_mesh",
           "adamw_state_from_numpy"]


def compact_index_from_numpy(fields: dict, device="cuda") -> CompactIndex:
    """A dict of ``CompactIndex._fields`` -> numpy arrays (and ``dim``)."""
    def t(name):
        return torch.from_numpy(np.array(fields[name])).to(device)
    return CompactIndex(**{f: t(f) for f in CompactIndex._fields
                           if f != "dim"}, dim=int(fields["dim"]))


def host_store_from_numpy(vectors, centroids, device="cuda") -> HostStore:
    return HostStore(
        torch.from_numpy(np.array(vectors, np.float32)).to(device),
        torch.from_numpy(np.array(centroids, np.float32)).to(device))


def placement_from_numpy(order, shard_of, local_slot, n_shards: int,
                         per_shard: int, load, mem=None, mem_reclaimable=None,
                         owners_of=None, locals_of=None,
                         resident_table=None) -> Placement:
    """The fields of the JAX package's ``Placement``, as numpy."""
    def opt(a, dtype):
        return None if a is None else np.asarray(a, dtype)
    return Placement(order=np.asarray(order, np.int32),
                     shard_of=np.asarray(shard_of, np.int32),
                     local_slot=np.asarray(local_slot, np.int32),
                     n_shards=int(n_shards), per_shard=int(per_shard),
                     load=np.asarray(load, np.float64),
                     mem=opt(mem, np.float64),
                     mem_reclaimable=opt(mem_reclaimable, np.float64),
                     owners_of=opt(owners_of, np.int32),
                     locals_of=opt(locals_of, np.int32),
                     resident_table=opt(resident_table, np.int32))


def placed_index_from_numpy(fields: dict, arrays: dict, mode: str,
                            device="cuda"):
    """The JAX package's ``PlacedIndex`` (its six shard-major fields and
    its backend's ``arrays`` NamedTuple, each as a dict of numpy arrays)
    as the port's, for the backend ``mode``: a JAX round-robin placed
    index (``launch/anns_step.py``) searched by both packages."""
    from .core import backends
    from .core.engine import PlacedIndex
    kind = type(backends.get_backend(mode).array_specs((1,), 1, 8))

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)
    return PlacedIndex(**{f: t(fields[f]) for f in (
        "centroids", "codes", "neighbors", "entry", "n_valid", "node_ids")},
        arrays=kind(**{f: t(arrays[f]) for f in kind._fields}))


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: the same 16
        # bits, reinterpreted (exact; no trip through another float type)
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params_from_numpy(tree, device="cuda"):
    """The JAX package's LM param tree (``jax.tree.map(np.asarray,
    params)``: dicts, lists and None around numpy leaves) as the port's
    params, leaf for leaf, in the same dtypes."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_numpy(v, device) for v in tree]
    return _tensor(tree, device)


def lm_params_onto_mesh(tree, specs, mesh, device="cuda"):
    """The JAX package's LM param tree (numpy, as ``lm_params_from_numpy``
    takes it) placed on ``mesh`` from its origin (flat mesh position 0),
    which passes the tree and its specs (``Model.specs()``); the other
    ranks pass None for both. Each leaf goes through ``elastic.place``
    under its spec, resolved with the divisibility fallbacks, one leaf at
    a time: every rank gets the block JAX's ``NamedSharding`` of that spec
    gives its device, as a plain tensor on ``device``. Collective: every
    rank of the mesh calls it."""
    import torch.distributed as dist
    from .distributed import elastic
    from .distributed.sharding import P, tree_flatten, tree_unflatten

    def leaf(x):
        return x is None or hasattr(x, "shape") or isinstance(x, P)
    group, ranks = elastic.mesh_ranks(mesh)
    box = [None, None]
    if ranks[0] == dist.get_rank():
        leaves, structure = tree_flatten(
            lm_params_from_numpy(tree, "cpu"), is_leaf=leaf)
        spec_leaves, _ = tree_flatten(specs, is_leaf=leaf)
        box = [[x is not None for x in leaves], structure]
    else:
        leaves = spec_leaves = None
    dist.broadcast_object_list(box, src=ranks[0], group=group)
    present, structure = box
    out = []
    for i, there in enumerate(present):
        if not there:
            out.append(None)
            continue
        mine = elastic.place(None if leaves is None else leaves[i],
                             None if spec_leaves is None else spec_leaves[i],
                             mesh)
        out.append(mine.to_local().to(device))
    return tree_unflatten(structure, out)


def adamw_state_from_numpy(step, mu, nu, device="cuda"):
    """The JAX package's ``AdamWState`` (``jax.tree.map(np.asarray,
    state)``: its step, mu and nu) as the port's ``optim.adamw.AdamWState``:
    the step a 0-d int32 tensor, the moments leaf for leaf in their
    types."""
    from .optim.adamw import AdamWState
    return AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        lm_params_from_numpy(mu, device), lm_params_from_numpy(nu, device))
