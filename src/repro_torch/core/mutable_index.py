"""Streaming mutation of the compact index (counterpart of
``repro/core/mutable_index.py``).

``MutableIndex`` keeps the per-cluster tensors of a ``CompactIndex`` as
mirrors on the index's device and mutates them through one entry point each:

  * ``delete(ids)``: tombstones. The served ``node_ids`` slot turns -1, so
    the node can never be returned, but its code and adjacency stay: the
    dead node remains a waypoint of the beam search until compaction.
  * ``insert(ids, vecs)``: bounded per-cluster append slabs. Each vector is
    routed to its nearest frozen centroid (``ivf.assign``), encoded against
    that cluster (``rabitq.encode``, the same bits as a rebuild's), given
    its ``f_add`` (``mulfree.fold_node_factor``) and linked into the graph
    (``graph.link_rounds``: round j links the j-th insert of every cluster,
    bit for bit the one-after-another ``graph.link_new``). Cluster
    constants stay stale until compaction.
  * ``compact(clusters=None)``: re-encodes each dirty cluster's live set in
    ascending id order through ``compact_index.encode_clusters``, the
    producer that construction and ``rebuild()`` share. A cluster's arrays
    do not depend on the clusters encoded beside it, so a compacted index
    equals a from-scratch ``rebuild()`` bit for bit.

Shapes never change: clusters are padded once to ``budget + slab`` rows and
the vector store is allocated to ``capacity`` rows, so every snapshot swaps
under a live engine (``PIMCQGEngine.refresh``, ``ServingTopology.apply``).
A snapshot hands out the mirrors themselves; the next write to a mirror
copies it first, so a served snapshot never changes under its engine.
Where an id lives is kept in (capacity,) tensors, not dicts: 10M ids would
be 10M tuples on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import compact_index as compact_index_mod
from . import graph as graph_mod
from . import ivf, mulfree, rabitq
from .compact_index import (CompactIndex, HostStore, IndexConfig,
                            compact_bytes_per_node)

__all__ = ["MutableIndex"]

_INT32_MAX = 2**31 - 1
# the mirrors a snapshot hands out (centroids and rotation never change)
_SERVED = ("codes", "f_add", "neighbors", "entry", "n_valid", "node_ids",
           "alpha", "rho", "shift1", "shift2", "residual_norm", "cos_theta",
           "vectors")


class MutableIndex:
    """Mutable mirror of a (CompactIndex, HostStore) pair, on the index's
    device.

    ``slab``: extra node rows appended to every cluster's budget, the
    bounded append headroom. ``capacity``: total vector rows (ids must stay
    below it); defaults to ``N + n_clusters * slab`` so the slabs can fill.
    Construction canonicalizes every cluster through the producer
    ``compact()`` uses, so the initial state is already bitwise a
    from-scratch build at the mutable budget. ``mem_bytes`` bounds the
    temporaries of one encode or link step."""

    def __init__(self, index: CompactIndex, host: HostStore,
                 icfg: IndexConfig, *, slab: int = 0,
                 capacity: int | None = None, mem_bytes: int = 8 << 30):
        if slab < 0:
            raise ValueError(f"slab must be >= 0, got {slab}")
        self.icfg = icfg
        self.slab = int(slab)
        self.mem_bytes = int(mem_bytes)
        c, m = index.n_clusters, index.budget
        self.budget = m + self.slab
        if icfg.knn_k > m - 1:
            raise ValueError(
                f"knn_k={icfg.knn_k} must be <= budget-1={m - 1} so graph "
                f"construction is invariant to the slab padding")
        n0 = int(host.vectors.shape[0])
        cap = n0 + c * self.slab if capacity is None else int(capacity)
        if cap < n0:
            raise ValueError(f"capacity {cap} < existing {n0} vectors")
        self.capacity = cap
        dev = self.device = index.codes.device

        # frozen routing state: mutation never moves or re-trains these
        self.centroids = index.centroids.to(torch.float32)
        self.rotation = index.rotation
        self.dim = index.dim

        # the vector store, allocated to capacity (shape-stable)
        self.vectors = torch.zeros((cap, host.vectors.shape[1]),
                                   dtype=torch.float32, device=dev)
        self.vectors[:n0] = host.vectors.to(dev)

        # per-cluster mirrors at the mutable budget M' = M + slab
        b = self.budget
        w, r = index.codes.shape[2], index.neighbors.shape[2]

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)
        self.codes = full((c, b, w), 0, torch.uint8)
        self.f_add = full((c, b), _INT32_MAX, torch.int32)
        self.neighbors = full((c, b, r), -1, torch.int32)
        self.node_ids = full((c, b), -1, torch.int32)   # served ids: -1 =
        self.slot_gid = full((c, b), -1, torch.int32)   # hole / tombstone;
        # slot_gid keeps the id through a tombstone, so the dead node's
        # vector stays addressable for graph geometry until compaction
        self.residual_norm = full((c, b), 0.0, torch.float32)
        self.cos_theta = full((c, b), 1.0, torch.float32)
        self.entry = full((c,), 0, torch.int32)
        self.n_valid = full((c,), 0, torch.int32)       # occupied prefix
        self.alpha = full((c,), 0.0, torch.float32)
        self.rho = full((c,), 0.0, torch.float32)
        self.shift1 = full((c,), 0, torch.int32)
        self.shift2 = full((c,), 0, torch.int32)
        self.tomb = full((c, b), False, torch.bool)     # occupied but dead

        self.loc = full((cap, 2), -1, torch.int32)      # id -> (c, slot)
        self._tomb_cluster = full((cap,), -1, torch.int32)  # dead id -> c
        self._n_live = 0
        self._shared: set[str] = set()   # mirrors a snapshot handed out
        self.dirty: set[int] = set()
        self.version = 0

        # canonicalize every cluster at the mutable budget (the compact()
        # path, so an unmutated snapshot == rebuild() bitwise)
        rows = _canonical(index.node_ids.to(dev), b)
        top = int(rows.max())
        if top >= cap:
            raise ValueError(f"global id {top} >= capacity {cap}")
        self._write_clusters(torch.arange(c, device=dev), rows)

    # -- construction convenience --------------------------------------------
    @classmethod
    def build(cls, seed: int, x, icfg: IndexConfig, *, slab: int = 0,
              capacity: int | None = None, verbose: bool = False,
              device: str | torch.device = "cuda") -> "MutableIndex":
        """Build the index from x (N, D) on ``device`` with a generator
        seeded by ``seed`` (``PIMCQGEngine.build``'s recipe), then wrap
        it."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        idx, host = compact_index_mod.build_compact_index(gen, x, icfg,
                                                          verbose=verbose)
        return cls(idx, host, icfg, slab=slab, capacity=capacity)

    def to_engine(self, scfg, *, n_shards: int = 1,
                  freq: np.ndarray | None = None, buckets=None):
        """A PIMCQGEngine over the current snapshot, on the index's device
        (``PIMCQGEngine.build``'s placement recipe). Later mutations reach
        it through ``engine.refresh(*mut.snapshot())``: shapes never
        change."""
        from . import engine as engine_mod
        from . import placement as placement_mod
        idx, host = self.snapshot()
        sizes = idx.n_valid.cpu().numpy()
        bpc = sizes * compact_bytes_per_node(self.icfg.dim, self.icfg.degree)
        if freq is None:
            freq = sizes.astype(np.float64)
        pl = placement_mod.greedy_place(freq, bpc, n_shards)
        return engine_mod.PIMCQGEngine(idx, host, pl, self.icfg, scfg,
                                       buckets=buckets, device=self.device)

    # -- bookkeeping helpers --------------------------------------------------
    @property
    def n_clusters(self) -> int:
        return self.codes.shape[0]

    @property
    def n_live(self) -> int:
        return self._n_live

    def live_ids(self) -> torch.Tensor:
        """The live ids, ascending, (n_live,) int64 on the index's device."""
        return torch.nonzero(self.loc[:, 0] >= 0).flatten()

    def _writable(self, *names: str) -> None:
        """Copy each mirror that a snapshot handed out before writing it."""
        for name in self._shared.intersection(names):
            setattr(self, name, getattr(self, name).clone())
            self._shared.discard(name)

    def _ids(self, ids) -> torch.Tensor:
        """A batch of ids (a list, an array or a tensor) as (n,) int64 on
        the index's device."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.as_tensor(np.asarray(ids))
        return ids.to(self.device, torch.int64).reshape(-1)

    def _write_clusters(self, cids: torch.Tensor, rows: torch.Tensor):
        """Re-encode clusters ``cids`` from their live sets (rows: (B,
        budget) ascending ids, -1 after them) through the producer that
        construction, compact() and rebuild() share."""
        fields = compact_index_mod.CLUSTER_FIELDS
        self._writable(*fields, "node_ids")
        compact_index_mod.encode_clusters(
            self.vectors, rows, self.centroids[cids], self.rotation,
            self.icfg, mem_bytes=self.mem_bytes,
            out={name: getattr(self, name) for name in fields}, at=cids)
        self.node_ids[cids] = rows
        self.slot_gid[cids] = rows
        self.tomb[cids] = False
        live = rows >= 0
        slot = torch.arange(rows.shape[1], device=self.device,
                            dtype=torch.int32).expand_as(rows)
        cl = cids.to(torch.int32)[:, None].expand_as(rows)
        gids = rows[live].long()
        was = int((self.loc[gids, 0] >= 0).sum())
        self.loc[gids] = torch.stack([cl[live], slot[live]], 1)
        self._n_live += len(gids) - was

    # -- mutation: delete -----------------------------------------------------
    def delete(self, ids) -> int:
        """Tombstone live global ids. Validates the whole batch before
        touching anything (all-or-nothing). Returns the delete count."""
        ids = self._ids(ids)
        if len(torch.unique(ids)) != len(ids):
            raise ValueError("duplicate ids in delete batch")
        inside = (ids >= 0) & (ids < self.capacity)
        live = inside & (self.loc[ids.clamp(0, self.capacity - 1), 0] >= 0)
        if not bool(live.all()):
            missing = ids[~live][:8].tolist()
            raise ValueError(f"ids not live (unknown or already deleted): "
                             f"{missing}")
        c, s = self.loc[ids].long().unbind(1)
        self._writable("node_ids")
        self.node_ids[c, s] = -1       # invisible to rerank/results now
        self.tomb[c, s] = True         # ...but still a graph waypoint
        self._tomb_cluster[ids] = c.to(torch.int32)
        self.loc[ids] = -1
        self.dirty.update(torch.unique(c).tolist())
        self._n_live -= len(ids)
        self.version += 1
        return len(ids)

    # -- mutation: insert -----------------------------------------------------
    def insert(self, ids, vecs) -> int:
        """Append new (id, vector) pairs into their owning clusters' slabs.

        Routing is nearest-frozen-centroid; encoding is bitwise the offline
        path; linking is the offline prune. Raises (without partial
        effects) when a target cluster's slab is full: call ``compact()``
        to reclaim tombstones first."""
        ids = self._ids(ids)
        vecs = torch.as_tensor(vecs, dtype=torch.float32).to(self.device)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if len(ids) != len(vecs):
            raise ValueError(f"{len(ids)} ids for {len(vecs)} vectors")
        if vecs.shape[1] != self.dim:
            raise ValueError(f"dim {vecs.shape[1]} != index dim {self.dim}")
        if len(torch.unique(ids)) != len(ids):
            raise ValueError("duplicate ids in insert batch")
        outside = (ids < 0) | (ids >= self.capacity)
        at = ids.clamp(0, self.capacity - 1)
        live = ~outside & (self.loc[at, 0] >= 0)
        dead = ~outside & (self._tomb_cluster[at] >= 0)
        bad = torch.nonzero(outside | live | dead).flatten()
        if len(bad):
            i = int(bad[0])
            g = int(ids[i])
            if bool(outside[i]):
                raise ValueError(f"id {g} outside [0, capacity="
                                 f"{self.capacity}) — build with a larger "
                                 f"capacity")
            if bool(live[i]):
                raise ValueError(f"id {g} is already live")
            raise ValueError(f"id {g} is tombstoned; compact() before "
                             f"reusing it")
        assign = ivf.assign(vecs, self.centroids).long()
        # validate slab room for the WHOLE batch before any write
        need = torch.bincount(assign, minlength=self.n_clusters)
        free = self.budget - self.n_valid.long()
        over = torch.nonzero(need > free).flatten()
        if len(over):
            c = int(over[0])
            raise ValueError(
                f"append slab full for cluster {c} "
                f"({int(need[c])} inserts, {int(free[c])} free slots); "
                f"compact() to reclaim tombstones")
        # each cluster's inserts take its next slots, in batch order
        order = torch.sort(assign, stable=True).indices
        cl, gids, v = assign[order], ids[order], vecs[order]
        start = torch.cumsum(need, 0) - need
        base = self.n_valid.long()
        slot = base[cl] + torch.arange(len(cl), device=self.device) \
            - start[cl]
        codes = rabitq.encode(v[:, None, :], self.centroids[cl],
                              self.rotation, dim=self.icfg.dim)
        self._writable("codes", "residual_norm", "cos_theta", "f_add",
                       "node_ids", "vectors", "n_valid", "neighbors")
        rn = codes.residual_norm[:, 0]
        self.codes[cl, slot] = codes.packed[:, 0]
        self.residual_norm[cl, slot] = rn
        self.cos_theta[cl, slot] = codes.cos_theta[:, 0]
        self.f_add[cl, slot] = mulfree.fold_node_factor(rn)
        self.node_ids[cl, slot] = gids.to(torch.int32)
        self.slot_gid[cl, slot] = gids.to(torch.int32)
        self.vectors[gids] = v
        self.n_valid += need.to(torch.int32)
        self.loc[gids] = torch.stack([cl, slot], 1).to(torch.int32)
        touched = torch.nonzero(need).flatten()
        graph_mod.link_rounds(
            self.neighbors, self.slot_gid, self.vectors, touched,
            base[touched], need[touched], r=self.icfg.degree,
            knn_k=self.icfg.knn_k, prune_alpha=self.icfg.prune_alpha,
            mem_bytes=min(self.mem_bytes, 1 << 30))
        self.dirty.update(touched.tolist())
        self._n_live += len(ids)
        self.version += 1
        return len(ids)

    # -- compaction -----------------------------------------------------------
    def compact(self, clusters=None) -> list[int]:
        """Rebuild dirty clusters offline from their live sets: reclaims
        tombstones and slab fragmentation, refreshes alpha / rho / graph /
        entry. A compacted cluster is bitwise identical to ``rebuild()``'s
        version of it. Returns the cluster ids compacted."""
        targets = sorted(self.dirty) if clusters is None \
            else sorted(int(c) for c in np.atleast_1d(clusters))
        for c in targets:
            if not 0 <= c < self.n_clusters:
                raise ValueError(f"cluster {c} out of range")
        if not targets:
            return targets
        cids = torch.as_tensor(sorted(set(targets)), device=self.device)
        self._write_clusters(cids, _canonical(self.node_ids[cids],
                                              self.budget))
        retired = torch.isin(self._tomb_cluster, cids.to(torch.int32))
        self._tomb_cluster[retired] = -1
        self.dirty.difference_update(targets)
        self.version += 1
        return targets

    # -- export ---------------------------------------------------------------
    def snapshot(self) -> tuple[CompactIndex, HostStore]:
        """The current state as served tensors, identical shapes every call,
        so engines refresh in place. Later writes copy a mirror first, so
        the snapshot never changes."""
        self._shared.update(_SERVED)
        idx = CompactIndex(
            codes=self.codes, f_add=self.f_add, neighbors=self.neighbors,
            entry=self.entry, n_valid=self.n_valid, node_ids=self.node_ids,
            centroids=self.centroids, alpha=self.alpha, rho=self.rho,
            shift1=self.shift1, shift2=self.shift2,
            residual_norm=self.residual_norm, cos_theta=self.cos_theta,
            rotation=self.rotation, dim=self.dim)
        return idx, HostStore(vectors=self.vectors, centroids=self.centroids)

    def rebuild(self) -> tuple[CompactIndex, HostStore]:
        """From-scratch rebuild of the CURRENT live set under the frozen
        routing (same centroids / rotation / budget): the parity reference.
        After ``compact()``, ``snapshot()`` equals it bitwise."""
        gids = self.live_ids()
        cl = self.loc[gids, 0].long()
        by = torch.sort(cl, stable=True).indices       # ascending id within
        cl, gids = cl[by], gids[by]
        counts = torch.bincount(cl, minlength=self.n_clusters)
        pos = torch.arange(len(cl), device=self.device) \
            - (torch.cumsum(counts, 0) - counts)[cl]
        rows = torch.full((self.n_clusters, self.budget), -1,
                          dtype=torch.int32, device=self.device)
        rows[cl, pos] = gids.to(torch.int32)
        out = compact_index_mod.encode_clusters(
            self.vectors, rows, self.centroids, self.rotation, self.icfg,
            mem_bytes=self.mem_bytes)
        self._shared.add("vectors")
        idx = CompactIndex(node_ids=rows, centroids=self.centroids,
                           rotation=self.rotation, dim=self.dim, **out)
        return idx, HostStore(vectors=self.vectors, centroids=self.centroids)

    # -- churn-honest memory accounting ---------------------------------------
    def cluster_bytes(self) -> tuple[np.ndarray, np.ndarray]:
        """(spoken_for, reclaimable) compact bytes per cluster: the full
        padded budget is spoken for (slab headroom is a promise to future
        inserts), tombstoned rows are reclaimable at the next compact()."""
        bpn = compact_bytes_per_node(self.icfg.dim, self.icfg.degree)
        spoken = np.full(self.n_clusters, self.budget * bpn, np.float64)
        reclaimable = self.tomb.sum(1).cpu().numpy().astype(np.float64) * bpn
        return spoken, reclaimable

    def footprint(self) -> dict:
        n_tomb = int(self.tomb.sum())
        reserved = self.n_clusters * self.budget - self.n_live - n_tomb
        return compact_index_mod.footprint_report(
            self.icfg.dim, self.icfg.degree, self.n_live,
            tombstoned=n_tomb, slab=reserved)

    def __repr__(self) -> str:
        return (f"MutableIndex(clusters={self.n_clusters}, "
                f"budget={self.budget} (slab {self.slab}), "
                f"live={self.n_live}, tombstones={int(self.tomb.sum())}, "
                f"dirty={sorted(self.dirty)}, version={self.version})")


def _canonical(node_ids: torch.Tensor, width: int) -> torch.Tensor:
    """(B, M) served ids -> (B, width) int32: each row's live ids ascending,
    then -1."""
    key = torch.where(node_ids >= 0, node_ids.long(), 2**62)
    srt = torch.sort(key, dim=1).values
    rows = torch.where(srt < 2**62, srt, -1).to(torch.int32)
    pad = width - rows.shape[1]
    return torch.nn.functional.pad(rows, (0, pad), value=-1) if pad > 0 \
        else rows[:, :width]
