"""O2 (offline half) — greedy frequency-aware cluster -> shard placement
(counterpart of ``repro/core/placement.py``; numpy, host side).

The placement permutes cluster ids so that reshaping the permuted
cluster-stacked tensors to (n_shards, clusters_per_shard, ...) gives the
balanced layout, and keeps the inverse map the router uses.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Placement", "greedy_place"]


@dataclasses.dataclass(frozen=True)
class Placement:
    order: np.ndarray          # (C,) cluster ids in shard-major order
    shard_of: np.ndarray       # (C,) PRIMARY shard id per original cluster id
    local_slot: np.ndarray     # (C,) slot within the primary shard
    n_shards: int
    per_shard: int             # primary clusters per shard (padded equal)
    load: np.ndarray           # (S,) final per-shard load estimate
    mem: np.ndarray | None = None  # (S,) final per-shard compact bytes
    mem_reclaimable: np.ndarray | None = None
    # (S,) per-shard bytes held by tombstoned rows: resident (and counted
    # in ``mem``) but recoverable at the next compaction

    # -- hot-cluster replication (multi-owner map; None = single-owner) ------
    owners_of: np.ndarray | None = None
    # (C, R) owning shard per cluster; column 0 is ``shard_of``, later
    # columns are replica owners, -1 where the cluster has fewer owners
    locals_of: np.ndarray | None = None
    # (C, R) the cluster's local id on each owner, aligned with
    # ``owners_of`` (-1 where no owner)
    resident_table: np.ndarray | None = None
    # (S, per_shard + cap) cluster ids RESIDENT per shard in local-slot
    # order: the primary members, then replica copies, then pad copies

    @property
    def replicated(self) -> bool:
        """True when some clusters carry replica owners (multi-owner map)."""
        return self.owners_of is not None

    def permute(self, arr: np.ndarray) -> np.ndarray:
        """Reorder a (C, ...) cluster-stacked array into shard-major order."""
        return arr[self.order]

    def members(self, shard: int) -> np.ndarray:
        """PRIMARY cluster ids placed on ``shard``, in local-slot order:
        slot s of the shard is members(shard)[s]."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} outside 0..{self.n_shards - 1}")
        return self.order[shard * self.per_shard:(shard + 1) * self.per_shard]

    def resident(self, shard: int) -> np.ndarray:
        """Every cluster id RESIDENT on ``shard`` in local-slot order: the
        slice the serving tier cuts per engine; without replication it is
        exactly ``members(shard)``."""
        if self.resident_table is None:
            return self.members(shard)
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} outside 0..{self.n_shards - 1}")
        return self.resident_table[shard]


def greedy_place(freq: np.ndarray, bytes_per_cluster: np.ndarray,
                 n_shards: int, mem_budget: int | None = None,
                 strict: bool = False,
                 reclaimable: np.ndarray | None = None) -> Placement:
    """LPT-style greedy: clusters in decreasing frequency order, each to the
    least-loaded shard with load and memory headroom. ``mem_budget`` caps
    per-shard bytes: a soft cap by default, a ValueError with ``strict``.
    ``reclaimable`` (C,) bytes are summed per shard into
    ``mem_reclaimable``."""
    c = len(freq)
    if c % n_shards:
        raise ValueError(f"{c} clusters not divisible by {n_shards} shards "
                         f"— pad n_clusters")
    per_shard = c // n_shards
    load = np.zeros(n_shards, np.float64)
    mem = np.zeros(n_shards, np.float64)
    count = np.zeros(n_shards, np.int64)
    shard_of = np.full(c, -1, np.int32)

    # stable descending sort: tied frequencies keep ascending cluster ids
    order_desc = np.argsort(-freq.astype(np.float64), kind="stable")
    for cid in order_desc:
        cand = np.nonzero(count < per_shard)[0]
        if mem_budget is not None:
            fits = cand[mem[cand] + bytes_per_cluster[cid] <= mem_budget]
            if len(fits):
                cand = fits
            elif strict:
                raise ValueError(
                    f"cluster {cid} ({bytes_per_cluster[cid]:.0f} B) fits no "
                    f"shard within mem_budget={mem_budget} "
                    f"(open shards already hold {mem[cand]} bytes)")
        s = cand[np.argmin(load[cand])]
        shard_of[cid] = s
        load[s] += freq[cid]
        mem[s] += bytes_per_cluster[cid]
        count[s] += 1

    # shard-major order with stable slot assignment
    order = np.argsort(shard_of * c + np.arange(c), kind="stable")
    local_slot = np.empty(c, np.int32)
    for s in range(n_shards):
        local_slot[order[s * per_shard:(s + 1) * per_shard]] = \
            np.arange(per_shard)
    mem_rec = None
    if reclaimable is not None:
        reclaimable = np.asarray(reclaimable, np.float64)
        if reclaimable.shape != (c,):
            raise ValueError(f"reclaimable shape {reclaimable.shape} != "
                             f"({c},)")
        mem_rec = np.zeros(n_shards, np.float64)
        np.add.at(mem_rec, shard_of, reclaimable)
    return Placement(order=order.astype(np.int32), shard_of=shard_of,
                     local_slot=local_slot, n_shards=n_shards,
                     per_shard=per_shard, load=load, mem=mem,
                     mem_reclaimable=mem_rec)
