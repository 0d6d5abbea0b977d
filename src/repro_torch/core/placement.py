"""O2 (offline half) — greedy frequency-aware cluster -> shard placement
(counterpart of ``repro/core/placement.py``; numpy, host side).

The placement permutes cluster ids so that reshaping the permuted
cluster-stacked tensors to (n_shards, clusters_per_shard, ...) gives the
balanced layout, and keeps the inverse map the router uses. ``rebalance``
and ``replicate_hot`` re-place clusters from measured heat and give the
hottest clusters copies on other shards; both are the JAX package's
functions, copied, and their choices are its bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Placement", "greedy_place", "rebalance", "replicate_hot"]


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


def _as_heat(report_or_heat, c: int) -> np.ndarray:
    """Accept a (C,) heat vector OR anything carrying ``cluster_hits``
    (a ``TopologyReport``) — the measured per-cluster scatter heat."""
    hits = getattr(report_or_heat, "cluster_hits", report_or_heat)
    if hits is None:
        raise ValueError("report carries no cluster_hits (sharded runs "
                         "only) — pass a (C,) heat vector instead")
    heat = np.asarray(hits, np.float64)
    if heat.shape != (c,):
        raise ValueError(f"heat shape {heat.shape} != ({c},)")
    return heat


def rebalance(pl: Placement, report_or_heat,
              bytes_per_cluster: np.ndarray | None = None, *,
              mem_budget: int | None = None, move_penalty: float = 0.02,
              max_moves: int | None = None) -> Placement:
    """Migration-minimizing re-placement from measured heat (Helix-style
    cost-model refinement bootstrapped from the incumbent solution).

    Starts from ``pl``'s CURRENT primary assignment and repeatedly applies
    the best cluster SWAP (one cluster of the hottest shard exchanged with
    a colder cluster elsewhere) while it lowers the max per-shard heat by
    more than ``move_penalty`` x the mean shard heat per moved cluster —
    the knob that prices live migration so a marginal improvement never
    pays for two cluster moves. Swaps (never one-way moves) keep the equal
    per-shard cluster counts, so re-slicing the index through
    ``ServingTopology.apply_placement`` preserves every engine's array
    shapes, which the live swap requires. ``mem_budget`` (with
    ``bytes_per_cluster``) rejects swaps that would overflow either shard.

    ``report_or_heat`` is a (C,) heat vector or a ``TopologyReport``
    (its ``cluster_hits``). Returns a new primary-only Placement (replica
    owners are re-derived by the caller via :func:`replicate_hot`);
    untouched clusters keep their shard AND local slot, so the number of
    clusters whose rows actually move is exactly ``2 x n_swaps``."""
    c = len(pl.shard_of)
    heat = _as_heat(report_or_heat, c)
    if not move_penalty >= 0:
        raise ValueError(f"move_penalty must be >= 0, got {move_penalty}")
    bpc = None if bytes_per_cluster is None \
        else np.asarray(bytes_per_cluster, np.float64)
    shard_of = pl.shard_of.copy()
    slot_of = pl.local_slot.copy()
    s_n = pl.n_shards
    load = np.zeros(s_n, np.float64)
    np.add.at(load, shard_of, heat)
    mem = np.zeros(s_n, np.float64)
    if bpc is not None:
        np.add.at(mem, shard_of, bpc)
    gain_floor = 2.0 * move_penalty * heat.sum() / max(s_n, 1)

    n_swaps = 0
    while max_moves is None or 2 * n_swaps + 1 < max_moves:
        cur_max = load.max()
        hot = int(np.argmax(load))
        hot_members = np.nonzero(shard_of == hot)[0]
        best = None                    # (new_global_max, a, b, other)
        for other in range(s_n):
            if other == hot:
                continue
            others_max = max((load[t] for t in range(s_n)
                              if t not in (hot, other)), default=0.0)
            target = (load[hot] - load[other]) / 2.0
            if target <= 0:
                continue
            omem = np.nonzero(shard_of == other)[0]
            oheat = heat[omem]
            osort = np.argsort(oheat, kind="stable")
            for a in hot_members:
                # ideal partner: heat[b] ~= heat[a] - target; searchsorted
                # over the other shard's sorted heats finds the closest
                want = heat[a] - target
                if heat[a] <= 0:
                    continue
                pos = int(np.searchsorted(oheat[osort], want))
                for j in (pos - 1, pos):
                    if not 0 <= j < len(osort):
                        continue
                    b = omem[osort[j]]
                    d = heat[a] - heat[b]
                    if d <= 0:
                        continue
                    if mem_budget is not None and bpc is not None:
                        if mem[other] - bpc[b] + bpc[a] > mem_budget:
                            continue
                        if mem[hot] - bpc[a] + bpc[b] > mem_budget:
                            continue
                    new_max = max(others_max, load[hot] - d, load[other] + d)
                    if best is None or new_max < best[0]:
                        best = (new_max, int(a), int(b), other)
        if best is None or cur_max - best[0] <= gain_floor:
            break
        _, a, b, other = best
        shard_of[a], shard_of[b] = other, hot
        slot_of[a], slot_of[b] = slot_of[b], slot_of[a]
        load[hot] += heat[b] - heat[a]
        load[other] += heat[a] - heat[b]
        if bpc is not None:
            mem[hot] += bpc[b] - bpc[a]
            mem[other] += bpc[a] - bpc[b]
        n_swaps += 1

    order = np.empty(c, np.int32)
    order[shard_of.astype(np.int64) * pl.per_shard + slot_of] = \
        np.arange(c, dtype=np.int32)
    new_mem = mem if bpc is not None else None
    return Placement(order=order, shard_of=shard_of.astype(np.int32),
                     local_slot=slot_of.astype(np.int32), n_shards=s_n,
                     per_shard=pl.per_shard, load=load, mem=new_mem)


def replicate_hot(pl: Placement, report_or_heat,
                  bytes_per_cluster: np.ndarray | None = None, *,
                  top_h: int, copies: int = 1, mem_budget: int | None = None,
                  cap: int | None = None) -> Placement:
    """Give the ``top_h`` hottest clusters ``copies`` extra owners.

    Extends ``pl`` with the multi-owner map the scatter router consumes
    (``owners_of``/``locals_of``): each hot cluster's copies land on the
    least-heat-loaded shards other than its primary (skipping shards that
    would overflow ``mem_budget``), so probes of a hot cluster can be
    served by whichever owner currently has headroom.

    Shape stability: every shard's resident list is padded to EXACTLY
    ``per_shard + cap`` entries — unfilled replica slots hold pad copies
    of the shard's own coldest primary members, which are never entered
    in ``owners_of`` and therefore never routed to. A later re-replication
    with the same ``cap`` (e.g. from the live ``Rebalancer`` after the
    hotspot drifted) re-slices into identical per-engine shapes, keeping
    the ``apply_placement`` swap shape-stable. ``cap`` defaults to
    the smallest capacity that fits ``top_h x copies`` total copies.

    Returns a new Placement; with ``top_h == 0`` (or no positive heat)
    ``pl`` is returned unchanged — the single-owner fast path."""
    c = len(pl.shard_of)
    s_n = pl.n_shards
    heat = _as_heat(report_or_heat, c)
    if copies < 1 or copies > s_n - 1:
        raise ValueError(f"copies must be in 1..{s_n - 1} "
                         f"(one per non-primary shard), got {copies}")
    if top_h < 0:
        raise ValueError(f"top_h must be >= 0, got {top_h}")
    bpc = None if bytes_per_cluster is None \
        else np.asarray(bytes_per_cluster, np.float64)
    hot_rank = np.argsort(-heat, kind="stable")
    hot = [int(h) for h in hot_rank[:min(top_h, c)] if heat[h] > 0]
    if cap is None:
        cap = math.ceil(len(hot) * copies / s_n) if hot else 0
    if not hot and cap == 0:
        return pl

    rep_load = pl.load.astype(np.float64).copy()
    rep_mem = None if pl.mem is None else pl.mem.astype(np.float64).copy()
    counts = np.zeros(s_n, np.int64)
    copy_lists: list[list[int]] = [[] for _ in range(s_n)]
    owners_of = np.full((c, 1 + copies), -1, np.int32)
    locals_of = np.full((c, 1 + copies), -1, np.int32)
    owners_of[:, 0] = pl.shard_of
    locals_of[:, 0] = pl.local_slot
    for cid in hot:
        placed = 0
        for _ in range(copies):
            cand = [s for s in range(s_n)
                    if s != pl.shard_of[cid] and counts[s] < cap
                    and s not in owners_of[cid, 1:1 + placed]]
            if mem_budget is not None and bpc is not None:
                fits = [s for s in cand
                        if (rep_mem[s] if rep_mem is not None else 0.0)
                        + bpc[cid] <= mem_budget]
                if fits:
                    cand = fits
            if not cand:
                break                 # out of slots: fewer owners, same shape
            s = min(cand, key=lambda t: (rep_load[t], t))
            owners_of[cid, 1 + placed] = s
            locals_of[cid, 1 + placed] = pl.per_shard + counts[s]
            copy_lists[s].append(cid)
            counts[s] += 1
            # a copy takes an even split of the cluster's heat off the
            # primary — the least-loaded choice sees the projected load
            rep_load[s] += heat[cid] / (copies + 1)
            rep_load[pl.shard_of[cid]] -= heat[cid] / (copies + 1)
            if rep_mem is not None and bpc is not None:
                rep_mem[s] += bpc[cid]
            placed += 1

    resident = np.empty((s_n, pl.per_shard + cap), np.int32)
    for s in range(s_n):
        mem_s = pl.members(s)
        # pads: the shard's own coldest primaries, repeated if needed —
        # resident rows only, never owners, never routed to
        pad_order = mem_s[np.argsort(heat[mem_s], kind="stable")]
        pads = [int(pad_order[i % len(pad_order)])
                for i in range(cap - len(copy_lists[s]))]
        resident[s] = np.concatenate([
            mem_s, np.asarray(copy_lists[s] + pads, np.int32)]) \
            if (copy_lists[s] or pads) else mem_s
    return dataclasses.replace(
        pl, owners_of=owners_of, locals_of=locals_of,
        resident_table=resident, load=rep_load,
        mem=rep_mem if rep_mem is not None else pl.mem)
