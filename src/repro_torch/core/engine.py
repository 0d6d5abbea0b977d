"""PIMCQG engine — the end-to-end query path (counterpart of
``repro/core/engine.py``).

    host: cluster filter -> lane routing -> per-lane LUT prep
    PU  : beam search over the compact clusters of each shard
    host: gather candidates -> exact rerank -> top-k

All S shards live on one device: the JAX package's vmap over the shard
axis becomes lanes flattened to (S * capacity,), each carrying its shard,
and the placed index stays (S, Cl, ...). The search runs eagerly; its two
kernels are ``beam_search`` (every lane's whole beam search, one launch)
or, with ``scan="gemv"``, ``cluster_scan``, and ``topk_select`` (the
rerank). Entry points run on the card unless the caller passes
``device="cpu"``.

The search of a batch over an explicit probe table, from lane routing to
the exact rerank, is one function, ``probed_block``, over the tensors a
partition's search reads (``ShardState``): the engine runs it, and so does
each rank of the mesh execution backend over the partition it holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import backends as backends_mod
from . import beam_search, compact_index, ivf, placement as placement_mod
from . import rerank as rerank_mod

__all__ = ["SearchConfig", "PlacedIndex", "PIMCQGEngine", "SearchStats",
           "ShardState", "probed_block", "place_arrays", "route_lanes"]


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    nprobe: int = 8
    ef: int = 40              # over-fetched candidate set size per lane
    k: int = 10
    max_iters: int = 64       # beam-expansion cap per lane
    mode: str = "mulfree"     # RankingBackend registry key
    scan: str = "beam"        # 'beam' | 'gemv' (full-cluster scan)
    lane_capacity_factor: float = 2.0  # per-shard lane buffer headroom
    # adaptive early termination (ivf.adaptive_keep_mask); 0.0 = off
    adaptive_tau: float = 0.0
    adaptive_min_probes: int = 1
    adaptive_ladder: tuple = ()

    def __post_init__(self):
        if self.adaptive_tau < 0:
            raise ValueError(
                f"adaptive_tau must be >= 0 (0 disables), got "
                f"{self.adaptive_tau}")
        if self.adaptive_min_probes < 1:
            raise ValueError(
                f"adaptive_min_probes must be >= 1, got "
                f"{self.adaptive_min_probes}")
        ladder = tuple(self.adaptive_ladder)
        object.__setattr__(self, "adaptive_ladder", ladder)
        if any(int(r) != r or r < 1 for r in ladder) or \
                list(ladder) != sorted(set(ladder)):
            raise ValueError(
                f"adaptive_ladder must be strictly-ascending positive "
                f"ints, got {ladder!r}")
        if self.scan not in ("beam", "gemv"):
            raise ValueError(f"scan must be 'beam' or 'gemv', got "
                             f"{self.scan!r}")


@dataclasses.dataclass(frozen=True)
class PlacedIndex:
    """Deployment layout: shard-major (S, Cl, ...) cluster stacks, plus the
    active backend's own slice in ``arrays``."""
    centroids: torch.Tensor  # (S, Cl, D) f32
    codes: torch.Tensor      # (S, Cl, M, W) u8
    neighbors: torch.Tensor  # (S, Cl, M, R) i32
    entry: torch.Tensor      # (S, Cl) i32
    n_valid: torch.Tensor    # (S, Cl) i32
    node_ids: torch.Tensor   # (S, Cl, M) i32
    arrays: Any              # backend NamedTuple, (S, Cl, ...) leading

    def flat(self) -> "PlacedIndex":
        """The same tensors with the shard and cluster axes merged, (S*Cl,
        ...) — the view the lanes index with flat cluster ids."""
        def f(t):
            return t.reshape(-1, *t.shape[2:])
        return PlacedIndex(
            f(self.centroids), f(self.codes), f(self.neighbors),
            f(self.entry), f(self.n_valid), f(self.node_ids),
            type(self.arrays)(*(f(t) for t in self.arrays)))


class SearchStats(NamedTuple):
    hops: torch.Tensor           # (S, capacity) i32 per-lane expansions
    dropped_lanes: torch.Tensor  # () i32 lanes lost to buffer overflow


class ShardState(NamedTuple):
    """The tensors a probed search of one engine's clusters reads: its
    placed index, its cluster -> (inner shard, slot) maps, the rotation,
    and the vectors the rerank reads, addressed by ``placed.node_ids``."""
    placed: PlacedIndex
    shard_of: torch.Tensor    # (C,) i32 inner shard of each cluster
    local_slot: torch.Tensor  # (C,) i32 slot within that shard
    rotation: torch.Tensor    # (D, D) f32
    vectors: torch.Tensor     # (N, D) f32


def _shard_major(a: torch.Tensor, pl: placement_mod.Placement):
    order = torch.as_tensor(pl.order, dtype=torch.int64, device=a.device)
    return a[order].reshape(pl.n_shards, pl.per_shard, *a.shape[1:])


def place_arrays(arrays, pl: placement_mod.Placement):
    """A backend's (C, ...) cluster-major arrays (``index_arrays``) in the
    placement's shard-major (S, Cl, ...) layout. Engines that share a
    placed index and differ in backend place only this."""
    return type(arrays)(*(_shard_major(a, pl) for a in arrays))


def _place(idx: compact_index.CompactIndex, pl: placement_mod.Placement,
           backend: backends_mod.RankingBackend) -> PlacedIndex:
    return PlacedIndex(
        *(_shard_major(a, pl) for a in (idx.centroids, idx.codes,
                                        idx.neighbors, idx.entry,
                                        idx.n_valid, idx.node_ids)),
        arrays=place_arrays(backend.index_arrays(idx), pl))


# ---------------------------------------------------------------------------
# Lane routing: (Q, nprobe) probes -> per-shard lane tables
# ---------------------------------------------------------------------------

def _lane_capacity(nq: int, nprobe: int, n_shards: int, factor: float) -> int:
    """Per-shard lane-buffer size for an nq-query batch."""
    return max(1, int(np.ceil(nq * nprobe / n_shards * factor)))


def route_lanes(probe_cids: torch.Tensor, shard_of: torch.Tensor,
                local_slot: torch.Tensor, valid_q: torch.Tensor | None = None,
                capacity_valid: int | None = None, *, n_shards: int,
                capacity: int):
    """Static-shape per-shard lane tables.

    probe_cids (Q, P) cluster ids (-1 = hole) -> lane_q (S, L) query ids and
    lane_cl (S, L) local cluster slots (-1 pad), the inverse map (Q, P) ->
    flat slot of the (S*L,) lane table (-1 if dropped), and the number of
    lanes dropped for overflow. Lanes of holes and of pad queries (valid_q
    False) sort after every real shard and never take capacity;
    ``capacity_valid`` tightens the drop threshold to the capacity an
    unpadded batch of the real queries would get."""
    q, p = probe_cids.shape
    dev = probe_cids.device
    flat_cid = probe_cids.reshape(-1)
    flat_q = torch.arange(q, dtype=torch.int32,
                          device=dev).repeat_interleave(p)
    live = flat_cid >= 0
    lane_shard = shard_of[flat_cid.clamp(min=0).long()].to(torch.int32)
    if valid_q is not None:
        live = live & valid_q.repeat_interleave(p)
    lane_shard = torch.where(live, lane_shard, n_shards)
    sh_sorted, order = torch.sort(lane_shard, stable=True)
    first = torch.searchsorted(
        sh_sorted, torch.arange(n_shards, dtype=torch.int32, device=dev),
        side="left")
    pos = torch.arange(q * p, device=dev) \
        - first[sh_sorted.clamp(0, n_shards - 1).long()]
    real = sh_sorted < n_shards
    cap = capacity if capacity_valid is None \
        else min(capacity, int(capacity_valid))
    ok = (pos < cap) & real
    dropped = (~ok & real).sum().to(torch.int32)

    # overflowing lanes go to a sink slot past the table; kept lanes have
    # unique destinations, so the scatter is order-free
    sink = n_shards * capacity
    dest = torch.where(ok, sh_sorted.long() * capacity + pos, sink)
    src_cl = local_slot[flat_cid[order].clamp(min=0).long()].to(torch.int32)
    lane_q = torch.full((sink + 1,), -1, dtype=torch.int32, device=dev)
    lane_cl = torch.full((sink + 1,), -1, dtype=torch.int32, device=dev)
    lane_q.scatter_(0, dest, flat_q[order])
    lane_cl.scatter_(0, dest, src_cl)
    inv = torch.full((q * p,), -1, dtype=torch.int32, device=dev)
    inv[order] = torch.where(ok, dest, -1).to(torch.int32)
    return (lane_q[:sink].reshape(n_shards, capacity),
            lane_cl[:sink].reshape(n_shards, capacity),
            inv.reshape(q, p), dropped)


# ---------------------------------------------------------------------------
# The probed search of one partition: route, search, gather, rerank
# ---------------------------------------------------------------------------

def _route(st: ShardState, scfg: SearchConfig, probe: torch.Tensor,
           nq: int):
    """Lane routing of a batch whose first nq rows are real, over the
    (B, P) probe table of this partition's cluster ids (-1 = hole). Lane
    capacity is reckoned over P and the partition's inner shards."""
    s = st.placed.codes.shape[0]
    b, p = probe.shape
    valid = torch.arange(b, device=probe.device) < nq
    capacity = _lane_capacity(b, p, s, scfg.lane_capacity_factor)
    cap_valid = _lane_capacity(nq, p, s, scfg.lane_capacity_factor)
    lane_q, lane_cl, inv, dropped = route_lanes(
        probe, st.shard_of, st.local_slot, valid, cap_valid,
        n_shards=s, capacity=capacity)
    return valid, lane_q, lane_cl, inv, dropped


def _lanes(st: ShardState, backend, queries, lane_q, lane_cl):
    """Flat lane table -> (flat shard view, flat cluster id per lane,
    the backend's lane LUTs, live mask)."""
    shard = st.placed.flat()
    s, cap = lane_q.shape
    per_shard = st.placed.codes.shape[1]
    lane_q, lane_cl = lane_q.reshape(-1), lane_cl.reshape(-1)
    fc = torch.arange(s, device=lane_q.device).repeat_interleave(cap) \
        * per_shard + lane_cl.clamp(min=0)
    lanes = backend.prepare_lanes(
        queries[lane_q.clamp(min=0).long()], shard.centroids[fc],
        st.rotation, shard.arrays, fc, st.rotation.shape[0])
    return shard, fc, lanes, lane_cl >= 0


def _candidates(st: ShardState, scfg: SearchConfig, queries, nq: int,
                probe):
    """Route, search every lane, and gather each query's candidates:
    -> (valid (B,), cand (B, P*ef) ids, SearchStats)."""
    backend = backends_mod.get_backend(scfg.mode)
    valid, lane_q, lane_cl, inv, dropped = _route(st, scfg, probe, nq)
    shard, fc, lanes, live = _lanes(st, backend, queries, lane_q, lane_cl)
    scan = beam_search.full_scan_lane if scfg.scan == "gemv" \
        else beam_search.beam_search_lane
    lane_cfg = backends_mod.LaneConfig(ef=scfg.ef, max_iters=scfg.max_iters,
                                       dim=st.rotation.shape[0])
    res = scan(shard, fc, lanes, backend=backend, cfg=lane_cfg, active=live)
    gids = shard.node_ids[fc[:, None], res.ids.clamp(min=0).long()]
    gids = torch.where((res.ids >= 0) & live[:, None], gids, -1)
    hops = torch.where(live, res.hops, 0).reshape(lane_q.shape)
    cand = gids[inv.clamp(min=0).long()]                  # (B, P, EF)
    cand = torch.where((inv >= 0)[..., None], cand, -1)
    cand = cand.reshape(queries.shape[0], inv.shape[1] * scfg.ef)
    return valid, cand.contiguous(), SearchStats(hops, dropped)


def probed_block(st: ShardState, scfg: SearchConfig, queries: torch.Tensor,
                 nq: int, probe: torch.Tensor
                 ) -> tuple[rerank_mod.RerankResult, SearchStats]:
    """The search of a (B, D) batch, its first nq rows real, over a (B, P)
    table of this partition's cluster ids (-1 = hole): lane routing, the
    beam (or gemv) search of every lane, the candidates' gather and the
    exact rerank. Returns the top-k of all B rows (ids -1 / dists inf on
    the pad rows and on rows with no probe) and the search stats.
    ``PIMCQGEngine.search`` / ``search_probed`` run it on the engine's own
    state; a mesh rank runs it on the partition it holds."""
    valid, cand, stats = _candidates(st, scfg, queries, nq, probe)
    out = rerank_mod.rerank(queries, cand, st.vectors, k=scfg.k)
    ids = torch.where(valid[:, None], out.ids, -1)
    dists = torch.where(valid[:, None], out.dists, float("inf"))
    return rerank_mod.RerankResult(ids, dists), stats


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class PIMCQGEngine:
    """Single-device engine: S shards, one device."""

    def __init__(self, index: compact_index.CompactIndex,
                 host: compact_index.HostStore,
                 place: placement_mod.Placement,
                 icfg: compact_index.IndexConfig, scfg: SearchConfig,
                 buckets: tuple[int, ...] | None = None,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.index = index.to(self.device)
        self.host = host.to(self.device)
        self.place = place
        self.icfg = icfg
        self.scfg = scfg
        self.backend = backends_mod.get_backend(scfg.mode)
        self.placed = _place(self.index, place, self.backend)
        self.shard_of = torch.as_tensor(place.shard_of, device=self.device)
        self.local_slot = torch.as_tensor(place.local_slot,
                                          device=self.device)
        self.buckets = tuple(sorted(set(buckets))) if buckets else ()

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, seed: int, x, icfg: compact_index.IndexConfig,
              scfg: SearchConfig, *, n_shards: int = 1,
              freq: np.ndarray | None = None, verbose: bool = False,
              buckets: tuple[int, ...] | None = None,
              device: str | torch.device = "cuda") -> "PIMCQGEngine":
        """Build the index from x (N, D) on ``device`` with a generator
        seeded by ``seed``, place it on ``n_shards`` shards, and wrap it."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        idx, host = compact_index.build_compact_index(gen, x, icfg,
                                                      verbose=verbose)
        sizes = idx.n_valid.cpu().numpy()
        bpc = sizes * compact_index.compact_bytes_per_node(icfg.dim,
                                                           icfg.degree)
        if freq is None:
            freq = sizes.astype(np.float64)   # popularity ~ size as prior
        pl = placement_mod.greedy_place(freq, bpc, n_shards)
        return cls(idx, host, pl, icfg, scfg, buckets=buckets, device=device)

    # -- query path ---------------------------------------------------------
    def _probes(self, queries: torch.Tensor) -> torch.Tensor:
        """Cluster filter (+ adaptive mask): (B, nprobe) global cluster
        ids, -1 where a probe is masked."""
        cfg = self.scfg
        probe, pdist = ivf.cluster_filter(queries, self.index.centroids,
                                          nprobe=cfg.nprobe)
        if cfg.adaptive_tau > 0:
            keep = ivf.adaptive_keep_mask(
                pdist, tau=cfg.adaptive_tau,
                min_probes=cfg.adaptive_min_probes,
                ladder=cfg.adaptive_ladder)
            probe = torch.where(keep, probe, -1)
        return probe

    def state(self) -> ShardState:
        """The tensors this engine's probed search reads."""
        return ShardState(self.placed, self.shard_of, self.local_slot,
                          self.index.rotation, self.host.vectors)

    def _route(self, queries: torch.Tensor, nq: int,
               probe: torch.Tensor | None = None):
        """Lane routing of a batch whose first nq rows are real, over the
        cluster filter's probes unless ``probe`` is given."""
        if probe is None:
            probe = self._probes(queries)
        return _route(self.state(), self.scfg, probe, nq)

    def _lanes(self, queries, lane_q, lane_cl):
        return _lanes(self.state(), self.backend, queries, lane_q, lane_cl)

    def _candidates(self, queries: torch.Tensor, nq: int,
                    probe: torch.Tensor | None = None):
        if probe is None:
            probe = self._probes(queries)
        return _candidates(self.state(), self.scfg, queries, nq, probe)

    def _padded(self, queries, pad_to: int | None):
        """(queries on the device zero-padded to pad_to rows, real rows)."""
        queries = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device)
        nq = queries.shape[0]
        b = nq if pad_to is None else int(pad_to)
        if b < nq:
            raise ValueError(f"pad_to={b} < batch size {nq}")
        if b > nq:
            queries = torch.cat([queries, queries.new_zeros(
                (b - nq, queries.shape[1]))])
        return queries, nq

    def _block(self, queries, nq: int, probe=None):
        """``probed_block`` on this engine, the real rows kept."""
        if probe is None:
            probe = self._probes(queries)
        res, stats = probed_block(self.state(), self.scfg, queries, nq,
                                  probe)
        return rerank_mod.RerankResult(res.ids[:nq], res.dists[:nq]), stats

    def search(self, queries, *, pad_to: int | None = None
               ) -> tuple[rerank_mod.RerankResult, SearchStats]:
        """Search; with pad_to=B >= len(queries) the batch is zero-padded to
        B rows, and the results of the real queries are those of an
        unpadded search."""
        queries, nq = self._padded(queries, pad_to)
        return self._block(queries, nq)

    def search_probed(self, queries, probe, *, pad_to: int | None = None
                      ) -> tuple[rerank_mod.RerankResult, SearchStats]:
        """Partial search over an EXPLICIT probe set (the sharded tier).

        probe (Q, P) int32: per-query LOCAL cluster ids of this engine to
        search; -1 entries are holes (probes owned by other engines) and
        contribute nothing. Returns the exact-reranked top-k over exactly
        those clusters; a row of all -1 probes yields ids -1 / dists inf.
        With pad_to=B the results of the real rows are those of an unpadded
        call, like ``search``."""
        probe = torch.as_tensor(probe, dtype=torch.int32).cpu()
        nq = len(queries)
        if probe.shape[0] != nq:
            raise ValueError(f"probe rows {probe.shape[0]} != queries {nq}")
        # local ids only: a global id would search the wrong cluster
        if probe.numel() and int(probe.max()) >= self.index.n_clusters:
            raise ValueError(
                f"probe id {int(probe.max())} out of range for this "
                f"engine's {self.index.n_clusters} local clusters — "
                f"search_probed takes LOCAL cluster ids (did you pass "
                f"global ids from cluster_filter on an unpartitioned "
                f"centroid set?)")
        queries, nq = self._padded(queries, pad_to)
        probe = torch.cat([probe, probe.new_full(
            (queries.shape[0] - nq, probe.shape[1]), -1)]).to(self.device)
        return self._block(queries, nq, probe)

    def search_bucketed(self, queries
                        ) -> tuple[rerank_mod.RerankResult, SearchStats]:
        """Pad an arbitrary batch to the smallest bucket that holds it."""
        nq = len(queries)
        if not self.buckets:
            return self.search(queries)
        for b in self.buckets:
            if b >= nq:
                return self.search(queries, pad_to=b)
        raise ValueError(
            f"batch of {nq} exceeds largest bucket {self.buckets[-1]}; "
            f"split upstream")

    # -- live swap ----------------------------------------------------------
    def refresh(self, index: compact_index.CompactIndex,
                host: compact_index.HostStore | None = None
                ) -> "PIMCQGEngine":
        """Swap a same-shape index (and, for a mutable index, its host
        store) under the live engine and place it anew through this
        engine's placement: the next search reads the new tensors
        (``ServingTopology.apply`` and ``apply_placement`` re-slice their
        shards this way). Shapes must match: ``MutableIndex`` pre-allocates
        its slabs and its vector capacity for exactly this. The old placed
        tensors are dropped before the new ones are made, so a swap holds
        one placed copy at a time."""
        if index.n_clusters != self.index.n_clusters \
                or index.budget != self.index.budget:
            raise ValueError(
                f"refresh needs matching shapes: "
                f"{index.n_clusters}x{index.budget} vs this engine's "
                f"{self.index.n_clusters}x{self.index.budget}")
        if host is not None:
            old, new = tuple(self.host.vectors.shape), \
                tuple(host.vectors.shape)
            if new != old:
                raise ValueError(
                    f"host store grew {old} -> {new}; pre-allocate capacity "
                    f"(MutableIndex(capacity=...)) so swaps keep every "
                    f"shape")
        self.placed = None
        if host is not None:
            self.host = host.to(self.device)
        self.index = index.to(self.device)
        self.placed = _place(self.index, self.place, self.backend)
        return self

    @property
    def compile_count(self) -> int:
        """Search executables built: always 0, the port runs eagerly. Kept
        so the serving tier reports compiles as the JAX package does."""
        return 0

    def warm(self, buckets: tuple[int, ...] | None = None) -> int:
        """One search per bucket (the engine's own ladder by default), so
        every kernel library is built and loaded before a timed stream.
        Returns the number of executables built: 0."""
        buckets = buckets if buckets is not None else self.buckets
        dummy = np.zeros((1, self.icfg.dim), np.float32)
        for b in buckets:
            self.search(dummy, pad_to=int(b))
        return 0

    # -- reporting ----------------------------------------------------------
    def footprint(self) -> dict:
        """Byte accounting of the compact index (paper Table II), with the
        live / tombstoned / reserved split."""
        idx = self.index
        occupied = int(idx.n_valid.sum())
        live = int((idx.node_ids >= 0).sum())
        reserved = idx.n_clusters * idx.budget - occupied
        return compact_index.footprint_report(
            self.icfg.dim, self.icfg.degree, live,
            tombstoned=occupied - live, slab=reserved)
