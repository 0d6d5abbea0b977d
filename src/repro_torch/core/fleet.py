"""Fleet serving facades over the port's ``core.topology`` tier
(counterpart of ``repro/core/fleet.py``).

  * ``FleetScheduler`` / ``replicate_engine``: N replicas of one index
    copy; arrivals dealt round-robin / least-in-flight behind a bounded
    admission queue with credit backpressure and deadline shedding.
    Admitted results equal an unpadded single-engine search of the same
    stream.

  * ``ShardedFleet`` / ``partition_engine``: the clusters PARTITIONED
    across N engines (disjoint ``CompactIndex`` slices via
    ``placement.greedy_place``); the origin runs the IVF top-probe
    selection once, scatters each query to the <= nprobe owning engines
    (``engine.search_probed``) and merges the gathered partial top-k by
    selection alone (the ``merge_topk`` kernel), which equals a single
    engine searching the same probed clusters. The facade keeps the eager
    scatter (no admission control).

New deployments spec the tier with ``TopologyConfig(shards=N,
replicas=R).build(eng)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .pipeline import StageCosts
from .topology import (ServingTopology, TenantSpec, TopologyConfig,
                       partition_index, replicate_engine, topology)

__all__ = ["FleetScheduler", "FleetReport", "replicate_engine",
           "ShardedFleet", "ShardedReport", "partition_engine", "topology",
           "TenantSpec", "TopologyConfig"]

@dataclasses.dataclass
class FleetReport:
    """Per-stream output of FleetScheduler.run. Shed queries keep the sink
    defaults (ids -1, dists inf, latency NaN) and are flagged in ``shed``;
    percentiles/qps cover admitted queries only (goodput, honestly NaN when
    nothing completed)."""
    ids: np.ndarray          # (N, k) int32, submission order; -1 rows = shed
    dists: np.ndarray        # (N, k) f32 exact squared distances
    latency_s: np.ndarray    # (N,) completion - arrival; NaN = shed
    shed: np.ndarray         # (N,) bool
    shed_wait_s: np.ndarray  # (N,) queue wait at shed time; NaN = admitted
    shed_fraction: float
    qps: float               # admitted queries / makespan (goodput)
    p50_ms: float
    p99_ms: float
    n_queries: int
    n_admitted: int
    n_shed: int
    n_flushes: int
    flush_sizes: list
    per_engine: list         # per-worker dicts: flushes/queries/max_in_flight
    makespan_s: float
    route: str
    backend: str = ""
    tenants: dict = dataclasses.field(default_factory=dict)  # per-tenant
    # accounting


class FleetScheduler:
    """Shard one query stream across N engine replicas with admission
    control — a facade over ``ServingTopology`` with a single replica
    group. Single-engine semantics (bucket ladder, fill/deadline flush,
    bounded in-flight FIFO) are per-worker and identical to
    StreamingScheduler; the topology owns routing, the bounded admission
    queue, and the shed policy."""

    def __init__(self, engines, *, route: str = "least-in-flight",
                 buckets=None, costs: StageCosts | None = None,
                 fill_threshold: int | None = None, wait_limit_s: float = 2e-3,
                 fifo_depth: int = 4, max_batch: int = 64,
                 admission_depth: int | None = None,
                 shed_deadline_s: float | None = None,
                 tenants=None):
        if not engines:
            raise ValueError("FleetScheduler needs at least one engine")
        self._topo = ServingTopology(
            [list(engines)], route=route, buckets=buckets, costs=costs,
            fill_threshold=fill_threshold, wait_limit_s=wait_limit_s,
            fifo_depth=fifo_depth, max_batch=max_batch,
            admission_depth="auto" if admission_depth is None
            else admission_depth,
            shed_deadline_s=shed_deadline_s, tenants=tenants)
        self.engines = list(engines)
        self.route = route
        self.buckets = self._topo.buckets
        self.fill_threshold = self._topo.fill_threshold
        self.wait_limit_s = self._topo.wait_limit_s
        self.fifo_depth = self._topo.fifo_depth
        self.shed_deadline_s = self._topo.shed_deadline_s
        self.admission_depth = self._topo.admission_depth

    def run(self, queries, arrival_times=None, tenant=None) -> FleetReport:
        """Replay a (possibly timed) stream through the fleet; see
        StreamingScheduler.run for the arrival-replay semantics (and
        ServingTopology.run for ``tenant`` tagging against a registry
        passed at construction)."""
        r = self._topo.run(queries, arrival_times, tenant=tenant)
        per_engine = [{k: d[k] for k in ("engine", "flushes", "queries",
                                         "max_in_flight", "compiles")}
                      for d in r.per_engine]
        return FleetReport(
            ids=r.ids, dists=r.dists, latency_s=r.latency_s, shed=r.shed,
            shed_wait_s=r.shed_wait_s, shed_fraction=r.shed_fraction,
            qps=r.qps, p50_ms=r.p50_ms, p99_ms=r.p99_ms,
            n_queries=r.n_queries, n_admitted=r.n_admitted, n_shed=r.n_shed,
            n_flushes=r.n_flushes, flush_sizes=r.flush_sizes,
            per_engine=per_engine, makespan_s=r.makespan_s, route=r.route,
            backend=r.backends[0], tenants=r.tenants)


# ---------------------------------------------------------------------------
# Sharded fleet tier: partition the index across engines (paper Fig 18)
# ---------------------------------------------------------------------------


def partition_engine(eng, n_parts: int, *, mem_budget: int | None = None,
                     strict: bool = False, modes=None, inner_shards: int = 1,
                     freq: np.ndarray | None = None,
                     heat: np.ndarray | None = None,
                     **stream_kw) -> "ShardedFleet":
    """Partition one built engine's clusters across ``n_parts`` engines and
    wrap them in a ``ShardedFleet`` (see ``core.topology.partition_index``
    for the slicing semantics: disjoint cluster slices via
    ``placement.greedy_place``, ~1/N memory per engine, optional strict
    ``mem_budget``, per-partition backends ``modes``; ``heat`` places by
    measured ``cluster_hits`` in place of the size prior).

    Extra keyword args flow to the ShardedFleet stream parameters
    (buckets, fill_threshold, wait_limit_s, fifo_depth, ...). For the same
    partitioning with tier-wide admission control, shedding and per-shard
    replicas, build ``TopologyConfig(shards=N, replicas=R).build(eng)``."""
    engines, pl = partition_index(eng, n_parts, mem_budget=mem_budget,
                                  strict=strict, modes=modes,
                                  inner_shards=inner_shards, freq=freq,
                                  heat=heat)
    return ShardedFleet(engines, part_of=pl.shard_of,
                        local_cid=pl.local_slot,
                        centroids=eng.index.centroids, **stream_kw)


@dataclasses.dataclass
class ShardedReport:
    """Per-stream output of ShardedFleet.run. A query with no probe left
    keeps the sink defaults (ids -1, dists inf), is counted in
    ``n_unrouted``, and completes at arrival."""
    ids: np.ndarray          # (N, k) int32, submission order
    dists: np.ndarray        # (N, k) f32 exact squared distances
    latency_s: np.ndarray    # (N,) completion - arrival
    qps: float
    p50_ms: float
    p99_ms: float
    n_queries: int
    n_flushes: int           # scatter flushes summed over shards
    flush_sizes: list
    n_merges: int            # origin gather/merge flushes
    merge_sizes: list
    fanout_mean: float       # mean shards scattered to per query
    n_unrouted: int
    per_engine: list         # per-shard dicts: backend/flushes/queries/...
    makespan_s: float
    backends: list           # per-shard declared backend (scfg.mode)


class ShardedFleet:
    """Scatter/gather serving over a PARTITIONED index (paper Fig 18) — a
    facade over ``ServingTopology`` with one single-replica group per
    shard, in the eager-scatter configuration (no admission queue, no
    shedding: arrivals scatter immediately and flushes self-limit on
    engine credits).

    The origin runs the IVF top-probe selection once per query (the same
    ``cluster_filter`` a single engine runs), scatters the query only
    to the <= nprobe engines owning its probed clusters, each engine
    beam-searches exactly those clusters and returns an exact-reranked
    partial top-k, and the origin merges the gathered pre-sorted partials
    by selection alone (``kernels.ops.merge_topk``), equal to a
    single engine searching the same probed clusters (clusters partition
    the corpus, so cross-shard candidates never collide and the shards'
    exact distances reproduce the single-engine ranking without any
    origin-side recompute). The parity contract
    presumes no lane-capacity overflow on either side: under extreme
    cluster-popularity skew a multi-inner-shard reference engine can drop
    lanes (``SearchStats.dropped_lanes``) where a 1-inner-shard partition
    cannot, and candidate sets then legitimately differ — size
    ``lane_capacity_factor`` for zero drops when parity matters.

    Heterogeneity-aware routing: shards may declare different backends
    (``partition_engine(modes=...)``), and ``run(..., backend=...)`` sends
    each query only to shards declaring the backend it asks for."""

    def __init__(self, engines, part_of, local_cid, centroids, *,
                 buckets=None, costs: StageCosts | None = None,
                 fill_threshold: int | None = None,
                 wait_limit_s: float = 2e-3, fifo_depth: int = 4,
                 max_batch: int = 64, exec: str = "inproc"):
        if not engines:
            raise ValueError("ShardedFleet needs at least one engine")
        self._topo = ServingTopology(
            [[e] for e in engines], part_of=part_of, local_cid=local_cid,
            centroids=centroids, buckets=buckets, costs=costs,
            fill_threshold=fill_threshold, wait_limit_s=wait_limit_s,
            fifo_depth=fifo_depth, max_batch=max_batch,
            admission_depth=None, shed_deadline_s=None, backpressure=False,
            exec=exec)
        self.engines = list(engines)
        self.part_of = self._topo.part_of
        self.local_cid = self._topo.local_cid
        self.centroids = self._topo.centroids
        self.k = self._topo.k
        self.nprobe = self._topo.nprobe
        self.modes = list(self._topo.modes)
        self.vectors = self._topo.vectors
        self.buckets = self._topo.buckets
        self.fill_threshold = self._topo.fill_threshold
        self.wait_limit_s = self._topo.wait_limit_s
        self.fifo_depth = self._topo.fifo_depth
        self.fanout = self._topo.fanout

    def run(self, queries, arrival_times=None, backend=None) -> ShardedReport:
        """Replay a (possibly timed) stream through the sharded fleet; see
        StreamingScheduler.run for the arrival-replay semantics. ``backend``
        (None | registry key | per-query sequence of keys / None) restricts
        each query to the shards declaring a matching backend
        (``ServingTopology.run``)."""
        r = self._topo.run(queries, arrival_times, backend=backend)
        per_engine = [{"engine": d["shard"], "backend": d["backend"],
                       "flushes": d["flushes"], "queries": d["queries"],
                       "max_in_flight": d["max_in_flight"],
                       "clusters": d["clusters"]}
                      for d in r.per_engine]
        return ShardedReport(
            ids=r.ids, dists=r.dists, latency_s=r.latency_s,
            qps=r.n_queries / r.makespan_s if r.makespan_s > 0 else 0.0,
            p50_ms=r.p50_ms, p99_ms=r.p99_ms, n_queries=r.n_queries,
            n_flushes=r.n_flushes, flush_sizes=r.flush_sizes,
            n_merges=r.n_merges, merge_sizes=r.merge_sizes,
            fanout_mean=r.fanout_mean, n_unrouted=r.n_unrouted,
            per_engine=per_engine, makespan_s=r.makespan_s,
            backends=r.backends)
