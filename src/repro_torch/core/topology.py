"""The serving topology, in process (counterpart of
``repro/core/topology.py``; paper Fig 18).

One ``AdmissionController`` (bounded admission queue, deadline shedding)
fronts a tree of tier nodes:

  * ``ReplicaGroup`` deals arrivals across engine replicas that serve the
    same data (``replicate_engine``: views of one placed index).
  * ``ShardGroup`` scatters each query to the shards owning its probed
    clusters (``partition_index`` slices the clusters into disjoint
    engines; ``ivf.owner_split_op`` splits the probes), each shard answers
    an exact-reranked partial top-k (``PIMCQGEngine.search_probed``), and
    the origin merges the gathered partials with the ``merge_topk`` kernel
    on the engines' device: one launch per merge flush.

``ServingTopology`` runs admission -> deal -> pump -> harvest -> merge for
every tree shape; ``TopologyConfig(shards=S, replicas=R).build(eng)`` is
the API. Every engine of a topology, and its merge, stay on the device of
the engine it was built from.

Parity contract: admitted results of any topology equal a single engine
searching the same probed clusters. Replication shares one placed index,
partitioning keeps the cluster slices disjoint, and each shard's partial
top-k already carries exact distances, so the origin merge is selection
alone over disjoint runs.

Shards may serve different ranking backends (``modes``: a mixed tier), and
``run(backend=...)`` restricts each query to the shards that declare the
backend it asks for.

Skewed traffic: ``build(eng, heat=report.cluster_hits)`` places clusters
by measured heat, and ``replicate_hot=H`` gives the H hottest clusters
``replica_factor - 1`` copies on other shards; the origin then routes each
probe of a replicated cluster to ONE owner (``ivf.choose_owners``), so
per-query probe sets stay disjoint and the merge is unchanged.
``apply_placement`` swaps a rebalanced placement in between streams
(``autoscale.Rebalancer``), ``apply`` swaps a ``MutableIndex``'s state in,
mid-stream too (``mutable=True``), ``scale_replicas`` resizes a shard group
(``autoscale.Autoscaler``), ``tenants=`` puts a DWRR admission controller
with per-tenant queues, deadlines, credits, backends and effort in front,
and ``hedge=`` re-runs an overdue flush on another replica of its shard
(first response wins).

``exec="mesh"`` runs the sharded tier over a mesh of processes, one rank a
shard (``execbackend.MeshBackend``): one ``MeshShardWorker`` scatters each
flush to every rank and harvests every owner's partial top-k at once, under
a ``MeshShardGroup`` root with the ``ShardGroup``'s deal semantics.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
import warnings
from collections import deque

import numpy as np
import torch

from . import autoscale as autoscale_mod
from . import compact_index as compact_index_mod
from . import engine as engine_mod
from . import execbackend as execbackend_mod
from . import ivf as ivf_mod
from . import placement as placement_mod
from ..kernels import ops as kernel_ops
from .pipeline import (EngineWorker, StageCosts, StreamSink, _host,
                       percentile_ms, resolve_stream_params)
from ..distributed.straggler import (DeadlineReissue, EwmaTracker,
                                     HedgeConfig)

__all__ = ["AdmissionController", "ReplicaGroup", "ShardGroup",
           "ShardWorker", "ShardedSink", "MeshShardWorker", "MeshShardGroup",
           "ServingTopology", "TopologyReport",
           "TopologyConfig", "ShardHedge", "TenantSpec", "replicate_engine",
           "partition_index", "topology"]

ROUTE_POLICIES = ("round-robin", "least-in-flight")
SHED_POLICIES = ("drop-new", "drop-old")

# ---------------------------------------------------------------------------
# engine multiplication: replicas (one index copy) and partitions (slices)
# ---------------------------------------------------------------------------

def replicate_engine(eng, n: int) -> list:
    """N logical replicas of one built PIMCQGEngine for a single-device
    tier. Replicas share the placed index tensors (one device copy: they
    model N schedulable engines, not N copies of the corpus). The
    reference's ``share_executables`` has no counterpart: the port builds
    no executables."""
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    return [eng] + [copy.copy(eng) for _ in range(n - 1)]


def _slice_index(idx, members):
    """Row-slice a CompactIndex down to the ``members`` cluster list."""
    sel = torch.as_tensor(np.asarray(members), dtype=torch.int64,
                          device=idx.codes.device)
    return compact_index_mod.CompactIndex(
        *(f[sel] if isinstance(f, torch.Tensor) and name != "rotation"
          else f for name, f in zip(compact_index_mod.CompactIndex._fields,
                                    idx)))


def partition_index(eng, n_parts: int, *, mem_budget: int | None = None,
                    strict: bool = False, modes=None, inner_shards: int = 1,
                    freq: np.ndarray | None = None, mutable: bool = False,
                    heat: np.ndarray | None = None, replicate_hot: int = 0,
                    replica_factor: int = 2, placement=None
                    ) -> tuple[list, placement_mod.Placement]:
    """Slice one built engine's clusters into ``n_parts`` disjoint engines.

    Each partition engine holds a DISJOINT cluster slice chosen by
    ``placement.greedy_place`` over (freq, compact bytes), on the source
    engine's device: per-engine memory scales down ~1/N. ``mem_budget``
    (compact-index bytes) caps each partition; with ``strict=True`` an
    infeasible partitioning raises. ``inner_shards`` is each partition's
    intra-engine shard count. The host store (raw rerank vectors, global-id
    addressed) is shared. ``modes`` optionally gives each partition its own
    ranking backend (registry key): a mixed tier.

    ``heat`` is MEASURED per-cluster scatter heat (a report's
    ``cluster_hits``), balanced in place of the size prior (exclusive with
    ``freq``, an estimate). ``replicate_hot=H`` gives the H hottest
    clusters copies on ``replica_factor - 1`` other shards
    (``placement.replicate_hot``): each engine then holds its primary slice
    plus the copies and pads, and the router picks one owner per probe.
    ``placement`` skips the placer and slices a prebuilt Placement.
    ``mutable=True`` bills spoken-for rows: a churning index keeps every
    padded row resident, so each cluster costs its full budget, and the
    tombstoned rows are reported as ``placement.mem_reclaimable``.

    Returns (engines, placement); ``placement.shard_of`` / ``local_slot``
    are the owner map and the per-owner local cluster ids the scatter
    router consumes (``owners_of`` / ``locals_of`` the multi-owner
    forms)."""
    if n_parts < 1:
        raise ValueError(f"need at least one partition, got {n_parts}")
    if modes is not None and len(modes) != n_parts:
        raise ValueError(f"modes has {len(modes)} entries for {n_parts} "
                         f"partitions")
    if heat is not None and freq is not None:
        raise ValueError("pass EITHER heat= (measured cluster_hits) OR "
                         "freq= (estimated frequency), not both")
    if replicate_hot < 0:
        raise ValueError(f"replicate_hot must be >= 0, got {replicate_hot}")
    if replicate_hot:
        if n_parts < 2:
            raise ValueError("replicate_hot needs n_parts >= 2 (a copy "
                             "must land on a DIFFERENT shard)")
        if not 2 <= replica_factor <= n_parts:
            raise ValueError(f"replica_factor must be in 2..{n_parts} "
                             f"(owners per hot cluster), "
                             f"got {replica_factor}")
        if inner_shards != 1:
            raise ValueError("replicate_hot with inner_shards > 1 is not "
                             "supported (replica slots break the equal "
                             "inner-shard split)")
    idx, icfg = eng.index, eng.icfg
    sizes = idx.n_valid.cpu().numpy().astype(np.float64)
    bpn = compact_index_mod.compact_bytes_per_node(icfg.dim, icfg.degree)
    reclaimable = None
    if mutable:
        # live + tombstones + append-slab headroom all hold memory: bill
        # the full budget, report the tombstones as reclaimable
        bpc = np.full(len(sizes), float(idx.budget) * bpn)
        live = (idx.node_ids >= 0).sum(1).cpu().numpy().astype(np.float64)
        reclaimable = (sizes - live) * bpn
    else:
        bpc = sizes * bpn
    if heat is not None:
        freq = np.asarray(heat, np.float64)
    if freq is None:
        freq = sizes                      # popularity ~ size as prior
    if placement is not None:
        pl = placement
        if pl.n_shards != n_parts:
            raise ValueError(f"placement has {pl.n_shards} shards for "
                             f"{n_parts} partitions")
    else:
        pl = placement_mod.greedy_place(np.asarray(freq, np.float64), bpc,
                                        n_parts, mem_budget=mem_budget,
                                        strict=strict,
                                        reclaimable=reclaimable)
        if replicate_hot:
            pl = placement_mod.replicate_hot(
                pl, np.asarray(freq, np.float64), bpc,
                top_h=replicate_hot, copies=replica_factor - 1,
                mem_budget=mem_budget)
    engines = []
    for o in range(n_parts):
        members = pl.resident(o)
        sub_pl = placement_mod.greedy_place(sizes[members], bpc[members],
                                            inner_shards)
        scfg = dataclasses.replace(eng.scfg, mode=modes[o]) \
            if modes is not None else eng.scfg
        engines.append(engine_mod.PIMCQGEngine(
            _slice_index(idx, members), eng.host, sub_pl, icfg, scfg,
            buckets=eng.buckets, device=eng.device))
    return engines, pl


# ---------------------------------------------------------------------------
# admission control (numpy, as in the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract with the serving tier.

    ``weight`` sets the DWRR share under contention (quanta are weights
    normalized so the lightest tenant replenishes 1 per round).
    ``queue_depth``/``deadline_s``/``credits`` bound, respectively, how
    many of the tenant's queries may wait at admission (None = the tier's
    global depth; 0 = admit nothing), how long one may wait before it is
    shed, and how many may be dealt-but-unfinished at once (in-service
    quota — a tenant at its quota stops being dealable until completions
    release credits via ``StreamSink.on_finish``). ``shed_policy``
    chooses the overflow victim: ``drop-new`` sheds the arrival (the
    default), ``drop-old`` evicts the tenant's oldest waiter to
    make room. ``backend`` pins the tenant to shards declaring that
    RankingBackend mode; ``k``/``nprobe``/``adaptive_tau`` (+
    ``adaptive_min_probes``) override the engines' search effort for this
    tenant's queries only — nprobe/tau apply at the sharded origin
    scatter, k truncates the tenant's result rows everywhere."""

    name: str
    weight: float = 1.0
    queue_depth: int | None = None
    deadline_s: float | None = None
    credits: int | None = None
    shed_policy: str = "drop-new"
    backend: str | None = None
    k: int | None = None
    nprobe: int | None = None
    adaptive_tau: float | None = None
    adaptive_min_probes: int = 1

    def __post_init__(self):
        if not self.name:
            raise ValueError("a tenant needs a non-empty name")
        if not (isinstance(self.weight, (int, float)) and self.weight > 0):
            raise ValueError(f"tenant {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")
        if self.queue_depth is not None and self.queue_depth < 0:
            raise ValueError(f"tenant {self.name!r}: queue_depth must be "
                             f">= 0 or None, got {self.queue_depth}")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(f"tenant {self.name!r}: deadline_s must be "
                             f"> 0 or None, got {self.deadline_s}")
        if self.credits is not None and self.credits < 1:
            raise ValueError(f"tenant {self.name!r}: credits must be >= 1 "
                             f"or None, got {self.credits}")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"tenant {self.name!r}: shed_policy must be "
                             f"one of {SHED_POLICIES}, "
                             f"got {self.shed_policy!r}")
        if self.k is not None and self.k < 1:
            raise ValueError(f"tenant {self.name!r}: k must be >= 1 or "
                             f"None, got {self.k}")
        if self.nprobe is not None and self.nprobe < 1:
            raise ValueError(f"tenant {self.name!r}: nprobe must be >= 1 "
                             f"or None, got {self.nprobe}")
        if self.adaptive_tau is not None and not self.adaptive_tau >= 0:
            raise ValueError(f"tenant {self.name!r}: adaptive_tau must be "
                             f">= 0 or None, got {self.adaptive_tau}")
        if self.adaptive_min_probes < 1:
            raise ValueError(f"tenant {self.name!r}: adaptive_min_probes "
                             f"must be >= 1, got {self.adaptive_min_probes}")


class AdmissionController:
    """Bounded admission queue(s) + deadline shedding in front of a tier
    tree, scheduled deficit-weighted-round-robin across tenants.

    With no tenant registry (the default) there is ONE tenant and the
    controller is a FIFO: ``offer`` admits an arrival
    unless the queue is full (``depth`` entries; None = unbounded — a
    full queue sheds the arrival immediately), ``expire`` drops queries
    at the HEAD whose wait has reached ``deadline_s`` (each queue is
    arrival-ordered, so its head is always the oldest): every query that
    IS dealt downstream started within its deadline.

    With ``tenants`` (a list of TenantSpec, ``tenant_of`` mapping each
    query index to its tenant), each tenant gets its own bounded queue
    and the dealing order is DWRR: each rotation visit banks
    ``quantum = weight / min(weight)`` deficit (capped at quantum + 1 so
    an idle-then-bursty tenant cannot hoard service; an EMPTY queue's
    deficit resets to 0), one pop costs 1. Per-tenant ``deadline_s``
    overrides the tier deadline in ``expire``/``next_deadline`` (each
    queue's head is checked against ITS OWN deadline); per-tenant
    ``credits`` cap dealt-but-unfinished
    queries — ``pop`` takes a credit, ``release`` (wired to the sink's
    completion hook) returns it, and a tenant at its cap is skipped by
    the rotation without consuming deficit.

    Tier-node credit backpressure is the other half of the contract, but
    it lives in the tree (``room()``) — the controller only holds what
    the tree refuses."""

    def __init__(self, depth: int | None, deadline_s: float | None,
                 arrivals: np.ndarray, *, tenants=None, tenant_of=None):
        self.depth = depth
        self.deadline_s = deadline_s
        self.arr = arrivals
        self.tenants: list[TenantSpec] = \
            list(tenants) if tenants else [TenantSpec("default")]
        T = len(self.tenants)
        if tenant_of is None:
            tenant_of = np.zeros(len(arrivals), np.int32)
        self.tenant_of = np.asarray(tenant_of, np.int32)
        if len(self.tenant_of) != len(arrivals):
            raise ValueError(f"tenant_of has {len(self.tenant_of)} entries "
                             f"for {len(arrivals)} arrivals")
        self.queues: list[deque] = [deque() for _ in range(T)]
        wmin = min(s.weight for s in self.tenants)
        self.quanta = [s.weight / wmin for s in self.tenants]
        self.deficit = [0.0] * T
        self._cur: int | None = None      # DWRR rotation position
        self.in_service = [0] * T         # dealt, completion not yet seen
        self.max_in_service = [0] * T
        self.dealt = [0] * T
        self.evicted: deque = deque()     # drop-old victims awaiting shed
        self._depth = [s.queue_depth if s.queue_depth is not None else depth
                       for s in self.tenants]
        self._deadline = [s.deadline_s if s.deadline_s is not None
                          else deadline_s for s in self.tenants]

    @property
    def queue(self) -> deque:
        """The single-tenant queue (back-compat introspection handle)."""
        if len(self.queues) != 1:
            raise AttributeError("multi-tenant controller has no single "
                                 "queue; use .queues")
        return self.queues[0]

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues)

    def offer(self, idx: int) -> bool:
        """Admit an arrival; False = its tenant's queue is full, shed
        immediately (``drop-new``) — under ``drop-old`` the tenant's
        oldest waiter is evicted instead (drain via ``drain_evicted``)
        and the arrival is admitted."""
        tid = int(self.tenant_of[idx])
        q = self.queues[tid]
        d = self._depth[tid]
        if d is not None and len(q) >= d:
            if self.tenants[tid].shed_policy == "drop-old" and q:
                self.evicted.append(q.popleft())
                q.append(idx)
                return True
            return False
        q.append(idx)
        return True

    def drain_evicted(self) -> list[int]:
        """Queries evicted by drop-old offers since the last drain."""
        out = list(self.evicted)
        self.evicted.clear()
        return out

    def expire(self, t: float) -> list[int]:
        """Pop (to shed) every head-of-queue query past ITS OWN deadline
        (each tenant's queue head is checked against that tenant's
        deadline, falling back to the tier-wide one)."""
        out: list[int] = []
        for tid, q in enumerate(self.queues):
            dl = self._deadline[tid]
            if dl is None:
                continue
            while q and t - self.arr[q[0]] >= dl:
                out.append(q.popleft())
        return out

    def next_deadline(self) -> float:
        """Earliest instant any queue head would be shed (inf if none)."""
        nxt = math.inf
        for tid, q in enumerate(self.queues):
            dl = self._deadline[tid]
            if dl is not None and q:
                nxt = min(nxt, float(self.arr[q[0]]) + dl)
        return nxt

    # -- DWRR dealing ---------------------------------------------------------
    def _dealable(self, tid: int) -> bool:
        s = self.tenants[tid]
        return bool(self.queues[tid]) and (
            s.credits is None or self.in_service[tid] < s.credits)

    def peek(self) -> int | None:
        """The query DWRR would deal next, WITHOUT committing it (None =
        nothing dealable: every nonempty queue is at its credit cap).
        Idempotent — once a candidate is found the rotation parks on it,
        so repeated peeks (and the peek inside ``pop``) return the same
        query without banking extra deficit."""
        T = len(self.queues)
        if not any(self._dealable(t) for t in range(T)):
            return None
        # visiting a dealable tenant at least twice guarantees deficit >= 1
        # (each visit banks quantum >= 1), so 2T+1 steps always terminate
        for _ in range(2 * T + 1):
            cur = self._cur
            if cur is not None and self._dealable(cur) \
                    and self.deficit[cur] >= 1.0:
                return int(self.queues[cur][0])
            nxt = 0 if cur is None else (cur + 1) % T
            self._cur = nxt
            if self._dealable(nxt):
                # cap banking at one extra pop so a blocked-then-released
                # tenant cannot hoard an unbounded burst
                self.deficit[nxt] = min(self.deficit[nxt] + self.quanta[nxt],
                                        self.quanta[nxt] + 1.0)
            elif not self.queues[nxt]:
                self.deficit[nxt] = 0.0   # no banking while idle (DWRR rule)
        raise AssertionError("DWRR rotation failed to find a dealable "
                             "tenant it proved exists")

    def pop(self) -> int | None:
        """Commit the peeked query: pop it, spend 1 deficit, take an
        in-service credit. None = nothing dealable."""
        idx = self.peek()
        if idx is None:
            return None
        tid = self._cur
        assert self.queues[tid][0] == idx
        self.queues[tid].popleft()
        self.deficit[tid] -= 1.0
        self.in_service[tid] += 1
        self.max_in_service[tid] = max(self.max_in_service[tid],
                                       self.in_service[tid])
        self.dealt[tid] += 1
        return idx

    def release(self, idxs):
        """Return in-service credits on completion (the StreamSink
        ``on_finish`` hook)."""
        for i in np.atleast_1d(np.asarray(idxs)):
            self.in_service[int(self.tenant_of[int(i)])] -= 1


# ---------------------------------------------------------------------------
# tier nodes (per-run runtime objects; leaves are EngineWorkers)
# ---------------------------------------------------------------------------

class ReplicaGroup:
    """Deal arrivals across N children serving the SAME data (engine
    replicas of one index copy — or of one partition, under a ShardGroup).

    Routing honors credits: ``round-robin`` deterministically cycles the
    children with room; ``least-in-flight`` joins the shortest queue
    (device FIFO depth, then buffer). ``deal`` consumes an admission queue
    in flush-sized chunks (one chunk = at most one flush quantum, so
    round-robin genuinely interleaves engines instead of filling the
    first); ``submit`` places a single query (the ShardGroup's scatter
    path, where the query's shard is fixed and only the replica is
    chosen)."""

    def __init__(self, workers: list, route: str = "least-in-flight"):
        self.children = list(workers)
        self.route = route
        self._rr = 0

    # -- capacity -----------------------------------------------------------
    def room(self) -> int:
        return sum(w.room() for w in self.children)

    def _pick(self):
        """Next child to feed, honoring credits; None = all backpressured."""
        if self.route == "round-robin":
            for off in range(len(self.children)):
                w = self.children[(self._rr + off) % len(self.children)]
                if w.room() > 0:
                    self._rr = (self._rr + off + 1) % len(self.children)
                    return w
            return None
        live = [w for w in self.children if w.room() > 0]
        if not live:
            return None
        return min(live, key=lambda w: (w.in_flight, len(w.buf)))

    # -- intake -------------------------------------------------------------
    def deal(self, admission: AdmissionController, quantum: int):
        """Deal queries from the admission queues (DWRR order) to children
        in flush-sized chunks; stops when every child is out of credits OR
        every waiting tenant is at its in-service quota (the queries wait
        upstream — credit-based backpressure)."""
        while len(admission):
            w = self._pick()
            if w is None:
                return
            for _ in range(min(w.room(), quantum, len(admission))):
                idx = admission.pop()
                if idx is None:
                    return                # waiting tenants all credit-capped
                w.submit(idx)

    def submit(self, idx: int):
        """Place one query on a replica (credit-aware; when every child is
        saturated the least-loaded one buffers it — a ShardGroup parent
        only scatters while the group has room, so this fallback fires
        only in eager-scatter mode)."""
        w = self._pick()
        if w is None:
            w = min(self.children, key=lambda c: (c.in_flight, len(c.buf)))
        w.submit(idx)

    # -- pump / harvest -----------------------------------------------------
    def pump(self, t: float, drain: bool) -> bool:
        progress = False
        for w in self.children:
            progress |= w.pump(t, drain=drain, block_when_full=False)
        return progress

    def harvest(self) -> bool:
        got = False
        for w in self.children:
            got |= w.harvest(block=False)
        return got

    def block_harvest_one(self) -> bool:
        """Block on the first child with work in flight (the run loop's
        last resort when no deadline is pending)."""
        for w in self.children:
            if w.inflight:
                w.harvest(block=True)
                return True
        return False

    def next_deadline(self) -> float:
        return min((w.next_deadline() for w in self.children),
                   default=math.inf)

    def idle(self) -> bool:
        return all(w.idle() for w in self.children)

    def workers(self):
        yield from self.children


class ShardHedge:
    """Per-run hedged-dispatch state of a sharded tier: one
    ``DeadlineReissue`` per shard (flush latency is a property of the
    shard's data slice, so each shard tracks its own EWMA), the registry of
    a flush's batch id to its shard and queries, and of a result object to
    its batch id, so the FIRST result to complete, original or duplicate,
    wins and the loser is dropped before it touches the gather slots."""

    def __init__(self, cfg: HedgeConfig, n_shards: int, clock):
        self.cfg = cfg
        self.per_shard = [
            DeadlineReissue(k=cfg.k, max_reissue=cfg.max_reissue,
                            clock=clock,
                            tracker=EwmaTracker(alpha=cfg.alpha))
            for _ in range(n_shards)]
        self.flights: dict = {}           # bid -> (shard, query idxs, origin)
        self._by_res: dict = {}           # id(result) -> bid
        self._next_bid = 0

    def register(self, shard: int, idxs, res, origin=None) -> int:
        """Record a primary flush; returns its batch id. ``origin`` (the
        dispatching worker) is never picked as the reissue target."""
        bid = self._next_bid
        self._next_bid += 1
        self.flights[bid] = (shard, np.asarray(idxs), origin)
        self.per_shard[shard].dispatch(bid)
        self._by_res[id(res)] = bid
        return bid

    def bind(self, res, bid: int):
        """Associate a speculative duplicate's result with the flush."""
        self._by_res[id(res)] = bid

    def complete(self, res, shard: int) -> bool:
        """First completion wins; False = duplicate, drop the deposit."""
        bid = self._by_res.pop(id(res), None)
        if bid is None:
            return True                   # unhedged flush (defensive)
        first = self.per_shard[shard].complete(bid)
        if first:
            self.flights.pop(bid, None)
        return first

    # -- accounting (TopologyReport) ----------------------------------------
    @property
    def n_reissued(self) -> int:
        return sum(dr.reissued_total for dr in self.per_shard)

    @property
    def n_duplicate_drops(self) -> int:
        return sum(dr.duplicate_results for dr in self.per_shard)

    @property
    def shard_ewma_ms(self) -> list:
        return [float("nan") if dr.tracker.value is None
                else dr.tracker.value * 1e3 for dr in self.per_shard]


class ShardWorker(EngineWorker):
    """EngineWorker over one PARTITION of the index. A flush carries the
    per-query probe rows for this engine's clusters (the scatter payload,
    consumed by ``engine.search_probed``), and a harvest deposits PARTIAL
    top-k into the ShardedSink's gather slots instead of final results.

    With ``hedge`` (a per-run ShardHedge) every primary flush is registered
    for deadline tracking, ``hedge_dispatch`` re-runs an overdue flush on
    this replica, and ``_finish`` drops the loser of each race. On one
    card every replica queues on the same stream, so a duplicate runs
    after its primary; the first result the readiness test sees wins."""

    def __init__(self, engine, sink: "ShardedSink", *, probes: np.ndarray,
                 slot: np.ndarray, shard: int = 0,
                 hedge: ShardHedge | None = None, **kw):
        super().__init__(engine, sink, **kw)
        self.probes = probes              # (N, P) local cluster ids, -1 hole
        self.slot = slot                  # (N,) this shard's gather slot
        self.shard = shard
        self.hedge = hedge

    def _dispatch(self, take):
        out = self.exec.search_probed(
            self.engine, self.sink.q[take], self.probes[take],
            pad_to=self._bucket_for(len(take)))
        if self.hedge is not None:
            self.hedge.register(self.shard, take, out[0], origin=self)
        return out

    def hedge_dispatch(self, idxs: np.ndarray, bid: int, t: float):
        """Re-run an overdue flush on THIS replica. It enters the in-flight
        FIFO directly (no buffer, no credit check: its queries were already
        admitted and dealt; ``max_reissue`` bounds the duplicate work)."""
        res, _ = self.exec.search_probed(
            self.engine, self.sink.q[idxs], self.probes[idxs],
            pad_to=self._bucket_for(len(idxs)))
        self.hedge.bind(res, bid)
        self.inflight.append((np.asarray(idxs), res, t, self._event()))
        self.max_in_flight = max(self.max_in_flight, len(self.inflight))

    def _finish(self, idxs, res, _t_dispatch):
        if self.hedge is not None \
                and not self.hedge.complete(res, self.shard):
            return                        # lost the race: drop, don't deposit
        self.sink.finish_partial(idxs, self.slot[idxs], _host(res.ids),
                                 _host(res.dists))


class ShardedSink(StreamSink):
    """StreamSink plus the gather stage of the sharded tier: a per-query
    buffer of each owning shard's partial top-k (slot-major), a countdown
    of outstanding shards, and the queue of fully-gathered queries awaiting
    the origin's k-selection merge."""

    def __init__(self, queries: np.ndarray, arrivals: np.ndarray, k: int,
                 fanout: int):
        super().__init__(queries, arrivals, k)
        n = len(queries)
        self.k = k
        self.part_ids = np.full((n, fanout * k), -1, np.int32)
        self.part_d = np.full((n, fanout * k), np.inf, np.float32)
        self.pending = np.zeros(n, np.int32)
        self.ready: deque = deque()       # (idx, gather-complete time)

    def finish_partial(self, idxs: np.ndarray, slots: np.ndarray,
                       ids: np.ndarray, dists: np.ndarray):
        cols = slots[:, None] * self.k + np.arange(self.k)
        self.part_ids[idxs[:, None], cols] = ids
        self.part_d[idxs[:, None], cols] = dists
        self.pending[idxs] -= 1
        t = self.now()
        for i in idxs[self.pending[idxs] == 0]:
            self.ready.append((int(i), t))


class ShardGroup:
    """Scatter each dealt query to the children (per-shard ReplicaGroups)
    owning its probed clusters. With ``backpressure`` every touched child
    must have room before the query leaves the admission queue (head-of-
    line FIFO, so deadline shedding upstream stays honest); without it the
    ShardedFleet eager scatter is reproduced (children buffer unboundedly,
    flushes self-limit on engine credits)."""

    def __init__(self, children: list, touches: np.ndarray,
                 pending: np.ndarray, sink: ShardedSink, k: int,
                 backpressure: bool, hedge: ShardHedge | None = None):
        self.children = list(children)
        self.touches = touches            # (N, O) bool
        self.pending = pending            # (N,) owners still outstanding
        self.sink = sink
        self.backpressure = backpressure
        self.hedge = hedge
        self._none_ids = np.full((1, k), -1, np.int32)
        self._none_d = np.full((1, k), np.inf, np.float32)

    def hedge_poll(self, t: float) -> bool:
        """Reissue overdue flushes: each shard's DeadlineReissue nominates
        batches past k x EWMA, and each is re-dispatched on the
        LEAST-LOADED other replica of that shard."""
        if self.hedge is None:
            return False
        did = False
        for dr in self.hedge.per_shard:
            for bid in dr.poll():
                shard, idxs, origin = self.hedge.flights[bid]
                alts = [c for c in self.children[shard].children
                        if c is not origin]
                if not alts:
                    continue              # single replica: nowhere to hedge
                w = min(alts, key=lambda c: (c.in_flight, len(c.buf)))
                w.hedge_dispatch(idxs, bid, t)
                did = True
        return did

    def deal(self, admission: AdmissionController, quantum: int):
        while len(admission):
            idx = admission.peek()
            if idx is None:
                return                    # waiting tenants all credit-capped
            if self.pending[idx] == 0:    # unrouted: completes immediately
                admission.pop()
                self.sink.finish(np.asarray([idx]), self._none_ids,
                                 self._none_d)
                continue
            owners = np.nonzero(self.touches[idx])[0]
            if self.backpressure and any(
                    self.children[int(o)].room() <= 0 for o in owners):
                return                    # head waits; deadline may shed it
            admission.pop()
            for o in owners:
                self.children[int(o)].submit(idx)

    def pump(self, t: float, drain: bool) -> bool:
        progress = self.hedge_poll(t)
        for c in self.children:
            progress |= c.pump(t, drain)
        return progress

    def harvest(self) -> bool:
        got = False
        for c in self.children:
            got |= c.harvest()
        return got

    def block_harvest_one(self) -> bool:
        for c in self.children:
            if c.block_harvest_one():
                return True
        return False

    def next_deadline(self) -> float:
        nxt = min((c.next_deadline() for c in self.children),
                  default=math.inf)
        if self.hedge is not None:
            # a pending reissue is a deadline too: wake AT it instead of
            # blocking on the straggler it would rescue
            nxt = min([nxt] + [dr.next_deadline()
                               for dr in self.hedge.per_shard])
            if self.hedge.flights:
                # first-response-wins cannot be had by blocking on one
                # child: while a tracked flush is out, keep polling (0.0 is
                # always past, so the loop naps instead of blocking)
                nxt = min(nxt, 0.0)
        return nxt

    def idle(self) -> bool:
        return all(c.idle() for c in self.children)

    def workers(self):
        for c in self.children:
            yield from c.workers()


class MeshShardWorker(EngineWorker):
    """ONE worker driving the whole shard set on a mesh of ranks: a flush
    scatters the batch's per-owner probe tables to every rank through the
    ``MeshBackend`` (each rank searches its own partition), and a single
    harvest deposits EVERY owner's partial top-k at once, the all_gather
    having brought them to the origin. The flush / credit / FIFO machinery
    is inherited unchanged, so admission control and backpressure behave
    exactly as in process.

    ``engine`` is the MeshBackend itself: it exposes ``compile_count`` (the
    worker report's only engine touchpoint on this path), and
    ``_dispatch`` goes through ``search_scattered``. A flush is ready when
    its all_gather has completed (``MeshResult.query``), where an
    in-process flush asks a CUDA event."""

    def __init__(self, backend, sink: "ShardedSink", *, tables: np.ndarray,
                 touches: np.ndarray, slots: np.ndarray, **kw):
        super().__init__(backend, sink, **kw)
        self.tables = tables              # (O, N, P) per-owner local cids
        self.touches = touches            # (N, O) bool
        self.slots = slots                # (N, O) gather slot per owner
        self.n_owners = tables.shape[0]
        self.queries_per_shard = np.zeros(self.n_owners, np.int64)
        self._last = None

    def _dispatch(self, take):
        t = np.asarray(take)
        self._last = self.engine.search_scattered(
            self.sink.q[t], self.tables[:, t, :],
            pad_to=self._bucket_for(len(t)))
        return self._last, None

    def _event(self):
        return self._last

    def _finish(self, idxs, res, _t_dispatch):
        nq = len(idxs)
        ids = res.ids[:, :nq]             # (O, nq, k)
        ds = res.dists[:, :nq]
        for o in range(self.n_owners):
            m = self.touches[idxs, o]
            if m.any():
                sel = idxs[m]
                self.sink.finish_partial(sel, self.slots[sel, o],
                                         ids[o][m], ds[o][m])
                self.queries_per_shard[o] += int(m.sum())


class MeshShardGroup:
    """Tree root for the mesh execution backend: the ShardGroup's deal
    semantics (unrouted queries complete immediately; head-of-line
    backpressure on the worker's credits) over a SINGLE MeshShardWorker;
    the per-owner fan-out happens inside the collective, not in the
    tree."""

    def __init__(self, worker: MeshShardWorker, pending: np.ndarray,
                 sink: ShardedSink, k: int, backpressure: bool):
        self.worker = worker
        self.pending = pending
        self.sink = sink
        self.backpressure = backpressure
        self._none_ids = np.full((1, k), -1, np.int32)
        self._none_d = np.full((1, k), np.inf, np.float32)

    def deal(self, admission: AdmissionController, quantum: int):
        while len(admission):
            idx = admission.peek()
            if idx is None:
                return                    # waiting tenants all credit-capped
            if self.pending[idx] == 0:    # unrouted: completes immediately
                admission.pop()
                self.sink.finish(np.asarray([idx]), self._none_ids,
                                 self._none_d)
                continue
            if self.backpressure and self.worker.room() <= 0:
                return                    # head waits; deadline may shed it
            admission.pop()
            self.worker.submit(idx)

    def pump(self, t: float, drain: bool) -> bool:
        return self.worker.pump(t, drain=drain, block_when_full=False)

    def harvest(self) -> bool:
        return self.worker.harvest(block=False)

    def block_harvest_one(self) -> bool:
        if self.worker.inflight:
            self.worker.harvest(block=True)
            return True
        return False

    def next_deadline(self) -> float:
        return self.worker.next_deadline()

    def idle(self) -> bool:
        return self.worker.idle()

    def workers(self):
        yield self.worker


# ---------------------------------------------------------------------------
# the unified topology
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TopologyReport:
    """Per-stream output of ServingTopology.run — the union of the fleet
    and sharded reports. Shed queries keep the sink defaults (ids -1,
    dists inf, latency NaN) and are flagged in ``shed``; percentiles/qps
    cover admitted queries only (goodput). Replicated-only topologies
    report fanout 1 and no merges."""
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
    n_merges: int            # origin gather/merge flushes (sharded only)
    merge_sizes: list
    fanout_mean: float       # mean shards scattered to per ADMITTED query
    n_unrouted: int          # (shed queries never scatter and don't count)
    per_engine: list         # per-worker dicts: shard/replica/flushes/...
    makespan_s: float
    route: str
    shards: int
    replicas: list           # replica count per shard group
    backends: list           # per-shard declared backend (scfg.mode)
    exec: str = "inproc"     # execution backend the tier ran on
    n_reissued: int = 0      # hedged (speculative duplicate) flushes
    n_duplicate_drops: int = 0   # race losers dropped before deposit
    shard_ewma_ms: list = dataclasses.field(default_factory=list)
    tenants: dict = dataclasses.field(default_factory=dict)
    # name -> per-tenant accounting: n_queries/n_admitted/n_shed/
    # shed_fraction/qps/p50_ms/p99_ms/dealt/max_in_service/weight/...
    cluster_hits: np.ndarray | None = None
    # (C,) per-cluster scatter heat over admitted queries (sharded only):
    # how many admitted probe slots landed on each global cluster, the
    # measurement heat-aware placement consumes
    shard_probes: np.ndarray | None = None
    # (S,) probes ROUTED to each shard over admitted queries (sharded
    # only). Under replication this differs from folding cluster_hits
    # through part_of: it counts the owner the router actually chose, so
    # it is the skew signal rebalancing watches.


class ServingTopology:
    """One admission controller fronting a tree of tier nodes.

    ``groups`` is the topology spec: a list of shard groups, each a list
    of engine replicas serving that shard's data. One group = a purely
    replicated tier (arrivals dealt across the replicas, full
    ``engine.search``); N groups (with ``part_of``/``local_cid``/
    ``centroids`` describing the cluster partition) = a sharded tier
    (scatter/gather via ``engine.search_probed`` + the origin merge), each
    shard's arrivals dealt across ITS replicas.

    Admission control, credit-based backpressure and deadline shedding
    apply at the root, whatever the tree shape. ``backpressure=False``
    reproduces the ShardedFleet eager scatter. ``exec`` selects how the
    tree runs: ``"inproc"`` in this process, ``"mesh"`` (or a
    ``MeshBackend`` instance) over a mesh of ranks, one a shard, from rank
    0; ``close()`` then stops the other ranks.

    ``placement`` (the cluster Placement, multi-owner when replicated) and
    ``source`` (the unpartitioned engine) let ``apply_placement`` re-slice
    the shards; ``tenants`` is a TenantSpec registry; ``hedge`` (a
    ``HedgeConfig``) re-runs overdue shard flushes on other replicas;
    ``autoscale`` (an ``AutoscalePolicy``) and ``rebalance`` (a
    ``RebalancePolicy``) attach an ``Autoscaler`` / ``Rebalancer`` that
    act between streams. ``mutable=True`` lets ``apply`` swap a
    ``MutableIndex``'s state in; a sharded mutable tier needs the
    placement to re-slice."""

    def __init__(self, groups, *, part_of=None, local_cid=None,
                 centroids=None, route: str = "least-in-flight",
                 buckets=None, costs: StageCosts | None = None,
                 fill_threshold: int | None = None,
                 wait_limit_s: float = 2e-3, fifo_depth: int = 4,
                 max_batch: int = 64,
                 admission_depth: int | str | None = "auto",
                 shed_deadline_s: float | None = None,
                 backpressure: bool = True, exec: str = "inproc",
                 hedge: HedgeConfig | None = None, tenants=None,
                 placement=None, mutable: bool = False, autoscale=None,
                 source=None, mem_budget: int | None = None,
                 rebalance=None):
        self.groups = [list(g) for g in groups]
        if not self.groups or any(not g for g in self.groups):
            raise ValueError("ServingTopology needs at least one engine in "
                             "every group")
        if route not in ROUTE_POLICIES:
            raise ValueError(f"route must be one of {ROUTE_POLICIES}, "
                             f"got {route!r}")
        engines = [e for g in self.groups for e in g]
        devices = {e.device for e in engines}
        if len(devices) != 1:
            raise ValueError(f"engines of one topology must share a device, "
                             f"got {sorted(map(str, devices))}")
        self.device = engines[0].device
        ks = {e.scfg.k for e in engines}
        if len(ks) != 1:
            raise ValueError(f"engines disagree on k: {sorted(ks)}")
        self.k = engines[0].scfg.k
        self.route = route
        (self.buckets, self.fill_threshold, self.wait_limit_s,
         self.fifo_depth) = resolve_stream_params(
            engines[0], buckets, costs, fill_threshold, wait_limit_s,
            fifo_depth, max_batch)
        if shed_deadline_s is not None and not shed_deadline_s > 0:
            raise ValueError(
                f"shed_deadline_s must be > 0 or None, got {shed_deadline_s}")
        self.shed_deadline_s = shed_deadline_s
        if admission_depth == "auto":
            # room for every FIFO to refill once while a full complement is
            # buffered: deep enough to ride a burst, bounded so overload
            # surfaces as shedding, not unbounded queue growth
            admission_depth = 2 * len(engines) * self.fifo_depth \
                * self.buckets[-1]
        if admission_depth is not None:
            admission_depth = int(admission_depth)
            if admission_depth < 1:
                raise ValueError(
                    f"admission_depth must be >= 1, got {admission_depth}")
        self.admission_depth = admission_depth
        self.backpressure = bool(backpressure)

        self.sharded = part_of is not None
        if self.sharded:
            if local_cid is None or centroids is None:
                raise ValueError("a sharded topology needs part_of, "
                                 "local_cid AND centroids")
            nps = {e.scfg.nprobe for e in engines}
            if len(nps) != 1:
                raise ValueError(f"engines disagree on nprobe: {sorted(nps)}")
            self.nprobe = engines[0].scfg.nprobe
            self.part_of = np.asarray(part_of, np.int32)
            self.local_cid = np.asarray(local_cid, np.int32)
            self.centroids = torch.as_tensor(centroids).to(self.device)
            if not (len(self.part_of) == len(self.local_cid)
                    == self.centroids.shape[0]):
                raise ValueError("part_of/local_cid/centroids disagree on "
                                 "the cluster count")
            self.replicated = placement is not None \
                and getattr(placement, "replicated", False)
            counts = np.bincount(self.part_of, minlength=len(self.groups))
            for o, g in enumerate(self.groups):
                expect = len(placement.resident(o)) if self.replicated \
                    else counts[o]
                if expect != g[0].index.n_clusters:
                    raise ValueError(
                        f"engine {o} holds {g[0].index.n_clusters} clusters "
                        f"but part_of assigns it {expect}")
                reps = {e.scfg.mode for e in g}
                if len(reps) != 1:
                    raise ValueError(f"replicas within shard {o} disagree "
                                     f"on backend: {sorted(reps)}")
                if any(e.index.n_clusters != g[0].index.n_clusters
                       for e in g):
                    raise ValueError(f"replicas within shard {o} disagree "
                                     f"on the cluster slice")
            self.vectors = engines[0].host.vectors
            self.fanout = max(1, min(self.nprobe, len(self.groups)))
            ad = {(getattr(e.scfg, "adaptive_tau", 0.0),
                   getattr(e.scfg, "adaptive_min_probes", 1),
                   getattr(e.scfg, "adaptive_ladder", ())) for e in engines}
            if len(ad) != 1:
                raise ValueError(
                    f"engines disagree on adaptive termination: {sorted(ad)}")
            (self.adaptive_tau, self.adaptive_min_probes,
             self.adaptive_ladder) = next(iter(ad))
        else:
            if len(self.groups) != 1:
                raise ValueError("multiple groups need a cluster partition "
                                 "(part_of/local_cid/centroids)")
            self.part_of = self.local_cid = self.centroids = None
            self.fanout = 1
            self.replicated = False
        self.modes = [g[0].scfg.mode for g in self.groups]
        self._exec = execbackend_mod.resolve_exec_backend(exec)
        self.hedge_cfg = hedge
        if hedge is not None and not self.sharded:
            raise ValueError("hedged dispatch re-runs SHARD flushes on "
                             "replicas; a replicated tier has no scatter "
                             "stage to hedge (needs shards >= 2)")
        if self._exec.name == "mesh":
            if not self.sharded:
                raise ValueError("the mesh execution backend lays shard "
                                 "partitions along a mesh axis; a "
                                 "replicated tier has nothing to scatter "
                                 "(use exec='inproc')")
            if self.replicated:
                raise ValueError(
                    "hot-cluster replication routes probes through a "
                    "host-side multi-owner choice the mesh backend's "
                    "scatter step does not take (use exec='inproc')")
            if any(len(g) != 1 for g in self.groups):
                raise ValueError(
                    "exec='mesh' drives one rank per shard group; "
                    "replication is the mesh's job (launch more processes),"
                    " so each group must hold exactly one engine")
            if hedge is not None:
                raise ValueError("hedging needs in-process replicas to "
                                 "reissue onto; exec='mesh' has one rank "
                                 "per shard (use exec='inproc')")
            if autoscale is not None:
                raise ValueError(
                    "autoscaling resizes in-process replica groups; "
                    "exec='mesh' pins one rank per shard group (scale by "
                    "launching processes, or use exec='inproc')")
        self.tenants = self._resolve_tenants(tenants)

        # -- day-2 operations: live swaps + replica autoscaling ------------
        self.placement = placement
        self.mutable = bool(mutable)
        self.mem_budget = mem_budget
        # the UNPARTITIONED source apply_placement re-slices; kept current
        # by apply() so a rebalance after churn sees the live corpus
        self._src_index = getattr(source, "index", None)
        if self.mutable and self.sharded and placement is None:
            raise ValueError(
                "a mutable SHARDED topology needs the cluster Placement "
                "(placement=...) so apply() can re-slice partitions; "
                "topology()/TopologyConfig.build pass it automatically")
        if autoscale is not None and not isinstance(
                autoscale, autoscale_mod.AutoscalePolicy):
            raise ValueError(f"autoscale must be an AutoscalePolicy, "
                             f"got {type(autoscale).__name__}")
        self.autoscaler = autoscale_mod.Autoscaler(self, autoscale) \
            if autoscale is not None else None
        if rebalance is not None:
            if not isinstance(rebalance, autoscale_mod.RebalancePolicy):
                raise ValueError(
                    f"rebalance must be a RebalancePolicy, "
                    f"got {type(rebalance).__name__}")
            if not self.sharded:
                raise ValueError("heat-driven rebalancing moves clusters "
                                 "between shards (needs shards >= 2)")
            if self.placement is None or self._src_index is None:
                raise ValueError(
                    "rebalancing needs the cluster Placement and the "
                    "unpartitioned source index (placement=/source=...); "
                    "TopologyConfig.build wires both automatically")
        self.rebalancer = autoscale_mod.Rebalancer(self, rebalance) \
            if rebalance is not None else None
        self._active = None        # (root, sink) of the in-progress run
        if self._exec.name == "mesh":
            self._exec.prepare(self)

    def close(self) -> None:
        """Release the execution backend: on a mesh, the origin tells the
        other ranks to stop. A no-op in process."""
        close = getattr(self._exec, "close", None)
        if close is not None:
            close()

    def _resolve_tenants(self, tenants) -> list[TenantSpec] | None:
        """Validate the tenant registry against this topology's shape;
        None = untenanted (run() makes a single default tenant)."""
        if tenants is None:
            return None
        specs = list(tenants.values()) if isinstance(tenants, dict) \
            else list(tenants)
        if not specs:
            raise ValueError("tenants must hold at least one TenantSpec "
                             "(or be None)")
        for s in specs:
            if not isinstance(s, TenantSpec):
                raise ValueError(f"tenants entries must be TenantSpec, "
                                 f"got {type(s).__name__}")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        for s in specs:
            if s.backend is not None:
                if not self.sharded:
                    raise ValueError(
                        f"tenant {s.name!r}: preferred-backend routing "
                        f"needs a sharded topology (shards >= 2); a "
                        f"replicated tier serves one backend everywhere")
                if s.backend not in self.modes:
                    raise ValueError(
                        f"tenant {s.name!r} prefers backend {s.backend!r} "
                        f"but no shard serves it; this fleet serves "
                        f"{sorted(set(self.modes))}")
            if s.k is not None and s.k > self.k:
                raise ValueError(f"tenant {s.name!r}: k={s.k} exceeds the "
                                 f"engines' k={self.k}")
            if s.nprobe is not None:
                if not self.sharded:
                    raise ValueError(
                        f"tenant {s.name!r}: per-tenant nprobe is applied "
                        f"at the sharded origin scatter (shards >= 2)")
                if s.nprobe > self.nprobe:
                    raise ValueError(
                        f"tenant {s.name!r}: nprobe={s.nprobe} exceeds the "
                        f"engines' nprobe={self.nprobe}")
            if s.adaptive_tau is not None and not self.sharded:
                raise ValueError(
                    f"tenant {s.name!r}: per-tenant adaptive_tau is applied "
                    f"at the sharded origin scatter (shards >= 2)")
        return specs

    # -- warmup ---------------------------------------------------------------
    def warm(self) -> int:
        """One padded search (replicated) or probed search (sharded) per
        bucket and engine, plus the origin merge per bucket on sharded
        topologies, so every kernel library is built and loaded before a
        timed stream. Replicas share one placed index and warm once.
        Returns the number of executables built: 0 (the port builds
        none). On a mesh, one flush per bucket runs on every rank."""
        if self._exec.name == "mesh":
            self._exec.warm(self.buckets, self.nprobe)
            self._warm_merge()
            return 0
        seen: set[int] = set()
        for e in (e for g in self.groups for e in g):
            if id(e.placed) in seen:
                continue
            seen.add(id(e.placed))
            q1 = np.zeros((1, e.icfg.dim), np.float32)
            for b in self.buckets:
                if self.sharded:
                    probe = np.full((1, self.nprobe), -1, np.int32)
                    probe[0, 0] = 0
                    e.search_probed(q1, probe, pad_to=int(b))
                else:
                    e.search(q1, pad_to=int(b))
        if self.sharded:
            self._warm_merge()
        return 0

    def _warm_merge(self) -> None:
        for b in self.buckets:
            kernel_ops.merge_topk(
                torch.full((b, self.fanout * self.k), -1, dtype=torch.int32,
                           device=self.device),
                torch.full((b, self.fanout * self.k), float("inf"),
                           device=self.device), k=self.k)

    # -- day-2 operations: replica scaling and placement swaps --------------
    def scale_replicas(self, group: int, n: int) -> int:
        """Resize shard ``group`` to ``n`` replicas. New replicas are
        ``copy.copy`` views sharing the group's placed index: scaling adds
        schedulable capacity, not device memory. Worker trees are built per
        ``run()``, so a resize takes effect at the next stream. Returns the
        group's new replica count."""
        if self._exec.name == "mesh":
            raise ValueError(
                "exec='mesh' pins one rank per shard group; replica "
                "scaling there means launching processes, not copying "
                "engines (use exec='inproc')")
        if not 0 <= group < len(self.groups):
            raise ValueError(f"group {group} outside "
                             f"0..{len(self.groups) - 1}")
        if n < 1:
            raise ValueError(f"need at least one replica, got {n}")
        g = self.groups[group]
        while len(g) < n:
            g.append(copy.copy(g[0]))
        while len(g) > n:
            g.pop()
        return len(g)

    def apply(self, mut) -> None:
        """Swap a ``MutableIndex``'s current state into the live topology
        without dropping queries.

        Every engine reads its ``placed`` / ``host`` tensors when a flush
        dispatches, so the swap takes effect at flush granularity. Called
        mid-run (from a ``run(ticker=...)`` callback) it first drains the
        flushes in flight, so no stream mixes index versions across its
        merge; queries still queued dispatch against the new state. Shapes
        are stable by the ``MutableIndex`` contract, so each group's leader
        is refreshed in place (its old tensors released first) and its
        replicas share the leader's. On a mesh, every rank's partition is
        then placed anew (``MeshBackend.refresh``)."""
        if not self.mutable:
            raise ValueError("apply() needs a mutable topology "
                             "(TopologyConfig(mutable=True) or "
                             "ServingTopology(mutable=True, ...))")
        idx, host = mut.snapshot()
        if self._active is not None:
            # finish every flush dispatched against the old tensors
            root, _sink = self._active
            while root.block_harvest_one():
                pass
            root.harvest()
        if self.sharded and idx.n_clusters != len(self.part_of):
            raise ValueError(
                f"index has {idx.n_clusters} clusters but this topology "
                f"partitions {len(self.part_of)} — the mutable tier never "
                f"changes the cluster count")
        for o, g in enumerate(self.groups):
            sub = _slice_index(idx, self.placement.resident(o)) \
                if self.sharded else idx
            self._swap_group(g, sub, host)
        if self.sharded:
            self.vectors = host.vectors
            self._src_index = idx
        if self._exec.name == "mesh":
            self._exec.refresh(self)

    def _swap_group(self, g, index, host=None) -> None:
        """Refresh a group's leader with ``index`` (and ``host``), its old
        tensors released first, and let its replicas share the leader's."""
        leader = g[0]
        for e in g:
            e.placed = None
        for e in g[1:]:
            e.index = None
        leader.refresh(index, host)
        for e in g[1:]:
            e.index, e.placed, e.host = \
                leader.index, leader.placed, leader.host

    def apply_placement(self, pl: placement_mod.Placement) -> None:
        """Swap a new cluster -> shard assignment into the live topology,
        between streams (the ``Rebalancer``'s path).

        The unpartitioned source index (``source=``, wired by
        ``TopologyConfig.build``) is re-sliced by the new placement's
        resident lists and swapped under each shard's engines with
        ``engine.refresh``, one group at a time: the group's old placed
        tensors are released before its new ones are made, and replicas
        share their leader's. Every engine keeps its cluster count, so the
        swap needs a shape-preserving placement (swaps, fixed replica
        capacity). Routing reads the new ``part_of`` / ``local_cid`` /
        multi-owner maps at the next ``run()``."""
        if not self.sharded:
            raise ValueError("apply_placement moves clusters between "
                             "shards; a replicated tier has one group")
        if self._active is not None:
            raise ValueError("apply_placement is a between-streams swap — "
                             "the in-flight run's probe tables were routed "
                             "against the old placement")
        if self._src_index is None:
            raise ValueError(
                "apply_placement needs the unpartitioned source index "
                "(ServingTopology(source=...); TopologyConfig.build wires "
                "it automatically)")
        if pl.n_shards != len(self.groups):
            raise ValueError(f"placement has {pl.n_shards} shards for "
                             f"{len(self.groups)} groups")
        idx = self._src_index
        for o, g in enumerate(self.groups):
            res = pl.resident(o)
            if len(res) != g[0].index.n_clusters:
                raise ValueError(
                    f"shard {o}: new placement holds {len(res)} resident "
                    f"clusters but the engine was built with "
                    f"{g[0].index.n_clusters} — rebalance must be "
                    f"shape-preserving (swaps + fixed replica capacity)")
        for o, g in enumerate(self.groups):
            self._swap_group(g, _slice_index(idx, pl.resident(o)))
        self.placement = pl
        self.part_of = np.asarray(pl.shard_of, np.int32)
        self.local_cid = np.asarray(pl.local_slot, np.int32)
        self.replicated = pl.replicated
        if self._exec.name == "mesh":
            self._exec.refresh(self)

    # -- scatter routing ------------------------------------------------------
    def _backend_live(self, probe: np.ndarray, backend) -> np.ndarray:
        """The backend match filter: (N, P) bool, True where a probe's
        (primary) owning shard declares the backend its query asks for
        (``backend``: a registry key for every query, or one key or None a
        query; None matches every shard)."""
        req = np.full(len(probe), backend, object) \
            if isinstance(backend, str) \
            else np.asarray(list(backend), object)
        if len(req) != len(probe):
            raise ValueError(
                f"backend list length {len(req)} != {len(probe)} queries")
        known = set(self.modes)
        missing = {b for b in req.tolist() if b is not None} - known
        if missing:
            raise ValueError(
                f"no shard serves backend(s) {sorted(missing)}; this "
                f"fleet serves {sorted(known)}")
        modes = np.asarray(self.modes, object)
        match_all = np.asarray([b is None for b in req.tolist()])
        return (modes[self.part_of[np.maximum(probe, 0)]] == req[:, None]) \
            | match_all[:, None]

    def _route_probes(self, q: np.ndarray, backend=None, specs=None,
                      tenant_of=None):
        """(1) IVF top-probe selection at the origin, on the engines'
        device (with adaptive early termination: easy queries keep fewer
        probes and fan out to fewer shards), (2) per-tenant effort: a
        tenant's ``nprobe`` / ``adaptive_tau`` prune its rows
        (``cluster_filter`` sorts probes by distance, so a prefix cut IS
        the lower-nprobe result), (3) the backend match filter
        (``_backend_live``), (4) the per-owner scatter split; on a
        replicated placement through ``ivf.choose_owners`` on the host, one
        owning shard a probe. Returns (tables (O, N, P), touches (N, O),
        served (N, P), owner_sel (N, P)): ``served`` is the global probe
        table with every dropped or filtered slot -1 (the per-cluster heat
        source), ``owner_sel`` the shard each served probe went to."""
        probe, pdist = ivf_mod.cluster_filter(
            torch.from_numpy(q).to(self.device), self.centroids,
            nprobe=self.nprobe)
        if self.adaptive_tau > 0:
            keep = ivf_mod.adaptive_keep_mask(
                pdist, tau=self.adaptive_tau,
                min_probes=self.adaptive_min_probes,
                ladder=self.adaptive_ladder)
            probe = torch.where(keep, probe, -1)
        probe_np = probe.cpu().numpy()
        if specs is not None and any(
                s.nprobe is not None or s.adaptive_tau is not None
                for s in specs):
            for t, s in enumerate(specs):
                rows = tenant_of == t
                if not rows.any():
                    continue
                if s.nprobe is not None and s.nprobe < probe_np.shape[1]:
                    probe_np[rows, s.nprobe:] = -1
                if s.adaptive_tau is not None and s.adaptive_tau > 0:
                    keep = ivf_mod.adaptive_keep_mask(
                        pdist[torch.from_numpy(rows).to(pdist.device)],
                        tau=float(s.adaptive_tau),
                        min_probes=int(s.adaptive_min_probes),
                        ladder=self.adaptive_ladder).cpu().numpy()
                    probe_np[rows] = np.where(keep, probe_np[rows], -1)
            probe = torch.from_numpy(probe_np).to(self.device)
        live = np.ones(probe_np.shape, bool) if backend is None \
            else self._backend_live(probe_np, backend)
        if self.replicated:
            own, local, _ = ivf_mod.choose_owners(
                probe_np, self.placement.owners_of,
                self.placement.locals_of, n_owners=len(self.groups),
                live=live)
            tables, touches = ivf_mod.owner_tables(own, local,
                                                   len(self.groups))
            return tables, touches, np.where(own >= 0, probe_np, -1), own
        tables, touches = ivf_mod.owner_split_op(
            probe, torch.from_numpy(self.part_of).to(self.device),
            torch.from_numpy(self.local_cid).to(self.device),
            torch.from_numpy(live).to(self.device),
            n_owners=len(self.groups))
        served = np.where(live, probe_np, -1)
        owner_sel = np.where(served >= 0,
                             self.part_of[np.maximum(served, 0)],
                             -1).astype(np.int32)
        return (tables.cpu().numpy(), touches.cpu().numpy(), served,
                owner_sel)

    # -- origin gather/merge --------------------------------------------------
    def _merge(self, sink: ShardedSink, t: float, drain: bool,
               merge_sizes: list) -> bool:
        """Merge fully-gathered queries' per-shard partial top-k runs with
        the ``merge_topk`` kernel on the engines' device (selection only:
        each shard already exact-reranked its partials and the cluster
        partition keeps their ids disjoint), flushed in bucket-padded
        batches like any other stage."""
        if not sink.ready:
            return False
        if not (len(sink.ready) >= self.fill_threshold or drain
                or t - sink.ready[0][1] >= self.wait_limit_s):
            return False
        take = []
        while sink.ready and len(take) < self.buckets[-1]:
            take.append(sink.ready.popleft()[0])
        take = np.asarray(take)
        nq = len(take)
        b = next(bb for bb in self.buckets if bb >= nq)
        cb = np.full((b, sink.part_ids.shape[1]), -1, np.int32)
        cb[:nq] = sink.part_ids[take]
        db = np.full((b, sink.part_d.shape[1]), np.inf, np.float32)
        db[:nq] = sink.part_d[take]
        out_ids, out_d = kernel_ops.merge_topk(
            torch.from_numpy(cb).to(self.device),
            torch.from_numpy(db).to(self.device), k=self.k)
        sink.finish(take, out_ids[:nq].cpu().numpy(),
                    out_d[:nq].cpu().numpy())
        merge_sizes.append(nq)
        return True

    # -- per-run tree construction --------------------------------------------
    def _build_tree(self, sink, tables, slots, hedge=None):
        stream_kw = dict(buckets=self.buckets,
                         fill_threshold=self.fill_threshold,
                         wait_limit_s=self.wait_limit_s,
                         fifo_depth=self.fifo_depth,
                         exec_backend=self._exec)
        if not self.sharded:
            return ReplicaGroup([EngineWorker(e, sink, **stream_kw)
                                 for e in self.groups[0]], self.route)
        return [ReplicaGroup([ShardWorker(e, sink, probes=tables[o],
                                          slot=slots[:, o], shard=o,
                                          hedge=hedge, **stream_kw)
                              for e in grp], self.route)
                for o, grp in enumerate(self.groups)]

    # -- the run loop ---------------------------------------------------------
    def run(self, queries, arrival_times=None, backend=None, tenant=None,
            ticker=None) -> TopologyReport:
        """Replay a (possibly timed) stream through the topology.

        ``arrival_times`` (N,) seconds from the stream's start (None = all
        at t = 0); the run sleeps to honour future arrivals. ``backend``
        (None, a registry key, or one key or None a query) restricts each
        query to the shards that declare a matching backend (sharded
        topologies only); a query left with no probe completes unrouted
        (ids -1, dists inf) and is counted in ``n_unrouted``. ``tenant``
        (None, a tenant name, or one name a query) tags each query with a
        registered TenantSpec: admission becomes DWRR across the tenants,
        their deadlines, depths, credits and shed policies apply, a
        tenant's backend fills any query ``backend`` left unrestricted, and
        its k / nprobe / adaptive_tau override the engines' effort for its
        rows. ``ticker`` (callable, receives the stream clock) is called
        once per scheduler iteration."""
        q = np.asarray(queries, np.float32)
        n = len(q)
        arr = np.zeros(n) if arrival_times is None \
            else np.asarray(arrival_times, np.float64)
        order = np.argsort(arr, kind="stable")
        specs, tenant_of = self._resolve_stream_tenants(tenant, n)
        if backend is None and any(s.backend is not None for s in specs):
            backend = [specs[t].backend for t in tenant_of]
        hedge_rt = None
        served = owner_sel = None
        if self.sharded:
            tables, touches, served, owner_sel = self._route_probes(
                q, backend, specs, tenant_of)
            slots = np.cumsum(touches, axis=1) - 1
            pending = touches.sum(axis=1).astype(np.int32)
            sink = ShardedSink(q, arr, self.k, self.fanout)
            sink.pending[:] = pending
            if self._exec.name == "mesh":
                w = MeshShardWorker(
                    self._exec, sink, tables=tables, touches=touches,
                    slots=slots, buckets=self.buckets,
                    fill_threshold=self.fill_threshold,
                    wait_limit_s=self.wait_limit_s,
                    fifo_depth=self.fifo_depth)
                root = MeshShardGroup(w, pending, sink, self.k,
                                      self.backpressure)
            else:
                if self.hedge_cfg is not None:
                    hedge_rt = ShardHedge(self.hedge_cfg, len(self.groups),
                                          sink.now)
                root = ShardGroup(
                    self._build_tree(sink, tables, slots, hedge_rt),
                    touches, pending, sink, self.k, self.backpressure,
                    hedge_rt)
        else:
            if backend is not None:
                raise ValueError("backend routing needs a sharded topology "
                                 "(shards >= 2); a replicated tier serves "
                                 "one backend everywhere")
            pending = None
            sink = StreamSink(q, arr, self.k)
            root = self._build_tree(sink, None, None)
        adm = AdmissionController(self.admission_depth, self.shed_deadline_s,
                                  arr, tenants=specs, tenant_of=tenant_of)
        if any(s.credits is not None for s in specs):
            # completions return in-service credits, so DWRR can skip and
            # unskip capped tenants; untenanted runs skip the hook
            sink.on_finish = adm.release
        shed = np.zeros(n, bool)
        shed_wait = np.full(n, np.nan)
        quantum = max(1, min(self.fill_threshold, self.buckets[-1]))
        merge_sizes: list = []

        def shed_one(idx: int, wait: float):
            shed[idx] = True
            shed_wait[idx] = wait

        self._active = (root, sink)
        try:
            self._run_loop(root, sink, adm, arr, order, n, shed_one,
                           quantum, merge_sizes, ticker)
        finally:
            self._active = None
        makespan = sink.now()
        # per-tenant k: the prefix of the full-k row (the merge output is
        # sorted)
        for t, s in enumerate(specs):
            if s.k is not None and s.k < self.k:
                rows = (tenant_of == t) & ~shed
                sink.out_ids[rows, s.k:] = -1
                sink.out_d[rows, s.k:] = np.inf
        if isinstance(root, MeshShardGroup):
            run_groups = [[root.worker]]  # one worker drives every shard
        elif self.sharded:
            run_groups = [list(c.children) for c in root.children]
        else:
            run_groups = [list(root.children)]
        return self._report(sink, shed, shed_wait, pending, merge_sizes,
                            makespan, n, run_groups, hedge_rt, specs=specs,
                            tenant_of=tenant_of, adm=adm, served=served,
                            owner_sel=owner_sel)

    def _run_loop(self, root, sink, adm, arr, order, n, shed_one,
                  quantum, merge_sizes, ticker):
        """The admission -> deal -> pump -> harvest -> merge scheduler."""
        i = 0
        while i < n or len(adm) or not root.idle() \
                or (self.sharded and sink.ready):
            t = sink.now()
            if ticker is not None:
                ticker(t)
            # 1. arrivals -> bounded admission queues (overflow sheds now:
            # the arrival under drop-new, the tenant's oldest under
            # drop-old)
            while i < n and arr[order[i]] <= t:
                idx = int(order[i])
                i += 1
                if not adm.offer(idx):
                    shed_one(idx, t - arr[idx])
            for idx in adm.drain_evicted():
                shed_one(idx, t - arr[idx])
            # 2. deadline shedding at the head of each tenant queue —
            # checked before dealing so every dealt query started within
            # ITS deadline
            for idx in adm.expire(t):
                shed_one(idx, t - arr[idx])
            # 3. deal admitted queries into the tree (credits permitting)
            root.deal(adm, quantum)
            # 4. pump + harvest every worker, non-blocking: one slow engine
            # must not stall its siblings; then merge gathered queries
            drain = i >= n and not len(adm)
            progress = root.pump(t, drain)
            progress |= root.harvest()
            if self.sharded:
                progress |= self._merge(sink, t, drain, merge_sizes)
            if progress:
                continue
            # 5. idle: nap until the next arrival / flush / shed / merge
            # deadline, or block on a device if that is all that's left
            nxt = arr[order[i]] if i < n else math.inf
            nxt = min(nxt, root.next_deadline(), adm.next_deadline())
            if self.sharded and sink.ready:
                nxt = min(nxt, sink.ready[0][1] + self.wait_limit_s)
            if not math.isfinite(nxt):
                if not root.block_harvest_one():
                    time.sleep(5e-5)      # transient: nothing due anywhere
                continue
            # dt <= 0 means a deadline already passed but the tree is out
            # of credits — nap briefly instead of spinning until a device
            # frees a slot
            dt = nxt - sink.now()
            time.sleep(min(max(dt, 5e-5), 5e-4))

    def _resolve_stream_tenants(self, tenant, n: int):
        """Map run(tenant=...) onto the registry: (specs, tenant_of)."""
        if tenant is not None and self.tenants is None:
            raise ValueError("tenant-tagged streams need a TenantSpec "
                             "registry (ServingTopology(tenants=[...]))")
        if self.tenants is None:
            return [TenantSpec("default")], np.zeros(n, np.int32)
        specs = self.tenants
        name_to = {s.name: t for t, s in enumerate(specs)}
        if tenant is None:
            return specs, np.zeros(n, np.int32)
        if isinstance(tenant, str):
            if tenant not in name_to:
                raise ValueError(f"unknown tenant {tenant!r}; registered: "
                                 f"{sorted(name_to)}")
            return specs, np.full(n, name_to[tenant], np.int32)
        labels = list(tenant)
        if len(labels) != n:
            raise ValueError(f"tenant list length {len(labels)} != {n} "
                             f"queries")
        missing = sorted(set(labels) - set(name_to))
        if missing:
            raise ValueError(f"unknown tenant(s) {missing}; registered: "
                             f"{sorted(name_to)}")
        return specs, np.asarray([name_to[l] for l in labels], np.int32)

    def _tenant_stats(self, sink, shed, makespan, specs, tenant_of, adm,
                      served=None) -> dict:
        """Per-tenant goodput/latency/shed accounting for the report. On
        sharded runs each tenant also gets its own ``cluster_hits`` slice
        of the heat (``autoscale.tenant_fair_heat`` reweights them)."""
        out = {}
        for t, s in enumerate(specs):
            rows = tenant_of == t
            nt = int(rows.sum())
            ns = int(shed[rows].sum())
            hits_t = None
            if served is not None:
                pt = served[rows & ~shed]
                hits_t = np.bincount(
                    pt[pt >= 0].ravel(),
                    minlength=len(self.part_of)).astype(np.int64)
            out[s.name] = {
                "weight": s.weight,
                "backend": s.backend,
                "k": s.k if s.k is not None else self.k,
                "n_queries": nt,
                "n_admitted": nt - ns,
                "n_shed": ns,
                "shed_fraction": ns / nt if nt else 0.0,
                "qps": (nt - ns) / makespan if makespan > 0 else 0.0,
                "p50_ms": percentile_ms(sink.lat[rows], 50),
                "p99_ms": percentile_ms(sink.lat[rows], 99),
                "dealt": adm.dealt[t] if adm is not None else nt - ns,
                "max_in_service": adm.max_in_service[t]
                if adm is not None else 0,
                "cluster_hits": hits_t,
            }
        return out

    def _report(self, sink, shed, shed_wait, pending, merge_sizes,
                makespan: float, n: int, run_groups: list,
                hedge_rt: ShardHedge | None = None, *, specs, tenant_of, adm,
                served=None, owner_sel=None) -> TopologyReport:
        n_shed = int(shed.sum())
        n_admitted = n - n_shed
        flush_sizes = [s for grp in run_groups for w in grp
                       for s in w.flush_sizes]
        per_engine = []
        if run_groups and isinstance(run_groups[0][0], MeshShardWorker):
            # one worker drove the whole mesh: report per SHARD (rank),
            # the worker's flushes attributed once, to shard 0
            w = run_groups[0][0]
            per_engine = [
                {"engine": o, "shard": o, "replica": 0,
                 "backend": self.modes[o],
                 "flushes": len(w.flush_sizes) if o == 0 else 0,
                 "queries": int(w.queries_per_shard[o]),
                 "max_in_flight": w.max_in_flight if o == 0 else 0,
                 "compiles": w.compiles if o == 0 else 0,
                 "clusters": int(self.groups[o][0].index.n_clusters)}
                for o in range(len(self.groups))]
            run_groups = []
        for o, grp_workers in enumerate(run_groups):
            for r, w in enumerate(grp_workers):
                per_engine.append({
                    "engine": len(per_engine), "shard": o, "replica": r,
                    "backend": self.modes[o],
                    "flushes": len(w.flush_sizes),
                    "queries": int(sum(w.flush_sizes)),
                    "max_in_flight": w.max_in_flight,
                    "compiles": w.compiles,
                    "clusters": int(w.engine.index.n_clusters)
                    if self.sharded else None})
        cluster_hits = None
        shard_probes = None
        if served is not None:
            adm_probes = served[~shed]
            cluster_hits = np.bincount(
                adm_probes[adm_probes >= 0].ravel(),
                minlength=len(self.part_of)).astype(np.int64)
        if owner_sel is not None:
            adm_owner = owner_sel[~shed]
            shard_probes = np.bincount(
                adm_owner[adm_owner >= 0].ravel(),
                minlength=len(self.groups)).astype(np.int64)
        return TopologyReport(
            ids=sink.out_ids, dists=sink.out_d, latency_s=sink.lat,
            shed=shed, shed_wait_s=shed_wait,
            shed_fraction=n_shed / n if n else 0.0,
            qps=n_admitted / makespan if makespan > 0 else 0.0,
            p50_ms=percentile_ms(sink.lat, 50),
            p99_ms=percentile_ms(sink.lat, 99),
            n_queries=n, n_admitted=n_admitted, n_shed=n_shed,
            n_flushes=len(flush_sizes), flush_sizes=flush_sizes,
            n_merges=len(merge_sizes), merge_sizes=merge_sizes,
            # shed queries never reached the scatter stage: fanout is the
            # mean over queries actually dealt (the all-queries mean
            # whenever nothing sheds)
            fanout_mean=float(pending[~shed].mean())
            if pending is not None and n_admitted else
            (1.0 if n_admitted else 0.0),
            n_unrouted=int((pending[~shed] == 0).sum())
            if pending is not None else 0,
            per_engine=per_engine, makespan_s=makespan, route=self.route,
            shards=len(self.groups) if self.sharded else 1,
            replicas=[len(g) for g in self.groups],
            backends=list(self.modes),
            exec=self._exec.name,
            n_reissued=hedge_rt.n_reissued if hedge_rt else 0,
            n_duplicate_drops=hedge_rt.n_duplicate_drops if hedge_rt else 0,
            shard_ewma_ms=hedge_rt.shard_ewma_ms if hedge_rt else [],
            tenants=self._tenant_stats(sink, shed, makespan, specs,
                                       tenant_of, adm, served),
            cluster_hits=cluster_hits,
            shard_probes=shard_probes)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """The typed serving-tier spec: shape (``shards`` / ``replicas`` /
    ``modes`` / ``inner_shards``), streaming (``buckets`` ... ``max_batch``),
    overload (``admission_depth`` / ``shed_deadline_s`` / ``backpressure``),
    execution (``exec`` / ``hedge``), tenancy (``tenants``), day-2
    operations (``mutable`` / ``autoscale``) and heat-aware placement
    (``replicate_hot`` / ``replica_factor`` / ``rebalance``). Build with
    ``cfg.build(eng)`` (or ``topology(eng, config=cfg)``); derive variants
    with ``dataclasses.replace``. ``modes`` gives each shard its own ranking
    backend (needs shards >= 2).

    ``share_executables`` is the JAX package's field and has no effect
    here: the port builds no executables, so replicas share nothing but
    their placed index either way. ``mutable=True`` serves a
    ``MutableIndex`` (``mut.to_engine(...)``) and accepts ``apply(mut)``
    swaps. ``exec="mesh"`` serves the partitions from a mesh of ranks, one
    a shard (``execbackend.MeshBackend``), built on rank 0 while the others
    follow; it refuses replicas, hedging, hot-cluster replication,
    autoscaling and mixed backends."""

    # -- shape ---------------------------------------------------------------
    shards: int = 1
    replicas: int = 1
    mem_budget: int | None = None
    strict: bool = False
    modes: tuple | None = None
    inner_shards: int = 1
    share_executables: bool = True
    # -- streaming -----------------------------------------------------------
    route: str = "least-in-flight"
    buckets: tuple | None = None
    costs: StageCosts | None = None
    fill_threshold: int | None = None
    wait_limit_s: float = 2e-3
    fifo_depth: int = 4
    max_batch: int = 64
    # -- overload ------------------------------------------------------------
    admission_depth: int | str | None = "auto"
    shed_deadline_s: float | None = None
    backpressure: bool = True
    # -- execution -----------------------------------------------------------
    exec: str | object = "inproc"
    hedge: HedgeConfig | None = None
    # -- tenancy -------------------------------------------------------------
    tenants: tuple | None = None
    # -- day-2 operations ----------------------------------------------------
    mutable: bool = False
    autoscale: autoscale_mod.AutoscalePolicy | None = None
    # -- heat-aware placement ------------------------------------------------
    replicate_hot: int = 0
    replica_factor: int = 2
    rebalance: autoscale_mod.RebalancePolicy | None = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(
                f"need at least one replica, got {self.replicas}")
        if self.shards < 1:
            raise ValueError(f"need at least one shard, got {self.shards}")
        if self.modes is not None and self.shards == 1:
            raise ValueError("modes (per-shard backends) needs shards >= 2")
        if self.route not in ROUTE_POLICIES:
            raise ValueError(f"route must be one of {ROUTE_POLICIES}, "
                             f"got {self.route!r}")
        if self.inner_shards < 1:
            raise ValueError(
                f"need at least one inner shard, got {self.inner_shards}")
        if self.autoscale is not None and not isinstance(
                self.autoscale, autoscale_mod.AutoscalePolicy):
            raise ValueError(f"autoscale must be an AutoscalePolicy, "
                             f"got {type(self.autoscale).__name__}")
        if self.replicate_hot < 0:
            raise ValueError(f"replicate_hot must be >= 0, "
                             f"got {self.replicate_hot}")
        if self.replicate_hot and self.shards < 2:
            raise ValueError("replicate_hot (hot-cluster replication) "
                             "needs shards >= 2")
        if self.replicate_hot and not 2 <= self.replica_factor <= self.shards:
            raise ValueError(f"replica_factor must be in 2..{self.shards}, "
                             f"got {self.replica_factor}")
        if self.replicate_hot and self.inner_shards != 1:
            raise ValueError("replicate_hot with inner_shards > 1 is not "
                             "supported (replica slots break the equal "
                             "inner-shard split)")
        if self.rebalance is not None:
            if not isinstance(self.rebalance, autoscale_mod.RebalancePolicy):
                raise ValueError(f"rebalance must be a RebalancePolicy, "
                                 f"got {type(self.rebalance).__name__}")
            if self.shards < 2:
                raise ValueError("heat-driven rebalancing moves clusters "
                                 "between shards (needs shards >= 2)")

    def build(self, eng, *, freq: np.ndarray | None = None,
              heat: np.ndarray | None = None) -> ServingTopology:
        """Materialize this config over one built engine (or a
        ``MutableIndex``'s, ``mut.to_engine(...)``). ``heat`` is a
        measured ``TopologyReport.cluster_hits`` vector for the placer (and
        the ``replicate_hot`` hot set); ``freq`` keeps its estimated
        meaning (the cluster sizes by default). Pass one or the other."""
        serve_kw = dict(
            route=self.route, buckets=self.buckets, costs=self.costs,
            fill_threshold=self.fill_threshold,
            wait_limit_s=self.wait_limit_s, fifo_depth=self.fifo_depth,
            max_batch=self.max_batch, admission_depth=self.admission_depth,
            shed_deadline_s=self.shed_deadline_s,
            backpressure=self.backpressure, exec=self.exec,
            hedge=self.hedge, tenants=self.tenants,
            mutable=self.mutable, autoscale=self.autoscale)
        if self.shards == 1:
            if heat is not None:
                raise ValueError("heat-aware placement needs shards >= 2 "
                                 "(one shard holds every cluster)")
            return ServingTopology(
                [replicate_engine(eng, self.replicas)], **serve_kw)
        parts, pl = partition_index(
            eng, self.shards, mem_budget=self.mem_budget, strict=self.strict,
            modes=self.modes, inner_shards=self.inner_shards, freq=freq,
            mutable=self.mutable, heat=heat,
            replicate_hot=self.replicate_hot,
            replica_factor=self.replica_factor)
        groups = [replicate_engine(p, self.replicas) for p in parts]
        return ServingTopology(groups, part_of=pl.shard_of,
                               local_cid=pl.local_slot,
                               centroids=eng.index.centroids,
                               placement=pl, source=eng,
                               mem_budget=self.mem_budget,
                               rebalance=self.rebalance, **serve_kw)


def topology(eng, *, config: TopologyConfig | None = None,
             freq: np.ndarray | None = None,
             heat: np.ndarray | None = None, **kw) -> ServingTopology:
    """Build a serving topology over one built engine:
    ``topology(eng, config=TopologyConfig(...))``, the same as
    ``config.build(eng)``. The deprecated kwarg form (``topology(eng,
    shards=2, ...)``) folds the kwargs into a ``TopologyConfig`` and emits
    a ``DeprecationWarning``, as the JAX package's does."""
    if config is not None:
        if kw:
            raise ValueError(
                f"pass EITHER config= OR legacy kwargs, not both "
                f"(got config plus {sorted(kw)})")
        if not isinstance(config, TopologyConfig):
            raise ValueError(f"config must be a TopologyConfig, "
                             f"got {type(config).__name__}")
        return config.build(eng, freq=freq, heat=heat)
    warnings.warn(
        "topology(eng, shards=..., ...) kwargs are deprecated; build a "
        "TopologyConfig and call topology(eng, config=cfg) or cfg.build(eng)",
        DeprecationWarning, stacklevel=2)
    try:
        cfg = TopologyConfig(**kw)
    except TypeError as e:
        raise TypeError(f"topology() got unknown keyword(s): {e}") from None
    return cfg.build(eng, freq=freq, heat=heat)
