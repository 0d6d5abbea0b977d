"""O2 (online half): streaming query scheduling (counterpart of
``repro/core/pipeline.py``; paper §IV-B).

  * ``LinkModel`` / ``StageCosts`` / ``tune_minibatch`` / ``bucket_ladder``:
    the host<->PU transfer model of the paper's Fig 6 and Eq (1)'s
    mini-batch choice, which sets the bucket ladder.
  * ``StreamingScheduler``: the paper's dynamic mini-batching run online
    over a ``PIMCQGEngine``. Arrivals buffer until the fill threshold OR
    the oldest query's wait limit; each flush is padded up to a bucket of
    the ladder; a bounded in-flight FIFO is the paper's flow control, and
    finished batches are harvested out of order and reassembled per query.
  * ``EngineWorker``: the per-engine flush / harvest loop underneath, which
    the serving topology composes over many engines.
  * ``EventSimulator``: a discrete-event simulator of the five overlapped
    stages (host prep, host->PU transfer, in-PU search, PU->host return,
    host rerank) under the four scheduling policies of Fig 16 (per-query,
    batch-synchronous, pipeline with a fixed mini-batch, dynamic
    mini-batching), with admission shedding, client retries
    (``RetryPolicy``), hedged dispatch and tenant DWRR; pure host code, a
    copy of the JAX package's.

A flush records a CUDA event on the engine's device after its work is
queued; a harvest asks that event (``event.query()``) and never
synchronises. On the CPU a result is ready when the search returns.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

__all__ = [
    "LinkModel", "UPMEM_LINK", "TPU_ICI_LINK", "PCIE_LINK",
    "StageCosts", "tune_minibatch", "bucket_ladder",
    "EventSimulator", "SimReport", "RetryPolicy", "round_robin_batches",
    "EngineWorker", "StreamSink", "StreamingScheduler", "StreamReport",
    "percentile_ms", "resolve_stream_params",
]


# ---------------------------------------------------------------------------
# Transfer model (Fig 6) and Eq (1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkModel:
    """latency(bytes) = setup + bytes/bw * (1 + congestion * max(0, b/knee - 1))"""
    setup_s: float            # fixed per-transfer cost
    bw_bytes_s: float         # asymptotic bandwidth
    knee_bytes: float = 8192  # paper: "fast communicating range (under 8 KB)"
    congestion: float = 0.15  # superlinear penalty beyond the knee

    def latency(self, nbytes: float) -> float:
        lin = nbytes / self.bw_bytes_s
        over = max(0.0, nbytes / self.knee_bytes - 1.0)
        return self.setup_s + lin * (1.0 + self.congestion * over)


UPMEM_LINK = LinkModel(setup_s=2.0e-6, bw_bytes_s=150e9 / 2560, knee_bytes=8192,
                       congestion=0.30)   # per-DPU share of the 150 GB/s bus
TPU_ICI_LINK = LinkModel(setup_s=1.0e-6, bw_bytes_s=50e9, knee_bytes=1 << 20,
                         congestion=0.05)
PCIE_LINK = LinkModel(setup_s=5.0e-6, bw_bytes_s=32e9, knee_bytes=1 << 20,
                      congestion=0.10)


@dataclasses.dataclass(frozen=True)
class StageCosts:
    """Per-mini-batch stage costs as functions of batch size N_B (seconds).
    t_xfer_in/out are derived from the LinkModel + per-query payload bytes."""
    t_pre: Callable[[int], float]
    t_proc: Callable[[int], float]
    t_post: Callable[[int], float]
    link: LinkModel = TPU_ICI_LINK
    query_bytes: int = 512        # LUT payload per query
    result_bytes: int = 512       # EF candidate ids+ranks per query

    def t_in(self, n: int) -> float:
        return self.link.latency(n * self.query_bytes)

    def t_out(self, n: int) -> float:
        return self.link.latency(n * self.result_bytes)

    def stage_max(self, n: int) -> float:
        pre = self.t_pre(n) + self.t_in(n)
        post = self.t_out(n) + self.t_post(n)
        return max(pre, self.t_proc(n), post)


def tune_minibatch(costs: StageCosts, candidates=(1, 2, 4, 8, 16, 32, 64, 128)
                   ) -> tuple[int, dict[int, float]]:
    """Eq (1): choose N* minimizing per-query pipelined time, preferring sizes
    whose transfers stay inside the link's fast range (paper §IV-B2)."""
    per_q = {n: costs.stage_max(n) / n for n in candidates}
    best = min(per_q, key=per_q.__getitem__)
    # paper refinement: prefer the smallest N whose payload is in-knee and
    # within 5% of the optimum (keeps latency low at equal throughput)
    for n in sorted(candidates):
        in_knee = n * max(costs.query_bytes, costs.result_bytes) <= costs.link.knee_bytes
        if in_knee and per_q[n] <= 1.05 * per_q[best]:
            return n, per_q
    return best, per_q


def bucket_ladder(max_batch: int, nstar: int | None = None
                  ) -> tuple[int, ...]:
    """Powers-of-two batch-size ladder up to ``max_batch``, with Eq (1)'s
    N* inserted so the steady-state flush size pads by zero. Every arrival
    batch size then routes to the next bucket up — a small fixed set of
    shapes."""
    ladder = {max_batch}
    b = 1
    while b < max_batch:
        ladder.add(b)
        b *= 2
    if nstar:
        ladder.add(min(int(nstar), max_batch))
    return tuple(sorted(ladder))


# ---------------------------------------------------------------------------
# Event-driven simulator (Fig 7/8/14/16)
# ---------------------------------------------------------------------------

def round_robin_batches(pus, minibatch: int) -> list[tuple[int, int, float]]:
    """Slice each PU's queries into mini-batches and interleave them
    round-robin — batch j of every PU precedes batch j+1 of any PU, the
    order a uniform arrival stream offers them to the shared link. Returns
    (pu, n_queries, ready_time) triples for ``EventSimulator._run_batches``."""
    per_pu: dict[int, list] = {}
    for i, pu in enumerate(pus):
        per_pu.setdefault(int(pu), []).append(i)
    keyed = []
    for pu, qs in per_pu.items():
        for j, s in enumerate(range(0, len(qs), minibatch)):
            keyed.append((j, pu, len(qs[s:s + minibatch])))
    keyed.sort()
    return [(pu, nq, 0.0) for _, pu, nq in keyed]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Shed-aware client retry model: a batch shed at admission is
    re-offered ``backoff_s`` after its deadline expired, as a fresh
    arrival with a fresh deadline, up to ``max_attempts`` total offers
    (1 = no retries). Completed-batch latency is still measured
    from the ORIGINAL arrival, so retries honestly inflate the tail they
    rescue; a batch that exhausts its attempts counts shed exactly once."""
    max_attempts: int = 2
    backoff_s: float = 5e-3

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not self.backoff_s >= 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")


@dataclasses.dataclass
class SimReport:
    qps: float                # completed queries / makespan (goodput)
    mean_latency_s: float     # over completed queries only
    stage_busy: dict          # stage -> busy fraction of makespan
    stage_time: dict          # stage -> total seconds
    makespan_s: float
    n_queries: int            # completed (admitted) queries
    n_shed: int = 0           # queries dropped by the shedding policy
    shed_fraction: float = 0.0  # n_shed / offered
    n_retries: int = 0        # shed batches re-offered by the retry policy
    p99_latency_s: float = float("nan")  # per-query p99 (batch latency
                                         # weighted by batch size)
    n_reissued: int = 0       # hedged speculative re-dispatches (search)
    n_duplicate_drops: int = 0  # hedged completions that lost the race
    # tenant-labeled streams only: tid -> value
    tenant_queries: dict = dataclasses.field(default_factory=dict)
    tenant_shed: dict = dataclasses.field(default_factory=dict)
    tenant_p99_s: dict = dataclasses.field(default_factory=dict)


class EventSimulator:
    """Five-stage pipeline over P PUs with one host prep thread, one shared
    host<->PU link (half-duplex, like UPMEM's rank-level bus), and a host
    rerank pool.

    Policies:
      per_query   — every query is its own transfer, serialized on the link
      batch_sync  — global barrier per batch (Fig 7a): prep all -> xfer all ->
                    all PUs search -> xfer back -> rerank all, strictly serial
      pipeline    — asynchronous 5-stage pipeline with fixed mini-batch size
      dynamic     — pipeline + per-PU buffers flushed on fill-threshold OR
                    waiting-time limit (Fig 7c)
    """

    def __init__(self, n_pus: int, costs: StageCosts, *,
                 rerank_workers: int = 4, fifo_depth: int = 4,
                 full_duplex: bool = False):
        self.n_pus = n_pus
        self.costs = costs
        self.rerank_workers = rerank_workers
        self.fifo_depth = fifo_depth
        self.full_duplex = full_duplex

    # -- shared machinery: a real discrete-event simulation ------------------
    # Resources: prep (1 server), link (half-duplex: 1 server for both
    # directions — UPMEM's rank bus; set full_duplex=True for ICI-like
    # links), one server per PU, rerank pool (W servers). Each stage has its
    # own FIFO; stages of different batches overlap freely — this is exactly
    # the concurrency structure of Fig 8 (async pipeline).
    def _run_batches(self, batches, shed_deadline_s: float | None = None,
                     retry: RetryPolicy | None = None,
                     pu_speed=None, hedge=None, hedge_groups=None,
                     tenant_of_batch=None, tenant_weights=None,
                     tenant_deadline_s=None):
        """batches: list of (pu, n_queries, ready_time); returns SimReport.

        With ``tenant_of_batch`` (one tenant id per batch), host prep is
        scheduled deficit-weighted-round-robin across per-tenant queues
        instead of FCFS — the deterministic mirror of the serving tier's
        tenant-aware AdmissionController. ``tenant_weights`` sets the
        DWRR quanta (default: equal); ``tenant_deadline_s`` (one per
        tenant, None entries fall back to ``shed_deadline_s``) sheds a
        batch whose prep could not start within ITS tenant's deadline.
        Per-tenant completions/sheds/p99 land in the SimReport's
        ``tenant_*`` dicts. Tenant mode composes with shedding only
        (retry/hedge raise).

        With ``shed_deadline_s`` set, a batch whose host prep could not
        start within the deadline of its ready time is shed (admission-time
        load shedding): its queries count toward ``shed_fraction`` instead
        of completing, so overload saturates goodput instead of growing
        latency without bound. With ``retry`` also set, a shed batch is
        re-offered ``backoff_s`` after its deadline expired (a fresh
        arrival with a fresh deadline) until ``max_attempts`` offers are
        exhausted — the shed-aware client model.

        ``pu_speed`` (P,) multiplies each PU's search-stage duration (a
        straggler PU is speed > 1). ``hedge`` — a
        ``distributed.straggler.DeadlineReissue`` — enables hedged dispatch
        at the search stage: a batch whose search would finish past
        ``k x EWMA`` of its dispatch is speculatively re-run, AT the
        deadline instant, on the least-loaded other PU in its
        ``hedge_groups`` replica set (default: all PUs are mutual
        replicas); the earlier finish wins and the later completion is
        dropped as a duplicate. The policy object is driven with the
        SIMULATED clock (its ``clock`` attribute is rebound here), so the
        same class governs real wall-clock serving and deterministic
        simulation."""
        c = self.costs
        speed = np.ones(self.n_pus) if pu_speed is None \
            else np.asarray(pu_speed, np.float64)
        if hedge is not None:
            sim_now = [0.0]
            hedge.clock = lambda: sim_now[0]
        group_of = {}
        if hedge_groups is not None:
            for grp in hedge_groups:
                for pu in grp:
                    group_of[int(pu)] = tuple(int(a) for a in grp)
        nres_in = "link"
        nres_out = "link_out" if self.full_duplex else "link"
        free = {"prep": 0.0, "link": 0.0, "link_out": 0.0}
        free_pu = np.zeros(self.n_pus)
        free_rr = np.zeros(self.rerank_workers)
        busy = {"prep": 0.0, "xfer_in": 0.0, "search": 0.0,
                "xfer_out": 0.0, "rerank": 0.0}
        STAGES = ("prep", "xfer_in", "search", "xfer_out", "rerank")

        # event heap: (ready_time, batch_idx, stage_idx)
        ev: list = []
        for i, (pu, n, ready) in enumerate(batches):
            heapq.heappush(ev, (ready, i, 0))
        inflight = 0
        gate_wait: deque = deque()          # batches held back by flow control
        done_t = {}
        n_shed = 0
        n_retries = 0
        # retries re-offer a batch at a LATER effective arrival (its own
        # deadline clock); completed latency still reads batches[i][2], the
        # original arrival, so retried batches pay their full queue+backoff
        arrival_of = [b[2] for b in batches]
        attempts = [1] * len(batches)
        end = 0.0
        limit = self.fifo_depth * self.n_pus

        tmode = tenant_of_batch is not None
        if tmode:
            if retry is not None or hedge is not None:
                raise ValueError("tenant-labeled streams compose with "
                                 "shedding, not retry/hedge")
            tenant_of_batch = [int(t) for t in tenant_of_batch]
            if len(tenant_of_batch) != len(batches):
                raise ValueError(
                    f"tenant_of_batch has {len(tenant_of_batch)} entries "
                    f"for {len(batches)} batches")
            T = (max(tenant_of_batch) + 1) if tenant_of_batch else 1
            tw = np.ones(T) if tenant_weights is None \
                else np.asarray(tenant_weights, np.float64)
            if len(tw) < T or not (tw > 0).all():
                raise ValueError(f"need {T} positive tenant weights, "
                                 f"got {tenant_weights}")
            T = len(tw)
            tdl = [shed_deadline_s] * T if tenant_deadline_s is None \
                else [shed_deadline_s if d is None else d
                      for d in tenant_deadline_s]
            quantum = tw / tw.min()
            deficit = np.zeros(T)
            cur = [None]                   # DWRR rotation position
            tq = [deque() for _ in range(T)]   # batch idxs awaiting prep
            t_shed = np.zeros(T, np.int64)

            def dwrr_pick():
                if not any(len(q) for q in tq):
                    return None
                for _ in range(2 * T + 1):
                    c0 = cur[0]
                    if c0 is not None and tq[c0] and deficit[c0] >= 1.0:
                        return c0
                    nxt = 0 if c0 is None else (c0 + 1) % T
                    cur[0] = nxt
                    if tq[nxt]:
                        deficit[nxt] = min(deficit[nxt] + quantum[nxt],
                                           quantum[nxt] + 1.0)
                    else:
                        deficit[nxt] = 0.0
                raise AssertionError("DWRR rotation found no backlogged "
                                     "tenant it proved exists")

        def duration(stage, pu, n):
            if stage == 0:
                return c.t_pre(n)
            if stage == 1:
                return c.t_in(n)
            if stage == 2:
                return c.t_proc(n)
            if stage == 3:
                return c.t_out(n)
            return c.t_post(n)

        while ev:
            ready, i, stage = heapq.heappop(ev)
            if stage == -1:               # tenant-mode prep gate (drain)
                t_now = ready
                if free["prep"] > t_now:
                    heapq.heappush(ev, (free["prep"], -1, -1))
                    continue
                while True:
                    tid = dwrr_pick()
                    if tid is None:
                        break
                    if inflight >= limit:
                        break             # a completion re-opens the gate
                    j = tq[tid].popleft()
                    pu_j, n_j, _ = batches[j]
                    if tdl[tid] is not None \
                            and t_now - arrival_of[j] > tdl[tid]:
                        # expiry spends NO deficit — the controller's
                        # expire() drops stale heads before dealing, so a
                        # backlogged low-weight tenant sheds its stale tail
                        # without burning its service share on it
                        n_shed += n_j
                        t_shed[tid] += n_j
                        continue          # server still free: keep picking
                    deficit[tid] -= 1.0
                    inflight += 1
                    dur = duration(0, pu_j, n_j)
                    free["prep"] = t_now + dur
                    busy["prep"] += dur
                    heapq.heappush(ev, (free["prep"], j, 1))
                    if any(len(q) for q in tq):
                        heapq.heappush(ev, (free["prep"], -1, -1))
                    break
                continue
            pu, n, arrival = batches[i]
            if stage == 0:
                if tmode:
                    # prep order is decided at server-free time by DWRR,
                    # not by FCFS arrival: park in the tenant queue and
                    # schedule a drain
                    tq[tenant_of_batch[i]].append(i)
                    heapq.heappush(ev, (max(ready, free["prep"]), -1, -1))
                    continue
                if shed_deadline_s is not None \
                        and max(ready, free["prep"]) - arrival_of[i] \
                        > shed_deadline_s:
                    if retry is not None \
                            and attempts[i] < retry.max_attempts:
                        # the system drops the batch when its deadline
                        # expires; the client re-offers it backoff later
                        attempts[i] += 1
                        n_retries += 1
                        t_retry = arrival_of[i] + shed_deadline_s \
                            + retry.backoff_s
                        arrival_of[i] = t_retry
                        heapq.heappush(ev, (t_retry, i, 0))
                        continue
                    n_shed += n        # shed at admission: prep never starts
                    if gate_wait:      # forward the flow-control release
                        j, jready = gate_wait.popleft()   # token a completed
                        heapq.heappush(ev, (max(jready, ready), j, 0))
                        # batch would have handed this one — a shed batch
                        # never completes, so without this the gate chain
                        # breaks and held batches are silently lost
                    continue
                if inflight >= limit:
                    gate_wait.append((i, ready))
                    continue
                inflight += 1
            # acquire the stage's resource (FCFS by event order)
            if stage == 0:
                start = max(ready, free["prep"]); free["prep"] = start + duration(0, pu, n)
                tdone = free["prep"]
            elif stage == 1:
                start = max(ready, free[nres_in]); free[nres_in] = start + duration(1, pu, n)
                tdone = free[nres_in]
            elif stage == 2:
                start = max(ready, free_pu[pu])
                t_primary = start + duration(2, pu, n) * speed[pu]
                free_pu[pu] = t_primary
                tdone = t_primary
                if hedge is not None:
                    # drive the real DeadlineReissue on the simulated clock:
                    # dispatch at ready, poll at the deadline instant; the
                    # whole race resolves in closed form (both finish times
                    # are known), so the outcome is deterministic
                    sim_now[0] = ready
                    hedge.dispatch(("batch", i))
                    fired = False
                    if hedge.tracker.value is not None:
                        t_deadline = ready + hedge.k * hedge.tracker.value
                        if t_primary > t_deadline:
                            sim_now[0] = t_deadline
                            fired = ("batch", i) in hedge.poll()
                    if fired:
                        alts = [a for a in group_of.get(pu, range(self.n_pus))
                                if a != pu]
                        alt = min(alts, key=lambda a: free_pu[a]) \
                            if alts else None
                    if fired and alt is not None:
                        start_a = max(t_deadline, free_pu[alt])
                        t_alt = start_a + duration(2, alt, n) * speed[alt]
                        free_pu[alt] = t_alt
                        busy["search"] += (t_primary - start) \
                            + (t_alt - start_a)
                        tdone = min(t_primary, t_alt)
                        sim_now[0] = tdone
                        hedge.complete(("batch", i))      # first response wins
                        sim_now[0] = max(t_primary, t_alt)
                        hedge.complete(("batch", i))      # duplicate dropped
                        start = tdone   # busy already accounted above
                    else:
                        sim_now[0] = t_primary
                        hedge.complete(("batch", i))
            elif stage == 3:
                start = max(ready, free[nres_out]); free[nres_out] = start + duration(3, pu, n)
                tdone = free[nres_out]
            else:
                w = int(np.argmin(free_rr))
                start = max(ready, free_rr[w]); free_rr[w] = start + duration(4, pu, n)
                tdone = free_rr[w]
            busy[STAGES[stage]] += tdone - start
            if stage < 4:
                heapq.heappush(ev, (tdone, i, stage + 1))
            else:
                done_t[i] = tdone
                end = max(end, tdone)
                inflight -= 1
                if gate_wait:
                    j, jready = gate_wait.popleft()
                    heapq.heappush(ev, (max(jready, tdone), j, 0))
                if tmode and any(len(q) for q in tq):
                    # the freed in-flight slot re-opens the prep gate
                    heapq.heappush(ev, (max(tdone, free["prep"]), -1, -1))

        offered = sum(n for _, n, _ in batches)
        nq = sum(batches[i][1] for i in done_t)   # measured, not offered-shed
        assert nq + n_shed == offered, "simulator lost batches in flight"
        lat = float(np.mean([done_t[i] - batches[i][2] for i in done_t])) \
            if done_t else float("nan")     # nothing completed: NaN, not 0
        per_q_lat = np.repeat(
            [done_t[i] - batches[i][2] for i in done_t],
            [batches[i][1] for i in done_t]) if done_t else np.empty(0)
        tenant_queries: dict = {}
        tenant_shed: dict = {}
        tenant_p99: dict = {}
        if tmode:
            per_lat: dict = {t: [] for t in range(T)}
            done_q = np.zeros(T, np.int64)
            for i in done_t:
                tid = tenant_of_batch[i]
                done_q[tid] += batches[i][1]
                per_lat[tid].extend([done_t[i] - batches[i][2]]
                                    * batches[i][1])
            tenant_queries = {t: int(done_q[t]) for t in range(T)}
            tenant_shed = {t: int(t_shed[t]) for t in range(T)}
            tenant_p99 = {t: (float(np.percentile(per_lat[t], 99))
                              if per_lat[t] else float("nan"))
                          for t in range(T)}
        return SimReport(qps=nq / end if end > 0 else 0.0,
                         mean_latency_s=lat,
                         stage_busy={k: v / end for k, v in busy.items()}
                         if end > 0 else {k: 0.0 for k in busy},
                         stage_time=dict(busy), makespan_s=end, n_queries=nq,
                         n_shed=n_shed,
                         shed_fraction=n_shed / offered if offered else 0.0,
                         n_retries=n_retries,
                         p99_latency_s=float(np.percentile(per_q_lat, 99))
                         if per_q_lat.size else float("nan"),
                         n_reissued=hedge.reissued_total
                         if hedge is not None else 0,
                         n_duplicate_drops=hedge.duplicate_results
                         if hedge is not None else 0,
                         tenant_queries=tenant_queries,
                         tenant_shed=tenant_shed,
                         tenant_p99_s=tenant_p99)

    # -- policies -------------------------------------------------------------
    def per_query(self, n_queries: int, pu_of_query=None) -> SimReport:
        pus = pu_of_query if pu_of_query is not None \
            else np.arange(n_queries) % self.n_pus
        batches = [(int(pus[i]), 1, 0.0) for i in range(n_queries)]
        return self._run_batches(batches)

    def batch_sync(self, n_queries: int, global_batch: int, pu_of_query=None
                   ) -> SimReport:
        """Strict barriers (Fig 7a): stages of one global batch never overlap
        with the next; slowest PU gates everything. Load skew across PUs is
        injected via pu_of_query."""
        c = self.costs
        pus = pu_of_query if pu_of_query is not None \
            else np.arange(n_queries) % self.n_pus
        t = 0.0
        busy = {"prep": 0.0, "xfer_in": 0.0, "search": 0.0,
                "xfer_out": 0.0, "rerank": 0.0}
        nq = 0
        for start in range(0, n_queries, global_batch):
            counts = np.bincount(pus[start:start + global_batch],
                                 minlength=self.n_pus)
            nb = int(counts.sum()); nq += nb
            tp = c.t_pre(nb); busy["prep"] += tp
            ti = sum(c.t_in(int(x)) for x in counts if x)   # serialized on link
            busy["xfer_in"] += ti
            ts = max((c.t_proc(int(x)) for x in counts if x), default=0.0)
            busy["search"] += ts                             # barrier: max PU
            to = sum(c.t_out(int(x)) for x in counts if x)
            busy["xfer_out"] += to
            tr = c.t_post(nb)                                # host serial rerank
            busy["rerank"] += tr
            t += tp + ti + ts + to + tr
        return SimReport(qps=nq / t if t else 0.0, mean_latency_s=t / max(nq, 1),
                         stage_busy={k: v / t for k, v in busy.items()},
                         stage_time=dict(busy), makespan_s=t, n_queries=nq)

    def pipeline(self, n_queries: int, minibatch: int, pu_of_query=None,
                 *, pu_speed=None, hedge=None, hedge_groups=None
                 ) -> SimReport:
        """Fixed-mini-batch async pipeline. ``pu_speed``/``hedge``/
        ``hedge_groups`` inject per-PU stragglers and the hedged-dispatch
        policy (see ``_run_batches``) — the deterministic harness for the
        serving tier's speculative re-dispatch claims."""
        pus = pu_of_query if pu_of_query is not None \
            else np.arange(n_queries) % self.n_pus
        # round-robin interleave across PUs to mimic arrival order
        return self._run_batches(round_robin_batches(pus, minibatch),
                                 pu_speed=pu_speed, hedge=hedge,
                                 hedge_groups=hedge_groups)

    def dynamic(self, arrival_times: np.ndarray, pu_of_query: np.ndarray,
                threshold: int, wait_limit_s: float,
                shed_deadline_s: float | None = None,
                retry: RetryPolicy | None = None,
                tenant_of=None, tenant_weights=None,
                tenant_deadline_s=None) -> SimReport:
        """Fig 7(c): per-PU buffers; flush on fill OR oldest-query timeout.

        ``shed_deadline_s`` enables the fleet tier's admission-deadline
        shedding (see ``_run_batches``) so the simulator predicts the
        goodput plateau the real FleetScheduler measures under overload;
        ``retry`` adds the shed-aware client model on top (shed batches
        re-offered after backoff, ``SimReport.n_retries``) — the
        retry-storm-vs-plateau overlay in benchmarks/overload.py.

        ``tenant_of`` (one tenant id per query) labels the arrival stream:
        buffers become per-(PU, tenant) so every flush is tenant-pure, and
        prep is scheduled DWRR across tenants with ``tenant_weights`` /
        per-tenant ``tenant_deadline_s`` (see ``_run_batches``) — the
        deterministic harness for the serving tier's noisy-neighbor
        isolation claims (benchmarks/tenancy.py)."""
        order = np.argsort(arrival_times)
        if tenant_of is None:
            key_of = lambda i: int(pu_of_query[i])
        else:
            tenant_of = np.asarray(tenant_of)
            key_of = lambda i: (int(pu_of_query[i]), int(tenant_of[i]))
        buf: dict = {}
        oldest: dict = {}
        batches = []
        batch_tenant = []

        def flush(key, now):
            if buf.get(key):
                pu = key if tenant_of is None else key[0]
                batches.append((pu, len(buf[key]), now))
                if tenant_of is not None:
                    batch_tenant.append(key[1])
                buf[key] = []
                oldest.pop(key, None)

        for i in order:
            now = float(arrival_times[i])
            # timeout flushes due before this arrival, at their fire times
            for key in list(oldest):
                if now - oldest[key] >= wait_limit_s:
                    flush(key, oldest[key] + wait_limit_s)
            key = key_of(i)
            buf.setdefault(key, []).append(i)
            oldest.setdefault(key, now)
            if len(buf[key]) >= threshold:
                flush(key, now)
        # end of stream: residual buffers still fire at their true deadline
        # (oldest arrival + wait limit), which may be after the last arrival
        # — nothing flushes "at tend" just because the trace ran out
        for key in sorted(oldest):
            flush(key, oldest[key] + wait_limit_s)
        if tenant_of is None:
            batches.sort(key=lambda b: b[2])
            return self._run_batches(batches, shed_deadline_s, retry)
        ob = sorted(range(len(batches)), key=lambda j: batches[j][2])
        return self._run_batches(
            [batches[j] for j in ob], shed_deadline_s, retry,
            tenant_of_batch=[batch_tenant[j] for j in ob],
            tenant_weights=tenant_weights,
            tenant_deadline_s=tenant_deadline_s)


# ---------------------------------------------------------------------------
# Streaming scheduler over a PIMCQGEngine
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def percentile_ms(latency_s: np.ndarray, p: float) -> float:
    """NaN-safe latency percentile in ms. NaN entries are queries that never
    completed (shed, or a partially-failed run) — they are excluded rather
    than poisoning the statistic; with no finite samples the answer is
    honestly NaN, not 0."""
    lat = np.asarray(latency_s, np.float64)
    if lat.size == 0 or not np.isfinite(lat).any():
        return float("nan")
    return float(np.nanpercentile(np.where(np.isfinite(lat), lat, np.nan),
                                  p)) * 1e3


def resolve_stream_params(engine, buckets, costs: StageCosts | None,
                          fill_threshold, wait_limit_s, fifo_depth,
                          max_batch) -> tuple[tuple[int, ...], int, float, int]:
    """Shared ladder resolution + argument validation for the streaming
    tier (StreamingScheduler and FleetScheduler workers). An explicit
    fill_threshold=0 is an error, not "unset" — only None means default."""
    if buckets is None:
        if engine.buckets:
            buckets = engine.buckets        # adopt (never mutate) the ladder
        else:
            nstar = tune_minibatch(costs)[0] if costs is not None else None
            buckets = bucket_ladder(max_batch, nstar)
    buckets = tuple(sorted({int(b) for b in buckets}))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    fill = buckets[-1] if fill_threshold is None else int(fill_threshold)
    if fill < 1:
        raise ValueError(f"fill_threshold must be >= 1, got {fill}")
    wait = float(wait_limit_s)
    if not wait > 0:
        raise ValueError(f"wait_limit_s must be > 0, got {wait_limit_s}")
    depth = int(fifo_depth)
    if depth < 1:
        raise ValueError(f"fifo_depth must be >= 1, got {fifo_depth}")
    return buckets, fill, wait, depth


class StreamSink:
    """Per-run shared state of one query stream: the query matrix, arrival
    times, output arrays, and the run clock. Workers write completed
    batches here; a fleet shares ONE sink across all its workers so the
    reassembled output is indistinguishable from a single engine's."""

    def __init__(self, queries: np.ndarray, arrivals: np.ndarray, k: int):
        self.q = queries
        self.arr = arrivals
        n = len(queries)
        self.out_ids = np.full((n, k), -1, np.int32)
        self.out_d = np.full((n, k), np.inf, np.float32)
        self.lat = np.full(n, np.nan)
        self.on_finish = None   # optional callback(idxs) at completion —
        self._t0 = time.perf_counter()  # e.g. per-tenant credit release

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def finish(self, idxs: np.ndarray, ids: np.ndarray, dists: np.ndarray):
        tc = self.now()
        self.out_ids[idxs] = ids
        self.out_d[idxs] = dists
        self.lat[idxs] = tc - self.arr[idxs]
        if self.on_finish is not None:
            self.on_finish(idxs)


class EngineWorker:
    """One engine's flush/harvest loop, factored out of StreamingScheduler
    so the fleet tier can compose N of them over one stream.

    Owns the per-engine arrival buffer, the bucket-ladder dispatch, the
    bounded in-flight FIFO (the paper's flow control), and out-of-order
    harvest. Two backpressure styles via ``pump``:

      * block_when_full=True  — single-engine mode: a full FIFO is relieved
        by a blocking harvest (the host thread has nothing better to do).
      * block_when_full=False — fleet mode: at zero credits the flush is
        refused and queries stay upstream in the fleet's admission queue,
        so one slow engine never stalls its siblings.
    """

    def __init__(self, engine, sink: StreamSink, *, buckets: tuple[int, ...],
                 fill_threshold: int, wait_limit_s: float, fifo_depth: int,
                 exec_backend=None):
        self.engine = engine
        self.sink = sink
        if exec_backend is None:
            from .execbackend import INPROC
            exec_backend = INPROC
        self.exec = exec_backend            # ExecutionBackend (where flushes run)
        self.buckets = buckets
        self.max_bucket = buckets[-1]
        self.fill_threshold = fill_threshold
        self.wait_limit_s = wait_limit_s
        self.fifo_depth = fifo_depth
        self.buf: list[int] = []            # admitted, not yet dispatched
        self.inflight: deque = deque()  # (query idxs, result, t, CUDA event)
        self.flush_sizes: list[int] = []
        self.max_in_flight = 0
        self._compiles0 = engine.compile_count

    # -- credit-based backpressure accounting --------------------------------
    @property
    def in_flight(self) -> int:
        return len(self.inflight)

    @property
    def credits(self) -> int:
        """Free in-flight FIFO slots — the fleet's backpressure currency."""
        return self.fifo_depth - len(self.inflight)

    def room(self) -> int:
        """Queries this worker can accept without overrunning its FIFO:
        each free slot is worth one max-bucket flush."""
        return max(0, self.credits * self.max_bucket - len(self.buf))

    @property
    def compiles(self) -> int:
        return self.engine.compile_count - self._compiles0

    def submit(self, idx: int):
        self.buf.append(idx)

    # -- dispatch / harvest ---------------------------------------------------
    def _bucket_for(self, nq: int) -> int:
        """Smallest ladder bucket holding a flush of ``nq`` queries (the
        shared pad-shape choice of every dispatch path)."""
        for b in self.buckets:
            if b >= nq:
                return b
        raise AssertionError(
            f"flush of {nq} exceeds max bucket {self.buckets[-1]}")

    def _dispatch(self, take):
        """Pad a flush (``take``: query indices into the sink) up to the
        worker's own ladder — the engine is shared state and is never
        reconfigured from here. Subclasses (e.g. the sharded tier's
        ShardWorker) override this to attach per-query payloads such as
        probe tables to the same flush."""
        q = self.sink.q[take]
        return self.exec.search(self.engine, q,
                                pad_to=self._bucket_for(len(q)))

    def _event(self):
        """A CUDA event recorded on the engine's device after a flush's
        work is queued; None on the CPU, where the search has finished
        when it returns."""
        dev = torch.device(getattr(self.engine, "device", "cpu"))
        if dev.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    @staticmethod
    def _ready(event) -> bool:
        return event is None or event.query()

    def _finish(self, idxs, res, _t_dispatch):
        self.sink.finish(idxs, _host(res.ids), _host(res.dists))

    def harvest(self, block: bool = False) -> bool:
        got = False
        if block and self.inflight:
            self._finish(*self.inflight.popleft()[:3])  # copies: waits
            got = True
        pending = list(self.inflight)
        self.inflight.clear()
        for rec in pending:                 # out-of-order completion
            if self._ready(rec[3]):
                self._finish(*rec[:3])
                got = True
            else:
                self.inflight.append(rec)
        return got

    def flush_due(self, t: float, drain: bool) -> bool:
        buf = self.buf
        return bool(buf) and (
            len(buf) >= self.fill_threshold
            or t - self.sink.arr[buf[0]] >= self.wait_limit_s
            or drain)                       # stream ended: drain

    def pump(self, t: float, *, drain: bool = False,
             block_when_full: bool = True) -> bool:
        """Dispatch one flush if a trigger (fill / deadline / drain) fired;
        returns True iff a flush happened."""
        if not self.flush_due(t, drain):
            return False
        if not block_when_full and self.credits <= 0:
            return False                    # backpressure: refuse, don't stall
        take = self.buf[:self.max_bucket]
        del self.buf[:len(take)]
        res, _ = self._dispatch(take)
        self.inflight.append((np.asarray(take), res, t, self._event()))
        self.max_in_flight = max(self.max_in_flight, len(self.inflight))
        self.flush_sizes.append(len(take))
        if block_when_full and len(self.inflight) >= self.fifo_depth:
            self.harvest(block=True)        # FIFO flow control
        return True

    def next_deadline(self) -> float:
        """Earliest future time this worker's wait-limit trigger fires."""
        if not self.buf:
            return math.inf
        return float(self.sink.arr[self.buf[0]]) + self.wait_limit_s

    def idle(self) -> bool:
        return not self.buf and not self.inflight


@dataclasses.dataclass
class StreamReport:
    """Per-run output of StreamingScheduler.run — per-REAL-query stats only
    (pad queries never reach the output arrays nor the throughput figure)."""
    ids: np.ndarray          # (N, k) int32, reassembled in submission order
    dists: np.ndarray        # (N, k) f32 exact squared distances
    latency_s: np.ndarray    # (N,) completion - arrival, per query
    qps: float               # N real queries / makespan
    p50_ms: float
    p99_ms: float
    n_queries: int
    n_flushes: int
    flush_sizes: list
    compiles: int            # search executables built during this run
    makespan_s: float
    backend: str = ""        # engine's RankingBackend registry key


class StreamingScheduler:
    """Online realization of the paper's dynamic mini-batching (Fig 7c) on a
    real PIMCQGEngine.

    Arrivals buffer until the fill threshold is reached OR the oldest query
    has waited ``wait_limit_s`` (Fig 7c's two flush triggers). Each flush is
    padded up to the next size in a small bucket ladder (``bucket_ladder`` /
    Eq (1)'s N*), so an arbitrary arrival process sees at most
    ``len(buckets)`` batch shapes. A bounded in-flight FIFO is the paper's
    flow control; completed batches are harvested out of order (a CUDA
    event per flush) and reassembled per query.

    The flush/harvest machinery lives in ``EngineWorker`` (one per engine);
    this class composes exactly one. ``core.fleet.FleetScheduler`` composes
    N of them behind an admission queue for the multi-engine tier."""

    def __init__(self, engine, *, buckets=None, costs: StageCosts | None = None,
                 fill_threshold: int | None = None, wait_limit_s: float = 2e-3,
                 fifo_depth: int = 4, max_batch: int = 64):
        self.engine = engine
        (self.buckets, self.fill_threshold, self.wait_limit_s,
         self.fifo_depth) = resolve_stream_params(
            engine, buckets, costs, fill_threshold, wait_limit_s,
            fifo_depth, max_batch)

    def run(self, queries, arrival_times=None) -> StreamReport:
        """Replay a (possibly timed) query stream through the scheduler.

        arrival_times (N,) seconds from stream start (None = all at t=0);
        the run sleeps to honor future arrivals, so QPS under a Poisson
        trace is sustained-throughput, not batch throughput."""
        q = np.asarray(queries, np.float32)
        n = len(q)
        arr = np.zeros(n) if arrival_times is None \
            else np.asarray(arrival_times, np.float64)
        order = np.argsort(arr, kind="stable")
        sink = StreamSink(q, arr, self.engine.scfg.k)
        w = EngineWorker(self.engine, sink, buckets=self.buckets,
                         fill_threshold=self.fill_threshold,
                         wait_limit_s=self.wait_limit_s,
                         fifo_depth=self.fifo_depth)
        i = 0
        while i < n or not w.idle():
            t = sink.now()
            while i < n and arr[order[i]] <= t:
                w.submit(int(order[i]))
                i += 1
            if w.pump(t, drain=i >= n):
                continue
            if w.harvest(block=False):
                continue
            nxt = arr[order[i]] if i < n else math.inf
            nxt = min(nxt, w.next_deadline())
            if not math.isfinite(nxt):
                if w.inflight:
                    w.harvest(block=True)
                continue
            dt = nxt - sink.now()
            if dt > 0:                          # idle until next arrival or
                time.sleep(min(dt, 5e-4))       # deadline; short naps keep
                                                # dispatch responsive
        makespan = sink.now()
        return StreamReport(
            ids=sink.out_ids, dists=sink.out_d, latency_s=sink.lat,
            qps=n / makespan if makespan > 0 else 0.0,
            p50_ms=percentile_ms(sink.lat, 50),
            p99_ms=percentile_ms(sink.lat, 99),
            n_queries=n, n_flushes=len(w.flush_sizes),
            flush_sizes=w.flush_sizes, compiles=w.compiles,
            makespan_s=makespan,
            backend=getattr(getattr(self.engine, "scfg", None), "mode", ""))
