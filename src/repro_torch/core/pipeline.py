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

A flush records a CUDA event on the engine's device after its work is
queued; a harvest asks that event (``event.query()``) and never
synchronises. On the CPU a result is ready when the search returns. The
JAX package's ``EventSimulator`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

__all__ = [
    "LinkModel", "UPMEM_LINK", "TPU_ICI_LINK", "PCIE_LINK",
    "StageCosts", "tune_minibatch", "bucket_ladder",
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
