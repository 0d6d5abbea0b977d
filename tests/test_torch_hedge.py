"""Hedged dispatch in the port's serving tier (``ShardHedge``,
``distributed/straggler.py``), held against the JAX package.

The straggler classes take their clock as an argument, so their unit
behaviour is asserted on a scripted clock, as tests/test_straggler.py
does. The tier's hedged scatter path runs on lazy fake shard engines under
a virtual clock (``virtual_tier``): the stream clock, the run loop's naps
and each flush's readiness test all read one ``VirtualClock``, so a slow
replica's flushes go overdue and are reissued at exact, repeatable
instants, with no sleeps. On real engines (the bridged index of
tests/test_torch_sharded.py) a hedged tier gives the ids of the unhedged
one and of the JAX package's tier.
"""

import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.compact_index import IndexConfig as JIndexConfig  # noqa: E402
from repro.data.synthetic import clustered_vectors, query_set  # noqa: E402
from repro.distributed import straggler as jstraggler  # noqa: E402
from repro_torch.core import pipeline, topology  # noqa: E402
from repro_torch.distributed import straggler  # noqa: E402
from test_torch_sharded import _bridged_engine  # noqa: E402

jtopology = importlib.import_module("repro.core.topology")


# ---------------------------------------------------------------------------
# the virtual-clock harness (tests/test_torch_tenancy.py and
# tests/test_torch_autoscale.py import it)
# ---------------------------------------------------------------------------

class VirtualClock:
    """One clock for the stream, the run loop's naps and the fakes'
    device time: a nap advances it instead of sleeping."""

    def __init__(self):
        self.t = 0.0

    def sleep(self, dt):
        self.t += max(float(dt), 0.0)


class _Lazy:
    """A fake device result: reading it waits (advances the clock) until
    the fake engine's flush is done."""

    def __init__(self, a, t_done, clock):
        self._a, self._t, self._clock = a, t_done, clock

    def __array__(self, dtype=None, *_, **__):
        self._clock.t = max(self._clock.t, self._t)
        return self._a if dtype is None else self._a.astype(dtype)


class _Event:
    def __init__(self, t_done, clock):
        self._t, self._clock = t_done, clock

    def query(self):
        return self._clock.t >= self._t


class FakeShardEngine:
    """search_probed answers ids[i] = int(q[i, 0]) after ``service_s`` of
    virtual device time, flushes serialised per engine."""

    def __init__(self, n_clusters, clock, *, k=3, nprobe=2, service_s=0.01,
                 mode="fake", vectors=None):
        self.scfg = types.SimpleNamespace(k=k, nprobe=nprobe, mode=mode)
        self.index = types.SimpleNamespace(n_clusters=n_clusters)
        self.host = types.SimpleNamespace(vectors=vectors)
        self.device = torch.device("cpu")
        self.buckets = ()
        self.clock = clock
        self.service_s = service_s
        self.t_free = 0.0
        self.t_last = 0.0

    @property
    def compile_count(self):
        return 0

    def search_probed(self, q, probes, *, pad_to=None):
        q = np.asarray(q)
        t_done = max(self.clock.t, self.t_free) + self.service_s
        self.t_free = self.t_last = t_done
        ids = np.repeat(q[:, :1].astype(np.int32), self.scfg.k, axis=1)
        dists = np.zeros((len(q), self.scfg.k), np.float32)
        return types.SimpleNamespace(
            ids=_Lazy(ids, t_done, self.clock),
            dists=_Lazy(dists, t_done, self.clock)), None


@pytest.fixture
def virtual_tier(monkeypatch):
    """A factory of fake sharded tiers under one VirtualClock: the stream
    clock (``StreamSink``'s ``time.perf_counter``), the run loop's
    ``time.sleep`` and each flush's readiness event read it. Returns (make, clock); ``make(
    n_shards, replicas, service={(shard, replica): s}, **tier_kw)`` gives
    (topology, groups) over 8 clusters of 4-dim centroids."""
    clock = VirtualClock()
    virtual = types.SimpleNamespace(perf_counter=lambda: clock.t,
                                    sleep=clock.sleep)
    monkeypatch.setattr(pipeline, "time", virtual)
    monkeypatch.setattr(topology, "time", virtual)
    monkeypatch.setattr(pipeline.EngineWorker, "_event",
                        lambda self: _Event(self.engine.t_last, clock))

    def make(n_shards=2, replicas=1, service=None, service_s=0.01,
             n_queries=64, mode="fake", **kw):
        c, dim = 8, 4
        per = c // n_shards
        part_of = np.repeat(np.arange(n_shards), per).astype(np.int32)
        local_cid = np.tile(np.arange(per), n_shards).astype(np.int32)
        centroids = np.random.default_rng(7).normal(
            0, 5.0, (c, dim)).astype(np.float32)
        vectors = torch.zeros((n_queries, dim))
        service = service or {}
        groups = [[FakeShardEngine(per, clock, mode=mode,
                                   service_s=service.get((o, r), service_s),
                                   vectors=vectors)
                   for r in range(replicas)] for o in range(n_shards)]
        topo = topology.ServingTopology(groups, part_of=part_of,
                                        local_cid=local_cid,
                                        centroids=centroids, **kw)
        return topo, groups

    return make, clock


def indexed_queries(n, dim=4):
    """Queries whose column 0 is their own index (the fakes echo it)."""
    q = np.random.default_rng(11).normal(0, 5.0, (n, dim)).astype(np.float32)
    q[:, 0] = np.arange(n)
    return q


# ---------------------------------------------------------------------------
# the straggler classes, against the JAX package's
# ---------------------------------------------------------------------------

def test_ewma_tracker_matches_jax():
    rng = np.random.default_rng(0)
    xs = rng.exponential(1.0, 50)
    for alpha in (0.2, 0.25, 1.0):
        got, want = straggler.EwmaTracker(alpha), jstraggler.EwmaTracker(alpha)
        assert got.value is None
        for x in xs:
            assert got.update(x) == want.update(x)


@pytest.mark.parametrize("kw", [dict(k=0.0), dict(max_reissue=0),
                                dict(alpha=0.0), dict(alpha=1.5)],
                         ids=["k", "max_reissue", "alpha0", "alpha15"])
def test_hedge_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as got:
        straggler.HedgeConfig(**kw)
    with pytest.raises(ValueError) as want:
        jstraggler.HedgeConfig(**kw)
    assert str(got.value) == str(want.value)
    assert straggler.HedgeConfig() == straggler.HedgeConfig(3.0, 1, 0.2)


def test_deadline_reissue_matches_jax_on_a_scripted_clock():
    """tests/test_straggler.py's script, and a seeded random one, on both
    packages' DeadlineReissue: every poll, deadline, completion and counter
    the same."""
    t = {"now": 0.0}
    clock = lambda: t["now"]                       # noqa: E731
    drs = [m.DeadlineReissue(k=2.0, max_reissue=1, clock=clock)
           for m in (straggler, jstraggler)]
    log = [[], []]
    rng = np.random.default_rng(3)
    script = [("dispatch", "a"), ("at", 100.0), ("poll",), ("next",),
              ("complete", "a"), ("dispatch", "b"), ("next",),
              ("at", 250.0), ("poll",), ("at", 301.0), ("poll",), ("poll",),
              ("next",), ("complete", "b"), ("complete", "b")]
    for i in range(40):
        script += [("at", 301.0 + 10.0 * i + rng.random()),
                   ("dispatch", i), ("poll",), ("next",)]
        if rng.random() < 0.6:
            script.append(("complete", int(rng.integers(0, i + 1))))
    for step in script:
        if step[0] == "at":
            t["now"] = step[1]
            continue
        for dr, out in zip(drs, log):
            if step[0] == "dispatch":
                dr.dispatch(step[1])
            elif step[0] == "poll":
                out.append(("poll", dr.poll()))
            elif step[0] == "next":
                out.append(("next", dr.next_deadline()))
            else:
                out.append(("complete", dr.complete(step[1])))
            out.append((dr.reissued_total, dr.duplicate_results,
                        dr.tracker.value))
    assert log[0] == log[1]
    assert ("poll", ["b"]) in log[0] and drs[0].duplicate_results >= 1


# ---------------------------------------------------------------------------
# the tier's hedged scatter path on lazy fakes under the virtual clock
# ---------------------------------------------------------------------------

SLOW = {(0, 0): 0.25}                 # shard 0, replica 0: the straggler
TIER = dict(route="round-robin", buckets=(4,), fill_threshold=4,
            wait_limit_s=1e-3, fifo_depth=2)


def _hedged_run(make, hedge, n=32):
    topo, _ = make(2, 2, service=SLOW, n_queries=n, hedge=hedge, **TIER)
    return topo.run(indexed_queries(n))


def test_hedging_reissues_deterministically_and_keeps_ids(virtual_tier):
    """The slow replica's flushes go overdue at k x the shard's EWMA and
    are re-run on the fast replica of the same shard; the first result
    wins and every loser is dropped before it deposits, so the ids are
    the unhedged run's. Under the virtual clock two runs agree in every
    count and every latency, and the hedged tail is far below the
    straggler's 250 ms."""
    make, clock = virtual_tier
    hedge = straggler.HedgeConfig(k=2.0, max_reissue=1, alpha=0.3)
    runs = []
    for _ in range(2):
        clock.t = 0.0
        runs.append(_hedged_run(make, hedge))
    clock.t = 0.0
    plain = _hedged_run(make, None)
    a, b = runs
    want = np.arange(32)
    np.testing.assert_array_equal(plain.ids[:, 0], want)
    np.testing.assert_array_equal(a.ids, plain.ids)
    assert a.n_shed == plain.n_shed == 0
    assert a.n_reissued >= 1
    assert a.n_duplicate_drops == a.n_reissued    # every race has one loser
    assert (a.n_reissued, a.n_duplicate_drops) == \
        (b.n_reissued, b.n_duplicate_drops)
    np.testing.assert_array_equal(a.latency_s, b.latency_s)
    assert a.shard_ewma_ms == b.shard_ewma_ms
    assert len(a.shard_ewma_ms) == 2 and np.isfinite(a.shard_ewma_ms).all()
    assert plain.n_reissued == plain.n_duplicate_drops == 0
    assert plain.shard_ewma_ms == []
    assert plain.p99_ms >= 250.0 > a.p99_ms


def test_hedge_never_reissues_onto_its_origin(virtual_tier):
    """One replica a shard: nowhere to hedge, so nothing is reissued even
    when a flush is overdue, and the ids are unchanged."""
    make, _ = virtual_tier
    topo, _ = make(2, 1, service={(0, 0): 0.25}, n_queries=16,
                   hedge=straggler.HedgeConfig(k=1.0), **TIER)
    rep = topo.run(indexed_queries(16))
    np.testing.assert_array_equal(rep.ids[:, 0], np.arange(16))
    assert rep.n_reissued >= 1 and rep.n_duplicate_drops == 0


def test_hedge_requires_sharded_topology_like_jax():
    eng = types.SimpleNamespace(
        scfg=types.SimpleNamespace(k=3, nprobe=2, mode="fake"),
        index=types.SimpleNamespace(n_clusters=8), buckets=(),
        host=types.SimpleNamespace(vectors=None), compile_count=0,
        device=torch.device("cpu"))
    msgs = []
    for mod, cfg in ((topology, straggler.HedgeConfig()),
                     (jtopology, jstraggler.HedgeConfig())):
        with pytest.raises(ValueError, match="hedge") as e:
            mod.ServingTopology([[eng]], buckets=(4,), fill_threshold=4,
                                hedge=cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# real engines: a hedged tier gives the unhedged tier's and JAX's ids
# ---------------------------------------------------------------------------

SCFG = dict(nprobe=2, ef=16, k=5)


@pytest.fixture(scope="module")
def engines():
    x, _ = clustered_vectors(3, 2000, 32, 8)
    q = query_set(3, x, 37)
    je = jengine.PIMCQGEngine.build(
        jax.random.PRNGKey(0), x,
        JIndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16),
        jengine.SearchConfig(**SCFG), n_shards=2)
    te = _bridged_engine(je, SCFG)
    return je, te, q


@pytest.mark.parametrize("shards", [2, 4])
def test_hedged_tier_ids_equal_unhedged_and_jax(engines, shards):
    """TopologyConfig(shards=S, replicas=2, hedge=HedgeConfig()): the ids
    of the unhedged port tier bitwise, of the port's single engine, and of
    the JAX package's hedged tier in >= 99% of slots (the integer LUT
    rounds a float, as in tests/test_torch_sharded.py)."""
    je, te, q = engines
    cfg = dict(shards=shards, replicas=2, buckets=(8, 16))
    hedged = topology.TopologyConfig(
        hedge=straggler.HedgeConfig(), **cfg).build(te).run(q)
    plain = topology.TopologyConfig(**cfg).build(te).run(q)
    jrep = jtopology.TopologyConfig(
        hedge=jstraggler.HedgeConfig(), **cfg).build(je).run(q)
    single = te.search(q)[0].ids.numpy()
    np.testing.assert_array_equal(hedged.ids, plain.ids)
    np.testing.assert_array_equal(hedged.ids, single)
    assert (hedged.ids == jrep.ids).mean() >= 0.99
    assert hedged.n_duplicate_drops <= hedged.n_reissued
    assert len(hedged.shard_ewma_ms) == shards
    assert hedged.replicas == jrep.replicas == [2] * shards
