"""The port's sharded serving tier on the CPU: owner routing, placement,
``search_probed``, partitioning and the in-process topology (partition ->
scatter -> ``search_probed`` -> origin ``merge_topk``), held against the
port's own single engine bitwise (the JAX package's parity contract,
tests/test_sharded.py and tests/test_topology.py) and against the JAX
tier on the bridged index. The setup is tests/test_sharded.py's: 2000 x 32
points, 8 clusters, nprobe 2, ef 16, k 5, 37 queries.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import ivf as jivf  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core.compact_index import IndexConfig as JIndexConfig  # noqa: E402
from repro.data.synthetic import clustered_vectors, query_set  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import compact_index as tci  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import execbackend, fleet, ivf, topology  # noqa: E402
from repro_torch.core.pipeline import StreamingScheduler  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the module: ``repro.core`` re-exports its ``topology`` function
jtopology = importlib.import_module("repro.core.topology")

SCFG = dict(nprobe=2, ef=16, k=5)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine of tests/test_sharded.py and the port's engine over
    its bridged index, placement included."""
    x, _ = clustered_vectors(3, 2000, 32, 8)
    q = query_set(3, x, 37)
    je = jengine.PIMCQGEngine.build(
        jax.random.PRNGKey(0), x,
        JIndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16),
        jengine.SearchConfig(**SCFG), n_shards=2)
    pl = je.place
    te = tengine.PIMCQGEngine(
        bridge.compact_index_from_numpy(
            {f: getattr(je.index, f) for f in je.index._fields},
            device="cpu"),
        bridge.host_store_from_numpy(je.host.vectors, je.host.centroids,
                                     device="cpu"),
        bridge.placement_from_numpy(pl.order, pl.shard_of, pl.local_slot,
                                    pl.n_shards, pl.per_shard, pl.load,
                                    pl.mem),
        tci.IndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16),
        tengine.SearchConfig(**SCFG), device="cpu")
    return je, te, q


@pytest.fixture(scope="module")
def single(engines):
    """The port's single-engine answer, the tier's parity target."""
    _, te, q = engines
    res, _ = te.search(q)
    return res.ids.numpy(), res.dists.numpy()


def _probes(te, q):
    return ivf.cluster_filter(torch.from_numpy(q), te.index.centroids,
                              nprobe=te.scfg.nprobe)[0].numpy()


# ---------------------------------------------------------------------------
# owner routing and placement, against the JAX package
# ---------------------------------------------------------------------------

def _owner_case(seed, q=11, p=5, c=12, o=3):
    rng = np.random.default_rng(seed)
    probe = rng.integers(0, c, (q, p)).astype(np.int32)
    probe[rng.random((q, p)) < 0.25] = -1               # holes
    probe[0] = -1                                       # an all-hole row
    owner = rng.integers(0, o, c).astype(np.int32)
    local = rng.integers(0, 4, c).astype(np.int32)
    live = rng.random((q, p)) < 0.7
    return probe, owner, local, live, o


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_owner_split_matches_jax(seed):
    """owner_split_op (torch), split_probes_by_owner and owner_tables
    (numpy) give the JAX package's tables and touches bitwise, holes and
    live masks included."""
    probe, owner, local, live, o = _owner_case(seed)
    jt, jtouch = jivf.owner_split_op(
        jnp.asarray(probe), jnp.asarray(owner), jnp.asarray(local),
        jnp.asarray(live), n_owners=o)
    tt, ttouch = ivf.owner_split_op(
        torch.from_numpy(probe), torch.from_numpy(owner),
        torch.from_numpy(local), torch.from_numpy(live), n_owners=o)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ttouch.numpy(), np.asarray(jtouch))
    assert tt.dtype == torch.int32
    for mask in (None, live):
        want = jivf.split_probes_by_owner(probe, owner, local, o, live=mask)
        got = ivf.split_probes_by_owner(probe, owner, local, o, live=mask)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    own = np.where(live & (probe >= 0), owner[np.maximum(probe, 0)], -1)
    loc = np.where(own >= 0, local[np.maximum(probe, 0)], -1)
    for g, w in zip(ivf.owner_tables(own, loc, o),
                    jivf.owner_tables(own, loc, o)):
        np.testing.assert_array_equal(g, w)


def _bridged(pl):
    return bridge.placement_from_numpy(
        pl.order, pl.shard_of, pl.local_slot, pl.n_shards, pl.per_shard,
        pl.load, pl.mem, pl.mem_reclaimable, pl.owners_of, pl.locals_of,
        pl.resident_table)


def test_placement_members_and_resident_match_jax():
    """members / resident / permute of a plain and of a replicated JAX
    placement, carried through the bridge."""
    rng = np.random.default_rng(4)
    freq = rng.random(12) * 100
    bpc = rng.random(12) * 1e4
    plain = jplacement.greedy_place(freq, bpc, 4)
    hot = jplacement.replicate_hot(plain, freq, bpc, top_h=3, copies=2)
    for jpl in (plain, hot):
        tpl = _bridged(jpl)
        assert tpl.replicated == jpl.replicated
        for s in range(4):
            np.testing.assert_array_equal(tpl.members(s), jpl.members(s))
            np.testing.assert_array_equal(tpl.resident(s), jpl.resident(s))
        arr = np.arange(24).reshape(12, 2)
        np.testing.assert_array_equal(tpl.permute(arr), jpl.permute(arr))
        with pytest.raises(ValueError, match="outside"):
            tpl.members(4)
    assert len(_bridged(hot).resident(0)) > len(_bridged(hot).members(0))


@pytest.mark.parametrize("parts", [2, 4])
def test_partition_index_matches_jax(engines, parts):
    """The same per-engine cluster slices, bitwise, and the same owner map
    as the JAX package's partition_index of the JAX engine."""
    je, te, _ = engines
    jparts, jpl = jtopology.partition_index(je, parts)
    tparts, tpl = topology.partition_index(te, parts)
    np.testing.assert_array_equal(tpl.shard_of, jpl.shard_of)
    np.testing.assert_array_equal(tpl.local_slot, jpl.local_slot)
    assert len(tparts) == len(jparts) == parts
    for je_o, te_o in zip(jparts, tparts):
        for f in te_o.index._fields:
            if f == "dim":
                continue
            np.testing.assert_array_equal(
                getattr(te_o.index, f).numpy(),
                np.asarray(getattr(je_o.index, f)), err_msg=f)
        np.testing.assert_array_equal(te_o.place.order, je_o.place.order)
        assert te_o.device == te.device
        assert te_o.host.vectors.data_ptr() == te.host.vectors.data_ptr()


# ---------------------------------------------------------------------------
# search_probed (tests/test_sharded.py:48-104, against the port's engine)
# ---------------------------------------------------------------------------

def test_search_probed_matches_search(engines, single):
    _, te, q = engines
    probed, _ = te.search_probed(q, _probes(te, q))
    np.testing.assert_array_equal(probed.ids.numpy(), single[0])
    np.testing.assert_array_equal(probed.dists.numpy(), single[1])


def test_search_probed_padded_matches_unpadded(engines):
    _, te, q = engines
    probe = _probes(te, q)
    ref, _ = te.search_probed(q[:10], probe[:10])
    pad, _ = te.search_probed(q[:10], probe[:10], pad_to=16)
    assert torch.equal(pad.ids, ref.ids) and torch.equal(pad.dists, ref.dists)


def test_search_probed_holes_restrict_candidates(engines):
    _, te, q = engines
    probe = _probes(te, q).copy()
    probe[:, 1:] = -1
    res, _ = te.search_probed(q, probe)
    ids = res.ids.numpy()
    node_ids = te.index.node_ids.numpy()
    for i in range(len(q)):
        members = set(node_ids[probe[i, 0]].tolist()) - {-1}
        got = set(ids[i].tolist()) - {-1}
        assert got and got <= members
    res0, _ = te.search_probed(q[:1], np.full((1, probe.shape[1]), -1,
                                              np.int32))
    assert bool((res0.ids == -1).all()) and bool(res0.dists.isinf().all())


def test_search_probed_validates_shapes(engines):
    _, te, q = engines
    with pytest.raises(ValueError, match="probe rows"):
        te.search_probed(q, np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="pad_to"):
        te.search_probed(q, np.zeros((len(q), 2), np.int32), pad_to=4)
    bad = np.full((len(q), 2), te.index.n_clusters, np.int32)
    with pytest.raises(ValueError, match="LOCAL cluster ids"):
        te.search_probed(q, bad)


def test_search_probed_close_to_jax(engines):
    """Against the JAX engine's search_probed on the bridged index, with
    holes: the integer LUT rounds a float (an entry may differ by 1), so
    >= 99% equal id slots, and dists close where the ids agree."""
    je, te, q = engines
    probe = _probes(te, q).copy()
    probe[::3, 1] = -1
    jr, _ = je.search_probed(q, probe)
    tr, _ = te.search_probed(q, probe)
    jids = np.asarray(jr.ids)
    same = tr.ids.numpy() == jids
    assert same.mean() >= 0.99
    # rerank distances: q2 + c2 - 2 q.c summed in another order; the
    # cancellation leaves an absolute error of a few ulps of q2 + c2
    scale = float(np.max(np.sum(q ** 2, -1))) * 4
    np.testing.assert_allclose(tr.dists.numpy()[same],
                               np.asarray(jr.dists)[same], rtol=1e-5,
                               atol=1e-6 * scale)


def test_compile_count_and_warm(engines):
    _, te, _ = engines
    assert te.compile_count == 0
    assert te.warm((4, 8)) == 0


# ---------------------------------------------------------------------------
# the tier end to end
# ---------------------------------------------------------------------------

def _same_as_single(rep, single):
    np.testing.assert_array_equal(rep.ids, single[0])
    np.testing.assert_allclose(rep.dists, single[1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shards", [2, 4])
def test_topology_equals_single_engine(engines, single, shards):
    """TopologyConfig(shards=S).build(te).run(q): the ids of the port's own
    single-engine search, bitwise; every shard worked; the merge ran
    through the ops seam (on the CPU, its plain version)."""
    _, te, q = engines
    topo = topology.TopologyConfig(shards=shards, buckets=(8, 16)).build(te)
    assert topo.warm() == 0
    ops.reset_launch_counts()
    rep = topo.run(q)
    _same_as_single(rep, single)
    assert rep.shards == shards and rep.n_shed == 0 and rep.n_unrouted == 0
    assert rep.n_merges >= 1 and sum(rep.merge_sizes) == len(q)
    assert 1.0 <= rep.fanout_mean <= te.scfg.nprobe
    assert [d["clusters"] for d in rep.per_engine] == [8 // shards] * shards
    assert sum(1 for d in rep.per_engine if d["queries"] > 0) >= 2
    assert rep.cluster_hits.sum() == rep.shard_probes.sum()
    assert ops.launch_counts()["merge_topk"] == 0


def test_topology_poisson_stream_equals_single_engine(engines, single):
    _, te, q = engines
    arr = np.cumsum(np.random.default_rng(2).exponential(3e-4, len(q)))
    topo = topology.TopologyConfig(shards=2, buckets=(4, 8, 16),
                                   fill_threshold=16, wait_limit_s=1e-3,
                                   fifo_depth=3).build(te)
    rep = topo.run(q, arr)
    _same_as_single(rep, single)
    assert rep.n_merges >= 2


def test_topology_replicas_equal_single_engine(engines, single):
    _, te, q = engines
    for cfg in (topology.TopologyConfig(shards=2, replicas=2,
                                        buckets=(8, 16)),
                topology.TopologyConfig(replicas=2, buckets=(8, 16))):
        rep = cfg.build(te).run(q)
        _same_as_single(rep, single)
        assert rep.replicas == [2] * cfg.shards


def test_sharded_fleet_and_fleet_scheduler_equal_single_engine(engines,
                                                               single):
    _, te, q = engines
    sf = fleet.partition_engine(te, 2, buckets=(8, 16), fill_threshold=16,
                                wait_limit_s=1e-3, fifo_depth=2)
    rep = sf.run(q)
    assert isinstance(rep, fleet.ShardedReport)
    _same_as_single(rep, single)
    assert rep.n_unrouted == 0 and np.isfinite(rep.latency_s).all()
    fs = fleet.FleetScheduler(topology.replicate_engine(te, 2),
                              buckets=(8, 16))
    _same_as_single(fs.run(q), single)


def test_streaming_scheduler_equals_search(engines, single):
    _, te, q = engines
    arr = np.cumsum(np.random.default_rng(5).exponential(2e-4, len(q)))
    rep = StreamingScheduler(te, buckets=(4, 8, 16), wait_limit_s=1e-3,
                             fifo_depth=2).run(q, arr)
    _same_as_single(rep, single)
    assert rep.compiles == 0 and sum(rep.flush_sizes) == len(q)


def test_tier_close_to_jax_tier(engines):
    """The port's tier against the JAX package's tier on the bridged index:
    ids in >= 99% of slots, the same fanout and unrouted count."""
    je, te, q = engines
    cfg = dict(shards=2, buckets=(8, 16))
    jrep = jtopology.TopologyConfig(**cfg).build(je).run(q)
    trep = topology.TopologyConfig(**cfg).build(te).run(q)
    assert (trep.ids == jrep.ids).mean() >= 0.99
    assert trep.fanout_mean == jrep.fanout_mean
    assert trep.n_unrouted == jrep.n_unrouted
    np.testing.assert_array_equal(trep.cluster_hits, jrep.cluster_hits)


def test_tier_stays_on_the_engines_device(engines, monkeypatch):
    """Every partition engine, the routing centroids and the merge's
    inputs live on the source engine's device."""
    _, te, q = engines
    seen = []
    real = ops.merge_topk

    def spy(ids, dists, **kw):
        seen.append((ids.device, dists.device))
        return real(ids, dists, **kw)
    monkeypatch.setattr(ops, "merge_topk", spy)
    topo = topology.TopologyConfig(shards=2, buckets=(8, 16)).build(te)
    assert topo.device == te.device
    assert topo.centroids.device == te.device
    for grp in topo.groups:
        for e in grp:
            assert e.device == te.device
            assert e.index.codes.device == te.device
    topo.run(q)
    assert seen and all(a == b == te.device for a, b in seen)


@pytest.mark.parametrize("build", [
    lambda te: topology.TopologyConfig(shards=2, exec="mesh").exec,
    lambda te: "mesh",
], ids=["mesh", "exec_mesh"])
def test_options_not_ported_raise(engines, build):
    """The mesh backend (ROADMAP A4) is ported: "mesh", from a config or as
    a key, resolves to a NEW MeshBackend each time (prepare binds state),
    an instance passes through, and "inproc" stays the shared default
    (tests/test_execbackend.py's registry check)."""
    _, te, _ = engines
    key = build(te)
    m = execbackend.resolve_exec_backend(key)
    assert isinstance(m, execbackend.MeshBackend) and m.name == "mesh"
    assert execbackend.resolve_exec_backend(key) is not m
    assert execbackend.resolve_exec_backend(m) is m
    assert execbackend.resolve_exec_backend("inproc") is execbackend.INPROC
    assert execbackend.resolve_exec_backend(
        execbackend.InProcBackend()) is not execbackend.INPROC
    assert set(execbackend.EXEC_BACKENDS) >= {"inproc", "mesh"}


def _sharded_mutable_without_placement(te):
    parts, pl = topology.partition_index(te, 2)
    topology.ServingTopology([[p] for p in parts], part_of=pl.shard_of,
                             local_cid=pl.local_slot,
                             centroids=te.index.centroids, mutable=True)


def _grown_host(te):
    v = te.host.vectors
    te.refresh(te.index, tci.HostStore(
        torch.cat([v, v[:1]]), te.host.centroids))


@pytest.mark.parametrize("build,match", [
    (_sharded_mutable_without_placement, "needs the cluster Placement"),
    (lambda te: topology.TopologyConfig(shards=2, buckets=(8, 16))
     .build(te).apply(None), r"apply\(\) needs a mutable topology"),
    (_grown_host, "pre-allocate capacity"),
], ids=["sharded_mutable_no_placement", "apply_frozen", "refresh_grown"])
def test_day2_misuse_raises(engines, build, match):
    """The mutable tier's misuse raises the JAX package's ValueErrors."""
    _, te, _ = engines
    with pytest.raises(ValueError, match=match):
        build(te)


# ---------------------------------------------------------------------------
# mixed tiers: per-shard backends and per-query backend routing
# (tests/test_sharded.py:225-300 and the JAX package's mixed tier)
# ---------------------------------------------------------------------------

MIXED = ("mulfree", "exact", "hamming", "mulfree")   # 4 shards of 2 clusters


@pytest.fixture(scope="module")
def het_fleet(engines):
    _, te, _ = engines
    return partition_engine_het(te)


def partition_engine_het(te):
    return fleet.partition_engine(te, 2, modes=["mulfree", "exact"],
                                  buckets=(8, 16, 64), fill_threshold=64,
                                  wait_limit_s=1e-3)


def _node_set(eng):
    return set(eng.index.node_ids.numpy().ravel().tolist()) - {-1}


def test_partition_modes_give_each_engine_its_backend(engines):
    """partition_index(modes=) gives partition o the backend modes[o] over
    the same cluster slice as without modes; a modes list of the wrong
    length and modes on one shard raise the JAX package's ValueErrors."""
    je, te, _ = engines
    parts, pl = topology.partition_index(te, 4, modes=MIXED)
    plain, _ = topology.partition_index(te, 4)
    jparts, jpl = jtopology.partition_index(je, 4, modes=MIXED)
    np.testing.assert_array_equal(pl.shard_of, jpl.shard_of)
    for p, q, j, mode in zip(parts, plain, jparts, MIXED):
        assert p.scfg.mode == p.backend.name == j.scfg.mode == mode
        assert torch.equal(p.index.codes, q.index.codes)
    with pytest.raises(ValueError, match="modes has 2 entries for 4"):
        topology.partition_index(te, 4, modes=MIXED[:2])
    with pytest.raises(ValueError, match="needs shards >= 2"):
        topology.TopologyConfig(modes=("exact",))
    topo = topology.TopologyConfig(shards=4, modes=MIXED,
                                   buckets=(8, 16)).build(te)
    assert topo.modes == list(MIXED)


def test_heterogeneous_fleet_routes_by_backend(het_fleet, engines):
    """A query asking for a backend reaches only the shards declaring it;
    the returned ids all live in clusters of matching shards."""
    _, _, q = engines
    rep = het_fleet.run(q, backend="exact")
    assert rep.backends == ["mulfree", "exact"]
    assert rep.per_engine[0]["queries"] == 0          # mulfree shard idle
    got = set(rep.ids[rep.ids >= 0].ravel().tolist())
    assert got and got <= _node_set(het_fleet.engines[1])


def test_heterogeneous_fleet_per_query_backends(het_fleet, engines):
    """None rows scatter to every owning shard, each answering with its
    backend; "exact" rows touch only exact-shard clusters."""
    _, te, q = engines
    reqs = [None if i % 2 else "exact" for i in range(len(q))]
    rep = het_fleet.run(q, backend=reqs)
    none_rows = np.asarray([r is None for r in reqs])
    assert (rep.ids[none_rows] >= 0).any(axis=1).all()
    restricted = rep.ids[~none_rows]
    got = set(restricted[restricted >= 0].ravel().tolist())
    assert got and got <= _node_set(het_fleet.engines[1])
    assert rep.fanout_mean <= te.scfg.nprobe


def test_heterogeneous_fleet_unknown_backend_raises(het_fleet, engines):
    _, _, q = engines
    with pytest.raises(ValueError, match="no shard serves"):
        het_fleet.run(q, backend="nope")
    with pytest.raises(ValueError, match="backend list length"):
        het_fleet.run(q, backend=["exact"])


def test_replicated_tier_refuses_backend_routing(engines):
    _, te, q = engines
    topo = topology.TopologyConfig(replicas=2, buckets=(8, 16)).build(te)
    with pytest.raises(ValueError, match="needs a sharded topology"):
        topo.run(q, backend="mulfree")


def test_unrouted_query_completes_with_sentinels():
    """nprobe = 1 and a backend filter that removes the probed cluster's
    owner: the query completes unrouted (ids -1, dists inf, finite
    latency), on the JAX package's setup (tests/test_sharded.py:279)."""
    x, _ = clustered_vectors(5, 1200, 32, 8)
    q = query_set(5, x, 16)
    icfg = JIndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16)
    je = jengine.PIMCQGEngine.build(
        jax.random.PRNGKey(1), x, icfg,
        jengine.SearchConfig(nprobe=1, ef=16, k=4), n_shards=1)
    te = _bridged_engine(je, dict(nprobe=1, ef=16, k=4))
    sf = fleet.partition_engine(te, 2, modes=["mulfree", "exact"],
                                buckets=(16,), fill_threshold=16,
                                wait_limit_s=1e-3)
    probe = _probes(te, q)[:, 0]
    unrouted = sf.part_of[probe] == 0                  # mulfree-owned
    rep = sf.run(q, backend="exact")
    assert rep.n_unrouted == int(unrouted.sum()) > 0
    assert (rep.ids[unrouted] == -1).all()
    assert np.isinf(rep.dists[unrouted]).all()
    assert np.isfinite(rep.latency_s[unrouted]).all()
    assert (rep.ids[~unrouted] >= 0).all()


def _bridged_engine(je, scfg):
    pl = je.place
    return tengine.PIMCQGEngine(
        bridge.compact_index_from_numpy(
            {f: getattr(je.index, f) for f in je.index._fields},
            device="cpu"),
        bridge.host_store_from_numpy(je.host.vectors, je.host.centroids,
                                     device="cpu"),
        bridge.placement_from_numpy(pl.order, pl.shard_of, pl.local_slot,
                                    pl.n_shards, pl.per_shard, pl.load,
                                    pl.mem),
        tci.IndexConfig(dim=je.icfg.dim, n_clusters=je.icfg.n_clusters,
                        degree=je.icfg.degree, knn_k=je.icfg.knn_k),
        tengine.SearchConfig(**scfg), device="cpu")


@pytest.mark.parametrize("reqs", ["all", "alternate"])
def test_mixed_tier_close_to_jax_tier(engines, reqs):
    """A tier of mulfree, exact and hamming shards against the JAX
    package's, over the bridged index: ids in >= 99% of slots, the same
    fanout, unrouted count and per-shard probe counts; unrestricted, and
    with every other query restricted to the exact shard."""
    je, te, q = engines
    backend = None if reqs == "all" else \
        [None if i % 2 else "exact" for i in range(len(q))]
    cfg = dict(shards=4, modes=MIXED, buckets=(8, 16))
    jrep = jtopology.TopologyConfig(**cfg).build(je).run(q, backend=backend)
    trep = topology.TopologyConfig(**cfg).build(te).run(q, backend=backend)
    assert trep.backends == jrep.backends == list(MIXED)
    assert (trep.ids == jrep.ids).mean() >= 0.99
    assert trep.fanout_mean == jrep.fanout_mean
    assert trep.n_unrouted == jrep.n_unrouted
    np.testing.assert_array_equal(trep.shard_probes, jrep.shard_probes)
    np.testing.assert_array_equal(trep.cluster_hits, jrep.cluster_hits)


def test_mixed_tier_partials_are_each_engines_own(engines):
    """Each partition answers by its own backend: the tier's ids equal the
    merge of every partition engine's own search_probed of its probes."""
    _, te, q = engines
    topo = topology.TopologyConfig(shards=4, modes=MIXED,
                                   buckets=(8, 16)).build(te)
    backend = [None if i % 2 else "exact" for i in range(len(q))]
    rep = topo.run(q, backend=backend)
    tables, touches, _, _ = topo._route_probes(q, backend)
    slots = np.cumsum(touches, axis=1) - 1
    k = topo.k
    part_ids = np.full((len(q), topo.fanout * k), -1, np.int32)
    part_d = np.full((len(q), topo.fanout * k), np.inf, np.float32)
    for o, grp in enumerate(topo.groups):
        rows = np.nonzero(touches[:, o])[0]
        if len(rows):
            res, _ = grp[0].search_probed(q[rows], tables[o][rows])
            cols = slots[rows, o][:, None] * k + np.arange(k)
            part_ids[rows[:, None], cols] = res.ids.numpy()
            part_d[rows[:, None], cols] = res.dists.numpy()
    want, _ = ops.merge_topk(torch.from_numpy(part_ids),
                             torch.from_numpy(part_d), k=k)
    np.testing.assert_array_equal(rep.ids, want.numpy())
    exact_rows = rep.ids[0::2]                  # backend[i] = "exact", i even
    got = set(exact_rows[exact_rows >= 0].ravel().tolist())
    assert got and got <= _node_set(topo.groups[1][0])


def test_day2_operations_not_ported_raise(engines):
    """Every day-2 operation is ported: apply() on a frozen tier and a
    tenant-tagged run without a registry are refused with the JAX
    package's ValueErrors, as its tier refuses them."""
    je, te, _ = engines
    topo = topology.TopologyConfig(shards=2, buckets=(8, 16)).build(te)
    jtopo = jtopology.TopologyConfig(shards=2, buckets=(8, 16)).build(je)
    for tier in (topo, jtopo):
        with pytest.raises(ValueError, match="needs a mutable topology"):
            tier.apply(None)
    with pytest.raises(ValueError, match="TenantSpec registry"):
        topo.run(np.zeros((1, 32), np.float32), tenant="a")


# ---------------------------------------------------------------------------
# admission control, against the JAX package's controller
# ---------------------------------------------------------------------------

def _tenant_specs(mod):
    return [mod.TenantSpec("a", weight=3.0, queue_depth=4, credits=2),
            mod.TenantSpec("b", queue_depth=2, shed_policy="drop-old",
                           deadline_s=0.05),
            mod.TenantSpec("c", weight=2.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_controller_matches_jax(seed):
    """DWRR dealing across weighted tenants, in-service credits, drop-old
    eviction and per-tenant deadlines: the same offers, pops, releases and
    expiries on both controllers give the same answers at every step."""
    rng = np.random.default_rng(seed)
    n = 80
    arr = np.sort(rng.random(n) * 0.2)
    tenant_of = rng.integers(0, 3, n).astype(np.int32)
    ctls = [m.AdmissionController(6, 0.08, arr, tenants=_tenant_specs(m),
                                  tenant_of=tenant_of)
            for m in (jtopology, topology)]
    dealt = []
    trace = [[], []]
    for i in range(n):
        t = float(arr[i])
        n_pop = int(rng.integers(0, 3))
        rel = rng.random(len(dealt)) < 0.4
        for c, log in zip(ctls, trace):
            log.append(("offer", c.offer(i), c.drain_evicted(), c.expire(t),
                        c.next_deadline()))
            log.append(("pop", [c.pop() for _ in range(n_pop)]))
        popped = [p for p in trace[1][-1][1] if p is not None]
        released = [d for d, r in zip(dealt, rel) if r]
        dealt = [d for d, r in zip(dealt, rel) if not r] + popped
        for c, log in zip(ctls, trace):
            c.release(released)
            log.append(("state", len(c), list(c.deficit),
                        list(c.in_service), list(c.dealt),
                        list(c.max_in_service)))
    assert trace[1] == trace[0]
    port = ctls[1]
    assert port.max_in_service[0] == 2            # tenant a's credit cap held
    assert any(ev for step in trace[1] if step[0] == "offer"
               for ev in step[2])                 # drop-old evicted someone


@pytest.mark.parametrize("bad", [dict(name=""), dict(weight=0),
                                 dict(queue_depth=-1), dict(deadline_s=0),
                                 dict(credits=0), dict(shed_policy="lifo"),
                                 dict(k=0), dict(nprobe=0),
                                 dict(adaptive_tau=-1.0),
                                 dict(adaptive_min_probes=0)])
def test_tenant_spec_validation_matches_jax(bad):
    kw = dict(name="t") | bad
    for mod in (jtopology, topology):
        with pytest.raises(ValueError):
            mod.TenantSpec(**kw)
