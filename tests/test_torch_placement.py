"""Heat-aware placement, hot-cluster replication, multi-owner routing,
placement swaps, rebalancing and the skewed workloads of the port, held
against the JAX package on the same numpy inputs (tests/
test_placement_heat.py's cases, re-expressed).

The numpy functions (``zipf_query_set``, ``drifting_hotspot_stream``,
``rebalance``, ``replicate_hot``, ``choose_owners``) are copies and must
give the JAX package's outputs bit for bit. The tiers run on the port's
engine over the JAX engine's bridged index; their ids equal the port's
single engine's bitwise (the parity contract) and the JAX tier's in >= 99%
of slots (the integer LUT rounds a float, as in tests/
test_torch_sharded.py), with the same probe routing.
"""

import dataclasses
import importlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import autoscale as jautoscale  # noqa: E402
from repro.core import compact_index as jci  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import ivf as jivf  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoscale  # noqa: E402
from repro_torch.core import compact_index as tci  # noqa: E402
from repro_torch.core import ivf, placement, topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from test_torch_sharded import _bridged_engine  # noqa: E402

jtopology = importlib.import_module("repro.core.topology")


def _same_placement(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f.name
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
            assert g.dtype == w.dtype, f.name
        else:
            assert g == w, f.name


def _bridged(pl):
    return bridge.placement_from_numpy(
        pl.order, pl.shard_of, pl.local_slot, pl.n_shards, pl.per_shard,
        pl.load, pl.mem, pl.mem_reclaimable, pl.owners_of, pl.locals_of,
        pl.resident_table)


# ---------------------------------------------------------------------------
# skewed workloads
# ---------------------------------------------------------------------------

def _corpus(seed, n, d, c):
    x, centers = jsynthetic.clustered_vectors(seed, n, d, c)
    assign = ((x[:, None] - centers[None]) ** 2).sum(-1).argmin(1)
    return x, assign


@pytest.mark.parametrize("case", [
    dict(s=1.2), dict(s=1.0, hot="roll"), dict(s=0.7, hot="perm"),
    dict(s=1.4, empty=True), dict(s=1.1, n_clusters=16)],
    ids=["default", "rolled", "permuted", "empty_cluster", "n_clusters"])
def test_zipf_query_set_bitwise(case):
    """The same queries and targets as the JAX package's, bit for bit;
    an empty cluster takes the fallback draw in both."""
    x, assign = _corpus(13, 1200, 16, 12)
    c = case.get("n_clusters", 12)
    if case.get("empty"):
        assign = np.where(assign == 3, 4, assign)      # cluster 3 empty
    hot = None
    if case.get("hot") == "roll":
        hot = np.roll(np.arange(c), -5)
    elif case.get("hot") == "perm":
        hot = np.random.default_rng(2).permutation(c)
    kw = dict(s=case["s"], hot_order=hot)
    if "n_clusters" in case:
        kw["n_clusters"] = c
    got = synthetic.zipf_query_set(13, x, assign, 400, **kw)
    want = jsynthetic.zipf_query_set(13, x, assign, 400, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    if case.get("empty"):
        assert 3 in got[1]                   # the fallback branch ran


def test_zipf_query_set_grouping_at_scale():
    """The argsort grouping at 200k rows and 512 clusters draws the JAX
    package's rows bit for bit (its per-cluster flatnonzero is O(C N)),
    and bounds the port's time."""
    rng = np.random.default_rng(5)
    n, c = 200_000, 512
    assign = rng.integers(0, c, n).astype(np.int32)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    hot = rng.permutation(c)
    t = time.perf_counter()
    got = synthetic.zipf_query_set(21, x, assign, 2048, s=1.0,
                                   hot_order=hot)
    port_s = time.perf_counter() - t
    want = jsynthetic.zipf_query_set(21, x, assign, 2048, s=1.0,
                                     hot_order=hot)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port_s < 10.0, port_s


def test_drifting_hotspot_stream_bitwise():
    x, assign = _corpus(14, 800, 16, 8)
    for kw in (dict(s=1.3, shift_frac=0.25),
               dict(s=1.0, shift_frac=0.5, hot_order=np.arange(8)[::-1])):
        got = synthetic.drifting_hotspot_stream(14, x, assign, 200, 3, **kw)
        want = jsynthetic.drifting_hotspot_stream(14, x, assign, 200, 3,
                                                  **kw)
        assert len(got) == len(want) == 3
        for (gq, gt), (wq, wt) in zip(got, want):
            np.testing.assert_array_equal(gq, wq)
            np.testing.assert_array_equal(gt, wt)
    tops = [np.bincount(t, minlength=8).argmax() for _, t in got]
    assert len(set(tops)) >= 2


@pytest.mark.parametrize("call", [
    lambda m, x, a: m.zipf_query_set(1, x, a, 10, s=0.0),
    lambda m, x, a: m.zipf_query_set(1, x, a, 10, hot_order=np.zeros(8, int)),
    lambda m, x, a: m.drifting_hotspot_stream(1, x, a, 10, 0)],
    ids=["s", "hot_order", "rounds"])
def test_workload_validation_matches_jax(call):
    x, assign = _corpus(14, 200, 8, 8)
    msgs = []
    for mod in (synthetic, jsynthetic):
        with pytest.raises(ValueError) as e:
            call(mod, x, assign)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# rebalance and replicate_hot
# ---------------------------------------------------------------------------

def _skewed(seed, c=16, s=4):
    rng = np.random.default_rng(seed)
    bpc = rng.uniform(50, 150, c)
    pl = jplacement.greedy_place(np.ones(c), bpc, s)
    heat = rng.exponential(1.0, c)
    heat[pl.members(0)] *= 8.0                    # shard 0 runs hot
    return pl, heat, bpc


@pytest.mark.parametrize("kw", [
    dict(), dict(move_penalty=0.0), dict(move_penalty=0.2),
    dict(max_moves=3), dict(mem_budget="tight"), dict(bpc=None)],
    ids=["default", "free", "priced", "max_moves", "mem_budget", "no_bytes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rebalance_matches_jax(seed, kw):
    pl, heat, bpc = _skewed(seed)
    kw = dict(kw)
    if kw.pop("bpc", 1) is None:
        bpc = None
    if kw.get("mem_budget") == "tight":
        kw["mem_budget"] = float(pl.mem.max()) * 1.02
    want = jplacement.rebalance(pl, heat, bpc, **kw)
    got = placement.rebalance(_bridged(pl), heat, bpc, **kw)
    _same_placement(got, want)


@pytest.mark.parametrize("kw", [
    dict(top_h=3, copies=1), dict(top_h=5, copies=2), dict(top_h=16,
                                                            copies=3),
    dict(top_h=3, copies=1, cap=4), dict(top_h=4, copies=2,
                                         mem_budget="tight"),
    dict(top_h=0, copies=1)],
    ids=["h3", "h5c2", "all", "cap", "mem_budget", "none"])
@pytest.mark.parametrize("seed", [0, 3])
def test_replicate_hot_matches_jax(seed, kw):
    pl, heat, bpc = _skewed(seed)
    kw = dict(kw)
    if kw.get("mem_budget") == "tight":
        kw["mem_budget"] = float(pl.mem.max()) * 1.05
    want = jplacement.replicate_hot(pl, heat, bpc, **kw)
    got = placement.replicate_hot(_bridged(pl), heat, bpc, **kw)
    _same_placement(got, want)
    if got.replicated:
        # every shard one shape; pads, the resident rows past a shard's
        # copies, are never an owner's local id
        assert len({len(got.resident(s)) for s in range(got.n_shards)}) == 1
        for s in range(got.n_shards):
            n_copies = int((got.owners_of[:, 1:] == s).sum())
            pads = np.arange(got.per_shard + n_copies,
                             got.resident_table.shape[1])
            for p in pads:
                assert not ((got.owners_of == s) & (got.locals_of == p)).any()


@pytest.mark.parametrize("call", [
    lambda m, pl, h: m.rebalance(pl, h[:-1]),
    lambda m, pl, h: m.rebalance(pl, h, move_penalty=-1.0),
    lambda m, pl, h: m.rebalance(pl, type("R", (), {"cluster_hits": None})()),
    lambda m, pl, h: m.replicate_hot(pl, h, top_h=1, copies=4),
    lambda m, pl, h: m.replicate_hot(pl, h, top_h=-1)],
    ids=["shape", "penalty", "no_hits", "copies", "top_h"])
def test_placement_validation_matches_jax(call):
    pl, heat, _ = _skewed(0)
    msgs = []
    for mod, p in ((placement, _bridged(pl)), (jplacement, pl)):
        with pytest.raises(ValueError) as e:
            call(mod, p, heat)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_rebalance_accepts_a_report():
    pl, heat, bpc = _skewed(1)
    rep = type("R", (), {"cluster_hits": heat})()
    _same_placement(placement.rebalance(_bridged(pl), rep, bpc),
                    placement.rebalance(_bridged(pl), heat, bpc))


# ---------------------------------------------------------------------------
# multi-owner routing (tests/test_placement_heat.py's seeded grid)
# ---------------------------------------------------------------------------

def _routing_case(seed):
    rng = np.random.default_rng(seed)
    c = int(rng.integers(4, 17))
    s = int(rng.integers(2, 5))
    c -= c % s
    c = max(c, s)
    q_n, p_n = int(rng.integers(1, 9)), int(rng.integers(1, 5))
    pl = jplacement.greedy_place(rng.uniform(1, 5, c), np.ones(c), s)
    heat = rng.uniform(0, 10, c)
    copies = int(rng.integers(1, s))
    pr = jplacement.replicate_hot(pl, heat, np.ones(c),
                                  top_h=int(rng.integers(0, c)),
                                  copies=copies)
    probe = rng.integers(-1, c, (q_n, p_n))
    return pl, pr, probe, s


@pytest.mark.parametrize("seed", range(12))
def test_multi_owner_routing_grid(seed):
    """choose_owners and the multi-owner split_probes_by_owner give the
    JAX package's owners, local ids, loads and tables bitwise; every live
    probe goes to exactly one owner of its cluster at its local slot;
    (C, 1) maps give the 1-D path's tables."""
    pl, pr, probe, s = _routing_case(seed)
    live = np.random.default_rng(seed + 100).random(probe.shape) < 0.8
    if pr.replicated:
        for mask in (None, live):
            got = ivf.choose_owners(probe, pr.owners_of, pr.locals_of,
                                    n_owners=s, live=mask)
            want = jivf.choose_owners(probe, pr.owners_of, pr.locals_of,
                                      n_owners=s, live=mask)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
            for g, w in zip(
                    ivf.split_probes_by_owner(probe, pr.owners_of,
                                              pr.locals_of, s, live=mask),
                    jivf.split_probes_by_owner(probe, pr.owners_of,
                                               pr.locals_of, s, live=mask)):
                np.testing.assert_array_equal(g, w)
        own, local, _ = ivf.choose_owners(probe, pr.owners_of, pr.locals_of,
                                          n_owners=s)
        holes = probe < 0
        assert (own[holes] == -1).all() and (local[holes] == -1).all()
        for i, j in zip(*np.nonzero(~holes)):
            r = np.nonzero(pr.owners_of[probe[i, j]] == own[i, j])[0]
            assert len(r) == 1
            assert local[i, j] == pr.locals_of[probe[i, j], r[0]]
        tables, _ = ivf.owner_tables(own, local, s)
        assert int((tables >= 0).sum()) == int((~holes).sum())
    t1 = ivf.split_probes_by_owner(probe, pl.shard_of, pl.local_slot, s)
    t2 = ivf.split_probes_by_owner(probe, pl.shard_of[:, None],
                                   pl.local_slot[:, None], s)
    for a, b in zip(t1, t2):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["collapse", "balance", "seeded_load"])
def test_choose_owners_cases_match_jax(case):
    """A probe set replicated onto one shard lands there whole; identical
    hot queries alternate across the owners; a seeded load counter is
    updated in place; all as the JAX package's."""
    if case == "collapse":
        owners_of = np.array([[0, 2], [1, 2], [0, 2], [1, 2]], np.int32)
        locals_of = np.array([[0, 0], [0, 1], [1, 2], [1, 3]], np.int32)
        probe, n = np.array([[0, 1, 2, 3]]), 3
    else:
        owners_of = np.array([[0, 1]], np.int32)
        locals_of = np.array([[0, 5]], np.int32)
        probe, n = np.zeros((6, 1), np.int64), 2
    loads = [np.array([2, 0], np.int64), np.array([2, 0], np.int64)] \
        if case == "seeded_load" else [None, None]
    got = ivf.choose_owners(probe, owners_of, locals_of, n_owners=n,
                            load=loads[0])
    want = jivf.choose_owners(probe, owners_of, locals_of, n_owners=n,
                              load=loads[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case == "collapse":
        np.testing.assert_array_equal(got[0], [[2, 2, 2, 2]])
    elif case == "balance":
        assert got[2][0] == got[2][1] == 3
    else:
        np.testing.assert_array_equal(loads[0], loads[1])
        assert loads[0].sum() == 8


# ---------------------------------------------------------------------------
# the tier: heat-aware replicated placement, swaps, rebalancing
# ---------------------------------------------------------------------------

SCFG = dict(nprobe=2, ef=16, k=5)


@pytest.fixture(scope="module")
def built():
    """tests/test_placement_heat.py's engine (2000 x 32, 8 clusters), with
    the port's engine over its bridged index."""
    x, _ = jsynthetic.clustered_vectors(11, 2000, 32, 8)
    icfg = jci.IndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16)
    je = jengine.PIMCQGEngine.build(jax.random.PRNGKey(0), x, icfg,
                                    jengine.SearchConfig(**SCFG))
    te = _bridged_engine(je, SCFG)
    q = jsynthetic.query_set(11, x, 29)
    return je, te, x, q


def _heat(hot, base=1.0, value=50.0):
    h = np.full(8, base)
    h[list(hot)] = value
    return h


def _bpc(te):
    return te.index.n_valid.numpy().astype(np.float64) * \
        tci.compact_bytes_per_node(te.icfg.dim, te.icfg.degree)


@pytest.mark.parametrize("shards,hot,factor", [(2, 2, 2), (4, 2, 3),
                                               (4, 3, 4)])
def test_replicated_partition_matches_jax(built, shards, hot, factor):
    """partition_index(heat=, replicate_hot=, replica_factor=) gives the
    JAX package's placement (multi-owner maps and resident table) and the
    same per-engine slices, copies and pads included, bitwise."""
    je, te, _, _ = built
    heat = _heat([0, 3, 5])
    kw = dict(heat=heat, replicate_hot=hot, replica_factor=factor)
    jparts, jpl = jtopology.partition_index(je, shards, **kw)
    tparts, tpl = topology.partition_index(te, shards, **kw)
    _same_placement(tpl, jpl)
    for jp, tp in zip(jparts, tparts):
        for f in tp.index._fields:
            if f != "dim":
                np.testing.assert_array_equal(
                    getattr(tp.index, f).numpy(),
                    np.asarray(getattr(jp.index, f)), err_msg=f)


@pytest.mark.parametrize("shards,hot,factor", [(2, 2, 2), (4, 2, 3),
                                               (4, 3, 4)])
def test_replicated_tier_matches_single_engine_and_jax(built, shards, hot,
                                                       factor):
    """A heat-aware, hot-replicated tier: the port's single engine's ids
    and dists bitwise, and the unreplicated tier's; no wider fanout; the
    JAX tier's ids in >= 99% of slots with the same routing (fanout, heat
    and probes routed to each shard)."""
    je, te, _, q = built
    heat = _heat([0, 3, 5])
    cfg = dict(shards=shards, buckets=(8, 16), replicate_hot=hot,
               replica_factor=factor)
    trep = topology.TopologyConfig(**cfg).build(te, heat=heat).run(q)
    jrep = jtopology.TopologyConfig(**cfg).build(je, heat=heat).run(q)
    plain = topology.TopologyConfig(shards=shards, buckets=(8, 16)).build(
        te, heat=heat).run(q)
    single, _ = te.search(q)
    np.testing.assert_array_equal(trep.ids, single.ids.numpy())
    np.testing.assert_array_equal(trep.dists, single.dists.numpy())
    np.testing.assert_array_equal(trep.ids, plain.ids)
    assert trep.fanout_mean <= plain.fanout_mean + 1e-12
    assert (trep.ids == jrep.ids).mean() >= 0.99
    assert trep.fanout_mean == jrep.fanout_mean
    np.testing.assert_array_equal(trep.cluster_hits, jrep.cluster_hits)
    np.testing.assert_array_equal(trep.shard_probes, jrep.shard_probes)
    assert trep.cluster_hits.sum() == trep.shard_probes.sum()


def test_no_pad_local_id_is_ever_routed(built):
    """Pads (copies of a shard's own coldest clusters that keep every
    engine one shape) never appear in a probe table: every query probing
    every cluster routes only to primary or replica slots."""
    _, te, x, _ = built
    heat = _heat([1, 6], value=80.0)
    topo = topology.TopologyConfig(shards=4, buckets=(8, 16),
                                   replicate_hot=1,
                                   replica_factor=2).build(te, heat=heat)
    pl = topo.placement
    cap = pl.resident_table.shape[1] - pl.per_shard
    assert cap >= 1
    n_copies = [int((pl.owners_of[:, 1:] == s).sum())
                for s in range(pl.n_shards)]
    assert sum(cap - n for n in n_copies) >= 1        # some shard has pads
    q = np.concatenate([te.index.centroids.numpy(), x[::37]])
    q = np.tile(q, (3, 1)).astype(np.float32)
    tables, touches, served, owner_sel = topo._route_probes(q)
    for s in range(pl.n_shards):
        used = tables[s][tables[s] >= 0]
        assert used.max() < pl.per_shard + n_copies[s]
    assert ((served >= 0) == (owner_sel >= 0)).all()
    assert touches.any(axis=0).all()                  # every shard routed


def test_report_shard_probes_counts_routed_owners(built):
    _, te, _, q = built
    topo = topology.TopologyConfig(shards=2, buckets=(8, 16)).build(te)
    r = topo.run(q)
    fold = np.zeros(2)
    np.add.at(fold, topo.part_of, r.cluster_hits.astype(float))
    np.testing.assert_allclose(r.shard_probes, fold)


def test_apply_placement_swap_keeps_ids_and_matches_jax(built):
    """A rebalanced, re-replicated placement at the same capacity swapped
    into the live tier: the same ids and dists as before, the JAX
    package's slices after the same swap, and the engines' shapes
    unchanged."""
    je, te, _, q = built
    heat, heat2 = _heat([1, 4], value=60.0), _heat([2, 7], value=60.0)
    cfg = dict(shards=2, buckets=(8, 16), replicate_hot=2, replica_factor=2)
    topo = topology.TopologyConfig(**cfg).build(te, heat=heat)
    jtopo = jtopology.TopologyConfig(**cfg).build(je, heat=heat)
    ref = topo.run(q)
    old = topo.placement
    new = placement.rebalance(old, heat2, _bpc(te))
    new = placement.replicate_hot(
        new, heat2, _bpc(te), top_h=2, copies=1,
        cap=old.resident_table.shape[1] - old.per_shard)
    shapes = [tuple(g[0].placed.codes.shape) for g in topo.groups]
    topo.apply_placement(new)
    jtopo.apply_placement(jplacement.replicate_hot(
        jplacement.rebalance(jtopo.placement, heat2, _bpc(te)), heat2,
        _bpc(te), top_h=2, copies=1,
        cap=old.resident_table.shape[1] - old.per_shard))
    assert [tuple(g[0].placed.codes.shape) for g in topo.groups] == shapes
    assert (topo.placement.shard_of != old.shard_of).any()
    np.testing.assert_array_equal(topo.part_of, jtopo.part_of)
    for g, jg in zip(topo.groups, jtopo.groups):
        np.testing.assert_array_equal(g[0].index.node_ids.numpy(),
                                      np.asarray(jg[0].index.node_ids))
    r2 = topo.run(q)
    np.testing.assert_array_equal(r2.ids, ref.ids)
    np.testing.assert_array_equal(r2.dists, ref.dists)


def test_apply_placement_with_replicas_shares_the_leaders_tensors(built):
    _, te, _, q = built
    topo = topology.TopologyConfig(shards=2, replicas=2,
                                   buckets=(8, 16)).build(te)
    ref = topo.run(q)
    new = placement.rebalance(topo.placement, _heat([0, 1]), _bpc(te),
                              move_penalty=0.0)
    topo.apply_placement(new)
    for g in topo.groups:
        assert all(e.placed is g[0].placed and e.index is g[0].index
                   for e in g)
    np.testing.assert_array_equal(topo.run(q).ids, ref.ids)


@pytest.mark.parametrize("case", ["replicated_tier", "shape", "n_shards",
                                  "no_source"])
def test_apply_placement_validates_like_jax(built, case):
    je, te, _, _ = built
    msgs = []
    for mod, pmod, eng in ((topology, placement, te),
                           (jtopology, jplacement, je)):
        if case == "replicated_tier":
            topo = mod.TopologyConfig(replicas=2, buckets=(8, 16)).build(eng)
            bad = None
        else:
            topo = mod.TopologyConfig(shards=2, buckets=(8, 16)).build(eng)
            bad = {"shape": lambda: pmod.replicate_hot(
                       topo.placement, np.arange(8.0), np.ones(8), top_h=2,
                       copies=1),
                   "n_shards": lambda: pmod.greedy_place(
                       np.ones(8), np.ones(8), 4),
                   "no_source": lambda: topo.placement}[case]()
            if case == "no_source":
                topo._src_index = None
        with pytest.raises(ValueError) as e:
            topo.apply_placement(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_rebalancer_fires_on_skew_like_jax():
    """tests/test_placement_heat.py's live loop on both packages: Zipf
    traffic on one shard's clusters trips the policy, the same clusters
    move through apply_placement, the measured skew drops, and the ids
    equal a fresh tier's."""
    x, _ = jsynthetic.clustered_vectors(21, 1200, 16, 8)
    icfg = jci.IndexConfig(dim=16, n_clusters=8, degree=8, knn_k=16)
    scfg = dict(nprobe=1, ef=16, k=5)
    je = jengine.PIMCQGEngine.build(jax.random.PRNGKey(1), x, icfg,
                                    jengine.SearchConfig(**scfg))
    te = _bridged_engine(je, scfg)
    assign = np.asarray(jivf.cluster_filter(x, je.index.centroids,
                                            nprobe=1)[0]).ravel()
    acts = []
    for mod, amod, eng in ((topology, autoscale, te),
                           (jtopology, jautoscale, je)):
        pol = amod.RebalancePolicy(skew_high=1.2, patience=1,
                                   move_penalty=0.0)
        topo = mod.TopologyConfig(shards=2, buckets=(8, 16),
                                  rebalance=pol).build(eng)
        part = np.asarray(topo.part_of)
        hot_order = np.concatenate([np.flatnonzero(part == 0),
                                    np.flatnonzero(part == 1)])
        zq, _ = synthetic.zipf_query_set(5, x, assign, 64, s=1.4,
                                         hot_order=hot_order)
        before = topo.placement.shard_of.copy()
        rep = topo.run(zq)
        act = topo.rebalancer.step(rep)
        assert act is not None and act.n_moved > 0
        assert act.skew_before >= pol.skew_high
        rep2 = topo.run(zq)
        assert topo.rebalancer.observe(rep2)["skew"] < act.skew_before
        ref = mod.TopologyConfig(shards=2, buckets=(8, 16)).build(eng)
        np.testing.assert_array_equal(rep2.ids, ref.run(zq).ids)
        acts.append((act, before, topo.placement.shard_of.copy(),
                     rep.shard_probes))
    (ta, tb, tn, tp), (ja, jb, jn, jp) = acts
    assert (ta.n_moved, ta.replicated) == (ja.n_moved, ja.replicated)
    assert ta.skew_before == ja.skew_before
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tp, jp)


def test_rebalancer_with_replication_keeps_capacity(built):
    """On a replicated tier the Rebalancer re-picks the hot set at the
    same per-shard capacity, so every engine keeps its shape, and the ids
    hold."""
    _, te, x, q = built
    pol = autoscale.RebalancePolicy(skew_high=1.05, patience=1,
                                    move_penalty=0.0)
    topo = topology.TopologyConfig(shards=2, buckets=(8, 16),
                                   replicate_hot=2, replica_factor=2,
                                   rebalance=pol).build(
        te, heat=_heat([0, 3]))
    ref = topo.run(q)
    shapes = [g[0].index.n_clusters for g in topo.groups]
    rep = topo.run(np.concatenate([q[:3]] * 8))
    act = topo.rebalancer.step(rep)
    assert act is not None and act.replicated == 2
    assert [g[0].index.n_clusters for g in topo.groups] == shapes
    np.testing.assert_array_equal(topo.run(q).ids, ref.ids)


def test_rebalancer_ignores_balanced_reports(built):
    _, te, _, q = built
    topo = topology.TopologyConfig(
        shards=2, buckets=(8, 16),
        rebalance=autoscale.RebalancePolicy(skew_high=50.0)).build(te)
    assert topo.rebalancer.step(topo.run(q)) is None
    assert topo.rebalancer.actions == []


@pytest.mark.parametrize("call", [
    lambda t, a: a.RebalancePolicy(skew_high=1.0),
    lambda t, a: a.RebalancePolicy(patience=0),
    lambda t, a: a.RebalancePolicy(move_penalty=-1.0),
    lambda t, a: a.RebalancePolicy(max_moves=1),
    lambda t, a: a.RebalancePolicy(min_hits=-1),
    lambda t, a: t.TopologyConfig(shards=2, rebalance=object()),
    lambda t, a: t.TopologyConfig(rebalance=a.RebalancePolicy()),
    lambda t, a: t.TopologyConfig(shards=2, replicate_hot=1,
                                  replica_factor=3),
    lambda t, a: t.TopologyConfig(replicate_hot=1),
    lambda t, a: t.TopologyConfig(shards=2, replicate_hot=-1),
    lambda t, a: t.TopologyConfig(shards=2, replicate_hot=1,
                                  inner_shards=2)],
    ids=["skew_high", "patience", "move_penalty", "max_moves", "min_hits",
         "not_a_policy", "one_shard", "replica_factor", "replicate_one_shard",
         "replicate_negative", "inner_shards"])
def test_policy_and_config_validation_matches_jax(call):
    msgs = []
    for t, a in ((topology, autoscale), (jtopology, jautoscale)):
        with pytest.raises(ValueError) as e:
            call(t, a)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
