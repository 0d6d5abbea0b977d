"""Tenant registries in the port's serving tier (``ServingTopology(
tenants=...)``), held against the JAX package (tests/test_tenancy.py's
cases, re-expressed).

Registry and label validation give the JAX package's messages. The
per-tenant probe cuts (``nprobe`` / ``adaptive_tau`` prefix cuts of the
distance-sorted probes) give the JAX package's scatter tables bitwise,
ties included, on tiers whose centroids repeat. On real engines (the
bridged index of tests/test_torch_sharded.py) a two-tenant run gives each
tenant the ids it gets alone and the JAX tier's; on lazy fakes under the
virtual clock of tests/test_torch_hedge.py the DWRR admission, credits,
deadlines and per-tenant heat are exact.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core.compact_index import IndexConfig as JIndexConfig  # noqa: E402
from repro.data.synthetic import clustered_vectors, query_set  # noqa: E402
from repro_torch.core import fleet, topology  # noqa: E402
from test_torch_hedge import indexed_queries, virtual_tier  # noqa: E402,F401
from test_torch_sharded import _bridged_engine  # noqa: E402

jtopology = importlib.import_module("repro.core.topology")

SCFG = dict(nprobe=2, ef=16, k=5)


@pytest.fixture(scope="module")
def engines():
    """tests/test_tenancy.py's engine (2000 x 32, 8 clusters, 40 queries),
    with the port's engine over its bridged index."""
    x, _ = clustered_vectors(3, 2000, 32, 8)
    q = query_set(3, x, 40)
    je = jengine.PIMCQGEngine.build(
        jax.random.PRNGKey(0), x,
        JIndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16),
        jengine.SearchConfig(**SCFG), n_shards=2)
    te = _bridged_engine(je, SCFG)
    return je, te, q


def _both(engines):
    je, te, _ = engines
    return ((topology, te), (jtopology, je))


# ---------------------------------------------------------------------------
# validation, against the JAX package's messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards,specs", [
    (2, lambda m: []), (2, lambda m: ["latency"]),
    (2, lambda m: [m.TenantSpec("a"), m.TenantSpec("a", weight=2)]),
    (2, lambda m: [m.TenantSpec("a", backend="exact")]),
    (2, lambda m: [m.TenantSpec("a", k=99)]),
    (2, lambda m: [m.TenantSpec("a", nprobe=99)]),
    (1, lambda m: [m.TenantSpec("a", backend="mulfree")]),
    (1, lambda m: [m.TenantSpec("a", nprobe=1)]),
    (1, lambda m: [m.TenantSpec("a", adaptive_tau=0.5)])],
    ids=["empty", "not_spec", "duplicate", "no_backend", "k", "nprobe",
         "replicated_backend", "replicated_nprobe", "replicated_tau"])
def test_registry_validation_matches_jax(engines, shards, specs):
    msgs = []
    for mod, eng in _both(engines):
        cfg = dict(shards=shards, replicas=2 if shards == 1 else 1,
                   buckets=(16,))
        with pytest.raises(ValueError) as e:
            mod.TopologyConfig(tenants=tuple(specs(mod)), **cfg).build(eng)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("tenant", ["nope", ["a", "a", "b", "zzz"],
                                    ["a", "b"], "bare"],
                         ids=["unknown", "unknown_list", "length", "bare"])
def test_run_label_validation_matches_jax(engines, tenant):
    _, _, q = engines
    msgs = []
    for mod, eng in _both(engines):
        specs = None if tenant == "bare" else \
            (mod.TenantSpec("a"), mod.TenantSpec("b"))
        topo = mod.TopologyConfig(shards=2, buckets=(16,),
                                  tenants=specs).build(eng)
        with pytest.raises(ValueError) as e:
            topo.run(q[:4], tenant="a" if tenant == "bare" else tenant)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# per-tenant probe cuts: the JAX package's tables, ties included
# ---------------------------------------------------------------------------

def _tie_tier(mod, centroids, vectors, specs, nprobe):
    """A 2-shard tier of inert engines over ``centroids`` (for routing
    alone)."""
    engs = [[types.SimpleNamespace(
        scfg=types.SimpleNamespace(k=3, nprobe=nprobe, mode="fake"),
        index=types.SimpleNamespace(n_clusters=4), buckets=(),
        host=types.SimpleNamespace(vectors=vectors), compile_count=0,
        device=torch.device("cpu"))] for _ in range(2)]
    return mod.ServingTopology(
        engs, part_of=np.repeat(np.arange(2), 4).astype(np.int32),
        local_cid=np.tile(np.arange(4), 2).astype(np.int32),
        centroids=centroids, buckets=(8,), tenants=specs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_tenant_probe_cuts_match_jax_with_ties(seed):
    """Tenants with nprobe 1 and 2 and an adaptive tau beside a full one,
    over centroids in which two pairs repeat (every query then has tied
    distances): the tables, touches, served probes and owners equal the
    JAX package's bitwise."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(0, 2.0, (8, 4)).astype(np.float32)
    cents[5], cents[6] = cents[1], cents[2]
    q = np.concatenate([cents[[1, 2, 5]] + 0.0,
                        rng.normal(0, 2.0, (29, 4))]).astype(np.float32)
    labels = np.arange(len(q)) % 4
    out = []
    for mod in (topology, jtopology):
        specs = [mod.TenantSpec("full"), mod.TenantSpec("one", nprobe=1),
                 mod.TenantSpec("two", nprobe=2),
                 mod.TenantSpec("tau", adaptive_tau=1.5,
                                adaptive_min_probes=2)]
        topo = _tie_tier(mod, cents,
                         torch.zeros((4, 4)) if mod is topology
                         else jnp.zeros((4, 4)), specs, nprobe=4)
        out.append(topo._route_probes(q, None, specs, labels))
    for g, w in zip(*out):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    served = out[0][2]
    assert (served[labels == 1][:, 1:] == -1).all()
    assert (served[labels == 2][:, 2:] == -1).all()
    assert (served[labels == 0] >= 0).all()


# ---------------------------------------------------------------------------
# real engines: per-tenant results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["backends", "nprobe"])
def test_two_tenant_hybrid_matches_each_tenant_alone(engines, variant):
    """tests/test_tenancy.py's acceptance on the port: two tenants share a
    shards=2 x replicas=2 hybrid and each tenant's rows equal that tenant
    run alone, bitwise; the rows equal the JAX tier's in >= 99% of slots
    with the same per-tenant counts and heat. ``backends`` pins a latency
    tenant to hamming and a recall tenant to exact (the JAX test);
    ``nprobe`` cuts the latency tenant to one probe on one backend."""
    je, te, q = engines
    labels = ["latency" if i % 2 == 0 else "recall" for i in range(len(q))]
    lat = np.array([x == "latency" for x in labels])
    reps = []
    for mod, eng in _both(engines):
        if variant == "backends":
            specs = (mod.TenantSpec("latency", weight=4.0,
                                    backend="hamming"),
                     mod.TenantSpec("recall", weight=1.0, backend="exact"))
            extra = dict(modes=("hamming", "exact"))
        else:
            specs = (mod.TenantSpec("latency", weight=4.0, nprobe=1),
                     mod.TenantSpec("recall", weight=1.0))
            extra = {}
        topo = mod.TopologyConfig(shards=2, replicas=2, buckets=(8, 16, 64),
                                  fill_threshold=64, wait_limit_s=1e-3,
                                  tenants=specs, **extra).build(eng)
        rep = topo.run(q, tenant=labels)
        assert rep.n_shed == 0
        alone_l = topo.run(q[lat], tenant="latency")
        alone_r = topo.run(q[~lat], tenant="recall")
        np.testing.assert_array_equal(rep.ids[lat], alone_l.ids)
        np.testing.assert_array_equal(rep.dists[lat], alone_l.dists)
        np.testing.assert_array_equal(rep.ids[~lat], alone_r.ids)
        np.testing.assert_array_equal(rep.dists[~lat], alone_r.dists)
        reps.append(rep)
    trep, jrep = reps
    assert (trep.ids == jrep.ids).mean() >= 0.99
    np.testing.assert_array_equal(trep.cluster_hits, jrep.cluster_hits)
    for name in ("latency", "recall"):
        t, j = trep.tenants[name], jrep.tenants[name]
        for key in ("weight", "backend", "k", "n_queries", "n_admitted",
                    "n_shed", "dealt"):
            assert t[key] == j[key], (name, key)
        np.testing.assert_array_equal(t["cluster_hits"], j["cluster_hits"])
    if variant == "nprobe":
        assert trep.tenants["latency"]["cluster_hits"].sum() == lat.sum()


def test_per_tenant_k_truncates_result_rows(engines):
    je, te, q = engines
    labels = ["full" if i % 2 == 0 else "short" for i in range(len(q))]
    short = np.array([x == "short" for x in labels])
    for mod, eng in _both(engines):
        topo = mod.TopologyConfig(
            shards=2, buckets=(8, 16, 64), fill_threshold=64,
            wait_limit_s=1e-3,
            tenants=(mod.TenantSpec("full"),
                     mod.TenantSpec("short", k=2))).build(eng)
        rep = topo.run(q, tenant=labels)
        ref = topo.run(q, tenant="full")
        np.testing.assert_array_equal(rep.ids[~short], ref.ids[~short])
        np.testing.assert_array_equal(rep.ids[short][:, :2],
                                      ref.ids[short][:, :2])
        assert (rep.ids[short][:, 2:] == -1).all()
        assert (rep.dists[short][:, 2:] == np.inf).all()
        assert rep.tenants["short"]["k"] == 2
        assert rep.tenants["full"]["k"] == SCFG["k"]


def test_untenanted_replicated_report_has_default_tenant(engines):
    _, te, q = engines
    rep = topology.TopologyConfig(shards=1, replicas=2,
                                  buckets=(8, 16, 64)).build(te).run(q)
    assert set(rep.tenants) == {"default"}
    assert rep.tenants["default"]["n_queries"] == len(q)
    assert rep.cluster_hits is None


def test_fleet_scheduler_serves_tenants_like_jax(engines):
    """FleetScheduler(tenants=) goes through the topology's registry, as
    the JAX package's facade does (core/fleet.py:107-142)."""
    je, te, q = engines
    labels = ["a" if i % 3 else "b" for i in range(len(q))]
    reps = []
    for mod, eng in ((fleet, te), (jfleet, je)):
        fs = mod.FleetScheduler(
            mod.replicate_engine(eng, 2), buckets=(8, 16),
            tenants=[mod.TenantSpec("a", weight=2.0),
                     mod.TenantSpec("b", k=3)])
        reps.append(fs.run(q, tenant=labels))
    trep, jrep = reps
    assert (trep.ids == jrep.ids).mean() >= 0.99
    assert set(trep.tenants) == {"a", "b"}
    for name in ("a", "b"):
        for key in ("weight", "k", "n_queries", "n_admitted", "dealt"):
            assert trep.tenants[name][key] == jrep.tenants[name][key]
    b = np.array([x == "b" for x in labels])
    assert (trep.ids[b][:, 3:] == -1).all()


# ---------------------------------------------------------------------------
# lazy fakes under the virtual clock: admission, credits, deadlines, heat
# ---------------------------------------------------------------------------

def test_credits_respected_end_to_end(virtual_tier):
    make, _ = virtual_tier
    n = 32
    topo, _ = make(2, 1, service_s=1e-3, n_queries=n, buckets=(4,),
                   fill_threshold=4, wait_limit_s=1e-3, fifo_depth=2,
                   tenants=[topology.TenantSpec("t", credits=3)])
    rep = topo.run(indexed_queries(n), tenant="t")
    st = rep.tenants["t"]
    assert rep.n_shed == 0 and st["n_admitted"] == n and st["dealt"] == n
    assert 1 <= st["max_in_service"] <= 3
    np.testing.assert_array_equal(rep.ids[:, 0], np.arange(n))


def test_noisy_neighbor_sheds_only_the_aggressor(virtual_tier):
    """An 8x-load aggressor with a tight deadline sheds, the weighted
    victim completes everything, and every shed honours the aggressor's
    own deadline; two runs shed exactly the same queries."""
    make, clock = virtual_tier
    n_v, n_a = 24, 192
    q = indexed_queries(n_v + n_a)
    labels = ["victim"] * n_v + ["aggr"] * n_a
    arr = np.concatenate([np.linspace(0.0, 0.5, n_v),
                          np.linspace(0.0, 0.5, n_a)])
    runs = []
    for _ in range(2):
        clock.t = 0.0
        topo, _ = make(2, 1, service_s=0.03, n_queries=n_v + n_a,
                       buckets=(4,), fill_threshold=4, wait_limit_s=1e-3,
                       fifo_depth=1, admission_depth=10_000,
                       tenants=[topology.TenantSpec("victim", weight=4.0),
                                topology.TenantSpec("aggr", weight=1.0,
                                                    deadline_s=0.05)])
        runs.append(topo.run(q, arr, tenant=labels))
    rep = runs[0]
    v, a = rep.tenants["victim"], rep.tenants["aggr"]
    assert v["n_shed"] == 0 and a["n_shed"] >= n_a // 4
    np.testing.assert_array_equal(rep.ids[:n_v, 0], np.arange(n_v))
    shed_rows = np.nonzero(rep.shed)[0]
    assert (shed_rows >= n_v).all()
    assert (rep.shed_wait_s[shed_rows] >= 0.05 - 1e-9).all()
    np.testing.assert_array_equal(runs[1].shed, rep.shed)


def test_goodput_tracks_weights_under_saturation(virtual_tier):
    make, _ = virtual_tier
    per = 120
    topo, _ = make(2, 1, service_s=0.02, n_queries=2 * per, buckets=(4,),
                   fill_threshold=4, wait_limit_s=1e-3, fifo_depth=1,
                   admission_depth=10_000,
                   tenants=[topology.TenantSpec("hi", weight=3.0,
                                                deadline_s=0.15),
                            topology.TenantSpec("lo", weight=1.0,
                                                deadline_s=0.15)])
    rep = topo.run(indexed_queries(2 * per), tenant=["hi", "lo"] * per)
    hi, lo = rep.tenants["hi"], rep.tenants["lo"]
    assert hi["n_shed"] > 0 and lo["n_shed"] > 0 and lo["dealt"] > 0
    assert 2.25 <= hi["dealt"] / lo["dealt"] <= 3.75


def test_per_tenant_cluster_hits_partition_the_heat(virtual_tier):
    make, _ = virtual_tier
    n = 32
    topo, _ = make(2, 1, service_s=1e-3, n_queries=n, buckets=(8,),
                   fill_threshold=8, wait_limit_s=1e-3, fifo_depth=4,
                   tenants=[topology.TenantSpec("full"),
                            topology.TenantSpec("eco", nprobe=1)])
    rep = topo.run(indexed_queries(n), tenant=["full", "eco"] * (n // 2))
    full = rep.tenants["full"]["cluster_hits"]
    eco = rep.tenants["eco"]["cluster_hits"]
    np.testing.assert_array_equal(full + eco, rep.cluster_hits)
    assert eco.sum() == n // 2 and full.sum() == n
    np.testing.assert_array_equal(rep.ids[:, 0], np.arange(n))
