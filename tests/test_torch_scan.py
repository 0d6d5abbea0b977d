"""The port's GEMV scan (``SearchConfig(scan="gemv")``) on the CPU: the
``cluster_scan`` plain version against the JAX package's ``full_scan_lane``
where ``INT_MIN`` ranks decide the order, the backend's fused
``scan_cluster`` against its rank-table default on real lanes, and a whole
gemv search against the JAX engine on the bridged index (the
tests/test_backends.py setup of tests/test_torch_engine.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backends as jbackends  # noqa: E402
from repro.core import beam_search as jbeam  # noqa: E402
from repro.core import compact_index as jci  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    clustered_vectors, ground_truth, query_set)
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import backends as tbackends  # noqa: E402
from repro_torch.core import beam_search as tbeam  # noqa: E402
from repro_torch.core import compact_index as tci  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

INT_MAX, INT_MIN = 2**31 - 1, -2**31
N, DIM, NC, NQ = 1500, 32, 8, 16
SCFG = dict(nprobe=3, ef=24, k=8, scan="gemv")


@pytest.fixture(scope="module")
def corpus():
    x, _ = clustered_vectors(7, N, DIM, NC)
    q = query_set(7, x, NQ)
    return x, q, ground_truth(x, q, SCFG["k"])


@pytest.fixture(scope="module")
def engines(corpus):
    """The JAX engine and the port's engine over the same, bridged index."""
    x, _, _ = corpus
    icfg = jci.IndexConfig(dim=DIM, n_clusters=NC, degree=12, knn_k=24)
    idx, host = jci.build_compact_index(jax.random.PRNGKey(3), x, icfg)
    sizes = np.asarray(idx.n_valid)
    pl = jplacement.greedy_place(
        sizes.astype(np.float64),
        sizes * jci.compact_bytes_per_node(icfg.dim, icfg.degree), 2)
    je = jengine.PIMCQGEngine(idx, host, pl, icfg,
                              jengine.SearchConfig(**SCFG))
    te = tengine.PIMCQGEngine(
        bridge.compact_index_from_numpy(
            {f: getattr(idx, f) for f in idx._fields}, device="cpu"),
        bridge.host_store_from_numpy(host.vectors, host.centroids,
                                     device="cpu"),
        bridge.placement_from_numpy(pl.order, pl.shard_of, pl.local_slot,
                                    pl.n_shards, pl.per_shard, pl.load,
                                    pl.mem),
        tci.IndexConfig(dim=DIM, n_clusters=NC, degree=12, knn_k=24),
        tengine.SearchConfig(**SCFG), device="cpu")
    return je, te


def _one_cluster(f_add, m):
    """A one-cluster shard whose codes and LUT are zero, so every row's rank
    is its f_add: the JAX and torch views of the same data."""
    w = 1
    lead = dict(centroids=np.zeros((1, 8), np.float32),
                codes=np.zeros((1, m, w), np.uint8),
                neighbors=np.full((1, m, 2), -1, np.int32),
                entry=np.zeros(1, np.int32), n_valid=np.array([m], np.int32),
                node_ids=np.arange(m, dtype=np.int32)[None])
    shifts = dict(rho=np.ones(1, np.float32), shift1=np.full(1, 2, np.int32),
                  shift2=np.full(1, 31, np.int32))
    jshard = jengine.PlacedIndex(
        **{k: jnp.asarray(v) for k, v in lead.items()},
        arrays=jbackends.MulFreeArrays(
            f_add=jnp.asarray(f_add[None]),
            **{k: jnp.asarray(v) for k, v in shifts.items()}))
    tshard = tengine.PlacedIndex(
        **{k: torch.from_numpy(v) for k, v in lead.items()},
        arrays=tbackends.MulFreeArrays(
            f_add=torch.from_numpy(f_add[None]),
            **{k: torch.from_numpy(v) for k, v in shifts.items()}))
    return jshard, tshard


def test_int_min_rank_takes_the_path_order():
    """A rank of INT_MIN comes last on the gemv path: JAX's full_scan_lane
    takes lax.top_k over the negated ranks, and -INT_MIN wraps to itself.
    The port's scan (the cluster_scan plain version, behind the backend's
    scan_cluster) keeps that order; JAX's cluster_scan_ref, which sorts the
    ranks themselves, puts INT_MIN first."""
    f_add = np.array([5, INT_MIN, 3, INT_MAX, 3, 7], np.int32)
    m = len(f_add)
    jshard, tshard = _one_cluster(f_add, m)
    want = jbeam.full_scan_lane(
        jshard, jnp.int32(0),
        jbackends.MulFreeLanes(jnp.zeros(8, jnp.int32), jnp.int32(0)),
        backend=jbackends.MulFreeBackend(),
        cfg=jbackends.LaneConfig(ef=m, max_iters=4, dim=8))
    got = tbeam.full_scan_lane(
        tshard, torch.zeros(1, dtype=torch.int32),
        tbackends.MulFreeLanes(torch.zeros((1, 8), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32)),
        backend=tbackends.MulFreeBackend(),
        cfg=tbackends.LaneConfig(ef=m, max_iters=4, dim=8))
    np.testing.assert_array_equal(got.ids.numpy()[0], [2, 4, 0, 5, 3, 1])
    np.testing.assert_array_equal(got.ids.numpy()[0], np.asarray(want.ids))
    np.testing.assert_array_equal(got.rank.numpy()[0], np.asarray(want.rank))
    assert int(got.hops[0]) == int(want.hops) == m
    jids, jranks = jref.cluster_scan_ref(
        jnp.zeros((m, 1), jnp.uint8), jnp.asarray(f_add),
        jnp.zeros(8, jnp.int32), jnp.int32(0), jnp.int32(2), jnp.int32(31),
        8, m)
    assert int(jranks[0]) == INT_MIN and int(jids[0]) == 1
    assert not np.array_equal(got.ids.numpy()[0], np.asarray(jids))


def _real_lanes(te, q):
    """The lanes, flat cluster ids and liveness of one search of q."""
    qt = torch.from_numpy(np.asarray(q))
    _, lane_q, lane_cl, _, _ = te._route(qt, len(q))
    return te._lanes(qt, lane_q, lane_cl)


def test_scan_cluster_fused_equals_rank_table_default(engines, corpus):
    """MulFreeBackend.scan_cluster (one cluster_scan over all lanes) gives,
    on every live lane, the ids and ranks of the backend's default body
    (rank_cluster's (L, M) table, then a stable selection); dead lanes
    come out as -1 / INT_MAX."""
    _, te = engines
    shard, fc, lanes, live = _real_lanes(te, corpus[1])
    assert bool(live.any()) and not bool(live.all())
    got = te.backend.scan_cluster(shard, fc.long(), lanes, DIM, SCFG["ef"],
                                  live)
    want = tbackends.RankingBackend.scan_cluster(
        te.backend, shard, fc.long(), lanes, DIM, SCFG["ef"], live)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g[live], w[live])
    assert bool((got[0][~live] == -1).all())
    assert bool((got[1][~live] == INT_MAX).all())


def test_gemv_search_goes_through_scan_cluster_once(engines, corpus,
                                                   monkeypatch):
    """On the CPU the scan takes the plain version and launches nothing;
    the search still goes through scan_cluster exactly once (counted with a
    wrapper around the backend's method)."""
    _, te = engines
    calls = []
    orig = te.backend.scan_cluster

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(te.backend, "scan_cluster", counted)
    ops.reset_launch_counts()
    te.search(corpus[1])
    assert len(calls) == 1
    assert ops.launch_counts()["cluster_scan"] == 0


def test_gemv_search_close_to_jax(engines, corpus):
    """The whole gemv search against the JAX engine on the bridged index:
    the LUT rounds a float (an entry may differ by 1), so >= 99% equal id
    slots and recall within 0.01, as for the beam search."""
    je, te = engines
    _, q, gt = corpus
    jr, _ = je.search(q)
    tr, ts = te.search(q)
    jids = np.asarray(jr.ids)
    assert (tr.ids.numpy() == jids).mean() >= 0.99

    def recall(ids):
        return np.mean([len(set(a[a >= 0]) & set(b)) / len(b)
                        for a, b in zip(ids, gt)])
    assert abs(recall(tr.ids.numpy()) - recall(jids)) <= 0.01
    hops = ts.hops[ts.hops > 0]
    assert bool((hops == te.index.budget).all())     # a lane scans M rows


def test_cluster_scan_ref_refuses_ef_above_m():
    args = [torch.zeros((4, 1), dtype=torch.uint8),
            torch.zeros(4, dtype=torch.int32)] + [
        torch.zeros(1, dtype=torch.int32)] * 2 + [
        torch.zeros((1, 8), dtype=torch.int32)] + [
        torch.zeros(1, dtype=torch.int32)] * 3 + [
        torch.ones(1, dtype=torch.bool)]
    with pytest.raises(ValueError, match="ef = 5"):
        tref.cluster_scan_ref(*args, 8, 5, 4)
    ids, ranks = tref.cluster_scan_ref(*args, 8, 4, 4)
    assert ids.tolist() == [[0, 1, 2, 3]] and ranks.tolist() == [[INT_MAX] * 4]
