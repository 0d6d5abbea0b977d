"""The port's query path end to end on the CPU against the JAX package, on
the tests/test_backends.py setup: the JAX-built index is carried into the
port through ``repro_torch.bridge``, so both packages search the identical
index. Lane searches fed the JAX package's own lane LUTs agree bitwise;
whole searches agree to the tolerances stated beside them.
"""

import inspect
import os
import pathlib
import subprocess
import sys

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
from repro_torch import bridge  # noqa: E402
from repro_torch.core import backends as tbackends  # noqa: E402
from repro_torch.core import beam_search as tbeam  # noqa: E402
from repro_torch.core import compact_index as tci  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402

N, DIM, NC, NQ = 1500, 32, 8, 16
SCFG = dict(nprobe=3, ef=24, k=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs test files in parallel workers, and
    timing-sensitive tests in other files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    x, _ = clustered_vectors(7, N, DIM, NC)
    q = query_set(7, x, NQ)
    return x, q, ground_truth(x, q, SCFG["k"])


@pytest.fixture(scope="module")
def built(corpus):
    """The JAX package's index, built once, and its bridged port copy."""
    x, _, _ = corpus
    icfg = jci.IndexConfig(dim=DIM, n_clusters=NC, degree=12, knn_k=24)
    idx, host = jci.build_compact_index(jax.random.PRNGKey(3), x, icfg)
    sizes = np.asarray(idx.n_valid)
    bpc = sizes * jci.compact_bytes_per_node(icfg.dim, icfg.degree)
    pl = jplacement.greedy_place(sizes.astype(np.float64), bpc, 2)
    tidx = bridge.compact_index_from_numpy(
        {f: getattr(idx, f) for f in idx._fields}, device="cpu")
    thost = bridge.host_store_from_numpy(host.vectors, host.centroids,
                                         device="cpu")
    tpl = bridge.placement_from_numpy(pl.order, pl.shard_of, pl.local_slot,
                                      pl.n_shards, pl.per_shard, pl.load,
                                      pl.mem)
    ticfg = tci.IndexConfig(dim=DIM, n_clusters=NC, degree=12, knn_k=24)
    return (idx, host, pl, icfg), (tidx, thost, tpl, ticfg)


def _engines(built, **kw):
    (idx, host, pl, icfg), (tidx, thost, tpl, ticfg) = built
    je = jengine.PIMCQGEngine(idx, host, pl, icfg,
                              jengine.SearchConfig(**SCFG, **kw))
    te = tengine.PIMCQGEngine(tidx, thost, tpl, ticfg,
                              tengine.SearchConfig(**SCFG, **kw),
                              device="cpu")
    return je, te


def _recall(ids, gt):
    return np.mean([len(set(a[a >= 0]) & set(b)) / len(b)
                    for a, b in zip(np.asarray(ids), gt)])


def _jax_lanes(je, q, shard):
    """The JAX package's own lanes and lane LUTs for every (query, local
    cluster) pair of one shard."""
    per = je.place.per_shard
    view = jax.tree.map(lambda a: a[shard], je.placed)
    lane_q = np.repeat(np.arange(NQ), per).astype(np.int32)
    lane_cl = np.tile(np.arange(per), NQ).astype(np.int32)
    lanes = je.backend.prepare_lanes(
        jnp.asarray(q)[lane_q], view.centroids[lane_cl], je.index.rotation,
        view.arrays, jnp.asarray(lane_cl), DIM)
    return view, lane_cl, lanes


@pytest.fixture
def seam_calls(monkeypatch):
    """Records each call of the kernel seam ``ops.ranked_beam_search`` (the
    CPU route runs its plain version, ``ref.ranked_beam_search_ref``)."""
    calls = []
    real = tbackends.kernel_ops.ranked_beam_search

    def recording(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(tbackends.kernel_ops, "ranked_beam_search",
                        recording)
    return calls


@pytest.mark.parametrize("scan", ["beam", "gemv"])
@pytest.mark.parametrize("shard", [0, 1])
def test_lane_search_bitwise_given_jax_luts(built, corpus, scan, shard,
                                            seam_calls):
    """Fed the JAX package's lane LUTs, the search of all lanes gives the
    same ids, ranks and hops as the vmapped per-lane loop: a mulfree beam
    search through the kernel seam ``ops.ranked_beam_search`` (one call), and
    the base class's plain lock-step loop, one ``rank_ids`` call a hop."""
    _, q, _ = corpus
    je, te = _engines(built, scan=scan)
    view, lane_cl, lanes = _jax_lanes(je, q, shard)
    cfg = jbackends.LaneConfig(ef=SCFG["ef"], max_iters=64, dim=DIM)
    fn = jbeam.full_scan_lane if scan == "gemv" else jbeam.beam_search_lane
    want = jax.vmap(lambda c, ln: fn(view, c, ln, backend=je.backend,
                                     cfg=cfg))(jnp.asarray(lane_cl), lanes)
    tfn = tbeam.full_scan_lane if scan == "gemv" else tbeam.beam_search_lane
    tlanes = tbackends.MulFreeLanes(torch.from_numpy(np.array(lanes.lut)),
                                    torch.from_numpy(np.array(lanes.sumq)))
    fc = torch.from_numpy(lane_cl + shard * je.place.per_shard)
    tcfg = tbackends.LaneConfig(ef=SCFG["ef"], max_iters=64, dim=DIM)
    got = tfn(te.placed.flat(), fc, tlanes, backend=te.backend, cfg=tcfg)
    results = [tuple(got)]
    assert len(seam_calls) == (scan == "beam")
    if scan == "beam":
        results.append(tbackends.RankingBackend.search_lanes(
            te.backend, te.placed.flat(), fc.long(), tlanes, tcfg,
            torch.ones(len(fc), dtype=torch.bool)))
    for ids, rank, hops in results:
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(want.rank))
        np.testing.assert_array_equal(hops.numpy(), np.asarray(want.hops))


def test_visited_scatter_quirk_reproduced(seam_calls):
    """The reference marks visited with a scatter in which every -1 slot
    writes node 0's OLD flag after a real 0 wrote True, and the last writer
    wins: node 0 followed by a -1 in a row stays unvisited and can enter
    the beam twice. The port reproduces that search exactly, through the
    kernel seam ``ops.ranked_beam_search``.

    Ranks are f_add (codes and LUT are zero): 1 (entry) < 0 < 2 < 3.
    Expanding 1 adds 0 (row [0, -1, -1]: stays unvisited); expanding 0 adds
    2; expanding 2 (row [0, 3, -1]) adds 0 AGAIN and 3."""
    m, r, w = 4, 3, 1
    nbrs = np.array([[2, -1, -1], [0, -1, -1], [0, 3, -1], [-1, -1, -1]],
                    np.int32)
    f_add = np.array([10, 5, 20, 30], np.int32)
    lead = dict(centroids=np.zeros((1, 8), np.float32),
                codes=np.zeros((1, m, w), np.uint8), neighbors=nbrs[None],
                entry=np.array([1], np.int32), n_valid=np.array([m], np.int32),
                node_ids=np.arange(m, dtype=np.int32)[None])
    shifts = dict(rho=np.ones(1, np.float32), shift1=np.full(1, 2, np.int32),
                  shift2=np.full(1, 31, np.int32))
    jshard = jengine.PlacedIndex(
        **{k: jnp.asarray(v) for k, v in lead.items()},
        arrays=jbackends.MulFreeArrays(
            f_add=jnp.asarray(f_add[None]),
            **{k: jnp.asarray(v) for k, v in shifts.items()}))
    want = jbeam.beam_search_lane(
        jshard, jnp.int32(0),
        jbackends.MulFreeLanes(jnp.zeros(8, jnp.int32), jnp.int32(0)),
        backend=jbackends.MulFreeBackend(),
        cfg=jbackends.LaneConfig(ef=6, max_iters=10, dim=8))
    tshard = tengine.PlacedIndex(
        **{k: torch.from_numpy(v) for k, v in lead.items()},
        arrays=tbackends.MulFreeArrays(
            f_add=torch.from_numpy(f_add[None]),
            **{k: torch.from_numpy(v) for k, v in shifts.items()}))
    got = tbeam.beam_search_lane(
        tshard, torch.zeros(1, dtype=torch.int32),
        tbackends.MulFreeLanes(torch.zeros((1, 8), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32)),
        backend=tbackends.MulFreeBackend(),
        cfg=tbackends.LaneConfig(ef=6, max_iters=10, dim=8))
    assert len(seam_calls) == 1
    ids = np.asarray(want.ids)
    assert (ids == 0).sum() == 2, ids        # node 0 entered twice
    np.testing.assert_array_equal(got.ids.numpy()[0], ids)
    np.testing.assert_array_equal(got.rank.numpy()[0], np.asarray(want.rank))
    assert int(got.hops[0]) == int(want.hops)


@pytest.mark.parametrize("tau", [0.0, 1.5])
def test_engine_search_close_to_jax(built, corpus, tau):
    _, q, gt = corpus
    je, te = _engines(built, adaptive_tau=tau)
    jr, js = je.search(q)
    tr, ts = te.search(q)
    jids = np.asarray(jr.ids)
    # the LUTs round floats (entries may differ by 1), so a near-tied rank
    # can reorder a beam: >= 99% equal id slots, recall within 0.01
    assert (tr.ids.numpy() == jids).mean() >= 0.99
    assert abs(_recall(tr.ids.numpy(), gt) - _recall(jids, gt)) <= 0.01
    assert int(ts.dropped_lanes) == int(js.dropped_lanes)
    same = tr.ids.numpy() == jids
    # rerank distances: q2 + c2 - 2 q.c summed in another order; the
    # cancellation leaves an absolute error of a few ulps of q2 + c2
    scale = float(np.max(np.sum(np.asarray(q) ** 2, -1))) * 4
    np.testing.assert_allclose(tr.dists.numpy()[same],
                               np.asarray(jr.dists)[same], rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("dim", [32, 30])
def test_rerank_distances_are_batch_invariant_and_close_to_jax(dim):
    """A query's rerank distances and lane LUTs are the same bits in any
    batch (summed through ``fixed_order``, so the sharded tier's partials
    equal the single engine's); the distances are within a few ulps of
    q2 + c2 of the JAX package's rerank, which picks the same ids."""
    from repro.core import rerank as jrerank
    from repro_torch.core import rabitq as trabitq
    from repro_torch.core import rerank as trerank
    rng = np.random.default_rng(dim)
    lanes = torch.from_numpy(rng.standard_normal((5000, dim)).astype(
        np.float32))
    rot = trabitq.random_rotation(torch.Generator().manual_seed(dim), dim)
    lut = trabitq.prepare_query(lanes, lanes.flip(0), rot)
    for a, b in ((0, 1), (10, 4106), (4000, 5000)):
        part = trabitq.prepare_query(lanes[a:b], lanes.flip(0)[a:b], rot)
        for got, want in zip(part, lut):
            assert torch.equal(got, want[a:b])
    vec = (rng.standard_normal((3000, dim)) * 3).astype(np.float32)
    q = (rng.standard_normal((300, dim)) * 3).astype(np.float32)
    cand = rng.integers(-1, 3000, (300, 64)).astype(np.int32)
    full = trerank.exact_sqdist(*map(torch.from_numpy, (q, cand, vec)))
    for a, b in ((0, 1), (7, 263), (299, 300)):
        part = trerank.exact_sqdist(torch.from_numpy(q[a:b]),
                                    torch.from_numpy(cand[a:b]),
                                    torch.from_numpy(vec))
        assert torch.equal(part, full[a:b])
    got = trerank.rerank(*map(torch.from_numpy, (q, cand, vec)), k=10)
    want = jrerank.rerank(jnp.asarray(q), jnp.asarray(cand),
                          jnp.asarray(vec), k=10)
    assert (got.ids.numpy() == np.asarray(want.ids)).mean() >= 0.99
    scale = float(np.max(np.sum(q ** 2, -1))) * 4
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("scan", ["beam", "gemv"])
def test_padded_search_bitwise_equals_unpadded(built, corpus, scan):
    _, q, _ = corpus
    _, te = _engines(built, scan=scan)
    a, sa = te.search(q)
    b, sb = te.search(q, pad_to=24)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert int(sa.dropped_lanes) == int(sb.dropped_lanes)
    te_b = tengine.PIMCQGEngine(te.index, te.host, te.place, te.icfg,
                                te.scfg, buckets=(8, 24), device="cpu")
    c, _ = te_b.search_bucketed(q)
    assert torch.equal(a.ids, c.ids) and torch.equal(a.dists, c.dists)


def test_port_built_index_recall_close_to_jax(built, corpus):
    """Running free with its own generator, the port's build reaches the
    recall of the JAX build within 0.03."""
    x, q, gt = corpus
    je, _ = _engines(built)
    jrec = _recall(je.search(q)[0].ids, gt)
    ticfg = built[1][3]
    te = tengine.PIMCQGEngine.build(
        0, x, ticfg, tengine.SearchConfig(**SCFG), n_shards=2, device="cpu")
    assert te.index.codes.shape[0] == NC and te.index.neighbors.shape[-1] == 12
    trec = _recall(te.search(q)[0].ids.numpy(), gt)
    assert trec >= jrec - 0.03, (trec, jrec)
    assert te.footprint() == jci.footprint_report(
        DIM, 12, N, slab=NC * te.index.budget - N)


def test_entry_points_default_to_the_card():
    for fn in (tengine.PIMCQGEngine.__init__, tengine.PIMCQGEngine.build):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (bridge.compact_index_from_numpy, bridge.host_store_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_port_imports_neither_jax_nor_repro():
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.core.engine, repro_torch.bridge, "
            "repro_torch.data.synthetic, repro_torch.core.topology, "
            "repro_torch.core.fleet, repro_torch.core.pipeline, "
            "repro_torch.core.execbackend, repro_torch.kernels.merge_topk, "
            "repro_torch.kernels.cluster_scan, "
            "repro_torch.kernels.beam_search; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=str(src)))
