"""The port's mutable index (``repro_torch.core.mutable_index``) and its live
swaps on the CPU: a twin of each test of tests/test_mutable.py on the
port's own build (same fixture: clustered_vectors(3, 1200, 32, 6), slab
24), then the port against the JAX package from one built state (the JAX
index bridged in), the batched link against the one-after-another
``graph.link_new``, the encoder's batch invariance and the mutable tier
against the JAX tier.

Tolerances, where float sums run in another order than the JAX package's:
residual_norm and cos_theta rtol 1e-5 (tests/test_torch_index.py's), so
f_add = round(rn^2 * 2^12) within 2e-5 of itself plus 1; graphs >= 98% of
entries equal (test_build_cluster_graph_close_to_jax); tier ids >= 99% of
slots (tests/test_torch_sharded.py). Everything else is bitwise.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import compact_index as jci  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.mutable_index import MutableIndex as JMutableIndex  # noqa: E402
from repro.core.topology import TopologyConfig as JTopologyConfig  # noqa: E402
from repro.core.topology import partition_index as jpartition  # noqa: E402
from repro.data.synthetic import clustered_vectors, query_set  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import compact_index, engine, graph, placement  # noqa: E402
from repro_torch.core.mutable_index import MutableIndex  # noqa: E402
from repro_torch.core.topology import (TopologyConfig,  # noqa: E402
                                       partition_index, topology)

SLAB = 24
ICFG = dict(dim=32, n_clusters=6, degree=8, knn_k=16)
_FIELDS = ["codes", "f_add", "neighbors", "entry", "n_valid", "node_ids",
           "centroids", "alpha", "rho", "shift1", "shift2",
           "residual_norm", "cos_theta"]


@pytest.fixture(scope="module")
def base():
    """The port's own build of tests/test_mutable.py's corpus."""
    x, _ = clustered_vectors(3, 1200, 32, 6)
    q = query_set(3, x, 16)
    icfg = compact_index.IndexConfig(**ICFG)
    idx, host = compact_index.build_compact_index(
        torch.Generator().manual_seed(0), torch.from_numpy(x), icfg)
    return idx, host, icfg, x, q


def _mut(base, slab=SLAB, **kw):
    idx, host, icfg, _, _ = base
    return MutableIndex(idx, host, icfg, slab=slab, **kw)


def _scfg():
    return engine.SearchConfig(nprobe=2, ef=16, k=5)


def _assert_index_equal(a, b):
    for f in _FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), \
            f"CompactIndex.{f} diverges from the rebuild"


def _live(mut):
    return mut.live_ids().numpy()


def _update_churn(mut, rng, n_del, n_ins, next_gid):
    """tests/test_mutable.py's mutation shape: tombstone n_del rows, insert
    n_ins perturbed copies of surviving rows under fresh ids."""
    drop = rng.choice(_live(mut), size=n_del, replace=False)
    mut.delete(drop)
    src = rng.choice(_live(mut), size=n_ins)
    vecs = mut.vectors[src].numpy() + 0.05 * rng.standard_normal(
        (n_ins, mut.dim)).astype(np.float32)
    gids = np.arange(next_gid, next_gid + n_ins)
    mut.insert(gids, vecs)
    return drop, gids


def _single_engine_ids(pair, icfg, q):
    """Reference search ids: one engine over (idx, host)."""
    idx, host = pair
    sizes = idx.n_valid.numpy().astype(np.float64)
    bpn = compact_index.compact_bytes_per_node(icfg.dim, icfg.degree)
    pl = placement.greedy_place(sizes, sizes * bpn, 1)
    ref = engine.PIMCQGEngine(idx, host, pl, icfg, _scfg(), device="cpu")
    return ref.search(q)[0].ids.numpy()


def _tier(eng, shards=2, **kw):
    return TopologyConfig(shards=shards, mutable=True, buckets=(8, 16),
                          fill_threshold=16, wait_limit_s=1e-3,
                          fifo_depth=2, **kw).build(eng)


# ---------------------------------------------------------------------------
# twins of tests/test_mutable.py: mutate -> compact == rebuild
# ---------------------------------------------------------------------------

def test_unmutated_snapshot_matches_rebuild(base):
    mut = _mut(base)
    idx, host = mut.snapshot()
    ridx, rhost = mut.rebuild()
    _assert_index_equal(idx, ridx)
    assert torch.equal(host.vectors, rhost.vectors)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_mutate_compact_equals_rebuild(base, seed):
    x = base[3]
    mut = _mut(base)
    rng = np.random.default_rng(seed)
    next_gid = len(x)
    for _ in range(int(rng.integers(1, 3))):       # 1-2 churn rounds
        n_del = int(rng.integers(4, 24))
        n_ins = int(rng.integers(1, 16))
        _update_churn(mut, rng, n_del, n_ins, next_gid)
        next_gid += n_ins
    assert mut.dirty, "churn must mark clusters dirty"
    compacted = mut.compact()
    assert compacted and not mut.dirty
    sidx, shost = mut.snapshot()
    ridx, rhost = mut.rebuild()
    _assert_index_equal(sidx, ridx)
    assert torch.equal(shost.vectors, rhost.vectors)


def test_partial_compact_targets_only_requested(base):
    mut = _mut(base)
    _update_churn(mut, np.random.default_rng(7), 12, 8, len(base[3]))
    dirty = sorted(mut.dirty)
    assert len(dirty) >= 2
    assert mut.compact(clusters=[dirty[0]]) == [dirty[0]]
    assert sorted(mut.dirty) == dirty[1:]
    mut.compact()                              # finish the rest
    _assert_index_equal(mut.snapshot()[0], mut.rebuild()[0])


def test_delete_reinsert_roundtrip_restores_original(base):
    """Tombstone a row, compact, re-insert the same vector under the same
    id, compact: bitwise back to the initial state."""
    mut = _mut(base)
    idx0 = {f: getattr(mut, f).clone() for f in _FIELDS}
    v0 = mut.vectors.clone()
    g = int(_live(mut)[17])
    v = mut.vectors[g].clone()
    mut.delete([g])
    assert g not in _live(mut)
    mut.compact()
    mut.insert([g], v[None])
    mut.compact()
    idx1, host1 = mut.snapshot()
    for f in _FIELDS:
        assert torch.equal(getattr(idx1, f), idx0[f]), f
    assert torch.equal(host1.vectors, v0)


# ---------------------------------------------------------------------------
# serving parity: the mutated index through a topology == a single engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_compacted_serving_parity(base, shards):
    _, _, icfg, x, q = base
    mut = _mut(base)
    _update_churn(mut, np.random.default_rng(3), 16, 10, len(x))
    mut.compact()
    topo = _tier(mut.to_engine(_scfg()), shards=shards)
    rep = topo.run(q)
    assert rep.n_shed == 0 and rep.n_unrouted == 0
    np.testing.assert_array_equal(
        rep.ids, _single_engine_ids(mut.rebuild(), icfg, q))


def test_apply_swaps_mutated_state_live(base):
    """apply() on a running tier serves the new snapshot: results match a
    single engine over it, and tombstoned ids are never returned."""
    _, _, icfg, x, q = base
    mut = _mut(base)
    topo = _tier(mut.to_engine(_scfg()))
    before = topo.run(q)
    served = np.unique(before.ids)
    drop = served[served >= 0][:12]
    assert len(drop) >= 1
    mut.delete(drop)
    rng = np.random.default_rng(5)
    src = rng.choice(_live(mut), size=6)
    mut.insert(np.arange(len(x), len(x) + 6),
               mut.vectors[src].numpy() + 0.05 * rng.standard_normal(
                   (6, mut.dim)).astype(np.float32))
    topo.apply(mut)
    after = topo.run(q)
    assert not np.isin(after.ids, drop).any(), \
        "tombstoned ids surfaced in results after apply()"
    np.testing.assert_array_equal(
        after.ids, _single_engine_ids(mut.snapshot(), icfg, q))


def test_apply_requires_mutable(base):
    mut = _mut(base)
    topo = TopologyConfig(shards=2, buckets=(8, 16), fill_threshold=16,
                          wait_limit_s=1e-3).build(mut.to_engine(_scfg()))
    with pytest.raises(ValueError, match="mutable"):
        topo.apply(mut)


def test_refresh_keeps_compile_cache(base):
    """Snapshot shapes are stable, so refresh swaps in place: every placed
    tensor keeps its shape, nothing is built (compile_count stays 0), and
    the refreshed engine answers as a fresh engine over the snapshot."""
    _, _, icfg, x, q = base
    mut = _mut(base)
    eng = mut.to_engine(_scfg())
    eng.search(q)
    cc = eng.compile_count
    shapes = [t.shape for t in dataclasses.astuple(eng.placed)[:6]]
    _update_churn(mut, np.random.default_rng(11), 10, 6, len(x))
    eng.refresh(*mut.snapshot())
    np.testing.assert_array_equal(
        eng.search(q)[0].ids.numpy(),
        _single_engine_ids(mut.snapshot(), icfg, q))
    mut.compact()
    eng.refresh(*mut.snapshot())
    eng.search(q)
    assert eng.compile_count == cc
    assert [t.shape for t in dataclasses.astuple(eng.placed)[:6]] == shapes


# ---------------------------------------------------------------------------
# all-or-nothing mutation validation
# ---------------------------------------------------------------------------

def test_delete_validates_batch_atomically(base):
    mut = _mut(base)
    live0, v0 = mut.n_live, mut.version
    good = int(_live(mut)[0])
    with pytest.raises(ValueError, match="duplicate"):
        mut.delete([good, good])
    with pytest.raises(ValueError, match="not live"):
        mut.delete([good, 10**6])
    assert mut.n_live == live0 and mut.version == v0
    assert good in _live(mut)                      # the good id survived


def test_insert_validates_batch_atomically(base):
    x = base[3]
    mut = _mut(base)
    live0, v0 = mut.n_live, mut.version
    vec = mut.vectors[int(_live(mut)[0])][None]
    gid = len(x)
    with pytest.raises(ValueError, match="duplicate"):
        mut.insert([gid, gid], vec.repeat(2, 1))
    with pytest.raises(ValueError, match="already live"):
        mut.insert([int(_live(mut)[3])], vec)
    with pytest.raises(ValueError, match="capacity"):
        mut.insert([mut.capacity], vec)
    with pytest.raises(ValueError, match="ids for"):
        mut.insert([gid], vec.repeat(2, 1))
    with pytest.raises(ValueError, match="dim"):
        mut.insert([gid], vec[:, :8])
    assert mut.n_live == live0 and mut.version == v0


def test_slab_overflow_raises_without_partial_writes(base):
    x = base[3]
    mut = _mut(base, slab=4)
    # aim the whole batch at the FULLEST cluster (its free slots == slab)
    c_full = int(torch.argmax(mut.n_valid))
    v = mut.vectors[int(mut.node_ids[c_full, 0])]
    n = 5                                          # slab is 4
    vecs = v[None].repeat(n, 1)
    live0, v0 = mut.n_live, mut.version
    nbr0 = mut.neighbors.clone()
    with pytest.raises(ValueError, match="append slab full"):
        mut.insert(np.arange(len(x), len(x) + n), vecs)
    assert mut.n_live == live0 and mut.version == v0
    assert torch.equal(mut.neighbors, nbr0)
    mut.insert(np.arange(len(x), len(x) + 4), vecs[:4])
    with pytest.raises(ValueError, match="compact"):
        mut.insert([len(x) + 4], vecs[:1])


def test_tombstoned_gid_reusable_only_after_compact(base):
    mut = _mut(base)
    g = int(_live(mut)[2])
    v = mut.vectors[g][None].clone()
    mut.delete([g])
    with pytest.raises(ValueError, match="tombstoned"):
        mut.insert([g], v)
    mut.compact()
    mut.insert([g], v)
    assert g in _live(mut)


# ---------------------------------------------------------------------------
# churn-honest memory accounting
# ---------------------------------------------------------------------------

def test_footprint_report_churn_split():
    per = compact_index.compact_bytes_per_node(32, 8)
    rep = compact_index.footprint_report(32, 8, 100, tombstoned=7, slab=5)
    assert rep["pimcqg_bytes"] == rep["live_bytes"] == 100 * per
    assert rep["reclaimable_bytes"] == 7 * per
    assert rep["reserved_bytes"] == 5 * per
    assert rep["resident_bytes"] == (100 + 7 + 5) * per
    legacy = compact_index.footprint_report(32, 8, 100)
    assert legacy["reduction"] == rep["reduction"]
    assert legacy["reclaimable_bytes"] == 0 == legacy["reserved_bytes"]


def test_mutable_footprint_tracks_tombstones(base):
    mut = _mut(base)
    per = compact_index.compact_bytes_per_node(32, 8)
    assert mut.footprint()["reclaimable_bytes"] == 0
    mut.delete(_live(mut)[:9])
    fp = mut.footprint()
    assert fp["reclaimable_bytes"] == 9 * per
    assert fp["live_bytes"] == mut.n_live * per
    mut.compact()
    assert mut.footprint()["reclaimable_bytes"] == 0


def test_partition_index_mutable_billing(base):
    """mutable=True bills the full padded budget per cluster and reports
    tombstoned bytes as Placement.mem_reclaimable; the frozen path reports
    none."""
    icfg = base[2]
    mut = _mut(base)
    mut.delete(_live(mut)[:9])
    eng = mut.to_engine(_scfg())
    per = compact_index.compact_bytes_per_node(icfg.dim, icfg.degree)
    _, pl = partition_index(eng, 2, mutable=True)
    assert pl.mem_reclaimable.sum() == pytest.approx(9 * per)
    assert pl.mem.sum() == pytest.approx(
        eng.index.n_clusters * eng.index.budget * per)
    _, pl0 = partition_index(eng, 2, mutable=False)
    assert pl0.mem_reclaimable is None
    assert pl0.mem.sum() < pl.mem.sum()


# ---------------------------------------------------------------------------
# the typed config API + deprecation shim
# ---------------------------------------------------------------------------

def test_topology_config_validates_up_front():
    with pytest.raises(ValueError, match="replica"):
        TopologyConfig(replicas=0)
    with pytest.raises(ValueError, match="shard"):
        TopologyConfig(shards=0)
    with pytest.raises(ValueError, match="shards >= 2"):
        TopologyConfig(modes=("mulfree",))
    with pytest.raises(ValueError, match="route"):
        TopologyConfig(route="fastest-wins")
    with pytest.raises(ValueError, match="inner shard"):
        TopologyConfig(inner_shards=0)
    with pytest.raises(ValueError, match="AutoscalePolicy"):
        TopologyConfig(autoscale="please")
    assert TopologyConfig(shards=2, mutable=True).mutable


def test_topology_config_is_frozen():
    cfg = TopologyConfig(shards=2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.shards = 4
    assert dataclasses.replace(cfg, replicas=2).replicas == 2


def test_legacy_kwargs_shim_warns_and_matches_typed(base):
    q = base[4]
    eng = _mut(base).to_engine(_scfg())
    with pytest.warns(DeprecationWarning, match="TopologyConfig"):
        legacy = topology(eng, shards=2, mutable=True, buckets=(8, 16),
                          fill_threshold=16, wait_limit_s=1e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        typed = topology(eng, config=TopologyConfig(
            shards=2, mutable=True, buckets=(8, 16), fill_threshold=16,
            wait_limit_s=1e-3))                    # typed form: no warning
    assert legacy.mutable and typed.mutable
    np.testing.assert_array_equal(legacy.run(q).ids, typed.run(q).ids)


def test_topology_rejects_mixed_and_bogus_forms(base):
    eng = _mut(base).to_engine(_scfg())
    with pytest.raises(ValueError, match="not both"):
        topology(eng, config=TopologyConfig(), shards=2)
    with pytest.raises(ValueError, match="TopologyConfig"):
        topology(eng, config={"shards": 2})
    with pytest.raises(TypeError, match="unknown keyword"):
        with pytest.warns(DeprecationWarning):
            topology(eng, n_shards=2)


# ---------------------------------------------------------------------------
# the port's own contracts: snapshots stay put, mid-stream swaps drain
# ---------------------------------------------------------------------------

def test_snapshot_never_changes_under_later_mutations(base):
    """A snapshot hands out the mirrors; every later write copies the
    mirror first, so a served snapshot keeps its bits."""
    x = base[3]
    mut = _mut(base)
    idx, host = mut.snapshot()
    frozen = {f: getattr(idx, f).clone() for f in _FIELDS}
    vectors = host.vectors.clone()
    _update_churn(mut, np.random.default_rng(2), 20, 12, len(x))
    mut.compact()
    _update_churn(mut, np.random.default_rng(4), 5, 5, len(x) + 12)
    for f in _FIELDS:
        assert torch.equal(getattr(idx, f), frozen[f]), f
    assert torch.equal(host.vectors, vectors)
    assert not torch.equal(mut.node_ids, frozen["node_ids"])


def test_apply_mid_stream_drains_in_flight_flushes(base):
    """apply() from a run's ticker while flushes are in flight (one group,
    so a query is one flush): the drained flushes finish against the old
    state, the rest dispatch against the new one, so every row is one
    state's answer and the new state's rows hold no deleted id."""
    _, _, icfg, x, q = base
    q = np.concatenate([q] * 4)
    mut = _mut(base)
    old = _single_engine_ids(mut.snapshot(), icfg, q)
    topo = _tier(mut.to_engine(_scfg()), shards=1)
    drop = np.unique(old[old >= 0])[:40]
    mut.delete(drop)
    new = _single_engine_ids(mut.snapshot(), icfg, q)
    swapped = []

    def ticker(t):
        if not swapped and not topo._active[0].idle():
            topo.apply(mut)
            swapped.append(t)
    rep = topo.run(q, ticker=ticker)
    assert swapped, "the ticker never saw a flush in flight"
    is_old = (rep.ids == old).all(1)
    is_new = (rep.ids == new).all(1)
    assert (is_old | is_new).all()
    assert is_new.any() and (~is_new).any()
    assert not np.isin(rep.ids[is_new & ~is_old], drop).any()


# ---------------------------------------------------------------------------
# against the JAX package, from one built state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both():
    """The JAX build of the fixture corpus and the port's bridged copy."""
    x, _ = clustered_vectors(3, 1200, 32, 6)
    jicfg = jci.IndexConfig(**ICFG)
    jidx, jhost = jci.build_compact_index(jax.random.PRNGKey(0), x, jicfg)
    tidx = bridge.compact_index_from_numpy(
        {f: getattr(jidx, f) for f in jidx._fields}, device="cpu")
    thost = bridge.host_store_from_numpy(jhost.vectors, jhost.centroids,
                                         device="cpu")
    return (jidx, jhost, jicfg), (tidx, thost,
                                  compact_index.IndexConfig(**ICFG)), x


def _pair(both, slab=SLAB):
    (ji, jh, jc), (ti, th, tc), _ = both
    return JMutableIndex(ji, jh, jc, slab=slab), \
        MutableIndex(ti, th, tc, slab=slab)


def _jax_churn(mut, rng, n_del, n_ins, next_gid):
    drop = rng.choice(mut.live_ids(), size=n_del, replace=False)
    mut.delete(drop)
    src = rng.choice(mut.live_ids(), size=n_ins)
    vecs = mut.vectors[src] + 0.05 * rng.standard_normal(
        (n_ins, mut.dim)).astype(np.float32)
    gids = np.arange(next_gid, next_gid + n_ins)
    mut.insert(gids, vecs)
    return drop, gids


def _assert_close_to_jax(t, j):
    """The port's mirrors against the JAX package's: ids, tombstones and
    codes bitwise, floats and graphs to the module's tolerances."""
    for f in ("node_ids", "slot_gid", "n_valid", "tomb", "codes", "shift1",
              "shift2", "entry"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      getattr(j, f), err_msg=f)
    loc = np.full((t.capacity, 2), -1, np.int32)
    for g, cs in j.loc.items():
        loc[g] = cs
    np.testing.assert_array_equal(t.loc.numpy(), loc)
    tomb = np.full(t.capacity, -1, np.int32)
    for g, c in j._tomb_cluster.items():
        tomb[g] = c
    np.testing.assert_array_equal(t._tomb_cluster.numpy(), tomb)
    assert t.n_live == j.n_live and sorted(t.dirty) == sorted(j.dirty)
    for f in ("residual_norm", "cos_theta", "alpha", "rho"):
        np.testing.assert_allclose(getattr(t, f).numpy(), getattr(j, f),
                                   rtol=1e-5, err_msg=f)
    tf, jf = t.f_add.numpy().astype(np.int64), j.f_add.astype(np.int64)
    assert (np.abs(tf - jf) <= 2e-5 * np.abs(jf) + 1).all()
    np.testing.assert_array_equal(tf == 2**31 - 1, jf == 2**31 - 1)
    same = (t.neighbors.numpy() == j.neighbors).mean()
    assert same >= 0.98, same
    assert t.footprint() == j.footprint()
    for a, b in zip(t.cluster_bytes(), j.cluster_bytes()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_churn_matches_jax(both, seed):
    """Construction, an update-churn round and compaction from one built
    state: deletes and inserted codes bitwise, floats and graphs within
    the module's tolerances, the same billing."""
    jm, tm = _pair(both)
    _assert_close_to_jax(tm, jm)
    n = len(both[2])
    jd, jg = _jax_churn(jm, np.random.default_rng(seed), 15, 12, n)
    td, tg = _update_churn(tm, np.random.default_rng(seed), 15, 12, n)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tg, jg)
    _assert_close_to_jax(tm, jm)
    scfg = dict(nprobe=2, ef=16, k=5)
    je = jm.to_engine(jengine.SearchConfig(**scfg))
    te = tm.to_engine(engine.SearchConfig(**scfg))
    (_, jpl), (_, tpl) = jpartition(je, 2, mutable=True), \
        partition_index(te, 2, mutable=True)
    np.testing.assert_array_equal(tpl.mem, jpl.mem)
    np.testing.assert_array_equal(tpl.mem_reclaimable, jpl.mem_reclaimable)
    assert tm.compact() == jm.compact()
    _assert_close_to_jax(tm, jm)


@pytest.mark.parametrize("op", [
    "slab", "knn_k", "capacity", "delete_dup", "delete_dead", "insert_dup",
    "insert_live", "insert_capacity", "insert_tomb", "insert_count",
    "insert_dim", "slab_full"])
def test_errors_match_jax_wording(both, op):
    """Every ValueError with the JAX package's message, and nothing
    written before it."""
    (ji, jh, jc), (ti, th, tc), x = both
    n = len(x)

    def make(mod, idx, host, icfg):
        if op == "slab":
            return mod(idx, host, icfg, slab=-1)
        if op == "knn_k":
            return mod(idx, host, dataclasses.replace(icfg, knn_k=10**4))
        if op == "capacity":
            return mod(idx, host, icfg, capacity=n - 1)
        return mod(idx, host, icfg, slab=4 if op == "slab_full" else SLAB)

    def act(m):
        live = m.live_ids()
        vec = (m.vectors[int(live[0])][None])
        if op == "slab_full":
            c = int(np.argmax(np.asarray(m.n_valid)))
            vec = m.vectors[int(m.node_ids[c, 0])][None]
            vecs = np.repeat(np.asarray(vec), 5, 0)
            return m.insert(np.arange(n, n + 5), vecs)
        vec = np.asarray(vec)
        if op == "delete_dup":
            return m.delete([int(live[1]), int(live[1])])
        if op == "delete_dead":
            return m.delete([int(live[1]), 10**6, -3])
        if op == "insert_dup":
            return m.insert([n, n], np.repeat(vec, 2, 0))
        if op == "insert_live":
            return m.insert([n, int(live[5])], np.repeat(vec, 2, 0))
        if op == "insert_capacity":
            return m.insert([n, m.capacity + 2], np.repeat(vec, 2, 0))
        if op == "insert_tomb":
            m.delete([int(live[7])])
            return m.insert([n, int(live[7])], np.repeat(vec, 2, 0))
        if op == "insert_count":
            return m.insert([n], np.repeat(vec, 2, 0))
        if op == "insert_dim":
            return m.insert([n], vec[:, :8])

    msgs = []
    for mod, idx, host, icfg in ((JMutableIndex, ji, jh, jc),
                                 (MutableIndex, ti, th, tc)):
        with pytest.raises(ValueError) as e:
            act(make(mod, idx, host, icfg))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_mutable_tier_after_apply_matches_jax(both):
    """A 2-shard mutable tier, churned and swapped live by apply, against
    the JAX tier over the same churn: ids in >= 99% of slots."""
    jm, tm = _pair(both)
    x = both[2]
    q = query_set(5, x, 128)
    cfg = dict(shards=2, mutable=True, buckets=(8, 16, 32),
               fill_threshold=16, wait_limit_s=1e-3)
    scfg = dict(nprobe=2, ef=16, k=5)
    jt = JTopologyConfig(**cfg).build(jm.to_engine(
        jengine.SearchConfig(**scfg)))
    tt = TopologyConfig(**cfg).build(tm.to_engine(
        engine.SearchConfig(**scfg)))
    for m, churn in ((jm, _jax_churn), (tm, _update_churn)):
        churn(m, np.random.default_rng(9), 30, 20, len(x))
    jt.apply(jm)
    tt.apply(tm)
    same = (tt.run(q).ids == jt.run(q).ids).mean()
    assert same >= 0.99, same
    jm.compact()
    tm.compact()
    jt.apply(jm)
    tt.apply(tm)
    same = (tt.run(q).ids == jt.run(q).ids).mean()
    assert same >= 0.99, same


# ---------------------------------------------------------------------------
# the link in rounds and the encoder's batch invariance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mem_bytes", [8 << 30, 1 << 16])
def test_link_rounds_equal_link_new(mem_bytes):
    """Inserts into clusters taking 0, 1 and many nodes, with backlinks
    both appended and re-pruned (degree 4, so rows are full): the batched
    link equals the one-after-another link_new bit for bit, also when a
    small memory bound splits its distances and re-prunes into chunks."""
    x, _ = clustered_vectors(5, 600, 16, 4)
    icfg = compact_index.IndexConfig(dim=16, n_clusters=4, degree=4,
                                     knn_k=8)
    idx, host = compact_index.build_compact_index(
        torch.Generator().manual_seed(1), torch.from_numpy(x), icfg)
    mut = MutableIndex(idx, host, icfg, slab=16, mem_bytes=mem_bytes)
    sizes = mut.n_valid.numpy()
    rng = np.random.default_rng(0)
    picks = []                      # cluster 0 takes none, 1 one, 2 twelve
    for c, k in ((1, 1), (2, 12), (3, 3)):
        rows = mut.node_ids[c, :sizes[c]].numpy()
        picks.append(rng.choice(rows, k))
    src = np.concatenate(picks)
    vecs = mut.vectors[src].numpy() + 0.01 * rng.standard_normal(
        (len(src), 16)).astype(np.float32)
    before, base = mut.neighbors.clone(), mut.n_valid.clone()
    mut.insert(np.arange(600, 600 + len(src)), vecs)
    count = (mut.n_valid - base).numpy()
    assert count[0] == 0 and count[1] >= 1 and count[2] >= 4
    want = before.clone()
    appended = repruned = 0
    for c in np.nonzero(count)[0]:
        occ = int(mut.n_valid[c])
        sl = mut.slot_gid[c]
        xs = torch.zeros((mut.budget, 16))
        xs[sl >= 0] = mut.vectors[sl[sl >= 0].long()]
        graph.link_new(want[c], xs, occ, range(int(base[c]), occ), r=4,
                       knn_k=8, prune_alpha=icfg.prune_alpha)
        old = before[c, :int(base[c])]
        new = want[c, :int(base[c])]
        changed = (old != new).any(1)
        grew = changed & ((old >= 0).sum(1) < (new >= 0).sum(1))
        appended += int(grew.sum())
        repruned += int((changed & ~grew).sum())
    assert appended and repruned, (appended, repruned)
    assert torch.equal(mut.neighbors, want)


def test_compact_subset_equals_rebuild_batched_differently(base):
    """compact(clusters=subset) encodes one cluster a call (a tiny memory
    bound), rebuild() all six in one: the subset's clusters are the same
    bits, and so is encode_clusters over any grouping."""
    x = base[3]
    mut = _mut(base)
    _update_churn(mut, np.random.default_rng(6), 30, 20, len(x))
    subset = sorted(mut.dirty)[::2]
    mut.mem_bytes = 1
    mut.compact(clusters=subset)
    mut.mem_bytes = 8 << 30
    ridx, _ = mut.rebuild()
    for f in _FIELDS:
        assert torch.equal(getattr(mut, f)[subset], getattr(ridx, f)[subset]), f
    rows = ridx.node_ids
    whole = compact_index.encode_clusters(
        mut.vectors, rows, mut.centroids, mut.rotation, mut.icfg)
    for group in ([0, 3], [5, 1, 4], [2]):
        part = compact_index.encode_clusters(
            mut.vectors, rows[group], mut.centroids[group], mut.rotation,
            mut.icfg, mem_bytes=1)
        for k, v in part.items():
            assert torch.equal(v, whole[k][group]), k


def test_build_cluster_graph_ignores_batch_padding(base):
    """A cluster's graph from a batch padded far past it, beside other
    clusters, equals its graph alone at its own size."""
    idx, host, icfg = base[:3]
    vecs, valid = compact_index._gather(host.vectors, idx.node_ids)
    wide = graph.build_cluster_graph(vecs, valid, r=8, knn_k=16)
    for c in range(idx.n_clusters):
        n = int(valid[c].sum())
        alone = graph.build_cluster_graph(vecs[c:c + 1, :n],
                                          valid[c:c + 1, :n], r=8, knn_k=16)
        assert torch.equal(wide.neighbors[c, :n], alone.neighbors[0])
        assert int(wide.entry[c]) == int(alone.entry[0])


def test_build_cluster_graph_in_knn_blocks_close_to_jax():
    """A cluster wider than graph.KNN_BLOCK takes its kNN in row blocks;
    its graph against the JAX package's, >= 98% of entries equal."""
    from repro.core import graph as jgraph
    import jax.numpy as jnp
    n = graph.KNN_BLOCK + 300
    xs = np.random.default_rng(4).normal(size=(1, n, 8)).astype(np.float32)
    valid = np.ones((1, n), bool)
    valid[0, -40:] = False
    got = graph.build_cluster_graph(torch.from_numpy(xs),
                                    torch.from_numpy(valid), r=6, knn_k=12)
    want = jgraph.build_cluster_graph(jnp.asarray(xs[0]),
                                      jnp.asarray(valid[0]), r=6, knn_k=12)
    same = (got.neighbors[0].numpy() == np.asarray(want.neighbors)).mean()
    assert same >= 0.98, same
    assert int(got.entry[0]) == int(want.entry)


def test_robust_prune_row_matches_jax(rng):
    """The one-row prune against the JAX package's on the same
    candidates, kept order and -1 pad."""
    from repro.core import graph as jgraph
    import jax.numpy as jnp
    xs = rng.normal(size=(40, 8)).astype(np.float32)
    d = ((xs - xs[0]) ** 2).sum(1).astype(np.float32)
    d[0] = np.inf
    order = np.lexsort((np.arange(40), d))[:20].astype(np.int32)
    got = graph._robust_prune_row(torch.from_numpy(order),
                                  torch.from_numpy(d[order]),
                                  torch.from_numpy(xs), 6, 1.2)
    want = jgraph._robust_prune_row(jnp.asarray(order),
                                    jnp.asarray(d[order]), jnp.asarray(xs),
                                    6, 1.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
