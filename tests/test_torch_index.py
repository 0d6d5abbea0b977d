"""The port's index-side modules on the CPU against the JAX package:
synthetic data, RabitQ encoding, O3 calibration and LUTs, IVF, graphs,
placement, lane routing and footprint math. Integer outputs are compared
bitwise; float outputs to the tolerance stated beside each, with its reason.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compact_index as jci  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import ivf as jivf  # noqa: E402
from repro.core import mulfree as jmulfree  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import rabitq as jrabitq  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import compact_index as tci  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import ivf as tivf  # noqa: E402
from repro_torch.core import mulfree as tmulfree  # noqa: E402
from repro_torch.core import placement as tplacement  # noqa: E402
from repro_torch.core import rabitq as trabitq  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs test files in parallel workers, and
    timing-sensitive tests in other files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    """numpy (possibly a read-only view of a JAX array) -> own tensor."""
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def clusters():
    """Two padded clusters of the test_backends corpus, with a rotation."""
    x, _ = jsyn.clustered_vectors(7, 1500, 32, 8)
    rot = np.asarray(jrabitq.random_rotation(jax.random.PRNGKey(1), 32))
    vecs = np.zeros((2, 200, 32), np.float32)
    valid = np.zeros((2, 200), bool)
    vecs[0, :187], valid[0, :187] = x[:187], True
    vecs[1, :200], valid[1] = x[187:387], True
    cents = vecs.sum(1) / valid.sum(1)[:, None]
    return vecs, valid, cents.astype(np.float32), rot


def test_synthetic_data_matches_jax():
    x, c = tsyn.clustered_vectors(3, 1001, 16, 7)
    jx, jc = jsyn.clustered_vectors(3, 1001, 16, 7)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(c, jc)
    q = tsyn.query_set(3, x, 9)
    np.testing.assert_array_equal(q, jsyn.query_set(3, jx, 9))
    np.testing.assert_array_equal(tsyn.ground_truth(x, q, 5),
                                  jsyn.ground_truth(jx, q, 5))
    # torch path: same neighbours (queries are near distinct points, so
    # there are no distance ties at the top 5)
    gt = tsyn.ground_truth(T(x), T(q), 5)
    np.testing.assert_array_equal(gt.numpy(), jsyn.ground_truth(jx, q, 5))


def test_encode_codes_bitwise_and_factors_close(clusters):
    vecs, valid, cents, rot = clusters
    got = trabitq.encode(T(vecs), T(cents), T(rot), dim=32)
    for b in range(2):
        want = jrabitq.encode(jnp.asarray(vecs[b]), jnp.asarray(cents[b]),
                              jnp.asarray(rot), dim=32)
        # sign bits: a component within float rounding of 0 could flip,
        # but none is, so the codes agree bitwise
        np.testing.assert_array_equal(got.packed[b].numpy(),
                                      np.asarray(want.packed))
        # float32 sums run in another order: rtol 1e-5
        np.testing.assert_allclose(got.residual_norm[b].numpy(),
                                   np.asarray(want.residual_norm), rtol=1e-5)
        np.testing.assert_allclose(got.cos_theta[b].numpy(),
                                   np.asarray(want.cos_theta), rtol=1e-5)


@pytest.mark.parametrize("dim", [32, 29])
def test_pack_unpack_codes_match_jax(rng, dim):
    bits = rng.integers(0, 2, (6, dim + (-dim) % 8)).astype(bool)
    packed = trabitq.pack_codes(T(bits))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jrabitq.pack_codes(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        trabitq.unpack_codes(packed, dim).numpy(),
        np.asarray(jrabitq.unpack_codes(jnp.asarray(packed.numpy()), dim)))


def test_random_rotation_is_orthogonal():
    rot = trabitq.random_rotation(torch.Generator().manual_seed(0), 24)
    np.testing.assert_allclose((rot.T @ rot).numpy(), np.eye(24), atol=1e-5)


def test_calibrate_alpha_shifts_bitwise(rng):
    cos = rng.uniform(0.55, 0.95, (40, 64)).astype(np.float32)
    rn = rng.uniform(0.5, 3.0, (40, 64)).astype(np.float32)
    valid = rng.random((40, 64)) < 0.8
    got = tmulfree.calibrate_alpha(T(cos), T(rn), T(valid))
    for c in range(40):
        want = jmulfree.calibrate_alpha(
            jnp.asarray(cos[c]), jnp.asarray(rn[c]), jnp.asarray(valid[c]))
        assert int(got.shifts.s1[c]) == int(want.shifts.s1)
        assert int(got.shifts.s2[c]) == int(want.shifts.s2)
        # float32 means in another summation order: rtol 1e-5
        np.testing.assert_allclose(float(got.alpha[c]), float(want.alpha),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got.rho[c]), float(want.rho),
                                   rtol=1e-5)


def test_shiftadd_and_fold_node_factor_bitwise(rng):
    t = rng.integers(-2**31, 2**31 - 1, 64, dtype=np.int64).astype(np.int32)
    for s1, s2 in ((2, 31), (1, 5), (3, 3)):
        sh = tmulfree.AlphaShifts(torch.tensor(s1), torch.tensor(s2), None)
        want = jmulfree.shiftadd_apply(
            jnp.asarray(t), jmulfree.AlphaShifts(jnp.int32(s1), jnp.int32(s2),
                                                 jnp.float32(0)))
        np.testing.assert_array_equal(
            tmulfree.shiftadd_apply(T(t), sh).numpy(), np.asarray(want))
    rn = rng.uniform(0, 4, 200).astype(np.float32)
    np.testing.assert_array_equal(
        tmulfree.fold_node_factor(T(rn)).numpy(),
        np.asarray(jmulfree.fold_node_factor(jnp.asarray(rn))))


@pytest.mark.parametrize("dim", [32, 29])
def test_prepare_int_lut_within_one(rng, dim):
    rot = np.asarray(jrabitq.random_rotation(jax.random.PRNGKey(2), dim))
    q = rng.normal(size=(12, dim)).astype(np.float32) * 3
    c = rng.normal(size=(12, dim)).astype(np.float32) * 3
    rho = rng.uniform(0.5, 3, 12).astype(np.float32)
    zero = torch.zeros(12)
    consts = tmulfree.ClusterConstants(zero, T(rho), None)
    lut, sumq = tmulfree.prepare_int_lut(T(q), T(c), T(rot), consts, dim)
    assert lut.shape == (12, dim + (-dim) % 8) and lut.dtype == torch.int32
    for i in range(12):
        jc = jmulfree.ClusterConstants(jnp.float32(0), jnp.float32(rho[i]),
                                       None)
        jl, js = jmulfree.prepare_int_lut(jnp.asarray(q[i]), jnp.asarray(c[i]),
                                          jnp.asarray(rot), jc, dim)
        # lut = round(float): a one-ulp difference in the float moves an
        # entry by at most 1
        assert np.abs(lut[i].numpy() - np.asarray(jl)).max() <= 1
        assert int(sumq[i]) == int(lut[i].sum())


def test_cluster_filter_and_assign_match_jax(rng):
    cents = rng.normal(size=(37, 16)).astype(np.float32) * 3
    q = rng.normal(size=(50, 16)).astype(np.float32) * 3
    cents[5] = cents[9]                    # exact tie: lower index first
    ids, d = tivf.cluster_filter(T(q), T(cents), nprobe=6)
    jids, jd = jivf.cluster_filter(jnp.asarray(q), jnp.asarray(cents),
                                   nprobe=6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(
        tivf.assign(T(q), T(cents)).numpy(),
        np.asarray(jivf.assign(jnp.asarray(q), jnp.asarray(cents))))


@pytest.mark.parametrize("tau,min_probes,ladder", [
    (2.0, 1, ()), (2.0, 2, ()), (2.0, 1, (2, 3)), (1.5, 1, (1, 4, 8))])
def test_adaptive_keep_mask_bitwise(rng, tau, min_probes, ladder):
    d = np.sort(rng.uniform(1, 5, (20, 8)).astype(np.float32), axis=1)
    got = tivf.adaptive_keep_mask(T(d), tau=tau, min_probes=min_probes,
                                  ladder=ladder)
    want = jivf.adaptive_keep_mask(jnp.asarray(d), tau=tau,
                                   min_probes=min_probes, ladder=ladder)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmeans_partitions_the_corpus():
    x, _ = jsyn.clustered_vectors(5, 800, 16, 8)
    km = tivf.kmeans(torch.Generator().manual_seed(0), T(x), 8, iters=6,
                     sample=400)
    assert int(km.sizes.sum()) == 800 and km.centroids.shape == (8, 16)
    np.testing.assert_array_equal(
        km.assignment.numpy(), tivf.assign(T(x), km.centroids).numpy())


def test_build_cluster_graph_close_to_jax(clusters):
    vecs, valid, _, _ = clusters
    got = tgraph.build_cluster_graph(T(vecs), T(valid), r=12, knn_k=24)
    for b in range(2):
        want = jgraph.build_cluster_graph(jnp.asarray(vecs[b]),
                                          jnp.asarray(valid[b]), r=12,
                                          knn_k=24)
        # float near-ties in the kNN (matmul-form distances summed in
        # another order) may swap a candidate: >= 98% equal entries
        same = (got.neighbors[b].numpy() == np.asarray(want.neighbors)).mean()
        assert same >= 0.98, same
        assert int(got.entry[b]) == int(want.entry)
        assert int(got.n_valid[b]) == int(want.n_valid)


def test_greedy_place_and_footprint_match_jax(rng):
    freq = rng.integers(1, 50, 24).astype(np.float64)
    freq[3] = freq[4]                       # tie: stable order
    bpc = rng.integers(100, 1000, 24).astype(np.float64)
    for budget in (None, 4000):
        got = tplacement.greedy_place(freq, bpc, 4, mem_budget=budget)
        want = jplacement.greedy_place(freq, bpc, 4, mem_budget=budget)
        for f in ("order", "shard_of", "local_slot", "load", "mem"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="fits no shard"):
        tplacement.greedy_place(freq, bpc, 4, mem_budget=500, strict=True)
    with pytest.raises(ValueError, match="not divisible"):
        tplacement.greedy_place(freq[:23], bpc[:23], 4)
    assert tci.footprint_report(128, 32, 1000, tombstoned=5, slab=7) == \
        jci.footprint_report(128, 32, 1000, tombstoned=5, slab=7)


@pytest.mark.parametrize("capacity,cap_valid,pad_rows", [
    (10, None, 0),      # roomy, holes only
    (4, None, 0),       # overflow drops
    (6, 3, 2),          # pad queries + the unpadded batch's capacity
])
def test_route_lanes_bitwise(rng, capacity, cap_valid, pad_rows):
    n_shards, n_clusters, q, p = 3, 12, 9, 4
    shard_of = rng.permutation(np.repeat(np.arange(n_shards), 4)).astype(
        np.int32)
    local_slot = np.zeros(n_clusters, np.int32)
    for s in range(n_shards):
        local_slot[shard_of == s] = np.arange(4)
    probe = rng.integers(0, n_clusters, (q, p)).astype(np.int32)
    probe[rng.random((q, p)) < 0.2] = -1     # holes
    valid = np.arange(q) < q - pad_rows
    got = tengine.route_lanes(T(probe), T(shard_of), T(local_slot), T(valid),
                              cap_valid, n_shards=n_shards, capacity=capacity)
    want = jengine.route_lanes(
        jnp.asarray(probe), jnp.asarray(shard_of), jnp.asarray(local_slot),
        jnp.asarray(valid),
        None if cap_valid is None else jnp.int32(cap_valid),
        n_shards=n_shards, capacity=capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_size_batched_graphs_equal_budget_padded(rng):
    """The build pads each graph batch only to its largest cluster; the
    graphs are those of the budget-padded build."""
    x = rng.normal(size=(300, 8)).astype(np.float32)
    sizes = np.array([0, 3, 40, 90, 17], np.int64)
    budget = int(sizes.max())
    node_ids = np.full((5, budget), -1, np.int32)
    perm = rng.permutation(300)
    o = 0
    for c, n in enumerate(sizes):
        node_ids[c, :n] = perm[o:o + n]
        o += n
    cfg = tci.IndexConfig(dim=8, n_clusters=5, degree=6, knn_k=10)
    got = tci._build_graphs(T(x), T(node_ids), sizes, cfg, mem_bytes=1 << 20)
    vecs, valid = tci._gather(T(x), T(node_ids))
    want = tgraph.build_cluster_graph(vecs, valid, r=6, knn_k=10)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
