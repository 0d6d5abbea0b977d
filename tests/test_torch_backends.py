"""The port's ``exact`` and ``hamming`` ranking backends on the CPU against
the JAX package, on tests/test_torch_engine.py's setup (the JAX-built
index carried into the port through ``repro_torch.bridge``).

* hamming is integer end to end: its lane codes, ranks, beam search (ids,
  ranks, hops, fed the JAX package's lane codes) and GEMV scan are held
  bitwise;
* exact is float32: the port fixes its own order of sums
  (``ref.exact_rank_ref``, which the kernels follow bit for bit), and JAX
  sums S as a matrix product, so ranks are held to a relative tolerance
  measured here, and searches to >= 99% equal id slots with recall within
  0.01;
* the estimators of ``core/rabitq.py`` against the JAX package's, the
  registry, a backend registered from outside, and the base class's GEMV
  scan on float ranks (which truncated them to integers before).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backends as jbackends  # noqa: E402
from repro.core import beam_search as jbeam  # noqa: E402
from repro.core import rabitq as jrabitq  # noqa: E402
from repro_torch.core import backends as tbackends  # noqa: E402
from repro_torch.core import beam_search as tbeam  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import rabitq as trabitq  # noqa: E402
from test_torch_engine import (  # noqa: E402,F401
    DIM, NQ, SCFG, _engines, _jax_lanes, _one_torch_thread, _recall, built,
    corpus)

INT_MAX = 2**31 - 1
# |port - JAX| of an exact rank, relative to the sum of its terms' sizes
# rn^2 + qn^2 + |2 rn qn est|: S is summed in another order (the port's
# ascending half bytes, JAX's matrix product), a few float32 ulps of S;
# measured at most 1.43e-7 on this setup (float32's unit roundoff is
# 6e-8), held here with a margin of 7x
EXACT_RTOL = 1e-6


def _rotation(rng, dim):
    q, r = np.linalg.qr(rng.standard_normal((dim, dim)))
    return (q * np.sign(np.diag(r))[None, :]).astype(np.float32)


def test_available_backends_match_jax():
    assert tbackends.available_backends() == jbackends.available_backends()
    for name in ("mulfree", "exact", "hamming"):
        b = tbackends.get_backend(name)
        assert isinstance(b, tbackends.KernelBackend) and b.name == name
    assert tbackends.get_backend("exact").pad_rank == float(
        jbackends.get_backend("exact").pad_rank)


@pytest.mark.parametrize("dim", [30, 32, 64])
def test_sign_code_bitwise_vs_jax(dim):
    """The hamming lane payload: the packed sign code of the rotated unit
    query residual, padded bits zero, equal bit for bit on one rotation."""
    rng = np.random.default_rng(dim)
    q = rng.standard_normal((24, dim)).astype(np.float32)
    c = rng.standard_normal((24, dim)).astype(np.float32)
    rot = _rotation(rng, dim)
    want = np.asarray(jax.vmap(lambda a, b: jrabitq.sign_code(
        a, b, jnp.asarray(rot), dim=dim))(q, c))
    got = trabitq.sign_code(torch.from_numpy(q), torch.from_numpy(c),
                            torch.from_numpy(rot), dim=dim)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [30, 32])
def test_estimators_close_to_jax(dim):
    """binary_dot, estimate_inner and estimate_sqdist on the JAX package's
    codes and query LUT: float32 products and sums in another order, so
    within 1e-5 relative (2e-6 absolute for S and the inner product)."""
    rng = np.random.default_rng(7 + dim)
    x = rng.standard_normal((200, dim)).astype(np.float32)
    c = rng.standard_normal(dim).astype(np.float32)
    qv = rng.standard_normal(dim).astype(np.float32)
    rot = jnp.asarray(_rotation(rng, dim))
    codes = jrabitq.encode(jnp.asarray(x), jnp.asarray(c), rot)
    qlut = jrabitq.prepare_query(jnp.asarray(qv), jnp.asarray(c), rot)
    pad = (-dim) % 8
    tcodes = trabitq.RabitQCodes(*(torch.from_numpy(np.array(a)) for a in (
        codes.packed, codes.residual_norm, codes.cos_theta)), dim)
    tq = trabitq.QueryLUT(
        torch.from_numpy(np.pad(np.array(qlut.lut), (0, pad))),
        torch.from_numpy(np.array(qlut.sum_lut)),
        torch.from_numpy(np.array(qlut.query_norm)))
    np.testing.assert_allclose(
        trabitq.binary_dot(tcodes.packed, tq.lut, dim).numpy(),
        np.asarray(jrabitq.binary_dot(codes.packed, qlut.lut, dim)),
        rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(
        trabitq.estimate_inner(tcodes, tq).numpy(),
        np.asarray(jrabitq.estimate_inner(codes, qlut)), rtol=1e-5,
        atol=2e-6)
    np.testing.assert_allclose(
        trabitq.estimate_sqdist(tcodes, tq).numpy(),
        np.asarray(jrabitq.estimate_sqdist(codes, qlut)), rtol=1e-5,
        atol=1e-5)


def _port_lanes(te, q, shard, per, lane_cl):
    """The port's own lanes for the (query, local cluster) pairs of
    ``_jax_lanes``: flat cluster ids and the backend's lane tensors."""
    fc = torch.from_numpy(lane_cl + shard * per)
    lane_q = np.repeat(np.arange(NQ), per)
    flat = te.placed.flat()
    lanes = te.backend.prepare_lanes(
        torch.from_numpy(np.asarray(q))[lane_q], flat.centroids[fc],
        te.index.rotation, flat.arrays, fc, DIM)
    return flat, fc, lanes


def _jax_run(je, view, lane_cl, lanes, scan):
    cfg = jbackends.LaneConfig(ef=SCFG["ef"], max_iters=64, dim=DIM)
    fn = jbeam.full_scan_lane if scan == "gemv" else jbeam.beam_search_lane
    return jax.vmap(lambda c, ln: fn(view, c, ln, backend=je.backend,
                                     cfg=cfg))(jnp.asarray(lane_cl), lanes)


def _port_run(te, flat, fc, lanes, scan):
    cfg = tbackends.LaneConfig(ef=SCFG["ef"], max_iters=64, dim=DIM)
    fn = tbeam.full_scan_lane if scan == "gemv" else tbeam.beam_search_lane
    return fn(flat, fc, lanes, backend=te.backend, cfg=cfg)


@pytest.mark.parametrize("shard", [0, 1])
def test_hamming_lanes_and_ranks_bitwise(built, corpus, shard):
    """The port's lane codes equal the JAX package's, and so do the ranks
    of every node of every lane's cluster (``rank_cluster``) and of a
    gathered id set with -1 pads (``rank_ids``)."""
    _, q, _ = corpus
    je, te = _engines(built, mode="hamming")
    view, lane_cl, jlanes = _jax_lanes(je, q, shard)
    flat, fc, lanes = _port_lanes(te, q, shard, je.place.per_shard, lane_cl)
    np.testing.assert_array_equal(lanes.qcode.numpy(),
                                  np.asarray(jlanes.qcode))
    want = jax.vmap(lambda c, ln: je.backend.rank_cluster(view, c, ln, DIM))(
        jnp.asarray(lane_cl), jlanes)
    got = te.backend.rank_cluster(flat, fc, lanes, DIM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = np.random.default_rng(shard).integers(
        -1, te.index.budget, (len(lane_cl), 9)).astype(np.int32)
    want = jax.vmap(lambda c, i, ln: je.backend.rank_ids(view, c, i, ln,
                                                         DIM))(
        jnp.asarray(lane_cl), jnp.asarray(ids), jlanes)
    got = te.backend.rank_ids(flat, fc, torch.from_numpy(ids), lanes, DIM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[ids < 0] == INT_MAX).all()


@pytest.mark.parametrize("scan", ["beam", "gemv"])
@pytest.mark.parametrize("shard", [0, 1])
def test_hamming_search_bitwise_given_jax_lanes(built, corpus, scan, shard):
    """Fed the JAX package's lane codes, the beam search (ids, ranks, hops)
    and the GEMV scan (ids, ranks) of every lane equal the vmapped per-lane
    JAX loop bitwise."""
    _, q, _ = corpus
    je, te = _engines(built, mode="hamming", scan=scan)
    view, lane_cl, jlanes = _jax_lanes(je, q, shard)
    want = _jax_run(je, view, lane_cl, jlanes, scan)
    flat, fc, _ = _port_lanes(te, q, shard, je.place.per_shard, lane_cl)
    lanes = tbackends.HammingLanes(torch.from_numpy(np.array(jlanes.qcode)))
    got = _port_run(te, flat, fc, lanes, scan)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))
    np.testing.assert_array_equal(got.hops.numpy(), np.asarray(want.hops))


def _exact_terms(te, flat, fc, lanes):
    """rn^2 + qn^2 + |2 rn qn est| of every (lane, node): the scale the
    exact rank's rounding is relative to."""
    m = flat.codes.shape[-2]
    rows = fc[:, None] * m + torch.arange(m)
    a = flat.arrays
    rn = a.residual_norm.reshape(-1)[rows].double()
    qn = lanes.query_norm[:, None].double()
    codes = trabitq.RabitQCodes(flat.codes[fc], a.residual_norm[fc],
                                a.cos_theta[fc], DIM)
    est = trabitq.estimate_inner(codes, trabitq.QueryLUT(
        lanes.lut, lanes.sum_lut, lanes.query_norm)).double()
    return rn * rn + qn * qn + (2 * rn * qn * est).abs()


@pytest.mark.parametrize("shard", [0, 1])
def test_exact_lanes_and_ranks_close_to_jax(built, corpus, shard):
    """The port's float LUTs within 1e-6 relative of the JAX package's;
    fed JAX's LUTs, every rank within EXACT_RTOL of its terms' scale of
    JAX's; -1 ids rank F32_MAX."""
    _, q, _ = corpus
    je, te = _engines(built, mode="exact")
    view, lane_cl, jlanes = _jax_lanes(je, q, shard)
    flat, fc, lanes = _port_lanes(te, q, shard, je.place.per_shard, lane_cl)
    for name in ("lut", "sum_lut", "query_norm"):
        np.testing.assert_allclose(getattr(lanes, name).numpy(),
                                   np.asarray(getattr(jlanes, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    jl = tbackends.ExactLanes(*(torch.from_numpy(np.array(getattr(jlanes, f)))
                                for f in tbackends.ExactLanes._fields))
    want = np.asarray(jax.vmap(lambda c, ln: je.backend.rank_cluster(
        view, c, ln, DIM))(jnp.asarray(lane_cl), jlanes)).astype(np.float64)
    got = te.backend.rank_cluster(flat, fc, jl, DIM)
    assert got.dtype == torch.float32
    scale = _exact_terms(te, flat, fc, jl).numpy()
    rel = np.abs(got.numpy().astype(np.float64) - want) / scale
    assert rel.max() <= EXACT_RTOL, rel.max()
    ids = np.full((len(lane_cl), 3), -1, np.int32)
    assert (te.backend.rank_ids(flat, fc, torch.from_numpy(ids), jl,
                                DIM).numpy() == np.finfo(np.float32).max
            ).all()


@pytest.mark.parametrize("scan", ["beam", "gemv"])
def test_exact_search_close_to_jax_given_jax_lanes(built, corpus, scan):
    """Fed the JAX package's float LUTs, the lanes' beam searches and GEMV
    scans over both shards agree with JAX's in >= 99% of id slots (a rank
    an ulp away can reorder two near-tied nodes), and where the ids agree
    the ranks are within EXACT_RTOL of their terms' scale."""
    _, q, _ = corpus
    je, te = _engines(built, mode="exact", scan=scan)
    same = total = 0
    for shard in (0, 1):
        view, lane_cl, jlanes = _jax_lanes(je, q, shard)
        want = _jax_run(je, view, lane_cl, jlanes, scan)
        flat, fc, _ = _port_lanes(te, q, shard, je.place.per_shard, lane_cl)
        jl = tbackends.ExactLanes(*(torch.from_numpy(
            np.array(getattr(jlanes, f)))
            for f in tbackends.ExactLanes._fields))
        got = _port_run(te, flat, fc, jl, scan)
        eq = got.ids.numpy() == np.asarray(want.ids)
        same += int(eq.sum())
        total += eq.size
        scale = torch.gather(_exact_terms(te, flat, fc, jl), 1,
                             got.ids.long().clamp(min=0)).numpy()
        diff = np.abs(got.rank.numpy().astype(np.float64)
                      - np.asarray(want.rank).astype(np.float64))
        real = eq & (got.ids.numpy() >= 0)
        assert (diff[real] <= EXACT_RTOL * scale[real]).all()
        assert (diff[eq & ~real] == 0).all()
    assert same / total >= 0.99, same / total


@pytest.mark.parametrize("mode", ["exact", "hamming"])
@pytest.mark.parametrize("scan", ["beam", "gemv"])
def test_engine_search_close_to_jax(built, corpus, mode, scan):
    """PIMCQGEngine.search of each backend running on its own (the port's
    lanes, searches and rerank): >= 99% equal id slots and recall within
    0.01 of the JAX engine's."""
    _, q, gt = corpus
    je, te = _engines(built, mode=mode, scan=scan)
    jids = np.asarray(je.search(q)[0].ids)
    tids = te.search(q)[0].ids.numpy()
    assert (tids == jids).mean() >= 0.99
    assert abs(_recall(tids, gt) - _recall(jids, gt)) <= 0.01


def test_user_registered_backend_runs(built, corpus):
    """A backend registered from outside that only ranks (no kernel
    operands) composes with the engine through the base class's plain loop
    and rank table, as tests/test_backends.py's does: doubling every
    hamming rank keeps the order, so the ids equal hamming's."""
    _, q, _ = corpus
    ham = tbackends.get_backend("hamming")

    class ScaledHamming(tbackends.RankingBackend):
        name = "hamming-x2"
        rank_dtype = torch.int32
        pad_rank = INT_MAX
        index_arrays = staticmethod(ham.index_arrays)
        prepare_lanes = staticmethod(ham.prepare_lanes)

        def rank_ids(self, shard, cl, ids, lanes, dim):
            r = ham.rank_ids(shard, cl, ids, lanes, dim)
            return torch.where(ids >= 0, 2 * r, INT_MAX)

        def rank_cluster(self, shard, cl, lanes, dim):
            return 2 * ham.rank_cluster(shard, cl, lanes, dim)

    tbackends.register_backend(ScaledHamming())
    try:
        assert "hamming-x2" in tbackends.available_backends()
        for scan in ("beam", "gemv"):
            te = _engines(built, mode="hamming", scan=scan)[1]
            x2 = tengine.PIMCQGEngine(
                te.index, te.host, te.place, te.icfg,
                dataclasses.replace(te.scfg, mode="hamming-x2"), device="cpu")
            assert isinstance(x2.backend, ScaledHamming)
            assert torch.equal(x2.search(q)[0].ids, te.search(q)[0].ids)
    finally:
        tbackends._REGISTRY.pop("hamming-x2", None)


class _FloatRanks(tbackends.RankingBackend):
    """A backend whose rank_cluster returns a fixed float32 table."""
    name = "float-table"
    rank_dtype = torch.float32
    pad_rank = float(np.finfo(np.float32).max)

    def __init__(self, table):
        self.table = table

    def rank_cluster(self, shard, cl, lanes, dim):
        return self.table[cl]


def test_base_scan_cluster_orders_float_ranks():
    """The base class's GEMV scan on float32 ranks gives JAX's
    ``full_scan_lane`` order (``lax.top_k`` of the negated ranks): ascending
    by value, ties to the lower node, -0.0 before +0.0, NaN last, nodes at
    n_valid or beyond ranking F32_MAX; the ranks come out as floats. (It
    truncated every rank to an integer before, so 0.25 and 0.75 tied.)"""
    nan = float("nan")
    table = torch.tensor([[0.75, 0.25, -0.5, 0.25, 2.5, nan, 0.1],
                          [0.0, -0.0, 1.0, nan, 1e-3, -1e30, 0.5],
                          [3.0, 2.0, 1.0, 0.0, -1.0, -2.0, -3.0]],
                         dtype=torch.float32)
    n_valid = torch.tensor([5, 7, 0], dtype=torch.int32)
    shard = type("Shard", (), dict(codes=torch.zeros((3, 7, 1),
                                                     dtype=torch.uint8),
                                   n_valid=n_valid))()
    cl = torch.arange(3)
    backend = _FloatRanks(table)
    ids, ranks = backend.scan_cluster(shard, cl, None, 8, 6,
                                      torch.ones(3, dtype=torch.bool))
    masked = jnp.where(jnp.arange(7)[None] < jnp.asarray(n_valid)[:, None],
                       jnp.asarray(table.numpy()), backend.pad_rank)
    neg, want = jax.lax.top_k(-masked, 6)
    assert ranks.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ranks.numpy().view(np.int32),
                                  np.asarray(-neg).view(np.int32))
    assert ids[0].tolist()[:3] == [2, 1, 3]          # 0.25 twice, in order
    assert ids[1].tolist()[:3] == [5, 1, 0]          # -0.0 before +0.0
