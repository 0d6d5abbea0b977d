"""The port's search step on a ('data', 'model') mesh
(``repro_torch.launch.anns_step``) on the CPU, against the JAX package's
``launch/anns_step.py``.

The JAX runs come from one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: the JAX engine's
index (2,000 x 32, 8 clusters) placed round-robin over 2 shards for each
backend, the one-process step (beam and gemv; mulfree, exact and hamming;
with and without the ``n_valid`` mask), its lane tables, the 2 x 2 step
with ``owner_rerank=True``, and the block layout of ``NamedSharding.
devices_indices_map`` on a 2 x 2 and a 2 x 2 x 1 mesh. The port searches
the same placed index (``bridge.placed_index_from_numpy``).

Bounds against JAX: lane tables, and for mulfree and hamming hops and
dropped lanes, bit for bit; ids in >= 99% of slots and distances within
rtol 1e-5 plus 1e-6 of 4 max |q|^2 where the ids agree
(tests/test_torch_mesh.py's bounds: the port sums (q - c)^2, the JAX
package's plain rerank q2 + c2 - 2 q.c). The port's 2 x 2 step (4 spawned
gloo ranks) against its one-process step: ids, distances and hops bit for
bit.

One spawn serves every multi-process check (the 2 x 2 steps, ``elastic``
on a 2 x 2 mesh, ``sharded_rerank``'s edges), under the group's timeout
and a join deadline. This module imports no JAX at its top: the spawned
ranks import it.
"""

import json
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import rerank as trerank  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.launch import anns_step as tstep  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("mulfree", "exact", "hamming")
SCANS = ("beam", "gemv")
N_VALID = 11                 # the masked step's real queries, of 16
TIMEOUT_S = 60.0             # a collective that waits longer fails a rank
JOIN_S = 180.0               # the ranks are killed after this
# the mesh steps of the spawned ranks: (scan, mode, masked)
MESH_RUNS = (("beam", "mulfree", False), ("gemv", "mulfree", False),
             ("beam", "mulfree", True), ("beam", "hamming", False))
# (shape, spec) pairs placed on the 2 x 2 ('data', 'model') mesh
LAYOUTS = (((8, 6), ("data", "model")), ((8, 6), ("model", None)),
           ((8, 6), (("data", "model"), None)), ((8, 6), (None, "data")),
           ((7, 6), ("data", None)), ((4, 2, 6), (None, ("data", "model"))))
LAYOUTS3 = (((8, 4), (("pod", "data"), None)), ((8, 4), ("pod", "data")),
            ((8, 4), ("data", "model")))

JAX_RUN = r"""
import json, sys, types
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import backends, compact_index, engine, ivf
from repro.distributed import sharding as jsharding
from repro.launch import anns_step
from repro.data.synthetic import clustered_vectors, query_set

layouts, layouts3 = json.loads(sys.argv[2]), json.loads(sys.argv[3])
x, _ = clustered_vectors(3, 2000, 32, 8)
q = query_set(3, x, 16)
icfg = compact_index.IndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16)
eng = engine.PIMCQGEngine.build(jax.random.PRNGKey(0), x, icfg,
                                engine.SearchConfig(nprobe=2, ef=16, k=5),
                                n_shards=2)
s = anns_step.AnnsScale(n=2000, dim=32, n_clusters=8,
                        budget=int(eng.index.budget), degree=8, nprobe=2,
                        ef=16, k=5, queries=16, max_iters=64)
out = {"queries": q, "vectors": np.asarray(eng.host.vectors),
       "centroids": np.asarray(eng.index.centroids),
       "rotation": np.asarray(eng.index.rotation),
       "budget": np.asarray(s.budget)}
pl = types.SimpleNamespace(order=np.arange(8).reshape(4, 2).T.reshape(-1),
                           n_shards=2, per_shard=4)
probe, _ = ivf.cluster_filter(jnp.asarray(q), eng.index.centroids, nprobe=2)
so = jnp.arange(8, dtype=jnp.int32)
cap = int(np.ceil(16 * 2 / 2 * 2.0))
for masked in (False, True):
    valid = None if not masked else jnp.arange(16) < """ + str(N_VALID) + r"""
    lq, lc, inv, dr = engine.route_lanes(probe, so % 2, so // 2, valid,
                                         n_shards=2, capacity=cap)
    for name, v in (("lane_q", lq), ("lane_cl", lc), ("inv", inv)):
        out[f"lanes.{int(masked)}.{name}"] = np.asarray(v)
for mode in ("mulfree", "exact", "hamming"):
    placed = engine._place(eng.index, pl, backends.get_backend(mode))
    for f in ("centroids", "codes", "neighbors", "entry", "n_valid",
              "node_ids"):
        out[f"{mode}.placed.{f}"] = np.asarray(getattr(placed, f))
    for f in (x.name for x in __import__("dataclasses").fields(
            placed.arrays)):
        out[f"{mode}.arrays.{f}"] = np.asarray(getattr(placed.arrays, f))
    for scan in ("beam", "gemv"):
        fn = jax.jit(anns_step.build_search_step(s, 2, scan=scan, mode=mode))
        for masked in (False, True):
            extra = (jnp.int32(""" + str(N_VALID) + r"""),) if masked else ()
            res, hops, dropped = fn(placed, eng.index.centroids,
                                    eng.index.rotation, eng.host.vectors,
                                    jnp.asarray(q), *extra)
            key = f"{mode}.{scan}.{int(masked)}."
            out[key + "ids"] = np.asarray(res.ids)
            out[key + "dists"] = np.asarray(res.dists)
            out[key + "hops"] = np.asarray(hops)
            out[key + "dropped"] = np.asarray(dropped)
mesh = jax.make_mesh((2, 2), ("data", "model"))
for scan, mode, masked in json.loads(sys.argv[4]):
    placed = engine._place(eng.index, pl, backends.get_backend(mode))
    fn = jax.jit(anns_step.build_search_step(s, 2, scan=scan, mesh=mesh,
                                             owner_rerank=True, mode=mode))
    extra = (jnp.int32(""" + str(N_VALID) + r"""),) if masked else ()
    with mesh:
        res, hops, dropped = fn(placed, eng.index.centroids,
                                eng.index.rotation, eng.host.vectors,
                                jnp.asarray(q), *extra)
    key = f"mesh.{mode}.{scan}.{int(masked)}."
    out[key + "ids"] = np.asarray(res.ids)
    out[key + "dists"] = np.asarray(res.dists)
    out[key + "hops"] = np.asarray(hops)
for tag, m, lays in (("2x2", mesh, layouts),
                     ("2x2x1", jax.make_mesh((2, 2, 1),
                                             ("pod", "data", "model")),
                      layouts3)):
    for i, (shape, spec) in enumerate(lays):
        spec = jsharding.resolve_spec(m, P(*[
            tuple(e) if isinstance(e, list) else e for e in spec]), shape)
        idx = NamedSharding(m, spec).devices_indices_map(tuple(shape))
        out[f"layout.{tag}.{i}"] = np.asarray(
            [[(sl.start or 0, shape[d] if sl.stop is None else sl.stop)
              for d, sl in enumerate(idx[dev])] for dev in m.devices.flat])
np.savez(sys.argv[1], **out)
"""


def _scale(ref) -> tstep.AnnsScale:
    return tstep.AnnsScale(n=2000, dim=32, n_clusters=8,
                           budget=int(ref["budget"]), degree=8, nprobe=2,
                           ef=16, k=5, queries=16, max_iters=64)


def _placed(ref, mode):
    pre, arr = f"{mode}.placed.", f"{mode}.arrays."
    return bridge.placed_index_from_numpy(
        {f[len(pre):]: ref[f] for f in ref.files if f.startswith(pre)},
        {f[len(arr):]: ref[f] for f in ref.files if f.startswith(arr)},
        mode, device="cpu")


def _host(ref):
    return (torch.from_numpy(ref["centroids"].copy()),
            torch.from_numpy(ref["rotation"].copy()),
            torch.from_numpy(ref["vectors"].copy()))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# ranks: one spawn of 4 for every multi-process check
# ---------------------------------------------------------------------------

def _place_round(mesh, layouts, rank: int) -> dict:
    """place / replace_mesh / reshard_like of the ``layouts`` leaves on
    ``mesh``: each rank's block is ``block_slices``' of the whole leaf
    (held against JAX's map in the test), the whole leaf comes back
    through ``full_tensor``; the round trip through a second mesh of the
    same axes; reshard_like in place. Returns (the leaves, their specs,
    the placed tree)."""
    full = {f"l{i}": torch.arange(int(np.prod(shape)),
                                  dtype=torch.float32).reshape(shape)
            for i, (shape, _) in enumerate(layouts)}
    specs = {f"l{i}": sharding.P(*spec) for i, (_, spec) in
             enumerate(layouts)}
    placed = elastic.place(full if rank == 0 else None,
                           specs if rank == 0 else None, mesh)
    coord = mesh.get_coordinate()
    for k, x in full.items():
        want = x[elastic.block_slices(x.shape, placed[k].placements,
                                      mesh.shape, coord)]
        assert torch.equal(placed[k].to_local(), want), k
        assert torch.equal(placed[k].full_tensor(), x), k
    other = lmesh.make_mesh(tuple(mesh.shape), mesh.mesh_dim_names,
                            device="cpu")
    again = elastic.replace_mesh(placed, specs if rank == 0 else None,
                                 other)
    for k, x in full.items():
        assert torch.equal(again[k].full_tensor(), x), k
    new = {k: v + 1 for k, v in full.items()}
    swapped = elastic.reshard_like(placed, new)
    for k, x in new.items():
        assert swapped[k] is placed[k]
        assert torch.equal(placed[k].full_tensor(), x), k
    return full, specs, placed


def _elastic_round(mesh, rank: int) -> dict:
    """``_place_round`` on the 2 x 2 mesh and on a (2, 2, 1) ('pod',
    'data', 'model') one; on the 2 x 2 mesh also a ``shardings_tree``
    tree placed, and a dim split out of the mesh's axis order refused."""
    _place_round(lmesh.make_mesh((2, 2, 1), ("pod", "data", "model"),
                                 device="cpu"), LAYOUTS3, rank)
    full, specs, placed = _place_round(mesh, LAYOUTS, rank)
    # the sharding tree elastic consumes: the same blocks from NamedShardings
    sh = sharding.shardings_tree(mesh, full, specs)
    via = elastic.place(full if rank == 0 else None,
                        sh if rank == 0 else None, mesh)
    for k, x in full.items():
        assert via[k].placements == placed[k].placements, k
        assert torch.equal(via[k].full_tensor(), x), k
    try:
        elastic.place(full if rank == 0 else None,
                      {k: sharding.P(("model", "data")) for k in full}
                      if rank == 0 else None, mesh)
    except NotImplementedError as e:
        return {"out_of_order": str(e)}
    raise AssertionError("a dim split out of the mesh's order was placed")


def _rerank_edges(mesh, rank: int) -> dict:
    """sharded_rerank on hand-made candidates (ids < 0, duplicates, the
    last id, owned by the last data rank) against the plain rerank over
    every vector, bit for bit; and the indivisible ValueError."""
    g = torch.Generator().manual_seed(5)
    n, d = 40, 8
    vectors = torch.randn(n, d, generator=g)
    q = torch.randn(3, d, generator=g)
    cand = torch.tensor([[5, -1, 5, 39, 20, 21, 39, 0],
                         [-1, -1, -1, -1, -1, -1, -1, -1],
                         [39, 38, 19, 20, 1, 1, -1, 7]], dtype=torch.int32)
    i = mesh.get_coordinate()[0]
    got = tstep.sharded_rerank(q, cand, vectors[i * 20:(i + 1) * 20], mesh,
                               n_total=n, k=8)
    want = trerank.rerank(q, cand, vectors, k=8)
    assert torch.equal(got.ids, want.ids), (got.ids, want.ids)
    assert torch.equal(got.dists.view(torch.int32),
                       want.dists.view(torch.int32))
    assert set(got.ids[0].tolist()) == {5, 39, 20, 21, 0, -1}
    assert set(got.ids[2].tolist()) == {39, 38, 19, 20, 1, 7, -1}
    assert (got.ids[1] == -1).all() and torch.isinf(got.dists[1]).all()
    notes = {}
    try:
        tstep.sharded_rerank(q, cand, vectors[:20], mesh, n_total=41, k=5)
    except ValueError as e:
        notes["indivisible"] = str(e)
    return notes


def _anns_rank(rank: int, world: int, init: str, ref_path: str,
               out: str) -> None:
    out = pathlib.Path(out)
    lmesh.init_shard_group(rank, world, init_method=init, device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        mesh = lmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
        notes = {"elastic": _elastic_round(mesh, rank),
                 "rerank": _rerank_edges(mesh, rank)}
        ref = np.load(ref_path)
        s = _scale(ref)
        res = {}
        for scan, mode, masked in MESH_RUNS:
            origin = rank == 0
            centroids, rotation, vectors = _host(ref)
            local = tstep.place_step_inputs(
                mesh, _placed(ref, mode) if origin else None,
                vectors if origin else None, centroids if origin else None,
                rotation if origin else None, device="cpu")
            step = tstep.build_search_step(s, 2, scan, mesh,
                                           owner_rerank=True, mode=mode)
            q = torch.from_numpy(ref["queries"].copy()) if origin else None
            got, hops, dropped = step(*local, q,
                                      N_VALID if masked else None)
            key = f"{mode}.{scan}.{int(masked)}."
            res[key + "ids"] = got.ids.numpy()
            res[key + "dists"] = got.dists.numpy()
            res[key + "hops"] = hops.numpy()
            res[key + "dropped"] = np.asarray(int(dropped))
            notes[key + "collectives"] = step.collectives.as_dict()
            notes[key + "shapes"] = [list(local[0].codes.shape),
                                     list(local[3].shape)]
        np.savez(out / f"rank{rank}.npz", **res)
        (out / f"rank{rank}.json").write_text(json.dumps(notes))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("jax_step") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    subprocess.run([sys.executable, "-c", JAX_RUN, str(path),
                    json.dumps(LAYOUTS), json.dumps(LAYOUTS3),
                    json.dumps(MESH_RUNS)],
                   env=env, check=True, timeout=JOIN_S, cwd=ROOT)
    return str(path)


@pytest.fixture(scope="module")
def mesh_run(jax_ref, tmp_path_factory):
    """The 4 ranks' results and notes."""
    out = tmp_path_factory.mktemp("anns_mesh")
    ctx = mp.get_context("spawn")
    init = f"file://{out / 'store'}"
    procs = [ctx.Process(target=_anns_rank,
                         args=(r, 4, init, jax_ref, str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    return ([np.load(out / f"rank{r}.npz") for r in range(4)],
            [json.loads((out / f"rank{r}.json").read_text())
             for r in range(4)])


def _one_process(ref, scan, mode, masked):
    centroids, rotation, vectors = _host(ref)
    step = tstep.build_search_step(_scale(ref), 2, scan, mode=mode)
    q = torch.from_numpy(ref["queries"].copy())
    return step, step(_placed(ref, mode), centroids, rotation, vectors, q,
                      N_VALID if masked else None)


# ---------------------------------------------------------------------------
# shapes and accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_specs_match_jax_leaf_for_leaf(mode):
    """array_specs, placed_specs and index_specs at SIFT1B's AnnsScale:
    every leaf's shape and dtype, field by field, against JAX's
    ShapeDtypeStructs; the port's are meta tensors."""
    import dataclasses as dc
    from repro.launch import anns_step as jstep
    jplaced, jhost = jstep.index_specs(jstep.AnnsScale(), 16, mode)
    tplaced, thost = tstep.index_specs(tstep.AnnsScale(), 16, mode)

    def same(t, j, what):
        assert t.device.type == "meta", what
        assert tuple(t.shape) == tuple(j.shape), what
        assert str(t.dtype).split(".")[-1] == str(j.dtype), what
    for f in ("centroids", "codes", "neighbors", "entry", "n_valid",
              "node_ids"):
        same(getattr(tplaced, f), getattr(jplaced, f), f)
    jarr = {f.name: getattr(jplaced.arrays, f.name)
            for f in dc.fields(jplaced.arrays)}
    assert list(tplaced.arrays._fields) == list(jarr)
    for f, j in jarr.items():
        same(getattr(tplaced.arrays, f), j, f)
    for k, j in jhost.items():
        same(thost[k], j, k)
    if mode == "hamming":
        assert tplaced.arrays == ()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_footprint_matches_jax_resolve_spec(multi_pod, mode):
    """footprint on both production shapes against bytes summed from JAX's
    resolve_spec on a stand-in mesh and JAX's index_specs."""
    from repro.distributed import sharding as jsharding
    from repro.launch import anns_step as jstep
    import jax
    shape = lmesh.production_shape(multi_pod=multi_pod)
    sizes = dict(zip(shape.mesh_dim_names, shape.shape))
    stand_in = types.SimpleNamespace(shape=sizes)
    s = jstep.AnnsScale()
    placed, host = jstep.index_specs(s, sizes["model"], mode)
    spec = jstep.placed_index_spec_tree(placed)

    def nbytes(leaf, sp):
        r = jsharding.resolve_spec(stand_in, sp, leaf.shape)
        n = np.dtype(leaf.dtype).itemsize
        for dim, e in zip(leaf.shape, tuple(r) + (None,) * len(leaf.shape)):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        return n
    want_index = sum(nbytes(a, b) for a, b in zip(
        jax.tree.leaves(placed), jax.tree.leaves(
            spec, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))))
    jP = jax.sharding.PartitionSpec
    hspec = dict(vectors=jP(jstep.DP, None), centroids=jP(),
                 rotation=jP(), queries=jP(jstep.DP, None))
    got = tstep.footprint(shape, tstep.AnnsScale(), mode)
    assert got["index"] == want_index
    for k, leaf in host.items():
        assert got[k] == nbytes(leaf, hspec[k]), k
    assert got["total"] == want_index + sum(
        nbytes(leaf, hspec[k]) for k, leaf in host.items())


def test_account_lines_and_production_mesh():
    """--account's lines name both meshes and say the bytes are computed;
    make_production_mesh without 256 ranks raises naming torchrun;
    lower_anns, which raised naming A7 before it was ported, counts the
    step on the production mesh's shape (no processes), its argument
    bytes footprint()'s (tests/test_torch_dryrun.py holds it against the
    JAX package's)."""
    lines = tstep.account_lines()
    assert len(lines) == 2 and all("computed" in x for x in lines)
    assert "'pod': 2" in lines[1] and "10.201 GB of index" in lines[0]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=256"):
        lmesh.make_production_mesh()
    shape = lmesh.production_shape()
    totals, arg_bytes, s = tstep.lower_anns(shape, owner_rerank=True)
    assert arg_bytes == tstep.footprint(shape, s)["total"]
    assert totals.kernels["beam_search"]["launches"] == 1
    assert tstep.model_flops(tstep.AnnsScale()) == pytest.approx(
        4096 * (8 * 32 * 32 * 2.0 * 128 + 8 * 40 * 3.0 * 128))


@pytest.mark.parametrize("tag,mesh_shape,names,layouts", [
    ("2x2", (2, 2), ("data", "model"), LAYOUTS),
    ("2x2x1", (2, 2, 1), ("pod", "data", "model"), LAYOUTS3)])
def test_block_layout_matches_jax(jax_ref, tag, mesh_shape, names, layouts):
    """elastic.block_slices under resolve_spec's placements gives, device
    for device, JAX's NamedSharding.devices_indices_map (a tuple of axes
    split first-axis-outermost)."""
    ref = np.load(jax_ref)
    mesh = lmesh.MeshShape(names, mesh_shape)
    for i, (shape, spec) in enumerate(layouts):
        pl = sharding.resolve_spec(mesh, sharding.P(*[
            tuple(e) if isinstance(e, list) else e for e in spec]), shape)
        want = ref[f"layout.{tag}.{i}"]
        for p in range(int(np.prod(mesh_shape))):
            got = elastic.block_slices(shape, pl, mesh_shape,
                                       np.unravel_index(p, mesh_shape))
            assert [[b.start, b.stop] for b in got] == want[p].tolist(), \
                (spec, p)


# ---------------------------------------------------------------------------
# the one-process step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["all", "n_valid"])
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("mode", MODES)
def test_one_process_step_matches_jax(jax_ref, mode, scan, masked):
    ref = np.load(jax_ref)
    step, (got, hops, dropped) = _one_process(ref, scan, mode, masked)
    q = torch.from_numpy(ref["queries"].copy())
    centroids = torch.from_numpy(ref["centroids"].copy())
    _, lane_q, lane_cl, inv, _ = step.route(q, centroids,
                                            N_VALID if masked else None)
    for name, v in (("lane_q", lane_q), ("lane_cl", lane_cl),
                    ("inv", inv)):
        np.testing.assert_array_equal(
            v.numpy(), ref[f"lanes.{int(masked)}.{name}"])
    key = f"{mode}.{scan}.{int(masked)}."
    if mode != "exact":
        np.testing.assert_array_equal(hops.numpy(), ref[key + "hops"])
        assert int(dropped) == int(ref[key + "dropped"])
    ids = got.ids.numpy()
    same = ids == ref[key + "ids"]
    assert same.mean() >= 0.99, same.mean()
    scale = float(np.max(np.sum(ref["queries"] ** 2, -1))) * 4
    np.testing.assert_allclose(got.dists.numpy()[same],
                               ref[key + "dists"][same], rtol=1e-5,
                               atol=1e-6 * scale)
    if masked:
        assert (ids[N_VALID:] == -1).all()
        assert np.isinf(got.dists.numpy()[N_VALID:]).all()
        assert (ids[:N_VALID] >= 0).all()


def test_step_refusals():
    s = tstep.AnnsScale(n=10, dim=8, n_clusters=6, budget=4, degree=2,
                        nprobe=1, ef=2, k=1, queries=2)
    with pytest.raises(ValueError, match="do not split over 4"):
        tstep.build_search_step(s, 4)
    with pytest.raises(ValueError, match="needs a mesh"):
        tstep.build_search_step(s, 2, owner_rerank=True)
    mesh = lmesh.MeshShape(("shard",), (2,))
    with pytest.raises(ValueError, match="'model' axis"):
        tstep.build_search_step(s, 2, mesh=mesh)


# ---------------------------------------------------------------------------
# the 2 x 2 step on 4 spawned ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", MESH_RUNS, ids=lambda r: "-".join(
    [r[0], r[1]] + (["n_valid"] if r[2] else [])))
def test_mesh_step_bitwise_equals_one_process(jax_ref, mesh_run, run):
    """Every rank returns the one-process step's ids, distances, hops and
    dropped lanes bit for bit; each rank held one model shard of 4
    clusters and 1,000 of the 2,000 vectors."""
    scan, mode, masked = run
    ref = np.load(jax_ref)
    _, (want, hops, dropped) = _one_process(ref, scan, mode, masked)
    results, notes = mesh_run
    key = f"{mode}.{scan}.{int(masked)}."
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[key + "ids"], want.ids.numpy())
        np.testing.assert_array_equal(_bits(res[key + "dists"]),
                                      _bits(want.dists.numpy()))
        np.testing.assert_array_equal(res[key + "hops"], hops.numpy())
        assert int(res[key + "dropped"]) == int(dropped)
        assert notes[r][key + "shapes"] == [[1, 4, int(ref["budget"]), 4],
                                            [1000, 32]]


@pytest.mark.parametrize("run", MESH_RUNS, ids=lambda r: "-".join(
    [r[0], r[1]] + (["n_valid"] if r[2] else [])))
def test_mesh_step_close_to_jax_mesh(jax_ref, mesh_run, run):
    """Against JAX's 2 x 2 step (owner_rerank=True, which sums (q - c)^2
    as the port does): ids in >= 99% of slots, distances within rtol 1e-5
    plus 1e-6 of 4 max |q|^2, hops bit for bit (mulfree, hamming)."""
    scan, mode, masked = run
    ref = np.load(jax_ref)
    res = mesh_run[0][0]
    key, jkey = f"{mode}.{scan}.{int(masked)}.", \
        f"mesh.{mode}.{scan}.{int(masked)}."
    same = res[key + "ids"] == ref[jkey + "ids"]
    assert same.mean() >= 0.99, same.mean()
    scale = float(np.max(np.sum(ref["queries"] ** 2, -1))) * 4
    np.testing.assert_allclose(res[key + "dists"][same],
                               ref[jkey + "dists"][same], rtol=1e-5,
                               atol=1e-6 * scale)
    np.testing.assert_array_equal(res[key + "hops"], ref[jkey + "hops"])


def test_mesh_step_collectives(mesh_run):
    """A step's collectives on every rank: one broadcast of the queries,
    one all_gather of the lanes, one MIN all_reduce over 'data' (none
    during the traversal), with the bytes their shapes give."""
    _, notes = mesh_run
    q_bytes = 16 * 32 * 4
    cap = 32                  # ceil(16 queries x nprobe 2 / 2 shards x 2)
    for n in notes:
        for scan, mode, masked in MESH_RUNS:
            got = n[f"{mode}.{scan}.{int(masked)}.collectives"]
            assert got == {
                "all_gather": {"calls": 1, "bytes": 4 * 1 * (cap // 2) *
                               (16 + 1) * 4},
                "all_reduce_min": {"calls": 1, "bytes": 16 * 2 * 16 * 4},
                "broadcast": {"calls": 1, "bytes": q_bytes}}, got


def test_elastic_on_a_two_axis_mesh(mesh_run):
    """Checked on every rank inside the spawn, on the 2 x 2 mesh and on a
    (2, 2, 1) ('pod', 'data', 'model') one: place gives each rank
    block_slices' block (held against JAX's map above) and the whole leaf
    back through full_tensor; replace_mesh round trip; reshard_like in
    place; on the 2 x 2 mesh a NamedSharding tree places the same blocks
    and a dim split out of the mesh's axis order raises naming A6."""
    _, notes = mesh_run
    for n in notes:
        assert "A6" in n["elastic"]["out_of_order"]


def test_sharded_rerank_edges(mesh_run):
    """Checked on every rank: ids < 0, duplicates and the last id (owned
    by the last data rank) bit for bit against the plain rerank over every
    vector; 41 vectors over 2 data ranks raise ValueError."""
    _, notes = mesh_run
    for n in notes:
        assert "do not split into 2" in n["rerank"]["indivisible"]
