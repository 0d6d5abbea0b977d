"""The port's mesh execution backend on the CPU: ``exec="mesh"`` over gloo,
one spawned process a shard, against the port's in-process tier on the
bridged index (bitwise: distances in every slot, ids too, since nothing
ties here) and against the JAX package's mesh run. The JAX run comes from
a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(tests/test_execbackend.py's mesh lane, which the default run skips); its
engine's index, placement and queries are bridged into the port, so both
packages search the same index. Tolerance against JAX: ids in >= 99% of
slots (tests/test_torch_sharded.py's bound), equal fanout, unrouted count
and cluster_hits, and distances within rtol 1e-5 plus atol 1e-6 of 4 max
|q|^2 (tests/test_torch_engine.py's bound: the port sums (q - c)^2, the
JAX package q2 + c2 - 2 q.c, whose cancellation costs a few ulps of
q2 + c2).

Also: ``sharding.resolve_spec`` against JAX's, ``ivf.owner_tables_op``
against JAX's, the mesh validations with JAX's wording, ``elastic``'s
place / replace_mesh / reshard_like across ranks, ``warm``, a prebuilt
mesh, ``apply`` on a mutable mesh tier, and ``serve.py --exec mesh``
under torchrun against ``--exec inproc``.

Every multi-process test has its own limit: the group's timeout
(``TIMEOUT_S``) and a join deadline after which the ranks are killed.
Ranks meet through a ``file://`` store under the test's temporary
directory, so parallel test workers never race for a port. This module
imports no JAX at its top: the spawned ranks import it.
"""

import dataclasses
import importlib
import json
import os
import pathlib
import re
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
from repro_torch.core import compact_index as tci  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import ivf  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.execbackend import MeshBackend  # noqa: E402
from repro_torch.core.mutable_index import MutableIndex  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.distributed.straggler import HedgeConfig  # noqa: E402
from repro_torch.core.autoscale import AutoscalePolicy  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCFG = dict(nprobe=2, ef=16, k=5)
ICFG = dict(dim=32, n_clusters=8, degree=8, knn_k=16)
STREAM = dict(buckets=(8, 16), fill_threshold=16, wait_limit_s=1e-3,
              fifo_depth=2)
TIMEOUT_S = 60.0      # a collective that waits longer fails its rank
JOIN_S = 240.0        # the ranks of one test are killed after this

# the JAX package's mesh run on tests/test_execbackend.py's engine, with
# the index, placement and queries it searched
JAX_MESH = r"""
import sys
import numpy as np
import jax
from repro.core import compact_index, engine
from repro.core.topology import TopologyConfig
from repro.data.synthetic import clustered_vectors, query_set

x, _ = clustered_vectors(3, 2000, 32, 8)
q = query_set(3, x, 37)
icfg = compact_index.IndexConfig(dim=32, n_clusters=8, degree=8, knn_k=16)
out = {"queries": q}
for scan in ("beam", "gemv"):
    eng = engine.PIMCQGEngine.build(
        jax.random.PRNGKey(0), x, icfg,
        engine.SearchConfig(nprobe=2, ef=16, k=5, scan=scan), n_shards=2)
    index = {f: np.asarray(getattr(eng.index, f)) for f in eng.index._fields}
    if scan == "beam":
        out.update({"index." + f: v for f, v in index.items()})
        out["host.vectors"] = np.asarray(eng.host.vectors)
        out["host.centroids"] = np.asarray(eng.host.centroids)
        for f in ("order", "shard_of", "local_slot", "load", "mem"):
            out["place." + f] = np.asarray(getattr(eng.place, f))
        out["place.n"] = np.asarray([eng.place.n_shards,
                                     eng.place.per_shard])
    else:
        for f, v in index.items():
            assert np.array_equal(v, out["index." + f]), f
    for parts in (2, 4):
        cfg = TopologyConfig(shards=parts, exec="mesh", buckets=(8, 16),
                             fill_threshold=16, wait_limit_s=1e-3,
                             fifo_depth=2)
        rep = cfg.build(eng).run(q)
        assert rep.exec == "mesh"
        key = f"{scan}.{parts}."
        out[key + "ids"] = rep.ids
        out[key + "dists"] = rep.dists
        out[key + "fanout"] = np.asarray(rep.fanout_mean)
        out[key + "unrouted"] = np.asarray(rep.n_unrouted)
        out[key + "hits"] = rep.cluster_hits
np.savez(sys.argv[1], **out)
"""


# ---------------------------------------------------------------------------
# ranks: spawned processes, each running one of these functions
# ---------------------------------------------------------------------------

def run_ranks(target, world: int, tmp: pathlib.Path, *args,
              join_s: float = JOIN_S) -> None:
    """Spawn ``world`` ranks of ``target(rank, world, init, *args)``, wait
    for them up to ``join_s`` seconds in all, kill any still running, and
    fail unless every rank exited 0."""
    ctx = mp.get_context("spawn")
    init = f"file://{tmp / 'store'}"
    procs = [ctx.Process(target=target, args=(r, world, init, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {join_s} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"


def _bridged(ref, scan: str) -> tengine.PIMCQGEngine:
    """The port's engine over the JAX run's index, placement included."""
    index = {f[len("index."):]: ref[f] for f in ref.files
             if f.startswith("index.")}
    n_shards, per_shard = (int(v) for v in ref["place.n"])
    return tengine.PIMCQGEngine(
        bridge.compact_index_from_numpy(index, device="cpu"),
        bridge.host_store_from_numpy(ref["host.vectors"],
                                     ref["host.centroids"], device="cpu"),
        bridge.placement_from_numpy(
            ref["place.order"], ref["place.shard_of"],
            ref["place.local_slot"], n_shards, per_shard,
            ref["place.load"], ref["place.mem"]),
        tci.IndexConfig(**ICFG),
        tengine.SearchConfig(**SCFG, scan=scan), device="cpu")


def _report(rep) -> dict:
    return dict(ids=rep.ids, dists=rep.dists,
                fanout=np.asarray(rep.fanout_mean),
                unrouted=np.asarray(rep.n_unrouted), hits=rep.cluster_hits,
                queries=np.asarray([d["queries"] for d in rep.per_engine]),
                exec=np.asarray(rep.exec))


def _churn(mut, rng, n_del, n_ins, next_gid):
    """tests/test_torch_mutable.py's churn: tombstone n_del live rows,
    insert n_ins perturbed copies of survivors under fresh ids."""
    live = mut.live_ids().numpy()
    mut.delete(rng.choice(live, size=n_del, replace=False))
    src = rng.choice(mut.live_ids().numpy(), size=n_ins)
    vecs = mut.vectors[src].numpy() + 0.05 * rng.standard_normal(
        (n_ins, mut.dim)).astype(np.float32)
    mut.insert(np.arange(next_gid, next_gid + n_ins), vecs)


def _origin(mesh, world: int, ref_path: str, out: pathlib.Path) -> None:
    """Rank 0: every mesh tier of the module, beside its in-process twin,
    results saved to ``out``."""
    ref = np.load(ref_path)
    q = ref["queries"]
    res, notes = {}, {}
    for scan in ("beam", "gemv"):
        eng = _bridged(ref, scan)
        cfg = topology.TopologyConfig(shards=world, **STREAM)
        for k, v in _report(cfg.build(eng).run(q)).items():
            res[f"{scan}.inproc.{k}"] = v
        single, _ = eng.search(q)
        res[f"{scan}.single.ids"] = single.ids.numpy()
        res[f"{scan}.single.dists"] = single.dists.numpy()
        mb = MeshBackend(mesh=mesh)              # a prebuilt mesh
        topo = dataclasses.replace(cfg, exec=mb).build(eng)
        notes[f"{scan}.warm"] = topo.warm()
        mb.rank_stats(reset=True)
        for k, v in _report(topo.run(q)).items():
            res[f"{scan}.mesh.{k}"] = v
        stats = mb.rank_stats()
        notes[f"{scan}.flushes"] = [s["flushes"] for s in stats]
        notes[f"{scan}.compiles"] = mb.compile_count
        topo.apply_placement(topo.placement)     # refresh every partition
        res[f"{scan}.refreshed.ids"] = topo.run(q).ids
        res[f"{scan}.refreshed.dists"] = topo.run(q).dists
        with pytest.raises(ValueError, match="pins one rank") as e:
            topo.scale_replicas(0, 2)
        notes["scale_replicas"] = str(e.value)
    with pytest.raises(ValueError, match="shard groups") as e:
        topology.TopologyConfig(shards=2 * world, exec=MeshBackend(mesh=mesh),
                                **STREAM).build(_bridged(ref, "beam"))
    notes["mismatch"] = str(e.value)

    # a mutable mesh tier and its in-process twin, churned and swapped
    index = bridge.compact_index_from_numpy(
        {f[len("index."):]: ref[f] for f in ref.files
         if f.startswith("index.")}, device="cpu")
    host = bridge.host_store_from_numpy(ref["host.vectors"],
                                        ref["host.centroids"], device="cpu")
    mut = MutableIndex(index, host, tci.IndexConfig(**ICFG), slab=24)
    eng = mut.to_engine(tengine.SearchConfig(**SCFG))
    cfg = topology.TopologyConfig(shards=world, mutable=True, **STREAM)
    tiers = {"inproc": cfg.build(eng),
             "mesh": dataclasses.replace(
                 cfg, exec=MeshBackend(mesh=mesh)).build(eng)}
    rng = np.random.default_rng(9)
    for step in ("churned", "compacted"):
        if step == "churned":
            _churn(mut, rng, 30, 20, len(ref["host.vectors"]))
        else:
            mut.compact()
        for name, topo in tiers.items():
            topo.apply(mut)
            rep = topo.run(q)
            res[f"mutable.{step}.{name}.ids"] = rep.ids
            res[f"mutable.{step}.{name}.dists"] = rep.dists
    res["mutable.live"] = mut.live_ids().numpy()
    np.savez(out / "results.npz", **res)
    (out / "notes.json").write_text(json.dumps(notes))
    tiers["mesh"].close()                         # the followers stop


def _elastic_round(mesh, rank: int, world: int) -> dict:
    """place / replace_mesh / reshard_like on every rank, checked there."""
    from torch.distributed.tensor import Replicate, Shard
    full = {"a": torch.arange(world * 6, dtype=torch.float32).reshape(
                world * 3, 2),
            "b": torch.arange(5, dtype=torch.int32),
            "c": torch.arange(7, dtype=torch.uint8)}
    specs = {"a": sharding.P("shard"), "b": sharding.P(),
             "c": sharding.P("shard")}
    placed = elastic.place(full if rank == 0 else None,
                           specs if rank == 0 else None, mesh)
    assert placed["a"].placements == (Shard(0),)
    assert torch.equal(placed["a"].to_local(), full["a"][3 * rank:3 * rank + 3])
    assert placed["b"].placements == (Replicate(),)
    assert torch.equal(placed["b"].to_local(), full["b"])
    # 7 rows do not divide over 2 or 4 ranks: replicated (resolve_spec)
    assert placed["c"].placements == (Replicate(),)
    assert torch.equal(placed["c"].to_local(), full["c"])
    again = elastic.replace_mesh(placed, specs if rank == 0 else None,
                                 lmesh.make_shard_mesh(world, device="cpu"))
    for k in full:
        assert torch.equal(again[k].full_tensor(), full[k])
    new = {k: v + 1 for k, v in full.items()}
    swapped = elastic.reshard_like(placed, new)
    assert swapped["a"] is placed["a"]           # refilled in place
    assert torch.equal(placed["a"].to_local(), new["a"][3 * rank:3 * rank + 3])
    assert torch.equal(placed["c"].to_local(), new["c"])
    try:
        elastic.reshard_like(placed, {**new, "b": torch.arange(6)})
    except ValueError as e:
        return {"reshard_error": str(e)}
    raise AssertionError("reshard_like took a new shape")


def _mesh_rank(rank: int, world: int, init: str, ref_path: str,
               out: str) -> None:
    """One rank of the module's mesh: the elastic round on every rank,
    then rank 0 serves the tiers and the others follow."""
    out = pathlib.Path(out)
    dev = lmesh.init_shard_group(rank, world, init_method=init,
                                 device="cpu", timeout_s=TIMEOUT_S)
    try:
        mesh = lmesh.make_shard_mesh(world, device="cpu")
        notes = _elastic_round(mesh, rank, world)
        if rank != 0:
            MeshBackend.follow(mesh, dev)
            return
        (out / "elastic.json").write_text(json.dumps(notes))
        try:
            _origin(mesh, world, ref_path, out)
        except BaseException:
            MeshBackend(mesh=mesh).close()        # stop them all the same
            raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory) -> str:
    """The JAX package's mesh run (4 forced host devices), saved."""
    path = tmp_path_factory.mktemp("jax_mesh") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    subprocess.run([sys.executable, "-c", JAX_MESH, str(path)], env=env,
                   check=True, timeout=JOIN_S, cwd=ROOT)
    return str(path)


@pytest.fixture(scope="module", params=[2, 4], ids=["shards2", "shards4"])
def mesh_run(request, jax_ref, tmp_path_factory):
    """Every mesh tier of the module at one world size, with its in-process
    twins: (world, results, notes, elastic notes)."""
    world = request.param
    out = tmp_path_factory.mktemp(f"mesh{world}")
    run_ranks(_mesh_rank, world, out, jax_ref, str(out))
    return (world, np.load(out / "results.npz"),
            json.loads((out / "notes.json").read_text()),
            json.loads((out / "elastic.json").read_text()))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the mesh tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", ["beam", "gemv"])
def test_mesh_tier_bitwise_equals_inproc_tier(mesh_run, scan):
    """Ids and distances bit for bit, the same fanout, unrouted count,
    cluster_hits and queries per shard; and the ids of one engine
    searching the same probes (tests/test_execbackend.py's contract)."""
    world, r, _, _ = mesh_run
    mesh, inproc = f"{scan}.mesh.", f"{scan}.inproc."
    assert str(r[mesh + "exec"]) == "mesh"
    assert str(r[inproc + "exec"]) == "inproc"
    np.testing.assert_array_equal(r[mesh + "ids"], r[inproc + "ids"])
    np.testing.assert_array_equal(_bits(r[mesh + "dists"]),
                                  _bits(r[inproc + "dists"]))
    for k in ("fanout", "unrouted", "hits", "queries"):
        np.testing.assert_array_equal(r[mesh + k], r[inproc + k])
    assert (r[mesh + "queries"] > 0).all()          # every owner searched
    np.testing.assert_array_equal(r[mesh + "ids"], r[f"{scan}.single.ids"])
    np.testing.assert_allclose(r[mesh + "dists"], r[f"{scan}.single.dists"],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scan", ["beam", "gemv"])
def test_mesh_tier_close_to_jax_mesh(mesh_run, jax_ref, scan):
    """Against the JAX package's mesh run on the same index: ids in >= 99%
    of slots, the same fanout, unrouted count and cluster_hits, distances
    within rtol 1e-5 plus 1e-6 of 4 max |q|^2 where the ids agree."""
    world, r, _, _ = mesh_run
    ref = np.load(jax_ref)
    key = f"{scan}.{world}."
    ids = r[f"{scan}.mesh.ids"]
    same = ids == ref[key + "ids"]
    assert same.mean() >= 0.99, same.mean()
    scale = float(np.max(np.sum(ref["queries"] ** 2, -1))) * 4
    np.testing.assert_allclose(r[f"{scan}.mesh.dists"][same],
                               ref[key + "dists"][same], rtol=1e-5,
                               atol=1e-6 * scale)
    assert float(r[f"{scan}.mesh.fanout"]) == float(ref[key + "fanout"])
    assert int(r[f"{scan}.mesh.unrouted"]) == int(ref[key + "unrouted"])
    np.testing.assert_array_equal(r[f"{scan}.mesh.hits"], ref[key + "hits"])


@pytest.mark.parametrize("scan", ["beam", "gemv"])
def test_mesh_warm_refresh_and_flushes(mesh_run, scan):
    """warm() builds nothing (the port runs eagerly) and leaves the results
    alone; every rank runs every flush of a run; a refresh of every
    partition (apply_placement with the same placement) keeps the bits."""
    world, r, notes, _ = mesh_run
    assert notes[f"{scan}.warm"] == 0 and notes[f"{scan}.compiles"] == 0
    flushes = notes[f"{scan}.flushes"]
    assert len(flushes) == world and len(set(flushes)) == 1
    assert flushes[0] > 0
    np.testing.assert_array_equal(r[f"{scan}.refreshed.ids"],
                                  r[f"{scan}.mesh.ids"])
    np.testing.assert_array_equal(_bits(r[f"{scan}.refreshed.dists"]),
                                  _bits(r[f"{scan}.mesh.dists"]))


def test_prebuilt_mesh_and_replica_scaling_refused(mesh_run):
    """A prebuilt mesh whose axis size disagrees with the topology raises
    (tests/test_execbackend.py's wording), and replica scaling on a mesh
    tier raises."""
    world, _, notes, _ = mesh_run
    assert f"has size {world}" in notes["mismatch"]
    assert f"{2 * world} shard groups" in notes["mismatch"]
    assert "launching processes" in notes["scale_replicas"]


@pytest.mark.parametrize("step", ["churned", "compacted"])
def test_mutable_mesh_tier_apply_equals_inproc(mesh_run, step):
    """apply() on a mutable mesh tier re-places every partition: after a
    churn and after compaction, the tier equals its in-process twin bit for
    bit, and serves no deleted id."""
    _, r, _, _ = mesh_run
    key = f"mutable.{step}."
    np.testing.assert_array_equal(r[key + "mesh.ids"], r[key + "inproc.ids"])
    np.testing.assert_array_equal(_bits(r[key + "mesh.dists"]),
                                  _bits(r[key + "inproc.dists"]))
    ids = r[key + "mesh.ids"]
    assert np.isin(ids[ids >= 0], r["mutable.live"]).all()


def test_elastic_place_replace_and_reshard(mesh_run):
    """Checked on every rank inside the spawned mesh: Shard / Replicate
    placements and the divisibility fallback, replace_mesh round trip,
    reshard_like in place; a shape change raises JAX's ValueError."""
    _, _, _, notes = mesh_run
    assert "live swaps demand shape stability" in notes["reshard_error"]


# ---------------------------------------------------------------------------
# host logic against the JAX package
# ---------------------------------------------------------------------------

def _jax():
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    return (jax, jnp, importlib.import_module("repro.distributed.sharding"),
            importlib.import_module("repro.core.ivf"))


SPECS = [
    ({"data": 1, "model": 1}, ("model", None), (14, 8)),
    ({"data": 1, "model": 1}, ("pod", "model"), (4, 8)),
    ({"data": 1, "model": 1}, (("pod", "data"), None), (4, 8)),
    ({"model": 1}, ("model",), (14,)),
    ({"data": 2, "model": 4}, ("data", "model"), (6, 8)),
    ({"data": 2, "model": 4}, ("model", "data"), (6, 8)),
    ({"data": 2, "model": 4}, (("data", "model"), None), (16, 3)),
    ({"data": 2, "model": 4}, (("data", "model"), None), (12, 3)),
    ({"data": 2, "model": 4}, (None, ("pod", "model")), (5, 12)),
    ({"shard": 4}, ("shard",), (8, 17, 3)),
    ({"shard": 4}, ("shard",), (7, 3)),
    ({"shard": 3}, (None, "shard"), (2, 9)),
]


@pytest.mark.parametrize("axes,spec,shape", SPECS)
def test_resolve_spec_matches_jax(axes, spec, shape):
    """The port's fallbacks give JAX's resolved spec entry for entry, and
    its placements are that spec's (Shard(d) where an axis splits dim d).
    Meshes are stand-ins with the axis sizes: both functions read only
    those."""
    from torch.distributed.tensor import Replicate, Shard
    _, _, jsharding, _ = _jax()
    jP = importlib.import_module("jax.sharding").PartitionSpec
    want = tuple(jsharding.resolve_spec(types.SimpleNamespace(shape=axes),
                                        jP(*spec), shape))
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 shape=tuple(axes.values()))
    got = sharding.resolve_entries(mesh, sharding.P(*spec), shape)
    assert tuple(got) == want + (None,) * (len(got) - len(want))
    placements = sharding.resolve_spec(mesh, sharding.P(*spec), shape)
    for name, pl in zip(axes, placements):
        dims = [d for d, e in enumerate(want)
                if e == name or (isinstance(e, tuple) and name in e)]
        assert pl == (Shard(dims[0]) if dims else Replicate())


def test_resolve_tree_and_use_mesh_on_a_real_mesh(tmp_path):
    """tests/test_distributed.py's specs on a real one-rank ("data",
    "model") DeviceMesh (``make_test_mesh``), resolve_tree over a dict of
    shapes, and use_mesh / current_mesh."""
    from torch.distributed.tensor import Replicate, Shard
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            rank=0, world_size=1)
    try:
        mesh = lmesh.make_test_mesh(1, 1)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        P = sharding.P
        assert sharding.resolve_entries(mesh, P("model", None), (14, 8)) \
            == P("model", None)
        assert sharding.resolve_entries(mesh, P("pod", "model"), (4, 8)) \
            == P(None, "model")
        assert sharding.resolve_entries(mesh, P(("pod", "data"), None),
                                        (4, 8)) == P("data", None)
        tree = sharding.resolve_tree(
            mesh, {"w": (14, 8), "b": [(4, 8)]},
            {"w": P("model", None), "b": [P("data", "model")]})
        assert tree == {"w": (Replicate(), Shard(0)),
                        "b": [(Shard(0), Shard(1))]}
        assert sharding.current_mesh() is None
        with sharding.use_mesh(mesh):
            assert sharding.current_mesh() is mesh
        assert sharding.current_mesh() is None
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_owner_tables_op_matches_jax(seed):
    """owner_tables_op (torch) gives the JAX op's tables and touches bit
    for bit, holes included, and the numpy owner_tables' too."""
    _, jnp, _, jivf = _jax()
    rng = np.random.default_rng(seed)
    q, p, o = 13, 5, 4
    own = rng.integers(-1, o, (q, p)).astype(np.int32)
    local = np.where(own >= 0, rng.integers(0, 6, (q, p)), -1).astype(
        np.int32)
    jt, jtouch = jivf.owner_tables_op(jnp.asarray(own), jnp.asarray(local),
                                      n_owners=o)
    tt, ttouch = ivf.owner_tables_op(torch.from_numpy(own),
                                     torch.from_numpy(local), n_owners=o)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ttouch.numpy(), np.asarray(jtouch))
    assert tt.dtype == torch.int32
    nt, ntouch = ivf.owner_tables(own, local, o)
    np.testing.assert_array_equal(tt.numpy(), nt)
    np.testing.assert_array_equal(ttouch.numpy(), ntouch)


# ---------------------------------------------------------------------------
# validations: each raises before any mesh is built, with JAX's wording
# (tests/test_execbackend.py's patterns)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_engine():
    from repro_torch.data.synthetic import clustered_vectors
    x, _ = clustered_vectors(3, 600, 16, 4)
    return tengine.PIMCQGEngine.build(
        0, x, tci.IndexConfig(dim=16, n_clusters=4, degree=8, knn_k=16),
        tengine.SearchConfig(**SCFG), n_shards=2, device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(shards=1, replicas=2), "nothing to scatter"),
    (dict(shards=2, replicas=2), "replica"),
    (dict(shards=2, hedge=HedgeConfig()), "hedging needs in-process"),
    (dict(shards=2, replicate_hot=2), "hot-cluster replication"),
    (dict(shards=2, autoscale=AutoscalePolicy()), "autoscaling resizes"),
    (dict(shards=2, modes=("mulfree", "exact")), "heterogeneous modes"),
], ids=["replicated_tier", "replicas", "hedge", "replicate_hot",
        "autoscale", "mixed_modes"])
def test_mesh_validations_raise_before_any_mesh(small_engine, kw, match):
    """No process group exists here: each refusal comes before one is
    needed."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=match):
        topology.TopologyConfig(exec="mesh", **STREAM, **kw).build(
            small_engine)


def test_mesh_backend_guards_unprepared_and_per_engine_entry_points():
    mb = MeshBackend()
    with pytest.raises(RuntimeError, match="prepare"):
        mb.search_scattered(np.zeros((1, 4), np.float32),
                            np.full((2, 1, 2), -1, np.int32), pad_to=8)
    with pytest.raises(NotImplementedError):
        mb.search(None, None, pad_to=8)
    with pytest.raises(NotImplementedError):
        mb.search_probed(None, None, None, pad_to=8)
    with pytest.raises(RuntimeError, match="before prepare"):
        mb.refresh(None)


def test_make_shard_mesh_error_names_the_launch(small_engine):
    """Without a process group of n ranks the mesh cannot be made: the
    error names torchrun (as JAX's names its XLA flag); the topology
    raises it too."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=2"):
        lmesh.make_shard_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        lmesh.make_shard_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        topology.TopologyConfig(shards=2, exec="mesh", **STREAM).build(
            small_engine)


def test_collective_backend_rule():
    """NCCL only when every rank has a card of its own; gloo otherwise
    (the CPU, or ranks sharing cards)."""
    assert lmesh.collective_backend(4, "cpu") == "gloo"
    cards = torch.cuda.device_count()
    assert lmesh.collective_backend(cards + 1, "cuda") == "gloo"
    assert lmesh.rank_device(3, "cpu") == torch.device("cpu")


def test_reshard_like_refuses_a_shape_change():
    """The live-swap contract: a new leaf of another shape raises JAX's
    ValueError and copies nothing."""
    old = {"a": torch.zeros(4, 3), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="live swaps demand shape"):
        elastic.reshard_like(old, {"a": torch.ones(4, 3),
                                   "b": torch.ones(3)})
    assert not old["a"].any()
    out = elastic.reshard_like(old, {"a": torch.ones(4, 3),
                                     "b": torch.ones(2)})
    assert out["a"] is old["a"] and bool(old["a"].all())


# ---------------------------------------------------------------------------
# serve.py --exec mesh under torchrun
# ---------------------------------------------------------------------------

def _retrieved(text: str) -> list:
    m = re.search(r"retrieved neighbor ids \(first 4 reqs\): (\[.*\])", text)
    assert m, text[-2000:]
    return json.loads(m.group(1))


def test_serve_exec_mesh_under_torchrun_equals_inproc():
    """python -m torch.distributed.run --nproc-per-node 2 serves the
    retrieval through the mesh tier (rank 0 serves, rank 1 follows) and
    retrieves --exec inproc's ids."""
    args = ["--arch", "h2o-danube-1.8b", "--requests", "4", "--prompt-len",
            "16", "--gen", "4", "--rag", "--fleet", "2", "--sharded",
            "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    mesh = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *args,
         "--exec", "mesh"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=JOIN_S)
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    assert "exec=mesh" in mesh.stdout
    from repro_torch.launch import serve
    _, want = serve.run("h2o-danube-1.8b", 4, 16, 4, rag=True, fleet=2,
                        sharded=True, verbose=False, device="cpu")
    assert _retrieved(mesh.stdout) == want[:4, :4].tolist()


def test_mesh_modules_import_no_jax():
    """The mesh backend's modules, the search step's and the token
    batches' leave jax and the JAX package out of sys.modules, in a fresh
    interpreter."""
    code = ("import sys, repro_torch.core.execbackend, "
            "repro_torch.launch.mesh, repro_torch.distributed.elastic, "
            "repro_torch.distributed.sharding, "
            "repro_torch.launch.anns_step, repro_torch.data.synthetic; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
