"""Execution backends of the serving topology (counterpart of
``repro/core/execbackend.py``).

How a tier runs is a seam: ``EngineWorker`` / ``ShardWorker`` dispatch
through an ``ExecutionBackend`` instead of calling the engine directly.

  * ``InProcBackend``, the default, runs each flush on the engine in this
    process, on the device that holds the engine's tensors.
  * ``MeshBackend`` runs the sharded scatter -> probed search -> gather
    path over a mesh of processes, one rank a shard
    (``launch.mesh.make_shard_mesh``). Rank 0, the origin, runs the
    ``ServingTopology`` and owns shard 0; every other rank holds its own
    partition and runs ``MeshBackend.follow`` until the origin stops it.
    ``prepare`` places each rank's partition on it
    (``distributed.elastic.place``); each flush broadcasts one header and
    the padded queries and probe tables, every rank searches its own row
    with ``engine.probed_block`` (the in-process probed search's very
    computation), and an ``all_gather`` brings every partial top-k back to
    the origin, which merges them as the in-process tier does.

Parity contract: a rank runs exactly ``probed_block``, whose sums are
batch-invariant (``core/fixed_order.py``), so each owner's partial top-k
and the origin merge equal the in-process tier's, distances in every slot
and ids outside exact ties (ROADMAP C4).

Memory: JAX's mesh block replicates the whole vector store on every
device; at 10M x 128 that is 5.12 GB a rank. A rank here holds only the
rows its partition's clusters reference (its rerank reads no others), its
``node_ids`` renumbered to them and mapped back to global ids after the
rerank; the renumbering is a bijection, so the selection is unchanged.

Select a backend by registry key (``exec="mesh"``) or pass an instance
(``exec=MeshBackend(mesh=m)``, a prebuilt mesh).
"""

from __future__ import annotations

import time
from typing import Protocol

import numpy as np
import torch
import torch.distributed as dist

from . import engine as engine_mod
from ..kernels import _build, ops

__all__ = ["ExecutionBackend", "InProcBackend", "MeshBackend", "MeshResult",
           "INPROC", "EXEC_BACKENDS", "resolve_exec_backend"]


class ExecutionBackend(Protocol):
    """Where and how a worker's flush executes. ``search`` and
    ``search_probed`` mirror the engine's entry points; ``name`` is the
    registry key reported in ``TopologyReport``."""

    name: str

    def search(self, engine, queries, *, pad_to): ...

    def search_probed(self, engine, queries, probe, *, pad_to): ...


class InProcBackend:
    """Run flushes on the engine in this process."""

    name = "inproc"

    def search(self, engine, queries, *, pad_to):
        return engine.search(queries, pad_to=pad_to)

    def search_probed(self, engine, queries, probe, *, pad_to):
        return engine.search_probed(queries, probe, pad_to=pad_to)


INPROC = InProcBackend()

# the origin's messages: a header of four int64 words, [op, a, b, c]
OP_STOP, OP_PLACE, OP_SEARCH, OP_STATS, OP_PROBE = range(5)
# the placed index's fields a rank receives as they are (its node_ids are
# renumbered to its own rows)
PLACED_FIELDS = ("centroids", "codes", "neighbors", "entry", "n_valid")


class MeshResult:
    """One scattered flush's gathered partials, (O, B, k) ids and dists,
    lazy like the other backends' results: ``query()`` is the all_gather's
    completion (where the in-process tier asks a CUDA event), and ``ids`` /
    ``dists`` wait for it."""

    def __init__(self, work, out: torch.Tensor, k: int):
        self._work, self._out, self._k = work, out, k

    def query(self) -> bool:
        return self._work is None or self._work.is_completed()

    def _gathered(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out

    @property
    def ids(self) -> np.ndarray:
        return self._gathered()[..., :self._k].cpu().numpy()

    @property
    def dists(self) -> np.ndarray:
        return self._gathered()[..., self._k:].contiguous().view(
            torch.float32).cpu().numpy()


def _stack(leaves, axis: int, fill) -> torch.Tensor:
    """Per-owner tensors stacked on the host along a new leading owner
    axis, ``axis`` padded to the widest owner with ``fill`` (pad clusters
    are never probed: the tables hold real local ids only)."""
    width = max(t.shape[axis] for t in leaves)
    out = []
    for t in leaves:
        t = t.cpu()
        pad = width - t.shape[axis]
        if pad:
            shape = list(t.shape)
            shape[axis] = pad
            t = torch.cat([t, t.new_full(shape, fill)], dim=axis)
        out.append(t)
    return torch.stack(out)


def _own_rows(engine):
    """A partition's rows: (the placed ``node_ids`` renumbered to rows of
    its own vector block, that block, the global id of each row)."""
    nid = engine.placed.node_ids
    rows = torch.unique(nid[nid >= 0])                    # ascending
    local = torch.searchsorted(rows, nid.clamp(min=0).contiguous())
    local = torch.where(nid >= 0, local, -1).to(torch.int32)
    return local, engine.host.vectors[rows.long()], rows.to(torch.int32)


class MeshBackend:
    """The sharded scatter / gather path on a mesh of ranks, one a shard.

    On the origin (rank 0), ``prepare(topology)`` validates the topology,
    builds the mesh when none was given (``launch.mesh.make_shard_mesh``)
    and places every partition on its rank; ``search_scattered`` runs one
    flush. The other ranks run ``MeshBackend.follow(mesh, device)``, which
    serves the origin's messages (place, search, stats, stop) until it
    sends stop. Followers never form batches of their own: every flush's
    shape comes from the origin's header, so the ranks stay in lockstep. A
    rank that fails raises, and the others' next collective fails within
    the group's timeout.

    The collectives run on the mesh's device type: a gloo mesh ("cpu")
    stages the queries, tables and partials through host memory, NCCL
    ("cuda") moves them between cards; the search itself runs on each
    rank's device. Replication is the mesh's job (one rank a shard); the
    in-process backend keeps the replica and hedging machinery."""

    name = "mesh"

    def __init__(self, mesh=None, axis: str = "shard"):
        self.mesh = mesh
        self.axis = axis
        self._ready = False
        self._stopped = False
        self._device = None
        self._state = None          # this rank's engine.ShardState
        self._row_ids = None        # (R,) global id of each held row
        self._scfg = None
        self._n_owners = 0
        self.n_flushes = 0
        self.search_s = 0.0         # seconds in this rank's searches
        self.stage_s = 0.0          # seconds of host <-> card copies

    # -- the wire: headers and collectives ----------------------------------
    @property
    def _group(self):
        return self.mesh.get_group()

    @property
    def _stage(self) -> torch.device:
        return torch.device(self.mesh.device_type)

    @property
    def _rank(self) -> int:
        return dist.get_rank(self._group)

    def _header(self, op: int = 0, a: int = 0, b: int = 0, c: int = 0):
        """Broadcast the origin's header (followers pass nothing and get
        it)."""
        h = torch.tensor([op, a, b, c], dtype=torch.int64, device=self._stage)
        dist.broadcast(h, src=dist.get_global_rank(self._group, 0),
                       group=self._group)
        return [int(v) for v in h.tolist()]

    # -- preparation ---------------------------------------------------------
    def prepare(self, topo) -> None:
        """Bind this backend to a sharded ServingTopology on the origin:
        build (or adopt) the mesh and place every partition on its rank."""
        if self._ready:
            return
        leaders = [g[0] for g in topo.groups]
        n_owners = len(leaders)
        inner = {e.place.n_shards for e in leaders}
        if len(inner) != 1:
            raise ValueError(
                f"mesh backend needs every partition to share one "
                f"inner-shard count, got {sorted(inner)}")
        modes = {e.scfg.mode for e in leaders}
        if len(modes) != 1:
            raise ValueError(
                f"mesh backend runs ONE ranking backend on every rank; "
                f"heterogeneous modes {sorted(modes)} need exec='inproc'")
        if self.mesh is None:
            from ..launch.mesh import make_shard_mesh
            self.mesh = make_shard_mesh(n_owners, self.axis,
                                        device=topo.device)
        names = tuple(self.mesh.mesh_dim_names or ())
        if self.axis not in names:
            raise ValueError(f"mesh has axes {names}, not {self.axis!r}")
        size = self.mesh.size(names.index(self.axis))
        if size != n_owners:
            raise ValueError(
                f"mesh axis {self.axis!r} has size {size} but the topology "
                f"has {n_owners} shard groups")
        if self._rank != 0:
            raise RuntimeError(
                "MeshBackend.prepare runs on the origin, rank 0; the other "
                "ranks run MeshBackend.follow")
        self._device = topo.device
        self._n_owners = n_owners
        if self._device.type == "cuda":
            # the followers load these libraries and never build one
            _build.build_all(("beam_search", "cluster_scan", "topk_select",
                              "merge_topk"))
        self._stack_and_place(leaders)
        self._ready = True

    def _stack_and_place(self, leaders) -> None:
        """Send every rank its partition (``_receive`` on each end)."""
        self._header(OP_PLACE)
        self._receive(leaders)

    def refresh(self, topo) -> None:
        """Re-place every partition after a live swap
        (``ServingTopology.apply`` / ``apply_placement``): the engines'
        refreshed arrays go to their ranks, each rank dropping its old
        block first. The placed shapes are the engines' and stay put (the
        ``MutableIndex`` contract); a rank's row block follows the rows
        its partition references."""
        if not self._ready:
            raise RuntimeError("MeshBackend.refresh() before prepare()")
        self._stack_and_place([g[0] for g in topo.groups])

    def _receive(self, leaders=None) -> None:
        """Both ends of a placement, after its header. The origin passes
        the partition engines; each field is stacked on the host along the
        owner axis, one field at a time, and placed with
        ``elastic.place``, so rank o gets partition o's block: its placed
        index, its cluster maps, its own rows and their global ids. The
        rotation is replicated. Every rank drops its old block first and
        ends holding its new ``ShardState``."""
        from ..distributed import elastic
        from ..distributed.sharding import P
        origin = leaders is not None
        self._state = self._row_ids = None        # release the old block
        meta = [leaders[0].scfg, type(leaders[0].placed.arrays)] \
            if origin else [None, None]
        dist.broadcast_object_list(
            meta, src=dist.get_global_rank(self._group, 0),
            group=self._group)
        self._scfg, arrays_type = meta

        def each(get):
            return [get(e) for e in leaders] if origin else None

        def put(parts, axis=0, fill=0):
            """This rank's block of the origin's per-owner tensors,
            ``axis`` padded to the widest owner with ``fill`` (pad
            clusters are never probed: the tables hold real local ids)."""
            tree = {"x": _stack(parts, axis, fill)} if origin else None
            spec = {"x": P(self.axis)} if origin else None
            return elastic.place(tree, spec, self.mesh)["x"].to_local()[0] \
                .to(self._device)

        placed = {f: put(each(lambda e: getattr(e.placed, f)), axis=1)
                  for f in PLACED_FIELDS}
        arrays = [put(each(lambda e: e.placed.arrays[i]), axis=1)
                  for i in range(len(arrays_type._fields))]
        shard_of = put(each(lambda e: e.shard_of))
        local_slot = put(each(lambda e: e.local_slot))
        # node_ids renumbered to the rank's own rows, and those rows
        own = each(lambda e: [t.cpu() for t in _own_rows(e)])
        placed["node_ids"] = put(own and [o[0] for o in own], 1, -1)
        vectors = put(own and [o[1] for o in own])
        self._row_ids = put(own and [o[2] for o in own], fill=-1)
        del own
        rot = elastic.place({"x": leaders[0].index.rotation} if origin
                            else None, {"x": P()} if origin else None,
                            self.mesh)["x"].to_local().to(self._device)
        self._state = engine_mod.ShardState(
            engine_mod.PlacedIndex(**placed, arrays=arrays_type(*arrays)),
            shard_of, local_slot, rot, vectors)

    # -- one flush -----------------------------------------------------------
    def search_scattered(self, queries: np.ndarray, tables: np.ndarray,
                         *, pad_to: int) -> MeshResult:
        """One scattered flush: queries (B', D) with their per-owner probe
        tables (O, B', P) -> lazy (ids (O, B, k), dists (O, B, k)), B =
        pad_to. Row o is owner o's partial top-k (-1 / inf where the owner
        was not touched), gathered to the origin."""
        if not self._ready:
            raise RuntimeError("MeshBackend.prepare() was never called — "
                               "construct it through ServingTopology")
        nq, d = queries.shape
        b = int(pad_to)
        p = tables.shape[2]
        payload = np.zeros(b * d + self._n_owners * b * p, np.int32)
        qb = payload[:b * d].view(np.float32).reshape(b, d)
        qb[:nq] = queries
        tb = payload[b * d:].reshape(self._n_owners, b, p)
        tb[:] = -1
        tb[:, :nq] = tables
        self._header(OP_SEARCH, b, p, nq)
        return self._search(torch.from_numpy(payload), b, p, nq)

    def _search(self, payload: torch.Tensor | None, b: int, p: int,
                nq: int) -> MeshResult:
        """Both ends of a flush, after its header: the payload's broadcast,
        this rank's ``probed_block`` over its row of the tables, and the
        all_gather of every rank's (B, k) ids and dists."""
        o, k = self.mesh.size(), self._scfg.k
        d = self._state.rotation.shape[0]
        if payload is None:
            payload = torch.empty(b * d + o * b * p, dtype=torch.int32)
        payload = payload.to(self._stage)
        dist.broadcast(payload, src=dist.get_global_rank(self._group, 0),
                       group=self._group)
        t0 = time.perf_counter()
        payload = payload.to(self._device)
        t1 = time.perf_counter()
        q = payload[:b * d].view(torch.float32).reshape(b, d)
        probe = payload[b * d:].reshape(o, b, p)[self._rank]
        res, _ = engine_mod.probed_block(self._state, self._scfg, q, nq,
                                         probe)
        ids = torch.where(res.ids >= 0,
                          self._row_ids[res.ids.clamp(min=0).long()], -1)
        packed = torch.cat([ids, res.dists.view(torch.int32)], dim=1)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        t2 = time.perf_counter()
        packed = packed.to(self._stage)
        self.stage_s += t1 - t0 + time.perf_counter() - t2
        self.search_s += t2 - t1
        out = torch.empty((o, b, 2 * k), dtype=torch.int32,
                          device=self._stage)
        work = dist.all_gather(list(out.unbind(0)), packed,
                               group=self._group, async_op=True)
        self.n_flushes += 1
        return MeshResult(work, out, k)

    # -- instrumentation -----------------------------------------------------
    def rank_stats(self, reset: bool = False) -> list[dict]:
        """Every rank's kernel launch counts, peak device memory, flushes,
        search seconds and host <-> card copy seconds since the last reset
        (``reset`` zeroes them after reading)."""
        self._header(OP_STATS, int(reset))
        return self._stats(reset)

    def _stats(self, reset: bool) -> list[dict]:
        dev = self._device
        cuda = dev is not None and dev.type == "cuda"
        mine = {"rank": self._rank, "device": str(dev),
                "launches": ops.launch_counts(),
                "peak_bytes": torch.cuda.max_memory_allocated(dev)
                if cuda else 0,
                "flushes": self.n_flushes, "search_s": self.search_s,
                "stage_s": self.stage_s}
        if reset:
            ops.reset_launch_counts()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            self.n_flushes, self.search_s, self.stage_s = 0, 0.0, 0.0
        out = [None] * self.mesh.size()
        dist.all_gather_object(out, mine, group=self._group)
        return out

    def time_gather(self, bucket: int, iters: int = 20) -> float:
        """Milliseconds per all_gather of one flush's partials at
        ``bucket`` rows (every rank's (bucket, 2k) int32), back to back
        on the mesh's collective device."""
        self._header(OP_PROBE, int(bucket), int(iters))
        return self._probe(bucket, iters)

    def _probe(self, bucket: int, iters: int) -> float:
        o, k = self.mesh.size(), self._scfg.k
        x = torch.zeros((bucket, 2 * k), dtype=torch.int32,
                        device=self._stage)
        out = torch.empty((o, bucket, 2 * k), dtype=torch.int32,
                          device=self._stage)
        dist.all_gather(list(out.unbind(0)), x, group=self._group)
        t = time.perf_counter()
        for _ in range(iters):
            dist.all_gather(list(out.unbind(0)), x, group=self._group)
        return 1e3 * (time.perf_counter() - t) / iters

    # -- the followers -------------------------------------------------------
    @classmethod
    def follow(cls, mesh, device, axis: str = "shard") -> None:
        """A follower rank's loop: serve the origin's messages until it
        sends stop. Raises on an unknown message or a failed collective."""
        me = cls(mesh, axis)
        me._device = torch.device(device)
        if me._rank == 0:
            raise RuntimeError("rank 0 is the origin; it serves the "
                               "topology and never follows")
        while True:
            op, a, b, c = me._header()
            if op == OP_STOP:
                return
            if op == OP_PLACE:
                me._receive()
            elif op == OP_SEARCH:
                me._search(None, a, b, c)._gathered()
            elif op == OP_STATS:
                me._stats(bool(a))
            elif op == OP_PROBE:
                me._probe(a, b)
            else:
                raise RuntimeError(f"unknown mesh message {op}")

    def close(self) -> None:
        """Tell the followers to stop (once, from the origin)."""
        if self.mesh is not None and not self._stopped and self._rank == 0:
            self._stopped = True
            self._header(OP_STOP)

    # -- the worker's view of its "engine" ----------------------------------
    @property
    def compile_count(self) -> int:
        """Executables built: always 0, the port runs eagerly."""
        return 0

    def warm(self, buckets, nprobe: int) -> int:
        """One flush per bucket shape with one probe on every owner, so
        every rank loads its kernel libraries before a timed stream.
        Returns the number of executables built: 0."""
        for b in buckets:
            q1 = np.zeros((1, self._state.rotation.shape[0]), np.float32)
            t1 = np.full((self._n_owners, 1, nprobe), -1, np.int32)
            t1[:, 0, 0] = 0
            self.search_scattered(q1, t1, pad_to=int(b))._gathered()
        return 0

    # Protocol completeness: the mesh never serves replicated tiers, but
    # the seam's surface stays uniform so callers can probe it.
    def search(self, engine, queries, *, pad_to):
        raise NotImplementedError(
            "the mesh backend executes the sharded scatter path only; "
            "replicated tiers use exec='inproc'")

    def search_probed(self, engine, queries, probe, *, pad_to):
        raise NotImplementedError(
            "mesh execution dispatches whole scattered flushes via "
            "search_scattered, not per-engine search_probed")


# registry: name -> zero-arg factory, so every topology gets its OWN
# MeshBackend instance (prepare() binds state)
EXEC_BACKENDS = {
    "inproc": lambda: INPROC,
    "mesh": MeshBackend,
}


def resolve_exec_backend(spec) -> ExecutionBackend:
    """Registry key or instance -> backend instance (instances pass
    through, enabling a prebuilt mesh: ``exec=MeshBackend(mesh=m)``)."""
    if isinstance(spec, str):
        try:
            return EXEC_BACKENDS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown execution backend {spec!r}; registered: "
                f"{sorted(EXEC_BACKENDS)}") from None
    if hasattr(spec, "name") and (hasattr(spec, "search_probed")
                                  or hasattr(spec, "search_scattered")):
        return spec
    raise ValueError(f"exec must be a registry key or ExecutionBackend, "
                     f"got {spec!r}")
