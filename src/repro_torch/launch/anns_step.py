"""The paper's search step on a two-axis ('data', 'model') mesh
(counterpart of ``repro/launch/anns_step.py``).

The 'model' axis is the PU array: the compact index (codes, f_add,
adjacency, entries) is sharded on its shard dim over 'model'. The raw
vectors of the rerank are sharded by id range over ('pod', 'data');
queries are data-parallel. Shapes follow the paper's SIFT1B deployment:
1e9 nodes, 8,192 IVF clusters, degree 32, D = 128, nprobe 8, EF 40.

One process a rank. Each flush:

1. the origin (flat mesh position 0) broadcasts the queries;
2. every rank runs the cluster filter and the lane routing from the same
   bits (round-robin maps: shard c % S, slot c // S; the reference's
   capacity ceil(Q nprobe / S * 2));
3. rank (d, m) searches lanes [d cap / |DP|, (d + 1) cap / |DP|) of its
   model shard(s): it touches only its own shard of the index, and there
   is no collective during the traversal;
4. one all_gather brings every lane's (ef) global ids and hops to every
   rank, and the inverse lane map makes each query's candidates;
5. the owner-computes rerank (``sharded_rerank``): each data rank takes
   the exact distances of the candidates whose ids fall in its block of
   the vectors, +inf elsewhere; a MIN all_reduce over the data axes; then
   ``topk_select``'s keep-first dedup and top-k, which equal the
   reference's dedup and ``top_k``, since after the min each id carries
   exactly one finite distance.

The step gives the one-process step's ids and distances bit for bit (the
same lanes, each searched alone; each distance computed by one rank from
the same bits), and counts its collectives.

The JAX package lowers this step through XLA on the production mesh
(``lower_anns``) and reads its cost from the HLO; the port runs it, and
its ``lower_anns`` runs the same step as one rank of an
``AccountingMesh`` on meta tensors at the SIFT1B scale, counting its
FLOPs, bytes and collectives (``launch/op_stats.py``; the beam search at
``max_iters`` hops a lane, ``kernels/cost.py``). ``footprint`` reads the
bytes a rank holds from meta tensors and the resolved placements. Neither
starts a process:

    python -m repro_torch.launch.anns_step --account
    python -m repro_torch.launch.anns_step --lower --owner-rerank \\
        [--scan gemv] [--masked] [--mode mulfree] [--out build/dryrun]
    torchrun --nproc-per-node=8 -m repro_torch.launch.anns_step \\
        --data 2 --model 4 --n 1000000 --clusters 1024
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import backends as backends_mod
from ..core import engine, ivf, placement as placement_mod
from ..core import rerank as rerank_mod
from ..distributed import elastic
from ..distributed.sharding import (P, AccountingMesh, Collectives,
                                    all_gather, all_reduce, blocks_of,
                                    broadcast_from, is_accounting,
                                    shardings_tree, tree_flatten,
                                    tree_unflatten)
from ..kernels import ops as kernel_ops

__all__ = ["DP", "AnnsScale", "index_specs", "placed_index_spec_tree",
           "host_spec_tree", "footprint", "model_flops", "Collectives",
           "sharded_rerank", "build_search_step", "round_robin",
           "place_step_inputs", "lower_anns", "lower_main", "main"]

DP = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class AnnsScale:
    """SIFT1B-shaped deployment (paper defaults)."""
    n: int = 10 ** 9
    dim: int = 128
    n_clusters: int = 8192
    budget: int = 131072          # padded nodes per cluster (~1e9/8192)
    degree: int = 32
    nprobe: int = 8
    ef: int = 40
    k: int = 10
    queries: int = 4096
    max_iters: int = 64

    @property
    def dim_padded(self):
        return self.dim + ((-self.dim) % 8)


def index_specs(s: AnnsScale, n_shards: int, mode: str = "mulfree"):
    """(placed, host): meta tensors of the PIM-resident compact index,
    shard-major (S, C/S, ...) exactly as ``engine._place`` lays it out
    (``engine.placed_specs``, the backend's slice included), and of the
    host arrays: vectors, centroids, rotation, queries."""
    placed = engine.placed_specs(n_shards, s.n_clusters // n_shards,
                                 s.budget, s.degree, s.dim,
                                 backends_mod.get_backend(mode))
    meta = backends_mod.meta_tensor
    host = dict(vectors=meta((s.n, s.dim)),
                centroids=meta((s.n_clusters, s.dim)),
                rotation=meta((s.dim, s.dim)),
                queries=meta((s.queries, s.dim)))
    return placed, host


def _tree_map(fn, tree):
    leaves, structure = tree_flatten(tree,
                                     is_leaf=lambda x: hasattr(x, "shape"))
    return tree_unflatten(structure, [fn(x) for x in leaves])


def placed_index_spec_tree(placed) -> engine.PlacedIndex:
    """Specs: every PIM-resident array shards dim 0 over 'model'."""
    return _tree_map(lambda t: P("model", *(None,) * (t.dim() - 1)), placed)


def host_spec_tree() -> dict:
    """Specs of the host arrays, as the JAX package's lowering takes them:
    vectors and queries by rows over ('pod', 'data'), the rest
    replicated."""
    return dict(vectors=P(DP, None), centroids=P(), rotation=P(),
                queries=P(DP, None))


def _block_bytes(t: torch.Tensor, sh) -> int:
    """Bytes of the block of ``t`` one rank holds under sharding ``sh``."""
    block = elastic.block_slices(t.shape, sh.placements, sh.mesh.shape,
                                 (0,) * len(sh.mesh.shape))
    return math.prod(b.stop - b.start for b in block) * t.element_size()


def footprint(mesh, s: AnnsScale | None = None, mode: str = "mulfree"
              ) -> dict:
    """Bytes each rank holds of the step's arguments on ``mesh`` (a
    DeviceMesh or ``launch.mesh.production_shape``): the index (every
    placed array, dim 0 over 'model'), the vectors and queries (rows over
    ('pod', 'data')), the replicated centroids and rotation, and their
    total: the counterpart of XLA's ``argument_size_in_bytes``, from meta
    tensors and the resolved placements."""
    s = s or AnnsScale()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    placed, host = index_specs(s, sizes["model"], mode)
    psh = shardings_tree(mesh, placed, placed_index_spec_tree(placed))
    hsh = shardings_tree(mesh, host, host_spec_tree())
    p_leaves, _ = tree_flatten(placed, is_leaf=lambda x: hasattr(x, "shape"))
    s_leaves, _ = tree_flatten(psh, is_leaf=lambda x: hasattr(
        x, "placements"))
    out = {"index": sum(_block_bytes(t, sh)
                        for t, sh in zip(p_leaves, s_leaves))}
    for k, t in host.items():
        out[k] = _block_bytes(t, hsh[k])
    out["total"] = sum(out.values())
    return out


def model_flops(s: AnnsScale, hops_est: int = 32) -> float:
    """Useful-work yardstick: per lane, hops x R neighbour evaluations of a
    D-add LUT dot, plus the host rerank's exact distances."""
    lane_flops = hops_est * s.degree * 2.0 * s.dim_padded
    rerank_flops = s.nprobe * s.ef * 3.0 * s.dim
    return s.queries * (s.nprobe * lane_flops + rerank_flops)


# ---------------------------------------------------------------------------
# collectives, staged through the mesh's device type and counted
# ---------------------------------------------------------------------------

def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in DP if a in mesh.mesh_dim_names)


def _dp_index(mesh, coord) -> tuple[int, int]:
    """(this rank's block of the DP axes, their size): the first axis
    outermost, i_pod |data| + i_data."""
    names = list(mesh.mesh_dim_names)
    idx, n = 0, 1
    for a in _dp_axes(mesh):
        size = mesh.shape[names.index(a)]
        idx, n = idx * size + coord[names.index(a)], n * size
    return idx, n


def sharded_rerank(queries: torch.Tensor, cand_ids: torch.Tensor,
                   vectors: torch.Tensor, mesh, *, n_total: int, k: int,
                   coll: Collectives | None = None
                   ) -> rerank_mod.RerankResult:
    """Owner-computes exact rerank. ``vectors`` is this rank's block of
    the (n_total, D) vectors, rows [i n_total / |DP|, (i + 1) n_total /
    |DP|) for its DP block i. It scores the candidates whose ids fall in
    its block (``rerank.exact_sqdist``), +inf elsewhere (ids < 0 too); a
    MIN all_reduce over each data axis combines, so the only cross-shard
    traffic is the (Q, C) distance tile; then ``topk_select`` dedups
    (keep-first) and takes the top k. Raises ValueError, before any
    collective, unless |DP| divides n_total and ``vectors`` holds its
    block."""
    dp_axes = _dp_axes(mesh)
    idx, n_dp = _dp_index(mesh, mesh.get_coordinate())
    if n_total % n_dp:
        raise ValueError(f"{n_total} vectors do not split into {n_dp} "
                         f"equal blocks over {dp_axes}")
    rows = n_total // n_dp
    if vectors.shape[0] != rows:
        raise ValueError(f"a rank holds {rows} vectors of {n_total} over "
                         f"{dp_axes}, got {vectors.shape[0]}")
    local = cand_ids - idx * rows
    mine = (local >= 0) & (local < rows) & (cand_ids >= 0)
    d2 = rerank_mod.exact_sqdist(queries, local, vectors)
    d2 = torch.where(mine, d2, float("inf"))
    for ax in dp_axes:
        d2 = all_reduce(d2, ax, "min", mesh=mesh, kind="all_reduce_min",
                        counts=coll)
    ids, dists = kernel_ops.topk_select(cand_ids.contiguous(),
                                        d2.contiguous(), k=k)
    return rerank_mod.RerankResult(ids, dists)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def round_robin(n_clusters: int, n_shards: int) -> placement_mod.Placement:
    """The step's placement: cluster c on shard c % S at slot c // S."""
    if n_clusters % n_shards:
        raise ValueError(f"{n_clusters} clusters do not split over "
                         f"{n_shards} shards")
    c = np.arange(n_clusters, dtype=np.int32)
    return placement_mod.Placement(
        order=c.reshape(-1, n_shards).T.reshape(-1).copy(),
        shard_of=c % n_shards, local_slot=c // n_shards, n_shards=n_shards,
        per_shard=n_clusters // n_shards,
        load=np.zeros(n_shards, np.float64))


class SearchStep:
    """``build_search_step``'s step: call it as
    ``step(placed, centroids, rotation, vectors, queries, n_valid=None)``
    -> (RerankResult (Q, k), hops (S, cap), dropped lanes). With a mesh,
    every rank calls it with its own ``placed`` (its model block) and
    ``vectors`` (its DP block under the owner rerank, else all of them);
    the origin passes the queries, the others None. ``collectives`` counts
    this rank's collectives since its last ``reset``."""

    def __init__(self, s: AnnsScale, n_shards: int, scan: str, mesh,
                 owner_rerank: bool, mode: str):
        if s.n_clusters % n_shards:
            raise ValueError(f"{s.n_clusters} clusters do not split over "
                             f"{n_shards} shards")
        if owner_rerank and mesh is None:
            raise ValueError("the owner-computes rerank needs a mesh")
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names)
            if "model" not in names or not _dp_axes(mesh) or \
                    set(names) - {"model", *DP}:
                raise ValueError(f"the step's mesh has a 'model' axis and "
                                 f"('pod',) 'data' axes, got {names}")
            m = mesh.shape[names.index("model")]
            if n_shards % m:
                raise ValueError(f"{n_shards} shards do not split over "
                                 f"{m} model ranks")
        self.s, self.n_shards, self.mesh = s, n_shards, mesh
        self.owner_rerank = owner_rerank
        self.scfg = engine.SearchConfig(nprobe=s.nprobe, ef=s.ef, k=s.k,
                                        max_iters=s.max_iters, scan=scan,
                                        mode=mode)
        self.capacity = int(np.ceil(s.queries * s.nprobe / n_shards * 2.0))
        self.collectives = Collectives()

    def _maps(self, device):
        c = torch.arange(self.s.n_clusters, dtype=torch.int32, device=device)
        return c % self.n_shards, c // self.n_shards

    def route(self, queries, centroids, n_valid=None):
        """(valid, lane_q, lane_cl, inv, dropped): the cluster filter and
        ``engine.route_lanes`` at the step's capacity, round-robin maps."""
        s = self.s
        probe, _ = ivf.cluster_filter(queries, centroids, nprobe=s.nprobe)
        valid = None if n_valid is None else torch.arange(
            s.queries, device=queries.device) < int(n_valid)
        shard_of, local_slot = self._maps(queries.device)
        return (valid, *engine.route_lanes(
            probe, shard_of, local_slot, valid, n_shards=self.n_shards,
            capacity=self.capacity))

    def _finish(self, out, valid):
        if valid is None:
            return out
        return rerank_mod.RerankResult(
            torch.where(valid[:, None], out.ids, -1),
            torch.where(valid[:, None], out.dists, float("inf")))

    def __call__(self, placed, centroids, rotation, vectors, queries,
                 n_valid=None):
        if self.mesh is not None:
            return self._mesh_step(placed, centroids, rotation, vectors,
                                   queries, n_valid)
        s = self.s
        if tuple(queries.shape) != (s.queries, s.dim):
            raise ValueError(f"queries {tuple(queries.shape)}, the step "
                             f"takes ({s.queries}, {s.dim})")
        valid, lane_q, lane_cl, inv, dropped = self.route(
            queries, centroids, n_valid)
        st = engine.ShardState(placed, None, None, rotation, vectors)
        gids, hops = engine.search_lanes(st, self.scfg, queries, lane_q,
                                         lane_cl)
        cand = engine.gather_candidates(gids, inv)
        out = rerank_mod.rerank(queries, cand, vectors, k=s.k)
        return self._finish(out, valid), hops, dropped

    def _mesh_step(self, placed, centroids, rotation, vectors, queries,
                   n_valid):
        s, mesh, coll = self.s, self.mesh, self.collectives
        names = list(mesh.mesh_dim_names)
        coord = mesh.get_coordinate()
        d, n_dp = _dp_index(mesh, coord)
        n_model = mesh.shape[names.index("model")]
        m = coord[names.index("model")]
        per = self.n_shards // n_model
        if self.owner_rerank and (s.n % n_dp or vectors.shape[0] != s.n //
                                  n_dp):
            raise ValueError(f"{s.n} vectors do not split into {n_dp} "
                             f"blocks of {vectors.shape[0]} over "
                             f"{_dp_axes(mesh)}")
        if placed.codes.shape[0] != per:
            raise ValueError(f"a model rank holds {per} shards, got "
                             f"{placed.codes.shape[0]}")
        dev = centroids.device
        every = tuple(names)
        # 1. the origin's queries to every rank
        queries = queries.to(dev) if not any(coord) else \
            torch.empty((s.queries, s.dim), dtype=torch.float32, device=dev)
        queries = broadcast_from(queries, every, 0, mesh=mesh, counts=coll)
        # 2. every rank routes from the same bits
        valid, lane_q, lane_cl, inv, dropped = self.route(
            queries, centroids, n_valid)
        # 3. this rank's lanes of its own shards; no collective
        cap = self.capacity
        width = -(-cap // n_dp)

        def lanes_of(dd):
            return dd * cap // n_dp, (dd + 1) * cap // n_dp
        lo, hi = lanes_of(d)
        rows = slice(m * per, (m + 1) * per)
        st = engine.ShardState(placed, None, None, rotation, vectors)
        gids, hops = engine.search_lanes(
            st, self.scfg, queries, lane_q[rows, lo:hi].contiguous(),
            lane_cl[rows, lo:hi].contiguous())
        # 4. one all_gather of every rank's lanes: (ef) ids and the hops
        mine = torch.full((per, width, s.ef + 1), -1, dtype=torch.int32,
                          device=dev)
        mine[:, :hi - lo, :s.ef] = gids.reshape(per, hi - lo, s.ef)
        mine[:, :hi - lo, s.ef] = hops
        parts = all_gather(mine, every, mesh=mesh, counts=coll)
        full = torch.empty((self.n_shards, cap, s.ef + 1), dtype=torch.int32,
                           device=dev)
        # part i is the rank of the i-th smallest global rank
        flat = np.argsort(mesh.mesh.reshape(-1).numpy(), kind="stable")
        for part, p in zip(parts, flat):
            c = np.unravel_index(p, tuple(mesh.shape))
            dd, _ = _dp_index(mesh, c)
            mm = int(c[names.index("model")])
            a, b = lanes_of(dd)
            full[mm * per:(mm + 1) * per, a:b] = part[:, :b - a]
        hops = full[:, :, s.ef].contiguous()
        cand = engine.gather_candidates(
            full[:, :, :s.ef].reshape(self.n_shards * cap, s.ef), inv)
        # 5. the rerank
        if self.owner_rerank:
            out = sharded_rerank(queries, cand, vectors, mesh, n_total=s.n,
                                 k=s.k, coll=coll)
        else:
            out = rerank_mod.rerank(queries, cand, vectors, k=s.k)
        return self._finish(out, valid), hops, dropped


def build_search_step(s: AnnsScale, n_shards: int, scan: str = "beam",
                      mesh=None, owner_rerank: bool = False,
                      mode: str = "mulfree") -> SearchStep:
    """The search step over a round-robin placed index (``round_robin``):
    ``step(placed, centroids, rotation, vectors, queries, n_valid=None)``.
    ``n_valid`` masks the pad queries of a batch padded to ``s.queries``
    out of routing, search and rerank (their rows come back -1 / inf),
    at the capacity of the whole batch, as the JAX package's masked step
    does. With ``mesh`` (axes 'model' and ('pod',) 'data'), one process a
    rank: see the module's docstring."""
    return SearchStep(s, n_shards, scan, mesh, owner_rerank, mode)


def place_step_inputs(mesh, placed, vectors, centroids, rotation, *,
                      owner_rerank: bool = True, device="cuda") -> tuple:
    """The step's first four arguments on this rank, on ``device``, from
    the origin's (flat mesh position 0; the others pass None for the
    four): its model block of the placed index, the centroids, the
    rotation, and its DP block of the vectors (all of them without the
    owner rerank).
    Placed one leaf at a time through ``elastic.place``, each block moved
    to ``device`` as it arrives, so the host holds one leaf's blocks at a
    time."""
    group, ranks = elastic.mesh_ranks(mesh)
    origin = ranks[0] == dist.get_rank()
    leaves, structure = tree_flatten(placed,
                                     is_leaf=lambda x: hasattr(x, "shape"))
    box = [len(leaves) if origin else None, structure]
    dist.broadcast_object_list(box, src=ranks[0], group=group)
    n, structure = box
    specs = placed_index_spec_tree(placed) if origin else None
    spec_leaves = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0] \
        if origin else [None] * n

    def one(x, spec):
        got = elastic.place(x, spec, mesh)
        return got.to_local().to(device)
    out = [one(leaves[i] if origin else None, spec_leaves[i])
           for i in range(n)]
    vspec = P(DP, None) if owner_rerank else P()
    vectors = one(vectors, vspec if origin else None)
    return (tree_unflatten(structure, out),
            one(centroids, P() if origin else None),
            one(rotation, P() if origin else None), vectors)


def lower_anns(mesh, s: AnnsScale | None = None, scan: str = "beam",
               owner_rerank: bool = False, masked: bool = False,
               mode: str = "mulfree"):
    """The step of ``build_search_step`` run once on meta tensors as the
    origin of ``mesh`` (an ``AccountingMesh``, or a mesh's names and
    shape: ``launch.mesh.production_shape``), at the scale ``s`` (SIFT1B
    by default): the JAX package's ``lower_anns``, which lowers the step
    through XLA on the production mesh. Returns (``op_stats.OpTotals`` of
    the rank, the step's collectives included, its argument bytes, ``s``).

    The argument bytes are what the rank holds: its model block of the
    placed index, the replicated centroids and rotation, its DP block of
    the queries (the batch's share a rank holds, as the reference's
    in_shardings give it; the origin reads the whole batch to broadcast
    it), and the vectors, its DP block under ``owner_rerank`` (then the
    argument bytes are ``footprint``'s) or all of them without (the port's
    plain rerank reads every row). ``masked`` passes ``n_valid`` (the
    shape-stable serving variant). The beam search is costed at
    ``max_iters`` hops a lane, the gemv scan at every row valid
    (``kernels/cost.py``)."""
    from . import op_stats
    s = s or AnnsScale()
    if not is_accounting(mesh):
        mesh = AccountingMesh(mesh.mesh_dim_names, mesh.shape)
    n_shards = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    placed, host = index_specs(s, n_shards, mode)
    placed = blocks_of(placed, placed_index_spec_tree(placed), mesh)
    vectors = blocks_of(host["vectors"], P(DP, None), mesh) \
        if owner_rerank else host["vectors"]
    args = (placed, host["centroids"], host["rotation"], vectors,
            host["queries"])
    step = build_search_step(s, n_shards, scan, mesh,
                             owner_rerank=owner_rerank, mode=mode)
    _, totals = op_stats.count(step, *args,
                               n_valid=s.queries if masked else None)
    for kind, (calls, nbytes) in step.collectives.counts.items():
        totals.coll_by_op[kind] = totals.coll_by_op.get(kind, 0.0) + nbytes
        totals.coll_calls[kind] = totals.coll_calls.get(kind, 0) + calls
    totals.coll_bytes = float(sum(totals.coll_by_op.values()))
    held = (*args[:4], blocks_of(host["queries"], P(DP, None), mesh))
    arg_bytes = sum(t.numel() * t.element_size() for t in tree_flatten(
        held, is_leaf=lambda x: hasattr(x, "shape"))[0])
    return totals, arg_bytes, s


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def account_lines(s: AnnsScale | None = None, mode: str = "mulfree"
                  ) -> list[str]:
    """One line a production mesh: the bytes a rank holds (computed from
    shapes, not measured)."""
    from . import mesh as lmesh
    s = s or AnnsScale()
    lines = []
    for multi in (False, True):
        shape = lmesh.production_shape(multi_pod=multi)
        fp = footprint(shape, s, mode)
        gb = {k: v / 1e9 for k, v in fp.items()}
        lines.append(
            f"SIFT1B ({s.n} x {s.dim}, {s.n_clusters} clusters x "
            f"{s.budget} slots, degree {s.degree}, {mode}) on "
            f"{dict(zip(shape.mesh_dim_names, shape.shape))}: a rank holds "
            f"{gb['index']:.3f} GB of index + {gb['vectors']:.3f} GB of "
            f"vectors + {gb['queries'] * 1e3:.3f} MB of queries + "
            f"{(gb['centroids'] + gb['rotation']) * 1e3:.3f} MB of "
            f"centroids and rotation = {gb['total']:.3f} GB (computed from "
            f"shapes)")
    return lines


def _run(args) -> None:
    """Under torchrun: the origin builds an index at the given scale, the
    ranks take their blocks, and the step runs ``args.steps`` times."""
    from ..core import compact_index
    from ..data import synthetic
    from . import mesh as lmesh
    dev = lmesh.init_from_env(device=args.device)
    if dev is None:
        raise SystemExit("run under torchrun (or pass --account)")
    try:
        mesh = lmesh.make_mesh((args.data, args.model), ("data", "model"),
                               device=args.device)
        origin = dist.get_rank() == 0
        n_shards = args.model
        placed = vectors = centroids = rotation = q = gt = None
        budget = 0
        if origin:
            x, _ = synthetic.clustered_vectors(args.seed, args.n, args.dim,
                                               args.clusters)
            q = torch.from_numpy(synthetic.query_set(args.seed, x,
                                                     args.queries)).to(dev)
            icfg = compact_index.IndexConfig(dim=args.dim,
                                             n_clusters=args.clusters,
                                             degree=args.degree)
            idx, host = compact_index.build_compact_index(
                torch.Generator(device=dev).manual_seed(args.seed),
                torch.from_numpy(x).to(dev), icfg)
            gt = synthetic.ground_truth(host.vectors, q, args.k)
            placed = engine._place(idx, round_robin(args.clusters, n_shards),
                                   backends_mod.get_backend(args.mode))
            vectors, centroids, rotation = host.vectors, idx.centroids, \
                idx.rotation
            budget = idx.budget
        box = [budget]
        dist.broadcast_object_list(box, src=0)
        s = AnnsScale(n=args.n, dim=args.dim, n_clusters=args.clusters,
                      budget=box[0], degree=args.degree, nprobe=args.nprobe,
                      ef=args.ef, k=args.k, queries=args.queries)
        local = place_step_inputs(mesh, placed, vectors, centroids,
                                  rotation, device=dev)
        del placed, vectors
        step = build_search_step(s, n_shards, args.scan, mesh,
                                 owner_rerank=True, mode=args.mode)
        for i in range(args.steps):
            step.collectives.reset()
            kernel_ops.reset_launch_counts()
            t = time.perf_counter()
            out, hops, dropped = step(*local, q)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            if origin:
                hit = (out.ids.long()[:, :, None] == gt[:, None, :]).any(-1)
                print(f"step {i}: {ms:.2f} ms, QPS {1e3 * s.queries / ms:.1f}"
                      f", recall@{s.k} {float(hit.float().mean()):.4f}, "
                      f"dropped lanes {int(dropped)}, collectives "
                      f"{step.collectives.as_dict()}, launches "
                      f"{kernel_ops.launch_counts()}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--account", action="store_true",
                    help="print the SIFT1B bytes a rank holds on both "
                         "production meshes (no processes) and exit")
    ap.add_argument("--lower", action="store_true",
                    help="count the SIFT1B step of one rank on the "
                         "production meshes (lower_anns, no processes), "
                         "write one JSON a mesh to --out and exit")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--owner-rerank", action="store_true")
    ap.add_argument("--masked", action="store_true",
                    help="the shape-stable (n_valid-masked) step")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mode", default="mulfree",
                    choices=list(backends_mod.available_backends()))
    ap.add_argument("--scan", default="beam", choices=["beam", "gemv"])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=64)
    ap.add_argument("--degree", type=int, default=32)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--ef", type=int, default=40)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.account:
        for line in account_lines(mode=args.mode):
            print(line, flush=True)
        return
    if args.lower:
        lower_main(args)
        return
    _run(args)


def lower_main(args) -> list[dict]:
    """``--lower``: one record a production mesh, written to
    ``{out}/pimcqg-engine__{variant}__{mesh}.json`` as the JAX package's
    ``main`` writes it; counted from shapes, not measured."""
    import json
    import pathlib

    from . import mesh as lmesh
    from .roofline import RooflineTerms
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    recs = []
    for mp in {"single": [False], "multi": [True],
               "both": [False, True]}[args.mesh]:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        shape = lmesh.production_shape(multi_pod=mp)
        t0 = time.time()
        totals, arg_bytes, s = lower_anns(
            shape, scan=args.scan, owner_rerank=args.owner_rerank,
            masked=args.masked, mode=args.mode)
        chips = shape.size()
        terms = RooflineTerms(
            flops=totals.flops * chips, hbm_bytes=totals.bytes * chips,
            coll_bytes=totals.coll_bytes * chips, chips=chips,
            peak_flops=lmesh.PEAK_FLOPS_BF16, hbm_bw=lmesh.HBM_BW,
            link_bw=lmesh.ICI_BW, model_flops=model_flops(s))
        variant = f"serve_b1_{args.scan}" + \
            (f"_{args.mode}" if args.mode != "mulfree" else "") + \
            ("_ownrr" if args.owner_rerank else "") + \
            ("_masked" if args.masked else "")
        rec = dict(arch="pimcqg-engine", shape=variant, mesh=mesh_name,
                   status="ok", chips=chips,
                   memory={"argument_size_in_bytes": arg_bytes,
                           "footprint": footprint(shape, s, args.mode),
                           "activation_peak_bytes":
                               totals.activation_peak},
                   roofline=terms.as_dict(),
                   ops={"per_device_flops": totals.flops,
                        "per_device_bytes": totals.bytes,
                        "per_device_coll_bytes": totals.coll_bytes,
                        "coll_by_op": totals.coll_by_op,
                        "coll_calls": totals.coll_calls,
                        "kernels": totals.kernels},
                   measured=False, wall_s=round(time.time() - t0, 2))
        path = out / f"pimcqg-engine__{variant}__{mesh_name}.json"
        path.write_text(json.dumps(rec, indent=1, default=float))
        r = rec["roofline"]
        print(f"[pimcqg-engine|{variant}|{mesh_name}] ok ({rec['wall_s']}s)"
              f" bneck={r['bottleneck']} tc={r['t_compute_s']:.3e} "
              f"tm={r['t_memory_s']:.3e} tx={r['t_collective_s']:.3e} "
              f"args={arg_bytes / 1e9:.3f} GB (computed from shapes)",
              flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
