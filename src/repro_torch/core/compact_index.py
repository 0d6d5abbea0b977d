"""O1 — the PIM-friendly compact index (counterpart of
``repro/core/compact_index.py``).

Per node the compact index keeps its canonical RabitQ code, one additive
int32 ``f_add`` and its local adjacency; raw vectors stay in the host store
for the exact rerank. Clusters are padded to a common node budget, so the
index is a stack of dense (C, M, ...) tensors. The build runs on the
tensors' device and encodes a batch of clusters per call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import graph as graph_mod
from . import ivf, mulfree, rabitq

__all__ = ["CompactIndex", "HostStore", "IndexConfig", "build_compact_index",
           "encode_clusters", "CLUSTER_FIELDS", "symphonyqg_bytes_per_node",
           "compact_bytes_per_node", "footprint_report"]

INT_MAX = 2**31 - 1
# the per-cluster CompactIndex fields that ``encode_clusters`` produces
CLUSTER_FIELDS = ("codes", "f_add", "residual_norm", "cos_theta", "alpha",
                  "rho", "shift1", "shift2", "neighbors", "entry", "n_valid")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    dim: int
    n_clusters: int = 64
    degree: int = 32            # graph out-degree R
    knn_k: int = 64             # candidate pool for pruning
    prune_alpha: float = 1.2
    kmeans_iters: int = 12
    kmeans_sample: int = 0      # 0 = train on all points
    pad_quantile: float = 1.0   # cluster node budget = quantile of sizes

    @property
    def dim_padded(self) -> int:
        return self.dim + ((-self.dim) % 8)


class CompactIndex(NamedTuple):
    """Index tensors stacked over clusters (C = n_clusters, M = budget)."""
    codes: torch.Tensor          # (C, M, Dpad//8) uint8
    f_add: torch.Tensor          # (C, M) int32, INT_MAX on pad rows
    neighbors: torch.Tensor      # (C, M, R) int32 local ids, -1 pad
    entry: torch.Tensor          # (C,) int32 medoid
    n_valid: torch.Tensor        # (C,) int32
    node_ids: torch.Tensor       # (C, M) int32 local -> global id, -1 pad
    centroids: torch.Tensor      # (C, D) f32
    alpha: torch.Tensor          # (C,) f32
    rho: torch.Tensor            # (C,) f32
    shift1: torch.Tensor         # (C,) int32
    shift2: torch.Tensor         # (C,) int32
    residual_norm: torch.Tensor  # (C, M) f32
    cos_theta: torch.Tensor      # (C, M) f32, 1.0 on pad rows
    rotation: torch.Tensor       # (D, D) f32
    dim: int

    @property
    def n_clusters(self) -> int:
        return self.codes.shape[0]

    @property
    def budget(self) -> int:
        return self.codes.shape[1]

    def to(self, device) -> "CompactIndex":
        return CompactIndex(*(f.to(device) if isinstance(f, torch.Tensor)
                              else f for f in self))


class HostStore(NamedTuple):
    """Off-PIM data: raw vectors for the exact rerank."""
    vectors: torch.Tensor    # (N, D) f32, global-id addressed
    centroids: torch.Tensor  # (C, D) f32

    def to(self, device) -> "HostStore":
        return HostStore(self.vectors.to(device), self.centroids.to(device))


def _gather(x, node_ids):
    """(B, M) global ids, -1 pad -> (B, M, D) vectors with zero pad rows,
    (B, M) valid mask."""
    valid = node_ids >= 0
    return torch.where(valid[..., None], x[node_ids.clamp(min=0).long()],
                       0.0), valid


def _encode_codes(vecs, valid, centroids, rotation, cfg: IndexConfig):
    """B clusters at once: canonical codes and O3 constants."""
    codes = rabitq.encode(vecs, centroids, rotation, dim=cfg.dim)
    consts = mulfree.calibrate_alpha(codes.cos_theta, codes.residual_norm,
                                     valid)
    f_add = mulfree.fold_node_factor(codes.residual_norm)
    return dict(
        codes=codes.packed, f_add=torch.where(valid, f_add, INT_MAX),
        residual_norm=codes.residual_norm,
        cos_theta=torch.where(valid, codes.cos_theta, 1.0),
        alpha=consts.alpha, rho=consts.rho,
        shift1=consts.shifts.s1, shift2=consts.shifts.s2)


def _graph_batch(rows: int, cfg: IndexConfig, mem_bytes: int) -> int:
    """Clusters of ``rows`` padded rows per graph call, so that the call's
    tensors (the gathered vectors, the candidate lists and the (rows, C, C)
    occlusion table) stay near ``mem_bytes``; one block's kNN temporaries
    (``graph.KNN_BLOCK`` x rows distances and their sort) come on top."""
    c = cfg.knn_k
    per = rows * (4 * cfg.dim + c * c + 16 * c)
    return max(1, mem_bytes // per)


def _build_graphs(x, node_ids, sizes: np.ndarray, cfg: IndexConfig,
                  mem_bytes: int, out: dict | None = None,
                  at: torch.Tensor | None = None):
    """Cluster graphs (neighbors, entry, n_valid), written into ``out``'s
    tensors at rows ``at`` (new tensors by default), in batches of clusters
    of similar size padded only to the batch's largest member (at least
    knn_k + 1 rows), so the O(n^2) kNN costs the clusters' own sizes and
    not the budget's. A graph does not depend on the padding or on the
    batch (``graph.build_cluster_graph``), so each is the one the
    budget-padded build gives."""
    c, budget = node_ids.shape
    knn_k = min(cfg.knn_k, max(budget - 1, 1))
    if out is None:
        # a budget below degree + 1 leaves fewer candidates than R, and
        # then the adjacency is as narrow as the candidate list (as in the
        # reference)
        out = dict(neighbors=torch.empty((c, budget, min(cfg.degree, knn_k)),
                                         dtype=torch.int32, device=x.device),
                   entry=torch.empty(c, dtype=torch.int32, device=x.device),
                   n_valid=torch.empty(c, dtype=torch.int32,
                                       device=x.device))
        at = torch.arange(c, device=x.device)
    by_size = np.argsort(sizes, kind="stable")
    floor = min(budget, knn_k + 1)

    def rows(j):
        return max(int(sizes[by_size[j]]), floor)

    i = 0
    while i < c:
        step = _graph_batch(rows(i), cfg, mem_bytes)
        while step > 1 and _graph_batch(rows(min(i + step, c) - 1), cfg,
                                        mem_bytes) < step:
            step = _graph_batch(rows(min(i + step, c) - 1), cfg, mem_bytes)
        cids = torch.as_tensor(by_size[i:i + step], device=x.device)
        n_rows = rows(min(i + step, c) - 1)
        vecs, valid = _gather(x, node_ids[cids, :n_rows])
        g = graph_mod.build_cluster_graph(vecs, valid, r=cfg.degree,
                                          knn_k=knn_k,
                                          prune_alpha=cfg.prune_alpha)
        dest = at[cids]
        out["neighbors"][dest, :n_rows] = g.neighbors
        out["neighbors"][dest, n_rows:] = -1
        out["entry"][dest], out["n_valid"][dest] = g.entry, g.n_valid
        i += step
    return out["neighbors"], out["entry"], out["n_valid"]


def encode_clusters(x: torch.Tensor, node_ids: torch.Tensor,
                    centroids: torch.Tensor, rotation: torch.Tensor,
                    cfg: IndexConfig, *, mem_bytes: int = 8 << 30,
                    out: dict | None = None,
                    at: torch.Tensor | None = None) -> dict:
    """The one producer of cluster arrays: the index build, and the mutable
    index's construction, ``compact()`` and ``rebuild()``.

    node_ids (B, M) global ids into x's rows, each cluster's members first
    and -1 after them; centroids (B, D). Produces the ``CLUSTER_FIELDS`` of
    a CompactIndex at budget M: codes, f_add and cos_theta (INT_MAX / 1 on
    pad rows), residual_norm, the O3 constants, and the graph (neighbors,
    entry, n_valid), into new (B, ...) tensors, or written batch by batch
    into ``out``'s tensors at rows ``at`` (the mutable index's mirrors, so
    no second copy of them is made). Returns the dict written. A cluster's
    arrays are the same bits whichever other clusters share the call: its
    sums run in one fixed order and its graph's products one cluster at a
    time."""
    b, budget = node_ids.shape
    dev = x.device
    if out is None:
        w = cfg.dim_padded // 8
        r = min(cfg.degree, cfg.knn_k, max(budget - 1, 1))

        def new(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=dev)
        out = dict(codes=new(b, budget, w, dtype=torch.uint8),
                   f_add=new(b, budget),
                   residual_norm=new(b, budget, dtype=torch.float32),
                   cos_theta=new(b, budget, dtype=torch.float32),
                   alpha=new(b, dtype=torch.float32),
                   rho=new(b, dtype=torch.float32), shift1=new(b),
                   shift2=new(b), neighbors=new(b, budget, r), entry=new(b),
                   n_valid=new(b))
    if at is None:
        at = torch.arange(b, device=dev)
    step = max(1, mem_bytes // (16 * budget * cfg.dim))
    for c0 in range(0, b, step):
        vecs, valid = _gather(x, node_ids[c0:c0 + step])
        part = _encode_codes(vecs, valid, centroids[c0:c0 + step], rotation,
                             cfg)
        for k, v in part.items():
            out[k][at[c0:c0 + step]] = v
    sizes = (node_ids >= 0).sum(1).cpu().numpy()
    _build_graphs(x, node_ids, sizes, cfg, mem_bytes, out, at)
    return out


def build_compact_index(generator: torch.Generator, x: torch.Tensor,
                        cfg: IndexConfig, *, verbose: bool = False,
                        mem_bytes: int = 8 << 30
                        ) -> tuple[CompactIndex, HostStore]:
    """Offline index construction on ``x``'s device.

    x (N, D) float32; ``generator`` lives on the same device and draws the
    k-means sample and seeds and the rotation. ``mem_bytes`` bounds the
    temporaries of one encode or graph call."""
    if x.shape[1] != cfg.dim:
        raise ValueError(f"vectors of width {x.shape[1]} for an index of "
                         f"dim {cfg.dim}")
    x = x.to(torch.float32)
    dev = x.device
    km = ivf.kmeans(generator, x, cfg.n_clusters, iters=cfg.kmeans_iters,
                    sample=cfg.kmeans_sample)
    sizes = km.sizes.cpu().numpy()
    budget = int(np.quantile(sizes, cfg.pad_quantile)) \
        if cfg.pad_quantile < 1.0 else int(sizes.max())
    budget = max(budget, 2)
    if verbose:
        print(f"[index] {cfg.n_clusters} clusters, sizes min/med/max = "
              f"{sizes.min()}/{int(np.median(sizes))}/{sizes.max()}, "
              f"budget={budget}")
    rotation = rabitq.random_rotation(generator, cfg.dim, device=dev)

    # members of each cluster in ascending global id, cut to the budget
    order = torch.sort(km.assignment, stable=True).indices
    counts = km.sizes.long()
    start = torch.cumsum(counts, 0) - counts
    cl = km.assignment[order].long()
    pos = torch.arange(len(order), device=dev) - start[cl]
    keep = pos < budget
    node_ids = torch.full((cfg.n_clusters, budget), -1, dtype=torch.int32,
                          device=dev)
    node_ids[cl[keep], pos[keep]] = order[keep].to(torch.int32)

    out = encode_clusters(x, node_ids, km.centroids, rotation, cfg,
                          mem_bytes=mem_bytes)
    idx = CompactIndex(node_ids=node_ids, centroids=km.centroids,
                       rotation=rotation, dim=cfg.dim, **out)
    return idx, HostStore(vectors=x, centroids=km.centroids)


# ---------------------------------------------------------------------------
# Footprint accounting (paper Table II) — exact per-node byte math
# ---------------------------------------------------------------------------

def symphonyqg_bytes_per_node(dim: int, degree: int) -> int:
    """Fig 5(a): raw vector + per-EDGE codes/factors + neighbor ids."""
    code_bytes = (dim + 7) // 8
    return 4 * dim + degree * (code_bytes + 8 + 4)


def compact_bytes_per_node(dim: int, degree: int) -> int:
    """Fig 5(b): canonical code + f_add + neighbor ids (raw vectors on
    host)."""
    code_bytes = (dim + 7) // 8
    return code_bytes + 4 + degree * 4


def footprint_report(dim: int, degree: int, n: int, *, tombstoned: int = 0,
                     slab: int = 0) -> dict:
    """Per-node byte math with the live-vs-reclaimable split: ``n`` live
    nodes, ``tombstoned`` resident but reclaimable rows, ``slab`` free
    headroom rows."""
    per = compact_bytes_per_node(dim, degree)
    s = symphonyqg_bytes_per_node(dim, degree) * n
    live = per * n
    reclaimable = per * tombstoned
    reserved = per * slab
    return {"symphonyqg_bytes": s, "pimcqg_bytes": live,
            "reduction": s / live if live else float("inf"),
            "live_bytes": live, "reclaimable_bytes": reclaimable,
            "reserved_bytes": reserved,
            "resident_bytes": live + reclaimable + reserved}
