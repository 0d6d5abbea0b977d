"""Per-cluster proximity graphs (counterpart of ``repro/core/graph.py``).

For a batch of B padded clusters at once: exact kNN inside each cluster,
Vamana-style robust pruning of every node's candidates down to R
neighbours, and the medoid as entry point. Adjacency holds local ids padded
with -1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID = -1

__all__ = ["ClusterGraph", "build_cluster_graph", "INVALID"]


class ClusterGraph(NamedTuple):
    neighbors: torch.Tensor  # (B, N, R) int32 local ids, -1 pad
    entry: torch.Tensor      # (B,) int32 medoid
    n_valid: torch.Tensor    # (B,) int32


def _sqdist_mat(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)
    return x2 + y2[..., None, :] - 2.0 * (x @ y.transpose(-1, -2))


def _knn(x: torch.Tensor, k: int, valid: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN ids/dists (excluding self) among valid rows, (B, N, k).
    A stable sort keeps ``lax.top_k``'s lower-index order on ties."""
    d = _sqdist_mat(x, x)
    n = x.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d = d.masked_fill(eye | ~valid[:, None, :], float("inf"))
    dist, ids = torch.sort(d, dim=-1, stable=True)
    return ids[..., :k].to(torch.int32), dist[..., :k]


def _robust_prune(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                  x: torch.Tensor, r: int, prune_alpha: float) -> torch.Tensor:
    """Occlusion pruning of every node of the batch at once.

    cand_ids / cand_d (B, N, C) in distance order. Walk the candidates in
    order; keep c unless an already-kept p occludes it (alpha * d(p, c) <
    d(node, c)), until R are kept. Returns (B, N, R) kept ids, -1 pad."""
    b, n, c = cand_ids.shape
    xc = torch.gather(x, 1, cand_ids.long().reshape(b, n * c, 1)
                      .expand(-1, -1, x.shape[-1])).reshape(b, n, c, -1)
    dcc = _sqdist_mat(xc, xc)                          # (B, N, C, C)
    kept = torch.zeros((b, n, c), dtype=torch.bool, device=x.device)
    kept_cnt = torch.zeros((b, n), dtype=torch.int32, device=x.device)
    occluded = torch.zeros((b, n, c), dtype=torch.bool, device=x.device)
    finite = cand_d < float("inf")
    for i in range(c):
        can_keep = ~occluded[..., i] & (kept_cnt < r) & finite[..., i]
        kept[..., i] = can_keep
        kept_cnt += can_keep.to(torch.int32)
        occluded |= can_keep[..., None] & (prune_alpha * dcc[..., i, :]
                                           < cand_d)
    # kept ids first, in distance order; then -1
    order = torch.sort((~kept).to(torch.uint8), dim=-1, stable=True).indices
    out = torch.where(torch.gather(kept, -1, order),
                      torch.gather(cand_ids, -1, order), INVALID)
    return out[..., :r].to(torch.int32)


def build_cluster_graph(x: torch.Tensor, valid: torch.Tensor, *, r: int = 32,
                        knn_k: int = 64, prune_alpha: float = 1.2
                        ) -> ClusterGraph:
    """Graphs of B padded clusters. x (B, N, D) node vectors with pad rows,
    valid (B, N) bool."""
    n = x.shape[-2]
    knn_k = min(knn_k, max(n - 1, 1))
    ids, d = _knn(x, knn_k, valid)
    neigh = _robust_prune(ids, d, x, r, prune_alpha)
    # padded rows have no edges and no edge targets a padded row
    neigh = torch.where(valid[..., None], neigh, INVALID)
    tgt_ok = (neigh >= 0) & torch.gather(
        valid, 1, neigh.clamp(min=0).long().reshape(neigh.shape[0], -1)
    ).reshape(neigh.shape)
    neigh = torch.where(tgt_ok, neigh, INVALID)

    # medoid entry point: the valid node nearest to the valid mean
    n_valid = valid.sum(-1)
    mean = torch.where(valid[..., None], x, 0.0).sum(-2) \
        / n_valid.clamp(min=1)[..., None]
    d2m = ((x - mean[:, None, :]) ** 2).sum(-1)
    d2m = torch.where(valid, d2m, float("inf"))
    entry = d2m.argmin(-1).to(torch.int32)
    return ClusterGraph(neigh.to(torch.int32), entry, n_valid.to(torch.int32))
