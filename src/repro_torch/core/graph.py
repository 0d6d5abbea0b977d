"""Per-cluster proximity graphs (counterpart of ``repro/core/graph.py``).

For a batch of B padded clusters at once: exact kNN inside each cluster,
Vamana-style robust pruning of every node's candidates down to R
neighbours, and the medoid as entry point. Adjacency holds local ids padded
with -1. ``link_new`` links appended nodes into one cluster's graph (the
mutable index's insert, one node after another); ``link_rounds`` does the
same for many clusters at once, bit for bit.

A cluster's graph is the same bits whichever clusters share its batch and
however far the batch pads it. Its two products (the kNN distances and its
candidates' pairwise distances) run one cluster at a time, at the cluster's
own row count, and every other sum runs in ``fixed_order``'s order, which
zero padding leaves unchanged. The link's sums all run in that order, so a
row links the same in a round of any size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fixed_order import fixed_order_sum

INVALID = -1
KNN_BLOCK = 2048   # rows of one cluster's kNN distances sorted at a time

__all__ = ["ClusterGraph", "build_cluster_graph", "link_new", "link_rounds",
           "INVALID"]


class ClusterGraph(NamedTuple):
    neighbors: torch.Tensor  # (B, N, R) int32 local ids, -1 pad
    entry: torch.Tensor      # (B,) int32 medoid
    n_valid: torch.Tensor    # (B,) int32


def _pair_sqdist(xc: torch.Tensor, mem_bytes: int = 1 << 30
                 ) -> torch.Tensor:
    """Squared distances among each row's candidates, xc (..., C, D) ->
    (..., C, C), as ||a||^2 + ||b||^2 - 2 a.b with every sum in one fixed
    order (the products taken elementwise, in chunks of rows that keep the
    (rows, C, C, D) temporary near ``mem_bytes``)."""
    *lead, c, d = xc.shape
    flat = xc.reshape(-1, c, d)
    n = fixed_order_sum(flat * flat)
    out = torch.empty((flat.shape[0], c, c), dtype=xc.dtype,
                      device=xc.device)
    step = max(1, mem_bytes // (8 * c * c * d))
    for s in range(0, flat.shape[0], step):
        f = flat[s:s + step]
        dot = fixed_order_sum(f[:, :, None, :] * f[:, None, :, :])
        ns = n[s:s + step]
        out[s:s + step] = ns[:, :, None] + ns[:, None, :] - 2.0 * dot
    return out.reshape(*lead, c, c)


def _prune_kept(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                occludes: torch.Tensor, r: int) -> torch.Tensor:
    """The occlusion walk of every row at once. cand_ids / cand_d (..., C)
    in distance order; occludes (..., C, C) bool, [i, j] = alpha * d(i, j) <
    d(node, j). Keep candidate i unless a kept one occludes it, until R are
    kept. Returns (..., R) kept ids in distance order, then -1."""
    c = cand_ids.shape[-1]
    kept = torch.zeros(cand_ids.shape, dtype=torch.bool,
                       device=cand_ids.device)
    kept_cnt = torch.zeros(cand_ids.shape[:-1], dtype=torch.int32,
                           device=cand_ids.device)
    occluded = torch.zeros_like(kept)
    finite = cand_d < float("inf")
    for i in range(c):
        can_keep = ~occluded[..., i] & (kept_cnt < r) & finite[..., i]
        kept[..., i] = can_keep
        kept_cnt += can_keep.to(torch.int32)
        occluded |= can_keep[..., None] & occludes[..., i, :]
    # kept ids first, in distance order; then -1
    order = torch.sort((~kept).to(torch.uint8), dim=-1, stable=True).indices
    out = torch.where(torch.gather(kept, -1, order),
                      torch.gather(cand_ids, -1, order), INVALID)
    return out[..., :r].to(torch.int32)


def _prune_rows(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                xc: torch.Tensor, r: int, prune_alpha: float
                ) -> torch.Tensor:
    """Robust pruning of rows whose candidates' vectors are given: cand_ids
    / cand_d (..., C), xc (..., C, D)."""
    dcc = _pair_sqdist(xc)
    return _prune_kept(cand_ids, cand_d,
                       prune_alpha * dcc < cand_d[..., None, :], r)


def _robust_prune_row(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                      x: torch.Tensor, r: int, prune_alpha: float
                      ) -> torch.Tensor:
    """One node's pruning (``graph._robust_prune_row`` of the JAX package):
    cand_ids / cand_d (C,) in distance order, x (M, D) -> (min(C, R),)
    kept ids, -1 pad. The single-row case of ``_prune_rows``: the same
    occlusion table, walked on the host (one row takes C dependent steps,
    each a handful of launches on a card)."""
    occ = (prune_alpha * _pair_sqdist(x[cand_ids.long()])
           < cand_d[None, :]).cpu().numpy()
    finite = (cand_d < float("inf")).cpu().numpy()
    ids = cand_ids.cpu().tolist()
    kept, occluded = [], np.zeros(len(ids), bool)
    for i in range(len(ids)):
        if not occluded[i] and len(kept) < r and finite[i]:
            kept.append(ids[i])
            occluded |= occ[i]
    width = min(len(ids), r)
    return torch.tensor(kept + [INVALID] * (width - len(kept)),
                        dtype=torch.int32, device=cand_ids.device)


def build_cluster_graph(x: torch.Tensor, valid: torch.Tensor, *, r: int = 32,
                        knn_k: int = 64, prune_alpha: float = 1.2
                        ) -> ClusterGraph:
    """Graphs of B padded clusters. x (B, N, D) node vectors with pad rows,
    valid (B, N) bool.

    A cluster's products run on its rows up to its last valid one (at least
    knn_k + 1): its graph does not depend on N or on the other clusters."""
    b, n, _ = x.shape
    dev = x.device
    knn_k = min(knn_k, max(n - 1, 1))
    norms = fixed_order_sum(x * x)                            # (B, N)
    ids = torch.zeros((b, n, knn_k), dtype=torch.int32, device=dev)
    cand_d = torch.full((b, n, knn_k), float("inf"), device=dev)
    occludes = torch.zeros((b, n, knn_k, knn_k), dtype=torch.bool,
                           device=dev)
    last = torch.where(valid, torch.arange(n, device=dev), -1).amax(-1)
    for i, top in enumerate(last.tolist()):
        m = min(n, max(top + 1, knn_k + 1))
        # a fresh copy: the products' kernels see the same shapes and
        # alignment wherever the cluster sits in the batch
        xi, ni = x[i, :m].clone(), norms[i, :m]
        invalid = ~valid[i, :m]
        # rows in blocks of KNN_BLOCK, so a block's (rows, m) distances and
        # their sort stay small at any cluster size
        for s0 in range(0, m, KNN_BLOCK):
            rows = torch.arange(s0, min(s0 + KNN_BLOCK, m), device=dev)
            # exact kNN (self and pads at inf); a stable sort keeps
            # lax.top_k's lower-index order on ties
            d = ni[rows, None] + ni[None, :] - 2.0 * (xi[rows] @ xi.T)
            d[rows - s0, rows] = float("inf")
            d.masked_fill_(invalid[None, :], float("inf"))
            dist, idx = torch.sort(d, dim=-1, stable=True)
            dist, idx = dist[:, :knn_k], idx[:, :knn_k]
            xc, nc = xi[idx], ni[idx]                      # (rows, k, D)
            dcc = nc[..., :, None] + nc[..., None, :] \
                - 2.0 * torch.bmm(xc, xc.transpose(1, 2))
            occludes[i, rows] = prune_alpha * dcc < dist[:, None, :]
            ids[i, rows], cand_d[i, rows] = idx.to(torch.int32), dist
    neigh = _prune_kept(ids, cand_d, occludes, r)
    # padded rows have no edges and no edge targets a padded row
    neigh = torch.where(valid[..., None], neigh, INVALID)
    tgt_ok = (neigh >= 0) & torch.gather(
        valid, 1, neigh.clamp(min=0).long().reshape(b, -1)
    ).reshape(neigh.shape)
    neigh = torch.where(tgt_ok, neigh, INVALID)

    # medoid entry point: the valid node nearest to the valid mean
    n_valid = valid.sum(-1)
    total = fixed_order_sum(torch.where(valid[..., None], x, 0.0)
                            .transpose(-1, -2))
    mean = total / n_valid.clamp(min=1)[..., None]
    d2m = fixed_order_sum((x - mean[:, None, :]) ** 2)
    d2m = torch.where(valid, d2m, float("inf"))
    entry = d2m.argmin(-1).to(torch.int32)
    return ClusterGraph(neigh.to(torch.int32), entry, n_valid.to(torch.int32))


# ---------------------------------------------------------------------------
# linking appended nodes (the mutable index's insert)
# ---------------------------------------------------------------------------

def _pad_row(row: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(row, (0, width - row.shape[-1]),
                                   value=INVALID)


def _lexsort_by_dist(cand: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The order of np.lexsort((cand, d)) along the last axis: by distance,
    ties by candidate id."""
    by_id = torch.sort(cand, dim=-1, stable=True).indices
    by_d = torch.sort(torch.gather(d, -1, by_id), dim=-1, stable=True).indices
    return torch.gather(by_id, -1, by_d)


def link_new(neighbors: torch.Tensor, x: torch.Tensor, occ: int, slots, *,
             r: int, knn_k: int, prune_alpha: float) -> None:
    """Link appended nodes into one cluster's graph, one after another
    (``MutableIndex._link_new`` of the JAX package), in place.

    neighbors (M, R) int32 local ids; x (M, D) the slots' vectors
    (tombstones keep theirs); occ the occupied prefix, the appended slots
    included. Each node's out-edges are the pruned kNN pool over the
    prefix, ordered by (distance, slot); each out-neighbour p gets the node
    as a backlink, appended when p's row has room, else p's row is
    re-pruned over its neighbours and the node, ordered by (distance, id).
    The plain version that ``link_rounds`` is held against."""
    width = neighbors.shape[-1]
    r = min(r, width)
    for m in slots:
        m = int(m)
        d = fixed_order_sum((x[:occ] - x[m]) ** 2)
        d[m] = float("inf")
        kk = min(knn_k, max(occ - 1, 1))
        dist, order = torch.sort(d, stable=True)
        pruned = _robust_prune_row(order[:kk].to(torch.int32), dist[:kk], x,
                                   r, prune_alpha)
        neighbors[m] = _pad_row(pruned, width)
        for p in pruned[pruned >= 0].tolist():
            nb = [v for v in neighbors[p].tolist() if v >= 0]
            if m in nb:
                continue
            if len(nb) < r:                  # room: plain append
                neighbors[p, len(nb)] = m
                continue
            cand = torch.tensor(nb + [m], dtype=torch.int32,
                                device=neighbors.device)
            dp = fixed_order_sum((x[cand.long()] - x[p]) ** 2)
            corder = _lexsort_by_dist(cand, dp)
            neighbors[p] = _pad_row(_robust_prune_row(
                cand[corder], dp[corder], x, r, prune_alpha), width)


def _prefix_sqdist(vectors, slot_gid, cl, occ, m, mem_bytes):
    """(A, max occ) squared distances from slot m[a] of cluster cl[a] to
    every slot of its occupied prefix (inf past it): the rows gathered flat
    and summed in the fixed order, ``mem_bytes`` of them at a time."""
    dev = vectors.device
    a = len(cl)
    width = int(occ.max())
    start = torch.cumsum(occ, 0) - occ
    row_a = torch.repeat_interleave(torch.arange(a, device=dev), occ)
    row_s = torch.arange(len(row_a), device=dev) - start[row_a]
    gid = slot_gid[cl[row_a], row_s].long()
    mgid = slot_gid[cl, m].long()[row_a]
    flat = torch.empty(len(row_a), dtype=vectors.dtype, device=dev)
    step = max(1, mem_bytes // (16 * vectors.shape[1]))
    for s in range(0, len(row_a), step):
        diff = vectors[gid[s:s + step]] - vectors[mgid[s:s + step]]
        flat[s:s + step] = fixed_order_sum(diff ** 2)
    d = torch.full((a, width), float("inf"), dtype=vectors.dtype, device=dev)
    d[row_a, row_s] = flat
    return d


def link_rounds(neighbors: torch.Tensor, slot_gid: torch.Tensor,
                vectors: torch.Tensor, clusters: torch.Tensor,
                base: torch.Tensor, count: torch.Tensor, *, r: int,
                knn_k: int, prune_alpha: float,
                mem_bytes: int = 1 << 30) -> None:
    """``link_new`` for many clusters at once, in place, bit for bit.

    neighbors (C, M, R) and slot_gid (C, M) are the index's, vectors its
    store; cluster clusters[i] gained count[i] nodes at slots base[i] ... .
    Clusters share nothing while they link, so round j links the j-th
    appended node of every cluster that has one: its kNN pool, its pruning
    and then its backlinks, whose rows are distinct, each as one batch."""
    if len(clusters) == 0:
        return
    dev = neighbors.device
    width = neighbors.shape[-1]
    r = min(r, width)
    clusters, base, count = (t.to(dev).long() for t in (clusters, base,
                                                         count))
    occ = base + count
    for j in range(int(count.max())):
        act = count > j
        cl, oc, m = clusters[act], occ[act], base[act] + j
        a = torch.arange(len(cl), device=dev)
        # the kNN pool over each occupied prefix, by (distance, slot)
        d = _prefix_sqdist(vectors, slot_gid, cl, oc, m, mem_bytes)
        d[a, m] = float("inf")
        dist, order = torch.sort(d, dim=-1, stable=True)
        c = min(knn_k, d.shape[1])
        kk = torch.clamp(oc - 1, min=1).clamp(max=knn_k)
        cand = order[:, :c]
        cd = torch.where(torch.arange(c, device=dev) < kk[:, None],
                         dist[:, :c], float("inf"))
        xc = vectors[slot_gid[cl[:, None], cand].long().clamp(min=0)]
        pruned = _pad_row(_prune_rows(cand.to(torch.int32), cd, xc, r,
                                      prune_alpha), width)
        neighbors[cl, m] = pruned
        # backlinks: every (node, out-neighbour p) pair of the round
        sel = pruned >= 0
        pa, p = torch.nonzero(sel, as_tuple=True)[0], pruned[sel].long()
        bc, bm = cl[pa], m[pa]
        rows = neighbors[bc, p]
        skip = (rows == bm[:, None]).any(-1)
        cnt = (rows >= 0).sum(-1)
        app = ~skip & (cnt < r)
        neighbors[bc[app], p[app], cnt[app]] = bm[app].to(torch.int32)
        # full rows re-prune over their neighbours and the node, in chunks
        # of rows whose (rows, R + 1, D) vectors stay near mem_bytes / 16
        full = torch.nonzero(~skip & (cnt >= r)).flatten()
        step = max(1, mem_bytes // (16 * (r + 1) * vectors.shape[1] * 4))
        for f in torch.split(full, step):
            fc, fp, fm = bc[f], p[f], bm[f]
            cand = torch.cat([rows[f][:, :r], fm[:, None].to(torch.int32)],
                             1)
            xv = vectors[slot_gid[fc[:, None], cand.long()].long()]
            xp = vectors[slot_gid[fc, fp].long()]
            dp = fixed_order_sum((xv - xp[:, None, :]) ** 2)
            corder = _lexsort_by_dist(cand, dp)
            xs = torch.gather(xv, 1, corder[..., None].expand_as(xv))
            neighbors[fc, fp] = _pad_row(_prune_rows(
                torch.gather(cand, 1, corder), torch.gather(dp, 1, corder),
                xs, r, prune_alpha), width)
