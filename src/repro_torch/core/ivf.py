"""IVF clustering and cluster filtering (counterpart of ``repro/core/ivf.py``).

k-means++ seeding and Lloyd iterations run on the tensors' device, chunked
so the (N, K) distance matrix never exists whole. Every float32 matmul here
runs at full precision: the caller keeps TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["KMeansResult", "kmeans", "assign", "cluster_filter",
           "adaptive_keep_mask"]

_CHUNK = 1 << 16   # rows per distance block in assign / Lloyd


class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # (K, D) f32
    assignment: torch.Tensor  # (N,) int32
    sizes: torch.Tensor       # (K,) int32


def _sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (K, D) -> (N, K) squared distances, matmul form."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    return x2 + c2[None, :] - 2.0 * (x @ c.T)


def _kmeanspp_init(generator: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding: each next centroid is drawn with probability
    proportional to its squared distance to the nearest one so far."""
    n = x.shape[0]
    idx = torch.empty(k, dtype=torch.int64, device=x.device)
    idx[0] = torch.randint(n, (1,), generator=generator,
                           device=generator.device)[0]
    d2 = ((x - x[idx[0]]) ** 2).sum(-1)
    for i in range(1, k):
        probs = d2 / d2.sum().clamp(min=1e-12)
        idx[i] = torch.multinomial(probs, 1, generator=generator)[0]
        d2 = torch.minimum(d2, ((x - x[idx[i]]) ** 2).sum(-1))
    return x[idx]


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment, (N, D) -> (N,) int32 (first minimum)."""
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], _CHUNK):
        out[s:s + _CHUNK] = _sqdist(x[s:s + _CHUNK], centroids).argmin(-1)
    return out


def kmeans(generator: torch.Generator, x: torch.Tensor, k: int, *,
           iters: int = 16, sample: int = 0) -> KMeansResult:
    """Lloyd's k-means with k-means++ init. ``sample`` > 0 seeds and
    iterates on a random subsample of that size, then assigns every point."""
    x = x.to(torch.float32)
    train = x
    if sample and sample < x.shape[0]:
        perm = torch.randperm(x.shape[0], generator=generator,
                              device=generator.device)
        train = x[perm[:sample].to(x.device)]
    cents = _kmeanspp_init(generator, train, k)
    for _ in range(iters):
        a = assign(train, cents).long()
        sums = torch.zeros_like(cents).index_add_(0, a, train)
        cnts = torch.bincount(a, minlength=k).to(torch.float32)
        new = sums / cnts.clamp(min=1.0)[:, None]
        cents = torch.where((cnts > 0)[:, None], new, cents)  # keep empties
    a = assign(x, cents)
    sizes = torch.bincount(a.long(), minlength=k).to(torch.int32)
    return KMeansResult(cents, a, sizes)


def cluster_filter(queries: torch.Tensor, centroids: torch.Tensor, *,
                   nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``nprobe`` nearest centroids per query: (Q, D) -> ids (Q, nprobe)
    int32, squared distances. A stable sort keeps ``lax.top_k``'s
    lower-index order on ties."""
    d2 = _sqdist(queries, centroids)
    dist, ids = torch.sort(d2, dim=-1, stable=True)
    return ids[:, :nprobe].to(torch.int32), dist[:, :nprobe]


def adaptive_keep_mask(probe_dists: torch.Tensor, *, tau: float,
                       min_probes: int = 1, ladder: tuple = ()
                       ) -> torch.Tensor:
    """Per-query adaptive early termination: probe j survives while
    d2_j <= tau * d2_0, floored at ``min_probes`` and rounded up to the next
    rung of ``ladder``. (Q, P) f32 ascending -> (Q, P) bool prefix mask."""
    p = probe_dists.shape[-1]
    n = (probe_dists <= tau * probe_dists[:, :1]).sum(-1)
    n = n.clamp(min=min_probes)
    if ladder:
        rungs = torch.tensor(sorted(ladder), dtype=torch.int64,
                             device=probe_dists.device)
        idx = torch.searchsorted(rungs, n)              # first rung >= n
        n = rungs[idx.clamp(0, len(ladder) - 1)]
    n = n.clamp(1, p)
    return torch.arange(p, device=probe_dists.device)[None, :] < n[:, None]
