"""IVF clustering and cluster filtering (counterpart of ``repro/core/ivf.py``).

k-means++ seeding and Lloyd iterations run on the tensors' device, chunked
so the (N, K) distance matrix never exists whole. Every float32 matmul here
runs at full precision: the caller keeps TF32 off. A Lloyd step sums each
cluster's members in one fixed order (``fixed_order.segment_sum``), so a
seed builds the same centroids, bit for bit, on every run on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fixed_order import segment_sum

__all__ = ["KMeansResult", "kmeans", "assign", "cluster_filter",
           "adaptive_keep_mask", "owner_split_op", "split_probes_by_owner",
           "choose_owners", "owner_tables", "owner_tables_op"]

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
        a = assign(train, cents)
        sums = segment_sum(train, a, k)
        cnts = torch.bincount(a.long(), minlength=k).to(torch.float32)
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


def owner_split_op(probe_cids: torch.Tensor, owner_of: torch.Tensor,
                   local_cid: torch.Tensor, live: torch.Tensor, *,
                   n_owners: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The owner split of :func:`split_probes_by_owner` as one broadcast
    compare on the tensors' device. ``live`` (Q, P) bool masks probes
    (all-True for none). Returns tables (O, Q, P) int32 local cluster ids
    with -1 holes, touches (Q, O) bool."""
    hole = probe_cids < 0
    safe = torch.where(hole, 0, probe_cids).long()         # avoid -1 wrap
    own = torch.where(hole | ~live, -1, owner_of[safe].long())   # (Q, P)
    local = torch.where(own >= 0, local_cid[safe].long(), -1)
    owners = torch.arange(n_owners, device=own.device)[:, None, None]
    tables = torch.where(own[None] == owners, local[None], -1).to(
        torch.int32)
    touches = (tables >= 0).any(dim=2).T                   # (Q, O)
    return tables, touches


def split_probes_by_owner(probe_cids: np.ndarray, owner_of: np.ndarray,
                          local_cid: np.ndarray, n_owners: int,
                          live: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Scatter-routing split of the IVF top-probe selection (host side).

    ``probe_cids`` (Q, P) global cluster ids (-1 = hole, kept a hole in
    every table), ``owner_of`` (C,) owning engine per cluster and
    ``local_cid`` (C,) the cluster's id within its owner -> tables
    (O, Q, P) int32 per-owner probe tables in LOCAL ids, -1 where the probe
    belongs to another owner (each engine's ``search_probed`` payload), and
    touches (Q, O) bool, the owners each query scatters to. ``live`` (Q, P)
    bool masks probes out. The multi-owner (C, R) maps of a replicated
    placement (``Placement.owners_of`` / ``locals_of``) route each probe to
    ONE owning shard through :func:`choose_owners`, so per-query probe sets
    stay disjoint; single-column maps give the 1-D path's tables."""
    owner_of = np.asarray(owner_of)
    if owner_of.ndim == 2:
        own, local, _ = choose_owners(probe_cids, owner_of,
                                      np.asarray(local_cid),
                                      n_owners=n_owners, live=live)
        return owner_tables(own, local, n_owners)
    probe_cids = np.asarray(probe_cids)
    hole = probe_cids < 0
    safe = np.where(hole, 0, probe_cids)                   # avoid -1 wrap
    own = np.where(hole, -1, owner_of[safe])               # (Q, P)
    if live is not None:
        own = np.where(live, own, -1)
    local = np.where(own >= 0, np.asarray(local_cid)[safe], -1)
    return owner_tables(own, local, n_owners)


def choose_owners(probe_cids: np.ndarray, owners_of: np.ndarray,
                  locals_of: np.ndarray, *, n_owners: int,
                  live: np.ndarray | None = None,
                  load: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pick ONE owning shard per probe over a multi-owner (replicated)
    cluster map — the origin-scatter half of hot-cluster replication.

    ``owners_of``/``locals_of`` are (C, R): column 0 the primary owner,
    later columns replica owners (-1 = fewer owners). Deterministic greedy,
    query-major, two goals in order:

      1. collapse fanout — each query repeatedly routes the largest group
         of its still-unassigned probes that some single owner can serve
         (a fully-replicated hot probe set lands on ONE shard instead of
         scattering);
      2. balance load — ties pick the owner with the fewest routed
         queries so far (then the lowest shard id), and the counter
         updates as it assigns, spreading successive hot queries across
         the replica owners.

    A probe whose cluster has a single owner always routes to it, so with
    no replicated clusters the choice is bit-identical to
    ``owner_of[cid]`` routing. ``live`` (Q, P) masks probes out; ``load``
    (O,) optionally seeds the per-owner routed-query counters (updated in
    place if given). Returns (own (Q, P), local (Q, P), load (O,)); holes
    and masked probes are -1 in both outputs."""
    probe_cids = np.asarray(probe_cids)
    owners_of = np.asarray(owners_of)
    locals_of = np.asarray(locals_of)
    q_n, p_n = probe_cids.shape
    r_n = owners_of.shape[1]
    if load is None:
        load = np.zeros(n_owners, np.int64)
    hole = probe_cids < 0
    if live is not None:
        hole = hole | ~np.asarray(live, bool)
    safe = np.where(probe_cids < 0, 0, probe_cids)
    opts = np.where(hole[:, :, None], -1, owners_of[safe])   # (Q, P, R)
    locs = np.where(hole[:, :, None], -1, locals_of[safe])
    own = np.full((q_n, p_n), -1, np.int32)
    local = np.full((q_n, p_n), -1, np.int32)
    for i in range(q_n):
        todo = [j for j in range(p_n) if not hole[i, j]]
        while todo:
            # coverage: how many unassigned probes each owner could serve
            cover = np.zeros(n_owners, np.int64)
            for j in todo:
                for r in range(r_n):
                    o = opts[i, j, r]
                    if o >= 0:
                        cover[o] += 1
            best = max(range(n_owners),
                       key=lambda o: (cover[o], -load[o], -o))
            if cover[best] == 0:
                break                                      # defensive
            took = False
            rest = []
            for j in todo:
                r = next((r for r in range(r_n)
                          if opts[i, j, r] == best), None)
                if r is None:
                    rest.append(j)
                    continue
                own[i, j] = best
                local[i, j] = locs[i, j, r]
                took = True
            if took:
                load[best] += 1        # one more query routed to ``best``
            todo = rest
    return own, local, load


def owner_tables(own: np.ndarray, local: np.ndarray, n_owners: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-owner probe tables from explicit per-probe (owner, local id)
    choices: (tables (O, Q, P) int32, touches (Q, O) bool)."""
    tables = np.stack([np.where(own == o, local, -1).astype(np.int32)
                       for o in range(n_owners)])
    touches = (tables >= 0).any(axis=2).T                  # (Q, O)
    return tables, touches


def owner_tables_op(own: torch.Tensor, local: torch.Tensor, *,
                    n_owners: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor twin of :func:`owner_tables`, on the tensors' device: the
    broadcast compare of :func:`owner_split_op` over PRE-CHOSEN owners
    (own, local (Q, P), -1 where a probe has none). Returns (tables
    (O, Q, P) int32, touches (Q, O) bool)."""
    owners = torch.arange(n_owners, dtype=own.dtype,
                          device=own.device)[:, None, None]
    tables = torch.where(own[None] == owners, local[None], -1).to(
        torch.int32)
    touches = (tables >= 0).any(dim=2).T                   # (Q, O)
    return tables, touches
