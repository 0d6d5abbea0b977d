"""In-PU greedy beam search over the compact index (counterpart of
``repro/core/beam_search.py``).

A lane is one (query, probed cluster) pair. The JAX package vmaps a
per-lane ``lax.while_loop``; here all L lanes run in lock-step: each hop
updates the lanes that are still live (hop cap not reached, an unexpanded
beam entry left) and freezes the rest, and the loop ends when no lane is
live. Every hop ranks the neighbours of all lanes with ONE call of the
backend's ranking kernel.

``shard`` is the placed index with shard and cluster axes flattened to one
(S*Cl,) axis; ``cl`` (L,) are the lanes' flat cluster ids; ``lanes`` is the
backend's lane bundle of (L, ...) tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .backends import LaneConfig, RankingBackend

__all__ = ["BeamResult", "beam_search_lane", "full_scan_lane"]


class BeamResult(NamedTuple):
    ids: torch.Tensor   # (L, EF) int32 local node ids, -1 pad
    rank: torch.Tensor  # (L, EF) ranks, pad = backend.pad_rank
    hops: torch.Tensor  # (L,) int32 expansions performed


def _update_visited(visited: torch.Tensor, nbrs: torch.Tensor) -> None:
    """The reference's visited update, reproduced exactly and in place.

    The reference scatters ``visited[clip(nbrs, 0)] |= nbrs >= 0``, so every
    -1 slot also writes visited[0] with its OLD value, and XLA applies
    duplicate scatters in order (last writer wins). So local node 0 ends
    True only if it already was, or a real 0 is in the row with no -1 slot
    after it; every real id > 0 ends True. Ids > 0 go through a scatter
    whose duplicate writes all write True (order-free); -1 and 0 slots
    write into a sink column M."""
    l, r = nbrs.shape
    m = visited.shape[1] - 1
    sink = torch.where(nbrs > 0, nbrs.clamp(max=m - 1), m).long()
    visited.scatter_(1, sink, True)
    pos = torch.arange(r, device=nbrs.device)
    last = torch.where(nbrs <= 0, pos, -1).amax(-1)            # (L,)
    last_is_zero = torch.gather(nbrs, 1, last.clamp(min=0)[:, None])[:, 0] == 0
    visited[:, 0] |= (last >= 0) & last_is_zero


def beam_search_lane(shard, cl: torch.Tensor, lanes, *,
                     backend: RankingBackend, cfg: LaneConfig,
                     active: torch.Tensor | None = None) -> BeamResult:
    """Greedy beam search of every lane over its cluster, in lock-step.
    ``active`` (L,) bool marks lanes to search (default all); the others
    do no work and report 0 hops."""
    n_lanes = cl.shape[0]
    m = shard.neighbors.shape[-2]
    dev = cl.device
    pad = backend.pad_rank
    cl = cl.long()
    li = torch.arange(n_lanes, device=dev)
    if active is None:
        active = torch.ones(n_lanes, dtype=torch.bool, device=dev)

    entry = shard.entry[cl]                                     # (L,) i32
    beam_ids = torch.full((n_lanes, cfg.ef), -1, dtype=torch.int32,
                          device=dev)
    beam_ids[:, 0] = entry
    beam_rank = torch.full((n_lanes, cfg.ef), pad, dtype=backend.rank_dtype,
                           device=dev)
    beam_rank[:, 0] = backend.rank_ids(shard, cl, entry[:, None], lanes,
                                       cfg.dim)[:, 0]
    expanded = torch.zeros((n_lanes, cfg.ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((n_lanes, m + 1), dtype=torch.bool, device=dev)
    visited[li, entry.long()] = True
    hops = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    no_exp = torch.zeros((n_lanes, shard.neighbors.shape[-1]),
                         dtype=torch.bool, device=dev)

    for _ in range(cfg.max_iters):
        # pick the best unexpanded beam entry (argmin: first minimum)
        frontier = torch.where(expanded, pad, beam_rank)
        sel = frontier.argmin(-1)
        live = active & (frontier[li, sel] < pad)
        if not bool(live.any()):
            break
        node = beam_ids[li, sel]
        nbrs = shard.neighbors[cl, node.clamp(min=0).long()]    # (L, R)
        seen = torch.gather(visited, 1, nbrs.clamp(0, m - 1).long())
        fresh = (nbrs >= 0) & ~seen & (node >= 0)[:, None] & live[:, None]
        nbrs = torch.where(fresh, nbrs, -1)
        _update_visited(visited, nbrs)
        nrank = backend.rank_ids(shard, cl, nbrs, lanes, cfg.dim)

        # merge beam + neighbours, keep the best EF (stable: ties keep order)
        exp_sel = expanded.clone()
        exp_sel[li, sel] = True
        all_ids = torch.cat([beam_ids, nbrs], dim=1)
        all_rank = torch.cat([beam_rank, nrank], dim=1)
        all_exp = torch.cat([exp_sel, no_exp], dim=1)
        take = torch.sort(all_rank, dim=1, stable=True).indices[:, :cfg.ef]
        keep = live[:, None]
        beam_ids = torch.where(keep, torch.gather(all_ids, 1, take), beam_ids)
        beam_rank = torch.where(keep, torch.gather(all_rank, 1, take),
                                beam_rank)
        expanded = torch.where(keep, torch.gather(all_exp, 1, take), expanded)
        hops += live.to(torch.int32)
    return BeamResult(beam_ids, beam_rank, hops)


def full_scan_lane(shard, cl: torch.Tensor, lanes, *,
                   backend: RankingBackend, cfg: LaneConfig,
                   active: torch.Tensor | None = None) -> BeamResult:
    """GEMV-mode scan of every lane's whole cluster through the backend's
    ``scan_cluster``: the EF best ranks, ties to the lower node id.
    Inactive lanes report 0 hops."""
    m = shard.codes.shape[-2]
    if active is None:
        active = torch.ones(cl.shape[0], dtype=torch.bool, device=cl.device)
    ids, rank = backend.scan_cluster(shard, cl.long(), lanes, cfg.dim,
                                     cfg.ef, active)
    hops = torch.where(active, m, 0).to(torch.int32)
    return BeamResult(ids, rank, hops)
