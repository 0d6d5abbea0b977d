"""In-PU greedy beam search over the compact index (counterpart of
``repro/core/beam_search.py``).

A lane is one (query, probed cluster) pair. The JAX package vmaps a
per-lane ``lax.while_loop``; here the backend's ``search_lanes`` searches
all L lanes at once: the mulfree backend in one ``beam_search`` kernel
launch, the base class in the plain lock-step loop
(``kernels/ref.py`` ``lockstep_beam_search``), one ranking call a hop.

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


def beam_search_lane(shard, cl: torch.Tensor, lanes, *,
                     backend: RankingBackend, cfg: LaneConfig,
                     active: torch.Tensor | None = None) -> BeamResult:
    """Greedy beam search of every lane over its cluster, through the
    backend's ``search_lanes``. ``active`` (L,) bool marks lanes to search
    (default all); the others do no work and report 0 hops."""
    if active is None:
        active = torch.ones(cl.shape[0], dtype=torch.bool, device=cl.device)
    return BeamResult(*backend.search_lanes(shard, cl.long(), lanes, cfg,
                                            active))


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
