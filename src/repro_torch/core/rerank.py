"""Host-side exact rerank (counterpart of ``repro/core/rerank.py``).

The lanes return EF approximate candidates each; the rerank computes exact
squared distances for each query's candidate union, then the fused dedup +
top-k selection (the ``topk_select`` kernel) takes the final k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops as kernel_ops

__all__ = ["RerankResult", "exact_sqdist", "rerank"]


class RerankResult(NamedTuple):
    ids: torch.Tensor    # (Q, k) int32 global ids, -1 pad
    dists: torch.Tensor  # (Q, k) f32 exact squared distances


def exact_sqdist(queries: torch.Tensor, cand_ids: torch.Tensor,
                 vectors: torch.Tensor) -> torch.Tensor:
    """(Q, D) queries, (Q, C) global ids (-1 pad) -> (Q, C) f32
    q2 + c2 - 2 q.c, in the reference's form (pads read row 0)."""
    q2 = (queries * queries).sum(-1, keepdim=True)
    cand = vectors[cand_ids.clamp(0, vectors.shape[0] - 1).long()]
    c2 = (cand * cand).sum(-1)
    dots = torch.einsum("qd,qcd->qc", queries, cand)
    return q2 + c2 - 2.0 * dots


def rerank(queries: torch.Tensor, cand_ids: torch.Tensor,
           vectors: torch.Tensor, *, k: int) -> RerankResult:
    """Exact rerank; duplicates in ``cand_ids`` are deduped keep-first."""
    d2 = exact_sqdist(queries, cand_ids, vectors)
    ids, dists = kernel_ops.topk_select(cand_ids.contiguous(),
                                        d2.contiguous(), k=k)
    return RerankResult(ids, dists)
