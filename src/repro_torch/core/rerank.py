"""Host-side exact rerank (counterpart of ``repro/core/rerank.py``).

The lanes return EF approximate candidates each; the rerank computes exact
squared distances for each query's candidate union, then the fused dedup +
top-k selection (the ``topk_select`` kernel) takes the final k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fixed_order
from ..kernels import ops as kernel_ops

__all__ = ["RerankResult", "exact_sqdist", "rerank"]


class RerankResult(NamedTuple):
    ids: torch.Tensor    # (Q, k) int32 global ids, -1 pad
    dists: torch.Tensor  # (Q, k) f32 exact squared distances


def exact_sqdist(queries: torch.Tensor, cand_ids: torch.Tensor,
                 vectors: torch.Tensor) -> torch.Tensor:
    """(Q, D) queries, (Q, C) global ids (-1 pad: reads row 0) -> (Q, C)
    f32 squared distances, the sum of (q - c)^2 in one fixed order
    (``fixed_order.fixed_order_sum``), so a query's distances are the same
    bits in any batch: the sharded tier's partial rerank of a query equals
    the single engine's. The JAX package sums q2 + c2 - 2 q.c; the two
    agree within that form's cancellation error, a few ulps of q2 + c2."""
    cand = vectors[cand_ids.clamp(0, vectors.shape[0] - 1).long()]
    diff = queries[:, None, :] - cand
    return fixed_order.fixed_order_sum(diff * diff)


def rerank(queries: torch.Tensor, cand_ids: torch.Tensor,
           vectors: torch.Tensor, *, k: int) -> RerankResult:
    """Exact rerank; duplicates in ``cand_ids`` are deduped keep-first."""
    d2 = exact_sqdist(queries, cand_ids, vectors)
    ids, dists = kernel_ops.topk_select(cand_ids.contiguous(),
                                        d2.contiguous(), k=k)
    return RerankResult(ids, dists)
