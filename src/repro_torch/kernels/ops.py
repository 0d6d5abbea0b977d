"""The kernel seam: dispatch by device.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version in ``kernels/ref.py``. There is no size threshold, no
environment switch and no fallback: a kernel that fails to build or launch
raises. (The JAX package sends small problems to XLA even on a TPU; here
one launch runs the beam search of every lane, so the kernel carries every
search.)
The attention kernel's argument checks (``flash_attn.check_args``) run on
both routes.
"""

from __future__ import annotations

import torch

from . import beam_search as _beam
from . import binary_ip as _binary_ip
from . import cluster_scan as _scan
from . import flash_attn as _flash
from . import merge_topk as _merge
from . import ref as _ref
from . import topk_select as _topk
from .ranks import O3Rank

__all__ = ["binary_ip_rank", "ranked_beam_search", "beam_search",
           "ranked_cluster_scan", "cluster_scan", "topk_select",
           "merge_topk", "flash_attention", "launch_counts",
           "reset_launch_counts"]

_KERNELS = {"binary_ip_rank": _binary_ip, "topk_select": _topk,
            "merge_topk": _merge, "cluster_scan": _scan,
            "flash_attention": _flash, "beam_search": _beam}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def binary_ip_rank(codes, f_add, rows, lut, sumq, s1, s2, dim: int
                   ) -> torch.Tensor:
    """O3 mulfree rank of (L, R) gathered rows; see
    ``ref.binary_ip_rank_ref`` for the exact semantics."""
    if _on_cuda(codes):
        return _binary_ip.binary_ip_rank(codes, f_add, rows, lut, sumq, s1,
                                         s2, dim)
    return _ref.binary_ip_rank_ref(codes, f_add, rows, lut, sumq, s1, s2, dim)


def ranked_beam_search(codes, rank, nbrs, base_rows, entry, active,
                       dim: int, ef: int, max_iters: int, m: int):
    """The whole beam search of every lane, each hop ranked by the rank
    tuple ``rank`` (``kernels/ranks.py``: mulfree, hamming or exact); see
    ``ref.ranked_beam_search_ref`` for the exact semantics."""
    if _on_cuda(codes):
        return _beam.ranked_beam_search(codes, rank, nbrs, base_rows, entry,
                                        active, dim, ef, max_iters, m)
    return _ref.ranked_beam_search_ref(codes, rank, nbrs, base_rows, entry,
                                       active, dim, ef, max_iters, m)


def beam_search(codes, f_add, nbrs, base_rows, entry, lut, sumq, s1, s2,
                active, dim: int, ef: int, max_iters: int, m: int):
    """The whole mulfree beam search of every lane: ``ranked_beam_search``
    with ``O3Rank(f_add, lut, sumq, s1, s2)``."""
    return ranked_beam_search(codes, O3Rank(f_add, lut, sumq, s1, s2), nbrs,
                              base_rows, entry, active, dim, ef, max_iters, m)


def ranked_cluster_scan(codes, rank, base_rows, n_valid, active, dim: int,
                        ef: int, m: int):
    """Whole-cluster rank + top-EF of every lane by the rank tuple
    ``rank``; see ``ref.ranked_cluster_scan_ref`` for the exact
    semantics."""
    if _on_cuda(codes):
        return _scan.ranked_cluster_scan(codes, rank, base_rows, n_valid,
                                         active, dim, ef, m)
    return _ref.ranked_cluster_scan_ref(codes, rank, base_rows, n_valid,
                                        active, dim, ef, m)


def cluster_scan(codes, f_add, base_rows, n_valid, lut, sumq, s1, s2, active,
                 dim: int, ef: int, m: int):
    """Whole-cluster O3 rank + top-EF of every lane: ``ranked_cluster_scan``
    with ``O3Rank(f_add, lut, sumq, s1, s2)``."""
    return ranked_cluster_scan(codes, O3Rank(f_add, lut, sumq, s1, s2),
                               base_rows, n_valid, active, dim, ef, m)


def topk_select(cand_ids, dists, *, k: int):
    """Fused dedup + top-k over (Q, C) candidate rows; see
    ``ref.topk_select_ref`` for the exact semantics. On CUDA a row wider
    than ``topk_select.MAX_C`` (4,096) columns is selected in chunked
    passes, which hold those semantics only when every occurrence of an id
    carries one distance and no id's distance is NaN or -inf (the rerank
    meets both); such a row that breaks them raises ValueError there."""
    if _on_cuda(cand_ids):
        return _topk.topk_select(cand_ids, dists, k=k)
    return _ref.topk_select_ref(cand_ids, dists, k=k)


def merge_topk(part_ids, part_dists, *, k: int, run: int | None = None):
    """Top-k of the owners' partial top-k runs (the sharded tier's origin
    merge); see ``ref.merge_topk_ref`` for the exact semantics."""
    if _on_cuda(part_ids):
        return _merge.merge_topk(part_ids, part_dists, k=k, run=run)
    return _ref.merge_topk_ref(part_ids, part_dists, k=k, run=run)


def flash_attention(q, k, v, *, causal: bool, window: int | None = None,
                    q_offset: int = 0, kv_valid_len: int | None = None,
                    return_lse: bool = False):
    """Masked online-softmax attention forward, (B, Sq, Hq, dv) in q.dtype,
    and with ``return_lse`` the rows' logsumexp (B, Hq, Sq) float32 beside
    it; see ``ref.flash_attention_ref`` for the semantics."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len)
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, return_lse=return_lse, **kw)
    _flash.check_args(q, k, v, **kw)
    return _ref.flash_attention_ref(q, k, v, return_lse=return_lse, **kw)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the counts were last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
