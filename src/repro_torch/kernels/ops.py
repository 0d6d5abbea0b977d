"""The kernel seam: dispatch by device.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version in ``kernels/ref.py``. There is no size threshold, no
environment switch and no fallback: a kernel that fails to build or launch
raises. (The JAX package sends small problems to XLA even on a TPU; here
one launch runs the beam search of every lane, so the kernel carries every
search.)
The attention kernel's argument checks (``flash_attn.check_args``) run on
both routes.

A meta tensor (the dry-run, ``launch/op_stats.py``) takes a third route:
no kernel and no plain version runs; the call returns outputs of the
kernel's shapes and types (``torch.empty`` on the meta device) and reports
the kernel's work, ``kernels/cost.py``'s count at these shapes, to
``cost.record``. Where the work depends on the data it is the bound
without data: ``cost.beam_search_worst`` (every lane ``max_iters`` hops)
and ``cost.cluster_scan_worst`` (every row valid). It counts no launch.
"""

from __future__ import annotations

import torch

from . import beam_search as _beam
from . import cost as _cost
from . import binary_ip as _binary_ip
from . import cluster_scan as _scan
from . import flash_attn as _flash
from . import merge_topk as _merge
from . import ref as _ref
from . import topk_select as _topk
from .ranks import O3Rank, dtype_of

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


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _same_rows(k: torch.Tensor, v: torch.Tensor) -> bool:
    """v is a view of k's own rows (MLA's latent cache: counted once)."""
    return (k.untyped_storage()._cdata == v.untyped_storage()._cdata
            and k.stride() == v.stride()
            and k.storage_offset() == v.storage_offset())


def binary_ip_rank(codes, f_add, rows, lut, sumq, s1, s2, dim: int
                   ) -> torch.Tensor:
    """O3 mulfree rank of (L, R) gathered rows; see
    ``ref.binary_ip_rank_ref`` for the exact semantics."""
    if _on_meta(codes):
        _cost.record("binary_ip_rank", _cost.binary_ip_rank(
            slots=rows.numel(), real_slots=rows.numel(),
            distinct_rows=min(rows.numel(), codes.shape[0]),
            live_lanes=rows.shape[0], w=codes.shape[1], dim=dim,
            lut_width=lut.shape[-1]))
        return _empty(rows.shape, torch.int32)
    if _on_cuda(codes):
        return _binary_ip.binary_ip_rank(codes, f_add, rows, lut, sumq, s1,
                                         s2, dim)
    return _ref.binary_ip_rank_ref(codes, f_add, rows, lut, sumq, s1, s2, dim)


def ranked_beam_search(codes, rank, nbrs, base_rows, entry, active,
                       dim: int, ef: int, max_iters: int, m: int):
    """The whole beam search of every lane, each hop ranked by the rank
    tuple ``rank`` (``kernels/ranks.py``: mulfree, hamming or exact); see
    ``ref.ranked_beam_search_ref`` for the exact semantics."""
    if _on_meta(codes):
        n = entry.shape[0]
        _cost.record("beam_search", _cost.beam_search_worst(
            kind=rank.kind, w=codes.shape[1], r=nbrs.shape[1], ef=ef,
            n_lanes=n, max_iters=max_iters, table_rows=nbrs.shape[0]))
        return (_empty((n, ef), torch.int32), _empty((n, ef), dtype_of(rank)),
                _empty((n,), torch.int32))
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
    if _on_meta(codes):
        n = base_rows.shape[0]
        _cost.record("cluster_scan", _cost.cluster_scan_worst(
            kind=rank.kind, w=codes.shape[1], ef=ef, n_lanes=n, m=m))
        return _empty((n, ef), torch.int32), _empty((n, ef), dtype_of(rank))
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
    if _on_meta(cand_ids):
        q, c = cand_ids.shape
        _cost.record("topk_select", _cost.topk_select(q, c, k))
        return _empty((q, k), torch.int32), _empty((q, k), torch.float32)
    if _on_cuda(cand_ids):
        return _topk.topk_select(cand_ids, dists, k=k)
    return _ref.topk_select_ref(cand_ids, dists, k=k)


def merge_topk(part_ids, part_dists, *, k: int, run: int | None = None):
    """Top-k of the owners' partial top-k runs (the sharded tier's origin
    merge); see ``ref.merge_topk_ref`` for the exact semantics."""
    if _on_meta(part_ids):
        q, w = part_ids.shape
        _cost.record("merge_topk", _cost.merge_topk(q, w, k))
        return _empty((q, k), torch.int32), _empty((q, k), torch.float32)
    if _on_cuda(part_ids):
        return _merge.merge_topk(part_ids, part_dists, k=k, run=run)
    return _ref.merge_topk_ref(part_ids, part_dists, k=k, run=run)


def flash_attention(q, k, v, *, causal: bool, window: int | None = None,
                    q_offset: int = 0, kv_valid_len: int | None = None,
                    return_lse: bool = False, softcap: float = 0.0):
    """Masked online-softmax attention forward, (B, Sq, Hq, dv) in q.dtype,
    and with ``return_lse`` the rows' logsumexp (B, Hq, Sq) float32 beside
    it; ``softcap`` > 0 caps the scaled scores (0 is off); see
    ``ref.flash_attention_ref`` for the semantics."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len, softcap=softcap)
    if _on_meta(q):
        _flash.check_args(q, k, v, **kw)
        b, sq, hq, dk = q.shape
        _cost.record("flash_attention", _cost.flash_attention(
            b=b, sq=sq, sk=k.shape[1], hq=hq, hkv=k.shape[2], dk=dk,
            dv=v.shape[-1], q_bytes=q.element_size(),
            kv_bytes=k.element_size(), alias=_same_rows(k, v), **kw))
        out = _empty((b, sq, hq, v.shape[-1]), q.dtype)
        return (out, _empty((b, hq, sq), torch.float32)) if return_lse \
            else out
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
