"""Wrapper of the CUDA ``merge_topk`` kernel (``csrc/merge_topk.cu``).

Counterpart of the Pallas kernel ``merge_topk`` in
``repro/kernels/topk_select.py``. The wrapper takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to the plain version in
``kernels/ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["merge_topk", "merge_tree", "MAX_W", "launches"]

MAX_W = 4096   # the kernel's shared-memory row limit (kMaxW in the source)
launches = 0   # kernel launches since the count was last set to 0


def _fn():
    fn = _build.library("merge_topk").merge_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def merge_tree(merge, part_ids: torch.Tensor, part_dists: torch.Tensor, *,
               k: int, run: int, max_w: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of rows wider than ``max_w`` slots as a tree of passes of
    ``merge(ids, dists, k=..., run=...)``, a function that takes rows of at
    most ``max_w`` slots and computes ``ref.merge_topk_ref``.

    The row is cut into contiguous groups of whole runs (of ``max_w`` slots
    where one run is wider), each group gives its min(k, width) best slots
    in (distance, column) order, and the group outputs, concatenated in
    group order, are merged again until one pass holds them. Exact for
    every input: the k best of a row are among the k best of the groups
    that hold them, a group's output keeps the (distance, column) order of
    its slots, and the concatenation keeps the groups in column order, so a
    tie between two groups still goes to the lower column. A non-finite
    distance keeps its value (id -1), which sorts where it did.

    Needs k <= max_w // 2 when the row is wider than ``max_w``, so that each
    level at least halves the width; a larger k raises NotImplementedError
    (ROADMAP C3)."""
    w = part_ids.shape[1]
    if w <= max_w:
        return merge(part_ids, part_dists, k=k, run=run)
    if not 0 < k <= max_w // 2:
        raise NotImplementedError(
            f"merge_topk of k = {k} over {w} > {max_w} slots: the merge "
            f"tree takes k <= {max_w // 2} (ROADMAP C3)")
    group = max_w // run * run if run <= max_w else max_w
    outs = [merge(part_ids[:, a:a + group].contiguous(),
                  part_dists[:, a:a + group].contiguous(),
                  k=min(k, w - a), run=min(group, w - a))
            for a in range(0, w, group)]
    ids = torch.cat([o[0] for o in outs], 1)
    return merge_tree(merge, ids, torch.cat([o[1] for o in outs], 1), k=k,
                      run=ids.shape[1], max_w=max_w)


def merge_topk(part_ids: torch.Tensor, part_dists: torch.Tensor, *, k: int,
               run: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids (Q, k) int32, dists (Q, k) f32); semantics of
    ``ref.merge_topk_ref``. Rows wider than MAX_W slots go through
    ``merge_tree``."""
    dev = part_ids.device
    if dev.type != "cuda":
        raise ValueError(f"merge_topk kernel needs CUDA tensors, got {dev}")
    if part_ids.dim() != 2 or part_ids.dtype != torch.int32 \
            or not part_ids.is_contiguous():
        raise ValueError("merge_topk: part_ids must be a contiguous (Q, W) "
                         f"int32 tensor, got {part_ids.dtype} "
                         f"{tuple(part_ids.shape)}")
    if part_dists.shape != part_ids.shape \
            or part_dists.dtype != torch.float32 \
            or part_dists.device != dev or not part_dists.is_contiguous():
        raise ValueError("merge_topk: part_dists must be a contiguous float32 "
                         "tensor shaped and placed like part_ids, got "
                         f"{part_dists.dtype} {tuple(part_dists.shape)} on "
                         f"{part_dists.device}")
    q, w = part_ids.shape
    if w % (k if run is None else run):
        raise ValueError(f"row width {w} is not a whole number of runs of "
                         f"{k if run is None else run}")
    if not 0 < k <= w:
        raise ValueError(f"k = {k} outside (0, {w}]")
    return merge_tree(_launch, part_ids, part_dists, k=k,
                      run=k if run is None else run, max_w=MAX_W)


def _launch(part_ids: torch.Tensor, part_dists: torch.Tensor, *, k: int,
            run: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch over rows of at most MAX_W slots."""
    global launches
    dev = part_ids.device
    q, w = part_ids.shape
    out_ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    if q == 0:
        return out_ids, out_d
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(part_ids.data_ptr(), part_dists.data_ptr(),
                    out_ids.data_ptr(), out_d.data_ptr(), q, w, k, stream)
    if err != 0:
        raise RuntimeError(f"merge_topk launch failed: CUDA error {err}")
    launches += 1
    return out_ids, out_d
