"""Wrapper of the CUDA ``merge_topk`` kernel (``csrc/merge_topk.cu``).

Counterpart of the Pallas kernel ``merge_topk`` in
``repro/kernels/topk_select.py``. The wrapper takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to the plain version in
``kernels/ref.py``.

Two routes of one launch, chosen from the row width W and k alone
(``topk_select.route_for``, the same limits): the warp route (one warp a
row, a register top-k) and the block route (a bitonic sort of the row in
shared memory) up to MAX_W slots. Neither gives way to the other or to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .topk_select import ROUTES, route_for

__all__ = ["merge_topk", "merge_tree", "smem_bytes", "MAX_W", "launches"]

MAX_W = 4096   # the block route's row limit (kMaxW in the source)
launches = 0   # kernel launches since the count was last set to 0


def _lib():
    return _build.library("merge_topk")


def _fn():
    fn = _lib().merge_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(w: int, route: str) -> int:
    """Dynamic shared memory of one block of ``route`` at row width w."""
    fn = _lib().merge_topk_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(w, ROUTES.index(route))


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
            run: int, route: str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch over rows of at most MAX_W slots, by ``route``
    (``route_for(W, k)`` when None; tests name one to hold both routes on
    the same rows). ``run`` is not read: the kernel takes any slot order."""
    global launches
    dev = part_ids.device
    q, w = part_ids.shape
    route = route_for(w, k) if route is None else route
    if route not in ROUTES or (route == "warp" and route_for(w, k) != "warp"):
        raise ValueError(f"merge_topk: route {route!r} cannot take W = {w}, "
                         f"k = {k}")
    out_ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    if q == 0:
        return out_ids, out_d
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(part_ids.data_ptr(), part_dists.data_ptr(),
                    out_ids.data_ptr(), out_d.data_ptr(), q, w, k,
                    ROUTES.index(route), stream)
    if err != 0:
        raise RuntimeError(f"merge_topk launch ({route} route) failed: CUDA "
                           f"error {err}")
    launches += 1
    return out_ids, out_d
