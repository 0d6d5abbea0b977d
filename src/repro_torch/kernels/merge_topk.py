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

__all__ = ["merge_topk", "MAX_W", "launches"]

MAX_W = 4096   # the kernel's shared-memory row limit (kMaxW in the source)
launches = 0   # kernel launches since the count was last set to 0


def _fn():
    fn = _build.library("merge_topk").merge_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def merge_topk(part_ids: torch.Tensor, part_dists: torch.Tensor, *, k: int,
               run: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids (Q, k) int32, dists (Q, k) f32); semantics of
    ``ref.merge_topk_ref``."""
    global launches
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
    if w > MAX_W:
        raise ValueError(f"merge_topk kernel takes at most {MAX_W} slots per "
                         f"row, got {w}")
    if not 0 < k <= w:
        raise ValueError(f"k = {k} outside (0, {w}]")
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
