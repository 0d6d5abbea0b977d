"""Wrapper of the CUDA ``topk_select`` kernel (``csrc/topk_select.cu``).

Counterpart of the Pallas kernel in ``repro/kernels/topk_select.py``. The
wrapper takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version in ``kernels/ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["topk_select", "MAX_C", "launches"]

MAX_C = 4096   # the kernel's shared-memory row limit (kMaxC in the source)
launches = 0   # kernel launches since the count was last set to 0


def _fn():
    fn = _build.library("topk_select").topk_select_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def topk_select(cand_ids: torch.Tensor, dists: torch.Tensor, *, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids (Q, k) int32, dists (Q, k) f32); semantics of
    ``ref.topk_select_ref``."""
    global launches
    dev = cand_ids.device
    if dev.type != "cuda":
        raise ValueError(f"topk_select kernel needs CUDA tensors, got {dev}")
    if cand_ids.dim() != 2 or cand_ids.dtype != torch.int32 \
            or not cand_ids.is_contiguous():
        raise ValueError("topk_select: cand_ids must be a contiguous (Q, C) "
                         f"int32 tensor, got {cand_ids.dtype} "
                         f"{tuple(cand_ids.shape)}")
    if dists.shape != cand_ids.shape or dists.dtype != torch.float32 \
            or dists.device != dev or not dists.is_contiguous():
        raise ValueError("topk_select: dists must be a contiguous float32 "
                         "tensor shaped and placed like cand_ids, got "
                         f"{dists.dtype} {tuple(dists.shape)} on "
                         f"{dists.device}")
    q, c = cand_ids.shape
    if c > MAX_C:
        raise ValueError(f"topk_select kernel takes at most {MAX_C} "
                         f"candidates per row, got {c}")
    if not 0 < k <= c:
        raise ValueError(f"k = {k} outside (0, {c}]")
    out_ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    if q == 0:
        return out_ids, out_d
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(cand_ids.data_ptr(), dists.data_ptr(), out_ids.data_ptr(),
                    out_d.data_ptr(), q, c, k, stream)
    if err != 0:
        raise RuntimeError(f"topk_select launch failed: CUDA error {err}")
    launches += 1
    return out_ids, out_d
