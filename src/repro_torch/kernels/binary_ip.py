"""Wrapper of the CUDA ``binary_ip_rank`` kernel (``csrc/binary_ip.cu``).

Counterpart of the Pallas kernel in ``repro/kernels/binary_ip.py``. The
wrapper takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version in ``kernels/ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["binary_ip_rank", "launches"]

launches = 0   # kernel launches since the count was last set to 0


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"binary_ip_rank: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _fn():
    fn = _build.library("binary_ip").binary_ip_rank_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def binary_ip_rank(codes: torch.Tensor, f_add: torch.Tensor,
                   rows: torch.Tensor, lut: torch.Tensor, sumq: torch.Tensor,
                   s1: torch.Tensor, s2: torch.Tensor, dim: int
                   ) -> torch.Tensor:
    """(L, R) int32 ranks; semantics of ``ref.binary_ip_rank_ref``."""
    global launches
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(
            f"binary_ip_rank kernel needs CUDA tensors, got {dev}")
    t, w = codes.shape
    n_lanes, n_rows = rows.shape
    if not 0 < dim <= 8 * w:
        raise ValueError(f"dim {dim} outside (0, {8 * w}] for W = {w}")
    if t >= 2**31:
        raise ValueError(f"code table of {t} rows exceeds int32 row ids")
    _check("codes", codes, torch.uint8, (t, w), dev)
    _check("f_add", f_add, torch.int32, (t,), dev)
    _check("rows", rows, torch.int32, (n_lanes, n_rows), dev)
    _check("lut", lut, torch.int32, (n_lanes, 8 * w), dev)
    for name, v in (("sumq", sumq), ("s1", s1), ("s2", s2)):
        _check(name, v, torch.int32, (n_lanes,), dev)
    out = torch.empty((n_lanes, n_rows), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    vec16 = int(w % 16 == 0 and codes.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(codes.data_ptr(), f_add.data_ptr(), rows.data_ptr(),
                    lut.data_ptr(), sumq.data_ptr(), s1.data_ptr(),
                    s2.data_ptr(), out.data_ptr(), n_lanes, n_rows, w, dim,
                    t, vec16, stream)
    if err != 0:
        raise RuntimeError(f"binary_ip_rank launch failed: CUDA error {err}")
    launches += 1
    return out
