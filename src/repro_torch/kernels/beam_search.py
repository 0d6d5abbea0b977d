"""Wrapper of the CUDA ``beam_search`` kernel (``csrc/beam_search.cu``).

The whole beam search of every lane in one launch: the Pallas kernel
``binary_ip_rank`` in ``repro/kernels/binary_ip.py`` fused with the
per-lane loop of ``repro/core/beam_search.py`` that called it once a hop.
One warp runs one lane's loop to its own end, with the lane's rank state,
visited bitmap and beam in shared memory (or, where a lane's state
outgrows a block, in a global scratch this wrapper allocates). A hop's
neighbours rank by the rank tuple's policy (``kernels/ranks.py``): the O3
rank (mulfree), the popcount of code XOR qcode (hamming) or the float32
estimator (exact). The wrapper takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to the plain version
``ref.ranked_beam_search_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ranks
from .ranks import O3Rank

__all__ = ["ranked_beam_search", "beam_search", "scratch_bytes",
           "smem_bytes", "launches"]

launches = 0   # kernel launches since the count was last set to 0


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"beam_search: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _lib():
    return _build.library("beam_search")


def scratch_bytes(n_lanes: int, ef: int, r: int, m: int, w: int,
                  kind: str = "mulfree") -> int:
    """Global scratch the launch needs: 0 where a lane's state fits a
    block's shared memory."""
    fn = _lib().beam_search_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return int(fn(ranks.KIND_IDS[kind], n_lanes, ef, r, m, w))


def smem_bytes(ef: int, r: int, m: int, w: int,
               kind: str = "mulfree") -> int:
    """Dynamic shared memory of one block (0 on the scratch route)."""
    fn = _lib().beam_search_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return int(fn(ranks.KIND_IDS[kind], ef, r, m, w))


def _fn():
    fn = _lib().beam_search_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ranked_beam_search(codes: torch.Tensor, rank, nbrs: torch.Tensor,
                       base_rows: torch.Tensor, entry: torch.Tensor,
                       active: torch.Tensor, dim: int, ef: int,
                       max_iters: int, m: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ids (L, EF) int32, ranks (L, EF) of the rank's type, hops (L,)
    int32); semantics of ``ref.ranked_beam_search_ref``."""
    global launches
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"beam_search kernel needs CUDA tensors, got {dev}")
    t, w = codes.shape
    n_lanes = base_rows.shape[0]
    if nbrs.dim() != 2:
        raise ValueError(f"beam_search: nbrs must be (T, R), got "
                         f"{tuple(nbrs.shape)}")
    r = nbrs.shape[1]
    if not 0 < dim <= 8 * w:
        raise ValueError(f"dim {dim} outside (0, {8 * w}] for W = {w}")
    if ef < 1 or r < 1 or m < 1 or max_iters < 0:
        raise ValueError(f"beam_search needs ef, R and m >= 1 and max_iters "
                         f">= 0, got ef {ef}, R {r}, m {m}, max_iters "
                         f"{max_iters}")
    if t >= 2**31:
        raise ValueError(f"code table of {t} rows exceeds int32 row ids")
    _check("codes", codes, torch.uint8, (t, w), dev)
    _check("nbrs", nbrs, torch.int32, (t, r), dev)
    for name, v in (("base_rows", base_rows), ("entry", entry)):
        _check(name, v, torch.int32, (n_lanes,), dev)
    _check("active", active, torch.bool, (n_lanes,), dev)
    ranks.check("beam_search", rank, t, w, n_lanes, dev)
    out_ids = torch.empty((n_lanes, ef), dtype=torch.int32, device=dev)
    out_ranks = torch.empty((n_lanes, ef), dtype=ranks.dtype_of(rank),
                            device=dev)
    out_hops = torch.empty((n_lanes,), dtype=torch.int32, device=dev)
    if n_lanes == 0:
        return out_ids, out_ranks, out_hops
    nbytes = scratch_bytes(n_lanes, ef, r, m, w, rank.kind)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev) \
        if nbytes else None
    vec16 = int(w % 16 == 0 and codes.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(ranks.KIND_IDS[rank.kind], codes.data_ptr(),
                    *ranks.pointers(rank), nbrs.data_ptr(),
                    base_rows.data_ptr(), entry.data_ptr(),
                    active.data_ptr(), out_ids.data_ptr(),
                    out_ranks.data_ptr(), out_hops.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    n_lanes, r, w, dim, ef, max_iters, m, t, vec16,
                    ranks.sqrt_dim(dim), stream)
    if err != 0:
        raise RuntimeError(f"beam_search launch failed: CUDA error {err}")
    launches += 1
    return out_ids, out_ranks, out_hops


def beam_search(codes: torch.Tensor, f_add: torch.Tensor, nbrs: torch.Tensor,
                base_rows: torch.Tensor, entry: torch.Tensor,
                lut: torch.Tensor, sumq: torch.Tensor, s1: torch.Tensor,
                s2: torch.Tensor, active: torch.Tensor, dim: int, ef: int,
                max_iters: int, m: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mulfree search: ``ranked_beam_search`` with ``O3Rank(f_add,
    lut, sumq, s1, s2)``; semantics of ``ref.beam_search_ref``."""
    return ranked_beam_search(codes, O3Rank(f_add, lut, sumq, s1, s2), nbrs,
                              base_rows, entry, active, dim, ef, max_iters, m)
