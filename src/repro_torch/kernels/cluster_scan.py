"""Wrapper of the CUDA ``cluster_scan`` kernel (``csrc/cluster_scan.cu``).

Counterpart of the Pallas kernel ``cluster_scan`` in
``repro/kernels/binary_ip.py``. One block per lane builds the lane's rank
state in shared memory and ranks each row of its cluster by the rank
tuple's policy (``kernels/ranks.py``): the O3 rank through partial-sum
tables (T[b][x], the LUT summed over the set bits of byte value x at code
byte b; nibble tables above W = 64), the popcount of code XOR qcode, or the
float32 estimator through float nibble tables. It keeps a running top-EF: a
row's 64-bit key (rank order, row) enters a candidate buffer only if it is
below the EF-th best key so far, and the buffer is merged into the top-EF
by a bitonic sort before it could overflow. The source note in
``csrc/cluster_scan.cu`` gives the layout and the filter's worst case. The
wrapper takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version in ``kernels/ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ranks
from .ranks import O3Rank

__all__ = ["ranked_cluster_scan", "cluster_scan", "smem_bytes", "max_smem",
           "max_ef", "MAX_DPAD", "launches"]

MAX_DPAD = 2048   # kMaxDpad: the widest LUT (W = 256, nibble tables)
launches = 0      # kernel launches since the count was last set to 0


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"cluster_scan: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _fn():
    fn = _build.library("cluster_scan").cluster_scan_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                             ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(w: int, ef: int, kind: str = "mulfree") -> int:
    """Dynamic shared memory of one block (keys and the lane's rank state)
    at code width W and EF, as the launch sizes it."""
    fn = _build.library("cluster_scan").cluster_scan_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(ranks.KIND_IDS[kind], w, ef))


def max_smem() -> int:
    """The dynamic shared memory a block may take (common.cuh's
    ``kMaxSmem``), as the library holds it."""
    fn = _build.library("cluster_scan").cluster_scan_max_smem
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return int(fn())


def max_ef(w: int, kind: str = "mulfree") -> int:
    """The largest EF whose block fits ``max_smem()`` at code width W: the
    top-EF slots are EF rounded up to a power of two (8,192 for every W up
    to 256)."""
    ef, limit = 1, max_smem()
    while smem_bytes(w, 2 * ef, kind) <= limit:
        ef *= 2
    return ef


def ranked_cluster_scan(codes: torch.Tensor, rank, base_rows: torch.Tensor,
                        n_valid: torch.Tensor, active: torch.Tensor,
                        dim: int, ef: int, m: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids (L, EF) int32, ranks (L, EF) of the rank's type); semantics of
    ``ref.ranked_cluster_scan_ref``."""
    global launches
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"cluster_scan kernel needs CUDA tensors, got {dev}")
    t, w = codes.shape
    n_lanes = base_rows.shape[0]
    kind = getattr(rank, "kind", None)
    if kind not in ranks.KIND_IDS:
        raise ValueError(f"cluster_scan: rank must be an O3Rank, "
                         f"HammingRank or ExactRank, got "
                         f"{type(rank).__name__}")
    if not 0 < dim <= 8 * w:
        raise ValueError(f"dim {dim} outside (0, {8 * w}] for W = {w}")
    if 8 * w > MAX_DPAD:
        raise ValueError(f"cluster_scan kernel takes codes of at most "
                         f"{MAX_DPAD // 8} bytes, got {w}")
    if not 0 < ef <= m:
        raise ValueError(f"ef = {ef} outside (0, {m}]: a cluster has {m} "
                         f"rows")
    if smem_bytes(w, ef, kind) > max_smem():
        raise NotImplementedError(
            f"cluster_scan of ef = {ef} at W = {w} needs "
            f"{smem_bytes(w, ef, kind)} bytes of shared memory a block, "
            f"more than {max_smem()}; the kernel serves EF <= "
            f"{max_ef(w, kind)} (ROADMAP C3)")
    if t >= 2**31:
        raise ValueError(f"code table of {t} rows exceeds int32 row ids")
    _check("codes", codes, torch.uint8, (t, w), dev)
    for name, v in (("base_rows", base_rows), ("n_valid", n_valid)):
        _check(name, v, torch.int32, (n_lanes,), dev)
    _check("active", active, torch.bool, (n_lanes,), dev)
    ranks.check("cluster_scan", rank, t, w, n_lanes, dev)
    out_ids = torch.empty((n_lanes, ef), dtype=torch.int32, device=dev)
    out_ranks = torch.empty((n_lanes, ef), dtype=ranks.dtype_of(rank),
                            device=dev)
    if n_lanes == 0:
        return out_ids, out_ranks
    vec16 = int(w % 16 == 0 and codes.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(ranks.KIND_IDS[kind], codes.data_ptr(),
                    *ranks.pointers(rank), base_rows.data_ptr(),
                    n_valid.data_ptr(), active.data_ptr(),
                    out_ids.data_ptr(), out_ranks.data_ptr(), n_lanes, w,
                    dim, ef, m, t, vec16, ranks.sqrt_dim(dim), stream)
    if err != 0:
        raise RuntimeError(f"cluster_scan launch failed: CUDA error {err}")
    launches += 1
    return out_ids, out_ranks


def cluster_scan(codes: torch.Tensor, f_add: torch.Tensor,
                 base_rows: torch.Tensor, n_valid: torch.Tensor,
                 lut: torch.Tensor, sumq: torch.Tensor, s1: torch.Tensor,
                 s2: torch.Tensor, active: torch.Tensor, dim: int, ef: int,
                 m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The mulfree scan: ``ranked_cluster_scan`` with ``O3Rank(f_add, lut,
    sumq, s1, s2)``; semantics of ``ref.cluster_scan_ref``."""
    return ranked_cluster_scan(codes, O3Rank(f_add, lut, sumq, s1, s2),
                               base_rows, n_valid, active, dim, ef, m)
