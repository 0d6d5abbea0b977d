"""The rank operands of the ``beam_search`` and ``cluster_scan`` kernels.

Both kernels rank a code row of a lane by one of three policies, the
ranking backends of ``core/backends.py``; a rank tuple names the policy by
its type and carries its tensors:

  * ``O3Rank`` (``mulfree``): the O3 multiplication-free rank, int32, from
    the lane's integer LUT and the row's ``f_add``;
  * ``HammingRank`` (``hamming``): popcount(code XOR qcode), int32, from the
    lane's packed sign code alone;
  * ``ExactRank`` (``exact``): the SymphonyQG estimator, float32, from the
    lane's float LUT and the row's ``residual_norm`` and ``cos_theta``.

Per-row tensors are (T,) over the flattened code table, per-lane tensors
(L, ...). ``kernels/ref.py`` defines each rank's semantics; this module
holds what the plain versions and the kernel wrappers share: the pad, the
rank type, the argument checks and the operands' order in the C launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["O3Rank", "HammingRank", "ExactRank", "KIND_IDS", "INT_MAX",
           "F32_MAX", "pad_of", "dtype_of", "sqrt_dim", "select_lanes",
           "check", "pointers"]

INT_MAX = 2**31 - 1
F32_MAX = float(np.finfo(np.float32).max)

# the policy a C launch takes (csrc/common.cuh: kO3, kHamming, kExact)
KIND_IDS = {"mulfree": 0, "hamming": 1, "exact": 2}


class O3Rank(NamedTuple):
    """mulfree: rank = f_add - t', t' the O3 shift-add of 2 S - sumq."""
    kind = "mulfree"
    f_add: torch.Tensor   # (T,) int32
    lut: torch.Tensor     # (L, 8W) int32
    sumq: torch.Tensor    # (L,) int32
    s1: torch.Tensor      # (L,) int32
    s2: torch.Tensor      # (L,) int32


class HammingRank(NamedTuple):
    """hamming: rank = popcount(code XOR qcode); no per-row tensor."""
    kind = "hamming"
    qcode: torch.Tensor   # (L, W) uint8


class ExactRank(NamedTuple):
    """exact: rank = rn^2 + qn^2 - 2 rn qn est, est = (2 S - sum_lut) /
    (sqrt(D) max(cos_theta, 1e-6))."""
    kind = "exact"
    residual_norm: torch.Tensor   # (T,) float32
    cos_theta: torch.Tensor       # (T,) float32
    lut: torch.Tensor             # (L, 8W) float32
    sum_lut: torch.Tensor         # (L,) float32
    query_norm: torch.Tensor      # (L,) float32


def pad_of(rank):
    """The rank of an invalid row: after every real rank."""
    return F32_MAX if rank.kind == "exact" else INT_MAX


def dtype_of(rank) -> torch.dtype:
    return torch.float32 if rank.kind == "exact" else torch.int32


def sqrt_dim(dim: int) -> float:
    """sqrt(float32(dim)) rounded to float32, as the JAX package's
    ``jnp.sqrt(jnp.asarray(dim, jnp.float32))`` gives it (rounding the
    double square root to float32 is exact rounding: a double carries more
    than twice float32's bits)."""
    return float(np.float32(np.sqrt(np.float64(dim))))


_LANE_FIELDS = {"mulfree": ("lut", "sumq", "s1", "s2"),
                "hamming": ("qcode",),
                "exact": ("lut", "sum_lut", "query_norm")}


def select_lanes(rank, idx):
    """The rank tuple of the lanes ``idx`` (an index tensor or a slice):
    per-lane tensors indexed, per-row ones kept."""
    return rank._replace(**{f: getattr(rank, f)[idx].contiguous()
                            for f in _LANE_FIELDS[rank.kind]})


def _shapes(rank, t: int, w: int, n_lanes: int):
    if rank.kind == "mulfree":
        return ((t,), (n_lanes, 8 * w), (n_lanes,), (n_lanes,), (n_lanes,))
    if rank.kind == "hamming":
        return ((n_lanes, w),)
    return ((t,), (t,), (n_lanes, 8 * w), (n_lanes,), (n_lanes,))


def _dtypes(rank):
    if rank.kind == "mulfree":
        return (torch.int32,) * 5
    if rank.kind == "hamming":
        return (torch.uint8,)
    return (torch.float32,) * 5


def check(who: str, rank, t: int, w: int, n_lanes: int,
          device: torch.device) -> None:
    """Raise ValueError unless every tensor of ``rank`` is contiguous, on
    ``device``, of its type and of its shape for a (t, W) code table and
    ``n_lanes`` lanes."""
    if not isinstance(rank, (O3Rank, HammingRank, ExactRank)):
        raise ValueError(f"{who}: rank must be an O3Rank, HammingRank or "
                         f"ExactRank, got {type(rank).__name__}")
    for name, v, dtype, shape in zip(rank._fields, rank, _dtypes(rank),
                                     _shapes(rank, t, w, n_lanes)):
        if v.device != device or v.dtype != dtype \
                or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(
                f"{who}: {rank.kind} {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {device}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device} "
                f"(contiguous={v.is_contiguous()})")


def pointers(rank) -> tuple:
    """The launch's six operand pointers (node0, node1, lut, lane0, lane1,
    lane2; None where the policy has none), csrc/common.cuh's
    ``RankArgs``."""
    if rank.kind == "mulfree":
        node0, node1 = rank.f_add, None
        lut, lanes = rank.lut, (rank.sumq, rank.s1, rank.s2)
    elif rank.kind == "hamming":
        node0 = node1 = None
        lut, lanes = rank.qcode, (None, None, None)
    else:
        node0, node1 = rank.residual_norm, rank.cos_theta
        lut, lanes = rank.lut, (rank.sum_lut, rank.query_norm, None)
    return tuple(None if v is None else v.data_ptr()
                 for v in (node0, node1, lut, *lanes))
