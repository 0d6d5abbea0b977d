r"""O3 — multiplication-free distance computation (counterpart of
``repro/core/mulfree.py``).

Within a cluster the per-node error factor cos_theta is replaced by a
cluster constant alpha, and 1/alpha is snapped to 1 + 2^-s1 (+ 2^-s2) so the
rank needs integer shifts and adds only; the residual norm folds into one
additive int32 ``f_add`` per node. The host folds every per-lane float
factor into an integer LUT (``prepare_int_lut``); the ranking itself is the
``binary_ip_rank`` kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rabitq
from .fixed_order import fixed_order_sum
from ..kernels.ref import wrap_int32

__all__ = ["AlphaShifts", "ClusterConstants", "calibrate_alpha",
           "shiftadd_apply", "fold_node_factor", "prepare_int_lut",
           "LUT_SCALE_BITS"]

LUT_SCALE_BITS = 12


class AlphaShifts(NamedTuple):
    """1/alpha ~= 1 + 2^-s1 + 2^-s2 (s2 = 31 disables the third term)."""
    s1: torch.Tensor     # (...,) int32
    s2: torch.Tensor     # (...,) int32
    value: torch.Tensor  # (...,) f32 the realized 1/alpha


class ClusterConstants(NamedTuple):
    alpha: torch.Tensor  # (...,) f32
    rho: torch.Tensor    # (...,) f32
    shifts: AlphaShifts


def calibrate_alpha(cos_theta: torch.Tensor, residual_norm: torch.Tensor,
                    valid: torch.Tensor | None = None) -> ClusterConstants:
    """Per-cluster calibration over the last axis (batched over the rest),
    its means summed in one fixed order (the same bits in any batch and at
    any zero padding)."""
    if valid is None:
        valid = torch.ones(cos_theta.shape, dtype=torch.bool,
                           device=cos_theta.device)
    w = valid.to(torch.float32)
    denom = fixed_order_sum(w).clamp(min=1.0)
    alpha = fixed_order_sum(cos_theta * w) / denom
    rho = fixed_order_sum(residual_norm * w) / denom
    inv = 1.0 / alpha.clamp(min=1e-6)

    # pick s1, s2 minimizing |inv - (1 + 2^-s1 + 2^-s2)| over a small grid;
    # argmin keeps the first minimum, as jnp.argmin does
    s = torch.arange(1, 16, dtype=torch.int32, device=cos_theta.device)
    pows = torch.exp2(-s.to(torch.float32))
    cand1 = 1.0 + pows                                    # (15,)
    cand2 = (1.0 + pows[:, None] + pows[None, :]).reshape(-1)   # (225,)
    err1 = (cand1 - inv[..., None]).abs()
    err2 = (cand2 - inv[..., None]).abs()
    i1 = err1.argmin(-1)
    i2 = err2.argmin(-1)
    e1 = torch.gather(err1, -1, i1[..., None])[..., 0]
    e2 = torch.gather(err2, -1, i2[..., None])[..., 0]
    use2 = e2 < e1
    s1 = torch.where(use2, s[i2 // 15], s[i1]).to(torch.int32)
    s2 = torch.where(use2, s[i2 % 15], torch.full_like(s[i1], 31))
    val = torch.where(use2, cand2[i2], cand1[i1])
    return ClusterConstants(alpha, rho, AlphaShifts(s1, s2, val))


def shiftadd_apply(t: torch.Tensor, shifts: AlphaShifts) -> torch.Tensor:
    """t * (1/alpha) by shift and add only: t + (t>>s1) [+ (t>>s2)], int32
    with two's-complement wrap (carried in int64)."""
    t = t.to(torch.int64)
    s2 = shifts.s2.to(torch.int64)
    third = torch.where(s2 >= 31, 0, t >> s2.clamp(0, 30))
    return wrap_int32(t + (t >> shifts.s1.to(torch.int64)) + third)


def fold_node_factor(residual_norm: torch.Tensor) -> torch.Tensor:
    """Per-node additive constant f_add = round(||r_i||^2 * 2^LUT_SCALE_BITS)
    (round half to even, as jnp.round)."""
    return torch.round(residual_norm.to(torch.float32) ** 2
                       * (1 << LUT_SCALE_BITS)).to(torch.int32)


def prepare_int_lut(q: torch.Tensor, centroid: torch.Tensor,
                    rotation: torch.Tensor, consts: ClusterConstants,
                    dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer LUT of each (query, cluster) lane, batched over lanes:
    q, centroid (L, D), consts.rho (L,) -> (lut (L, Dpad) int32, sumq (L,)
    int32). lut = round(g * kappa), kappa = 2^LUT_SCALE_BITS * 2 ||q_r|| rho
    / sqrt(D), multiplied in the reference's order."""
    qlut = rabitq.prepare_query(q, centroid, rotation)
    sqrt_d = torch.sqrt(torch.tensor(float(dim), dtype=torch.float32))
    kappa = ((2.0 ** LUT_SCALE_BITS) * 2.0 * qlut.query_norm * consts.rho
             / sqrt_d.to(q.device))
    lut = torch.round(qlut.lut * kappa[..., None]).to(torch.int32)
    pad = (-dim) % 8
    if pad:
        lut = torch.nn.functional.pad(lut, (0, pad))
    return lut, lut.sum(-1, dtype=torch.int32)
