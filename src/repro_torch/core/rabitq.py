"""RabitQ quantization (counterpart of ``repro/core/rabitq.py``).

A unit centroid residual ``o`` is rotated by a random orthogonal P and
quantized to one bit per rotated dimension; ``cos_theta = sum|z| / sqrt(D)``
is its per-node error factor. The functions are batched: a leading batch
dimension of clusters or lanes is written out instead of vmapped.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import fixed_order

__all__ = ["RabitQCodes", "QueryLUT", "random_rotation", "encode",
           "prepare_query", "sign_code", "pack_codes", "unpack_codes",
           "binary_dot", "estimate_inner", "estimate_sqdist"]


class RabitQCodes(NamedTuple):
    packed: torch.Tensor         # (..., N, Dpad//8) uint8 packed sign codes
    residual_norm: torch.Tensor  # (..., N) f32  ||x - c||
    cos_theta: torch.Tensor      # (..., N) f32  <o_bar, o>
    dim: int                     # unpadded D


class QueryLUT(NamedTuple):
    lut: torch.Tensor         # (..., D) f32 rotated unit query residual
    sum_lut: torch.Tensor     # (...,) f32
    query_norm: torch.Tensor  # (...,) f32 ||q - c||


def random_rotation(generator: torch.Generator, dim: int,
                    device=None) -> torch.Tensor:
    """Random orthogonal (D, D) matrix: QR of a Gaussian, signs fixed so the
    draw is Haar-distributed. It does not reproduce ``jax.random``'s bits."""
    g = torch.randn((dim, dim), generator=generator, dtype=torch.float64,
                    device=generator.device)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(torch.float32).to(device or generator.device)


def pack_codes(bits: torch.Tensor) -> torch.Tensor:
    """(..., D) bool {0,1} -> (..., D//8) uint8, little-endian bit order."""
    *lead, d = bits.shape
    assert d % 8 == 0, f"dim {d} not a multiple of 8"
    b = bits.to(torch.uint8).reshape(*lead, d // 8, 8)
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
    return (b * weights).sum(-1, dtype=torch.uint8)


def unpack_codes(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., D//8) uint8 -> (..., D) int8 {0,1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1],
                        packed.shape[-1] * 8)[..., :dim].to(torch.int8)


def encode(x: torch.Tensor, centroid: torch.Tensor, rotation: torch.Tensor,
           *, dim: int | None = None) -> RabitQCodes:
    """Encode points x (..., N, D) against centroids (..., D). A point's
    code and factors are the same bits in any batch (``fixed_order``), so an
    appended node encodes as its cluster's rebuild does."""
    dim = dim or x.shape[-1]
    resid = x - centroid[..., None, :]
    norm = fixed_order.row_norm(resid)
    o = resid / norm.clamp(min=1e-12)[..., None]
    z = fixed_order.blocked_matmul(o, rotation)
    bits = z > 0
    cos_theta = fixed_order.fixed_order_sum(z.abs()) / math.sqrt(dim)
    pad = (-dim) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return RabitQCodes(pack_codes(bits), norm, cos_theta, dim)


def prepare_query(q: torch.Tensor, centroid: torch.Tensor,
                  rotation: torch.Tensor) -> QueryLUT:
    """Per-(query, cluster) lane prep, batched: q, centroid (..., D). A
    lane's LUT is the same bits in any batch (``fixed_order``)."""
    resid = q - centroid
    qnorm = fixed_order.row_norm(resid)
    g = fixed_order.blocked_matmul(resid / qnorm.clamp(min=1e-12)[..., None],
                                   rotation)
    return QueryLUT(g, fixed_order.fixed_order_sum(g), qnorm)


def sign_code(q: torch.Tensor, centroid: torch.Tensor,
              rotation: torch.Tensor, *, dim: int) -> torch.Tensor:
    """Packed sign code of the rotated unit query residual, batched: q,
    centroid (..., D) -> (..., Dpad // 8) uint8. The query encoded as the
    nodes are (``encode`` without its factors), the whole lane payload of
    the hamming backend; padded bits are zero, as in the node codes, so
    they XOR to 0."""
    resid = q - centroid
    norm = fixed_order.row_norm(resid)
    g = fixed_order.blocked_matmul(resid / norm.clamp(min=1e-12)[..., None],
                                   rotation)
    bits = g > 0
    pad = (-dim) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return pack_codes(bits)


def binary_dot(packed: torch.Tensor, lut: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """S: the sum of lut over each code's set bits, batched: packed
    (..., N, W), lut (..., Dpad) -> (..., N), as one float32 matrix
    product (the kernels' order of adds is ``ref.exact_rank_ref``'s)."""
    bits = unpack_codes(packed, dim).to(lut.dtype)
    return (bits @ lut[..., :dim, None])[..., 0]


def estimate_inner(codes: RabitQCodes, q: QueryLUT) -> torch.Tensor:
    """<o, q_hat> of every node: (2 S - sum(g)) / (sqrt(D) cos_theta),
    cos_theta floored at 1e-6; codes (..., N, ...), q (...) -> (..., N)."""
    s = binary_dot(codes.packed, q.lut, codes.dim)
    sd = torch.tensor(codes.dim, dtype=torch.float32,
                      device=s.device).sqrt()
    obar = (2.0 * s - q.sum_lut[..., None]) / sd
    floor = torch.tensor(1e-6, dtype=torch.float32, device=s.device)
    return obar / torch.maximum(codes.cos_theta, floor)


def estimate_sqdist(codes: RabitQCodes, q: QueryLUT) -> torch.Tensor:
    """||x - q||^2 of every node from the residual decomposition
    ||x-c||^2 + ||q-c||^2 - 2 ||x-c|| ||q-c|| <o, q_hat>, with the node's
    own cos_theta (the exact backend's estimator)."""
    est = estimate_inner(codes, q)
    rn, qn = codes.residual_norm, q.query_norm[..., None]
    return (rn * rn + qn * qn) - ((2.0 * rn) * qn) * est
