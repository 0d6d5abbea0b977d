"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

Each function has the signature of its kernel's wrapper and defines the
exact semantics the CUDA kernel must reproduce bitwise. The wrappers in
``kernels/ops.py`` run these for CPU tensors; ``chip_smoke.py`` holds each
kernel against its plain version on the card.

int32 arithmetic that may overflow is carried in int64 and wrapped back
with ``wrap_int32``, so the result is the two's-complement one the JAX
reference computes, without relying on signed overflow.
"""

from __future__ import annotations

import torch

__all__ = ["INT_MAX", "wrap_int32", "unpack_bits", "binary_ip_rank_ref",
           "topk_select_ref"]

INT_MAX = 2**31 - 1


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), fully defined."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def unpack_bits(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., W) uint8 -> (..., dim) int32 {0,1}, little-endian within a
    byte."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :dim]


def _shift_amount(s: torch.Tensor) -> torch.Tensor:
    """Arithmetic-shift amounts outside [0, 31] fill with the sign, as an
    XLA shift does; shifting by 31 gives the same result."""
    return torch.where((s < 0) | (s > 31), 31, s)


def binary_ip_rank_ref(codes: torch.Tensor, f_add: torch.Tensor,
                       rows: torch.Tensor, lut: torch.Tensor,
                       sumq: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """O3 mulfree rank, lane-batched in gather form:

        S   = <bits(codes[rows[l, r]]), lut[l, :dim]>
        t   = 2 S - sumq[l]
        t'  = t + (t >> s1[l]) [+ (t >> s2[l]) unless s2[l] >= 31]
        out = f_add[rows[l, r]] - t'            (INT_MAX where rows < 0)

    codes (T, W) u8, f_add (T,) i32, rows (L, R) i32 flat row ids (-1 pad;
    ids are clipped into [0, T) for the gather), lut (L, Dpad) i32, sumq /
    s1 / s2 (L,) i32 -> (L, R) i32.
    """
    safe = rows.long().clamp(0, codes.shape[0] - 1)
    bits = unpack_bits(codes[safe], dim).long()             # (L, R, dim)
    s = wrap_int32((bits * lut[:, None, :dim].long()).sum(-1)).long()
    t = wrap_int32(2 * s - sumq.long()[:, None]).long()
    sh1 = _shift_amount(s1.long())[:, None]
    sh2 = _shift_amount(s2.long().clamp(max=30))[:, None]
    third = torch.where(s2.long()[:, None] >= 31, 0, t >> sh2)
    tp = wrap_int32(t + (t >> sh1) + third).long()
    out = wrap_int32(f_add[safe].long() - tp)
    return torch.where(rows >= 0, out, INT_MAX)


def topk_select_ref(cand_ids: torch.Tensor, dists: torch.Tensor, *, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused dedup + k-selection over per-query candidate rows.

    cand_ids (Q, C) int32 (-1 = pad, duplicates allowed), dists (Q, C) f32.
    Keeps the FIRST occurrence of each id (pads and later duplicates are
    masked to inf), then takes the k smallest distances per row, ties to
    the lower column. Returns (ids (Q, k) int32, -1 where the distance is
    non-finite; dists (Q, k) f32). Both sorts are stable, which is what
    gives ``lax.top_k``'s lower-index tie order.
    """
    sorted_ids, order = torch.sort(cand_ids, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(sorted_ids, dtype=torch.bool)
    dup_sorted[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    d = torch.where((cand_ids < 0) | dup, float("inf"), dists)
    out_d, pos = torch.sort(d, dim=-1, stable=True)
    out_d = out_d[:, :k].contiguous()
    ids = torch.gather(cand_ids, 1, pos[:, :k])
    ids = torch.where(torch.isfinite(out_d), ids, -1)
    return ids.to(torch.int32), out_d.to(torch.float32)
