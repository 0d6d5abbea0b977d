"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

Each function has the signature of its kernel's wrapper and defines the
semantics the CUDA kernel must reproduce: bitwise for the integer and
selection kernels, to a stated tolerance for ``flash_attention_ref``, whose
float32 sums the kernel takes in another order. The wrappers in
``kernels/ops.py`` run these for CPU tensors; ``chip_smoke.py`` holds each
kernel against its plain version on the card.

int32 arithmetic that may overflow is carried in int64 and wrapped back
with ``wrap_int32``, so the result is the two's-complement one the JAX
reference computes, without relying on signed overflow.
"""

from __future__ import annotations

import math

import torch

__all__ = ["INT_MAX", "INT_MIN", "wrap_int32", "unpack_bits",
           "binary_ip_rank_ref", "cluster_scan_ref", "topk_select_ref",
           "merge_topk_ref", "NEG_INF", "FLASH_TILE", "flash_attention_ref"]

INT_MAX = 2**31 - 1
INT_MIN = -2**31
NEG_INF = -1e30      # the attention mask's fill (repro/models/attention.py)
FLASH_TILE = 64      # keys per block of the scan: the CUDA kernel's KV tile


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


def cluster_scan_ref(codes: torch.Tensor, f_add: torch.Tensor,
                     base_rows: torch.Tensor, n_valid: torch.Tensor,
                     lut: torch.Tensor, sumq: torch.Tensor, s1: torch.Tensor,
                     s2: torch.Tensor, active: torch.Tensor, dim: int,
                     ef: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused whole-cluster O3 rank + top-EF of every lane, gather form.

    Lane l's cluster is the rows base_rows[l] + [0, m) of the flattened
    code table (ids clipped into [0, T) for the gather); each row ranks as
    in ``binary_ip_rank_ref``, and rows at n_valid[l] or beyond rank
    INT_MAX. The EF best come out in the order of the GEMV path
    (``full_scan_lane``: ``lax.top_k`` over the wrapped negated ranks):
    ascending rank, ties to the lower row, a rank of INT_MIN after INT_MAX
    (its negation wraps to itself). Equal to ``repro``'s
    ``cluster_scan_ref`` on every input without an INT_MIN rank. An
    inactive lane gives ids -1 and ranks INT_MAX.

    codes (T, W) u8, f_add (T,) i32, base_rows / n_valid / sumq / s1 / s2
    (L,) i32, lut (L, Dpad) i32, active (L,) bool -> (ids (L, EF) i32 local
    row ids, ranks (L, EF) i32).
    """
    if not 0 < ef <= m:
        raise ValueError(f"ef = {ef} outside (0, {m}]")
    i = torch.arange(m, device=codes.device)
    rows = (base_rows.long()[:, None] + i).clamp(0, codes.shape[0] - 1)
    r = binary_ip_rank_ref(codes, f_add, rows.to(torch.int32), lut, sumq, s1,
                           s2, dim)
    r = torch.where(i < n_valid[:, None], r, INT_MAX)
    order = torch.where(r == INT_MIN, 2**31, r.long())
    ids = torch.sort(order, dim=1, stable=True).indices[:, :ef]
    ranks = torch.gather(r, 1, ids)
    return (torch.where(active[:, None], ids, -1).to(torch.int32),
            torch.where(active[:, None], ranks, INT_MAX))


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


def merge_topk_ref(part_ids: torch.Tensor, part_dists: torch.Tensor, *,
                   k: int, run: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-owner partial top-k runs into the global top-k.

    part_ids (Q, O*run) int32 / part_dists (Q, O*run) f32: O concatenated
    runs per query (run defaults to k, the sharded tier's slot layout),
    ids disjoint across runs, -1 / inf in unfilled slots. Selection only:
    the k smallest distances, ties to the lower column, whether or not the
    runs are sorted. Returns (ids (Q, k) int32, -1 where the distance is
    non-finite; dists (Q, k) f32). A stable sort gives ``lax.top_k``'s tie
    order, which ``torch.topk`` does not.
    """
    w = part_ids.shape[-1]
    if w % (k if run is None else run):
        raise ValueError(f"row width {w} is not a whole number of runs of "
                         f"{k if run is None else run}")
    out_d, pos = torch.sort(part_dists, dim=-1, stable=True)
    out_d = out_d[:, :k].contiguous()
    ids = torch.gather(part_ids, 1, pos[:, :k])
    ids = torch.where(torch.isfinite(out_d), ids, -1)
    return ids.to(torch.int32), out_d.to(torch.float32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int | None = None,
                        q_offset: int = 0, kv_valid_len: int | None = None
                        ) -> torch.Tensor:
    """Blockwise online-softmax attention forward (``_flash_fwd`` of
    ``repro/models/attention.py``, the oracle of the Pallas
    ``flash_attention_fwd``).

    q (B, Sq, Hq, dk), k (B, Sk, Hkv, dk), v (B, Sk, Hkv, dv), Hq % Hkv ==
    0; query head h reads KV head h // (Hq / Hkv). Key j is valid for the
    query at absolute position p = q_offset + i when j < kv_valid_len (Sk
    when None), j <= p if causal, and p - j < window if a window is given.
    Scores, softmax and the P.V sum are float32 (q scaled by 1/sqrt(dk)
    first), a masked score is NEG_INF, the denominator max(l, 1e-30), and
    the output (B, Sq, Hq, dv) is cast to q.dtype. Keys are scanned in
    blocks of FLASH_TILE; the last block is ragged instead of zero-padded,
    which gives the reference's result for every row with a valid key.
    """
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    valid = sk if kv_valid_len is None else kv_valid_len
    qf = (q.float() / math.sqrt(dk)).reshape(b, sq, hkv, g, dk)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), device=q.device)
    for j0 in range(0, sk, FLASH_TILE):
        kj = k[:, j0:j0 + FLASH_TILE].float()
        vj = v[:, j0:j0 + FLASH_TILE].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kj)
        kv_pos = j0 + torch.arange(kj.shape[1], device=q.device)
        ok = (kv_pos < valid)[None, :].expand(sq, -1)
        if causal:
            ok = ok & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            ok = ok & (q_pos[:, None] - kv_pos[None, :] < window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)
