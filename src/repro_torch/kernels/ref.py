"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

Each function has the signature of its kernel's wrapper and defines the
semantics the CUDA kernel must reproduce: bitwise for the integer and
selection kernels and for the float32 ``exact`` rank (whose order of sums
``exact_rank_ref`` fixes), to a stated tolerance for
``flash_attention_ref``, whose float32 sums the kernel takes in another
order. The wrappers in
``kernels/ops.py`` run these for CPU tensors; ``chip_smoke.py`` holds each
kernel against its plain version on the card.

int32 arithmetic that may overflow is carried in int64 and wrapped back
with ``wrap_int32``, so the result is the two's-complement one the JAX
reference computes, without relying on signed overflow.
"""

from __future__ import annotations

import math

import torch

from .ranks import (F32_MAX, ExactRank, HammingRank, O3Rank, dtype_of, pad_of,
                    sqrt_dim)

__all__ = ["INT_MAX", "INT_MIN", "NAN_BITS", "wrap_int32", "unpack_bits",
           "binary_ip_rank_ref", "hamming_rank_ref", "exact_tables",
           "exact_rank_ref", "row_ranker", "float_order_key", "scan_order",
           "lockstep_beam_search", "ranked_beam_search_ref",
           "ranked_cluster_scan_ref", "beam_search_ref", "cluster_scan_ref",
           "topk_select_ref",
           "merge_topk_ref", "NEG_INF", "FLASH_TILE", "LOG2E",
           "LN2", "BWD_KV_BLOCK", "flash_attention_ref", "flash_decode_ref",
           "flash_attention_bwd_ref", "flash_attention_lse_bound",
           "flash_attention_bwd_bound", "flash_attention_order_bound",
           "flash_attention_flip_bound", "flash_attention_rounding_bound"]

INT_MAX = 2**31 - 1
INT_MIN = -2**31
NAN_BITS = 0x7FC00000   # the positive quiet NaN: every NaN rank comes out so
NEG_INF = -1e30      # the attention mask's fill (repro/models/attention.py)
FLASH_TILE = 64      # keys per block of the scan: the CUDA kernels' KV tile
LOG2E = 1.4426950408889634   # the kernel's literal: the same float64
LN2 = 0.6931471805599453     # the kernels' kLn2, rounded to float32 there
BWD_KV_BLOCK = 512           # keys per block of the backward


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


# popcount of each byte value (torch has no popcount)
_POPCOUNT = torch.tensor([bin(x).count("1") for x in range(256)],
                         dtype=torch.int32)


def hamming_rank_ref(codes: torch.Tensor, rows: torch.Tensor,
                     qcode: torch.Tensor) -> torch.Tensor:
    """Sign-only rank, lane-batched in gather form: the popcount of
    codes[rows[l, r]] XOR qcode[l], summed in int32 (padded code bits are
    zero in both, so they never count), INT_MAX where rows < 0.

    codes (T, W) u8, rows (L, R) i32 flat row ids (-1 pad; clipped into
    [0, T) for the gather), qcode (L, W) u8 -> (L, R) i32."""
    safe = rows.long().clamp(0, codes.shape[0] - 1)
    x = torch.bitwise_xor(codes[safe], qcode[:, None, :])
    pc = _POPCOUNT.to(codes.device)[x.long()].sum(-1, dtype=torch.int32)
    return torch.where(rows >= 0, pc, INT_MAX)


def exact_tables(lut: torch.Tensor, dim: int) -> torch.Tensor:
    """The float nibble tables of a float LUT (L, 8W), entries at or past
    dim taken as 0: T[l, h, x] (L, 2W, 16) is the sum of lut[l, 4h + i] over
    the set bits i of x, added in ascending bit order from +0.0, so T[x] =
    T[x without its top bit] + lut[4h + top]. The kernels build the same
    tables with the same adds."""
    n_lanes, dpad = lut.shape
    lut = torch.where(torch.arange(dpad, device=lut.device) < dim, lut,
                      0.0).reshape(n_lanes, dpad // 4, 4)
    tab = torch.zeros((n_lanes, dpad // 4, 16), dtype=torch.float32,
                      device=lut.device)
    for x in range(1, 16):
        top = x.bit_length() - 1
        tab[..., x] = tab[..., x ^ (1 << top)] + lut[..., top]
    return tab


def _exact_from_tables(codes, residual_norm, cos_theta, rows, tab, sum_lut,
                       query_norm, dim):
    safe = rows.long().clamp(0, codes.shape[0] - 1)
    c = codes[safe].long()                                   # (L, R, W)
    nib = torch.stack([c & 15, c >> 4], -1).flatten(-2)      # (L, R, 2W)
    h = torch.arange(nib.shape[-1], device=codes.device)
    n_lanes, n_rows = rows.shape
    vals = torch.gather(tab.reshape(n_lanes, 1, -1).expand(n_lanes, n_rows,
                                                           -1),
                        2, h * 16 + nib)                      # (L, R, 2W)
    s = torch.zeros((n_lanes, n_rows), dtype=torch.float32,
                    device=codes.device)
    for b in range(nib.shape[-1]):                            # ascending
        s = s + vals[..., b]
    sd = torch.tensor(sqrt_dim(dim), dtype=torch.float32, device=codes.device)
    floor = torch.tensor(1e-6, dtype=torch.float32, device=codes.device)
    obar = (2.0 * s - sum_lut[:, None]) / sd
    est = obar / torch.maximum(cos_theta[safe], floor)
    rn, qn = residual_norm[safe], query_norm[:, None]
    r = (rn * rn + qn * qn) - ((2.0 * rn) * qn) * est
    r = torch.where(torch.isnan(r), _nan(codes.device), r)
    return torch.where(rows >= 0, r, F32_MAX)


def _nan(device) -> torch.Tensor:
    return torch.tensor(NAN_BITS, dtype=torch.int32,
                        device=device).view(torch.float32)


def exact_rank_ref(codes: torch.Tensor, residual_norm: torch.Tensor,
                   cos_theta: torch.Tensor, rows: torch.Tensor,
                   lut: torch.Tensor, sum_lut: torch.Tensor,
                   query_norm: torch.Tensor, dim: int) -> torch.Tensor:
    """The exact (SymphonyQG) estimator, lane-batched in gather form, with
    the order of its float32 sums fixed, so that the kernels equal it
    bitwise:

        S    = sum over the half bytes h = 0 .. 2W-1, ascending, of
               T[h][nibble h of the row] (``exact_tables``), from +0.0
        obar = (2 S - sum_lut[l]) / sqrt(float32(D))
        est  = obar / max(cos_theta, 1e-6)
        rank = (rn rn + qn qn) - ((2 rn) qn) est

    rn = residual_norm of the row, qn = query_norm[l]; the epilogue is the
    JAX package's ``rabitq.estimate_sqdist`` in its order of operations,
    each rounded to float32 (no fused multiply-add); its S is a matrix
    product summed in another order, so the two agree to a tolerance. A
    NaN rank comes out as the positive quiet NaN (``NAN_BITS``), F32_MAX
    where rows < 0. The rank is never -0.0: rn rn + qn qn is +0.0 or more,
    and a difference of equal values rounds to +0.0.

    codes (T, W) u8, residual_norm / cos_theta (T,) f32, rows (L, R) i32
    flat row ids (-1 pad; clipped into [0, T) for the gathers), lut (L, 8W)
    f32, sum_lut / query_norm (L,) f32 -> (L, R) f32."""
    return _exact_from_tables(codes, residual_norm, cos_theta, rows,
                              exact_tables(lut, dim), sum_lut, query_norm,
                              dim)


def row_ranker(codes: torch.Tensor, rank, dim: int):
    """rows (L, R) -> (L, R) ranks of the lanes' rows by the rank tuple
    ``rank`` (``kernels/ranks.py``), pad_of(rank) where rows < 0; the exact
    rank's tables are built once, here."""
    if isinstance(rank, O3Rank):
        return lambda rows: binary_ip_rank_ref(
            codes, rank.f_add, rows, rank.lut, rank.sumq, rank.s1, rank.s2,
            dim)
    if isinstance(rank, HammingRank):
        return lambda rows: hamming_rank_ref(codes, rows, rank.qcode)
    if isinstance(rank, ExactRank):
        tab = exact_tables(rank.lut, dim)
        return lambda rows: _exact_from_tables(
            codes, rank.residual_norm, rank.cos_theta, rows, tab,
            rank.sum_lut, rank.query_norm, dim)
    raise ValueError(f"rank must be an O3Rank, HammingRank or ExactRank, "
                     f"got {type(rank).__name__}")


def float_order_key(r: torch.Tensor) -> torch.Tensor:
    """float32 ranks -> int64 keys in [0, 2^32) in ascending total order:
    -0.0 before +0.0, every NaN as the positive quiet NaN, after +inf.
    The kernels' ``rank_order_key`` bit for bit."""
    u = torch.where(torch.isnan(r), NAN_BITS,
                    r.view(torch.int32)).long() & 0xFFFFFFFF
    return torch.where(u >= 2**31, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def scan_order(r: torch.Tensor) -> torch.Tensor:
    """int64 keys of the GEMV path's order (``full_scan_lane``: ``lax.top_k``
    over the negated ranks, ties to the lower node): int32 ranks ascending
    with INT_MIN last (its negation wraps to itself), float32 ranks in the
    total order of ``float_order_key`` (the negation of -0.0 is +0.0, so
    -0.0 comes first; NaN last)."""
    if r.dtype == torch.float32:
        return float_order_key(r)
    return torch.where(r == INT_MIN, 2**31, r.long())


def _update_visited(visited: torch.Tensor, nbrs: torch.Tensor) -> None:
    """The reference's visited update, reproduced exactly and in place.

    The reference scatters ``visited[clip(nbrs, 0)] |= nbrs >= 0``, so every
    -1 slot also writes visited[0] with its OLD value, and XLA applies
    duplicate scatters in order (last writer wins). So local node 0 ends
    True only if it already was, or a real 0 is in the row with no -1 slot
    after it; every real id > 0 ends True. Ids > 0 go through a scatter
    whose duplicate writes all write True (order-free); -1 and 0 slots
    write into a sink column M. visited (L, M + 1) bool, nbrs (L, R)."""
    l, r = nbrs.shape
    m = visited.shape[1] - 1
    sink = torch.where(nbrs > 0, nbrs.clamp(max=m - 1), m).long()
    visited.scatter_(1, sink, True)
    pos = torch.arange(r, device=nbrs.device)
    last = torch.where(nbrs <= 0, pos, -1).amax(-1)            # (L,)
    last_is_zero = torch.gather(nbrs, 1, last.clamp(min=0)[:, None])[:, 0] == 0
    visited[:, 0] |= (last >= 0) & last_is_zero


def lockstep_beam_search(nbr_table: torch.Tensor, base_rows: torch.Tensor,
                         entry: torch.Tensor, active: torch.Tensor, *, m: int,
                         ef: int, max_iters: int, pad, rank_dtype, rank
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy beam search of every lane over its cluster, all L lanes in
    lock-step (the JAX package vmaps a per-lane ``lax.while_loop``).

    Lane l's cluster is the rows base_rows[l] + [0, m) of the flattened
    (T, R) neighbour table. ``rank(ids)`` ranks (L, R') local ids of each
    lane's cluster, ``pad`` (which sorts after every real rank) where an id
    is -1. Each hop updates the lanes that are still live (hop cap not
    reached, an unexpanded beam entry ranking below ``pad``) and freezes
    the rest: a lane that is not live does not change, so it is never live
    again. A hop expands the best unexpanded entry, marks its neighbours
    fresh against the visited bitmap as it was before the hop, updates the
    bitmap (``_update_visited``), ranks the fresh ones, and merges the beam
    and the neighbours stably into the best EF (ties keep the beam first,
    the neighbours in column order). Inactive lanes rank their entry and
    report 0 hops. -> (ids (L, EF) int32 local, -1 pad; ranks (L, EF);
    hops (L,) int32)."""
    n_lanes = entry.shape[0]
    dev = entry.device
    li = torch.arange(n_lanes, device=dev)
    base = base_rows.long()
    beam_ids = torch.full((n_lanes, ef), -1, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = entry
    beam_rank = torch.full((n_lanes, ef), pad, dtype=rank_dtype, device=dev)
    beam_rank[:, 0] = rank(entry[:, None])[:, 0]
    expanded = torch.zeros((n_lanes, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((n_lanes, m + 1), dtype=torch.bool, device=dev)
    visited[li, entry.long()] = True
    hops = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    no_exp = torch.zeros((n_lanes, nbr_table.shape[-1]), dtype=torch.bool,
                         device=dev)

    for _ in range(max_iters):
        # pick the best unexpanded beam entry (argmin: first minimum)
        frontier = torch.where(expanded, pad, beam_rank)
        sel = frontier.argmin(-1)
        live = active & (frontier[li, sel] < pad)
        if not bool(live.any()):
            break
        node = beam_ids[li, sel]
        nbrs = nbr_table[base + node.clamp(0, m - 1).long()]    # (L, R)
        seen = torch.gather(visited, 1, nbrs.clamp(0, m - 1).long())
        fresh = (nbrs >= 0) & ~seen & (node >= 0)[:, None] & live[:, None]
        nbrs = torch.where(fresh, nbrs, -1)
        _update_visited(visited, nbrs)
        nrank = rank(nbrs)

        # merge beam + neighbours, keep the best EF (stable: ties keep order)
        exp_sel = expanded.clone()
        exp_sel[li, sel] = True
        all_ids = torch.cat([beam_ids, nbrs], dim=1)
        all_rank = torch.cat([beam_rank, nrank], dim=1)
        all_exp = torch.cat([exp_sel, no_exp], dim=1)
        take = torch.sort(all_rank, dim=1, stable=True).indices[:, :ef]
        keep = live[:, None]
        beam_ids = torch.where(keep, torch.gather(all_ids, 1, take), beam_ids)
        beam_rank = torch.where(keep, torch.gather(all_rank, 1, take),
                                beam_rank)
        expanded = torch.where(keep, torch.gather(all_exp, 1, take), expanded)
        hops += live.to(torch.int32)
    return beam_ids, beam_rank, hops


def ranked_beam_search_ref(codes: torch.Tensor, rank, nbrs: torch.Tensor,
                           base_rows: torch.Tensor, entry: torch.Tensor,
                           active: torch.Tensor, dim: int, ef: int,
                           max_iters: int, m: int
                           ) -> tuple[torch.Tensor, ...]:
    """The beam search of every lane: ``lockstep_beam_search`` ranking each
    hop's ids with the rank tuple ``rank`` (``row_ranker``: rows
    base_rows[l] + id, ids clipped into [0, m) for the gathers, -1 ids
    ranking pad_of(rank)).

    codes (T, W) u8, rank an O3Rank, HammingRank or ExactRank over the T
    rows and L lanes, nbrs (T, R) i32 local neighbour ids (-1 pad),
    base_rows / entry (L,) i32, active (L,) bool -> (ids (L, EF) i32,
    ranks (L, EF) of the rank's type, hops (L,) i32)."""
    base = base_rows[:, None]
    ranker = row_ranker(codes, rank, dim)

    def rank_ids(ids):
        rows = torch.where(ids >= 0, base + ids.clamp(0, m - 1), -1)
        return ranker(rows.to(torch.int32))
    return lockstep_beam_search(nbrs, base_rows, entry, active, m=m, ef=ef,
                                max_iters=max_iters, pad=pad_of(rank),
                                rank_dtype=dtype_of(rank), rank=rank_ids)


def beam_search_ref(codes: torch.Tensor, f_add: torch.Tensor,
                    nbrs: torch.Tensor, base_rows: torch.Tensor,
                    entry: torch.Tensor, lut: torch.Tensor, sumq: torch.Tensor,
                    s1: torch.Tensor, s2: torch.Tensor, active: torch.Tensor,
                    dim: int, ef: int, max_iters: int, m: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mulfree beam search of every lane: ``ranked_beam_search_ref``
    with ``O3Rank(f_add, lut, sumq, s1, s2)``, each hop ranked by
    ``binary_ip_rank_ref``.

    codes (T, W) u8, f_add (T,) i32, nbrs (T, R) i32 local neighbour ids
    (-1 pad), base_rows / entry / sumq / s1 / s2 (L,) i32, lut (L, 8W) i32,
    active (L,) bool -> (ids (L, EF) i32, ranks (L, EF) i32, hops (L,)
    i32)."""
    return ranked_beam_search_ref(codes, O3Rank(f_add, lut, sumq, s1, s2),
                                  nbrs, base_rows, entry, active, dim, ef,
                                  max_iters, m)


def ranked_cluster_scan_ref(codes: torch.Tensor, rank,
                            base_rows: torch.Tensor, n_valid: torch.Tensor,
                            active: torch.Tensor, dim: int, ef: int, m: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused whole-cluster rank + top-EF of every lane, gather form.

    Lane l's cluster is the rows base_rows[l] + [0, m) of the flattened
    code table (ids clipped into [0, T) for the gather); each row ranks by
    ``rank`` (``row_ranker``), and rows at n_valid[l] or beyond rank
    pad_of(rank). The EF best come out in the order of the GEMV path
    (``scan_order``): ascending rank, ties to the lower row; an int32 rank
    of INT_MIN after INT_MAX, a float32 NaN after +inf. An inactive lane
    gives ids -1 and ranks pad_of(rank).

    codes (T, W) u8, rank over the T rows and L lanes, base_rows / n_valid
    (L,) i32, active (L,) bool -> (ids (L, EF) i32 local row ids, ranks
    (L, EF) of the rank's type)."""
    if not 0 < ef <= m:
        raise ValueError(f"ef = {ef} outside (0, {m}]")
    i = torch.arange(m, device=codes.device)
    rows = (base_rows.long()[:, None] + i).clamp(0, codes.shape[0] - 1)
    pad = pad_of(rank)
    r = row_ranker(codes, rank, dim)(rows.to(torch.int32))
    r = torch.where(i < n_valid[:, None], r, pad)
    ids = torch.sort(scan_order(r), dim=1, stable=True).indices[:, :ef]
    ranks = torch.gather(r, 1, ids)
    return (torch.where(active[:, None], ids, -1).to(torch.int32),
            torch.where(active[:, None], ranks, pad))


def cluster_scan_ref(codes: torch.Tensor, f_add: torch.Tensor,
                     base_rows: torch.Tensor, n_valid: torch.Tensor,
                     lut: torch.Tensor, sumq: torch.Tensor, s1: torch.Tensor,
                     s2: torch.Tensor, active: torch.Tensor, dim: int,
                     ef: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused whole-cluster O3 rank + top-EF of every lane:
    ``ranked_cluster_scan_ref`` with ``O3Rank(f_add, lut, sumq, s1, s2)``.
    Each row ranks as in ``binary_ip_rank_ref``; the order is the GEMV
    path's (ascending rank, ties to the lower row, a rank of INT_MIN after
    INT_MAX), equal to ``repro``'s ``cluster_scan_ref`` on every input
    without an INT_MIN rank. An inactive lane gives ids -1 and ranks
    INT_MAX.

    codes (T, W) u8, f_add (T,) i32, base_rows / n_valid / sumq / s1 / s2
    (L,) i32, lut (L, Dpad) i32, active (L,) bool -> (ids (L, EF) i32 local
    row ids, ranks (L, EF) i32).
    """
    return ranked_cluster_scan_ref(codes, O3Rank(f_add, lut, sumq, s1, s2),
                                   base_rows, n_valid, active, dim, ef, m)


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
                        q_offset: int = 0, kv_valid_len: int | None = None,
                        operands: torch.dtype | None = None,
                        return_lse: bool = False, softcap: float = 0.0):
    """Blockwise online-softmax attention forward (``_flash_fwd`` of
    ``repro/models/attention.py``, the oracle of the Pallas
    ``flash_attention_fwd``).

    q (B, Sq, Hq, dk), k (B, Sk, Hkv, dk), v (B, Sk, Hkv, dv), Hq % Hkv ==
    0; query head h reads KV head h // (Hq / Hkv). Key j is valid for the
    query at absolute position p = q_offset + i when j < kv_valid_len (Sk
    when None), j <= p if causal, and p - j < window if a window is given.
    Keys are scanned in blocks of FLASH_TILE; the last block is ragged
    instead of zero-padded, which gives the reference's result for every
    row with a valid key. The output (B, Sq, Hq, dv) is cast to q.dtype.

    ``operands=None``: scores, softmax and the P.V sum in float32 (q scaled
    by 1/sqrt(dk) first), a masked score is NEG_INF, the denominator
    max(l, 1e-30); the JAX package's function on the CPU.

    ``operands=torch.bfloat16``: the tensor-core kernel's twin, which rounds
    where the kernel rounds. q, K and V are rounded to bf16; S = q.K^T is
    summed in float32 and then scaled, t = S * float32(log2(e) / sqrt(dk));
    a masked t is -inf; at each tile the running max m (from NEG_INF) takes
    the tile's max, p = exp2(t - m) in float32, l = l * corr + sum(p) from
    the float32 p, and only the P.V product takes P rounded to bf16 (with
    float32 sums). What the JAX einsums at DEFAULT precision compute on a
    TPU: bf16 operands, float32 sums.

    ``return_lse``: (out, lse), lse (B, Hq, Sq) float32 the logsumexp of
    each row's scaled, masked scores, from the scan's running max m and
    denominator l: m + log(max(l, 1e-30)) (``_flash_fwd``'s residual); the
    twin's m is in log2 units of the scaled score, so its lse is ln 2 (m +
    log2(max(l, 1e-30))), as the tensor-core kernels write it.

    ``softcap`` > 0 (0 is off, as in the JAX package): each scaled score s
    becomes cap tanh(s / cap) before the mask, and the lse is of the capped
    scores. The twin computes it as the tensor-core kernels do, in log2
    units from the raw sum S: t = float32(log2(e) cap) tanh(S
    float32(1 / (sqrt(dk) cap))), each product rounded to float32.
    """
    out, _, lse = _flash_scan(q, k, v, causal, window, q_offset,
                              kv_valid_len, operands, softcap=softcap)
    return (out, lse) if return_lse else out


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int | None = None,
                     q_offset: int = 0, kv_valid_len: int | None = None,
                     return_lse: bool = False, softcap: float = 0.0):
    """The split-KV decode kernel (``csrc/flash_decode.cu``) step by step
    in plain PyTorch, for the tests: the split of ``flash_attn.decode_design``
    (chunks of whole tiles of ``DECODE_TILE`` keys), each chunk's online
    softmax over its tiles from m = NEG_INF, l = 0, acc = 0 (a masked key
    weighs exactly 0; K/V rows past min(Sk, kv_valid_len) read as zeros),
    then the combine in chunk order: M = max m_c, L = sum l_c exp(m_c - M),
    out = sum acc_c exp(m_c - M) / max(L, 1e-30), lse = M + log(max(L,
    1e-30)). Float32 throughout; same arguments and results as
    ``flash_attention_ref`` (float32 q). The kernel's sums within a tile
    go in another order, and its combine adds runs of consecutive chunks,
    then the runs, in order."""
    from .flash_attn import DECODE_TILE, decode_chunks
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    rows = sq * g
    limit = min(sk, sk if kv_valid_len is None else int(kv_valid_len))
    dev = q.device
    # row r = position r // g, head hk g + r % g of KV head hk
    qs = (q.float() / math.sqrt(dk)).reshape(b, sq, hkv, g, dk).permute(
        0, 2, 1, 3, 4).reshape(b, hkv, rows, dk)
    q_pos = q_offset + torch.arange(rows, device=dev) // g
    parts = []
    for begin, end in decode_chunks(
            b, sq, hq, hkv, sk, causal=causal, window=window,
            q_offset=q_offset, kv_valid_len=kv_valid_len):
        m = torch.full((b, hkv, rows), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, rows), device=dev)
        acc = torch.zeros((b, hkv, rows, dv), device=dev)
        for key0 in range(begin, end, DECODE_TILE):
            keys = key0 + torch.arange(DECODE_TILE, device=dev)
            live = keys < limit
            at = keys.clamp(max=sk - 1)
            kt = torch.where(live[None, :, None, None], k[:, at].float(),
                             0.0).permute(0, 2, 1, 3)
            vt = torch.where(live[None, :, None, None], v[:, at].float(),
                             0.0).permute(0, 2, 1, 3)
            s = qs @ kt.transpose(-1, -2)                  # (B, Hkv, R, 32)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            ok = live[None, :].expand(rows, -1)
            if causal:
                ok = ok & (keys[None, :] <= q_pos[:, None])
            if window is not None:
                ok = ok & (q_pos[:, None] - keys[None, :] < window)
            m_new = torch.maximum(m, torch.where(ok, s, NEG_INF).amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        parts.append((m, l, acc))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(top)
    out = torch.zeros((b, hkv, rows, dv), device=dev)
    for m, l, acc in parts:
        w = torch.exp(m - top)
        den = den + l * w
        out = out + acc * w[..., None]
    den = den.clamp(min=1e-30)
    out = (out / den[..., None]).reshape(b, hkv, sq, g, dv).permute(
        0, 2, 1, 3, 4).reshape(b, sq, hq, dv).to(q.dtype)
    lse = (top + torch.log(den)).reshape(b, hkv, sq, g).permute(
        0, 1, 3, 2).reshape(b, hq, sq)
    return (out, lse) if return_lse else out


def _work_type(q, operands=None) -> torch.dtype:
    """The plain attention's arithmetic type: float32, or float64 for
    float64 q with the default operands (a gradient check's inputs)."""
    return torch.float64 if q.dtype == torch.float64 and operands is None \
        else torch.float32


def _cap_consts(dk: int, softcap: float, device) -> tuple:
    """The tensor-core kernels' two float32 constants of the capped score
    in log2 units: (1 / (sqrt(dk) cap), log2(e) cap), each rounded once
    from float64 (``flash_attn_launch``'s)."""
    return (torch.tensor(1.0 / (math.sqrt(dk) * softcap), dtype=torch.float32,
                         device=device),
            torch.tensor(LOG2E * softcap, dtype=torch.float32, device=device))


def _flash_scan(q, k, v, causal, window, q_offset, kv_valid_len, operands,
                peak=False, softcap=0.0):
    """flash_attention_ref's scan: (out, peak, lse); with ``peak`` also
    max_j p_j max_d |v_jd| / l per row, (B, Sq, Hq, 1), from the same p and
    l (else None)."""
    if operands not in (None, torch.bfloat16):
        raise ValueError(f"operands {operands}: None (float32) or bfloat16")
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    valid = sk if kv_valid_len is None else kv_valid_len
    twin = operands is not None
    f = _work_type(q, operands)
    if twin:
        qf = q.to(operands).float().reshape(b, sq, hkv, g, dk)
        k, v = k.to(operands), v.to(operands)
        scale = torch.tensor(LOG2E / math.sqrt(dk), dtype=torch.float32,
                             device=q.device)
        if softcap:
            cap_in, cap_out = _cap_consts(dk, softcap, q.device)
    else:
        qf = (q.to(f) / math.sqrt(dk)).reshape(b, sq, hkv, g, dk)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=f, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=f, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=f, device=q.device)
    top = torch.zeros((b, hkv, g, sq), device=q.device) if peak else None
    for j0 in range(0, sk, FLASH_TILE):
        kj = k[:, j0:j0 + FLASH_TILE].to(f)
        vj = v[:, j0:j0 + FLASH_TILE].to(f)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kj)
        kv_pos = j0 + torch.arange(kj.shape[1], device=q.device)
        ok = (kv_pos < valid)[None, :].expand(sq, -1)
        if causal:
            ok = ok & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            ok = ok & (q_pos[:, None] - kv_pos[None, :] < window)
        if twin:
            s = torch.tanh(s * cap_in) * cap_out if softcap else s * scale
            s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp2(s - m_new[..., None])
            corr = torch.exp2(m - m_new)
            pv = p.to(operands).float()
        else:
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            pv = p
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", pv, vj)
        if peak:
            vmax = vj.abs().amax(-1).permute(0, 2, 1)[:, :, None, None]
            top = torch.maximum(top * corr, (p * vmax).amax(-1))
        m = m_new
    den = torch.clamp(l, min=1e-30)
    out = acc / den[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)
    if peak:
        top = (top / den).permute(0, 3, 1, 2).reshape(b, sq, hq, 1)
    lse = LN2 * (m + torch.log2(den)) if twin else m + torch.log(den)
    return out, top, lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool, window: int | None = None,
                            q_offset: int = 0,
                            kv_valid_len: int | None = None,
                            softcap: float = 0.0
                            ) -> tuple[torch.Tensor, ...]:
    """The flash backward (``_flash_bwd_rule`` of
    ``repro/models/attention.py``): (dq, dk, dv) in q's, k's and v's types.

    q, k, v as ``flash_attention_ref`` takes them; out (B, Sq, Hq, dv) and
    lse (B, Hq, Sq) the forward's (``return_lse``); dout the output's
    gradient. P is recomputed block by block from (q, k, lse), keys in
    blocks of BWD_KV_BLOCK, the last one ragged: delta = rowsum(dout *
    out), dS = P (dP - delta), dq accumulated over the blocks, each block's
    dk and dv emitted, everything in float32 (float64 for float64 q, a
    gradient check's inputs). Memory is O(S d) plus one
    block's (Sq, BWD_KV_BLOCK) scores, never the (Sq, Sk) matrix. Where the
    mask leaves a block no visible query row (causal: rows before the
    block; a window: rows past its reach), those rows are not computed:
    their P and dS are zero, so the sums are the reference's.

    ``softcap`` > 0: the scores are recomputed capped, t = tanh(s / cap)
    and cap t, and dS is multiplied by the cap's derivative 1 - t^2 before
    the mask zeroes it (``_flash_bwd_rule``).

    The reference keeps the forward's float32 output as its residual; here
    ``out`` is the forward's own output, in q's type (bf16 at the serving
    types on the card), so delta carries its rounding."""
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dk)
    valid = sk if kv_valid_len is None else kv_valid_len
    f = _work_type(q)
    qf = (q.to(f) * scale).reshape(b, sq, hkv, g, dk)
    go = dout.to(f).reshape(b, sq, hkv, g, dv).permute(0, 2, 3, 1, 4)
    delta = (go * out.to(f).reshape(b, sq, hkv, g, dv).permute(
        0, 2, 3, 1, 4)).sum(-1)                             # (b, h, g, sq)
    lse = lse.to(f).reshape(b, hkv, g, sq)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros((b, sq, hkv, g, dk), dtype=f, device=q.device)
    dks = torch.zeros((b, sk, hkv, dk), dtype=f, device=q.device)
    dvs = torch.zeros((b, sk, hkv, dv), dtype=f, device=q.device)
    for j0 in range(0, sk, BWD_KV_BLOCK):
        j1 = min(j0 + BWD_KV_BLOCK, sk)
        r0 = min(max(0, j0 - q_offset), sq) if causal else 0
        r1 = sq if window is None else \
            max(0, min(sq, j1 - 1 + window - q_offset))
        if r0 >= r1:
            continue
        kj, vj = k[:, j0:j1].to(f), v[:, j0:j1].to(f)
        qb, gb = qf[:, r0:r1], go[:, :, :, r0:r1]
        kv_pos = j0 + torch.arange(j1 - j0, device=q.device)
        qp = q_pos[r0:r1]
        ok = (kv_pos < valid)[None, :].expand(r1 - r0, -1)
        if causal:
            ok = ok & (kv_pos[None, :] <= qp[:, None])
        if window is not None:
            ok = ok & (qp[:, None] - kv_pos[None, :] < window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kj)
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        s = torch.where(ok, s, NEG_INF)
        p = torch.exp(s - lse[..., r0:r1, None])
        dvs[:, j0:j1] = torch.einsum("bhgqk,bhgqd->bkhd", p, gb)
        dp = torch.einsum("bhgqd,bkhd->bhgqk", gb, vj)
        ds = p * (dp - delta[..., r0:r1, None])
        if softcap:
            ds = ds * (1.0 - t * t)
        ds = torch.where(ok, ds, 0.0)
        # s = (q scale) k^T: ds/dq = k scale, ds/dk = q scale (= qf)
        dq[:, r0:r1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kj) * scale
        dks[:, j0:j1] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
    return (dq.reshape(b, sq, hq, dk).to(q.dtype), dks.to(k.dtype),
            dvs.to(v.dtype))


def flash_attention_order_bound(out: torch.Tensor) -> torch.Tensor:
    """Per-element bound of two attention forwards that round alike and sum
    in float32 in other orders, at ``out`` (either one's output).

    A float32 output moves by ~1e-6 of the values summed: 2e-5 absolute,
    scaled by the largest |output| above 1. A bf16 output is that sum
    rounded to 8 significant bits, and the other order can flip that
    rounding: the gap between two neighbouring bf16 values is at most 2^-7
    of the smaller one, so each element may move by 2^-7 of its own |output|
    on top of the float32 term, and never by more than 2^-7 of the largest
    |output| above 1."""
    mag = out.float().abs()
    big = max(1.0, float(mag.max())) if mag.numel() else 1.0
    if out.dtype == torch.bfloat16:
        return (2.0 ** -7 * mag + 2e-5 * big).clamp(max=2.0 ** -7 * big)
    return torch.full_like(mag, 2e-5 * big)


def flash_attention_flip_bound(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool,
                               window: int | None = None, q_offset: int = 0,
                               kv_valid_len: int | None = None,
                               softcap: float = 0.0) -> torch.Tensor:
    """Per-row bound, (B, Sq, Hq, 1), of what one weight rounded to the
    other bf16 neighbour moves in the tensor-core kernel's output against
    its twin (``flash_attention_ref(..., operands=torch.bfloat16)``).

    Both compute p_j = 2^(t_j - m) in float32 and round it to bf16 for the
    P.V product, but their t_j differ in the last bits (S summed in another
    order) and so do their 2^x (the kernel's ex2.approx against
    torch.exp2). A p_j that lies that close to the midpoint between two
    bf16 values is rounded up by one and down by the other: the two P.V
    sums then differ by one bf16 ulp of p_j times v_j, and one ulp of a
    value in [2^e, 2^(e+1)) is 2^(e-7), at most 2^-7 of the value. So an
    element of row i moves by at most 2^-7 max_j p_j |v_jd| / l_i for one
    such weight, bounded here by 2^-7 max_j p_j max_d |v_jd| / l_i with
    the twin's p and l. Rounding that differs on a second weight of the
    same row is ~1e-4 as likely again (the weights differ by a few float32
    ulps, a bf16 ulp is 2^16 of those) and moves the row by its own,
    smaller, p_j. With ``softcap`` the weights are the capped twin's (its
    tanh and the kernel's tanhf differ in the last bits too, which is the
    same near-midpoint case)."""
    return 2.0 ** -7 * _flash_scan(q, k, v, causal, window, q_offset,
                                   kv_valid_len, torch.bfloat16,
                                   peak=True, softcap=softcap)[1]


def _bf16_exact(t: torch.Tensor) -> bool:
    return torch.equal(t.to(torch.bfloat16).float(), t.float())


def _max_abs_score(q, k, causal, window, q_offset, valid) -> torch.Tensor:
    """max over each row's valid keys j of sum_d |q_d| |k_jd| / sqrt(dk),
    (B, Sq, Hq, 1)."""
    b, sq, hq, dk = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qa = (q.float().abs() / math.sqrt(dk)).reshape(b, sq, hkv, g, dk)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    mx = torch.zeros((b, hkv, g, sq), device=q.device)
    for j0 in range(0, sk, FLASH_TILE):
        ka = k[:, j0:j0 + FLASH_TILE].float().abs()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qa, ka)
        kv_pos = j0 + torch.arange(ka.shape[1], device=q.device)
        ok = (kv_pos < valid)[None, :].expand(sq, -1)
        if causal:
            ok = ok & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            ok = ok & (q_pos[:, None] - kv_pos[None, :] < window)
        mx = torch.maximum(mx, torch.where(ok, s, 0.0).amax(-1))
    return mx.permute(0, 3, 1, 2).reshape(b, sq, hq, 1)


def flash_attention_rounding_bound(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *, causal: bool,
                                   window: int | None = None,
                                   q_offset: int = 0,
                                   kv_valid_len: int | None = None,
                                   softcap: float = 0.0) -> torch.Tensor:
    """Per-element bound of |twin - float32 plain|: ``flash_attention_ref``
    with ``operands=torch.bfloat16`` against the default, (B, Sq, Hq, dv).

    Write A = sum_j p_j |v_j| / l = flash_attention_ref(q, k, |v|), the
    float32 plain version's weights applied to |v|.

    * P in bf16. Rounding to nearest at 8 significant bits moves each p_j by
      at most 2^-9 p_j, so the P.V sum moves by at most 2^-9 A; l is summed
      from the unrounded p. Taken as 2^-8 A: one ulp, not half, which also
      covers A being evaluated with the float32 version's weights.
    * q and K in bf16 (zero when both are bf16-exact, as on the serving
      path). Each product q_d k_jd moves by at most (2^-8 + 2^-18) of its
      size, so each score by at most D_i = 2^-8 (1 + 2^-8) max_j sum_d
      |q_d||k_jd| / sqrt(dk) over row i's valid keys. Shifting every score
      of a row by at most D moves each softmax weight by a factor within
      [e^-2D, e^2D], so the output by at most (e^2D - 1) A, and the P term
      above grows by the factor e^2D.
    * V in bf16 (zero when V is bf16-exact): each |v_j| moves by at most
      2^-9 of itself, so the output by 2^-9 e^2D A, taken as 2^-8 e^2D A.
    * The sums in other orders and the rounding of the output to q's type:
      ``flash_attention_order_bound`` of the float32 plain output.
    * ``softcap`` (the weights and A are then the capped ones). The cap
      c(s) = cap tanh(s / cap) has slope 1 - tanh^2 <= 1, so a shift of at
      most D in the raw scores stays one of at most D in the capped
      scores, and the terms above hold as they are. Each side evaluates
      the cap in float32 its own way (the twin tanh(S float32(1 / (sqrt(dk)
      cap))) float32(log2(e) cap), the plain version tanh(s / cap) cap):
      the argument's rounding and its constant's (2^-23 of x = s / cap)
      move cap tanh by at most cap (1 - t^2) |x| 2^-23 <= 2^-23 |s|; tanh
      itself (torch.tanh, and the kernels' tanhf, within 2 ulp) by 2^-22
      |c| <= 2^-22 |s|; the product by cap and its constant's rounding by
      2^-23 |c|. So each capped score lies within 2^-21 |s| <= 2^-21 A_i
      of the exact one, A_i = max_j sum_d |q_d||k_jd| / sqrt(dk), and the
      two sides' scores differ by one more shift of at most 2^-20 A_i,
      which adds to D (and makes D nonzero even for bf16-exact q and K).
    """
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len)
    want = flash_attention_ref(q, k, v, softcap=softcap, **kw)
    a = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                            softcap=softcap, **kw)
    grow = torch.ones((), device=q.device)
    bound = torch.zeros_like(a)
    rounded = not (_bf16_exact(q) and _bf16_exact(k))
    if rounded or softcap:
        valid = k.shape[1] if kv_valid_len is None else kv_valid_len
        score = _max_abs_score(q, k, causal, window, q_offset, valid)
        d = (2.0 ** -8 * (1 + 2.0 ** -8) if rounded else 0.0) * score
        if softcap:
            d = d + 2.0 ** -20 * score
        grow = torch.exp(2 * d)
        bound = torch.expm1(2 * d) * a
    bound = bound + 2.0 ** -8 * grow * a
    if not _bf16_exact(v):
        bound = bound + 2.0 ** -8 * grow * a
    return bound + flash_attention_order_bound(want)


def _gamma(n: int) -> float:
    """The worst relative error of a float32 sum (or dot product) of n
    terms, in units of the sum of their magnitudes: n 2^-24."""
    return n * 2.0 ** -24


def flash_attention_lse_bound(q: torch.Tensor, k: torch.Tensor,
                              lse: torch.Tensor, *, causal: bool,
                              window: int | None = None, q_offset: int = 0,
                              kv_valid_len: int | None = None,
                              softcap: float = 0.0) -> torch.Tensor:
    """Per-row bound, (B, Hq, Sq), of |lse - lse'| for two forwards'
    logsumexps at the same q and k: the kernel's against its twin's or the
    float32 plain version's, or the twin's against the float32 plain
    version's; ``lse`` is either one's.

    * The scores. Each is a float32 dot product of dk terms, summed in
      another order by each (and scaled once, before or after the sum): it
      lies within (dk + 1) 2^-24 A_i of the exact score in each of the
      two, A_i = max_j sum_d |q_d||k_jd| / sqrt(dk) over row i's valid keys
      (natural units; the kernels' log2 units' log2(e) cancels against the
      ln 2 that turns their lse back). Shifting every score of a row by at
      most D moves its lse by at most D: 2 (dk + 1) 2^-24 A_i for the two.
    * The denominator l: a float32 sum of at most Sk positive terms
      (relative error Sk 2^-24), each p_j an exponential within 2^-22 of
      its value (torch.exp, exp2, the kernels' ex2.approx), and one
      rescale by corr a tile (one exponential and one product, 2^-21);
      log(l) moves by the relative error of l: 2 (Sk 2^-24 + 2^-22 + T
      2^-21) for the two, T = ceil(Sk / FLASH_TILE) tiles.
    * The last operations (log2f / log, the add, the kernels' product by
      ln 2): a few ulps of |lse|, taken as 2^-21 (1 + |lse|).
    * q or K not bf16-exact: the twin and the kernel read them rounded to
      bf16, which moves each score by at most 2^-8 (1 + 2^-8) A_i, and the
      lse by as much.
    * ``softcap``: the cap cap tanh(s / cap) has slope at most 1, so the
      shifts above pass through it unchanged; its float32 evaluation puts
      each capped score within 2^-21 A_i of the exact one on each side
      (``flash_attention_rounding_bound``'s derivation), 2^-20 A_i for the
      two, and the lse moves by as much."""
    b, sq, hq, dk = q.shape
    sk = k.shape[1]
    valid = sk if kv_valid_len is None else kv_valid_len
    a = _max_abs_score(q, k, causal, window, q_offset, valid)[..., 0]
    a = a.permute(0, 2, 1)                                  # (B, Hq, Sq)
    tiles = -(-sk // FLASH_TILE)
    bound = (2 * (dk + 1) * 2.0 ** -24 * a
             + 2 * (_gamma(sk) + 2.0 ** -22 + tiles * 2.0 ** -21)
             + 2.0 ** -21 * (1 + lse.float().abs()))
    if not (_bf16_exact(q) and _bf16_exact(k)):
        bound = bound + 2.0 ** -8 * (1 + 2.0 ** -8) * a
    if softcap:
        bound = bound + 2.0 ** -20 * a
    return bound


def flash_attention_bwd_bound(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool, window: int | None = None,
                              q_offset: int = 0,
                              kv_valid_len: int | None = None,
                              softcap: float = 0.0
                              ) -> tuple[torch.Tensor, ...]:
    """Per-element bounds (float64, of dq's, dk's and dv's shapes) of
    |g - g32|: g the gradients ``flash_attention_bwd_ref`` gives from a
    forward's ``out`` and ``lse`` (the kernel's, out in q's type), g32
    autograd through ``attend_onepass`` on float32 copies of q, k, v and
    dout. Each side is bounded against the float64 gradients g64 (the same
    softmax attention in float64, one batch row at a time) and the bound
    is the sum of the two, plus 2^-22 |g64|.

    With P the float64 weights, dP = dout . v, delta = rowsum(dout o),
    dS = P (dP - delta), and for each side a bound dP_err on each weight,
    e_delta on each delta and e_dp on each dP:
      e_dS = dP_err |dP - delta| + (P + dP_err)(e_dp + e_delta)
             + 2^-23 |dS|
      e_dv = sum_i dP_err |dout| + gamma(g Sq) sum_i P |dout|
      e_dq = scale (sum_j e_dS |k| + gamma(Sk) sum_j |dS| |k|)
      e_dk = scale (sum_i e_dS |q| + gamma(g Sq) sum_i |dS| |q|)
    (sums over the query heads of a KV head for dk and dv; gamma(n) =
    n 2^-24, a float32 sum of n terms; e_dp = gamma(dv) sum_d |dout||v|).

    * The port recomputes P = exp(s - lse) from its own lse: with delta_i
      = |lse_i - lse64_i| (measured), s within gamma(dk) S_ij + 2^-23 |s|
      of the exact score (S_ij = sum_d |q||k| / sqrt(dk)), and exp within
      2^-22: dP_err = P (expm1(delta_i + gamma(dk) S_ij + 2^-23 |s_ij|) +
      2^-22). Its delta is taken from ``out``: e_delta = sum_d |dout|
      |out - o64| (measured) + gamma(dv) sum_d |dout| |out|. Its
      gradients are rounded to the inputs' types at the end: 2^-8 (|g64|
      + e) more for a bf16 input.
    * The float32 softmax: each score within gamma(dk) A_i of its value,
      the max subtracted, l summed over Sk terms: dP_err = P (expm1(2
      gamma(dk) A_i + gamma(Sk)) + 2^-22); autograd's delta is sum_j P dP,
      so e_delta = sum_j (dP_err |dP| + P e_dp) + gamma(Sk) sum_j P |dP|.

    ``softcap``: P is the softmax of the capped scores c = cap t, t =
    tanh(s / cap), and dS = P (dP - delta) f with f = 1 - t^2 (the cap's
    slope). The slope is at most 1, so each side's score errors above pass
    through the cap, and its float32 evaluation adds 2^-21 |s| to each
    capped score (``flash_attention_rounding_bound``'s derivation): the
    port's dP_err takes 2^-21 |s_ij| more in its exponent, the float32
    side's 2 2^-21 A_i. Each side's f is off by e_f: its score's error e_s
    moves t by f e_s / cap, so t^2 by 2 |t| f e_s / cap; the evaluation of
    t (2^-22 |t|, and under 2^-24 from the argument's rounding, max_x x
    sech^2 x < 1/2) moves t^2 by under 2^-21 + 2^-23, and the square and
    the subtraction round by 2^-24 each: e_f <= 2 |t| f e_s / cap + 2^-20.
    So e_dS = f (dP_err |dP - delta| + (P + dP_err)(e_dp + e_delta))
    + e_f |P (dP - delta)| + 2^-23 |dS|."""
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    f = torch.float64
    scale = 1.0 / math.sqrt(dk)
    valid = sk if kv_valid_len is None else kv_valid_len
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(sk, device=q.device)
    ok = (kv_pos < valid)[None, :].expand(sq, sk)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (q_pos[:, None] - kv_pos[None, :] < window)
    cap_err = 2.0 ** -21 if softcap else 0.0
    bq, bk, bv = [], [], []
    for i in range(b):
        qd, gd = q[i].to(f), dout[i].to(f)                  # (Sq, Hq, d)
        kd = k[i].to(f).repeat_interleave(g, dim=1)         # (Sk, Hq, dk)
        vd = v[i].to(f).repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", qd, kd) * scale
        s_fin = torch.where(ok, s, 0.0).abs()               # raw |s|
        t, fac = None, 1.0
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
            fac = 1.0 - t * t
        s = torch.where(ok, s, -math.inf)
        p = torch.softmax(s, dim=-1)
        lse64 = torch.logsumexp(s, dim=-1)                  # (Hq, Sq)
        o64 = torch.einsum("hqk,khd->qhd", p, vd)
        dp = torch.einsum("qhd,khd->hqk", gd, vd)
        delta = (gd * o64).sum(-1).T                        # (Hq, Sq)
        ds_c = p * (dp - delta[..., None])
        ds = ds_c * fac
        s_abs = torch.where(ok, torch.einsum(
            "qhd,khd->hqk", qd.abs(), kd.abs()) * scale, 0.0)
        e_dp = _gamma(dv) * torch.einsum("qhd,khd->hqk", gd.abs(), vd.abs())

        def fac_err(e_s):
            if not softcap:
                return 0.0
            return 2 * t.abs() * fac * e_s / softcap + 2.0 ** -20

        def grads_err(p_err, e_delta, e_fac):
            e_ds = (fac * (p_err * (dp - delta[..., None]).abs()
                           + (p + p_err) * (e_dp + e_delta[..., None]))
                    + e_fac * ds_c.abs() + 2.0 ** -23 * ds.abs())
            e_v = (torch.einsum("hqk,qhd->khd", p_err, gd.abs())
                   + _gamma(g * sq) * torch.einsum("hqk,qhd->khd", p,
                                                   gd.abs()))
            e_q = scale * (torch.einsum("hqk,khd->qhd", e_ds, kd.abs())
                           + _gamma(sk) * torch.einsum(
                               "hqk,khd->qhd", ds.abs(), kd.abs()))
            e_k = scale * (torch.einsum("hqk,qhd->khd", e_ds, qd.abs())
                           + _gamma(g * sq) * torch.einsum(
                               "hqk,qhd->khd", ds.abs(), qd.abs()))
            fold = (sk, hkv, g, -1)
            return e_q, e_k.reshape(fold).sum(2), e_v.reshape(fold).sum(2)

        # the port: P from its own lse, delta from its own out
        d_lse = (lse[i].to(f) - lse64).abs()
        e_s = _gamma(dk) * s_abs + 2.0 ** -23 * s_fin
        p_err = p * (torch.expm1(d_lse[..., None] + e_s + cap_err * s_fin)
                     + 2.0 ** -22)
        e_delta = (gd.abs() * (out[i].to(f) - o64).abs()
                   + _gamma(dv) * gd.abs() * out[i].to(f).abs()).sum(-1).T
        port = grads_err(p_err, e_delta, fac_err(e_s))
        # autograd through the float32 one-pass softmax
        a_row = s_abs.amax(-1, keepdim=True)
        p_err32 = p * (torch.expm1(2 * (_gamma(dk) + cap_err) * a_row
                                   + _gamma(sk)) + 2.0 ** -22)
        e_delta32 = (p_err32 * dp.abs() + p * e_dp).sum(-1) + \
            _gamma(sk) * (p * dp.abs()).sum(-1)
        f32 = grads_err(p_err32, e_delta32, fac_err(_gamma(dk) * a_row))
        # the float64 gradients, for the relative terms
        g64 = (scale * torch.einsum("hqk,khd->qhd", ds, kd),
               (scale * torch.einsum("hqk,qhd->khd", ds, qd)).reshape(
                   sk, hkv, g, dk).sum(2),
               torch.einsum("hqk,qhd->khd", p, gd).reshape(
                   sk, hkv, g, dv).sum(2))
        outs = []
        for e_port, e_32, ref64, like in zip(port, f32, g64, (q, k, v)):
            e = e_port + e_32 + 2.0 ** -22 * ref64.abs()
            if like.dtype == torch.bfloat16:
                e = e + 2.0 ** -8 * (ref64.abs() + e_port)
            outs.append(e)
        bq.append(outs[0])
        bk.append(outs[1])
        bv.append(outs[2])
    return torch.stack(bq), torch.stack(bk), torch.stack(bv)
