"""The count of work of each kernel: operations and device-memory bytes as
functions of shapes (and, where the work depends on the data, of counts
taken from it), one source for ``chip_smoke.py``'s bounds, the dry-run's
meta routes (``launch/op_stats.py``) and the roofline.

A ``Work`` holds the operations a kernel needs, by the rate they run at
(``"bf16"``: the dense tensor-core rate; ``"fp32"`` and ``"int32"``: the
CUDA cores' instruction rates; ``launch/mesh.py``'s H100 constants), and
the bytes it must move: each input read once and each output written
once, whatever the kernel reads again. Its ``bound_ms`` is the least time
the card could take: the larger of bytes over the HBM rate and each rate's
operations over that rate.

Where the work depends on the data (a beam search's hops, the rows a scan
finds valid), the caller passes what its data needs (``chip_smoke.py``
counts it from the run) or, without data (the dry-run on meta tensors), a
bound: ``beam_search_worst`` prices every lane taking ``max_iters`` hops,
as the JAX package's while loop's known trip count does, and
``cluster_scan_worst`` every row of every lane's cluster valid.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import numpy as np

from ..launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FP32_OPS, \
    PEAK_INT32_OPS

__all__ = ["RATES", "Work", "rank_bytes", "slot_ops", "binary_ip_rank",
           "cluster_scan", "cluster_scan_worst", "beam_search",
           "beam_search_worst", "topk_select", "topk_select_sorts",
           "merge_topk", "visible_keys", "flash_attention",
           "flash_staged_bytes", "recording", "record"]

RATES = {"bf16": PEAK_FLOPS_BF16, "fp32": PEAK_FP32_OPS,
         "int32": PEAK_INT32_OPS}


class Work(NamedTuple):
    """Operations by rate name (``RATES``) and bytes moved."""
    ops: dict
    bytes: float

    def seconds(self) -> tuple[float, float]:
        """(bytes over the HBM rate, the slowest rate's operations over
        it)."""
        to = max((n / RATES[r] for r, n in self.ops.items()), default=0.0)
        return self.bytes / HBM_BW, to

    def bound_ms(self) -> float:
        return 1e3 * max(self.seconds())

    def bound_by(self) -> str:
        tb, to = self.seconds()
        return "bytes" if tb >= to else "operations"

    def bound(self) -> tuple[float, str]:
        """(``bound_ms``, ``bound_by``)."""
        return self.bound_ms(), self.bound_by()

    def flops(self) -> float:
        """The operations at the bf16 tensor-core rate, and the others
        priced as the tensor-core operations of the same time (what the
        roofline's compute term divides by that rate)."""
        return sum(n * PEAK_FLOPS_BF16 / RATES[r]
                   for r, n in self.ops.items())


def rank_bytes(kind: str, w: int) -> tuple[int, int]:
    """(bytes a ranked row reads beside its W code bytes, bytes of a lane's
    rank operands): O3 ("mulfree") f_add and the int32 LUT, sumq, s1, s2;
    Hamming nothing and the W-byte qcode; Exact residual_norm and
    cos_theta and the float LUT, sum_lut, query_norm."""
    if kind == "hamming":
        return 0, w
    if kind == "exact":
        return 8, (8 * w + 2) * 4
    return 4, (8 * w + 3) * 4


def slot_ops(kind: str, w: int) -> tuple[float, str]:
    """(operations ranking one (lane, row) slot takes at least, the rate's
    name): a table lookup and an add per code byte (O3, 2 W), per half
    byte in float32 plus the estimator's ten (Exact, 4 W + 10), an XOR, a
    popcount and an add per 32-bit word (Hamming, 3 W / 4)."""
    if kind == "hamming":
        return 3 * w / 4, "int32"
    if kind == "exact":
        return 4 * w + 10, "fp32"
    return 2 * w, "int32"


def binary_ip_rank(*, slots: int, real_slots: int, distinct_rows: int,
                   live_lanes: int, w: int, dim: int, lut_width: int) -> Work:
    """The O3 rank of (L, R) gathered rows. Bytes: each distinct real row's
    code and f_add once (lanes that probe one cluster gather the same
    rows), the LUT, sumq, s1 and s2 of each lane with a real row (a lane of
    -1 rows needs none), every row id read and every rank written.
    Operations: a mask and an add per code bit of each real (lane, row)
    slot, at the int32 rate."""
    nbytes = (distinct_rows * (w + 4) + live_lanes * (lut_width + 3) * 4
              + slots * 4 + slots * 4)
    return Work({"int32": 2 * real_slots * dim}, nbytes)


def cluster_scan(*, kind: str, w: int, ef: int, n_lanes: int,
                 live_lanes: int, cluster_rows: int,
                 scanned_rows: int) -> Work:
    """Whole-cluster rank + top-EF of every lane. Bytes: each distinct
    probed cluster's valid rows (``cluster_rows``: code and per-row
    factors, ``rank_bytes``) once, the rank operands and two scalars of
    each live lane, the (L, EF) ids and ranks written. Operations:
    ``slot_ops`` per valid row of every live lane (``scanned_rows``; O3:
    one table lookup and one add per code byte, 2 W a row: a lane's LUT is
    fixed for its scan, so S = sum over the code bytes b of T[b][code[b]],
    with T[b][x] the LUT summed over the set bits of x, the least a row's
    rank takes; the tables' ~8 x 256 W adds a lane and the epilogue's few
    operations a row are left out)."""
    row_extra, lane_bytes = rank_bytes(kind, w)
    nbytes = (cluster_rows * (w + row_extra) + live_lanes * (lane_bytes + 8)
              + n_lanes * ef * 8)
    per_slot, rate = slot_ops(kind, w)
    return Work({rate: per_slot * scanned_rows}, nbytes)


def cluster_scan_worst(*, kind: str, w: int, ef: int, n_lanes: int,
                       m: int) -> Work:
    """``cluster_scan`` without data: every lane live, each on a cluster
    of its own, all m rows of it valid."""
    return cluster_scan(kind=kind, w=w, ef=ef, n_lanes=n_lanes,
                        live_lanes=n_lanes, cluster_rows=n_lanes * m,
                        scanned_rows=n_lanes * m)


def beam_search(*, kind: str, w: int, r: int, ef: int, n_lanes: int,
                entries: int, expanded: int, rows: int,
                slots: int) -> Work:
    """The whole beam search of every lane. Bytes: each distinct
    neighbour-table row expanded (``expanded``, 4 R bytes) and each
    distinct row ranked (``rows``: its code and per-row factors,
    ``rank_bytes``) once, since lanes that probe one cluster start from
    its entry and share rows; the rank operands of each lane with an entry
    (``entries``: every such lane ranks it), each lane's two int32 scalars
    and its active flag, the (L, EF) ids and ranks and the (L,) hops
    written. Operations: ``slot_ops`` per ranked (lane, row) slot
    (``slots``), the least a row's rank takes."""
    row_extra, lane_bytes = rank_bytes(kind, w)
    nbytes = (expanded * 4 * r + rows * (w + row_extra)
              + entries * lane_bytes + n_lanes * (2 * 4 + 1)
              + n_lanes * (ef * 8 + 4))
    per_slot, rate = slot_ops(kind, w)
    return Work({rate: slots * per_slot}, nbytes)


def beam_search_worst(*, kind: str, w: int, r: int, ef: int, n_lanes: int,
                      max_iters: int, table_rows: int) -> Work:
    """``beam_search`` without data: every lane has an entry and takes
    ``max_iters`` hops (the bound on iterations), each expanding one row
    and ranking its R neighbours plus the entry, no row shared between
    lanes, at most the ``table_rows`` rows of the table distinct."""
    slots = n_lanes * (max_iters * r + 1)
    return beam_search(kind=kind, w=w, r=r, ef=ef, n_lanes=n_lanes,
                       entries=n_lanes,
                       expanded=min(n_lanes * max_iters, table_rows),
                       rows=min(slots, table_rows), slots=slots)


def merge_topk(q: int, w: int, k: int) -> Work:
    """Top-k of (Q, W) runs. Bytes: every (id, dist) slot read once, k of
    each written per row. Operations: one compare per slot, at the
    float32 rate."""
    return Work({"fp32": q * w}, q * w * 8 + q * k * 8)


def topk_select(q: int, c: int, k: int) -> Work:
    """Dedup + top-k of (Q, C). Bytes: ids and dists read, k of each
    written per row. Operations: one keep-first table probe and one
    compare per slot, 2 Q C at the float32 rate (as ``merge_topk``)."""
    return Work({"fp32": 2 * q * c}, q * c * 8 + q * k * 8)


def topk_select_sorts(q: int, c: int, k: int) -> Work:
    """``topk_select``'s bytes with the compares of two C log2 C sorts a
    row: the first design's work rather than the function's, logged beside
    the bound only."""
    return Work({"fp32": 2 * q * c * max(1, math.ceil(math.log2(c)))},
                q * c * 8 + q * k * 8)


def visible_keys(sq: int, sk: int, causal: bool, window: int | None,
                 q_offset: int, kv_valid_len: int | None) -> tuple[int, int]:
    """(valid keys summed over the query rows, the furthest key any row
    sees + 1) under the attention mask."""
    valid = sk if kv_valid_len is None else kv_valid_len
    pos = q_offset + np.arange(sq)
    hi = np.minimum(valid, pos + 1) if causal else np.full(sq, valid)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq)
    return int(np.maximum(hi - lo, 0).sum()), int(hi.max())


def flash_attention(*, b: int, sq: int, sk: int, hq: int, hkv: int, dk: int,
                    dv: int, q_bytes: int, kv_bytes: int, causal: bool,
                    window: int | None = None, q_offset: int = 0,
                    kv_valid_len: int | None = None, alias: bool = False,
                    softcap: float = 0.0) -> Work:
    """The attention forward. Operations: a multiply-add per (query row,
    head, dk column, valid key) for QK^T and one per dv column for PV,
    2 B Hq (dk + dv) (valid keys summed over the rows), at the dense bf16
    tensor-core rate; with ``softcap``, three float32 operations per
    (row, head, valid key) score besides (the argument's product, the
    tanh counted as one, the product by the cap). Bytes: q once (element
    size ``q_bytes``), the K rows some query can see once and the V rows
    once (``kv_bytes`` each; not again when v is a view of k's own rows,
    ``alias``, as MLA's latent cache), the output (q's type, dv wide)
    once."""
    keys, reach = visible_keys(sq, sk, causal, window, q_offset,
                               kv_valid_len)
    kv_row = dk * kv_bytes + (0 if alias else dv * kv_bytes)
    nbytes = (b * sq * hq * dk * q_bytes + b * sq * hq * dv * q_bytes
              + b * reach * hkv * kv_row)
    ops = {"bf16": 2 * b * hq * (dk + dv) * keys}
    if softcap:
        ops["fp32"] = 3 * b * hq * keys
    return Work(ops, nbytes)


def flash_staged_bytes(*, b: int, sq: int, sk: int, hq: int, hkv: int,
                       dk: int, dv: int, kv_bytes: int, causal: bool,
                       window: int | None = None, q_offset: int = 0,
                       kv_valid_len: int | None = None, alias: bool = False,
                       rows: int = 64, share: int = 1) -> int:
    """The K/V bytes one launch of a tensor-core attention kernel stages
    from L2 into shared memory: the traffic its design makes, not its
    bound. A block serves ``rows`` query rows, gh query heads of one KV
    head (the largest of 16, 8, 4, 2 and 1 that divides the group) at rows
    / gh positions, and stages every 64-key tile that some row of it can
    see, whole (rows past the cache count too): dk columns of K and,
    unless v is a view of k's rows (``alias``), dv of V, ``kv_bytes``
    each. The blocks of a KV head go head sets first, then query blocks
    from the last; ``share`` consecutive ones form a cluster that stages
    the union of their tiles once (each tile multicast to all of them)."""
    g = hq // hkv
    gh = next(x for x in (16, 8, 4, 2, 1) if g % x == 0)
    rows_h = rows // gh
    valid = sk if kv_valid_len is None else kv_valid_len
    n_qb = -(-sq // rows_h)
    q0 = (n_qb - 1 - np.arange(g // gh * n_qb) // (g // gh)) * rows_h
    lo = q_offset + q0
    hi = q_offset + np.minimum(q0 + rows_h, sq) - 1
    end = np.minimum(valid, hi + 1) if causal else np.full(len(q0), valid)
    first = (np.maximum(0, lo - window + 1) if window else 0 * lo) // 64 * 64
    tiles = sum(-(-(end[i:i + share].max() - first[i:i + share].min()) // 64)
                for i in range(0, len(q0), share))
    row_bytes = (dk + (0 if alias else dv)) * kv_bytes
    return int(b * hkv * tiles * 64 * row_bytes)


# ---------------------------------------------------------------------------
# recording: the meta routes of ``kernels/ops.py`` report each launch's work
# to whatever counts it (``launch/op_stats.py``)
# ---------------------------------------------------------------------------

_recorders = threading.local()


@contextlib.contextmanager
def recording(sink):
    """Within the block, each kernel call on meta tensors (``ops``' meta
    routes) calls ``sink(name, work)``; blocks nest, the innermost sink
    takes the record."""
    stack = getattr(_recorders, "stack", None)
    if stack is None:
        stack = _recorders.stack = []
    stack.append(sink)
    try:
        yield
    finally:
        stack.pop()


def record(name: str, work: Work) -> None:
    """Report one kernel call's work to the innermost ``recording`` sink
    (none outside a ``recording`` block)."""
    stack = getattr(_recorders, "stack", None)
    if stack:
        stack[-1](name, work)
