#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the PIMCQG query path on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch / CUDA versions and
     the TF32 flags, which are switched off;
  2. build every kernel from src/repro_torch/kernels/csrc/ (one nvcc per
     source, all started together) into build/kernels/, log ptxas's
     registers, shared memory and spills of each kernel and the dynamic
     shared memory a block of each selection route takes, and count the
     tensor-core instructions (HGMMA / HMMA) in the flash library's SASS,
     which must not be zero;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes: the search kernels bitwise, with pads, INT_MAX
     rows, int32 wraps, duplicates, ties and all-pad rows injected, and
     cluster_scan also on ranks falling, equal and late in row order (its
     running threshold's worst case and edges), the main path's cluster
     budget M = 17,089, LUT entries set past dim, and W = 256 (its nibble
     tables); topk_select and merge_topk by both routes (warp and block) on
     the same rows, from 1 to 4,096 columns across both route boundaries,
     with NaN, +-inf, -0.0, duplicates and pads, float32 bit for bit, a
     warp launch past the route's limits refused; the rows ROADMAP C3
     opened (topk_select at C = 4,160 in
     passes, merge_topk at O k = 4,800 as a tree, cluster_scan at EF =
     1,500); beam_search bitwise in ids, ranks and hops on the adversarial
     cases named in ``phase_beam_synthetic`` (the visited quirk, ties,
     INT_MIN / INT_MAX, EF 1 to 100, R 16 to 48, the hop cap, inactive
     lanes, M = 17,089 at 16,384 lanes, W 16 and 64), and its hamming and
     exact policies and cluster_scan's at the main path's shape, with NaN,
     +-inf, tied and pad ranks (``phase_ranked_synthetic``);
     flash_attention over GQA groups 1 and 4, head dims 64 / 80 / 96 / 128
     / 160,
     ragged Sq and Sk, q_offset, a window that bites, kv_valid_len < Sk and
     bf16 q over float32 K/V: float32 q within a stated per-element bound
     of the float32 plain version (float32 sums in another order); bf16 q
     (the tensor-core kernel) within that bound, plus the one-weight bf16
     flip term, of its twin (``operands=torch.bfloat16``), and within the
     derived ``flash_attention_rounding_bound`` of the float32 plain
     version, as the twin is; and head dim 160 at stablelm-12b's shape,
     timed beside scaled_dot_product_attention;
  4. build the index of a 10M x 128 clustered corpus (big-ann-benchmarks'
     10M BIGANN/SIFT subset scale, SIFT's width) on the card, 4096 clusters
     on 8 shards; run the build's k-means twice more from its seed and
     hold both runs' centroids, assignment and sizes bitwise against each
     other and the build's centroids (ROADMAP C5), and print a digest of
     the built index (every CompactIndex tensor and the vectors), which
     two runs of the smoke must share;
  5. search 1024 queries through PIMCQGEngine.search with the launch counts
     set to 0 just before and read just after (one beam_search, one
     topk_select, no binary_ip_rank); recall@10 against brute-force
     ground truth computed on the card;
  6. break one search's time down by stage, and profile one search for
     the device's busy share and its kernels by device time;
  7. hold each kernel bitwise against its plain version on the real
     search's inputs (beam_search on the search's own arguments, timed
     beside its bound and the old path, the plain lock-step loop with one
     binary_ip_rank launch a hop; binary_ip_rank on one hop's lane LUTs
     and rows and on a gemv-shaped call over the cluster budget; the
     rerank candidates, by both topk_select routes), and time both there:
     the two topk_select routes in turns, torch.topk(d, k, largest=False)
     on the same rows as a yardstick of the selection alone, and the bound
     beside the first design's count of its operations;
  8. search the same queries in GEMV mode (scan="gemv": one cluster_scan
     launch ranks every probed cluster whole), counted like phase 5;
     8b. the exact and hamming backends, each a view of the same engine
     (only its own arrays placed anew), search the same queries by beam
     and by GEMV, counted like phases 5 and 8, each recall@10 held to a
     floor taken from the JAX package (RECALL_FLOORS), and the kernels'
     rank policies (beam_search/exact, beam_search/hamming,
     cluster_scan/exact, cluster_scan/hamming) held bitwise (float32 ranks
     by their bits) against their plain versions on the counted searches'
     own arguments and timed there beside their bounds;
  9. serve them through the sharded tier, TopologyConfig(shards=8).build:
     8 disjoint partition engines, scatter, search_probed, and the origin
     merge through merge_topk; after one warm-up run, the first of five
     timed runs is counted and held against the single engine, and QPS,
     p50 and p99 are the median of the five;
     9b. a mixed tier over views of the same 8 partition engines, their
     backends cycling mulfree, exact, hamming: the queries unrestricted and
     with backend= None / "exact" alternating; every partial equal to its
     engine's own search_probed, the ids to merge_topk_ref of the partials,
     the restricted rows' ids all from exact partitions;
     9c. the skew-aware tier on the same engine (after phase 10, once
     phase 9's tier is released): 4,096 Zipf(1.0) queries over a hot blob
     of clusters (the index build's own row -> cluster assignment) on the
     size-prior 8-shard tier, then on TopologyConfig(replicate_hot=64,
     replica_factor=4).build(eng, heat=cluster_hits), counted like phase 9
     and held against engine.search in every slot (distances bit for bit,
     ids outside exact distance ties); three rounds of
     drifting Zipf(1.4) traffic through a Rebalancer whose placement swaps
     apply_placement re-slices on the card (it must fire; ids hold after
     every swap, against eng.search with room for every lane; allocated
     memory within 1 GiB); two tenants (a latency
     tenant cut to nprobe 4), each tenant's rows equal to its queries
     served alone; hedged dispatch over two replicas a shard and
     scale_replicas, ids unchanged;
 10. hold merge_topk (by both routes) and cluster_scan bitwise against their
     plain versions on those runs' real inputs (cluster_scan on the
     arguments of phase 8's counted launch), and time both there, the two
     merge_topk routes in turns; cluster_scan's shared memory per
     block and phase 2's ptxas lines are logged, and its bound beside PR
     12's count of its operations;
 13. the mesh execution backend (after phase 10, once phase 9's tier is
     released): seven follower ranks spawned (launch.mesh.follower_main)
     and this process, the origin, in one 8-rank gloo group (all ranks
     share the card, so NCCL cannot run) through a file store under build/;
     TopologyConfig(shards=8, buckets=(256, 1024), exec=MeshBackend(mesh))
     .build(engine) places each partition on its rank; the 1024 queries at
     t = 0, one warm-up and five runs, the first counted on every rank
     (beam_search and topk_select on each, merge_topk at the origin), each
     held against phase 9's tier (distances bit for bit, ids outside exact
     ties), rank 0's beam_search, topk_select and merge_topk calls held
     bitwise against their plain versions; QPS / p50 / p99 (median of 5)
     beside phase 9's, the all_gather's ms, a refresh of every partition
     (results unchanged), each rank's peak memory; then a gemv mesh tier
     (cluster_scan on every rank, rank 0's held against the plain
     version) against the in-process tier over its partitions;
 11. serve h2o-danube-1.8b at full width (24 x 2560, 32 / 8 heads of 80,
     seeded random bf16 weights) through repro_torch.launch.serve.generate:
     8 requests of 2048 prompt tokens, 32 generated, float32 KV cache, the
     first decode step's queries served by a StreamingScheduler over the
     10M engine; counted like phase 5 (24 flash_attention launches, one a
     layer of the prefill); the retrieved ids held against engine.search of
     the same queries, the last decode step's logits against a prefill of
     the prompt and the generated tokens (the kernel against the plain
     one-pass decode attention; the greedy token equal in every row), and
     the kernel on layer 0's real q / k / v held as in phase 3 (whether
     those K/V are bf16-exact is logged), its and
     scaled_dot_product_attention's max and 99.9th-percentile |error|
     against a float64 computation (the kernel's percentile within 1.25x
     of SDPA's), and timed there beside its bound, its twin, the float32
     plain version and scaled_dot_product_attention;
 12. the mutable index at 10M x 128 (after phase 11, phase 4's engine
     dropped, its index and vectors kept): MutableIndex(slab=S) with S from
     the churn draw (the fullest cluster's inserts under frozen-centroid
     assign, rounded up to 32, at least 64); its snapshot held bitwise
     against rebuild() in all 13 CompactIndex fields and the vectors; the
     1024 queries through TopologyConfig(shards=8, mutable=True) over
     mut.to_engine(n_shards=8), counted, QPS / p50 / p99 the median of
     five runs; the JAX package's update churn (benchmarks/churn.py): 1%,
     the 100,000 lowest live ids deleted and re-inserted as vectors[drop]
     + 0.05 N(0, 1) (default_rng(0)) under ids from N up, the first 256
     inserts linked in rounds and held bitwise against graph.link_new on
     copies of their clusters; topo.apply(mut) from the ticker of a run
     (no deleted id served, every admitted row k live ids, allocated
     memory within 1 GiB across the swap, tombstones billed reclaimable);
     recall@10 over the live corpus at SearchConfig() and at ef 64 (a view
     of the mutable engine); compact(), apply, the snapshot against
     rebuild() again, the tier against the refreshed engine (distances
     bitwise, ids outside exact ties), reclaimable bytes 0, and the recall
     drift at ef 64 within 0.01 (benchmarks/churn.py's DRIFT_BOUND); each
     step's seconds and peak allocated memory logged.
The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N = 10_000_000               # corpus rows: big-ann-benchmarks' 10M scale
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
# Instruction rates outside the tensor cores: 132 SMs at the 1.98 GHz boost
# clock; per SM and clock 128 float32 lanes (the data sheet's 67 TFLOP/s
# counts an FMA as two) and 64 int32 lanes (Hopper architecture whitepaper).
H100_FP32_OPS = 132 * 128 * 1.98e9
H100_INT32_OPS = 132 * 64 * 1.98e9
H100_BF16_FLOPS = 989e12     # dense tensor-core bf16, H100 SXM data sheet
INT_MAX = 2**31 - 1
MIXED = ("mulfree", "exact", "hamming")   # phase 9b's backends, by shard
MESH_RANKS = 8               # phase 13: one process a shard, phase 9's 8
MESH_TIMEOUT_S = 300.0       # a mesh collective that waits longer fails
# recall@10 floors of phase 8b: the JAX package's recall on a 100k-point,
# 40-cluster version of the corpus (scripts/backend_recall.py, CPU), less
# the margin the mulfree floor of 0.5 keeps below its JAX recall there
# (floor = JAX(mode, scan) - (JAX(mulfree, scan) - 0.5), rounded down: JAX
# gives mulfree 0.6394 / 0.6642, exact 0.6404 / 0.6508, hamming 0.4088 /
# 0.3362, beam / gemv)
RECALL_FLOORS = {"exact/beam": 0.50, "exact/gemv": 0.48,
                 "hamming/beam": 0.26, "hamming/gemv": 0.17}
ERRS: dict[str, float] = {}  # kernel name -> max |kernel - plain| seen
PTXAS: dict[str, list] = {}  # kernel name -> phase 2's ptxas resource lines
T0 = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def profiled(torch, fn, iters: int = 1):
    """Kernel records of ``iters`` calls of fn under torch.profiler:
    (wall ms of those calls, [(kernel name, launches, device ms)]).

    The recorded calls follow a warm-up step of as many calls with the
    profiler already running (its records discarded), and sit 0.1 s inside
    their step on both sides: in this long process on the H100, sessions
    that recorded from their first launch to their last kept 96 of 100, 26
    of 30 and once 1 of 10 launches of a one-kernel call."""
    from torch.profiler import ProfilerActivity, profile, schedule
    kern, wall = [], []

    def ready(prof):
        kern.extend((e.key, e.count, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type.name == "CUDA" and e.count > 0
                    and not e.key.startswith("ProfilerStep"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            time.sleep(0.1)
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t))
            time.sleep(0.1)
            prof.step()
    return wall[-1], kern


def times(torch, fn, iters: int) -> tuple[float, float]:
    """(device ms, wall ms) per call of fn(), after a warm-up.

    Device ms: the durations of the kernels fn launches over ``iters``
    calls (``profiled``), summed and divided by ``iters``; host gaps between
    launches are left out. The record counts only if every kernel name was
    launched a whole multiple of ``iters`` times; up to three sessions are
    made. Wall ms: CUDA events around ``iters`` calls launched back to
    back, which a host slower than the kernel bounds from below. Device ms
    is None where no session recorded a whole set of launches."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    wall = a.elapsed_time(b) / iters
    for attempt in range(3):
        _, kern = profiled(torch, fn, iters)
        if kern and all(n % iters == 0 for _, n, _ in kern):
            return sum(ms for _, _, ms in kern) / iters, wall
        log(f"profiler session {attempt + 1} kept "
            f"{[n for _, n, _ in kern]} kernel records over {iters} calls; "
            f"measuring again")
    return None, wall


def log_top(kern, n: int) -> None:
    """The n kernels of a profiled record with the most device time."""
    for name, count, ms in sorted(kern, key=lambda r: -r[2])[:n]:
        log(f"  {ms:8.3f} ms  x{count:<5d} {name[:90]}")


def route_turns(torch, name, launch, iters):
    """Log the device ms per call of launch(route) for the warp and the
    block route on the same inputs, in turns (warp, block, block, warp)
    (CUDA-event wall ms where the profiler recorded no whole set of
    launches)."""
    out = {"warp": [], "block": []}
    for route in ("warp", "block", "block", "warp"):
        ms, wall = times(torch, lambda: launch(route), iters)
        out[route].append(ms if ms is not None else wall)
    log(f"{name}: warp route {', '.join(f'{v:.5f}' for v in out['warp'])} "
        f"ms, block route {', '.join(f'{v:.5f}' for v in out['block'])} ms "
        f"on the device (turns warp, block, block, warp)")


def timed_row(torch, name, kernel, plain, iters, bound):
    """Time a kernel and its plain version (device ms as the result, the
    event wall ms beside it) and log them with the bound."""
    ms, wall = times(torch, kernel, iters)
    plain_ms, plain_wall = times(torch, plain, max(iters // 10, 3))
    if ms is None or plain_ms is None:
        log(f"{name}: device time not measured (no profiler session kept "
            f"every launch); CUDA-event wall ms stand in")
        ms, plain_ms = wall, plain_wall
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
               bound_by=bound[1])
    log(f"{name}: kernel {ms:.5f} ms on the device ({wall:.5f} ms event "
        f"wall per back-to-back call), plain {plain_ms:.5f} ms on the device "
        f"({plain_wall:.5f} wall), bound {bound[0]:.5f} ms ({bound[1]})")
    return row


def recording(module, name, fn):
    """fn() with ``module.name`` recording its calls' arguments: (fn's
    result, [args of each call])."""
    calls, real = [], getattr(module, name)

    def record(*args):
        calls.append(args)
        return real(*args)
    setattr(module, name, record)
    try:
        return fn(), calls
    finally:
        setattr(module, name, real)


def lane_subset(args, idx):
    """Ranked scan arguments (codes, rank, base_rows, n_valid, active) of
    the lanes ``idx`` (an index tensor or a slice)."""
    from repro_torch.kernels import ranks
    codes, rank, *per_lane = args
    return (codes, ranks.select_lanes(rank, idx),
            *(t[idx].contiguous() for t in per_lane))


def max_abs_err(torch, got, want) -> float:
    """max |got - want| over the entries finite in both (0.0 if none)."""
    g, w = got.double(), want.double()
    both = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w)[both].abs().max()) if both.any() else 0.0


def bitwise(torch, kernel, label, got, want) -> None:
    """Exact equality, a float32 tensor bit for bit (so NaN and -0.0 are
    held too), else fail; records the measured max |diff| under ``kernel``
    in ERRS."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{kernel} {label}: kernel gives {got.dtype} "
             f"{tuple(got.shape)}, plain version {want.dtype} "
             f"{tuple(want.shape)}")
    err = max_abs_err(torch, got, want)
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if not torch.equal(got, want):
        fail(f"{kernel} {label}: kernel disagrees with its plain version "
             f"(max |diff| {err})")
    ERRS[kernel] = max(ERRS.get(kernel, 0.0), err)


def close(torch, kernel, label, got, want, bound, record=True) -> None:
    """|got - want| <= bound in every element (same shape and dtype,
    finite), else fail; ``bound`` is a tensor of want's shape (or
    broadcasts to it). Records the measured max |diff| under ``kernel`` in
    ERRS (unless ``record`` is False: a comparison with another function
    than the kernel's plain version) and logs it with the worst share of
    its element's bound and the median |want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{kernel} {label}: kernel gives {got.dtype} "
             f"{tuple(got.shape)}, plain version {want.dtype} "
             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{kernel} {label}: non-finite output")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    worst = float((diff / bound.double()).max())
    over = int((diff > bound).sum())
    if record:
        ERRS[kernel] = max(ERRS.get(kernel, 0.0), err)
    msg = (f"max |kernel - plain| {err:.3g}, at most {worst:.3g} of its "
           f"element's bound (bound {float(bound.min()):.3g} to "
           f"{float(bound.max()):.3g}); median |plain| "
           f"{float(want.float().abs().median()):.3g}")
    if over:
        fail(f"{kernel} {label}: {over} elements over their bound; {msg}")
    log(f"{kernel} {label}: {msg}")


def attn_bound(torch, want):
    """Per-element bound of the attention kernel against its plain version
    (``ref.flash_attention_order_bound``): both sum in float32, in another
    order, so a float32 output moves by 2e-5 absolute, scaled by the
    largest |output| above 1; a bf16 output may also flip its rounding,
    2^-7 of its own |output|, never more than 2^-7 of the largest above
    1."""
    from repro_torch.kernels import ref
    return ref.flash_attention_order_bound(want)


def hold_bf16_attention(torch, label, got, q, k, v, kw) -> None:
    """The tensor-core kernel's output ``got`` (bf16 q) held twice: against
    its twin within ``attn_bound`` plus ``ref.flash_attention_flip_bound``
    (a weight that the kernel's ex2 and torch.exp2, or S summed in another
    order, round to other bf16 neighbours moves its row by up to 2^-7 of
    the row's largest p_j |v_j| / l; the elements that needed the term are
    counted), and against the float32 plain version within
    ``ref.flash_attention_rounding_bound``, as the twin itself is."""
    from repro_torch.kernels import ref
    twin = ref.flash_attention_ref(q, k, v, operands=torch.bfloat16, **kw)
    base = attn_bound(torch, twin)
    flip = ref.flash_attention_flip_bound(q, k, v, **kw)
    needed = int(((got.double() - twin.double()).abs() > base).sum())
    close(torch, "flash_attention", f"{label} vs twin", got, twin,
          base + flip)
    log(f"flash_attention {label}: {needed} of {got.numel()} elements "
        f"needed the bf16 flip term")
    plain = ref.flash_attention_ref(q, k, v, **kw)
    bound = ref.flash_attention_rounding_bound(q, k, v, **kw)
    close(torch, "flash_attention", f"{label} vs float32 plain", got, plain,
          bound, record=False)
    close(torch, "flash_attention", f"{label} twin vs float32 plain", twin,
          plain, bound, record=False)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def rank_bound(torch, rows, lut, w, dim):
    """Bytes: each distinct real row's code and f_add once (lanes that probe
    one cluster gather the same rows), the LUT, sumq, s1 and s2 of each lane
    with a real row (a lane of -1 rows needs none), every row id, every rank
    written. Operations: a mask and an add per code bit of each real
    (lane, row) slot, at the int32 rate."""
    real = rows >= 0
    distinct = int(torch.unique(rows[real]).numel())
    live = int(real.any(-1).sum())
    nbytes = (distinct * (w + 4) + live * (lut.shape[1] + 3) * 4
              + rows.numel() * 4 + rows.numel() * 4)
    ops = 2 * int(real.sum()) * dim
    tb, to = nbytes / H100_BYTES_PER_S, ops / H100_INT32_OPS
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def scan_bound(torch, args, dim, ef):
    """Bytes: each distinct probed cluster's valid rows (code and per-row
    factors, ``rank_bytes``) once, the rank operands and two scalars of
    each live lane, the (L, EF) ids and ranks written. Operations:
    ``slot_ops`` per valid row of every live lane (O3: one table lookup and
    one add per code byte, 2 W a row: a lane's LUT is fixed for its scan,
    so S = sum over the code bytes b of T[b][code[b]], with T[b][x] the LUT
    summed over the set bits of x, the least a row's rank takes; the
    tables' ~8 x 256 W adds a lane and the epilogue's few operations a row
    are left out). ``args`` are the ranked arguments (codes, rank,
    base_rows, n_valid, active). Returns (ms, "bytes" or "operations", ms
    by the bit count): the last prices a mask and an add per code bit, 2
    dim operations a row, as the bound of a kernel that ranks bit by
    bit."""
    codes, rank, base_rows, n_valid, active = args
    w = codes.shape[1]
    nv = n_valid[active].long()
    clusters = torch.unique(torch.stack([base_rows[active].long(), nv], 1),
                            dim=0)
    n_live = int(active.sum())
    row_extra, lane_bytes = rank_bytes(rank, w)
    nbytes = (int(clusters[:, 1].sum()) * (w + row_extra)
              + n_live * (lane_bytes + 2 * 4) + active.numel() * ef * 8)
    per_slot, rate = slot_ops(rank, w)
    tb, to = nbytes / H100_BYTES_PER_S, per_slot * int(nv.sum()) / rate
    old = max(tb, 2 * int(nv.sum()) * dim / H100_INT32_OPS)
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations",
            1e3 * old)


def merge_bound(q, w, k):
    """Bytes: every (id, dist) slot read once, k of each written per row.
    Operations: one compare per slot, at the float32 rate."""
    nbytes = q * w * 8 + q * k * 8
    tb, to = nbytes / H100_BYTES_PER_S, q * w / H100_FP32_OPS
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def topk_bound(q, c, k):
    """Bytes: ids and dists read, k of each written per row. Operations:
    one keep-first table probe and one compare per slot, 2 Q C at the
    float32 rate (as ``merge_bound``). Returns (ms, "bytes" or
    "operations", ms by the first design's count): the last prices the
    compares of two C log2 C sorts a row, that design's work rather than
    the function's, and is logged beside the bound only."""
    nbytes = q * c * 8 + q * k * 8
    tb, to = nbytes / H100_BYTES_PER_S, 2 * q * c / H100_FP32_OPS
    old = 2 * q * c * max(1, math.ceil(math.log2(c))) / H100_FP32_OPS
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations",
            1e3 * max(tb, old))


def flash_bound(q, k, v, causal, window, q_offset, kv_valid_len):
    """Operations: two multiply-adds (QK^T and PV) per (query row, head,
    head-dim column, valid key), 4 * B * Hq * hd * (valid keys summed over
    the rows), at the dense bf16 tensor-core rate. Bytes: q once, the K and
    V rows some query can see once, the output (q's type) once."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    valid = sk if kv_valid_len is None else kv_valid_len
    pos = q_offset + np.arange(sq)
    hi = np.minimum(valid, pos + 1) if causal else np.full(sq, valid)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq)
    keys = int(np.maximum(hi - lo, 0).sum())
    reach = int(hi.max())
    nbytes = (2 * q.numel() * q.element_size()
              + b * reach * k.shape[2] * d * (k.element_size()
                                              + v.element_size()))
    ops = 4 * b * hq * d * keys
    tb, to = nbytes / H100_BYTES_PER_S, ops / H100_BF16_FLOPS
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()}")
    return card


def phase_build_kernels():
    from repro_torch.kernels import _build
    t = time.perf_counter()
    reports = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t:.2f} s "
        f"({', '.join(_build.SOURCES)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line \
                    or "Function properties" in line:
                log(f"  ptxas {name}: {line.strip()}")
                PTXAS.setdefault(name, []).append(line.strip())
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build._target("flash_attn"))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass of the flash library: {sass.stderr.strip()}")
    hgmma, hmma = sass.stdout.count("HGMMA"), sass.stdout.count("HMMA.")
    log(f"flash library SASS: {hgmma} HGMMA and {hmma} HMMA instructions")
    if hgmma + hmma == 0:
        fail("the flash library's SASS holds no tensor-core instruction")
    from repro_torch.kernels import merge_topk, topk_select
    log("selection routes' dynamic shared memory a block (bytes; a warp "
        "route block takes 4 rows, a block route block one): topk_select "
        "warp C=320 "
        f"{topk_select.smem_bytes(320, 'warp')}, C=1024 "
        f"{topk_select.smem_bytes(1024, 'warp')}; block C=320 "
        f"{topk_select.smem_bytes(320, 'block')}, C=4096 "
        f"{topk_select.smem_bytes(4096, 'block')}; merge_topk warp W=80 "
        f"{merge_topk.smem_bytes(80, 'warp')}; block W=80 "
        f"{merge_topk.smem_bytes(80, 'block')}, W=4096 "
        f"{merge_topk.smem_bytes(4096, 'block')}")


def synthetic_rank_inputs(torch, dev, n_lanes, n_rows, w, t_rows, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)
    codes = ri(0, 256, (t_rows, w), torch.uint8)
    f_add = ri(0, 1 << 20, (t_rows,))
    f_add[ri(0, t_rows, (t_rows // 10,)).long()] = INT_MAX   # pad rows
    rows = ri(0, t_rows, (n_lanes, n_rows))
    rows[ri(0, 2, (n_lanes, n_rows)).bool() & (ri(0, 8, (n_lanes, n_rows))
                                               == 0)] = -1
    lut = ri(-(1 << 14), 1 << 14, (n_lanes, 8 * w))
    lut[:64] = ri(-(1 << 28), 1 << 28, (64, 8 * w))   # S and t wrap
    sumq = lut.long().sum(-1)
    sumq = ((sumq + 2**31) % 2**32 - 2**31).to(torch.int32)
    sumq[1::3] = ri(-(1 << 30), 1 << 30, (sumq[1::3].numel(),))  # t < 0
    s1 = ri(1, 16, (n_lanes,))
    s2 = ri(1, 16, (n_lanes,))
    s2[::2] = 31                                     # one- and two-term
    return codes, f_add, rows, lut, sumq, s1, s2


def synthetic_topk_inputs(torch, dev, q, c, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(-1, c, (q, c), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)   # duplicates
    d = torch.rand((q, c), generator=g, device=dev)
    ids[:, -2:] = -1                                  # pads
    ids[:8] = -1                                      # all-pad rows
    ids[8:16] = 7                                     # one id per row
    d[:, 3:7] = 0.5                                   # ties across columns
    d[:, 100:140] = d[:, 10:50]
    return ids.contiguous(), d.contiguous()


def synthetic_select_rows(torch, dev, q, c, seed):
    """Rows for both selection kernels' routes: duplicate ids, pads, ties,
    row 0 all pads, row 1 one id, row 2 a later duplicate with a smaller
    distance than its first occurrence, row 3 and every eighth row NaN,
    +inf, -inf, -0.0 and +0.0 sprinkled among the distances."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(-1, max(2, c // 2), (q, c), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    d = torch.randint(0, 40, (q, c), generator=g, device=dev).float() / 8
    ids[0] = -1
    if q > 1:
        ids[1] = 7
    if q > 2 and c > 1:
        ids[2] = torch.arange(c, dtype=torch.int32, device=dev)
        ids[2, -1] = 0
        d[2, -1] = -1.0
    for i, v in enumerate((math.nan, math.inf, -math.inf, -0.0, 0.0)):
        d[3::8, i::5] = v
    return ids.contiguous(), d.contiguous()


def phase_select_routes(torch, dev):
    """topk_select and merge_topk by both routes on the same rows, bitwise
    against the plain versions (float32 by their bits): each lane-slot
    count of the warp route (C = 1 to 1,024), both route boundaries (C =
    1,024 / 1,025 and k = 32 / 33), the main path's widths, the RAG
    retrieval's Q = 8 and a ragged last block; a warp launch the route
    cannot take must raise."""
    from repro_torch.kernels import merge_topk, ref, topk_select
    n = 0
    for q, c, k in ((1024, 320, 10), (8, 320, 10), (1023, 80, 10), (5, 1, 1),
                    (3, 31, 31), (7, 32, 32), (6, 33, 10), (4, 65, 20),
                    (9, 129, 32), (2, 257, 7), (3, 513, 10), (5, 1000, 32),
                    (4, 1024, 32), (4, 1025, 10), (3, 100, 33),
                    (2, 4096, 10)):
        ids, d = synthetic_select_rows(torch, dev, q, c, q + c + k)
        md = torch.where(ids < 0, math.inf, d)
        for route in topk_select.ROUTES:
            label = f"Q={q} C={c} k={k} {route} route"
            if route == "warp" and topk_select.route_for(c, k) != "warp":
                for launch in (topk_select._launch, merge_topk._launch):
                    try:
                        launch(ids, d, k=k, route=route,
                               **({"run": 1} if launch is merge_topk._launch
                                  else {}))
                    except ValueError:
                        continue
                    fail(f"{label}: a warp launch past the route's limits "
                         f"did not raise")
                continue
            for name, a, b in zip(("ids", "dists"),
                                  topk_select._launch(ids, d, k=k,
                                                      route=route),
                                  ref.topk_select_ref(ids, d, k=k)):
                bitwise(torch, "topk_select", f"{label} {name}", a, b)
            for name, a, b in zip(("ids", "dists"),
                                  merge_topk._launch(ids, md, k=k, run=1,
                                                     route=route),
                                  ref.merge_topk_ref(ids, md, k=k, run=1)):
                bitwise(torch, "merge_topk", f"{label} {name}", a, b)
            n += 1
    torch.cuda.synchronize()
    log(f"selection routes: {n} (shape, route) cases of each kernel bitwise "
        f"on rows with NaN, +-inf, -0.0, duplicates and pads; warp launches "
        f"past C = {topk_select.WARP_MAX_C} or k = {topk_select.WARP_MAX_K} "
        f"refused")


def synthetic_merge_inputs(torch, dev, q, o, run, seed):
    """O sorted runs per row in the sharded sink's slot layout: unfilled
    tails, exact ties across runs, fully unanswered rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.rand((q, o, run), generator=g, device=dev)
    ids = torch.arange(q * o * run, dtype=torch.int32,
                       device=dev).view(q, o, run).clone()
    d[:, 0, -2:] = math.inf
    ids[:, 0, -2:] = -1
    if o > 1:
        d[:, 1, 0] = d[:, 0, 0]                       # a tie across runs
    d = torch.sort(d, dim=-1).values
    d[1::7] = math.inf                                # unanswered rows
    ids[1::7] = -1
    return ids.view(q, o * run).contiguous(), d.view(q, o * run).contiguous()


def synthetic_scan_inputs(torch, dev, n_lanes, m, w, n_clusters, seed,
                          kind="random"):
    """Lanes over a flattened (n_clusters * m, W) table. Every fourth lane
    has a zero LUT and sumq, so its ranks are f_add, which holds INT_MIN,
    INT_MAX and ties; n_valid takes 0, < EF and M; some lanes are
    inactive. ``kind`` "falling", "equal" or "late" zeroes every LUT and
    sumq and sets f_add, in row order, falling (every row passes the
    kernel's running threshold), all equal, or rising by 2 with each
    cluster's last row just inside the best 40, after the threshold has
    settled."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)
    t = n_clusters * m
    codes = ri(0, 256, (t, w), torch.uint8)
    f_add = ri(-(1 << 12), 1 << 12, (t,))
    f_add[::5] = INT_MAX
    f_add[1::7] = -2**31
    lut = ri(-(1 << 28), 1 << 28, (n_lanes, 8 * w))
    sumq = ri(-(1 << 30), 1 << 30, (n_lanes,))
    lut[::4] = 0
    sumq[::4] = 0
    base = ri(0, n_clusters, (n_lanes,)) * m
    nv = ri(0, m + 1, (n_lanes,))
    nv[:4] = torch.tensor([0, m, 3, 0], device=dev)
    s1 = ri(0, 33, (n_lanes,))
    s2 = ri(0, 33, (n_lanes,))
    s2[::3] = 31
    active = ri(0, 5, (n_lanes,)) > 0
    active[:4] = True
    if kind != "random":
        lut.zero_()
        sumq.zero_()
        i = torch.arange(t, device=dev, dtype=torch.int32) % m
        f_add = {"falling": m - i, "equal": 0 * i,
                 "late": torch.where(i == m - 1, 2 * 40 - 3, 2 * i)}[kind]
        f_add = f_add.to(torch.int32).contiguous()
    return codes, f_add, base, nv, lut, sumq, s1, s2, active


def synthetic_beam_inputs(torch, dev, n_lanes, m, r, w, n_clusters, seed):
    """Lanes over a flattened (n_clusters * m) cluster table, for
    beam_search. Neighbour rows hold -1 pads, duplicate ids, rows of all
    -1 and rows ending in 0, -1 (the visited quirk); odd lanes have a zero
    LUT and sumq, so their ranks are f_add itself, which holds INT_MAX,
    INT_MIN and, in cluster 0, only 8 values (equal ranks across the beam
    and the neighbours); lane 1's entry ranks INT_MAX, lane 3's entry is
    -1; about one lane in seven is inactive."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)
    t = n_clusters * m
    codes = ri(0, 256, (t, w), torch.uint8)
    f_add = ri(-(1 << 12), 1 << 12, (t,))
    f_add[:m] = ri(0, 8, (m,))
    f_add[::13] = INT_MAX
    f_add[5::17] = -2**31
    nbrs = ri(0, m, (t, r))
    nbrs[ri(0, 100, (t, r)) < 15] = -1
    nbrs[::3, 1] = nbrs[::3, 0]                      # duplicates in a row
    nbrs[::11] = -1                                  # rows of all -1
    nbrs[::7, -2] = 0                                # 0 followed by -1
    nbrs[::7, -1] = -1
    lut = ri(-(1 << 20), 1 << 20, (n_lanes, 8 * w))
    sumq = ri(-(1 << 24), 1 << 24, (n_lanes,))
    lut[1::2] = 0
    sumq[1::2] = 0
    s1 = ri(0, 33, (n_lanes,))
    s2 = ri(0, 33, (n_lanes,))
    s2[::3] = 31
    base = ri(0, n_clusters, (n_lanes,)) * m
    base[::4] = 0                                    # the tie cluster
    entry = ri(0, m, (n_lanes,))
    if n_lanes > 3:
        f_add[base[1] + entry[1]] = INT_MAX          # an entry at INT_MAX
        entry[3] = -1
    active = ri(0, 7, (n_lanes,)) > 0
    active[:2] = True
    return (codes, f_add, nbrs.contiguous(), base.contiguous(),
            entry.contiguous(), lut, sumq, s1, s2, active)


def synthetic_rank(torch, dev, kind, t, n_lanes, w, dim, seed):
    """A rank tuple of ``kind`` ("hamming" or "exact") over t rows and
    n_lanes lanes. Hamming: random qcodes, every other lane all zero.
    Exact: zero residual norms, cos_theta 0 and under the 1e-6 floor, NaN
    and +inf residual norms (ranks NaN and +-inf), query_norm 0 in every
    other lane (ranks rn * rn: ties), LUT entries past dim set."""
    from repro_torch.kernels import ranks
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "hamming":
        q = torch.randint(0, 256, (n_lanes, w), generator=g, device=dev,
                          dtype=torch.int64).to(torch.uint8)
        q[1::2] = 0
        return ranks.HammingRank(q)
    rn = torch.rand(t, generator=g, device=dev) * 4
    rn[::9] = 0
    rn[::1001] = float("nan")
    rn[7::1003] = float("inf")
    cos = torch.rand(t, generator=g, device=dev)
    cos[::11] = 0
    cos[5::13] = 1e-7
    lut = torch.randn((n_lanes, 8 * w), generator=g, device=dev) / dim ** 0.5
    sum_lut = lut[:, :dim].sum(1)
    qn = torch.rand(n_lanes, generator=g, device=dev) * 3
    qn[1::2] = 0
    return ranks.ExactRank(rn, cos, lut, sum_lut, qn)


def phase_ranked_synthetic(torch, dev):
    """The hamming and exact policies of beam_search and cluster_scan at
    the main path's shape (16,384 lanes, M = 17,089, W = 16, EF = 40) on
    ``synthetic_rank``'s ranks, over ``synthetic_beam_inputs``' graph and
    ``synthetic_scan_inputs``' clusters (empty and short ones, pad rows,
    inactive lanes), bitwise against their plain versions."""
    from repro_torch.kernels import beam_search, cluster_scan, ref
    n_lanes, m, r, w, dim, ef = 16384, 17089, 32, 16, 128, 40
    bargs = synthetic_beam_inputs(torch, dev, n_lanes, m, r, w, 64, 77)
    sargs = synthetic_scan_inputs(torch, dev, 512, m, w, 64, 78)
    for kind in ("hamming", "exact"):
        rank = synthetic_rank(torch, dev, kind, bargs[0].shape[0], n_lanes,
                              w, dim, 79)
        args = (bargs[0], rank, bargs[2], bargs[3], bargs[4], bargs[9])
        for name, a, b in zip(
                ("ids", "ranks", "hops"),
                beam_search.ranked_beam_search(*args, dim, ef, 64, m),
                ref.ranked_beam_search_ref(*args, dim, ef, 64, m)):
            bitwise(torch, f"beam_search/{kind}",
                    f"L={n_lanes} M={m} {name}", a, b)
        rank = synthetic_rank(torch, dev, kind, sargs[0].shape[0], 512, w,
                              dim, 80)
        args = (sargs[0], rank, sargs[2], sargs[3], sargs[8])
        for name, a, b in zip(
                ("ids", "ranks"),
                cluster_scan.ranked_cluster_scan(*args, dim, ef, m),
                ref.ranked_cluster_scan_ref(*args, dim, ef, m)):
            bitwise(torch, f"cluster_scan/{kind}", f"L=512 M={m} {name}", a,
                    b)
        log(f"beam_search/{kind} and cluster_scan/{kind} at the main path's "
            f"shape: bitwise (shared memory a block: beam "
            f"{beam_search.smem_bytes(ef, r, m, w, kind)}, scan "
            f"{cluster_scan.smem_bytes(w, ef, kind)} bytes)")


@dataclasses.dataclass(frozen=True)
class BeamReads:
    """What one beam search read: real (lane, row) slots ranked, distinct
    rows ranked, distinct neighbour-table rows expanded."""
    slots: int
    rows: int
    expanded: int


def plain_beam_counted(torch, args, dim, ef, iters, m):
    """beam_search's plain version, ``ref.ranked_beam_search_ref`` on the
    ranked arguments ``args`` (codes, rank, nbrs, base_rows, entry,
    active), also counting what its search reads: the real (lane, row)
    slots it ranks (entries and fresh neighbours, through the loop's rank
    calls), the distinct rows among them, and the distinct neighbour-table
    rows it expands (its gathers of the table, a lane's counted while the
    lane is live: at hop t while its hops exceed t). -> (result,
    BeamReads)."""
    from repro_torch.kernels import ref
    real_loop = ref.lockstep_beam_search
    slots, ranked, gathers = [0], [], []

    class Table(torch.Tensor):          # records each gather of its rows
        def __getitem__(self, idx):
            gathers.append(idx)
            return super().__getitem__(idx).as_subclass(torch.Tensor)

    def loop(nbr_table, base_rows, entry, active, *, rank, **kw):
        def counting(ids):
            real = (base_rows[:, None].long() + ids.long())[ids >= 0]
            slots[0] += int(real.numel())
            ranked.append(torch.unique(real))
            return rank(ids)
        return real_loop(nbr_table.as_subclass(Table), base_rows, entry,
                         active, rank=counting, **kw)
    ref.lockstep_beam_search = loop
    try:
        out = ref.ranked_beam_search_ref(*args, dim, ef, iters, m)
    finally:
        ref.lockstep_beam_search = real_loop
    hops = out[2]
    expanded = torch.cat([idx[hops > t] for t, idx in enumerate(gathers)]
                         + [hops.new_empty(0, dtype=torch.long)])
    return out, BeamReads(slots[0], int(torch.unique(torch.cat(ranked))
                                        .numel()),
                          int(torch.unique(expanded).numel()))


def rank_bytes(rank, w):
    """(bytes a ranked row reads beside its W code bytes, bytes of a lane's
    rank operands): O3 f_add and the int32 LUT, sumq, s1, s2; Hamming
    nothing and the W-byte qcode; Exact residual_norm and cos_theta and the
    float LUT, sum_lut, query_norm."""
    if rank.kind == "hamming":
        return 0, w
    if rank.kind == "exact":
        return 8, (8 * w + 2) * 4
    return 4, (8 * w + 3) * 4


def slot_ops(rank, w):
    """(operations ranking one (lane, row) slot takes at least, the rate's
    name): a table lookup and an add per code byte (O3, 2 W), per half
    byte in float32 plus the estimator's ten (Exact, 4 W + 10), an XOR, a
    popcount and an add per 32-bit word (Hamming, 3 W / 4)."""
    if rank.kind == "hamming":
        return 3 * w / 4, H100_INT32_OPS
    if rank.kind == "exact":
        return 4 * w + 10, H100_FP32_OPS
    return 2 * w, H100_INT32_OPS


def beam_bound(args, ef, dim, reads):
    """Bytes: each distinct neighbour-table row expanded (4 R) and each
    distinct row ranked (its code and per-row factors, ``rank_bytes``)
    once, since lanes that probe one cluster start from its entry and share
    rows (as ``rank_bound`` counts them); the rank operands of each lane
    with an entry (every such lane ranks it), each lane's two int32 scalars
    and its active flag, the (L, EF) ids and ranks and the (L,) hops
    written. Operations: ``slot_ops`` per ranked (lane, row) slot, the
    least a row's rank takes. ``args`` are the ranked arguments (codes,
    rank, nbrs, base_rows, entry, active); ``reads`` is this run's
    (``plain_beam_counted``). Returns (ms, "bytes" or "operations", ms by
    the bit count, ms by the kernel's nibble tables): the last two price
    2 dim and 4 W operations an O3 slot against the same bytes, and are
    logged beside the bound only."""
    codes, rank, nbrs, entry = args[0], args[1], args[2], args[4]
    w, r = codes.shape[1], nbrs.shape[1]
    n_lanes = entry.numel()
    row_extra, lane_bytes = rank_bytes(rank, w)
    nbytes = (reads.expanded * 4 * r + reads.rows * (w + row_extra)
              + int((entry >= 0).sum()) * lane_bytes
              + n_lanes * (2 * 4 + 1) + n_lanes * (ef * 8 + 4))
    tb = nbytes / H100_BYTES_PER_S
    per_slot, rate = slot_ops(rank, w)
    to = reads.slots * per_slot / rate

    def by(ops):
        return 1e3 * max(tb, ops / H100_INT32_OPS)
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations",
            by(2 * reads.slots * dim), by(4 * reads.slots * w))


def quirk_beam_inputs(torch, dev):
    """The minimal search of ROADMAP C1 (M = 4, entry 1, ranks = f_add
    [10, 5, 20, 30]): node 0 enters the beam twice."""
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    z = i32([0])
    return (torch.zeros((4, 1), dtype=torch.uint8, device=dev),
            i32([10, 5, 20, 30]),
            i32([[2, -1, -1], [0, -1, -1], [0, 3, -1], [-1, -1, -1]]), z,
            i32([1]), torch.zeros((1, 8), dtype=torch.int32, device=dev), z,
            i32([2]), i32([31]), torch.ones(1, dtype=torch.bool, device=dev))


def phase_beam_synthetic(torch, dev):
    """beam_search against its plain version, bitwise in ids, ranks and
    hops, on the adversarial inputs of ``synthetic_beam_inputs``: neighbour
    rows with duplicates, all -1, and 0 followed by -1 (the quirk); equal
    ranks across the beam and the neighbours (a tie cluster); INT_MAX and
    INT_MIN ranks; an entry that ranks INT_MAX; EF = 1, EF < R, EF = 40
    and EF = 100; R = 16 and R = 48; the max_iters cap hit; inactive lanes;
    M = 17,089 at the main path's 16,384 lanes; W = 16 and W = 64; and the
    minimal search of ROADMAP C1, where node 0 enters twice."""
    from repro_torch.kernels import beam_search, ref
    cases = [  # lanes, M, R, W, EF, max_iters, dim, clusters, what
        (16384, 17089, 32, 16, 40, 64, 128, 64, "the main path's shape"),
        (512, 3000, 32, 16, 1, 64, 128, 8, "EF = 1"),
        (512, 3000, 32, 16, 12, 64, 121, 8, "EF < R, dim % 8 != 0"),
        (512, 3000, 32, 16, 100, 64, 128, 8, "EF = 100"),
        (512, 3000, 16, 16, 40, 64, 128, 8, "R = 16"),
        (512, 3000, 48, 16, 40, 64, 128, 8, "R = 48"),
        (512, 3000, 32, 16, 40, 5, 128, 8, "the max_iters cap"),
        (256, 3000, 32, 64, 40, 64, 500, 8, "W = 64"),
    ]
    for n_lanes, m, r, w, ef, iters, dim, ncl, what in cases:
        args = synthetic_beam_inputs(torch, dev, n_lanes, m, r, w, ncl,
                                     n_lanes + m + r + ef)
        got = beam_search.beam_search(*args, dim, ef, iters, m)
        want = ref.beam_search_ref(*args, dim, ef, iters, m)
        label = (f"L={n_lanes} M={m} R={r} W={w} EF={ef} max_iters={iters} "
                 f"({what})")
        for name, a, b in zip(("ids", "ranks", "hops"), got, want):
            bitwise(torch, "beam_search", f"{label} {name}", a, b)
        hops = want[2]
        log(f"beam_search {label}: bitwise; hops {int(hops.min())}-"
            f"{int(hops.max())}, {int((hops == iters).sum())} lanes at the "
            f"cap; INT_MIN ranks kept {int((want[1] == -2**31).sum())}; "
            f"smem {beam_search.smem_bytes(ef, r, m, w)} bytes a block")
        if what == "the max_iters cap" and int(hops.max()) != iters:
            fail(f"beam_search {label}: no lane reached the cap")
    args = quirk_beam_inputs(torch, dev)
    got = beam_search.beam_search(*args, 8, 6, 10, 4)
    want = ref.beam_search_ref(*args, 8, 6, 10, 4)
    for name, a, b in zip(("ids", "ranks", "hops"), got, want):
        bitwise(torch, "beam_search", f"ROADMAP C1 search {name}", a, b)
    if int((want[0] == 0).sum()) != 2:
        fail(f"the ROADMAP C1 search kept node 0 {int((want[0] == 0).sum())}"
             f" times, not twice: {want[0].tolist()}")
    log(f"beam_search ROADMAP C1 search: bitwise, ids {got[0].tolist()[0]}")


def phase_wide_rows(torch, dev):
    """The shapes the kernels refused before ROADMAP C3 was repaired:
    topk_select at C = 4,160 (chunks and a pass over their outputs; each
    id carries one distance, as in the rerank), merge_topk at O k = 4,800
    (a tree of launches) and cluster_scan at EF = 1,500, bitwise."""
    from repro_torch.kernels import cluster_scan, merge_topk, ref, topk_select
    g = torch.Generator(device=dev).manual_seed(4160)
    ids = torch.randint(-1, 1500, (64, 4160), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    table = torch.randint(0, 400, (1500,), generator=g,
                          device=dev).float() / 8
    d = torch.where(ids >= 0, table[ids.clamp(min=0).long()], 0.0)
    for name, a, b in zip(("ids", "dists"),
                          topk_select.topk_select(ids, d, k=10),
                          ref.topk_select_ref(ids, d, k=10)):
        bitwise(torch, "topk_select", f"Q=64 C=4160 k=10 {name}", a, b)
    ids, d = synthetic_merge_inputs(torch, dev, 64, 480, 10, 4800)
    for name, a, b in zip(("ids", "dists"),
                          merge_topk.merge_topk(ids, d, k=10),
                          ref.merge_topk_ref(ids, d, k=10)):
        bitwise(torch, "merge_topk", f"Q=64 O=480 run=10 k=10 {name}", a, b)
    args = synthetic_scan_inputs(torch, dev, 16, 3000, 16, 64, 1500)
    for name, a, b in zip(("ids", "ranks"),
                          cluster_scan.cluster_scan(*args, 128, 1500, 3000),
                          ref.cluster_scan_ref(*args, 128, 1500, 3000)):
        bitwise(torch, "cluster_scan", f"L=16 M=3000 EF=1500 {name}", a, b)
    log(f"wide rows bitwise: topk_select C=4160, merge_topk O k=4800, "
        f"cluster_scan EF=1500 ({cluster_scan.smem_bytes(16, 1500)} bytes "
        f"of shared memory a block; EF up to {cluster_scan.max_ef(16)} "
        f"served at W=16)")


def phase_kernels_synthetic(torch, dev):
    from repro_torch.kernels import (binary_ip, cluster_scan, merge_topk,
                                     ref, topk_select)
    w, dim = 16, 128
    args = synthetic_rank_inputs(torch, dev, 16384, 32, w, 10_000_000, 1)
    bitwise(torch, "binary_ip_rank", "L=16384 R=32 W=16",
            binary_ip.binary_ip_rank(*args, dim),
            ref.binary_ip_rank_ref(*args, dim))
    lut = args[3].clone()
    lut[:, 121:] = 0                                  # dim % 8 != 0
    odd = (*args[:3], lut, *args[4:])
    bitwise(torch, "binary_ip_rank", "dim=121",
            binary_ip.binary_ip_rank(*odd, 121),
            ref.binary_ip_rank_ref(*odd, 121))
    timed_row(torch, "binary_ip_rank synthetic L=16384 R=32 W=16",
              lambda: binary_ip.binary_ip_rank(*args, dim),
              lambda: ref.binary_ip_rank_ref(*args, dim), 50,
              rank_bound(torch, args[2], args[3], w, dim))

    for q, c, k in ((1024, 320, 10), (64, 2048, 16), (64, 4096, 100),
                    (64, 7, 7)):                      # the supported range
        ids, d = synthetic_topk_inputs(torch, dev, q, c, c)
        for name, a, b in zip(("ids", "dists"),
                              topk_select.topk_select(ids, d, k=k),
                              ref.topk_select_ref(ids, d, k=k)):
            bitwise(torch, "topk_select", f"Q={q} C={c} k={k} {name}", a, b)
    ids, d = synthetic_topk_inputs(torch, dev, 1024, 320, 320)
    timed_row(torch, "topk_select synthetic Q=1024 C=320 k=10",
              lambda: topk_select.topk_select(ids, d, k=10),
              lambda: ref.topk_select_ref(ids, d, k=10), 50,
              topk_bound(1024, 320, 10))

    for q, o, run, k in ((1024, 8, 10, 10), (64, 6, 12, 7), (64, 1, 10, 10),
                         (16, 3, 1365, 100)):         # run != k, W to 4095
        ids, d = synthetic_merge_inputs(torch, dev, q, o, run, o * run)
        for name, a, b in zip(("ids", "dists"),
                              merge_topk.merge_topk(ids, d, k=k, run=run),
                              ref.merge_topk_ref(ids, d, k=k, run=run)):
            bitwise(torch, "merge_topk", f"Q={q} O={o} run={run} k={k} "
                    f"{name}", a, b)

    # (lanes, M, EF, dim, W, ranks in row order, LUT entries past dim);
    # the kernel ignores entries past dim whether or not they are zero
    for n_lanes, m, ef, dim, w, kind, junk in (
            (512, 3000, 40, 128, 16, "random", False),
            (64, 9000, 300, 121, 16, "random", False),
            (16, 1024, 1024, 128, 16, "random", False),
            (64, 9000, 40, 128, 16, "falling", False),
            (64, 3000, 40, 128, 16, "equal", False),
            (64, 3000, 40, 128, 16, "late", False),
            (64, 17089, 40, 121, 16, "random", True),
            (16, 2000, 40, 2045, 256, "random", True)):
        args = synthetic_scan_inputs(torch, dev, n_lanes, m, w, 64, m, kind)
        if not junk:
            lut = args[4].clone()
            lut[:, dim:] = 0
            args = (*args[:4], lut, *args[5:])
        for name, a, b in zip(
                ("ids", "ranks"),
                cluster_scan.cluster_scan(*args, dim, ef, m),
                ref.cluster_scan_ref(*args, dim, ef, m)):
            bitwise(torch, "cluster_scan", f"L={n_lanes} M={m} EF={ef} "
                    f"dim={dim} W={w} {kind} {name}", a, b)
    phase_select_routes(torch, dev)
    phase_wide_rows(torch, dev)
    phase_beam_synthetic(torch, dev)
    phase_ranked_synthetic(torch, dev)
    phase_flash_synthetic(torch, dev)


def phase_flash_synthetic(torch, dev):
    """flash_attention against its plain versions: GQA groups 1 and 4,
    every head dim the kernel takes, ragged Sq / Sk (not multiples of the
    tiles), q_offset > 0, a window that bites, kv_valid_len < Sk (the cache
    prefill's shape), bf16 q over float32 K/V (the serving path's types),
    and query rows past 1024 that walk 17 KV tiles. float32 q against the
    float32 plain version; bf16 q by ``hold_bf16_attention``."""
    from repro_torch.kernels import flash_attn, ref
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # b, sq, sk, hq, hkv, d, causal, window, q_off, valid, qt, kvt
        (2, 300, 300, 8, 8, 64, True, None, 0, None, f32, f32),
        (2, 257, 330, 8, 2, 80, True, None, 0, 300, bf, f32),
        (1, 190, 523, 16, 4, 96, True, 128, 333, None, bf, f32),
        (2, 129, 2080, 32, 8, 80, True, 700, 1900, 2029, bf, f32),
        (1, 77, 200, 4, 1, 128, False, None, 0, 150, f32, bf),
        (1, 100, 1000, 8, 2, 128, True, 37, 900, None, bf, bf),
        (3, 1, 65, 4, 1, 64, True, None, 64, None, bf, f32),
        (1, 1100, 1100, 8, 2, 80, True, None, 0, None, bf, f32),
        # the tensor-core kernel's head sets: groups of 2, 8 and 3
        (2, 150, 200, 8, 4, 64, True, None, 50, None, bf, f32),
        (1, 100, 300, 8, 1, 96, True, 70, 200, None, bf, bf),
        (2, 77, 77, 6, 2, 128, True, None, 0, None, bf, f32),
        # head dim 160 (stablelm-12b): causal, ragged, GQA group 4, bf16 q
        # over float32 K/V; a window over bf16 K/V; the float32 route
        (2, 257, 330, 8, 2, 160, True, None, 0, 300, bf, f32),
        (1, 200, 200, 4, 1, 160, True, 48, 0, None, bf, bf),
        (2, 129, 200, 4, 1, 160, True, None, 71, None, f32, f32),
    ]
    for b, sq, sk, hq, hkv, d, causal, window, q_off, valid, qt, kvt in cases:
        g = torch.Generator(device=dev).manual_seed(sq * 1000 + sk)
        q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(qt)
        k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(kvt)
        v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(kvt)
        kw = dict(causal=causal, window=window, q_offset=q_off,
                  kv_valid_len=valid)
        label = (f"B={b} Sq={sq} Sk={sk} g={hq // hkv} hd={d} "
                 f"causal={causal} window={window} q_offset={q_off} "
                 f"kv_valid_len={valid} {str(qt)[6:]}/{str(kvt)[6:]}")
        got = flash_attn.flash_attention(q, k, v, **kw)
        if qt == bf:
            hold_bf16_attention(torch, label, got, q, k, v, kw)
        else:
            want = ref.flash_attention_ref(q, k, v, **kw)
            close(torch, "flash_attention", label, got, want,
                  attn_bound(torch, want))
    time_hd160(torch, dev)


def time_hd160(torch, dev):
    """The head-dim-160 kernel at a prefill of stablelm-12b's attention
    shape (B = 2, S = 2048, 32 / 8 heads of 160, bf16 q, float32 K/V
    holding bf16-exact values, causal), held against its twin and timed
    beside its bound and scaled_dot_product_attention on the same work
    (bf16 K/V)."""
    from repro_torch.kernels import flash_attn, ref
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(160)
    b, s, hq, hkv, d = 2, 2048, 32, 8, 160
    q = torch.randn((b, s, hq, d), generator=g, device=dev).to(bf)
    k = torch.randn((b, s, hkv, d), generator=g, device=dev).to(bf).float()
    v = torch.randn((b, s, hkv, d), generator=g, device=dev).to(bf).float()
    kw = dict(causal=True, window=None, q_offset=0, kv_valid_len=None)
    got = flash_attn.flash_attention(q, k, v, **kw)
    hold_bf16_attention(torch, f"hd 160 B={b} S={s} {hq}/{hkv} heads", got,
                        q, k, v, kw)
    row = timed_row(
        torch, f"flash_attention hd 160 B={b} S={s} {hq}/{hkv} heads, "
        f"plain = the twin",
        lambda: flash_attn.flash_attention(q, k, v, **kw),
        lambda: ref.flash_attention_ref(q, k, v, operands=bf, **kw), 10,
        flash_bound(q, k, v, True, None, 0, None))
    qs, ks, vs = (t.to(bf).transpose(1, 2).contiguous() for t in (q, k, v))
    lib, lib_wall = times(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), 10)
    log(f"flash_attention hd 160: kernel {row['ms']:.5f} ms, SDPA "
        f"{lib if lib is not None else lib_wall:.5f} ms on the device "
        f"(bf16 K/V), bound {row['bound_ms']:.5f} ms")


def phase_build_index(torch, dev):
    from repro_torch.core import compact_index, engine
    from repro_torch.data import synthetic
    t = time.perf_counter()
    x, _ = synthetic.clustered_vectors(0, N, 128, 4096)
    q = synthetic.query_set(0, x, 1024)
    log(f"corpus {x.shape} + queries {q.shape} made on the host in "
        f"{time.perf_counter() - t:.1f} s")
    icfg = compact_index.IndexConfig(dim=128, n_clusters=4096, degree=32,
                                     knn_k=64, kmeans_sample=262_144)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = engine.PIMCQGEngine.build(0, x, icfg, engine.SearchConfig(),
                                    n_shards=8, device=dev, verbose=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    del x
    log(f"index built on the card in {build_s:.1f} s; budget "
        f"{eng.index.budget} rows/cluster; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"footprint {json.dumps(eng.footprint())}")
    hold_kmeans_reproducible(torch, eng, icfg)
    t = time.perf_counter()
    digest = index_digest(torch, eng)
    log(f"index digest (SHA-256 over the shapes, types and card-side "
        f"fingerprints of the 14 CompactIndex tensors and the vectors): "
        f"{digest} ({time.perf_counter() - t:.1f} s)")
    return eng, torch.from_numpy(q).to(dev), build_s


def hold_kmeans_reproducible(torch, eng, icfg) -> None:
    """ROADMAP C5: the build's k-means, run twice more from the build's
    seed on the same 10M rows (its 262,144-row sample drawn from the same
    generator), gives the same centroids and assignment bit for bit, and
    the centroids the build made."""
    from repro_torch.core import ivf
    t = time.perf_counter()
    runs = [ivf.kmeans(torch.Generator(device=eng.device).manual_seed(0),
                       eng.host.vectors, icfg.n_clusters,
                       iters=icfg.kmeans_iters, sample=icfg.kmeans_sample)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name in ("centroids", "assignment", "sizes"):
        a, b = getattr(runs[0], name), getattr(runs[1], name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            fail(f"C5: two k-means runs of seed 0 differ in {name} in "
                 f"{int((a != b).sum())} entries")
    if not torch.equal(runs[0].centroids.view(torch.int32),
                       eng.index.centroids.view(torch.int32)):
        fail("C5: k-means of seed 0 differs from the build's centroids")
    log(f"C5: two k-means runs of seed 0 ({icfg.kmeans_sample:,} sampled "
        f"rows, {icfg.n_clusters} clusters, {icfg.kmeans_iters} Lloyd "
        f"steps, the assignment of all {eng.host.vectors.shape[0]:,} rows) "
        f"equal each other and the build's centroids bit for bit "
        f"({(time.perf_counter() - t) / 2:.1f} s a run)")


def index_digest(torch, eng) -> str:
    """SHA-256 over each CompactIndex tensor's and the vectors' shape,
    type and a 64-bit fingerprint of its bytes taken on the card: the sum,
    mod 2^64, of each 32-bit word times an odd weight fixed by its
    position. An integer sum is exact in any order, so the fingerprint is
    the same whenever the bytes are; a random change of the bytes changes
    it but with odds of 2^-64. Equal digests in two runs mean the same
    index."""
    h = hashlib.sha256()
    tensors = [f for f in eng.index if isinstance(f, torch.Tensor)]
    step = 1 << 26
    for t in tensors + [eng.host.vectors]:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        if raw.numel() % 4:
            raw = torch.cat([raw, raw.new_zeros(4 - raw.numel() % 4)])
        words = raw.view(torch.int32)
        fp = torch.zeros((), dtype=torch.int64, device=t.device)
        for s in range(0, words.numel(), step):
            w = words[s:s + step].long()
            pos = torch.arange(s, s + w.numel(), dtype=torch.int64,
                               device=t.device)
            fp += (w * ((pos * -7046029254386353131) | 1)).sum()
        h.update(f"{tuple(t.shape)} {t.dtype} {int(fp)};".encode())
    return h.hexdigest()


def phase_search(torch, eng, qt):
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    eng.search(qt)                                    # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res, stats = eng.search(qt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = ops.launch_counts()
    qps = [qt.shape[0] / dt]
    for _ in range(3):
        t = time.perf_counter()
        eng.search(qt)
        torch.cuda.synchronize()
        qps.append(qt.shape[0] / (time.perf_counter() - t))
    ids = res.ids
    if ids.shape != (qt.shape[0], 10) or not torch.isfinite(
            res.dists[ids >= 0]).all():
        fail(f"search output malformed: ids {tuple(ids.shape)}")
    gt = synthetic.ground_truth(eng.host.vectors, qt, 10)
    hit = (ids.long()[:, :, None] == gt[:, None, :]).any(-1).sum()
    recall = float(hit) / gt.numel()
    live = stats.hops[stats.hops > 0].float()
    log(f"search of {qt.shape[0]} queries: {dt * 1e3:.2f} ms, QPS "
        f"{', '.join(f'{v:.1f}' for v in qps)} (first = the counted run)")
    log(f"recall@10 {recall:.4f}; mean hops {float(live.mean()):.2f} over "
        f"{live.numel()} live lanes; dropped lanes "
        f"{int(stats.dropped_lanes)}")
    print("kernels " + json.dumps(counts), flush=True)
    want = {"beam_search": 1, "topk_select": 1, "binary_ip_rank": 0}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"the beam search launched {counts}, expected {want}: one "
             f"beam_search (every lane's loop, the rank fused in) and one "
             f"topk_select")
    if recall < 0.5:
        fail(f"recall@10 {recall:.4f} < 0.5")
    return counts, recall, qps, res


def phase_breakdown(torch, eng, qt, search_ms):
    """Where one search's time goes: wall time of each stage of
    PIMCQGEngine._candidates and the rerank, each ended by a synchronise,
    then one whole search under torch.profiler (after a discarded warm-up
    search) for the device's busy share and its kernels by device time."""
    from repro_torch.core import backends, beam_search, rerank

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    nq, cfg = qt.shape[0], eng.scfg
    stages = {}
    (_, lane_q, lane_cl, inv, _), stages["route"] = timed(
        lambda: eng._route(qt, nq))
    (shard, fc, lanes, live), stages["lane_luts"] = timed(
        lambda: eng._lanes(qt, lane_q, lane_cl))
    lane_cfg = backends.LaneConfig(ef=cfg.ef, max_iters=cfg.max_iters,
                                   dim=eng.icfg.dim)
    res, stages["beam_search"] = timed(lambda: beam_search.beam_search_lane(
        shard, fc, lanes, backend=eng.backend, cfg=lane_cfg, active=live))
    (_, cand, _), _ = timed(lambda: eng._candidates(qt, nq))
    _, stages["rerank"] = timed(lambda: rerank.rerank(
        qt, cand, eng.host.vectors, k=cfg.k))
    log(f"stage wall ms (one search; its longest lane takes "
        f"{int(res.hops.max())} hops, {int(res.hops.sum())} in all): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    wall, kern = profiled(torch, lambda: eng.search(qt))
    busy = sum(ms for _, _, ms in kern)
    if not kern:
        log(f"profiled search {wall:.2f} ms wall; device time not measured "
            f"(the profiler recorded no kernel)")
        return
    log(f"profiled search {wall:.2f} ms wall, device busy {busy:.2f} ms in "
        f"{sum(n for _, n, _ in kern)} kernel launches; idle share "
        f"{1 - busy / search_ms:.3f} of the unprofiled median search "
        f"({search_ms:.2f} ms), {1 - busy / wall:.3f} of the profiled one")
    log_top(kern, 12)


def phase_kernels_real(torch, eng, qt):
    """Kernel vs plain version on the real search's inputs; times both.
    beam_search on the arguments the search gives it, bitwise against its
    plain version, and timed beside its bound and the old path (the plain
    lock-step loop of ``RankingBackend.search_lanes``, one binary_ip_rank
    launch a hop); binary_ip_rank on one real hop and a gemv-shaped call."""
    from repro_torch.core import backends, rerank
    from repro_torch.kernels import beam_search, binary_ip, ref, topk_select
    dim = eng.icfg.dim
    _, lane_q, lane_cl, _, _ = eng._route(qt, qt.shape[0])
    shard, fc, lanes, live = eng._lanes(qt, lane_q, lane_cl)
    m = shard.codes.shape[-2]
    a = shard.arrays
    codes = shard.codes.reshape(-1, shard.codes.shape[-1])
    f_add = a.f_add.reshape(-1)
    s1, s2 = a.shift1[fc].contiguous(), a.shift2[fc].contiguous()
    cfg = eng.scfg
    lane_cfg = backends.LaneConfig(ef=cfg.ef, max_iters=cfg.max_iters,
                                   dim=dim)
    _, calls = recording(beam_search, "ranked_beam_search", lambda:
                         eng.backend.search_lanes(shard, fc, lanes, lane_cfg,
                                                  live))
    b_args = calls[0][:6]
    got = beam_search.ranked_beam_search(*b_args, dim, cfg.ef, cfg.max_iters,
                                         m)
    want, reads = plain_beam_counted(torch, b_args, dim, cfg.ef,
                                     cfg.max_iters, m)
    for name, x, y in zip(("ids", "ranks", "hops"), got, want):
        bitwise(torch, "beam_search", f"real search {name}", x, y)
    hops = want[2]
    old = backends.RankingBackend.search_lanes
    bound = beam_bound(b_args, cfg.ef, dim, reads)
    beam_row = timed_row(
        torch, f"beam_search real search L={live.numel()} ({int(live.sum())}"
        f" live) M={m} R={shard.neighbors.shape[-1]} EF={cfg.ef}, plain = "
        f"the old path",
        lambda: beam_search.ranked_beam_search(*b_args, dim, cfg.ef,
                                               cfg.max_iters, m),
        lambda: old(eng.backend, shard, fc, lanes, lane_cfg, live), 30,
        bound)
    beam_row["library_ms"] = None
    smem = beam_search.smem_bytes(cfg.ef, shard.neighbors.shape[-1], m,
                                  codes.shape[1])
    log(f"beam_search real search: {int(hops.sum())} hops over "
        f"{int((hops > 0).sum())} lanes (at most {int(hops.max())}), "
        f"{reads.slots} real (lane, row) slots ranked, {reads.rows} distinct "
        f"rows, {reads.expanded} distinct rows expanded; bound "
        f"{bound[0]:.5f} ms ({bound[1]}); by the bit count {bound[2]:.5f} "
        f"ms, by the nibble tables' count {bound[3]:.5f} ms; {smem} "
        f"bytes of shared memory a block; ptxas: "
        f"{'; '.join(PTXAS.get('beam_search', ['not built here']))}")
    entry = shard.entry[fc].long()
    nbrs = shard.neighbors[fc, entry]                 # the first hop's rows
    nbrs = torch.where(live[:, None], nbrs, -1)
    rows = torch.where(nbrs >= 0, fc[:, None].int() * m + nbrs, -1).int()
    rank_args = (codes, f_add, rows.contiguous(), lanes.lut, lanes.sumq,
                 s1, s2)
    bitwise(torch, "binary_ip_rank", "real hop",
            binary_ip.binary_ip_rank(*rank_args, dim),
            ref.binary_ip_rank_ref(*rank_args, dim))
    rank_row = timed_row(
        torch, f"binary_ip_rank real hop L={rows.shape[0]} R={rows.shape[1]}",
        lambda: binary_ip.binary_ip_rank(*rank_args, dim),
        lambda: ref.binary_ip_rank_ref(*rank_args, dim), 100,
        rank_bound(torch, rows, lanes.lut, codes.shape[1], dim))

    sel = torch.nonzero(live)[:64, 0]                # gemv: M = budget rows
    g_rows = (fc[sel, None].int() * m + torch.arange(
        m, device=fc.device, dtype=torch.int32)).contiguous()
    g_args = (codes, f_add, g_rows, lanes.lut[sel].contiguous(),
              lanes.sumq[sel].contiguous(), s1[sel].contiguous(),
              s2[sel].contiguous())
    bitwise(torch, "binary_ip_rank", f"gemv M={m}",
            binary_ip.binary_ip_rank(*g_args, dim),
            ref.binary_ip_rank_ref(*g_args, dim))
    timed_row(torch, f"binary_ip_rank gemv L={len(sel)} M={m}",
              lambda: binary_ip.binary_ip_rank(*g_args, dim),
              lambda: ref.binary_ip_rank_ref(*g_args, dim), 30,
              rank_bound(torch, g_rows, g_args[3], codes.shape[1], dim))

    _, cand, _ = eng._candidates(qt, qt.shape[0])
    d2 = rerank.exact_sqdist(qt, cand, eng.host.vectors).contiguous()
    k = eng.scfg.k
    want = ref.topk_select_ref(cand, d2, k=k)
    for x, y in zip(topk_select.topk_select(cand, d2, k=k), want):
        bitwise(torch, "topk_select", "real", x, y)
    for route in topk_select.ROUTES:
        for name, x, y in zip(("ids", "dists"),
                              topk_select._launch(cand, d2, k=k, route=route),
                              want):
            bitwise(torch, "topk_select", f"real {route} route {name}", x, y)
    q, c = cand.shape
    bound = topk_bound(q, c, k)
    topk_row = timed_row(
        torch, f"topk_select real rerank Q={q} C={c} k={k}",
        lambda: topk_select.topk_select(cand, d2, k=k),
        lambda: ref.topk_select_ref(cand, d2, k=k), 100, bound)
    route_turns(torch, f"topk_select real rerank Q={q} C={c} k={k}",
                lambda r: topk_select._launch(cand, d2, k=k, route=r), 100)
    lib, lib_wall = times(torch, lambda: torch.topk(d2, k, largest=False),
                          100)
    route = topk_select.route_for(c, k)
    log(f"topk_select real rerank: the main path takes the {route} route "
        f"({topk_select.smem_bytes(c, route)} bytes of shared memory a "
        f"block); "
        f"bound {bound[0]:.5f} ms ({bound[1]}: a table probe and a compare a "
        f"slot), {bound[2]:.5f} ms by the first design's count (two C log2 C "
        f"sorts a row); torch.topk(d, k, largest=False) on the same rows "
        f"{lib if lib is not None else lib_wall:.5f} ms on the device (no "
        f"dedup, another tie order: a yardstick of the selection alone, not "
        f"its library_ms)")
    return {"binary_ip_rank": rank_row, "topk_select": topk_row,
            "beam_search": beam_row}


def recall_at(torch, eng, qt, ids) -> float:
    from repro_torch.data import synthetic
    gt = synthetic.ground_truth(eng.host.vectors, qt, ids.shape[1])
    hit = (ids.long()[:, :, None] == gt[:, None, :]).any(-1).sum()
    return float(hit) / gt.numel()


def phase_gemv(torch, eng, qt, beam_recall):
    """Phase 8: the same engine in GEMV mode. copy.copy shares every
    tensor, so it costs no device memory; one cluster_scan launch ranks
    and selects every probed cluster whole. The counted search's own
    cluster_scan arguments are recorded for phase 10."""
    from repro_torch.kernels import ops
    geng = copy.copy(eng)
    geng.scfg = dataclasses.replace(eng.scfg, scan="gemv")
    geng.search(qt)                                   # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    (res, stats), scan_calls = recording(ops, "ranked_cluster_scan",
                                         lambda: geng.search(qt))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = ops.launch_counts()
    qps = [qt.shape[0] / dt]
    for _ in range(3):
        t = time.perf_counter()
        geng.search(qt)
        torch.cuda.synchronize()
        qps.append(qt.shape[0] / (time.perf_counter() - t))
    if res.ids.shape != (qt.shape[0], eng.scfg.k) or not torch.isfinite(
            res.dists[res.ids >= 0]).all():
        fail(f"gemv search output malformed: ids {tuple(res.ids.shape)}")
    recall = recall_at(torch, eng, qt, res.ids)
    log(f"gemv search of {qt.shape[0]} queries: {dt * 1e3:.2f} ms, QPS "
        f"{', '.join(f'{v:.1f}' for v in qps)} (first = the counted run); "
        f"recall@10 {recall:.4f} (beam {beam_recall:.4f}); "
        f"{int((stats.hops > 0).sum())} live lanes")
    print("kernels gemv " + json.dumps(counts), flush=True)
    want = {"cluster_scan": 1, "topk_select": 1, "binary_ip_rank": 0}
    if any(counts[k] != v for k, v in want.items()) or len(scan_calls) != 1:
        fail(f"gemv search launched {counts} ({len(scan_calls)} recorded "
             f"cluster_scan calls), expected {want}")
    if recall < 0.5:
        fail(f"gemv recall@10 {recall:.4f} < 0.5")
    if recall < beam_recall:
        log(f"gemv recall {recall:.4f} is below the beam's {beam_recall:.4f}"
            f" within the same probed clusters")
    return scan_calls[0], counts, recall, qps


def backend_view(eng, mode, scan="beam"):
    """The engine under another ranking backend: copy.copy shares every
    placed tensor (codes, the 9 GB neighbour table, ...); only the
    backend's own arrays are placed anew (exact: residual_norm and
    cos_theta, 2 x 4096 x 17,089 float32 = 0.56 GB at 10M; hamming:
    none)."""
    from repro_torch.core import backends, engine
    v = copy.copy(eng)
    v.scfg = dataclasses.replace(eng.scfg, mode=mode, scan=scan)
    v.backend = backends.get_backend(mode)
    v.placed = dataclasses.replace(eng.placed, arrays=engine.place_arrays(
        v.backend.index_arrays(eng.index), eng.place))
    return v


def phase_backends(torch, eng, qt, recalls):
    """Phase 8b: the exact and hamming backends, each as a view of the 10M
    engine, search the same queries by beam and by GEMV, counted like
    phases 5 and 8 (one beam_search or one cluster_scan launch, one
    topk_select, no binary_ip_rank) and held to the recall floors taken
    from the JAX package (RECALL_FLOORS); the kernel of each search, on the
    counted search's own arguments, is held bitwise against its plain
    version (the plain loop; the plain scan over all lanes) and timed
    beside it and its bound."""
    from repro_torch.kernels import beam_search, ops, ref
    dim, cfg = eng.icfg.dim, eng.scfg
    rows = {}
    for mode in ("exact", "hamming"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        views = {"beam": backend_view(eng, mode)}
        views["gemv"] = copy.copy(views["beam"])
        views["gemv"].scfg = dataclasses.replace(views["beam"].scfg,
                                                 scan="gemv")
        log(f"{mode} view of the 10M engine: "
            f"{(torch.cuda.memory_allocated() - before) / 2**30:.3f} GiB "
            f"placed for its arrays")
        for scan, view in views.items():
            seam = "ranked_beam_search" if scan == "beam" \
                else "ranked_cluster_scan"
            kernel = ("beam_search" if scan == "beam" else "cluster_scan")
            view.search(qt)                           # warm
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t = time.perf_counter()
            (res, _), calls = recording(ops, seam, lambda: view.search(qt))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = ops.launch_counts()
            if res.ids.shape != (qt.shape[0], cfg.k) or not torch.isfinite(
                    res.dists[res.ids >= 0]).all():
                fail(f"{mode} {scan} search output malformed: ids "
                     f"{tuple(res.ids.shape)}")
            recall = recall_at(torch, eng, qt, res.ids)
            recalls[f"{mode}/{scan}"] = recall
            print(f"kernels {mode} {scan} " + json.dumps(counts), flush=True)
            want = {kernel: 1, "topk_select": 1, "binary_ip_rank": 0}
            if any(counts[k] != v for k, v in want.items()) \
                    or len(calls) != 1:
                fail(f"the {mode} {scan} search launched {counts} "
                     f"({len(calls)} recorded {seam} calls), expected "
                     f"{want}")
            floor = RECALL_FLOORS[f"{mode}/{scan}"]
            log(f"{mode} {scan} search of {qt.shape[0]} queries: "
                f"{dt * 1e3:.2f} ms (QPS {qt.shape[0] / dt:.1f}); recall@10 "
                f"{recall:.4f} (mulfree {recalls['mulfree/' + scan]:.4f}; "
                f"floor {floor})")
            if recall < floor:
                fail(f"{mode} {scan} recall@10 {recall:.4f} < {floor}")
            name = f"{kernel}/{mode}"
            if scan == "gemv":
                row = hold_scan(torch, calls[0], name, f"{mode} gemv search")
            else:
                args = calls[0][:6]
                got = beam_search.ranked_beam_search(*args, dim, cfg.ef,
                                                     cfg.max_iters, eng_m(eng))
                want_out, reads = plain_beam_counted(
                    torch, args, dim, cfg.ef, cfg.max_iters, eng_m(eng))
                for part, x, y in zip(("ids", "ranks", "hops"), got,
                                      want_out):
                    bitwise(torch, name, f"{mode} search {part}", x, y)
                bound = beam_bound(args, cfg.ef, dim, reads)
                row = timed_row(
                    torch, f"{name} {mode} search L={args[4].numel()} "
                    f"({int(args[5].sum())} live) EF={cfg.ef}",
                    lambda: beam_search.ranked_beam_search(
                        *args, dim, cfg.ef, cfg.max_iters, eng_m(eng)),
                    lambda: ref.ranked_beam_search_ref(
                        *args, dim, cfg.ef, cfg.max_iters, eng_m(eng)),
                    30, bound)
                hops = want_out[2]
                smem = beam_search.smem_bytes(cfg.ef, args[2].shape[1],
                                              eng_m(eng), args[0].shape[1],
                                              mode)
                log(f"{name}: {int(hops.sum())} hops (at most "
                    f"{int(hops.max())}), {reads.slots} (lane, row) slots "
                    f"ranked, {reads.rows} distinct rows, {reads.expanded} "
                    f"expanded; bound {bound[0]:.5f} ms ({bound[1]}); "
                    f"{smem} bytes of shared memory a block")
                row["library_ms"] = None
            row["launches"] = counts[kernel]
            rows[name] = row
        del views
    return rows


def eng_m(eng) -> int:
    """The engine's cluster budget M (rows a cluster holds)."""
    return eng.placed.codes.shape[-2]


def phase_mixed_tier(torch, topo, qt):
    """Phase 9b: a second tier over views of phase 9's 8 partition engines,
    their backends cycling mulfree, exact, hamming (no second
    partitioning). The queries run unrestricted, then with backend= None
    and "exact" alternating; in each counted run every partial a partition
    engine flushed equals that engine's own search_probed of the same rows
    (bitwise, ids and dists), the tier's ids equal merge_topk_ref of the
    partials, and the restricted rows' ids all come from exact
    partitions."""
    from repro_torch.core import topology
    from repro_torch.kernels import ops, ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    modes = [MIXED[o % len(MIXED)] for o in range(len(topo.groups))]
    views = [backend_view(g[0], mode) for g, mode in zip(topo.groups, modes)]
    mixed = topology.ServingTopology(
        [[v] for v in views], part_of=topo.part_of, local_cid=topo.local_cid,
        centroids=topo.centroids, buckets=topo.buckets)
    mixed.warm()
    q = qt.cpu().numpy()
    exact_nodes = torch.cat([v.index.node_ids.reshape(-1)
                             for v, mode in zip(views, modes)
                             if mode == "exact"])
    alternate = [None if i % 2 else "exact" for i in range(len(q))]
    for label, backend in (("unrestricted", None),
                           ("alternating None / exact", alternate)):
        mixed.run(q, backend=backend)                 # warm
        torch.cuda.synchronize()
        flushed = []
        real_finish = topology.ShardWorker._finish

        def finish(worker, idxs, res, t_dispatch):
            flushed.append((worker.shard, np.array(idxs), res.ids.clone(),
                            res.dists.clone()))
            return real_finish(worker, idxs, res, t_dispatch)
        ops.reset_launch_counts()
        topology.ShardWorker._finish = finish
        try:
            t = time.perf_counter()
            rep = mixed.run(q, backend=backend)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            topology.ShardWorker._finish = real_finish
        counts = ops.launch_counts()
        tables, touches, _, _ = mixed._route_probes(q, backend)
        slots = np.cumsum(touches, axis=1) - 1
        k = mixed.k
        part_ids = np.full((len(q), mixed.fanout * k), -1, np.int32)
        part_d = np.full((len(q), mixed.fanout * k), np.inf, np.float32)
        for o, idxs, ids, dists in flushed:
            res, _ = views[o].search_probed(q[idxs], tables[o][idxs])
            bitwise(torch, "mixed tier", f"{label} shard {o} ({modes[o]}) "
                    f"partial ids", ids, res.ids)
            bitwise(torch, "mixed tier", f"{label} shard {o} partial dists",
                    dists, res.dists)
            cols = slots[idxs, o][:, None] * k + np.arange(k)
            part_ids[idxs[:, None], cols] = ids.cpu().numpy()
            part_d[idxs[:, None], cols] = dists.cpu().numpy()
        want, _ = ref.merge_topk_ref(torch.from_numpy(part_ids),
                                     torch.from_numpy(part_d), k=k)
        if not (want.numpy() == rep.ids).all():
            fail(f"mixed tier {label}: the tier's ids differ from "
                 f"merge_topk_ref of its partials")
        if backend is not None:
            got = torch.from_numpy(rep.ids[0::2]).to(qt.device).reshape(-1)
            got = got[got >= 0]
            if not torch.isin(got, exact_nodes).all():
                fail(f"mixed tier {label}: a row restricted to exact holds "
                     f"ids of another backend's partition")
        log(f"mixed tier ({', '.join(modes)}) {label}: {dt * 1e3:.2f} ms "
            f"(QPS {rep.qps:.1f}); {len(flushed)} partials held against "
            f"their engines' search_probed; ids equal merge_topk_ref of them; "
            f"n_unrouted {rep.n_unrouted}, fanout_mean "
            f"{rep.fanout_mean:.3f}, queries per shard "
            f"{[d['queries'] for d in rep.per_engine]}; launches {counts}")
    log(f"mixed tier peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_sharded(torch, eng, qt, single, beam_recall):
    """Phase 9: the sharded tier over 8 disjoint partition engines on this
    card; every query arrives at t = 0. Held against the single engine's
    search of the same queries (phase 5)."""
    from repro_torch.core import topology
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    topo = topology.TopologyConfig(shards=8, buckets=(256, 1024)).build(eng)
    torch.cuda.synchronize()
    log(f"partitioned into 8 engines in {time.perf_counter() - t:.1f} s; "
        f"device memory {before / 2**30:.2f} GiB before, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    topo.warm()
    q = qt.cpu().numpy()
    t = time.perf_counter()
    topo.run(q)                  # warm at the real bucket shapes and probes
    torch.cuda.synchronize()
    log(f"warm-up run {1e3 * (time.perf_counter() - t):.2f} ms")
    ops.reset_launch_counts()
    rep = topo.run(q)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    runs = [rep] + [topo.run(q) for _ in range(4)]
    med = {key: float(np.median([getattr(r, key) for r in runs]))
           for key in ("qps", "p50_ms", "p99_ms")}
    per_shard = [d["queries"] for d in rep.per_engine]
    log(f"sharded runs of {rep.n_queries} queries (the first counted): QPS "
        f"{', '.join(f'{r.qps:.1f}' for r in runs)}; p50 ms "
        f"{', '.join(f'{r.p50_ms:.2f}' for r in runs)}; p99 ms "
        f"{', '.join(f'{r.p99_ms:.2f}' for r in runs)}; median QPS "
        f"{med['qps']:.1f}, p50 {med['p50_ms']:.2f} ms, p99 "
        f"{med['p99_ms']:.2f} ms")
    log(f"counted run: makespan {rep.makespan_s * 1e3:.2f} ms; fanout_mean "
        f"{rep.fanout_mean:.3f}, n_flushes {rep.n_flushes}, n_merges "
        f"{rep.n_merges} (sizes {rep.merge_sizes}), n_unrouted "
        f"{rep.n_unrouted}, n_shed {rep.n_shed}; queries per shard "
        f"{per_shard}")
    print("kernels sharded " + json.dumps(counts), flush=True)
    if counts["merge_topk"] == 0:
        fail(f"the sharded run never launched merge_topk: {counts}")
    ids, dists = rep.ids, rep.dists
    want_ids, want_d = single.ids.cpu().numpy(), single.dists.cpu().numpy()
    if ids.shape != want_ids.shape:
        fail(f"sharded ids {ids.shape} vs single engine {want_ids.shape}")
    same = ids == want_ids
    log(f"sharded ids equal the single engine's in {int(same.sum())} of "
        f"{same.size} slots; {int((~same).sum())} differ")
    if same.mean() < 0.999:
        fail(f"sharded ids match the single engine in only "
             f"{same.mean():.5f} of slots")
    err = np.abs(dists[same] - want_d[same])
    if not np.allclose(dists[same], want_d[same], rtol=1e-5, atol=1e-4):
        fail(f"sharded dists differ from the single engine's where the ids "
             f"agree (max |diff| {err.max()})")
    recall = recall_at(torch, eng, qt, torch.from_numpy(ids).to(qt.device))
    log(f"sharded recall@10 {recall:.4f} (single engine {beam_recall:.4f}); "
        f"max |dist diff| where ids agree {float(err.max()):.3g}")
    if abs(recall - beam_recall) > 0.001:
        fail(f"sharded recall {recall:.4f} is not within 0.001 of the "
             f"single engine's {beam_recall:.4f}")
    return topo, counts, rep, med


def zipf_workload(torch, eng):
    """Phase 9c's traffic law over the 10M corpus: the row -> cluster
    assignment is the index build's own (row node_ids[c, s] belongs to
    cluster c), and popularity ranks run outward from the most central
    centroid (a spatial hot blob, as the JAX package's
    benchmarks/placement.py orders them). Returns (x on the host,
    assignment, hot_order, rows in no cluster)."""
    dev = eng.device
    nid = eng.index.node_ids
    n_rows = eng.host.vectors.shape[0]
    cl = torch.arange(nid.shape[0], device=dev,
                      dtype=torch.int32)[:, None].expand_as(nid)
    live = nid >= 0
    assign = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
    assign[nid[live].long()] = cl[live]
    assign = assign.cpu().numpy()
    x = eng.host.vectors.cpu().numpy()
    cents = eng.index.centroids.cpu().numpy()
    seed = int(np.argmin(((cents - cents.mean(0)) ** 2).sum(-1)))
    hot_order = np.argsort(((cents - cents[seed]) ** 2).sum(-1),
                           kind="stable")
    return x, assign, hot_order, int((assign < 0).sum())


def room_for_every_lane(eng):
    """The engine with lane_capacity_factor = its shard count: every lane
    of a batch fits on any one shard, so no skew of the traffic drops one
    (a view: copy.copy shares every placed tensor)."""
    v = copy.copy(eng)
    v.scfg = dataclasses.replace(
        eng.scfg, lane_capacity_factor=float(eng.place.n_shards))
    return v


def hold_ids(label, got, want) -> None:
    """A tier's top-k against a reference in every slot: the distances the
    same bits, and the ids equal wherever no other candidate lies at
    exactly the slot's distance. topk_select and merge_topk order exactly
    tied candidates by their column in the row (the JAX kernels' (dist,
    column) order), and a tier's merged columns are slot-major by shard
    where a single engine's are probe-major, so tied ids may come in
    another order or, at a row's last distance, be another pick of the
    tie. ``got`` / ``want``: (ids, dists) numpy pairs."""
    (gi, gd), (wi, wd) = got, want
    if gi.shape != wi.shape or not (gd.view(np.int32)
                                    == wd.view(np.int32)).all():
        fail(f"{label}: distances differ from the reference's in "
             f"{int((gd.view(np.int32) != wd.view(np.int32)).sum())} of "
             f"{wd.size} slots")
    diff = gi != wi
    for i in np.nonzero(diff.any(1))[0]:
        for v in np.unique(wd[i][diff[i]]):
            sel = wd[i] == v
            if v != wd[i, -1] and sorted(gi[i][sel]) != sorted(wi[i][sel]):
                fail(f"{label}: row {i} holds ids {gi[i].tolist()} where the "
                     f"reference holds {wi[i].tolist()} (distances "
                     f"{wd[i].tolist()})")
    log(f"{label}: distances equal in every slot; ids equal in "
        f"{int((~diff).sum())} of {diff.size} slots, the other "
        f"{int(diff.sum())} among exactly tied distances")


def pair(rep, rows=slice(None)):
    """(ids, dists) of a report or a search result as numpy, ``rows`` of
    them."""
    ids, dists = rep.ids, rep.dists
    if not isinstance(ids, np.ndarray):
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    return ids[rows], dists[rows]


def skew_of(rep) -> tuple[float, float]:
    """(hottest shard's share of routed probes, that share over 1/S)."""
    sp = rep.shard_probes.astype(np.float64)
    share = float(sp.max() / sp.sum())
    return share, share * len(sp)


def recording_calls(targets, fn):
    """fn() with each (module, name) of ``targets`` recording the
    (args, kwargs) of its calls: (fn's result, {name: [calls]})."""
    calls = {name: [] for _, name in targets}
    real = {name: getattr(mod, name) for mod, name in targets}

    def recorder(name):
        def record(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return record
    for mod, name in targets:
        setattr(mod, name, recorder(name))
    try:
        return fn(), calls
    finally:
        for mod, name in targets:
            setattr(mod, name, real[name])


def rank_line(stats, key, scale=1.0, fmt="{:.2f}") -> str:
    return ", ".join(fmt.format(s[key] * scale) for s in stats)


def check_mesh_launches(label, stats, kernels) -> dict:
    """Every rank launched each of ``kernels`` in the run (merge_topk at
    the origin only); returns the launches summed over the ranks."""
    for s in stats:
        need = [k for k in kernels if k != "merge_topk" or s["rank"] == 0]
        if any(s["launches"][k] == 0 for k in need):
            fail(f"{label}: rank {s['rank']} launched {s['launches']}, "
                 f"none of some of {need}")
    total = {k: sum(s["launches"][k] for s in stats)
             for k in stats[0]["launches"]}
    print(f"kernels {label} " + json.dumps(total), flush=True)
    log(f"{label}: launches by rank " + json.dumps(
        [s["launches"] for s in stats]))
    return total


def hold_rank0_kernels(torch, calls, label) -> None:
    """Each kernel call rank 0 made in a recorded mesh run, held bitwise
    against its plain version on the same arguments (the first call of
    each; the lanes of a scan 64 live ones and then all)."""
    from repro_torch.kernels import (beam_search, cluster_scan, merge_topk,
                                     ref, topk_select)
    plain = {"ranked_beam_search": (beam_search.ranked_beam_search,
                                    ref.ranked_beam_search_ref,
                                    "beam_search", ("ids", "ranks", "hops")),
             "topk_select": (topk_select.topk_select, ref.topk_select_ref,
                             "topk_select", ("ids", "dists")),
             "merge_topk": (merge_topk.merge_topk, ref.merge_topk_ref,
                            "merge_topk", ("ids", "dists"))}
    for name, recorded in calls.items():
        if not recorded:
            fail(f"{label}: rank 0 never called {name}")
        args, kw = recorded[0]
        if name == "ranked_cluster_scan":
            scan_args, rest = args[:5], args[5:]
            live = scan_args[4]
            for sub, what in ((lane_subset(scan_args, torch.nonzero(
                    live)[:64, 0]), "64 live lanes"), (scan_args,
                                                      "all lanes")):
                for field, x, y in zip(
                        ("ids", "ranks"),
                        cluster_scan.ranked_cluster_scan(*sub, *rest),
                        plain_scan(torch, ref, sub, *rest)):
                    bitwise(torch, "cluster_scan",
                            f"{label} rank 0 {what} {field}", x, y)
            continue
        kernel, want_fn, key, fields = plain[name]
        for field, x, y in zip(fields, kernel(*args, **kw),
                               want_fn(*args, **kw)):
            bitwise(torch, key, f"{label} rank 0 {field}", x, y)
    log(f"{label}: rank 0's {', '.join(calls)} held bitwise against their "
        f"plain versions on the run's own arguments")


def mesh_tiers(torch, eng, q, mesh, rep9, med9) -> dict:
    """Phase 13's work on the origin, the follower ranks serving: the
    beam tier (placement, warm-up, five runs, the counted one held against
    phase 9's tier and its kernels against their plain versions, the
    all_gather, a refresh), then a gemv tier."""
    from repro_torch.core import execbackend, topology
    from repro_torch.kernels import (beam_search, cluster_scan, merge_topk,
                                     topk_select)
    out = {}
    mb = execbackend.MeshBackend(mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    topo = topology.TopologyConfig(shards=MESH_RANKS, buckets=(256, 1024),
                                   exec=mb).build(eng)
    out["build_s"] = time.perf_counter() - t
    placed = mb.rank_stats(reset=True)
    log(f"13 mesh tier built in {out['build_s']:.1f} s (8 partitions cut on "
        f"the origin, then each placed on its rank: stacked on the host, "
        f"scattered over {mesh.device_type} collectives, copied to the "
        f"card); peak GiB by rank through placement "
        f"[{rank_line(placed, 'peak_bytes', 2**-30)}]")
    topo.warm()
    t = time.perf_counter()
    topo.run(q)
    log(f"13 warm-up run {1e3 * (time.perf_counter() - t):.2f} ms")
    mb.rank_stats(reset=True)                    # every count to 0
    rep, calls = recording_calls(
        [(beam_search, "ranked_beam_search"), (topk_select, "topk_select"),
         (merge_topk, "merge_topk")], lambda: topo.run(q))
    stats = mb.rank_stats()
    out["launches"] = check_mesh_launches(
        "mesh", stats, ("beam_search", "topk_select", "merge_topk"))
    runs = [rep] + [topo.run(q) for _ in range(4)]
    med = {key: float(np.median([getattr(r, key) for r in runs]))
           for key in ("qps", "p50_ms", "p99_ms")}
    out.update(med=med, stats=stats)
    log(f"13 mesh runs of {rep.n_queries} queries (the first counted): QPS "
        f"{', '.join(f'{r.qps:.1f}' for r in runs)}; p50 ms "
        f"{', '.join(f'{r.p50_ms:.2f}' for r in runs)}; p99 ms "
        f"{', '.join(f'{r.p99_ms:.2f}' for r in runs)}; median QPS "
        f"{med['qps']:.1f}, p50 {med['p50_ms']:.2f} ms, p99 "
        f"{med['p99_ms']:.2f} ms; phase 9's in-process tier in this call: "
        f"QPS {med9['qps']:.1f}, p50 {med9['p50_ms']:.2f} ms, p99 "
        f"{med9['p99_ms']:.2f} ms")
    log(f"13 counted run: {rep.n_flushes} flushes (sizes "
        f"{rep.flush_sizes}), {rep.n_merges} merges, fanout_mean "
        f"{rep.fanout_mean:.3f}, queries per shard "
        f"{[d['queries'] for d in rep.per_engine]}; by rank: search s "
        f"[{rank_line(stats, 'search_s', fmt='{:.4f}')}], host <-> card "
        f"copy s [{rank_line(stats, 'stage_s', fmt='{:.4f}')}], peak GiB "
        f"[{rank_line(stats, 'peak_bytes', 2**-30)}]")
    for i, r in enumerate(runs):
        hold_ids(f"13 mesh run {i} vs phase 9's in-process tier", pair(r),
                 pair(rep9))
    hold_rank0_kernels(torch, calls, "13 mesh beam")
    out["gather_ms"] = {b: mb.time_gather(b, 50) for b in (256, 1024)}
    log(f"13 all_gather of one flush's partials ({MESH_RANKS} ranks x B "
        f"rows x 2k int32, {mesh.device_type}): "
        + ", ".join(f"B={b}: {ms:.3f} ms" for b, ms in
                    out["gather_ms"].items()))
    t = time.perf_counter()
    mb.refresh(topo)
    out["refresh_s"] = time.perf_counter() - t
    again = topo.run(q)
    if not (np.array_equal(again.ids, rep.ids)
            and np.array_equal(again.dists.view(np.int32),
                               rep.dists.view(np.int32))):
        fail("13: the mesh tier's results changed across a refresh")
    log(f"13 refresh of every partition in {out['refresh_s']:.2f} s; "
        f"results unchanged bit for bit")
    del topo, mb, runs, again
    torch.cuda.empty_cache()

    view = backend_view(eng, "mulfree", scan="gemv")
    gb = execbackend.MeshBackend(mesh=mesh)
    gtopo = topology.TopologyConfig(shards=MESH_RANKS, buckets=(256, 1024),
                                    exec=gb).build(view)
    inproc = topology.ServingTopology(
        gtopo.groups, part_of=gtopo.part_of, local_cid=gtopo.local_cid,
        centroids=gtopo.centroids, buckets=gtopo.buckets)
    gtopo.warm()
    gtopo.run(q)
    gb.rank_stats(reset=True)
    grep, gcalls = recording_calls(
        [(cluster_scan, "ranked_cluster_scan")], lambda: gtopo.run(q))
    gstats = gb.rank_stats()
    out["gemv_launches"] = check_mesh_launches(
        "mesh gemv", gstats, ("cluster_scan", "topk_select", "merge_topk"))
    hold_ids("13 mesh gemv vs the in-process tier over its partitions",
             pair(grep), pair(inproc.run(q)))
    hold_rank0_kernels(torch, gcalls, "13 mesh gemv")
    out["gemv_qps"] = grep.qps
    log(f"13 mesh gemv run: QPS {grep.qps:.1f}, p50 {grep.p50_ms:.2f} ms, "
        f"p99 {grep.p99_ms:.2f} ms")
    del gtopo, gb, inproc, view
    torch.cuda.empty_cache()
    return out


def phase_mesh(torch, eng, qt, rep9, med9) -> dict:
    """Phase 13: the mesh execution backend at 10M on the card. Seven
    follower ranks are spawned (``launch.mesh.follower_main``); with this
    process, the origin, they form an 8-rank gloo group (every rank shares
    this card, so NCCL cannot run) through a file store under build/.
    ``mesh_tiers`` then serves the tiers; the followers are stopped and
    joined whatever happens, and a follower that exits non-zero fails the
    smoke."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.core import execbackend
    from repro_torch.launch import mesh as lmesh
    t_phase = time.perf_counter()
    store = ROOT / "build" / f"mesh-store-{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    init = f"file://{store}"
    # one host: gloo's sockets stay on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()         # the ranks' memory comes off the card
    ctx = mp.get_context("spawn")
    t = time.perf_counter()
    procs = [ctx.Process(target=lmesh.follower_main,
                         args=(r, MESH_RANKS, init, "cuda", MESH_TIMEOUT_S))
             for r in range(1, MESH_RANKS)]
    for p in procs:
        p.start()
    mesh = None
    try:
        lmesh.init_shard_group(0, MESH_RANKS, init_method=init,
                               device=eng.device, timeout_s=MESH_TIMEOUT_S)
        mesh = lmesh.make_shard_mesh(MESH_RANKS, device=eng.device)
        start_s = time.perf_counter() - t
        log(f"13 {MESH_RANKS} ranks up in {start_s:.1f} s (7 spawned): "
            f"{dist.get_backend()} collectives on a {mesh.device_type} mesh "
            f"of world size {dist.get_world_size()}, every rank on "
            f"{eng.device} ({lmesh.collective_backend(MESH_RANKS, 'cuda')} "
            f"by the rule: {torch.cuda.device_count()} card(s) for "
            f"{MESH_RANKS} ranks)")
        out = mesh_tiers(torch, eng, qt.cpu().numpy(), mesh, rep9, med9)
        out["start_s"] = start_s
    finally:
        if mesh is not None:
            execbackend.MeshBackend(mesh=mesh).close()
        for p in procs:
            p.join(60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if dist.is_initialized():
            dist.destroy_process_group()
        if store.exists():
            store.unlink()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        fail(f"13: follower ranks exited with {codes}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"13 done in {out['phase_s']:.1f} s; followers exited 0")
    return out


def phase_skewed_tier(torch, eng):
    """Phase 9c: the skew-aware tier on the 10M engine. (a) 4,096 Zipf(1.0)
    queries on the size-prior 8-shard tier, then on a heat-aware tier
    built from that run's cluster_hits with the 64 hottest clusters
    resident on 4 shards (choose_owners routes each probe of a replicated
    cluster to one owner); (b) 3 rounds of drifting Zipf(1.4) traffic, each
    concentrated on one current shard, through a Rebalancer whose swaps
    apply_placement re-slices on the card; (c) two tenants (DWRR, a
    latency tenant cut to nprobe 4); (d) hedged dispatch over two
    replicas a shard, and replica scaling. Every tier is held against
    eng.search or its own reference in every slot (``hold_ids``)."""
    from repro_torch.core import autoscale, ivf, topology
    from repro_torch.data import synthetic
    from repro_torch.distributed.straggler import HedgeConfig
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    x, assign, hot_order, unassigned = zipf_workload(torch, eng)
    n_clusters = len(hot_order)
    q, target = synthetic.zipf_query_set(7, x, assign, 4096, s=1.0,
                                         hot_order=hot_order,
                                         n_clusters=n_clusters)
    hist = np.bincount(target, minlength=n_clusters)
    log(f"9c: Zipf(1.0) workload of {len(q)} queries made on the host in "
        f"{time.perf_counter() - t:.1f} s ({unassigned} rows in no "
        f"cluster); the 64 hottest target clusters draw "
        f"{np.sort(hist)[::-1][:64].sum() / len(q):.3f} of the queries")
    res, stats = eng.search(q)
    want = (res.ids.cpu().numpy(), res.dists.cpu().numpy())
    if int(stats.dropped_lanes):
        fail(f"9c: eng.search dropped {int(stats.dropped_lanes)} lanes")

    # (a) size prior, then heat-aware placement with hot replicas
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = topology.TopologyConfig(shards=8, buckets=(256, 1024))
    base = cfg.build(eng)
    base.warm()
    base.run(q)
    rep_b = base.run(q)
    share_b, skew_b = skew_of(rep_b)
    heat = rep_b.cluster_hits
    hold_ids("9c size-prior tier vs eng.search", pair(rep_b), want)
    log(f"9c size-prior tier: QPS {rep_b.qps:.1f}, p50 {rep_b.p50_ms:.2f} "
        f"ms, p99 {rep_b.p99_ms:.2f} ms, fanout {rep_b.fanout_mean:.3f}, "
        f"hottest shard's share of shard_probes {share_b:.4f} (skew "
        f"{skew_b:.3f}), shard_probes {rep_b.shard_probes.tolist()}")
    del base
    torch.cuda.empty_cache()
    t = time.perf_counter()
    topo = dataclasses.replace(cfg, replicate_hot=64,
                               replica_factor=4).build(eng, heat=heat)
    torch.cuda.synchronize()
    pl = topo.placement
    cap = pl.resident_table.shape[1] - pl.per_shard
    log(f"9c replicated tier built in {time.perf_counter() - t:.1f} s: "
        f"{int((pl.owners_of[:, 1:] >= 0).any(1).sum())} clusters with "
        f"{int((pl.owners_of[:, 1:] >= 0).sum())} copies, {cap} replica "
        f"slots a shard ({pl.per_shard} primaries); device memory "
        f"{base_mem / 2**30:.2f} GiB before the tiers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB now, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    topo.warm()
    topo.run(q)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = topo.run(q)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print("kernels skewed " + json.dumps(counts), flush=True)
    if any(counts[k] == 0 for k in ("beam_search", "topk_select",
                                    "merge_topk")):
        fail(f"the replicated tier's run missed a kernel: {counts}")
    runs = [rep] + [topo.run(q) for _ in range(2)]
    med = {key: float(np.median([getattr(r, key) for r in runs]))
           for key in ("qps", "p50_ms", "p99_ms")}
    share_r, skew_r = skew_of(rep)
    hold_ids("9c replicated tier vs eng.search", pair(rep), want)
    hold_ids("9c replicated tier vs the size-prior tier", pair(rep),
             pair(rep_b))
    probe = ivf.cluster_filter(torch.from_numpy(q).to(eng.device),
                               topo.centroids, nprobe=topo.nprobe)[0]
    probe = probe.cpu().numpy()
    t = time.perf_counter()
    ivf.choose_owners(probe, pl.owners_of, pl.locals_of,
                      n_owners=len(topo.groups))
    route_ms = 1e3 * (time.perf_counter() - t)
    log(f"9c replicated tier (the first run counted, median of 3): QPS "
        f"{', '.join(f'{r.qps:.1f}' for r in runs)} (median "
        f"{med['qps']:.1f}), p50 {med['p50_ms']:.2f} ms, p99 "
        f"{med['p99_ms']:.2f} ms, fanout {rep.fanout_mean:.3f} (size prior "
        f"{rep_b.fanout_mean:.3f}); hottest shard's share of shard_probes "
        f"{share_b:.4f} -> {share_r:.4f} (x{share_b / share_r:.3f} cut), "
        f"shard_probes {rep.shard_probes.tolist()}; choose_owners on the "
        f"host {route_ms:.1f} ms for {probe.shape[0]} x {probe.shape[1]} "
        f"probes; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # (b) drift: the Rebalancer re-places clusters on the live tier
    pol = autoscale.RebalancePolicy(skew_high=1.3, patience=1,
                                    move_penalty=0.0)
    reb = autoscale.Rebalancer(topo, pol)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    fired = 0
    for r in range(3):
        part = topo.part_of.copy()
        hot_shard = r % len(topo.groups)
        order_r = np.concatenate([np.flatnonzero(part == hot_shard),
                                  np.flatnonzero(part != hot_shard)])
        qr, _ = synthetic.zipf_query_set(101 + r, x, assign, 1024, s=1.4,
                                         hot_order=order_r,
                                         n_clusters=n_clusters)
        rep_r = topo.run(qr)
        skew = skew_of(rep_r)[1]
        t = time.perf_counter()
        act = reb.step(rep_r)
        torch.cuda.synchronize()
        swap_s = time.perf_counter() - t
        if act is None:
            log(f"9c drift round {r}: skew {skew:.3f}, no rebalance")
            continue
        fired += 1
        rep2 = topo.run(qr)
        # eng's 8 inner shards take 2 / 8 of a batch's lanes each; a round
        # hot on a few clusters can overflow one, and the reference must
        # not drop what the tier serves
        dropped = int(eng.search(qr)[1].dropped_lanes)
        ref, stats = room_for_every_lane(eng).search(qr)
        if int(stats.dropped_lanes):
            fail(f"9c drift round {r}: the reference dropped lanes")
        hold_ids(f"9c drift round {r} after apply_placement vs eng.search "
                 f"with room for every lane (at its own capacity it drops "
                 f"{dropped} lanes)", pair(rep2), pair(ref))
        log(f"9c drift round {r}: skew {skew:.3f} -> "
            f"{skew_of(rep2)[1]:.3f} after a rebalance of {act.n_moved} "
            f"primaries ({act.replicated} clusters replicated) in "
            f"{swap_s:.2f} s (rebalance + replicate_hot + apply_placement)")
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    log(f"9c drift: the Rebalancer fired {fired} of 3 rounds; allocated "
        f"device memory {mem0 / 2**30:.3f} GiB before the swaps, "
        f"{mem1 / 2**30:.3f} GiB after")
    if fired == 0:
        fail("9c drift: the Rebalancer never fired")
    if abs(mem1 - mem0) > 2**30:
        fail(f"9c drift: allocated memory moved by "
             f"{(mem1 - mem0) / 2**30:.3f} GiB across the swaps")

    # (c) two tenants on the same engines
    specs = [topology.TenantSpec("latency", weight=4, nprobe=4),
             topology.TenantSpec("recall", weight=1)]
    tier_kw = dict(part_of=topo.part_of, local_cid=topo.local_cid,
                   centroids=topo.centroids, placement=topo.placement,
                   source=eng, buckets=topo.buckets)
    tenanted = topology.ServingTopology(topo.groups, tenants=specs,
                                        **tier_kw)
    labels = [("latency", "recall")[i % 2] for i in range(len(q))]
    lat = np.arange(len(q)) % 2 == 0
    rep_t = tenanted.run(q, tenant=labels)
    hold_ids("9c tenant latency (nprobe 4) vs alone", pair(rep_t, lat),
             pair(tenanted.run(q[lat], tenant="latency")))
    hold_ids("9c tenant recall vs alone", pair(rep_t, ~lat),
             pair(tenanted.run(q[~lat], tenant="recall")))
    hold_ids("9c tenant recall vs eng.search", pair(rep_t, ~lat),
             (want[0][~lat], want[1][~lat]))
    for name, st in rep_t.tenants.items():
        log(f"9c tenant {name}: weight {st['weight']}, admitted "
            f"{st['n_admitted']}, p50 {st['p50_ms']:.2f} ms, p99 "
            f"{st['p99_ms']:.2f} ms, probes {int(st['cluster_hits'].sum())}")

    # (d) hedged dispatch over two replicas a shard, and replica scaling
    for o in range(len(topo.groups)):
        topo.scale_replicas(o, 2)
    plain = topo.run(q)
    hedged = topology.ServingTopology(topo.groups, hedge=HedgeConfig(),
                                      **tier_kw)
    rep_h = hedged.run(q)
    hold_ids("9c hedged tier vs the unhedged one", pair(rep_h), pair(plain))
    hold_ids("9c hedged tier vs eng.search", pair(rep_h), want)
    for n_rep in (3, 1):
        hedged.scale_replicas(0, n_rep)
        hold_ids(f"9c hedged tier with shard 0 at {n_rep} replicas",
                 pair(hedged.run(q)), pair(plain))
    log(f"9c hedged tier: n_reissued {rep_h.n_reissued}, n_duplicate_drops "
        f"{rep_h.n_duplicate_drops}, shard EWMA ms "
        f"{[round(v, 3) for v in rep_h.shard_ewma_ms]}, QPS {rep_h.qps:.1f} "
        f"(unhedged {plain.qps:.1f}), p99 {rep_h.p99_ms:.2f} ms (unhedged "
        f"{plain.p99_ms:.2f})")
    del hedged, tenanted, topo
    torch.cuda.empty_cache()
    log(f"9c done in {time.perf_counter() - t_phase:.1f} s")
    return counts


def sink_partials(torch, topo, q):
    """The origin merge's real input: every shard's search_probed partial
    top-k of q, gathered in ShardedSink's slot layout, (N, fanout * k)."""
    tables, touches, _, _ = topo._route_probes(q)
    slots = np.cumsum(touches, axis=1) - 1
    k = topo.k
    part_ids = np.full((len(q), topo.fanout * k), -1, np.int32)
    part_d = np.full((len(q), topo.fanout * k), np.inf, np.float32)
    for o, grp in enumerate(topo.groups):
        rows = np.nonzero(touches[:, o])[0]
        if not len(rows):
            continue
        res, _ = grp[0].search_probed(q[rows], tables[o][rows])
        cols = slots[rows, o][:, None] * k + np.arange(k)
        part_ids[rows[:, None], cols] = res.ids.cpu().numpy()
        part_d[rows[:, None], cols] = res.dists.cpu().numpy()
    dev = topo.device
    return (torch.from_numpy(part_ids).to(dev),
            torch.from_numpy(part_d).to(dev))


def plain_scan(torch, ref, args, dim, ef, m, chunk=128):
    """cluster_scan's plain version over every lane of the ranked arguments
    ``args``, ``chunk`` lanes at a time: one call over all lanes would hold
    an (L, M, dim) table."""
    outs = [ref.ranked_cluster_scan_ref(
        *lane_subset(args, slice(i, i + chunk)), dim, ef, m)
        for i in range(0, args[2].shape[0], chunk)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def phase_new_kernels_real(torch, topo, rep, scan_call, qt):
    """Phase 10: merge_topk on the real gathered partials of phase 9 and
    cluster_scan on the arguments of phase 8's counted gemv search, each
    held bitwise against its plain version and timed beside it."""
    from repro_torch.kernels import merge_topk, ref, topk_select
    k = topo.k
    ids, d = sink_partials(torch, topo, qt.cpu().numpy())
    got = merge_topk.merge_topk(ids, d, k=k)
    want = ref.merge_topk_ref(ids, d, k=k)
    for name, a, b in zip(("ids", "dists"), got, want):
        bitwise(torch, "merge_topk", f"real Q={ids.shape[0]} W={ids.shape[1]} "
                f"{name}", a, b)
    for route in topk_select.ROUTES:
        for name, a, b in zip(("ids", "dists"),
                              merge_topk._launch(ids, d, k=k, run=k,
                                                 route=route), want):
            bitwise(torch, "merge_topk", f"real {route} route {name}", a, b)
    if not (got[0].cpu().numpy() == rep.ids).all():
        fail("merge_topk on the rebuilt partials disagrees with the "
             "sharded run's output")
    merge_row = timed_row(
        torch, f"merge_topk real Q={ids.shape[0]} W={ids.shape[1]} k={k}",
        lambda: merge_topk.merge_topk(ids, d, k=k),
        lambda: ref.merge_topk_ref(ids, d, k=k), 100,
        merge_bound(ids.shape[0], ids.shape[1], k))
    route_turns(torch, f"merge_topk real Q={ids.shape[0]} W={ids.shape[1]} "
                f"k={k}", lambda r: merge_topk._launch(ids, d, k=k, run=k,
                                                       route=r), 100)
    lib, lib_wall = times(torch, lambda: torch.topk(d, k, largest=False),
                          100)
    merge_row["library_ms"] = lib if lib is not None else lib_wall
    log(f"merge_topk real merge: the main path takes the "
        f"{topk_select.route_for(ids.shape[1], k)} route; library "
        f"(torch.topk, another tie order): "
        f"{merge_row['library_ms']:.5f} ms on the device")

    scan_row = hold_scan(torch, scan_call, "cluster_scan", "real gemv search")
    scan_row["library_ms"] = None
    return {"merge_topk": merge_row, "cluster_scan": scan_row}


def hold_scan(torch, call, kernel, label):
    """cluster_scan on a recorded call's ranked arguments (codes, rank,
    base_rows, n_valid, active, dim, ef, m), held bitwise against its plain
    version on 64 live lanes and on all lanes, and timed there beside its
    bound (``scan_bound``); ``kernel`` names the kernels-line entry."""
    from repro_torch.kernels import cluster_scan, ref
    args, (dim, ef, m) = call[:5], call[5:]
    rank, live = args[1], args[4]
    w = args[0].shape[1]
    log(f"{kernel} at W={w} EF={ef}: "
        f"{cluster_scan.smem_bytes(w, ef, rank.kind)} bytes of dynamic "
        f"shared memory per block; ptxas: "
        f"{'; '.join(PTXAS.get('cluster_scan', ['not built here']))}")
    sub = lane_subset(args, torch.nonzero(live)[:64, 0])
    for name, x, y in zip(("ids", "ranks"),
                          cluster_scan.ranked_cluster_scan(*sub, dim, ef, m),
                          ref.ranked_cluster_scan_ref(*sub, dim, ef, m)):
        bitwise(torch, kernel, f"{label} 64 lanes {name}", x, y)
    bound = scan_bound(torch, sub, dim, ef)
    timed_row(torch, f"{kernel} {label} 64 live lanes M={m} EF={ef}",
              lambda: cluster_scan.ranked_cluster_scan(*sub, dim, ef, m),
              lambda: ref.ranked_cluster_scan_ref(*sub, dim, ef, m), 30,
              bound)
    for name, x, y in zip(("ids", "ranks"),
                          cluster_scan.ranked_cluster_scan(*args, dim, ef, m),
                          plain_scan(torch, ref, args, dim, ef, m)):
        bitwise(torch, kernel, f"{label} all {live.numel()} lanes {name}",
                x, y)
    bound = scan_bound(torch, args, dim, ef)
    row = timed_row(
        torch, f"{kernel} {label} L={live.numel()} ({int(live.sum())} live) "
        f"M={m} EF={ef}",
        lambda: cluster_scan.ranked_cluster_scan(*args, dim, ef, m),
        lambda: plain_scan(torch, ref, args, dim, ef, m), 30, bound)
    log(f"{kernel} {label}: bound {bound[0]:.5f} ms ({bound[1]}), "
        f"{bound[2]:.5f} ms by the bit count (a mask and an add per code "
        f"bit); {int(args[3][live].clamp(0, m).sum())} valid rows scanned by "
        f"the live lanes")
    row["library_ms"] = None
    return row


def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [] if tree is None else [tree]


def phase_lm(torch, dev, eng):
    """Phase 11: the LM serving path at h2o-danube-1.8b's full width, with
    retrieval into the 10M engine. Returns (launches of the counted run,
    the flash_attention timing row)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import StreamingScheduler, bucket_ladder
    from repro_torch.kernels import flash_attn, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    cfg = get_config("h2o-danube-1.8b")
    b, prompt, n_gen = 8, 2048, 32
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers x d_model {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.window}; "
        f"{n_params / 1e9:.3f} B params ({cfg.param_count() / 1e9:.3f} B by "
        f"the config's count) drawn on the card in "
        f"{time.perf_counter() - t:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                           device=dev)
    sched = StreamingScheduler(eng, buckets=bucket_ladder(b),
                               fill_threshold=max(b // 2, 1),
                               wait_limit_s=5e-3)
    enc = serve.mean_pool_encoder(params, eng.icfg.dim)

    def cache():
        return model.init_cache(b, prompt + n_gen, dtype=torch.float32,
                                device=dev)
    serve.generate(model, params, tokens, 2, cache())     # warm-up
    calls = []
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        if not calls:                 # layer 0 of the counted prefill
            calls.append((q.clone(), k.clone(), v.clone(), kw))
        return real(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c = cache()
    ops.flash_attention = recording
    ops.reset_launch_counts()
    try:
        out = serve.generate(model, params, tokens, n_gen, c,
                             scheduler=sched, encoder=enc)
    finally:
        ops.flash_attention = real
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = out.prefill_s + out.decode_s + out.retrieve_s
    log(f"generate B={b} prompt={prompt} gen={n_gen}: prefill "
        f"{out.prefill_s * 1e3:.2f} ms, decode {out.decode_s * 1e3 / (n_gen - 1):.3f}"
        f" ms per step ({n_gen - 1} steps), retrieval "
        f"{out.retrieve_s * 1e3:.2f} ms; {b * n_gen / total:.1f} generated "
        f"tokens/s ({b * (prompt + n_gen) / total:.1f} tokens/s with the "
        f"prompt); peak device memory {peak:.2f} GiB")
    print("kernels lm " + json.dumps(counts), flush=True)
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"the prefill launched flash_attention {counts['flash_attention']}"
             f" times, expected one a layer ({cfg.n_layers})")
    toks = out.tokens
    if toks.shape != (b, n_gen) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"generated tokens malformed: {tuple(toks.shape)}")
    if not torch.isfinite(out.logits).all():
        fail("the last decode step's logits are not finite")
    ids = out.report.ids
    log(f"retrieved ids (k={ids.shape[1]}) of the {b} requests: "
        f"{ids.tolist()}")
    res, _ = eng.search(torch.from_numpy(out.queries).to(dev))
    same = ids == res.ids.cpu().numpy()
    log(f"retrieved ids equal engine.search of the same queries in "
        f"{int(same.sum())} of {same.size} slots")
    if not same.all():
        fail("the RAG loop's retrieved ids differ from engine.search")

    # the last decode step (plain one-pass attention over the cache) against
    # a prefill of the same tokens (the kernel), at that step's position
    full = torch.cat([tokens, toks[:, :-1].long()], dim=1)
    logits_p, cp = model.prefill(params, full, cache())
    got, want = out.logits[:, -1].float(), logits_p[:, -1].float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    arg_d, arg_p = got.argmax(-1), want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    log(f"decode vs prefill logits at position {full.shape[1] - 1}: max "
        f"|diff| {err:.4f}, max |logit| {scale:.4f} (ratio "
        f"{err / scale:.4f}), median |logit| "
        f"{float(want.abs().median()):.4f}; argmax agrees in "
        f"{int((arg_d == arg_p).sum())} of {b} rows; the prefill's top-2 "
        f"margins {[round(x, 4) for x in margin]}")
    # both run 24 bf16 layers; the two attentions sum in another order and
    # the matmuls run at other batch shapes, so bf16 roundings (2^-8
    # relative) differ and compound over the layers. The greedy token must
    # not change in any row: it is what decode serves.
    if err > 0.05 * scale:
        fail(f"decode logits differ from the prefill's by {err:.4f} > 5% of "
             f"their largest magnitude {scale:.4f}")
    if not torch.equal(arg_d, arg_p):
        fail(f"decode's greedy token differs from the prefill's in "
             f"{int((arg_d != arg_p).sum())} of {b} rows")

    q0, k0, v0, kw0 = calls[0]
    bf = torch.bfloat16
    exact = [torch.equal(t.to(bf).float(), t) for t in (k0, v0)]
    log(f"layer 0's K / V ({k0.dtype}) bf16-exact: {exact[0]} / {exact[1]}")
    label = (f"real layer 0 q {tuple(q0.shape)} {str(q0.dtype)[6:]}, k/v "
             f"{tuple(k0.shape)} {str(k0.dtype)[6:]}, {kw0}")
    got0 = flash_attn.flash_attention(q0, k0, v0, **kw0)
    hold_bf16_attention(torch, label, got0, q0, k0, v0, kw0)
    row = timed_row(
        torch, f"flash_attention real layer 0 B={b} Sq={q0.shape[1]} "
        f"Sk={k0.shape[1]} (valid {kw0['kv_valid_len']}), plain = the twin",
        lambda: flash_attn.flash_attention(q0, k0, v0, **kw0),
        lambda: ref.flash_attention_ref(q0, k0, v0, operands=bf, **kw0), 10,
        flash_bound(q0, k0, v0, kw0["causal"], kw0["window"],
                    kw0["q_offset"], kw0["kv_valid_len"]))
    f32_ms, f32_wall = times(
        torch, lambda: ref.flash_attention_ref(q0, k0, v0, **kw0), 3)
    log(f"flash_attention float32 plain version: "
        f"{f32_ms if f32_ms is not None else f32_wall:.5f} ms on the device")
    n = q0.shape[1]
    qs = q0.transpose(1, 2).contiguous()
    ks = k0[:, :n].to(bf).transpose(1, 2).contiguous()
    vs = v0[:, :n].to(bf).transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)
    lib, lib_wall = times(torch, sdpa, 10)
    row["library_ms"] = lib if lib is not None else lib_wall
    log(f"flash_attention library (scaled_dot_product_attention, causal, "
        f"GQA, bf16 K/V of the {n} valid keys): {row['library_ms']:.5f} ms "
        f"on the device")
    if kw0["window"] is not None and kw0["window"] < n:
        fail(f"the float64 check assumes the window ({kw0['window']}) spans "
             f"the prompt ({n})")
    # the kernel and SDPA against float64 over the same 2048 valid keys
    # (prefill: q_offset 0, causal), one batch row at a time
    mine, lib_out = got0.transpose(1, 2), sdpa()
    errs = {"kernel": [], "sdpa": []}
    for i in range(b):
        exact64 = torch.nn.functional.scaled_dot_product_attention(
            qs[i:i + 1].double(), ks[i:i + 1].double(),
            vs[i:i + 1].double(), is_causal=True, enable_gqa=True)
        errs["kernel"].append((mine[i:i + 1].double() - exact64).abs()
                              .flatten().float())
        errs["sdpa"].append((lib_out[i:i + 1].double() - exact64).abs()
                            .flatten().float())
    stats = {}
    for name, parts in errs.items():
        e = torch.cat(parts)
        top = torch.topk(e, max(1, e.numel() // 1000)).values
        stats[name] = (float(top[0]), float(top[-1]))
    log(f"|error| against float64 over {mine.numel()} outputs: kernel max "
        f"{stats['kernel'][0]:.4g}, 99.9th percentile "
        f"{stats['kernel'][1]:.4g}; SDPA max {stats['sdpa'][0]:.4g}, 99.9th "
        f"percentile {stats['sdpa'][1]:.4g} (ratio "
        f"{stats['kernel'][1] / stats['sdpa'][1]:.4f})")
    if stats["kernel"][1] > 1.25 * stats["sdpa"][1]:
        fail("the kernel's 99.9th-percentile error against float64 exceeds "
             "1.25x SDPA's")

    # where a prefill's and a decode step's time goes (the decode step at
    # position prompt + n_gen - 1, the last slot of the cache)
    nxt = toks[:, -1:]
    for name, step in (("prefill", lambda: model.prefill(params, tokens,
                                                         cache())),
                       ("decode step", lambda: model.decode(params, nxt,
                                                            cp))):
        wall, kern = profiled(torch, step)
        busy = sum(ms for _, _, ms in kern)
        log(f"profiled {name}: {wall:.2f} ms wall, device busy {busy:.2f} ms "
            f"in {sum(n for _, n, _ in kern)} kernel launches (idle share "
            f"{1 - busy / wall:.3f})")
        log_top(kern, 6)
    return counts, row


# the 13 CompactIndex tensors phase 12 holds bitwise against rebuild()
INDEX_FIELDS = ("codes", "f_add", "neighbors", "entry", "n_valid",
                "node_ids", "centroids", "alpha", "rho", "shift1", "shift2",
                "residual_norm", "cos_theta")
DRIFT_BOUND = 0.01           # benchmarks/churn.py's recall drift bound


def same_index(torch, label, got, want) -> None:
    """Two (CompactIndex, HostStore) pairs equal bit for bit, field by
    field; a failure names every field that differs."""
    (gi, gh), (wi, wh) = got, want
    bad = [f for f in INDEX_FIELDS
           if not torch.equal(getattr(gi, f), getattr(wi, f))]
    if not torch.equal(gh.vectors, wh.vectors):
        bad.append("host vectors")
    if bad:
        fail(f"{label}: snapshot differs from rebuild() in {bad}")
    log(f"{label}: snapshot equals rebuild() bit for bit in all "
        f"{len(INDEX_FIELDS)} CompactIndex fields and the host vectors")


def live_ground_truth(torch, vectors, live, q, k: int = 10,
                      chunk: int = 1 << 18):
    """Exact top-k ids over the rows of ``vectors`` that ``live`` marks
    (synthetic.ground_truth with every other row at inf), on the card."""
    best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                         device=q.device)
    for s in range(0, vectors.shape[0], chunk):
        xc = vectors[s:s + chunk]
        d2 = (xc * xc).sum(-1)[None, :] - 2.0 * (q @ xc.T)
        d2 = d2.masked_fill(~live[s:s + chunk][None, :], float("inf"))
        d_top, i_top = torch.sort(d2, dim=1, stable=True)
        cat_d = torch.cat([best_d, d_top[:, :k]], dim=1)
        cat_i = torch.cat([best_i, i_top[:, :k] + s], dim=1)
        d_sorted, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d, best_i = d_sorted[:, :k], torch.gather(cat_i, 1, pos[:, :k])
    return best_i


def recall_vs(torch, ids, gt) -> float:
    """recall@k of ids (numpy or a tensor) against gt on its device."""
    ids = torch.as_tensor(ids).to(gt.device).long()
    hit = (ids[:, :, None] == gt[:, None, :]).any(-1).sum()
    return float(hit) / gt.numel()


def phase_mutable(torch, parts, icfg, qt):
    """Phase 12: the mutable index at 10M x 128 (module docstring). ``parts``
    holds phase 4's (index, host) and is emptied, so they go once the
    mutable index has its mirrors. Returns a dict of the phase's
    numbers."""
    from repro_torch.core import engine, graph, ivf, topology
    from repro_torch.core.mutable_index import MutableIndex
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    out = {}

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    def gib():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() / 2**30

    def step(name, t0):
        """Seconds since t0 into out[name], and the step's peak allocated
        memory (GiB) beside them."""
        out[name] = now() - t0
        out[name[:-2] + "_peak_gib"] = \
            torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        return out[name]

    index, host = parts
    parts.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = qt.device
    n = host.vectors.shape[0]
    # the churn law (benchmarks/churn.py's update churn, 1% of the corpus):
    # the lowest live ids come back perturbed under new ids from N up
    n_churn = n // 100
    drop = np.arange(n_churn)
    new_ids = np.arange(n, n + n_churn)
    noise = np.random.default_rng(0).standard_normal((n_churn, icfg.dim))
    vecs = host.vectors[:n_churn] + 0.05 * torch.from_numpy(
        noise.astype(np.float32)).to(dev)
    need = torch.bincount(ivf.assign(vecs, index.centroids).long(),
                          minlength=index.n_clusters)
    slab = max(64, -(-int(need.max()) // 32) * 32)
    out["slab"] = slab
    log(f"12: churn of {n_churn} rows (1%); the fullest cluster draws "
        f"{int(need.max())} inserts under frozen-centroid assign, "
        f"{int((need > 0).sum())} clusters draw any: slab {slab} "
        f"(budget {index.budget} -> {index.budget + slab}, "
        f"+{slab / index.budget:.2%})")

    # 1. construction, then the unmutated snapshot against rebuild()
    t = now()
    mut = MutableIndex(index, host, icfg, slab=slab, mem_bytes=2 << 30)
    log(f"12 construct: {step('construct_s', t):.2f} s; {mut!r}"[:200])
    del index, host
    torch.cuda.empty_cache()
    log(f"12: mirrors on the card, {gib():.2f} GiB allocated")
    t = now()
    rebuilt = mut.rebuild()
    log(f"12 rebuild (unmutated): {step('rebuild0_s', t):.2f} s")
    same_index(torch, "12 unmutated", mut.snapshot(), rebuilt)
    del rebuilt
    torch.cuda.empty_cache()

    # 2. serve through the mutable 8-shard tier before any mutation
    scfg = engine.SearchConfig()
    q = qt.cpu().numpy()
    t = now()
    mut_eng = mut.to_engine(scfg, n_shards=8)
    topo = topology.TopologyConfig(shards=8, mutable=True,
                                   buckets=(256, 1024)).build(mut_eng)
    log(f"12: mutable engine and 8-shard tier in {now() - t:.2f} s, "
        f"{gib():.2f} GiB allocated")
    topo.warm()
    topo.run(q)
    ops.reset_launch_counts()
    rep = topo.run(q)
    counts = ops.launch_counts()
    runs = [rep] + [topo.run(q) for _ in range(4)]
    med = {key: float(np.median([getattr(r, key) for r in runs]))
           for key in ("qps", "p50_ms", "p99_ms")}
    out.update(tier_qps=med["qps"], tier_p50=med["p50_ms"],
               tier_p99=med["p99_ms"])
    print("kernels mutable " + json.dumps(counts), flush=True)
    if any(counts[k] == 0 for k in ("beam_search", "topk_select",
                                    "merge_topk")):
        fail(f"12: the mutable tier's run launched {counts}")
    hold_ids("12 mutable tier (unmutated) vs its engine", pair(rep),
             pair(mut_eng.search(qt)[0]))
    log(f"12 mutable tier, unmutated: QPS "
        f"{', '.join(f'{r.qps:.1f}' for r in runs)}; median QPS "
        f"{med['qps']:.1f}, p50 {med['p50_ms']:.2f} ms, p99 "
        f"{med['p99_ms']:.2f} ms")

    # 3. the link on the card: rounds against link_new, one after another
    b0 = 256
    first = torch.as_tensor(new_ids[:b0])
    touched = torch.unique(ivf.assign(vecs[:b0], mut.centroids))
    before = mut.neighbors[touched].clone()
    base = mut.n_valid[touched].clone()
    t = now()
    mut.insert(first, vecs[:b0])
    rounds_s = step("link_rounds_s", t)
    want = before
    t = now()
    for j, c in enumerate(touched.tolist()):
        occ, sl = int(mut.n_valid[c]), mut.slot_gid[c]
        xs = torch.zeros((mut.budget, mut.dim), device=dev)
        xs[sl >= 0] = mut.vectors[sl[sl >= 0].long()]
        graph.link_new(want[j], xs, occ, range(int(base[j]), occ),
                       r=icfg.degree, knn_k=icfg.knn_k,
                       prune_alpha=icfg.prune_alpha)
    plain_s = step("link_new_s", t)
    diff = (mut.neighbors[touched] != want).any(-1)
    if diff.any():
        fail(f"12 link: {int(diff.sum())} rows of {diff.numel()} in "
             f"{len(touched)} clusters differ from link_new")
    log(f"12 link of {b0} inserts into {len(touched)} clusters: rounds "
        f"{rounds_s:.2f} s (with the encode and writes), link_new "
        f"{plain_s:.2f} s; every row of the touched clusters equal bit for "
        f"bit")
    del want, before

    # 4. delete and insert the rest of the 1%, then apply mid-stream
    torch.cuda.empty_cache()
    t = now()
    mut.delete(drop)
    step("delete_s", t)
    t = now()
    mut.insert(new_ids[b0:], vecs[b0:])
    step("insert_s", t)
    fp = mut.footprint()
    log(f"12 delete of {n_churn}: {out['delete_s']:.2f} s; insert of "
        f"{n_churn - b0} ({int(need.max())} rounds at most): "
        f"{out['insert_s']:.2f} s; footprint {json.dumps(fp)}")
    if not fp["reclaimable_bytes"] > 0:
        fail("12: tombstones are not billed as reclaimable")
    mem0 = gib()
    swapped = []

    def ticker(t_stream):
        if not swapped:
            t0 = now()
            topo.apply(mut)
            swapped.append(now() - t0)
    ops.reset_launch_counts()
    rep4 = topo.run(q, ticker=ticker)
    counts4 = ops.launch_counts()
    mem1 = gib()
    out["apply_mid_s"] = swapped[0] if swapped else float("nan")
    log(f"12 apply from the run's ticker: {out['apply_mid_s']:.2f} s; "
        f"allocated {mem0:.3f} -> {mem1:.3f} GiB; launches {counts4}")
    if not swapped or abs(mem1 - mem0) > 1.0:
        fail(f"12: mid-stream apply ran {len(swapped)} times, memory "
             f"{mem0:.3f} -> {mem1:.3f} GiB")
    if any(counts4[k] == 0 for k in ("beam_search", "topk_select",
                                     "merge_topk")):
        fail(f"12: the run with the mid-stream apply launched {counts4}")
    ids4 = rep4.ids
    if np.isin(ids4, drop).any():
        fail(f"12: {int(np.isin(ids4, drop).sum())} deleted ids served "
             f"after apply")
    admitted = ~rep4.shed
    live_of = mut.loc[:, 0].cpu().numpy()
    rows = ids4[admitted]
    if not ((rows >= 0).all() and (live_of[np.maximum(rows, 0)] >= 0).all()):
        fail("12: an admitted row carries fewer than k live ids")
    log(f"12: {int(admitted.sum())} admitted rows, each of "
        f"{rows.shape[1]} live ids; no deleted id served")
    t = now()
    mut_eng.refresh(*mut.snapshot())
    log(f"12 engine refresh {now() - t:.2f} s, {gib():.2f} GiB allocated")

    # 5. recall of the mutated, uncompacted index over the live corpus
    gt = live_ground_truth(torch, mut.vectors, mut.loc[:, 0] >= 0, qt)
    out["recall_mut"] = recall_vs(torch, ids4, gt)
    view64 = copy.copy(mut_eng)
    view64.scfg = dataclasses.replace(scfg, ef=64)
    out["recall_mut64"] = recall_vs(torch, view64.search(qt)[0].ids, gt)
    del view64                   # it holds this state's placed tensors
    log(f"12 recall@10 of the mutated, uncompacted index: tier "
        f"{out['recall_mut']:.4f} at SearchConfig(); "
        f"{out['recall_mut64']:.4f} at ef 64 (a view of its engine)")

    # 6. compact, apply, and the snapshot against rebuild()
    torch.cuda.empty_cache()
    t = now()
    compacted = mut.compact()
    log(f"12 compact of {len(compacted)} dirty clusters: "
        f"{step('compact_s', t):.2f} s")
    mem0 = gib()
    t = now()
    topo.apply(mut)
    out["apply_s"] = now() - t
    mem1 = gib()
    log(f"12 apply after compact: {out['apply_s']:.2f} s; allocated "
        f"{mem0:.3f} -> {mem1:.3f} GiB")
    if abs(mem1 - mem0) > 1.0:
        fail(f"12: apply moved allocated memory {mem0:.3f} -> {mem1:.3f}")
    mut_eng.refresh(*mut.snapshot())
    if mut.footprint()["reclaimable_bytes"] != 0:
        fail("12: compaction left reclaimable bytes billed")
    torch.cuda.empty_cache()
    t = now()
    rebuilt = mut.rebuild()
    log(f"12 rebuild (compacted): {step('rebuild1_s', t):.2f} s")
    same_index(torch, "12 compacted", mut.snapshot(), rebuilt)
    del rebuilt
    torch.cuda.empty_cache()
    rep6 = topo.run(q)
    hold_ids("12 compacted tier vs the refreshed engine", pair(rep6),
             pair(mut_eng.search(qt)[0]))
    out["recall_compact"] = recall_vs(torch, rep6.ids, gt)
    view64 = copy.copy(mut_eng)
    view64.scfg = dataclasses.replace(scfg, ef=64)
    out["recall_compact64"] = recall_vs(torch, view64.search(qt)[0].ids, gt)
    del view64
    drift = abs(out["recall_mut64"] - out["recall_compact64"])
    log(f"12 recall@10 compacted: tier {out['recall_compact']:.4f}; ef 64 "
        f"{out['recall_compact64']:.4f}; drift at ef 64 {drift:.4f} "
        f"(bound {DRIFT_BOUND})")
    if drift > DRIFT_BOUND:
        fail(f"12: recall drift {drift:.4f} at ef 64 exceeds {DRIFT_BOUND}")
    out["peak_gib"] = max([torch.cuda.max_memory_allocated() / 2**30] + [
        v for k, v in out.items() if k.endswith("_peak_gib")])
    del topo, mut_eng, mut
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"12 done in {out['phase_s']:.1f} s; peak device memory "
        f"{out['peak_gib']:.2f} GiB; steps (s) " + json.dumps(
            {k: round(v, 3) for k, v in out.items() if k.endswith("_s")})
        + "; peak allocated by step (GiB) " + json.dumps(
            {k: round(v, 2) for k, v in out.items()
             if k.endswith("_peak_gib")}))
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs on the card only")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not beside this script ({e}); run it from the "
             f"root of a checkout")
    dev = torch.device("cuda", 0)

    card = phase_card(torch)
    phase_build_kernels()
    phase_kernels_synthetic(torch, dev)
    eng, qt, build_s = phase_build_index(torch, dev)
    counts, recall, qps, single = phase_search(torch, eng, qt)
    phase_breakdown(torch, eng, qt,
                    1e3 * qt.shape[0] / sorted(qps)[len(qps) // 2])
    timing = phase_kernels_real(torch, eng, qt)
    scan_call, gemv_counts, gemv_recall, gemv_qps = phase_gemv(
        torch, eng, qt, recall)
    recalls = {"mulfree/beam": recall, "mulfree/gemv": gemv_recall}
    ranked = phase_backends(torch, eng, qt, recalls)
    topo, sharded_counts, rep, med = phase_sharded(torch, eng, qt, single,
                                                   recall)
    phase_mixed_tier(torch, topo, qt)
    timing.update(phase_new_kernels_real(torch, topo, rep, scan_call, qt))
    del topo, scan_call
    mesh = phase_mesh(torch, eng, qt, rep, med)
    phase_skewed_tier(torch, eng)
    lm_counts, timing["flash_attention"] = phase_lm(torch, dev, eng)
    parts, icfg = [eng.index, eng.host], eng.icfg
    del eng
    mutable = phase_mutable(torch, parts, icfg, qt)

    src = {"binary_ip_rank": ("src/repro_torch/kernels/csrc/binary_ip.cu",
                              "src/repro/kernels/binary_ip.py:79"),
           "topk_select": ("src/repro_torch/kernels/csrc/topk_select.cu",
                           "src/repro/kernels/topk_select.py:181"),
           "merge_topk": ("src/repro_torch/kernels/csrc/merge_topk.cu",
                          "src/repro/kernels/topk_select.py:236"),
           "cluster_scan": ("src/repro_torch/kernels/csrc/cluster_scan.cu",
                            "src/repro/kernels/binary_ip.py:162"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                               "src/repro/kernels/flash_attn.py:75"),
           "beam_search": ("src/repro_torch/kernels/csrc/beam_search.cu",
                           "src/repro/kernels/binary_ip.py:79, fused with "
                           "src/repro/core/beam_search.py:46")}
    # launches: each kernel's count in the run of its own path (phase 5 the
    # beam search, 8 the gemv search, 9 the sharded tier, 11 the LM path);
    # binary_ip_rank's is 0: the beam path ranks inside beam_search
    launches = {"binary_ip_rank": counts["binary_ip_rank"],
                "beam_search": counts["beam_search"],
                "topk_select": counts["topk_select"],
                "cluster_scan": gemv_counts["cluster_scan"],
                "merge_topk": sharded_counts["merge_topk"],
                "flash_attention": lm_counts["flash_attention"]}
    kernels = [dict(name=name, route="cuda", source=src[name][0],
                    replaces=src[name][1], launches=launches[name],
                    max_abs_err=ERRS[name], ms=timing[name]["ms"],
                    plain_ms=timing[name]["plain_ms"],
                    bound_ms=timing[name]["bound_ms"],
                    bound_by=timing[name]["bound_by"],
                    library_ms=timing[name].get("library_ms"))
               for name in src]
    # each rank policy of beam_search and cluster_scan (phase 8b): its own
    # launches, times and errors, on the search of its own backend
    for name, row in ranked.items():
        kernel = name.split("/")[0]
        kernels.append(dict(
            name=name, route="cuda", source=src[kernel][0],
            replaces=src[kernel][1], launches=row["launches"],
            max_abs_err=ERRS[name], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    log(f"recall@10 by backend: {json.dumps(recalls)}")
    log(f"card {card}; n={N}; build {build_s:.1f} s; recall@10 "
        f"{recall:.4f} beam, {gemv_recall:.4f} gemv, sharded equal to beam; "
        f"QPS {qps[0]:.1f} beam, {gemv_qps[0]:.1f} gemv, {med['qps']:.1f} "
        f"sharded (median of 5), {mesh['med']['qps']:.1f} on the "
        f"{MESH_RANKS}-rank mesh (median of 5); mutable tier QPS "
        f"{mutable['tier_qps']:.1f}, "
        f"recall drift at ef 64 "
        f"{abs(mutable['recall_mut64'] - mutable['recall_compact64']):.4f}; "
        f"no single PyTorch call computes binary_ip_rank, "
        f"topk_select (a dedup first), cluster_scan (a rank and a "
        f"selection) or beam_search (a graph search), so their library_ms "
        f"is null")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
