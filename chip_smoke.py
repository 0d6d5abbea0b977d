#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the PIMCQG query path on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch / CUDA versions and
     the TF32 flags, which are switched off;
  2. build every kernel from src/repro_torch/kernels/csrc/ (one nvcc per
     source, all started together) into build/kernels/, log ptxas's
     registers, shared memory and spills of each kernel (the eight head-dim
     256 instantiations of the attention kernel and the 24 of the split-KV
     decode kernel, flash_decode.cu, must not spill) and the
     dynamic
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
     timed beside scaled_dot_product_attention; the smoke configs' head
     dims 8, 12 and 16 and the deepseek smoke's MLA pair (dk 40, dv 32),
     zero-padded in the kernel (ROADMAP C6), and the latent-attention
     instantiation (dk 576, dv 512, g 16) with v a view of k's rows or a
     tensor of its own, held the same way; head dim 256 (recurrentgemma's
     local attention) over GQA groups 16, 4 and 1, ragged Sq and Sk,
     q_offset, kv_valid_len < Sk, windows that bite, bf16 q over bf16 and
     float32 K/V and float32 q, and the padded heads (200, 176) and 192 in
     the 256 instantiation; the tensor-core kernel (bf16 q) without the
     causal mask, as whisper calls it: GQA groups 1 and 7, Sq != Sk over
     1,500 keys (ragged tiles), Sq = 1 over float32 K/V, kv_valid_len < Sk
     and the smoke head dims 16 and 8; and with ``return_lse`` (the
     training path's call) on every case but the non-causal ones, the
     output the bits of the call without it and the rows' logsumexp within
     ``ref.flash_attention_lse_bound`` of the twin's (bf16 q) or of the
     float32 plain version's (float32 q), on every route (the CUDA-core
     kernel, the tensor-core kernel, the wide kernel at hd 256, the
     split-dv kernel at (576, 512), the zero-padded head dims);
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
     13b. the paper's search step on a (2 data x 4 model) mesh
     (launch.anns_step, after phase 13's ranks are down): phase 4's index
     placed round-robin over 4 model shards (1,024 clusters each), 8 gloo
     ranks sharing the card (7 spawned); the origin's one-process
     build_search_step first, on the same round-robin index; then every
     rank takes its model block of the index and its data block of the
     vectors (elastic.place, one leaf at a time), 1024 queries, nprobe 8,
     EF 40, k 10, beam then gemv, mulfree, owner-computes rerank: one
     warm-up and five runs, the first counted on every rank, each held
     bitwise (ids, distances, hops, dropped lanes) against the
     one-process step; QPS (median of 5) beside phases 5 and 13, recall@10,
     the collectives a step by kind and bytes, one more run timed by stage
     on rank 0, launches, allocated and
     peak memory by rank beside the reckoning; rank 0's beam_search,
     cluster_scan and topk_select calls held bitwise against their plain
     versions; the SIFT1B footprint a rank on both production meshes
     (computed, --account);
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
 14. serve deepseek-v2-lite-16b at full width and depth (27 x 2048, MLA
     kv_lora 512 + rope 64, 64 routed experts top-6 + 2 shared, the first
     layer dense, vocab 102,400, seeded bf16 weights; after phase 11,
     whose weights are released) through repro_torch.launch.serve.generate:
     8 requests of 2048 prompt tokens, 32 generated, a bf16 latent cache,
     the first decode step's queries through a StreamingScheduler over the
     10M engine; 27 flash_attention launches in the counted prefill (the
     MLA instantiation, dk 576 / dv 512), the ids held against
     engine.search; the last decode step held against the same step with
     its attention through the kernel and its routing forced to decode's
     (5% of the largest |logit|, the same greedy token); the served prefill
     of the same tokens against decode, its dropped copies and the flipped
     top-6 choices logged; the kernel on layer 0's real q_all / latent
     cache / its view held as in phase 3 and timed beside its bound, its
     twin, the float32 plain version and scaled_dot_product_attention (the
     first backend that takes dk != dv); a profiled prefill and decode
     step.
 15. serve mamba2-1.3b at full width and depth (48 SSD blocks of d_inner
     4,096, 64 heads of 64, state 128, chunk 256, vocab 50,280, seeded bf16
     weights; after phase 14, whose weights are released) through
     repro_torch.launch.serve.generate: 8 requests of 2,000 prompt tokens
     (not a multiple of the chunk: the last chunk is padded), 32
     generated, a float32 cache, retrieval as in phase 11 (ids held against
     engine.search); no flash_attention launch; the last decode step (the
     recurrence) held against a prefill of the same 2,031 tokens into an
     empty cache (the chunked form) by phase 11's rule, and that prefill's
     pos held to the padded 2,048 (ROADMAP C7); the SSD stages' device
     times (conv, intra-chunk, chunk states, the inter-chunk loop) on one
     layer's real inputs, a profiled prefill and decode step.
 16. serve recurrentgemma-9b at full width and depth (38 layers: 12 groups
     of (rglru, rglru, lattn) + 2 rglru; d 4,096, 16 heads over 1 KV head
     of 256, window 2,048, RNN width 4,096, GeGLU d_ff 12,288, vocab
     256,000, logit softcap 30, seeded bf16 weights) the same way: 8
     requests of 3,072 prompt tokens (past the window), 32 generated, a
     bf16 rolling cache of 2,048 slots; 12 flash_attention launches in the
     counted prefill, all in the hd-256 instantiation; ids held against
     engine.search; the last decode step (the rolling cache through the
     plain one-pass attention, the RG-LRU recurrence) against a prefill of
     the 3,103 tokens (the kernel with its window, the log-depth scan) by
     phase 11's rule; the kernel on layer 2's real q / k / v held as in
     phase 3 and timed beside its bound, its twin, the float32 plain
     version and scaled_dot_product_attention (the window as a boolean
     mask, GQA, the first backend that takes it); the RG-LRU stages' device
     times (conv, gates, the scan), a profiled prefill and decode step.
 17. serve whisper-large-v3 at full width and depth (32 encoder + 32
     decoder layers, d 1,280, 20 heads of 64, d_ff 5,120, vocab 51,866,
     seeded bf16 weights) the same way: 8 requests of 416 prompt tokens +
     32 generated (Whisper's 448-token decoder context), 1,500 stub frames
     a request (30 s of audio) drawn from a seed, a float32 cache; exactly
     96 flash_attention launches a prefill (32 encoder, 32 decoder self, 32
     cross) and 32 a decode step (cross only), 1,088 in the counted run,
     all but the decoder prefill's 32 non-causal; ids held against
     engine.search; the last decode step held against a prefill of the
     same tokens and frames by phase 11's rule; the prefill split by CUDA
     events into the encoder, the cross K/V projection and the decoder;
     layer 0's encoder call and its cross calls (prefill and decode) on
     their real inputs held as in phase 3 and timed beside their bounds,
     the twin, the float32 plain version and SDPA's flash backend; a
     profiled prefill and decode step.
 18. serve internvl2-1b at full width and depth (24 layers, d 896, 14 / 2
     heads of 64, vocab 151,655, seeded bf16 weights) the same way: 256
     stub patches + 1,792 prompt tokens = 2,048, 32 generated, a float32
     cache; 24 launches a prefill, none a decode step; ids, decode vs
     prefill (patches and tokens), the prefill's pos, layer 0's call (g 7)
     held and timed as in 17, a profiled prefill and decode step.
     11s. the sharded LM (after phase 18, while phase 4's engine lives):
     h2o-danube-1.8b at full width and depth on a (1 data x 4 model)
     mesh of gloo ranks sharing the card
     (this process and 3 spawned), tensor parallelism over 'model' (each
     rank 8 / 2 heads, d_ff 1,728, 8,000 vocab rows, drawn whole from seed
     0 on the card as one process draws them, and cut to its blocks); 4
     requests of 512 prompt tokens, 8 generated, a float32 cache, through
     launch.serve.generate under sharding.use_mesh with retrieval (every
     rank encodes its logits block by a vocabulary-parallel softmax, this
     process serves the queries from the engine and broadcasts the report;
     the ids held against engine.search of the queries), counted (24
     flash_attention launches on every rank, the collectives by kind and
     bytes against sharded_reckoning), then a prefill and 7 decode steps
     teacher-forced with a one-process run's tokens: each step's logits
     within 5% of the largest |logit| of the one-process run's (phase 11's
     bound), the greedy token reaching the one-process row's maximum
     within it, the same tokens on every rank, each window's collectives
     equal to the reckoning; then the sequence-split run: the cache split
     on the sequence over 'model' (init_cache(..., seq_split=True), 520
     slots, 130 a rank, float32), a prefill and 2 decode steps
     teacher-forced, each layer's decode attention the split-KV decode
     kernel over the rank's slots (24 launches a step on every rank),
     each step's logits within the same 5% of the one-process run's, each
     window's collectives and its seconds logged; rank 0's layer-0 call
     held and timed as in phase 17, and its first sequence-split decode
     call (float32 q and K/V) held against the float32 plain version and
     timed beside its bound and SDPA: the kernels line's
     flash_attention/decode row; prefill and decode ms, weights and peak
     memory by rank.
 19. train h2o-danube-1.8b at full width through launch.train.run (24
     layers, d 2,560, vocab 32,000, accum_steps 2, remat on, bf16 params,
     float32 AdamW moments, seeded weights): 16 steps of 8 x 2,048
     synthetic tokens (data.synthetic.token_batch; the loss rises above the
     first over steps 2-4, and 4 steps ended above it: 19w is the
     witness), each step's loss, ms, tokens/s
     and flash_attention launches (96: a forward and a recompute a layer
     each micro-batch) logged with the peak device memory; every loss
     finite and the last below the first; on layer 0's real q / k / v the
     kernel's lse against its twin's and the float32 plain version's
     (``ref.flash_attention_lse_bound``), its output with lse the bits of
     its output without and held as in phase 11, the plain backward's (dq,
     dk, dv) on layer 0's recorded backward inputs against autograd
     through the float32 one-pass attention
     (``ref.flash_attention_bwd_bound``), and the forward with and without
     lse, the backward and SDPA's forward and forward + backward timed;
     the last step run again under the profiler (its busy and idle
     share, the kernels with the most device time);
     19w. the witness of that rise, at danube's full width: the float32
     gradients of one 128-token sequence through its first 8 layers (the
     depth cut to 8 of 24 for phase 11s) on the card against the CPU's
     (loss within 1e-4 relative, each leaf within 1e-3 of its largest
     |grad|; global norms and the bf16 params' gradients logged),
     and phase 19's first 4 steps at lr_peak 3e-5 (losses logged, the
     last held below the first);
     19b. checkpoint and resume at phi3's 100m preset (8 x 256 tokens a
     step): 6 steps with a checkpoint every 3, --resume to 9 runs exactly 3
     more; an uninterrupted 9-step run, a copy without step 9 resumed (its
     last 3 losses held bitwise against the run's), a copy torn further (a
     stray .tmp_ directory, a corrupted leaf in step 6) that must skip
     step 6 and resume from step 3 (its last 6 losses held bitwise);
     19c. the DP trainer (distributed.trainer.make_dp_train_step, int8
     compressed gradients, error feedback) with 2 ranks sharing the card
     over gloo at the same preset: params bitwise equal on both ranks
     after a step, within 5e-2 of make_train_step on the whole batch; the
     same step with float32 params, its first moments bitwise equal on
     both ranks and within an int8 step's bound (``mu_bound``) of
     make_train_step's; the step's and the gradient reduction's ms
     logged;
     19d. the same DP step on a (2 pod x 2 data) mesh of 4 gloo ranks
     sharing the card: a plain mean over 'pod', then the compressed mean
     over 'data' (the reference's order, ROADMAP C9); held as 19c is, the
     first moments within ``mu_bound`` over the 2 shards of 'data'; the
     step's and the two-stage reduction's ms (compressed and plain)
     logged.
     19s. the sharded train step (last): h2o-danube-1.8b's full config
     (as 19) through launch.train.run(..., mesh=) on a (2 data x 2
     model) mesh of gloo ranks sharing the card (this process and 3
     spawned; each rank draws the whole tree from seed 0 and keeps its
     blocks: 16 / 4 heads, d_ff 3,456, 16,000 vocab rows), 1 step of 4 x
     512 token_batch tokens (accum 2: a rank 1 row a micro-batch); first
     the reckoning by rank (weights, moments, gradient sum, micro-batch
     gradients) and the same step in one process (the witness); held:
     loss and grad_norm equal on every rank bit for bit, each step's loss
     within 4 u (bf16's unit roundoff) of the witness's relatively, the
     first moments after step 1 rank by rank within ``bf16_mu_bound`` of
     the witness's blocks, 96 flash_attention launches a rank a step, each
     rank's collectives a step by kind and bytes equal to
     ``sharded_train_reckoning``; step ms and peak memory by rank; rank
     0's layer-0 call (B 1, S 512, 16 / 4 heads of 80, with lse) held and
     timed beside its bound and SDPA.
     21a. (right after 19, on its params and optimizer state) the dry-run's
     accounting (launch.op_stats on meta tensors, a one-rank
     AccountingMesh) of phase 11's prefill and 19's step against the card:
     argument bytes against torch.cuda.memory_allocated of a copy (exact,
     in 512-byte blocks), matmul FLOPs against torch.profiler's with_flops
     (within 1%); the roofline step time, the measured step time and MFU
     printed. 21b. (after 19s) 11s's windows on a (1 x 4) and 19s's step
     on a (2 x 2) AccountingMesh, every coordinate, equal to the card's
     collectives by kind, calls and bytes.
 20. the attention softcap (cap 50) on each kernel template at its path's
     full width (danube's layer 0 causal and in float32 q, whisper's
     encoder shape non-causal, MLA (576, 512), hd 256 with a window; q
     scaled by 6): attend(softcap=) with the counts set to 0 just before
     each route's call and read just after (one launch a route), each
     held against its capped twin / plain version and lse bound, the
     uncapped kernel outside that bound, timed by CUDA events beside its
     bound (no library call caps the scores); the sequence-split decode
     step's kernel calls (float32 q, one row a request over a danube
     decode_32k rank's 2,048 bf16 slots: a rolling cache's 1,500, a
     window past the slots, every slot; and B 1 over 32,768 slots) on
     the split-KV decode kernel, held against the float32 plain version
     with their lse, and at the full rank shape and at B 1 timed on the
     device beside the plain version, the bound and SDPA on float32 K/V;
     the capped backward on the card against the CPU's.
Each phase logs "<tag> done in X s (T s since start)" when it ends; before
the result lines one line "phase seconds {...}" holds every phase's
seconds. The second-to-last line is the kernels JSON; the last line is
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
# The card's rates (H100 SXM5 datasheet, Hopper whitepaper) are
# repro_torch.launch.mesh's PEAK_FLOPS_BF16, HBM_BW, PEAK_FP32_OPS and
# PEAK_INT32_OPS, which every bound reads through repro_torch.kernels.cost.
INT_MAX = 2**31 - 1
MIXED = ("mulfree", "exact", "hamming")   # phase 9b's backends, by shard
MESH_RANKS = 8               # phase 13: one process a shard, phase 9's 8
MESH_TIMEOUT_S = 300.0       # a mesh collective that waits longer fails
ANNS_MESH = (2, 4)           # phase 13b: ('data', 'model') ranks
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


PHASE_S: dict = {}  # seconds of each phase, in the order they ran


def phase(tag: str, fn, *args, **kw):
    """fn(*args, **kw) as phase ``tag``: its seconds kept in PHASE_S and
    logged when it ends, with the seconds since the start, so a run cut
    short shows how far it got."""
    t = time.perf_counter()
    out = fn(*args, **kw)
    now = time.perf_counter()
    PHASE_S[tag] = round(now - t, 2)
    log(f"{tag} done in {now - t:.1f} s ({now - T0:.1f} s since start)")
    return out


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


def event_ms(torch, fn, iters: int = 1, warm: int = 1,
             lead: bool = False) -> float:
    """ms a call of fn() by CUDA events around ``iters`` calls launched
    back to back, after ``warm`` warm-up calls. With ``lead`` the calls
    queue behind a spin kernel (``torch.cuda._sleep``, ~0.1 s at the
    H100's clocks) that outlasts their launch on the host, so the events
    span the device's work alone, the gaps between its kernels included.
    A plain version is no yardstick of speed: one warm-up and one call,
    the defaults, are its time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if lead:
        torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def timed_row(torch, name, kernel, plain, iters, bound):
    """Time a kernel (device ms as the result, the event wall ms beside
    it) and its plain version (``event_ms``) and log them with the
    bound."""
    ms, wall = times(torch, kernel, iters)
    plain_ms = event_ms(torch, plain)
    if ms is None:
        log(f"{name}: device time not measured (no profiler session kept "
            f"every launch); CUDA-event wall ms stand in")
        ms = wall
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
               bound_by=bound[1])
    log(f"{name}: kernel {ms:.5f} ms on the device ({wall:.5f} ms event "
        f"wall per back-to-back call), plain {plain_ms:.5f} ms (one call, "
        f"CUDA events), bound {bound[0]:.5f} ms ({bound[1]})")
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


def hold_bf16_attention(torch, label, got, q, k, v, kw,
                        kernel="flash_attention"):
    """The tensor-core kernel's output ``got`` (bf16 q) held twice: against
    its twin within ``attn_bound`` plus ``ref.flash_attention_flip_bound``
    (a weight that the kernel's ex2 and torch.exp2, or S summed in another
    order, round to other bf16 neighbours moves its row by up to 2^-7 of
    the row's largest p_j |v_j| / l; the elements that needed the term are
    counted), and against the float32 plain version within
    ``ref.flash_attention_rounding_bound``, as the twin itself is. The
    error against the twin is recorded under ``kernel``. Returns (the
    float32 plain version, that bound)."""
    from repro_torch.kernels import ref
    twin = ref.flash_attention_ref(q, k, v, operands=torch.bfloat16, **kw)
    base = attn_bound(torch, twin)
    flip = ref.flash_attention_flip_bound(q, k, v, **kw)
    needed = int(((got.double() - twin.double()).abs() > base).sum())
    close(torch, kernel, f"{label} vs twin", got, twin, base + flip)
    log(f"{kernel} {label}: {needed} of {got.numel()} elements "
        f"needed the bf16 flip term")
    plain = ref.flash_attention_ref(q, k, v, **kw)
    bound = ref.flash_attention_rounding_bound(q, k, v, **kw)
    close(torch, kernel, f"{label} vs float32 plain", got, plain,
          bound, record=False)
    close(torch, kernel, f"{label} twin vs float32 plain", twin,
          plain, bound, record=False)
    return plain, bound


def hold_lse(torch, name, label, got, q, k, v, kw) -> None:
    """The kernel asked for the rows' logsumexp (the training path's call)
    on the inputs of a call that gave ``got``: its output must be the bits
    of ``got``, its lse within ``ref.flash_attention_lse_bound`` of its
    twin's (bf16 q) or of the float32 plain version's (float32 q), and the
    twin's within it of the float32 plain version's."""
    from repro_torch.kernels import flash_attn, ref
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    if not torch.equal(out, got):
        fail(f"{name} {label}: the output with lse differs from without")
    bf = torch.bfloat16 if q.dtype == torch.bfloat16 else None
    _, twin = ref.flash_attention_ref(q, k, v, operands=bf, return_lse=True,
                                      **kw)
    bound = ref.flash_attention_lse_bound(q, k, twin, **kw)
    close(torch, name, f"{label} lse", lse, twin, bound, record=False)
    if bf is not None:
        _, plain = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        close(torch, name, f"{label} twin lse vs float32 plain", twin, plain,
              bound, record=False)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def rank_bound(torch, rows, lut, w, dim):
    """``cost.binary_ip_rank`` of these rows: the distinct real rows, the
    lanes with a real row and the real (lane, row) slots counted from
    them."""
    from repro_torch.kernels import cost
    real = rows >= 0
    return cost.binary_ip_rank(
        slots=rows.numel(), real_slots=int(real.sum()),
        distinct_rows=int(torch.unique(rows[real]).numel()),
        live_lanes=int(real.any(-1).sum()), w=w, dim=dim,
        lut_width=lut.shape[1]).bound()


def scan_bound(torch, args, dim, ef):
    """``cost.cluster_scan`` of the ranked arguments (codes, rank,
    base_rows, n_valid, active): the distinct probed clusters' valid rows
    and every live lane's valid rows counted from them. Returns (ms,
    "bytes" or "operations", ms by the bit count): the last prices a mask
    and an add per code bit, 2 dim operations a row, as the bound of a
    kernel that ranks bit by bit."""
    from repro_torch.kernels import cost
    codes, rank, base_rows, n_valid, active = args
    w = codes.shape[1]
    nv = n_valid[active].long()
    clusters = torch.unique(torch.stack([base_rows[active].long(), nv], 1),
                            dim=0)
    work = cost.cluster_scan(kind=rank.kind, w=w, ef=ef,
                             n_lanes=active.numel(),
                             live_lanes=int(active.sum()),
                             cluster_rows=int(clusters[:, 1].sum()),
                             scanned_rows=int(nv.sum()))
    old = cost.Work({"int32": 2 * int(nv.sum()) * dim}, work.bytes)
    return (*work.bound(), old.bound_ms())


def merge_bound(q, w, k):
    from repro_torch.kernels import cost
    return cost.merge_topk(q, w, k).bound()


def topk_bound(q, c, k):
    """``cost.topk_select``'s bound, and the first design's count
    (``cost.topk_select_sorts``) logged beside it only."""
    from repro_torch.kernels import cost
    return (*cost.topk_select(q, c, k).bound(),
            cost.topk_select_sorts(q, c, k).bound_ms())


def flash_bound(q, k, v, causal, window, q_offset, kv_valid_len,
                softcap=0.0):
    """``cost.flash_attention`` at these tensors' shapes and types (v a
    view of k's rows counts once)."""
    from repro_torch.kernels import cost
    b, sq, hq, dk = q.shape
    alias = v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
    return cost.flash_attention(
        b=b, sq=sq, sk=k.shape[1], hq=hq, hkv=k.shape[2], dk=dk,
        dv=v.shape[-1], q_bytes=q.element_size(),
        kv_bytes=k.element_size(), causal=causal, window=window,
        q_offset=q_offset, kv_valid_len=kv_valid_len, alias=alias,
        softcap=softcap).bound()


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
    hold_hd256_spills(reports.get("flash_attn", ""))
    hold_decode_spills(reports.get("flash_decode", ""))
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


def hold_hd256_spills(report: str) -> None:
    """The head-dim-256 instantiations in ptxas's report of the flash
    library (the wide kernel for bf16 q, the CUDA-core kernel for float32
    q, each over bf16 and float32 K/V, each without and with the softcap):
    logged, and none may spill (a spill would put O's registers through
    local memory). The split-dv kernel's four (MLA's (576, 512)) are
    logged beside them."""
    fn, seen = None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill" in line:
            if "flash_mla_kernel" in fn:
                kv = "float32" if "flash_mla_kernelIf" in fn else "bf16"
                log(f"  ptxas flash_attention/mla (split-dv, {kv} K/V): "
                    f"{line.strip()}")
                continue
            if "flash_wide_kernel" in fn:
                kind = "wide"
                kv = "float32" if "flash_wide_kernelIf" in fn else "bf16"
            elif "Li256ELi256E" in fn:
                kind = "CUDA-core"
                kv = "float32" if "kernelIffLi" in fn else "bf16"
            else:
                continue
            log(f"  ptxas flash_attention/hd256 ({kind}, {kv} K/V): "
                f"{line.strip()}")
            seen += 1
            if " 0 bytes spill stores, 0 bytes spill loads" not in \
                    f" {line.strip()}":
                fail(f"the hd-256 instantiation {fn} spills: {line.strip()}")
    if report and seen != 8:
        fail(f"ptxas reported {seen} head-dim-256 instantiations, expected 8")


def hold_decode_spills(report: str) -> None:
    """ptxas's report of the split-KV decode library: each instantiation
    of ``flash_decode_kernel`` (bf16 and float32 K/V, head dims 64 to 256,
    without and with the softcap: 24) and the combine kernel logged with
    its registers, static shared memory and spills; none may spill. The
    dynamic shared memory a block takes (the query rows and each warp's
    ring) is set at the launch and not in the report."""
    import re
    fn, seen = None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "registers" in line:
            if "flash_decode_kernel" in fn:
                kv = "float32" if "flash_decode_kernelIf" in fn else "bf16"
                d = re.search(r"Li(\d+)ELb", fn)
                cap = "capped" if "Lb1E" in fn else "uncapped"
                what = f"flash_decode_kernel<{kv} K/V, {d and d.group(1)}, " \
                       f"{cap}>"
                seen += 1
            elif "flash_decode_combine" in fn:
                what = "flash_decode_combine"
            else:
                continue
            log(f"  ptxas flash_attention/decode {what}: "
                f"{line.split(': ', 1)[-1].strip()}; {spill}")
            if "0 bytes spill stores, 0 bytes spill loads" not in spill:
                fail(f"the decode instantiation {fn} spills: {spill}")
            fn = None
    if report and seen != 24:
        fail(f"ptxas reported {seen} flash_decode_kernel instantiations, "
             f"expected 24")


def log_staged(q, k, v, kw, ms, label) -> None:
    """The K/V bytes the split-dv or wide kernel stages from L2 on these
    inputs (``kernels/cost.py`` ``flash_staged_bytes`` at the kernel's
    query rows a block and cluster sharing, ``flash_attn.split_design``)
    and their rate at the kernel's ms, logged; beside them the bytes the
    redesign's parent staged (64-row blocks, no sharing)."""
    from repro_torch.kernels import cost, flash_attn
    b, sq, hq, dk = q.shape
    rows, share = flash_attn.split_design(q, k, v)
    alias = v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
    kw_bytes = dict(
        b=b, sq=sq, sk=k.shape[1], hq=hq, hkv=k.shape[2], dk=dk,
        dv=v.shape[-1], kv_bytes=k.element_size(), causal=kw["causal"],
        window=kw.get("window"), q_offset=kw.get("q_offset", 0),
        kv_valid_len=kw.get("kv_valid_len"), alias=alias)
    staged = cost.flash_staged_bytes(rows=rows, share=share, **kw_bytes)
    before = cost.flash_staged_bytes(rows=64, share=1, **kw_bytes)
    log(f"{label}: stages {staged / 1e9:.4f} GB of K/V from L2 ({rows}-row "
        f"blocks, {share} a tile), {staged / ms / 1e9:.4f} TB/s at "
        f"{ms:.5f} ms (64-row blocks alone: {before / 1e9:.4f} GB)")


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


def beam_bound(args, ef, dim, reads):
    """``cost.beam_search`` of the ranked arguments (codes, rank, nbrs,
    base_rows, entry, active) with this run's ``reads``
    (``plain_beam_counted``). Returns (ms, "bytes" or "operations", ms by
    the bit count, ms by the kernel's nibble tables): the last two price
    2 dim and 4 W operations an O3 slot against the same bytes, and are
    logged beside the bound only."""
    from repro_torch.kernels import cost
    codes, rank, nbrs, entry = args[0], args[1], args[2], args[4]
    work = cost.beam_search(kind=rank.kind, w=codes.shape[1],
                            r=nbrs.shape[1], ef=ef, n_lanes=entry.numel(),
                            entries=int((entry >= 0).sum()),
                            expanded=reads.expanded, rows=reads.rows,
                            slots=reads.slots)

    def by(ops):
        return cost.Work({"int32": ops}, work.bytes).bound_ms()
    return (*work.bound(), by(2 * reads.slots * dim),
            by(4 * reads.slots * codes.shape[1]))


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
        # head dim 256 (recurrentgemma-9b's local attention, the wide
        # kernel for bf16 q): GQA groups 16, 4 and 1, ragged Sq / Sk,
        # q_offset, kv_valid_len < Sk, windows that bite, bf16 q over bf16
        # and float32 K/V; the float32 route
        (2, 300, 330, 16, 1, 256, True, 100, 20, 325, bf, bf),
        (1, 257, 400, 16, 1, 256, True, 64, 130, 390, bf, f32),
        (2, 150, 200, 16, 4, 256, True, None, 40, 195, bf, f32),
        (1, 129, 129, 4, 4, 256, True, 48, 0, None, bf, bf),
        (2, 100, 230, 16, 1, 256, True, 70, 120, 225, f32, f32),
        (1, 77, 200, 8, 2, 256, False, 90, 100, 190, f32, bf),
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
        name = flash_name(flash_attn, d, d)
        if qt == bf:
            hold_bf16_attention(torch, label, got, q, k, v, kw, name)
        else:
            want = ref.flash_attention_ref(q, k, v, **kw)
            close(torch, name, label, got, want, attn_bound(torch, want))
        hold_lse(torch, name, label, got, q, k, v, kw)
    # the smoke configs' head dims (ROADMAP C6: zero-padded into the 64
    # instantiation), heads in (160, 256) zero-padded into 256, and the MLA
    # pairs, dk != dv, v a view of k's rows (the latent cache) or a tensor
    # of its own; causal throughout
    cases = [  # b, sq, sk, hq, hkv, dk, dv, q_off, valid, qt, kvt, alias
        (2, 70, 150, 4, 2, 8, 8, 60, 140, bf, f32, False),
        (2, 70, 150, 4, 2, 12, 12, 60, 140, f32, f32, False),
        (2, 70, 150, 4, 2, 16, 16, 60, 140, bf, bf, False),
        (2, 70, 150, 4, 1, 40, 32, 60, 140, bf, f32, True),
        (2, 150, 220, 16, 1, 200, 176, 60, 210, bf, f32, False),
        (1, 90, 200, 4, 2, 192, 192, 100, None, f32, bf, False),
        (2, 300, 300, 16, 1, 576, 512, 0, None, bf, bf, True),
        (1, 100, 700, 16, 1, 576, 512, 590, 690, bf, bf, True),
        (1, 100, 300, 16, 1, 576, 512, 150, None, bf, f32, False),
    ]
    for b, sq, sk, hq, hkv, dk, dv, q_off, valid, qt, kvt, alias in cases:
        g = torch.Generator(device=dev).manual_seed(dk * 1000 + sk)
        q = torch.randn((b, sq, hq, dk), generator=g, device=dev).to(qt)
        k = torch.randn((b, sk, hkv, dk), generator=g, device=dev).to(kvt)
        v = k[..., :dv] if alias else torch.randn(
            (b, sk, hkv, dv), generator=g, device=dev).to(kvt)
        kw = dict(causal=True, window=None, q_offset=q_off,
                  kv_valid_len=valid)
        name = flash_name(flash_attn, dk, dv)
        label = (f"B={b} Sq={sq} Sk={sk} g={hq // hkv} dk={dk} dv={dv} "
                 f"q_offset={q_off} kv_valid_len={valid} v "
                 f"{'a view of k' if alias else 'its own'} "
                 f"{str(qt)[6:]}/{str(kvt)[6:]}")
        got = flash_attn.flash_attention(q, k, v, **kw)
        if qt == bf:
            hold_bf16_attention(torch, label, got, q, k, v, kw, name)
        else:
            want = ref.flash_attention_ref(q, k, v, **kw)
            close(torch, name, label, got, want, attn_bound(torch, want))
        hold_lse(torch, name, label, got, q, k, v, kw)
    # the tensor-core kernel (bf16 q) without the causal mask, as whisper's
    # encoder and cross-attention call it: GQA groups 1 (MHA) and 7
    # (internvl2's, a head set of one), Sq != Sk with ragged tiles (1,500
    # keys: 23 tiles and 28), Sq = 1 over float32 K/V (a decode step's
    # cross-attention), kv_valid_len < Sk, and the smoke head dims 16 and 8
    # zero-padded into 64
    cases = [  # b, sq, sk, hq, hkv, d, valid, kvt
        (2, 300, 1500, 20, 20, 64, None, bf),
        (2, 1500, 1500, 20, 20, 64, None, bf),
        (2, 300, 1500, 14, 2, 64, None, f32),
        (8, 1, 1500, 20, 20, 64, None, f32),
        (3, 1, 200, 14, 2, 64, 150, f32),
        (1, 129, 1500, 14, 2, 64, 1400, bf),
        (2, 70, 150, 4, 4, 16, None, f32),
        (2, 9, 12, 7, 1, 8, None, bf),
    ]
    for b, sq, sk, hq, hkv, d, valid, kvt in cases:
        g = torch.Generator(device=dev).manual_seed(7 * sq + sk)
        q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(bf)
        k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(kvt)
        v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(kvt)
        kw = dict(causal=False, window=None, q_offset=0, kv_valid_len=valid)
        label = (f"B={b} Sq={sq} Sk={sk} g={hq // hkv} hd={d} causal=False "
                 f"kv_valid_len={valid} bfloat16/{str(kvt)[6:]}")
        got = flash_attn.flash_attention(q, k, v, **kw)
        hold_bf16_attention(torch, label, got, q, k, v, kw,
                            "flash_attention/noncausal")
    time_hd160(torch, dev)


def flash_name(flash_attn, dk, dv) -> str:
    """The kernels line's name of the instantiation that runs (dk, dv)."""
    inst = flash_attn.instantiation(dk, dv)
    return {flash_attn.MLA_DIMS: "flash_attention/mla",
            (256, 256): "flash_attention/hd256"}.get(inst, "flash_attention")


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


def recording_calls(targets, fn, keep=None):
    """fn() with each (module, name) of ``targets`` recording the
    (args, kwargs) of its calls, the first ``keep`` of them if given (a
    full-width layer's arguments take GBs): (fn's result, {name:
    [calls]})."""
    calls = {name: [] for _, name in targets}
    real = {name: getattr(mod, name) for mod, name in targets}

    def recorder(name):
        def record(*args, **kw):
            if keep is None or len(calls[name]) < keep:
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
    log("13: followers exited 0")
    return out


def anns_rank(rank: int, world: int, init: str, device: str,
              origin: dict | None = None) -> dict | None:
    """One rank of phase 13b's (data x model) mesh: rank 0 is this process
    and brings ``origin`` (the round-robin placed index on the host, the
    engine's vectors, centroids and rotation, the scale and the queries);
    the others are spawned with ``anns_follower``. Every rank takes its
    blocks (``anns_step.place_step_inputs``), then for each scan runs a
    warm-up step, one counted step (every count set to 0 just before, read
    just after; rank 0 records its kernel calls) and four more, rank 0
    timing each. Returns, on rank 0, each scan's results, times, counted
    calls, collectives and every rank's launches and memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import beam_search, cluster_scan, ops, topk_select
    from repro_torch.launch import anns_step
    from repro_torch.launch import mesh as lmesh
    dev = lmesh.init_shard_group(rank, world, init_method=init,
                                 device=device, timeout_s=MESH_TIMEOUT_S)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    try:
        mesh = lmesh.make_mesh(ANNS_MESH, ("data", "model"), device=device)
        box = [origin["scale"] if origin else None]
        dist.broadcast_object_list(box, src=0)
        s = box[0]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        o = origin or {}
        local = anns_step.place_step_inputs(
            mesh, o.get("placed"), o.get("vectors"), o.get("centroids"),
            o.get("rotation"), device=dev)
        sync()
        place_s = time.perf_counter() - t
        mem = [torch.cuda.memory_allocated(dev) if cuda else 0]
        q = o.get("queries")
        out = {"place_s": place_s, "scans": {}}
        for scan in ("beam", "gemv"):
            step = anns_step.build_search_step(
                s, ANNS_MESH[1], scan, mesh, owner_rerank=True)
            step(*local, q)                          # warm-up
            sync()
            dist.barrier()
            ops.reset_launch_counts()
            step.collectives.reset()
            targets = [(topk_select, "topk_select"),
                       (cluster_scan, "ranked_cluster_scan")
                       if scan == "gemv" else
                       (beam_search, "ranked_beam_search")]
            t = time.perf_counter()
            (res, hops, dropped), calls = recording_calls(
                targets if rank == 0 else [], lambda: step(*local, q))
            sync()
            ms = [1e3 * (time.perf_counter() - t)]
            launches = ops.launch_counts()
            coll = step.collectives.as_dict()
            runs = [(res, hops, dropped)]
            for _ in range(4):
                t = time.perf_counter()
                runs.append(step(*local, q))
                sync()
                ms.append(1e3 * (time.perf_counter() - t))
            # one more run, rank 0 timing its stages (each synced)
            staged = step_stages(torch, step, sync, lambda: step(*local, q)) \
                if rank == 0 else step(*local, q)
            by_rank = [None] * world
            dist.all_gather_object(by_rank, launches)
            out["scans"][scan] = dict(runs=runs, ms=ms, calls=calls,
                                      collectives=coll, launches=by_rank,
                                      stages=staged if rank == 0 else None)
        mem.append(torch.cuda.max_memory_allocated(dev) if cuda else 0)
        mems = [None] * world
        dist.all_gather_object(mems, mem)
        out["memory"] = mems
        out["blocks"] = [tuple(local[0].codes.shape),
                         tuple(local[3].shape)]
        return out if rank == 0 else None
    finally:
        dist.destroy_process_group()


def step_stages(torch, step, sync, fn) -> dict:
    """fn(), one call of the mesh search step ``step``, with each of its
    stages timed on this rank's host clock, synced before and after
    (``sync``): the queries' broadcast, the routing (cluster filter and
    lane tables), the lanes' search, the all_gather, the candidates'
    gather, the rerank's distances, its MIN all_reduce and the selection;
    "other" is the rest of the call. A collective's time includes the wait
    for the slowest rank. Returns {stage: ms}."""
    import torch.distributed as dist
    from repro_torch.core import engine, rerank
    from repro_torch.kernels import ops
    stages = {}
    targets = [(dist, "broadcast", "broadcast"), (step, "route", "route"),
               (engine, "search_lanes", "search"),
               (dist, "all_gather", "all_gather"),
               (engine, "gather_candidates", "gather"),
               (rerank, "exact_sqdist", "distances"),
               (dist, "all_reduce", "all_reduce_min"),
               (ops, "topk_select", "topk_select")]
    real = [getattr(obj, name) for obj, name, _ in targets]

    def timed(f, label):
        def call(*a, **kw):
            sync()
            t = time.perf_counter()
            out = f(*a, **kw)
            sync()
            stages[label] = stages.get(label, 0.0) + 1e3 * (
                time.perf_counter() - t)
            return out
        return call
    for (obj, name, label), f in zip(targets, real):
        setattr(obj, name, timed(f, label))
    try:
        sync()
        t = time.perf_counter()
        fn()
        sync()
        total = 1e3 * (time.perf_counter() - t)
    finally:
        for (obj, name, _), f in zip(targets, real):
            setattr(obj, name, f)
        step.__dict__.pop("route", None)
    stages["other"] = total - sum(stages.values())
    stages["total"] = total
    return stages


def anns_follower(rank: int, world: int, init: str, device: str) -> None:
    """A spawned rank of phase 13b: ``anns_rank``, nothing returned (an
    exception ends the process with a non-zero exit)."""
    anns_rank(rank, world, init, device)


def same_bits(torch, label, got, want) -> None:
    """Ids, distances, hops and dropped lanes of a step, bit for bit."""
    (gr, gh, gd), (wr, wh, wd) = got, want
    if not (torch.equal(gr.ids, wr.ids)
            and torch.equal(gr.dists.view(torch.int32),
                            wr.dists.view(torch.int32))
            and torch.equal(gh, wh) and int(gd) == int(wd)):
        fail(f"{label}: differs from the one-process step (ids equal "
             f"{float((gr.ids == wr.ids).float().mean()):.4f}, dropped "
             f"{int(gd)} vs {int(wd)})")


def phase_anns_step(torch, eng, qt, qps5, mesh13) -> dict:
    """Phase 13b: ``launch.anns_step``'s search step at 10M on a (2 data x
    4 model) mesh of 8 gloo ranks sharing the card (see the module's
    docstring). The engine's own placed index is dropped while the phase
    runs, to make room, and placed anew after it."""
    import torch.distributed as dist  # noqa: F401
    import torch.multiprocessing as mp
    from repro_torch.core import backends, engine
    from repro_torch.kernels import ops
    from repro_torch.launch import anns_step
    t_phase = time.perf_counter()
    cuda = eng.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    world = ANNS_MESH[0] * ANNS_MESH[1]
    n_model = ANNS_MESH[1]
    s = anns_step.AnnsScale(n=N, dim=128, n_clusters=eng.index.n_clusters,
                            budget=eng.index.budget, degree=eng.icfg.degree,
                            queries=qt.shape[0])
    for line in anns_step.account_lines():
        log(f"13b --account: {line}")
    from repro_torch.launch import mesh as lmesh
    fp = anns_step.footprint(lmesh.MeshShape(("data", "model"), ANNS_MESH),
                             s)
    log(f"13b reckoning a rank at this scale (computed from shapes): index "
        f"{fp['index'] / 2**30:.3f} GiB + vectors "
        f"{fp['vectors'] / 2**30:.3f} GiB")
    eng.placed = None                  # 13b's round-robin copy takes its room
    sync()
    rr = engine._place(eng.index, anns_step.round_robin(s.n_clusters,
                                                        n_model),
                       backends.get_backend("mulfree"))
    one = {}
    for scan in ("beam", "gemv"):
        step = anns_step.build_search_step(s, n_model, scan)
        args = (rr, eng.index.centroids, eng.index.rotation,
                eng.host.vectors, qt)
        step(*args)
        sync()
        ops.reset_launch_counts()
        t = time.perf_counter()
        one[scan] = step(*args)
        sync()
        log(f"13b one-process step ({scan}, {n_model} shards round-robin): "
            f"{1e3 * (time.perf_counter() - t):.2f} ms, launches "
            f"{json.dumps(ops.launch_counts())}")
    rr_host = engine.PlacedIndex(
        *(t.cpu() for t in (rr.centroids, rr.codes, rr.neighbors, rr.entry,
                            rr.n_valid, rr.node_ids)),
        arrays=type(rr.arrays)(*(t.cpu() for t in rr.arrays)))
    del rr
    sync()
    store = ROOT / "build" / f"anns-store-{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    init = f"file://{store}"
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    t = time.perf_counter()
    procs = [ctx.Process(target=anns_follower,
                         args=(r, world, init, eng.device.type))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = anns_rank(0, world, init, eng.device.type, origin=dict(
            scale=s, placed=rr_host, vectors=eng.host.vectors,
            centroids=eng.index.centroids, rotation=eng.index.rotation,
            queries=qt))
    finally:
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if store.exists():
            store.unlink()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        fail(f"13b: ranks exited with {codes}")
    del rr_host
    log(f"13b {world} ranks up and placed in {time.perf_counter() - t:.1f} "
        f"s (placement {out['place_s']:.1f} s); each holds index "
        f"{out['blocks'][0]} and vectors {out['blocks'][1]}; GiB by rank "
        f"after placement [" + ", ".join(f"{m[0] / 2**30:.2f}" for m in
                                         out["memory"])
        + "], peak [" + ", ".join(f"{m[1] / 2**30:.2f}" for m in
                                  out["memory"]) + "] (rank 0 also holds "
        f"the engine's index and vectors)")
    result = {}
    for scan, r in out["scans"].items():
        for i, run in enumerate(r["runs"]):
            same_bits(torch, f"13b {scan} mesh run {i}", run, one[scan])
        res, hops, dropped = r["runs"][0]
        recall = recall_at(torch, eng, qt, res.ids)
        qps = sorted(1e3 * qt.shape[0] / m for m in r["ms"])
        med = qps[len(qps) // 2]
        want = "cluster_scan" if scan == "gemv" else "beam_search"
        for k, lc in enumerate(r["launches"]):
            if lc[want] != 1 or lc["topk_select"] != 1:
                fail(f"13b {scan}: rank {k} launched {lc}, expected one "
                     f"{want} and one topk_select")
        print(f"kernels anns {scan} " + json.dumps(
            {k: sum(lc[k] for lc in r["launches"]) for k in
             r["launches"][0]}), flush=True)
        hold_rank0_kernels(torch, r["calls"], f"13b {scan}")
        log(f"13b {scan}: one more run by stage on rank 0 (ms, each synced "
            f"on both sides): " + ", ".join(
                f"{k} {v:.2f}" for k, v in r["stages"].items()))
        log(f"13b {scan}: runs of {qt.shape[0]} queries "
            f"{', '.join(f'{m:.2f}' for m in r['ms'])} ms (the first "
            f"counted), median QPS {med:.1f}; phase 5's single engine "
            f"{sorted(qps5)[len(qps5) // 2]:.1f}, phase 13's mesh tier "
            f"{mesh13['med']['qps']:.1f} in this call; recall@10 "
            f"{recall:.4f}; dropped lanes {int(dropped)}; mean hops "
            f"{float(hops[hops > 0].float().mean()):.2f}; collectives a "
            f"step on rank 0 {json.dumps(r['collectives'])}; launches by "
            f"rank {json.dumps(r['launches'])}; every run bitwise the "
            f"one-process step's")
        if recall < 0.5:
            fail(f"13b {scan}: recall@10 {recall:.4f} < 0.5")
        result[scan] = dict(qps=med, recall=recall)
    eng.placed = engine._place(eng.index, eng.place, eng.backend)
    result["phase_s"] = time.perf_counter() - t_phase
    log("13b: the engine placed anew")
    return result


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
    from repro_torch.kernels import flash_attn, ref
    cfg = get_config("h2o-danube-1.8b")
    log(f"{cfg.name}: {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, window {cfg.window}")
    calls = []

    def record(q, k, v, **kw):
        if not calls:                 # layer 0 of the counted prefill
            calls.append((q.clone(), k.clone(), v.clone(), kw))
    model, params, tokens, out, counts, cache, _ = serve_counted(
        torch, dev, eng, cfg, 8, 2048, 32, torch.float32, record)
    b = tokens.shape[0]
    print("kernels lm " + json.dumps(counts), flush=True)
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"the prefill launched flash_attention {counts['flash_attention']}"
             f" times, expected one a layer ({cfg.n_layers})")
    log(f"retrieved ids (k={out.report.ids.shape[1]}) of the {b} requests: "
        f"{out.report.ids.tolist()}")
    # the last decode step (plain one-pass attention over the cache) against
    # a prefill of the same tokens (the kernel)
    cp = hold_decode_vs_prefill(torch, cfg, model, params, tokens, out,
                                cache, "plain one-pass attention")

    q0, k0, v0, kw0 = calls[0]
    SAVED["lm_layer0"] = calls[0]          # phase 20's tensor-core inputs
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
    f32_ms = event_ms(
        torch, lambda: ref.flash_attention_ref(q0, k0, v0, **kw0))
    log(f"flash_attention float32 plain version: {f32_ms:.5f} ms (one "
        f"call, CUDA events)")
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
    profile_steps(torch, model, params, tokens, out.tokens[:, -1:], cache,
                  cp, 6)
    return counts, row


def rewind(cache, pos: int) -> dict:
    """The LM cache with every slot's pos set to ``pos`` (the same tensors):
    the next step writes slot ``pos`` again and attends to the slots
    before it."""
    from repro_torch.models.attention import KVCache

    def one(c):
        return None if c is None else KVCache(c.k, c.v, pos)
    return {part: [one(c) for c in cache[part]]
            for part in ("prefix", "groups", "tail")}


def moe_routes(torch, fn, force=None):
    """fn() with the MoE router and dispatch recording, layer by layer:
    each layer's experts for the last position, (B, 1, k), and the copies
    it drops past capacity. With ``force`` (one (B, 1, k) tensor a layer,
    in order) the last position's experts are taken from it and their
    gates renormalised from the router's own probabilities there. Returns
    (fn's result, [the layers' own last-position experts], copies dropped,
    of which the last position's, copies routed)."""
    from repro_torch.models import moe
    real_route, real_rows = moe.route, moe.route_rows
    own, drops = [], [0, 0, 0]

    def route(p, x, cfg):
        probs, top_p, top_i = real_route(p, x, cfg)
        own.append(top_i[:, -1:].clone())
        if force is not None:
            top_i = top_i.clone()
            top_i[:, -1:] = force[len(own) - 1]
            gate = torch.gather(probs, -1, top_i)
            top_p = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return probs, top_p, top_i

    def route_rows(top_i, cap, e):
        dest = real_rows(top_i, cap, e)
        sink = dest == e * cap
        drops[0] += int(sink.sum())
        drops[1] += int(sink[:, -top_i.shape[-1]:].sum())
        drops[2] += dest.numel()
        return dest
    moe.route, moe.route_rows = route, route_rows
    try:
        return (fn(), own, *drops)
    finally:
        moe.route, moe.route_rows = real_route, real_rows


def through_kernel(torch, fn):
    """fn() with the decode step's plain one-pass attention sent through
    ``attend``, the kernel on a card: (fn's result, flash_attention
    launches in it)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    real = attention.attend_onepass
    attention.attend_onepass = attention.attend
    ops.reset_launch_counts()
    try:
        return fn(), ops.launch_counts()["flash_attention"]
    finally:
        attention.attend_onepass = real


def flipped(torch, own, want) -> int:
    """(layer, row) pairs whose top-k expert sets differ."""
    return sum(int((torch.sort(a, -1).values != torch.sort(b, -1).values)
                   .any(-1).sum()) for a, b in zip(own, want))


def sdpa_row(torch, q, k, v, n):
    """Time one scaled_dot_product_attention call on the kernel's work
    (causal over the n valid keys, GQA, bf16 K/V), by the first backend
    that takes dk != dv; (ms or None, backend name or the refusals)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    bf = torch.bfloat16
    qs = q.transpose(1, 2).contiguous()
    ks = k[:, :n].to(bf).transpose(1, 2).contiguous()
    vs = v[:, :n].to(bf).transpose(1, 2).contiguous()
    refused = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused.append(f"{backend.name}: "
                           f"{' '.join(str(e).split())[:160]}")
            continue
        ms, wall = times(torch, call, 3)
        return (ms if ms is not None else wall), backend.name, refused
    return None, None, refused


def phase_mla(torch, dev, eng):
    """Phase 14: deepseek-v2-lite-16b at full width (MLA and MoE) through
    launch.serve.generate, with retrieval into the 10M engine. Returns
    (the flash_attention launches of the counted run, the
    flash_attention/mla timing row)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn, ref
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b")
    b, prompt, n_gen = 8, 2048, 32
    log(f"{cfg.name}: {cfg.n_heads} heads, MLA kv_lora {cfg.kv_lora_rank} "
        f"+ rope {cfg.qk_rope_dim} (attention at dk "
        f"{cfg.kv_lora_rank + cfg.qk_rope_dim}, dv {cfg.kv_lora_rank}), "
        f"{cfg.n_experts} experts top-{cfg.n_experts_active} of d_ff "
        f"{cfg.moe_d_ff} + {cfg.n_shared_experts} shared, "
        f"{cfg.first_k_dense} dense layer of d_ff {cfg.d_ff}")
    calls = []

    def record(q, k, v, **kw):
        if not calls:                 # layer 0 of the counted prefill
            kc = k.clone()
            calls.append((q.clone(), kc, kc[..., :v.shape[-1]]
                          if v.data_ptr() == k.data_ptr() else v.clone(),
                          kw))
    model, params, tokens, out, counts, cache, c = serve_counted(
        torch, dev, eng, cfg, b, prompt, n_gen, torch.bfloat16, record)
    print("kernels mla " + json.dumps(counts), flush=True)
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"the prefill launched flash_attention {counts['flash_attention']}"
             f" times, expected one a layer ({cfg.n_layers})")
    toks = out.tokens

    # the last decode step again (the cache rewound to its position: it
    # writes its slot with the same bits), recording its routes
    pos = prompt + n_gen - 2
    (dec_logits, _), dec_top, d_drop, _, _ = moe_routes(
        torch, lambda: model.decode(params, toks[:, -2:-1], rewind(c, pos)))
    log(f"the last decode step run again: logits bitwise the served ones: "
        f"{torch.equal(dec_logits, out.logits)}; copies dropped {d_drop}")
    if d_drop:
        fail(f"a decode step dropped {d_drop} routed copies (capacity 1, "
             f"{cfg.n_experts_active} distinct experts: it cannot)")
    full = torch.cat([tokens, toks[:, :-1].long()], dim=1)
    v = slice(0, cfg.vocab_size)
    # the served config's prefill of the same tokens: logged, not held
    (srv, cp), srv_top, drop, drop_last, routed = moe_routes(
        torch, lambda: model.prefill(params, full, cache()))
    e_srv = float((dec_logits[:, -1, v].float() - srv[:, -1, v].float())
                  .abs().max())
    agree = int((dec_logits[:, -1, v].argmax(-1)
                 == srv[:, -1, v].argmax(-1)).sum())
    log(f"served prefill of {full.shape[1]} tokens (capacity "
        f"{moe.capacity(cfg, full.shape[1])} a row): {drop} of {routed} "
        f"routed copies dropped ({drop / routed:.4f}), {drop_last} of the "
        f"compared tokens' {b * cfg.n_experts_active * len(srv_top)}; "
        f"flipped top-{cfg.n_experts_active} choices of the compared token "
        f"vs decode {flipped(torch, srv_top, dec_top)} of "
        f"{b * len(srv_top)} (layer, row) pairs; decode vs it: max |diff| "
        f"{e_srv:.4f} of max |logit| "
        f"{float(srv[:, -1, v].float().abs().max()):.4f}, greedy token "
        f"equal in {agree} of {b} rows (logged, not held)")
    # held: the same decode step, its attention through the kernel (the MLA
    # instantiation at Sq = 1 over the same cache) and each MoE layer's
    # experts taken from decode's: the context and the routing are decode's,
    # so only the attention's rounding differs
    ((want, _), k_launches), k_top, _, _, _ = moe_routes(
        torch, lambda: through_kernel(
            torch, lambda: model.decode(params, toks[:, -2:-1],
                                        rewind(c, pos))),
        force=dec_top)
    if k_launches != cfg.n_layers:
        fail(f"the decode step through the kernel launched it {k_launches} "
             f"times, expected {cfg.n_layers}")
    got, want = dec_logits[:, -1, v].float(), want[:, -1, v].float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    arg_d, arg_p = got.argmax(-1), want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    log(f"decode (plain one-pass attention) vs the same step through the "
        f"kernel at position {pos} (routing forced to decode's; its own "
        f"choice flipped in {flipped(torch, k_top, dec_top)} of "
        f"{b * len(k_top)} (layer, row) pairs): max |diff| {err:.4f}, max "
        f"|logit| {scale:.4f} (ratio {err / scale:.4f}); argmax agrees in "
        f"{int((arg_d == arg_p).sum())} of {b} rows; top-2 margins "
        f"{[round(x, 4) for x in (top2[:, 0] - top2[:, 1]).tolist()]}")
    if err > 0.05 * scale:
        fail(f"decode logits differ from the kernel's by {err:.4f} > 5% of "
             f"their largest magnitude {scale:.4f}")
    if not torch.equal(arg_d, arg_p):
        fail("decode's greedy token differs from the kernel run's")
    del want, got, srv

    q0, k0, v0, kw0 = calls[0]
    alias = v0.data_ptr() == k0.data_ptr()
    label = (f"real layer 0 q_all {tuple(q0.shape)} "
             f"{str(q0.dtype)[6:]}, latent cache {tuple(k0.shape)} "
             f"{str(k0.dtype)[6:]}, v {'a view of it' if alias else 'apart'}"
             f" {tuple(v0.shape)}, {kw0}")
    if not alias:
        fail("the MLA prefill's v is not a view of its cache")
    got0 = flash_attn.flash_attention(q0, k0, v0, **kw0)
    hold_bf16_attention(torch, label, got0, q0, k0, v0, kw0,
                        "flash_attention/mla")
    bf = torch.bfloat16
    row = timed_row(
        torch, f"flash_attention/mla real layer 0 B={b} Sq={q0.shape[1]} "
        f"Sk={k0.shape[1]} (valid {kw0['kv_valid_len']}), plain = the twin",
        lambda: flash_attn.flash_attention(q0, k0, v0, **kw0),
        lambda: ref.flash_attention_ref(q0, k0, v0, operands=bf, **kw0), 10,
        flash_bound(q0, k0, v0, kw0["causal"], kw0["window"],
                    kw0["q_offset"], kw0["kv_valid_len"]))
    log_staged(q0, k0, v0, kw0, row["ms"], "flash_attention/mla")
    f32_ms = event_ms(
        torch, lambda: ref.flash_attention_ref(q0, k0, v0, **kw0))
    log(f"flash_attention/mla float32 plain version: {f32_ms:.5f} ms (one "
        f"call, CUDA events)")
    lib, backend, refused = sdpa_row(torch, q0, k0, v0, q0.shape[1])
    for line in refused:
        log(f"scaled_dot_product_attention at dk 576 / dv 512 refused by "
            f"{line}")
    row["library_ms"] = lib
    if lib is None:
        log("no scaled_dot_product_attention backend takes dk 576 != dv "
            "512 with enable_gqa: library_ms is null")
    else:
        log(f"flash_attention/mla library (scaled_dot_product_attention, "
            f"backend {backend}, causal, GQA over one latent head, bf16 K/V "
            f"of the {q0.shape[1]} valid keys): {lib:.5f} ms on the device; "
            f"kernel {row['ms']:.5f} ms, bound {row['bound_ms']:.5f} ms")

    # where a prefill's and a decode step's time goes (the decode step at
    # the last slot of the cache)
    profile_steps(torch, model, params, tokens, toks[:, -1:], cache, cp, 8)
    return counts["flash_attention"], row


def stage_times(torch, label, module, calls, per_prefill) -> dict:
    """Device ms of each stage's first recorded call (``recording_calls``)
    run again on its own arguments, and that times the calls a prefill
    makes (one a layer); CUDA-event wall ms where the profiler kept no
    whole set."""
    out = {}
    for name, ((a, kw),) in calls.items():
        fn = getattr(module, name)
        ms, wall = times(torch, lambda: fn(*a, **kw), 3)
        out[name] = ms if ms is not None else wall
        log(f"{label} stage {name}: {out[name]:.5f} ms on the device a call"
            f"{'' if ms is not None else ' (CUDA-event wall)'}, x"
            f"{per_prefill} layers = {out[name] * per_prefill:.3f} ms a "
            f"prefill")
    return out


def serve_counted(torch, dev, eng, cfg, b, prompt, n_gen, cache_dtype,
                  record=None, stub=None):
    """One arch at full width and depth through launch.serve.generate,
    with retrieval into the 10M engine: seeded params drawn on the card, a
    warm-up generate of 2 tokens, then the counted one (launch counts set
    to 0 just before and read just after). ``record(q, k, v, **kw)``, if
    given, sees every flash_attention call of the counted run; ``stub``
    (frames or patches) goes to every prefill. Returns (model, params,
    tokens, the Generation, launch counts, a fresh-cache factory, the
    counted run's cache, written in place)."""
    from repro_torch.core.pipeline import StreamingScheduler, bucket_ladder
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers (pattern {cfg.pattern}, layer "
        f"plan {cfg.layer_plan()}) x d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params "
        f"({cfg.param_count() / 1e9:.3f} B by the config's count, norms "
        f"left out) drawn on the card in {time.perf_counter() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                           device=dev)
    sched = StreamingScheduler(eng, buckets=bucket_ladder(b),
                               fill_threshold=max(b // 2, 1),
                               wait_limit_s=5e-3)
    enc = serve.mean_pool_encoder(params, eng.icfg.dim)

    def cache():
        return model.init_cache(b, prompt + n_gen, dtype=cache_dtype,
                                device=dev)
    stub = stub or {}
    serve.generate(model, params, tokens, 2, cache(), **stub)   # warm-up
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        record(q, k, v, **kw)
        return real(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c = cache()
    if record is not None:
        ops.flash_attention = recording
    ops.reset_launch_counts()
    try:
        out = serve.generate(model, params, tokens, n_gen, c,
                             scheduler=sched, encoder=enc, **stub)
    finally:
        ops.flash_attention = real
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = out.prefill_s + out.decode_s + out.retrieve_s
    log(f"generate B={b} prompt={prompt} gen={n_gen}, {str(cache_dtype)[6:]}"
        f" cache: prefill {out.prefill_s * 1e3:.2f} ms, decode "
        f"{out.decode_s * 1e3 / (n_gen - 1):.3f} ms per step ({n_gen - 1} "
        f"steps), retrieval {out.retrieve_s * 1e3:.2f} ms; "
        f"{b * n_gen / total:.1f} generated tokens/s "
        f"({b * (prompt + n_gen) / total:.1f} tokens/s with the prompt); "
        f"peak device memory {peak:.2f} GiB")
    toks = out.tokens
    if toks.shape != (b, n_gen) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"generated tokens malformed: {tuple(toks.shape)}")
    if not torch.isfinite(out.logits[..., :cfg.vocab_size].float()).all():
        fail("the last decode step's logits are not finite")
    ids = out.report.ids
    res, _ = eng.search(torch.from_numpy(out.queries).to(dev))
    same = ids == res.ids.cpu().numpy()
    log(f"retrieved ids equal engine.search of the same queries in "
        f"{int(same.sum())} of {same.size} slots")
    if not same.all():
        fail("the RAG loop's retrieved ids differ from engine.search")
    return model, params, tokens, out, counts, cache, c


def hold_decode_vs_prefill(torch, cfg, model, params, tokens, out, cache,
                           what: str, stub=None):
    """Phase 11's rule: the last decode step's logits (``what`` says how
    it reads the cache) against a prefill of the prompt and the generated
    tokens into an empty cache, at the last position: max |diff| within 5%
    of the largest |logit| and the same greedy token in every row, over the
    real vocabulary (in a row where two of the prefill's bf16 logits tie
    exactly at its maximum, decode's token is one of them). Both run every
    bf16 layer; the attention sums (and a recurrence against its chunked
    form or scan) run in other orders and the matmuls at other batch
    shapes, so bf16 roundings (2^-8 relative) differ and compound over the
    layers. The greedy token must not change in any row: it is what decode
    serves. ``stub`` (frames or patches)
    goes to the prefill as it went to the served one. Returns the
    prefill's cache."""
    full = torch.cat([tokens, out.tokens[:, :-1].long()], dim=1)
    logits_p, cp = model.prefill(params, full, cache(), **(stub or {}))
    v = slice(0, cfg.vocab_size)
    got, want = out.logits[:, -1, v].float(), logits_p[:, -1, v].float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    arg_d, arg_p = got.argmax(-1), want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    log(f"decode ({what}) vs a prefill of the same {full.shape[1]} tokens "
        f"at position {full.shape[1] - 1}: max |diff| {err:.4f}, max |logit| "
        f"{scale:.4f} (ratio {err / scale:.4f}), median |logit| "
        f"{float(want.abs().median()):.4f}; argmax agrees in "
        f"{int((arg_d == arg_p).sum())} of {arg_d.numel()} rows; the "
        f"prefill's top-2 margins "
        f"{[round(x, 4) for x in (top2[:, 0] - top2[:, 1]).tolist()]}")
    if err > 0.05 * scale:
        fail(f"decode logits differ from the prefill's by {err:.4f} > 5% of "
             f"their largest magnitude {scale:.4f}")
    # decode's token must reach the prefill's largest logit: where that
    # maximum is unique, it is the prefill's argmax; where two bf16 logits
    # tie at it exactly, neither is the greedy token more than the other
    top = want.max(-1).values
    tied = (want == top[:, None]).sum(-1) > 1
    reach = want.gather(-1, arg_d[:, None])[:, 0] == top
    if tied.any():
        pairs = [torch.nonzero(r == t).flatten().tolist()
                 for r, t in zip(want[tied], top[tied])]
        log(f"{int(tied.sum())} rows of the prefill tie exactly at their "
            f"largest logit (tokens {pairs}); decode's tokens there "
            f"{arg_d[tied].tolist()}")
    if not reach.all():
        fail(f"decode's greedy token is not the prefill's in "
             f"{int((~reach).sum())} of {arg_d.numel()} rows")
    return cp


def profile_steps(torch, model, params, tokens, nxt, cache, cp, n_top,
                  stub=None):
    """A profiled prefill of ``tokens`` (with ``stub``'s frames or patches)
    into a fresh cache and a profiled decode step of ``nxt`` over ``cp``:
    wall, device busy, launches, idle share, the top kernels. Returns
    {name: (wall ms, busy ms)}."""
    out = {}
    stub = stub or {}
    for name, step in (("prefill", lambda: model.prefill(params, tokens,
                                                         cache(), **stub)),
                       ("decode step", lambda: model.decode(params, nxt,
                                                            cp))):
        wall, kern = profiled(torch, step)
        busy = sum(ms for _, _, ms in kern)
        log(f"profiled {name}: {wall:.2f} ms wall, device busy {busy:.2f} ms "
            f"in {sum(n for _, n, _ in kern)} kernel launches (idle share "
            f"{1 - busy / wall:.3f})")
        log_top(kern, n_top)
        out[name] = (wall, busy)
    return out


def phase_ssm(torch, dev, eng):
    """Phase 15: mamba2-1.3b at full width and depth (48 SSD blocks, no
    attention) through launch.serve.generate, with retrieval into the 10M
    engine. Returns the launch counts of the counted run."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("mamba2-1.3b")
    d_inner = cfg.ssm_expand * cfg.d_model
    log(f"{cfg.name}: SSD d_inner {d_inner}, {d_inner // cfg.ssm_head_dim} "
        f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
        f"{cfg.chunk}, conv width {cfg.conv_width}")
    b, prompt, n_gen = 8, 2000, 32
    model, params, tokens, out, counts, cache, _ = serve_counted(
        torch, dev, eng, cfg, b, prompt, n_gen, torch.float32)
    print("kernels ssm " + json.dumps(counts), flush=True)
    if counts["flash_attention"] != 0:
        fail(f"mamba2 has no attention, yet flash_attention launched "
             f"{counts['flash_attention']} times")
    cp = hold_decode_vs_prefill(
        torch, cfg, model, params, tokens, out, cache,
        "the SSD recurrence from the prefill's state")
    # ROADMAP C7: a prefill's pos counts the padded length
    seen = prompt + n_gen - 1
    padded = -(-seen // cfg.chunk) * cfg.chunk
    pos = cp["groups"][0].pos
    log(f"C7: the prefill of {seen} tokens leaves pos {pos} (the padded "
        f"{padded}, as the reference's)")
    if pos != padded:
        fail(f"the SSM cache's pos after {seen} tokens is {pos}, the "
             f"reference's is {padded}")
    _, calls = recording_calls(
        [(ssm, n) for n in ("_causal_conv", "_intra_chunk", "_chunk_states",
                            "_inter_chunk")],
        lambda: model.prefill(params, tokens, cache()), keep=1)
    stage_times(torch, "SSD", ssm, calls, cfg.n_layers)
    profile_steps(torch, model, params, tokens, out.tokens[:, -1:], cache,
                  cp, 8)
    return counts


def sdpa_window_row(torch, q, k, v, window):
    """Time one scaled_dot_product_attention call on the kernel's work at
    a prefill from position 0 (causal, the window as a boolean mask, GQA,
    bf16 K/V), by the first backend that takes it; (ms or None, backend
    name or None, the refusals)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    bf = torch.bfloat16
    qs = q.transpose(1, 2).contiguous()
    ks = k.to(bf).transpose(1, 2).contiguous()
    vs = v.to(bf).transpose(1, 2).contiguous()
    n = q.shape[1]
    i = torch.arange(n, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    refused = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused.append(f"{backend.name}: "
                           f"{' '.join(str(e).split())[:160]}")
            continue
        ms, wall = times(torch, call, 3)
        return (ms if ms is not None else wall), backend.name, refused
    return None, None, refused


def phase_rglru(torch, dev, eng):
    """Phase 16: recurrentgemma-9b at full width and depth (26 RG-LRU
    blocks, 12 local-attention blocks at head dim 256) through
    launch.serve.generate, with retrieval into the 10M engine. Returns
    (the flash_attention launches of the counted run, the
    flash_attention/hd256 timing row)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn, ref
    from repro_torch.models import rglru
    cfg = get_config("recurrentgemma-9b")
    n_attn = sum(cfg.mixer_of(i) == "lattn" for i in range(cfg.n_layers))
    log(f"{cfg.name}: {cfg.n_heads} query heads over {cfg.n_kv_heads} KV "
        f"head of {cfg.hd}, window {cfg.window}, RNN width {cfg.rnn_width}, "
        f"{cfg.mlp_kind} d_ff {cfg.d_ff}, logit softcap {cfg.logit_softcap};"
        f" {n_attn} local-attention layers")
    b, prompt, n_gen = 8, 3072, 32
    calls, shapes = [], []

    def record(q, k, v, **kw):
        shapes.append((q.shape[-1], v.shape[-1], q.dtype, k.dtype, kw))
        if not calls:                 # layer 2, the first lattn layer
            calls.append((q.clone(), k.clone(), v.clone(), kw))
    model, params, tokens, out, counts, cache, _ = serve_counted(
        torch, dev, eng, cfg, b, prompt, n_gen, torch.bfloat16, record)
    print("kernels rglru " + json.dumps(counts), flush=True)
    if counts["flash_attention"] != n_attn:
        fail(f"the prefill launched flash_attention "
             f"{counts['flash_attention']} times, expected one a local-"
             f"attention layer ({n_attn})")
    insts = {flash_attn.instantiation(dk, dv) for dk, dv, *_ in shapes}
    log(f"the counted prefill's {len(shapes)} attention calls: head dims "
        f"{sorted({(dk, dv) for dk, dv, *_ in shapes})}, instantiations "
        f"{sorted(insts)}, q / K/V {shapes[0][2]} / {shapes[0][3]}, "
        f"{shapes[0][4]}")
    if insts != {(256, 256)}:
        fail(f"the prefill's attention ran in {insts}, not the hd-256 "
             f"instantiation alone")
    cp = hold_decode_vs_prefill(
        torch, cfg, model, params, tokens, out, cache,
        "the rolling cache through attend_onepass, the RG-LRU recurrence")
    slot = [c for c in cp["groups"] if hasattr(c, "k")][0]
    log(f"local-attention cache: k {tuple(slot.k.shape)} "
        f"{str(slot.k.dtype)[6:]} (a rolling window of {slot.k.shape[2]} "
        f"slots), pos {slot.pos}")

    q0, k0, v0, kw0 = calls[0]
    label = (f"real layer 2 q {tuple(q0.shape)} {str(q0.dtype)[6:]}, k/v "
             f"{tuple(k0.shape)} {str(k0.dtype)[6:]}, {kw0}")
    got0 = flash_attn.flash_attention(q0, k0, v0, **kw0)
    hold_bf16_attention(torch, label, got0, q0, k0, v0, kw0,
                        "flash_attention/hd256")
    bf = torch.bfloat16
    row = timed_row(
        torch, f"flash_attention/hd256 real layer 2 B={b} Sq={q0.shape[1]} "
        f"Sk={k0.shape[1]} window {kw0['window']}, plain = the twin",
        lambda: flash_attn.flash_attention(q0, k0, v0, **kw0),
        lambda: ref.flash_attention_ref(q0, k0, v0, operands=bf, **kw0), 10,
        flash_bound(q0, k0, v0, kw0["causal"], kw0["window"],
                    kw0["q_offset"], kw0["kv_valid_len"]))
    log_staged(q0, k0, v0, kw0, row["ms"], "flash_attention/hd256")
    f32_ms = event_ms(
        torch, lambda: ref.flash_attention_ref(q0, k0, v0, **kw0))
    log(f"flash_attention/hd256 float32 plain version: {f32_ms:.5f} ms (one "
        f"call, CUDA events)")
    if kw0["q_offset"] != 0 or kw0["kv_valid_len"] is not None:
        fail(f"the SDPA yardstick assumes a prefill from position 0 over "
             f"every key, got {kw0}")
    lib, backend, refused = sdpa_window_row(torch, q0, k0, v0,
                                            kw0["window"])
    for line in refused:
        log(f"scaled_dot_product_attention with the window's mask refused "
            f"by {line}")
    row["library_ms"] = lib
    if lib is None:
        log("no scaled_dot_product_attention backend takes the windowed "
            "mask with enable_gqa: library_ms is null")
    else:
        log(f"flash_attention/hd256 library (scaled_dot_product_attention, "
            f"backend {backend}, causal and the window {kw0['window']} as a "
            f"boolean mask, GQA over one KV head, bf16 K/V): {lib:.5f} ms on "
            f"the device; kernel {row['ms']:.5f} ms, bound "
            f"{row['bound_ms']:.5f} ms")
    del got0

    _, stage_calls = recording_calls(
        [(rglru, n) for n in ("_conv", "_gates", "_scan")],
        lambda: model.prefill(params, tokens, cache()), keep=1)
    stage_times(torch, "RG-LRU", rglru, stage_calls,
                cfg.n_layers - n_attn)
    del stage_calls
    profile_steps(torch, model, params, tokens, out.tokens[:, -1:], cache,
                  cp, 8)
    return counts["flash_attention"], row


def sdpa_flash_row(torch, q, k, v, causal):
    """Time one scaled_dot_product_attention call on the kernel's work by
    its flash backend (bf16 q, K/V cast to bf16, GQA where Hq > Hkv); ms
    or None where the backend refuses (the refusal logged)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    bf = torch.bfloat16
    qs = q.transpose(1, 2).contiguous()
    ks = k.to(bf).transpose(1, 2).contiguous()
    vs = v.to(bf).transpose(1, 2).contiguous()

    def call():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal,
                enable_gqa=q.shape[2] != k.shape[2])
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"scaled_dot_product_attention's flash backend refused "
            f"{tuple(q.shape)} over {tuple(k.shape)}: "
            f"{' '.join(str(e).split())[:160]}")
        return None
    ms, wall = times(torch, call, 10)
    return ms if ms is not None else wall


def kernel_row(torch, name, label, call, n_iters=10):
    """One flash_attention call ``(q, k, v, kw)`` recorded on the main
    path, launched again on its own inputs: held against its twin and the
    float32 plain version (``hold_bf16_attention``, recorded under
    ``name``), timed beside its bound, the twin, the float32 plain version
    and SDPA's flash backend on the same work. Returns the timing row."""
    from repro_torch.kernels import flash_attn, ref
    q, k, v, kw = call
    full = (f"{label}: q {tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
            f"{tuple(k.shape)} {str(k.dtype)[6:]}, {kw}")
    got = flash_attn.flash_attention(q, k, v, **kw)
    hold_bf16_attention(torch, full, got, q, k, v, kw, name)
    del got
    row = timed_row(
        torch, f"{name} {label} B={q.shape[0]} Sq={q.shape[1]} "
        f"Sk={k.shape[1]} {q.shape[2]}/{k.shape[2]} heads, plain = the twin",
        lambda: flash_attn.flash_attention(q, k, v, **kw),
        lambda: ref.flash_attention_ref(q, k, v, operands=torch.bfloat16,
                                        **kw), n_iters,
        flash_bound(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                    kw["kv_valid_len"]))
    f32_ms = event_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw))
    valid = k.shape[1] if kw["kv_valid_len"] is None else kw["kv_valid_len"]
    if kw["q_offset"] != 0 or valid != (q.shape[1] if kw["causal"]
                                        else k.shape[1]):
        fail(f"the SDPA yardstick assumes a prefill from position 0 over "
             f"its own keys, got {kw} at Sq {q.shape[1]}, Sk {k.shape[1]}")
    row["library_ms"] = sdpa_flash_row(torch, q, k[:, :valid],
                                       v[:, :valid], kw["causal"])
    lib = row["library_ms"]
    log(f"{name} {label}: kernel {row['ms']:.5f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
        f"{row['bound_ms'] / row['ms']:.3f} of the kernel's time), twin "
        f"{row['plain_ms']:.5f}, float32 plain {f32_ms:.5f}, SDPA flash "
        f"{'refused' if lib is None else f'{lib:.5f}'} ms on the device")
    return row


def split_prefill(torch, model, params, tokens, cache, stub):
    """One enc-dec prefill with CUDA events around its three parts (the
    encoder, ``encdec.encode``; the cross K/V projection,
    ``project_cross_kv``; the decoder's prefill, ``decode_forward``) and
    the whole: {part: (ms, flash_attention launches)}, and the whole's."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    names = ("encode", "project_cross_kv", "decode_forward")
    real = {n: getattr(encdec, n) for n in names}
    marks = {}

    def timed(n):
        def fn(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            n0 = ops.launch_counts()["flash_attention"]
            e0.record()
            r = real[n](*a, **kw)
            e1.record()
            marks[n] = (e0, e1, ops.launch_counts()["flash_attention"] - n0)
            return r
        return fn
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for n in names:
        setattr(encdec, n, timed(n))
    try:
        a.record()
        logits, c = model.prefill(params, tokens, cache, **stub)
        b.record()
    finally:
        for n in names:
            setattr(encdec, n, real[n])
    b.synchronize()
    out = {n: (e0.elapsed_time(e1), k) for n, (e0, e1, k) in marks.items()}
    out["prefill"] = (a.elapsed_time(b),
                      ops.launch_counts()["flash_attention"])
    return out, logits, c


def phase_encdec(torch, dev, eng):
    """Phase 17: whisper-large-v3 at full width and depth (32 encoder + 32
    decoder layers, 20 heads of 64, 1,500 frames) through
    launch.serve.generate, with retrieval into the 10M engine. Returns (the
    non-causal flash_attention launches of the counted run, the
    flash_attention/noncausal timing row of layer 0's encoder call)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config("whisper-large-v3")
    b, prompt, n_gen = 8, 416, 32
    log(f"{cfg.name}: {cfg.enc_layers} encoder + {cfg.n_layers} decoder "
        f"layers, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff} ({cfg.mlp_kind}, {cfg.act}), {cfg.n_frames} frames; "
        f"{b} requests of {prompt} prompt tokens + {n_gen} generated")
    frames = torch.randn((b, cfg.n_frames, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(17))
    stub = {"frames": frames}
    calls, kept = [], {}

    def record(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        role = "encoder" if q.shape[1] == k.shape[1] == cfg.n_frames \
            else "cross" if not kw["causal"] and q.shape[1] > 1 \
            else "cross decode" if not kw["causal"] else None
        if role is not None and role not in kept:     # layer 0's
            kept[role] = (q.clone(), k.clone(), v.clone(), kw)
    model, params, tokens, out, counts, cache, _ = serve_counted(
        torch, dev, eng, cfg, b, prompt, n_gen, torch.float32, record, stub)
    print("kernels encdec " + json.dumps(counts), flush=True)
    per_prefill = cfg.enc_layers + 2 * cfg.n_layers
    want = per_prefill + (n_gen - 1) * cfg.n_layers
    noncausal = sum(not c for c, _, _ in calls)
    log(f"the counted run's flash_attention calls: {len(calls)} ({noncausal}"
        f" non-causal), launches {counts['flash_attention']}")
    if counts["flash_attention"] != want or len(calls) != want:
        fail(f"the counted run launched flash_attention "
             f"{counts['flash_attention']} times ({len(calls)} calls), "
             f"expected {per_prefill} in the prefill and {cfg.n_layers} in "
             f"each of the {n_gen - 1} decode steps ({want})")
    if noncausal != want - cfg.n_layers:
        fail(f"{noncausal} non-causal calls, expected every call but the "
             f"decoder prefill's {cfg.n_layers} self-attention layers")
    cp = hold_decode_vs_prefill(
        torch, cfg, model, params, tokens, out, cache,
        "self-attention through attend_onepass, cross-attention through the "
        "kernel at Sq = 1", stub)
    del cp

    # the prefill split by CUDA events, its launches, then one decode step's
    parts, _, c2 = split_prefill(torch, model, params, tokens, cache(), stub)
    for n, (ms, k) in parts.items():
        log(f"prefill part {n}: {ms:.3f} ms (CUDA events), {k} "
            f"flash_attention launches")
    nxt = out.tokens[:, :1]
    ops.reset_launch_counts()
    model.decode(params, nxt, c2)
    step = ops.launch_counts()["flash_attention"]
    log(f"one decode step: {step} flash_attention launches")
    if parts["prefill"][1] != per_prefill or step != cfg.n_layers or \
            parts["encode"][1] != cfg.enc_layers:
        fail(f"a prefill launched {parts['prefill'][1]} (expected "
             f"{per_prefill}, {cfg.enc_layers} in the encoder), a decode "
             f"step {step} (expected {cfg.n_layers})")

    if set(kept) != {"encoder", "cross", "cross decode"}:
        fail(f"the counted run recorded calls {sorted(kept)}")
    row = kernel_row(torch, "flash_attention/noncausal", "encoder layer 0",
                     kept["encoder"])
    kernel_row(torch, "flash_attention/noncausal", "cross layer 0 prefill",
               kept["cross"])
    kernel_row(torch, "flash_attention/noncausal", "cross layer 0 decode",
               kept["cross decode"], n_iters=30)
    kept.clear()
    profile_steps(torch, model, params, tokens, nxt, cache, c2, 8, stub)
    return noncausal, row


def phase_vlm(torch, dev, eng):
    """Phase 18: internvl2-1b at full width and depth (24 layers, 14 / 2
    heads of 64) through launch.serve.generate with 256 stub patches
    before the prompt, with retrieval into the 10M engine. Returns the
    launch counts of the counted run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config("internvl2-1b")
    b, prompt, n_gen = 8, 2048 - cfg.n_patches, 32
    log(f"{cfg.name}: {cfg.n_layers} layers, {cfg.n_heads} / "
        f"{cfg.n_kv_heads} heads of {cfg.hd} (group "
        f"{cfg.n_heads // cfg.n_kv_heads}), {cfg.n_patches} patches + "
        f"{prompt} prompt tokens, {n_gen} generated")
    patches = torch.randn((b, cfg.n_patches, cfg.d_model), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              18))
    stub = {"patches": patches}
    kept = []

    def record(q, k, v, **kw):
        if not kept:                       # layer 0 of the counted prefill
            kept.append((q.clone(), k.clone(), v.clone(), kw))
    model, params, tokens, out, counts, cache, _ = serve_counted(
        torch, dev, eng, cfg, b, prompt, n_gen, torch.float32, record, stub)
    print("kernels vlm " + json.dumps(counts), flush=True)
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"the counted run launched flash_attention "
             f"{counts['flash_attention']} times, expected {cfg.n_layers} "
             f"in the prefill and none in a decode step")
    cp = hold_decode_vs_prefill(torch, cfg, model, params, tokens, out,
                                cache, "plain one-pass attention", stub)
    pos = cp["groups"][0].pos
    log(f"the prefill of the patches and {prompt + n_gen - 1} tokens leaves "
        f"pos {pos} ({cfg.n_patches} patch slots first)")
    if pos != cfg.n_patches + prompt + n_gen - 1:
        fail(f"the vlm cache's pos is {pos}")
    ops.reset_launch_counts()
    model.prefill(params, tokens, cache(), **stub)
    per_prefill = ops.launch_counts()["flash_attention"]
    ops.reset_launch_counts()
    model.decode(params, out.tokens[:, -1:], cp)
    step = ops.launch_counts()["flash_attention"]
    log(f"flash_attention launches: {per_prefill} a prefill, {step} a "
        f"decode step")
    if per_prefill != cfg.n_layers or step != 0:
        fail(f"{per_prefill} launches a prefill, {step} a decode step")
    kernel_row(torch, "flash_attention", "internvl2 layer 0", kept.pop())
    profile_steps(torch, model, params, tokens, out.tokens[:, -1:], cache,
                  cp, 8, stub)
    return counts


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
    log(f"12: peak device memory "
        f"{out['peak_gib']:.2f} GiB; steps (s) " + json.dumps(
            {k: round(v, 3) for k, v in out.items() if k.endswith("_s")})
        + "; peak allocated by step (GiB) " + json.dumps(
            {k: round(v, 2) for k, v in out.items()
             if k.endswith("_peak_gib")}))
    return out


# ---------------------------------------------------------------------------
# phases 19-19d: the training path
# ---------------------------------------------------------------------------

TRAIN_ARCH = "h2o-danube-1.8b"   # phase 19: full width, launch.train.run
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 16
RESUME_ARCH = "phi3-mini-3.8b"   # phases 19b and 19c: the 100m preset
RESUME_B, RESUME_S = 8, 256
DP_RANKS = 2                     # phase 19c: ranks sharing the card (gloo)
                                 # (19d: 2 pod x 2 data)
DP_ATOL = 5e-2                   # tests/test_distributed.py's DP tolerance
# float32 gradients of one batch summed in other orders (on the card and
# the CPU; the whole batch and its halves): within 1e-3 / 1e-4 of the
# leaf's largest |grad| (tests/test_torch_cuda.py, tests/test_torch_train.py)
CARD_GRAD_RTOL, GRAD_RTOL = 1e-3, 1e-4
WITNESS_S = 128                  # phase 19w: one sequence, float32 ...
WITNESS_LAYERS = 8               # ... through 8 of danube's 24 layers
WITNESS_LR = 3e-5                # phase 19w: lr_peak of the 4-step run


def bwd_bound(q, k, v, causal, window, q_offset, kv_valid_len):
    """The attention backward's least time: its operations, 2.5x the
    forward's (``flash_bound``: QK^T and PV, 2 B Hq (dk + dv) a valid key;
    the backward recomputes S and P and takes dV = P^T dO, dP = dO V^T, dQ
    = dS K and dK = dS^T Q, five products of that size where the forward
    has two), at the bf16 tensor-core rate; its bytes, q, k, v, out and dout
    read once, lse read once, dq, dk and dv written once."""
    from repro_torch.kernels import cost
    b, sq, hq, dk = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    keys, _ = cost.visible_keys(sq, sk, causal, window, q_offset,
                                kv_valid_len)
    e = q.element_size()
    nbytes = (2 * (q.numel() + b * sq * hq * dv) * e      # q, dq; out, dout
              + 2 * (k.numel() + v.numel()) * e            # k, v; dk, dv
              + b * hq * sq * 4)                           # lse
    return cost.Work({"bf16": 2.5 * 2 * b * hq * (dk + dv) * keys},
                     nbytes).bound()


def phase_train(torch, dev):
    """Phase 19: h2o-danube-1.8b trains at full width through
    ``launch.train.run``: TRAIN_STEPS steps of TRAIN_B x TRAIN_S tokens (two
    micro-batches a step, its accum_steps), remat on, bf16 params, float32
    moments. Each step is timed (CUDA synchronised on both sides), the
    flash_attention launches of each step counted; the first forward
    attention call (layer 0 of the first micro-batch) and the backward of
    layer 0 in that micro-batch are recorded. Then, on those real inputs:
    the kernel's lse against its twin's and the float32 plain version's
    within ``ref.flash_attention_lse_bound``; its output with lse the bits
    of its output without, held as in phase 11; the plain backward's (dq,
    dk, dv) against autograd through the float32 one-pass attention within
    ``ref.flash_attention_bwd_bound``; the forward timed with and without
    lse, the backward, and SDPA's forward and forward + backward. Returns
    (the flash_attention launches of the run, the timing row)."""
    from repro_torch.kernels import flash_attn, ops, ref
    from repro_torch.launch import train
    from repro_torch.models.attention import attend_onepass
    cfg = train.preset_config(TRAIN_ARCH, "full")
    log(f"19 {cfg.name} training: {cfg.n_layers} layers x d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd},"
        f" window {cfg.window}, vocab {cfg.vocab_size}, accum_steps "
        f"{cfg.accum_steps}, remat {cfg.remat}, params {cfg.param_dtype}; "
        f"{TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd_calls, bwd_calls, step_ms, step_launches, last = [], [], [], [], []
    n_bwd = [0]
    real_flash, real_bwd = ops.flash_attention, ref.flash_attention_bwd_ref
    real_step = train.make_train_step

    def rec_flash(q, k, v, **kw):
        if not fwd_calls:
            mask = {x: y for x, y in kw.items() if x != "return_lse"}
            fwd_calls.append((q.detach().clone(), k.detach().clone(),
                              v.detach().clone(), mask))
        return real_flash(q, k, v, **kw)

    def rec_bwd(q, k, v, out, lse, dout, **kw):
        n_bwd[0] += 1
        if n_bwd[0] == cfg.n_layers:   # layer 0, the first micro-batch
            bwd_calls.append(tuple(t.detach().clone() for t in
                                   (q, k, v, out, lse, dout)) + (kw,))
        return real_bwd(q, k, v, out, lse, dout, **kw)

    def timed_step_factory(model, ocfg, donate=False):
        fn = real_step(model, ocfg, donate)

        def step(*args):
            if len(step_ms) == TRAIN_STEPS - 1:    # the last step's inputs
                last[:] = [fn, args]
            torch.cuda.synchronize()
            before = ops.launch_counts()["flash_attention"]
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            step_launches.append(ops.launch_counts()["flash_attention"]
                                 - before)
            return out
        return step

    ops.flash_attention, ref.flash_attention_bwd_ref = rec_flash, rec_bwd
    train.make_train_step = timed_step_factory
    ops.reset_launch_counts()
    try:
        losses = train.run(TRAIN_ARCH, "full", TRAIN_STEPS, TRAIN_B,
                           TRAIN_S, None, 0, False, log_every=1, device=dev)
    finally:
        ops.flash_attention, ref.flash_attention_bwd_ref = real_flash, \
            real_bwd
        train.make_train_step = real_step
    counts = ops.launch_counts()
    print("kernels train " + json.dumps(counts), flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (loss, ms, n) in enumerate(zip(losses, step_ms, step_launches)):
        log(f"19 step {i}: loss {loss:.5f}, {ms:.1f} ms, "
            f"{TRAIN_B * TRAIN_S / (ms / 1e3):.1f} tokens/s, "
            f"{n} flash_attention launches")
    steady = step_ms[1:]
    log(f"19 train: steps after the first {np.mean(steady):.1f} ms mean, "
        f"{TRAIN_B * TRAIN_S / (np.mean(steady) / 1e3):.1f} tokens/s; peak "
        f"device memory {peak:.2f} GiB; flash_attention launches "
        f"{counts['flash_attention']} in the run ({step_launches} by step: "
        f"a forward and a recompute a layer a micro-batch)")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"19: losses {losses}: expected {TRAIN_STEPS} finite")
    if not losses[-1] < losses[0]:
        fail(f"19: the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    want = 2 * cfg.accum_steps * cfg.n_layers
    if step_launches != [want] * TRAIN_STEPS:
        fail(f"19: flash_attention launches by step {step_launches}, "
             f"expected {want} (forward and recompute, each layer of each "
             f"micro-batch)")
    if len(bwd_calls) != 1:
        fail("19: layer 0's backward was not recorded")
    # where a step's time goes: the last step again under the profiler
    fn, args = last
    last.clear()
    SAVED["train_step"] = (fn, args, float(np.median(steady)) / 1e3)
    wall, kern = profiled(torch, lambda: fn(*args))
    del fn, args
    busy = sum(ms for _, _, ms in kern)
    log(f"19 profiled train step: {wall:.1f} ms wall, {busy:.1f} ms busy "
        f"in {sum(n for _, n, _ in kern)} launches (idle "
        f"{1 - busy / wall:.3f}); the kernels with the most device time:")
    log_top(kern, 10)
    torch.cuda.empty_cache()

    q, k, v, kw = fwd_calls[0]
    bf = torch.bfloat16
    label = (f"train layer 0 q {tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
             f"{tuple(k.shape)} {str(k.dtype)[6:]}, {kw}")
    name = "flash_attention/train"
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    if not torch.equal(out, flash_attn.flash_attention(q, k, v, **kw)):
        fail("19: the kernel's output with lse differs from without")
    hold_bf16_attention(torch, label, out, q, k, v, kw, name)
    _, twin_lse = ref.flash_attention_ref(q, k, v, operands=bf,
                                          return_lse=True, **kw)
    _, plain_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    lb = ref.flash_attention_lse_bound(q, k, twin_lse, **kw)
    close(torch, name, f"{label} lse vs twin", lse, twin_lse, lb)
    close(torch, name, f"{label} lse vs float32 plain", lse, plain_lse, lb,
          record=False)
    del out, lse, twin_lse, plain_lse, lb

    bq, bk, bv, bo, blse, bdout, bkw = bwd_calls[0]
    if not (torch.equal(bq, q) and torch.equal(bk, k)):
        fail("19: layer 0's recomputed q / k differ from its forward's")
    grads = ref.flash_attention_bwd_ref(bq, bk, bv, bo, blse, bdout, **bkw)
    f32 = [t.float().requires_grad_() for t in (bq, bk, bv)]
    want32 = torch.autograd.grad(attend_onepass(*f32, **bkw), f32,
                                 bdout.float())
    del f32
    bounds = ref.flash_attention_bwd_bound(bq, bk, bv, bo, blse, bdout,
                                           **bkw)
    for gname, got, w, bnd in zip(("dq", "dk", "dv"), grads, want32, bounds):
        close(torch, name, f"layer 0 backward {gname} vs autograd through "
              f"the float32 one-pass attention", got.float(), w, bnd,
              record=False)
    del want32, bounds

    row = timed_row(
        torch, f"{name} (with lse) layer 0 B={q.shape[0]} Sq={q.shape[1]}, "
        f"plain = the twin with lse",
        lambda: flash_attn.flash_attention(q, k, v, return_lse=True, **kw),
        lambda: ref.flash_attention_ref(q, k, v, operands=bf,
                                        return_lse=True, **kw), 10,
        flash_bound(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                    kw["kv_valid_len"]))
    no_lse, no_lse_wall = times(
        torch, lambda: flash_attn.flash_attention(q, k, v, **kw), 10)
    bwd_ms, bwd_wall = times(
        torch, lambda: ref.flash_attention_bwd_ref(bq, bk, bv, bo, blse,
                                                   bdout, **bkw), 3)
    bwd_ms = bwd_ms if bwd_ms is not None else bwd_wall
    bb = bwd_bound(bq, bk, bv, bkw["causal"], bkw["window"],
                   bkw["q_offset"], bkw["kv_valid_len"])
    n = q.shape[1]
    if kw["window"] is not None and kw["window"] < n:
        fail(f"19: the SDPA yardstick assumes the window ({kw['window']}) "
             f"spans the sequence ({n})")
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (bq, bk, bv))
    dos = bdout.transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), dos)
    with torch.no_grad():
        lib, lib_wall = times(torch, sdpa, 10)
    lib_fb, lib_fb_wall = times(torch, sdpa_fwd_bwd, 5)
    row["library_ms"] = lib if lib is not None else lib_wall
    lib_fb = lib_fb if lib_fb is not None else lib_fb_wall
    row["no_lse_ms"] = no_lse if no_lse is not None else no_lse_wall
    row["bwd"] = dict(ms=bwd_ms, bound_ms=bb[0], bound_by=bb[1],
                      library_ms=lib_fb - row["library_ms"],
                      launches=TRAIN_STEPS * cfg.accum_steps * cfg.n_layers)
    log(f"19 {name} layer 0: forward with lse {row['ms']:.5f} ms, without "
        f"{row['no_lse_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}); SDPA forward {row['library_ms']:.5f} ms; "
        f"plain backward {bwd_ms:.5f} ms, bound {bb[0]:.5f} ms ({bb[1]}, "
        f"{bb[0] / bwd_ms:.4f} of its time), {row['bwd']['launches']} calls "
        f"in the run ({cfg.accum_steps * cfg.n_layers} a step); SDPA forward"
        f" + backward {lib_fb:.5f} ms (backward alone "
        f"{row['bwd']['library_ms']:.5f} ms) on the device")
    row["steps"] = dict(losses=losses, step_ms=step_ms, peak_gib=peak,
                        tokens_per_s=TRAIN_B * TRAIN_S
                        / (np.mean(steady) / 1e3), busy_ms=busy,
                        wall_ms=wall)
    return counts["flash_attention"], row


def phase_train_witness(torch, dev):
    """Phase 19w: what phase 19's rise in loss comes from (with the
    reference's recipe, lr 3e-4 after a warm-up of 2 steps, its steps 2-4
    rise above the first). Two witnesses at h2o-danube-1.8b's full
    width. (1) The gradients, at full width through the first
    WITNESS_LAYERS layers (the depth cut to pay for phase 11s, most of it
    the CPU pass's): float32 params on the card and on the
    CPU, one sequence of WITNESS_S tokens (row 0 of step 0's batch), the
    loss within 1e-4 relative and each grad leaf within CARD_GRAD_RTOL of
    its largest |grad| (float32 sums in other orders); the global grad
    norms logged; the bf16 params' gradients on the card (the training's
    types) logged beside them, not held (bf16 roundings through the layers
    have no derived bound). (2) The recipe: phase 19's first 4 steps (the
    same seeded params and batches, through ``make_train_step``) at
    lr_peak WITNESS_LR, warm-up 1: each loss logged; held finite and the
    last below the first."""
    from repro_torch import tree as T
    from repro_torch.data.synthetic import TokenDataConfig, token_batch
    from repro_torch.launch import train
    from repro_torch.models.model import (build_model, make_train_step,
                                          value_and_grad)
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = train.preset_config(TRAIN_ARCH, "full")
    dcfg = TokenDataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    one = {k: v[:1, :WITNESS_S].contiguous()
           for k, v in token_batch(dcfg, 0).items()}
    cut = dataclasses.replace(cfg, n_layers=WITNESS_LAYERS)
    m32 = build_model(dataclasses.replace(cut, param_dtype="float32"))
    p32 = m32.init(torch.Generator(device=dev).manual_seed(0))
    card_l, _, card_g = value_and_grad(
        m32, p32, {k: v.to(dev) for k, v in one.items()})
    card_g = [g.cpu() for g in card_g]
    pc = T.tree_map(lambda x: x.cpu(), p32)
    p16 = T.tree_map(lambda x: x.to(torch.bfloat16), p32)
    del p32
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cpu_l, _, cpu_g = value_and_grad(m32, pc, one)
    cpu_s = time.perf_counter() - t
    del pc
    bf_l, _, bf_g = value_and_grad(
        build_model(cut), p16, {k: v.to(dev) for k, v in one.items()})
    bf_g = [g.float().cpu() for g in bf_g]
    del p16
    torch.cuda.empty_cache()

    def norm(gs):
        return math.sqrt(sum(float(g.double().square().sum()) for g in gs))
    worst, worst_bf = 0.0, 0.0
    for a, w, b in zip(card_g, cpu_g, bf_g):
        scale = max(float(w.abs().max()), 1e-30)
        worst = max(worst, float((a - w).abs().max()) / scale)
        worst_bf = max(worst_bf, float((b - w).norm() / w.norm().clamp(
            min=1e-30)))
    log(f"19w gradients, {cfg.name} float32 at full width through "
        f"{WITNESS_LAYERS} of its {cfg.n_layers} layers, 1 x "
        f"{WITNESS_S} tokens: loss card {float(card_l):.6f}, CPU "
        f"{float(cpu_l):.6f} ({cpu_s:.1f} s on the CPU); global grad norm "
        f"card {norm(card_g):.6f}, CPU {norm(cpu_g):.6f}; max over "
        f"{len(cpu_g)} leaves of max |card - CPU| / max |CPU| {worst:.3g} "
        f"(bound {CARD_GRAD_RTOL}); bf16 params on the card: loss "
        f"{float(bf_l):.6f}, grad norm {norm(bf_g):.6f}, largest leaf "
        f"|bf16 - float32| / |float32| (L2) {worst_bf:.3g}")
    if abs(float(card_l) - float(cpu_l)) > 1e-4 * abs(float(cpu_l)) or \
            worst > CARD_GRAD_RTOL:
        fail(f"19w: the full-width gradients on the card differ from the "
             f"CPU's: loss {float(card_l)} vs {float(cpu_l)}, leaf error "
             f"{worst} of its largest |grad| (> {CARD_GRAD_RTOL})")
    del card_g, cpu_g, bf_g

    ocfg = adamw.AdamWConfig(lr_peak=WITNESS_LR, warmup_steps=1,
                             decay_steps=4)
    m16 = build_model(cfg)
    params = m16.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw.init(ocfg, params)
    step = make_train_step(m16, ocfg)
    losses = []
    for i in range(4):
        b = {k: v.to(dev) for k, v in token_batch(dcfg, i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    del params, opt
    torch.cuda.empty_cache()
    log(f"19w recipe: phase 19's first 4 steps at lr_peak {WITNESS_LR} "
        f"(warm-up 1): losses {losses}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"19w: at lr_peak {WITNESS_LR} the losses {losses} do not end "
             f"below the first")


def mu_bound(mu_ref, n):
    """Per-element bound on |mu - mu_ref| of a DP step's first moment
    against ``make_train_step``'s on the whole batch, after one step
    without clipping (mu = (1 - b1) g, float32 params and moments):
    ``compressed_psum_mean`` rounds each of a leaf's n flat shards to its
    int8 grid, step max |shard| / 127, so half a step of the shard's
    largest |g| plus dg = GRAD_RTOL max |g| (the float32 orders of the
    halves and the whole), then dg again and 1e-6 of the largest |mu| for
    the roundings; a leaf that takes the plain mean has no step. In mu's
    units; tests/test_torch_trainer.py's ``_mu_bound``."""
    m = mu_ref.double().abs().reshape(-1)
    top = float(m.max())
    dg = GRAD_RTOL * top
    if m.numel() % n or m.numel() < n * 8:
        half = m * 0
    else:
        half = (m.reshape(n, -1).amax(1) + dg).repeat_interleave(
            m.numel() // n) / 254
    return (half + dg + 1e-6 * top).reshape(mu_ref.shape)


def phase_train_resume(torch, dev):
    """Phase 19b: checkpoint and resume through ``launch.train.run`` at
    RESUME_ARCH's 100m preset, RESUME_B x RESUME_S tokens a step: 6 steps
    with a checkpoint every 3, then --resume to 9 (exactly 3 steps run);
    an uninterrupted 9-step run (checkpoints 3, 6, 9); a copy of it without
    step 9 resumed to 9 (its last 3 losses); a copy torn further (a stray
    .tmp_ directory, one corrupted leaf in step 6), which must skip step 6
    and load step 3 (its last 6 losses). The step is deterministic (the
    same batches from (seed, step), the same kernels on the same inputs),
    so the resumed losses are held bitwise against the uninterrupted
    run's: a restore that lost or reset any of the optimizer state would
    change them."""
    import io
    import shutil
    from contextlib import redirect_stdout
    from repro_torch.launch import train
    root = ROOT / "build" / f"train-ckpt-{os.getpid()}"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)

    def run(d, steps, resume):
        buf = io.StringIO()
        with redirect_stdout(buf):
            losses = train.run(RESUME_ARCH, "100m", steps, RESUME_B,
                               RESUME_S, str(root / d), 3, resume,
                               log_every=100, device=dev)
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"19b {d}: {line}")
        return losses, text

    try:
        first, _ = run("a", 6, False)
        more, text = run("a", 9, True)
        if len(first) != 6 or len(more) != 3 or \
                "resumed from step 6" not in text:
            fail(f"19b: 6 steps then a resume to 9 ran {len(first)} and "
                 f"{len(more)} steps")
        whole, _ = run("b", 9, False)
        shutil.copytree(root / "b", root / "c")
        shutil.rmtree(root / "c" / "step_000000009")
        after6, text = run("c", 9, True)
        shutil.copytree(root / "b", root / "d")
        shutil.rmtree(root / "d" / "step_000000009")
        (root / "d" / ".tmp_000000009").mkdir()
        leaf = root / "d" / "step_000000006" / "arr_00003.npy"
        raw = bytearray(leaf.read_bytes())
        raw[-1] ^= 0xFF
        leaf.write_bytes(bytes(raw))
        names = sorted(x.name for x in (root / "d").iterdir())
        log(f"19b torn directory: {names}, step 6's arr_00003.npy "
            f"corrupted")
        after3, torn = run("d", 9, True)
        if "step 6 unusable" not in torn or "resumed from step 3" not in torn:
            fail("19b: the torn step 6 was not skipped for step 3")
        checks = {"resume at 6": (after6, whole[6:]),
                  "torn, resume at 3": (after3, whole[3:])}
        for label, (got, want) in checks.items():
            log(f"19b {label}: losses {got} vs uninterrupted {want}")
            if got != want:
                fail(f"19b {label}: resumed losses {got} are not the "
                     f"uninterrupted run's {want} bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"19b: 6 + 3 steps, "
        f"9 uninterrupted, resumed at 6 and (torn) at 3")


def dp_rank(rank: int, world: int, init: str, device: str = "cuda",
            pod: bool = False) -> dict:
    """One rank of phase 19c's DP step (this process is rank 0; the others
    are spawned with ``dp_follower``), or with ``pod`` of phase 19d's on a
    (2 pod x 2 data) mesh: the group over gloo, RESUME_ARCH's
    100m params seeded alike on every rank, one compressed
    ``make_dp_train_step`` step on the global batch of step 0, the params'
    SHA-256 gathered from every rank; the same step with the preset's
    params in float32, its params' and first moments' SHA-256 gathered;
    then the gradient reduction alone timed (``trainer.reduce_mean``,
    compressed and plain, 2 turns each, every leaf of the params' shapes).
    Returns the step's params,
    loss, ms, the digests, the float32 step's first moments and the
    reduction ms."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.data.synthetic import TokenDataConfig, token_batch
    from repro_torch.distributed import compress, trainer
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    dev = lmesh.init_shard_group(rank, world, init_method=init,
                                 device=device, timeout_s=MESH_TIMEOUT_S)
    try:
        group = lmesh.make_mesh((2, world // 2), ("pod", "data"),
                                device=device) if pod else None
        groups = trainer.data_groups(group)[0]
        cfg = train.preset_config(RESUME_ARCH, "100m")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        ocfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=4,
                                 clip_norm=0.0)
        batch = {k: v.to(dev) for k, v in token_batch(TokenDataConfig(
            cfg.vocab_size, RESUME_S, RESUME_B, seed=0), 0).items()}
        step = trainer.make_dp_train_step(model, ocfg, group)
        opt, fb = adamw.init(ocfg, params), compress.init_feedback(params)
        step(params, opt, fb, batch)                  # warm-up
        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        sync()
        t = time.perf_counter()
        p2, _, _, m = step(params, opt, fb, batch)
        sync()
        step_ms = 1e3 * (time.perf_counter() - t)

        def digest(tree):
            h = hashlib.sha256()
            for leaf in T.leaves(tree):
                h.update(leaf.detach().cpu().contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
            out = [None] * world
            dist.all_gather_object(out, h.hexdigest())
            return out
        digests = digest(p2)
        m32 = build_model(dataclasses.replace(cfg, param_dtype="float32"))
        p32 = m32.init(torch.Generator(device=dev).manual_seed(0))
        q32, o32, _, _ = trainer.make_dp_train_step(m32, ocfg, group)(
            p32, adamw.init(ocfg, p32), compress.init_feedback(p32), batch)
        digests32 = digest((q32, o32.mu))
        del p32, q32
        g = torch.Generator(device=dev).manual_seed(rank)
        like = T.tree_map(lambda p: torch.randn(p.shape, generator=g,
                                                device=dev), params)
        reduce_ms = {}
        for kind in ("compressed", "plain", "plain", "compressed"):
            sync()
            t = time.perf_counter()
            T.tree_map(lambda g: trainer.reduce_mean(
                g, groups, kind == "compressed"), like)
            sync()
            reduce_ms.setdefault(kind, []).append(
                1e3 * (time.perf_counter() - t))
        return dict(params=p2, loss=float(m["loss"]), step_ms=step_ms,
                    digests=digests, digests32=digests32, mu32=o32.mu,
                    reduce_ms=reduce_ms,
                    n_leaves=len(T.leaves(params)),
                    n_params=sum(p.numel() for p in T.leaves(params)))
    finally:
        dist.destroy_process_group()


def dp_follower(rank: int, world: int, init: str, device: str,
                pod: bool = False) -> None:
    """A spawned rank of phase 19c (19d with ``pod``): ``dp_rank``, its
    results dropped (an exception ends the process with a non-zero
    exit)."""
    dp_rank(rank, world, init, device, pod)


def phase_train_dp(torch, dev, pod: bool = False):
    """Phase 19c: the DP trainer on the card, DP_RANKS ranks sharing it
    over gloo (the rule of ``launch.mesh.collective_backend``: one card for
    two ranks), through a file store under build/ (phase 13's
    arrangement). Holds the params bitwise equal on every rank after the
    step, and within DP_ATOL of ``make_train_step`` on the whole batch in
    this process (the reference test's tolerance: int8-compressed
    gradients). A first AdamW step moves each param by about lr whatever
    its gradient, so the params cannot show a wrong reduction; the first
    moment (1 - b1) g can: the float32 step's moments, bitwise equal on
    every rank, are held within ``mu_bound`` of ``make_train_step``'s.
    Logs the step's ms and the reduction's. With ``pod``, phase 19d: the
    same on a (2 pod x 2 data) mesh of 4 ranks, the reduction a plain mean
    over 'pod' then the compressed mean over 'data', so the moments' bound
    is ``mu_bound`` over the 2 shards of 'data' (the pod mean is exact to
    float32 orders, which the bound's dg covers)."""
    import torch.multiprocessing as mp
    from repro_torch import tree as T
    from repro_torch.data.synthetic import TokenDataConfig, token_batch
    from repro_torch.launch import train
    from repro_torch.models.model import build_model, make_train_step
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    tag, world = ("19d", 4) if pod else ("19c", DP_RANKS)
    n_data = 2 if pod else DP_RANKS
    store = ROOT / "build" / f"dp-store-{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    init = f"file://{store}"
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dp_follower,
                         args=(r, world, init, dev.type, pod))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        res = dp_rank(0, world, init, dev.type, pod)
    finally:
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if store.exists():
            store.unlink()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        fail(f"{tag}: DP ranks exited with {codes}")
    if len(set(res["digests"])) != 1 or len(set(res["digests32"])) != 1:
        fail(f"{tag}: the ranks' params or moments differ after the step: "
             f"{res['digests']}, float32 {res['digests32']}")
    cfg = train.preset_config(RESUME_ARCH, "100m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ocfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=4, clip_norm=0.0)
    batch = {k: v.to(dev) for k, v in token_batch(TokenDataConfig(
        cfg.vocab_size, RESUME_S, RESUME_B, seed=0), 0).items()}
    p_ref, _, m_ref = make_train_step(model, ocfg)(
        params, adamw.init(ocfg, params), batch)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(T.leaves(p_ref), T.leaves(res["params"])))
    del p_ref
    m32 = build_model(dataclasses.replace(cfg, param_dtype="float32"))
    p32 = m32.init(torch.Generator(device=dev).manual_seed(0))
    _, o32, _ = make_train_step(m32, ocfg)(p32, adamw.init(ocfg, p32),
                                           batch)
    mu_excess, mu_ratio = -math.inf, 0.0
    for got, want in zip(T.leaves(res["mu32"]), T.leaves(o32.mu)):
        err = (got.double() - want.double()).abs()
        bound = mu_bound(want, n_data)
        mu_excess = max(mu_excess, float((err - bound).max()))
        mu_ratio = max(mu_ratio, float((err / bound).max()))
    del p32, o32
    log(f"{tag} {world} ranks{' (2 pod x 2 data)' if pod else ''} "
        f"({res['n_params'] / 1e6:.1f} M params in "
        f"{res['n_leaves']} leaves): params equal on every rank (SHA-256 "
        f"{res['digests'][0][:16]}); loss {res['loss']:.5f} vs "
        f"{float(m_ref['loss']):.5f} on the whole batch; max |param - "
        f"make_train_step's| {diff:.3g} (tolerance {DP_ATOL}); float32 "
        f"step: moments equal on every rank, |mu - make_train_step's| at "
        f"most {mu_ratio:.3g} of its element's bound; DP step "
        f"{res['step_ms']:.1f} ms; the gradient reduction of every leaf "
        f"(ms, turns; {'a plain mean over pod, then ' if pod else ''}the "
        f"compressed or the plain mean{' over data' if pod else ''}): "
        f"compressed {res['reduce_ms']['compressed']}, plain "
        f"{res['reduce_ms']['plain']}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if abs(res["loss"] - float(m_ref["loss"])) > 1e-3 or diff > DP_ATOL \
            or mu_excess > 0:
        fail(f"{tag}: the DP step differs from make_train_step: loss "
             f"{res['loss']} vs {float(m_ref['loss'])}, params by {diff}, "
             f"first moments by up to {mu_ratio} of their bound")
    return res


# ---------------------------------------------------------------------------
# phase 11s: the sharded LM
# ---------------------------------------------------------------------------

SHARDED_ARCH = "h2o-danube-1.8b"  # phase 11s: full width and depth ...
SHARDED_MESH = (1, 4)             # ... on ('data', 'model') gloo ranks
SHARDED_REQ = (4, 512, 8)         # requests, prompt tokens, generated
SEQ_SPLIT_STEPS = 2               # 11s: decode steps over a SeqKVCache


def sharded_reckoning(cfg, b, s) -> dict:
    """The collectives of phase 11s's windows on each rank, by kind: calls
    and bytes, written from the shapes (``models/transformer.py``'s
    docstring). A prefill of S split over 'model' (m ranks): per layer an
    all_gather of the normed input (B, S, d) before the attention and the
    MLP and a reduce_scatter of each row-parallel output into (B, S / m,
    d); the embedding's all_reduce (B, S, d); the last token's broadcast
    (B, 1, d); the greedy token's all_gather of m (value, index) float64
    pairs a row. A decode step (S = 1, whole): per layer 2 all_reduces of
    (B, 1, d), the embedding's, and the greedy all_gather. bf16
    activations."""
    m, d, n = SHARDED_MESH[1], cfg.d_model, cfg.n_layers
    act = cfg.dtype.itemsize
    pairs = m * b * 2 * 8
    prefill = {"all_gather": [2 * n + 1, 2 * n * b * s * d * act + pairs],
               "reduce_scatter": [2 * n, 2 * n * b * (s // m) * d * act],
               "all_reduce": [1, b * s * d * act],
               "broadcast": [1, b * d * act]}
    decode = {"all_gather": [1, pairs],
              "all_reduce": [2 * n + 1, (2 * n + 1) * b * d * act]}

    def fmt(w):
        return {k: {"calls": c, "bytes": x} for k, (c, x) in sorted(w.items())}
    return {"prefill": fmt(prefill), "decode": fmt(decode)}


def cache_kinds(tree) -> set:
    """The type names of the layer caches in a model's cache tree."""
    if isinstance(tree, dict):
        return set().union(*map(cache_kinds, tree.values()))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {type(tree).__name__}
    if isinstance(tree, (list, tuple)):
        return set().union(*map(cache_kinds, tree))
    return set()


def seq_split_run(torch, model, params, tokens, teacher, slots, coll,
                  sync, keep=None) -> dict:
    """Phase 11s's sequence-split run on a rank, under its mesh: the
    cache split on the sequence over 'model' (``init_cache(...,
    seq_split=True)``: ``attention.SeqKVCache``, slots / m a rank, the
    JAX package's decode layout), float32; a prefill, then
    SEQ_SPLIT_STEPS decode steps teacher-forced with the one-process
    tokens, each layer's attention the kernel over the rank's slots
    (float32 q and K/V: the decode route) combined by its lse over
    'model'. The decode steps' flash_attention launches (the counts set
    to 0 just before, read just after), each window's collectives, the
    last-token logits and the seconds are kept; a list ``keep`` gets a
    copy of the first decode step's layer-0 call ``(q, k, v, kw)``."""
    from repro_torch.kernels import ops
    t = time.perf_counter()
    real = ops.flash_attention

    def record(q, k, v, **kw):
        if not keep:
            keep.append((q.clone(), k.clone(), v.clone(),
                         {x: y for x, y in kw.items() if x != "return_lse"}))
        return real(q, k, v, **kw)
    c = model.init_cache(tokens.shape[0], slots, dtype=torch.float32,
                         device=tokens.device, seq_split=True)
    kinds = sorted(cache_kinds(c))
    coll.reset()
    logits, c = model.prefill(params, tokens, c)
    rows = [logits[:, -1].float().cpu()]
    windows = {"prefill": coll.as_dict()}
    sync()
    if keep is not None:
        ops.flash_attention = record
    ops.reset_launch_counts()
    coll.reset()
    try:
        for i in range(SEQ_SPLIT_STEPS):
            logits, c = model.decode(params, teacher[:, i:i + 1], c)
            rows.append(logits[:, -1].float().cpu())
    finally:
        ops.flash_attention = real
    sync()
    launches = ops.launch_counts()["flash_attention"]
    windows["decode"] = coll.as_dict()
    return dict(rows=torch.stack(rows), launches=launches, windows=windows,
                kinds=kinds, seconds=time.perf_counter() - t)


def sharded_rank(rank: int, world: int, init: str, device: str,
                 teacher=None, eng=None) -> dict | None:
    """One rank of phase 11s: rank 0 is this process and brings the
    one-process run's greedy tokens (``teacher``) and phase 4's engine
    (``eng``); the others are spawned with ``sharded_follower``. Each rank
    draws danube's whole param tree from seed 0 on the card, as the
    one-process run did, keeps its blocks (``sharding.blocks_of``, no
    collective) and frees the rest; under ``sharding.use_mesh``: a
    warm-up generate of 2 tokens, then the counted
    ``launch.serve.generate`` with retrieval (every rank encodes its
    logits block, rank 0 alone runs the scheduler over the engine; every
    launch count and collective count set to 0 just before, read just
    after; rank 0 records its flash_attention calls), then the held run:
    a prefill and the decode steps teacher-forced with the one-process
    tokens, each window's collectives and its logits block kept; then the
    sequence-split run (``seq_split_run``; rank 0 records its first decode
    call). Returns, on rank 0, every rank's results."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import StreamingScheduler, bucket_ladder
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, greedy
    dev = lmesh.init_shard_group(rank, world, init_method=init,
                                 device=device, timeout_s=MESH_TIMEOUT_S)
    b, s, n_gen = SHARDED_REQ

    def sync():
        torch.cuda.synchronize(dev)
    try:
        mesh = lmesh.make_mesh(SHARDED_MESH, ("data", "model"), device=device)
        box = [teacher, None if eng is None else eng.icfg.dim]
        dist.broadcast_object_list(box, src=0)
        teacher, dim = box[0].to(dev), box[1]
        cfg = get_config(SHARDED_ARCH)
        model = build_model(cfg)
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        whole = model.init(gen)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=dev)
        with sharding.use_mesh(mesh):
            params = sharding.blocks_of(whole, model.specs())
        del whole
        sync()
        torch.cuda.empty_cache()
        draw_s = time.perf_counter() - t
        weights = sum(x.numel() * x.element_size() for x in leaves(params))
        torch.cuda.reset_peak_memory_stats(dev)

        def cache():
            return model.init_cache(b, s + n_gen, dtype=torch.float32,
                                    device=dev)
        calls = []
        real = ops.flash_attention

        def record(q, k, v, **kw):
            if not calls:                 # layer 0 of the counted prefill
                calls.append((q.clone(), k.clone(), v.clone(), kw))
            return real(q, k, v, **kw)
        coll = sharding.collectives()
        sched = None if eng is None else StreamingScheduler(
            eng, buckets=bucket_ladder(b), fill_threshold=max(b // 2, 1),
            wait_limit_s=5e-3)
        with sharding.use_mesh(mesh):
            enc = serve.mean_pool_encoder(params, dim,
                                          vocab=cfg.vocab_padded)
            serve.generate(model, params, tokens, 2, cache())     # warm-up
            c = cache()
            sync()
            dist.barrier()
            if rank == 0:
                ops.flash_attention = record
            ops.reset_launch_counts()
            coll.reset()
            try:
                out = serve.generate(model, params, tokens, n_gen, c,
                                     scheduler=sched, encoder=enc)
            finally:
                ops.flash_attention = real
            launches = ops.launch_counts()
            counted = coll.as_dict()
            # the held run: decode teacher-forced with one process's tokens
            c = cache()
            coll.reset()
            logits, c = model.prefill(params, tokens, c)
            toks = [greedy(logits, cfg, b)]
            windows = {"prefill": coll.as_dict()}
            rows = [logits[:, -1].float().cpu()]
            for i in range(n_gen - 1):
                coll.reset()
                logits, c = model.decode(params, teacher[:, i:i + 1], c)
                toks.append(greedy(logits, cfg, b))
                rows.append(logits[:, -1].float().cpu())
            windows["decode"] = coll.as_dict()
            seq_calls = [] if rank == 0 else None
            seq = seq_split_run(torch, model, params, tokens, teacher,
                                s + n_gen, coll, sync, seq_calls)
        sync()
        mine = dict(coord=list(mesh.get_coordinate()), weights=weights,
                    peak=torch.cuda.max_memory_allocated(dev),
                    launches=launches, counted=counted, windows=windows,
                    rows=torch.stack(rows), toks=torch.cat(toks, 1).cpu(),
                    gen_tokens=out.tokens.cpu(), prefill_s=out.prefill_s,
                    decode_s=out.decode_s, draw_s=draw_s,
                    retrieve_s=out.retrieve_s, ids=out.report.ids,
                    queries=out.queries, seq=seq)
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            return dict(ranks=every, call=calls[0] if calls else None,
                        seq_call=seq_calls[0] if seq_calls else None)
        return None
    finally:
        dist.destroy_process_group()


def sharded_follower(rank: int, world: int, init: str, device: str) -> None:
    """A spawned rank of phase 11s: ``sharded_rank``, nothing returned (an
    exception ends the process with a non-zero exit)."""
    sharded_rank(rank, world, init, device)


def retrieval_reckoning(cfg, b) -> dict:
    """The collectives retrieval adds to 11s's counted generate on each
    rank: the encoder's all_reduces over 'model' (the rows' maxima (b, 1)
    and the (b, d + 1) ``exp @ emb`` partials beside the sums), float32,
    with the batch whole over 'data' (1 rank); then one broadcast of the
    origin's report (pickled: its bytes are the report's, not a shape's,
    and are held equal across ranks)."""
    return {"all_reduce": [2, b * 4 + b * (cfg.d_model + 1) * 4],
            "broadcast_object": [1, None]}


def phase_sharded_lm(torch, dev, eng) -> tuple[int, dict, int, dict]:
    """Phase 11s: the sharded LM (tensor parallelism over 'model') serving
    h2o-danube-1.8b at full width and depth on a (1 data x 4 model) mesh
    of gloo ranks sharing the card (this process and 3 spawned; see the
    module's docstring), with retrieval into phase 4's engine (held
    in this process). Returns (rank 0's flash_attention launches in the
    counted run, the kernel's timing row on rank 0's layer-0 call, rank
    0's launches in the sequence-split decode steps, the decode route's
    timing row on rank 0's first call there)."""
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn
    from repro_torch.models.model import build_model
    cfg = get_config(SHARDED_ARCH)
    b, s, n_gen = SHARDED_REQ
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    want = sharded_reckoning(cfg, b, s)
    log(f"11s reckoning a rank (from shapes): weights "
        f"{cfg.param_count() * cfg.dtype.itemsize / world / 1e9:.3f} GB "
        f"(norms left out); collectives a prefill {json.dumps(want['prefill'])}"
        f", a decode step {json.dumps(want['decode'])}")
    # the one-process run on the same draw: its logits and greedy tokens
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    c = model.init_cache(b, s + n_gen, dtype=torch.float32, device=dev)
    logits, c = model.prefill(params, tokens, c)
    one_toks = [torch.argmax(logits[:, -1:], -1).to(torch.int32)]
    one_rows = [logits[:, -1].float().cpu()]
    for _ in range(n_gen - 1):
        logits, c = model.decode(params, one_toks[-1], c)
        one_toks.append(torch.argmax(logits[:, -1:], -1).to(torch.int32))
        one_rows.append(logits[:, -1].float().cpu())
    teacher = torch.cat(one_toks, 1).cpu()
    one_rows = torch.stack(one_rows)
    del params, c, logits, tokens
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    store = ROOT / "build" / f"sharded-store-{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    init = f"file://{store}"
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    t = time.perf_counter()
    procs = [ctx.Process(target=sharded_follower,
                         args=(r, world, init, dev.type))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = sharded_rank(0, world, init, dev.type, teacher=teacher,
                           eng=eng)
    finally:
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if store.exists():
            store.unlink()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        fail(f"11s: ranks exited with {codes}")
    ranks = out["ranks"]
    r0 = ranks[0]
    log(f"11s {world} ranks ran in {time.perf_counter() - t:.1f} s (3 "
        f"spawned); each drew the whole tree and kept its blocks in "
        f"{', '.join(f'{r['draw_s']:.1f}' for r in ranks)} s; weights a "
        f"rank {', '.join(f'{r['weights'] / 1e9:.3f}' for r in ranks)} GB, "
        f"peak allocated after the draw "
        f"{', '.join(f'{r['peak'] / 2**30:.2f}' for r in ranks)} GiB")
    log(f"11s generate B={b} prompt={s} gen={n_gen} on rank 0: prefill "
        f"{r0['prefill_s'] * 1e3:.2f} ms, decode "
        f"{r0['decode_s'] * 1e3 / (n_gen - 1):.3f} ms per step; launches by "
        f"rank {json.dumps([r['launches'] for r in ranks])}; its "
        f"collectives on rank 0 {json.dumps(r0['counted'])}")
    print("kernels sharded " + json.dumps(
        {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}),
        flush=True)
    for k, r in enumerate(ranks):
        if r["launches"]["flash_attention"] != cfg.n_layers:
            fail(f"11s: rank {k} launched flash_attention "
                 f"{r['launches']['flash_attention']} times in the counted "
                 f"run, expected one a layer of the prefill ({cfg.n_layers})")
        got = r["windows"]
        if got != want:
            fail(f"11s: rank {k}'s collectives {json.dumps(got)} differ from "
                 f"the reckoning {json.dumps(want)}")
        total = {kind: {"calls": want["prefill"].get(kind, {}).get("calls", 0)
                        + (n_gen - 1) * want["decode"].get(kind, {}).get(
                            "calls", 0),
                        "bytes": want["prefill"].get(kind, {}).get("bytes", 0)
                        + (n_gen - 1) * want["decode"].get(kind, {}).get(
                            "bytes", 0)}
                 for kind in sorted(set(want["prefill"]) | set(
                     want["decode"]))}
        for kind, (calls, nbytes) in retrieval_reckoning(cfg, b).items():
            t = total.setdefault(kind, {"calls": 0, "bytes": 0})
            t["calls"] += calls
            t["bytes"] += r0["counted"][kind]["bytes"] if nbytes is None \
                else nbytes
        total = dict(sorted(total.items()))
        if r["counted"] != total:
            fail(f"11s: rank {k}'s collectives in generate "
                 f"{json.dumps(r['counted'])} differ from the reckoning "
                 f"{json.dumps(total)}")
        if not torch.equal(r["toks"], ranks[0]["toks"]) or not torch.equal(
                r["gen_tokens"], ranks[0]["gen_tokens"]):
            fail(f"11s: rank {k}'s greedy tokens differ from rank 0's")
    SAVED["11s"] = r0["windows"]          # phase 21b's witness
    log(f"11s collectives by rank equal the reckoning in every window "
        f"(a prefill, a decode step, generate's {n_gen - 1} steps and its "
        f"retrieval)")
    # retrieval: rank 0 served the queries every rank encoded
    res, _ = eng.search(torch.from_numpy(r0["queries"]).to(dev))
    same = r0["ids"] == res.ids.cpu().numpy()
    log(f"11s retrieval on the mesh ({r0['retrieve_s'] * 1e3:.2f} ms on rank "
        f"0): ids equal engine.search of the encoded queries in "
        f"{int(same.sum())} of {same.size} slots")
    if not same.all():
        fail("11s: the mesh's retrieved ids differ from engine.search")
    for k, r in enumerate(ranks):
        if not (np.array_equal(r["ids"], r0["ids"])
                and np.array_equal(r["queries"], r0["queries"])):
            fail(f"11s: rank {k}'s queries or ids differ from rank 0's")
    # the held run's logits, assembled from the vocabulary blocks
    blocks = sorted(ranks, key=lambda r: r["coord"][1])
    got = torch.cat([r["rows"] for r in blocks], dim=-1)
    v = slice(0, cfg.vocab_size)
    for i in range(n_gen):
        g, w = got[i, :, v], one_rows[i, :, v]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        tok = ranks[0]["toks"][:, i].long()
        reach = w.gather(-1, tok[:, None])[:, 0] >= w.max(-1).values \
            - 0.05 * scale
        what = "prefill" if i == 0 else f"decode step {i}"
        log(f"11s {what} (teacher-forced) vs one process: max |diff| "
            f"{err:.4f}, max |logit| {scale:.4f} (ratio {err / scale:.4f}); "
            f"greedy tokens equal in {int((tok == teacher[:, i]).sum())} of "
            f"{b} rows")
        if err > 0.05 * scale:
            fail(f"11s {what}: the sharded logits differ from one process's "
                 f"by {err:.4f} > 5% of their largest magnitude {scale:.4f}")
        if not reach.all():
            fail(f"11s {what}: the sharded greedy token is not within the "
                 f"bound of the one-process row's maximum in "
                 f"{int((~reach).sum())} rows")
    same = int((ranks[0]["gen_tokens"] == teacher).sum())
    log(f"11s generate's own greedy tokens equal the one-process run's in "
        f"{same} of {teacher.numel()}")
    seq_launches = hold_seq_split_run(torch, cfg, ranks, one_rows)
    # rank 0's layer-0 call: its 8 / 2 heads, held and timed
    row = kernel_row(torch, "flash_attention/sharded",
                     "11s rank 0 layer 0", out["call"])
    # rank 0's first sequence-split decode call: float32 q and K/V over
    # its 130 slots, held and timed
    if out["seq_call"] is None:
        fail("11s: rank 0 recorded no sequence-split decode call")
    q, k = out["seq_call"][:2]
    if not flash_attn.decode_route(q.dtype, q.shape[1], q.shape[2],
                                   k.shape[2]):
        fail("11s: rank 0's sequence-split decode call is off the decode "
             "route")
    seq_row = decode_row(torch, "11s rank 0 decode step 1 layer 0",
                         *out["seq_call"])
    return r0["launches"]["flash_attention"], row, seq_launches, seq_row


def hold_seq_split_run(torch, cfg, ranks, one_rows) -> int:
    """Phase 11s's sequence-split run (``seq_split_run``) held: every
    rank's cache a SeqKVCache, its decode steps one flash_attention launch
    a layer a step, its prefill and each step's logits (assembled from the
    vocabulary blocks) within 5% of the largest |logit| of the one-process
    run's (phase 11's bound); each window's collectives and the run's
    seconds logged. Returns rank 0's launches in the decode steps."""
    b, s, n_gen = SHARDED_REQ
    want = SEQ_SPLIT_STEPS * cfg.n_layers
    for k, r in enumerate(ranks):
        seq = r["seq"]
        if seq["kinds"] != ["SeqKVCache"]:
            fail(f"11s: rank {k}'s sequence-split cache holds "
                 f"{seq['kinds']}, not a SeqKVCache a layer")
        if seq["launches"] != want:
            fail(f"11s: rank {k} launched flash_attention {seq['launches']} "
                 f"times in {SEQ_SPLIT_STEPS} sequence-split decode steps, "
                 f"expected one a layer a step ({want})")
    r0 = ranks[0]["seq"]
    log(f"11s sequence-split run ({s + n_gen} slots, "
        f"{(s + n_gen) // SHARDED_MESH[1]} a rank, float32): a prefill and "
        f"{SEQ_SPLIT_STEPS} decode steps in "
        f"{', '.join(f'{r['seq']['seconds']:.2f}' for r in ranks)} s by rank;"
        f" rank 0's collectives a window {json.dumps(r0['windows'])}; "
        f"flash_attention launches by rank in the decode steps "
        f"{[r['seq']['launches'] for r in ranks]}")
    blocks = sorted(ranks, key=lambda r: r["coord"][1])
    got = torch.cat([r["seq"]["rows"] for r in blocks], dim=-1)
    v = slice(0, cfg.vocab_size)
    for i in range(SEQ_SPLIT_STEPS + 1):
        g, w = got[i, :, v], one_rows[i, :, v]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        what = "prefill" if i == 0 else f"decode step {i}"
        log(f"11s sequence-split {what} (teacher-forced) vs one process: "
            f"max |diff| {err:.4f}, max |logit| {scale:.4f} (ratio "
            f"{err / scale:.4f})")
        if err > 0.05 * scale:
            fail(f"11s sequence-split {what}: the logits differ from one "
                 f"process's by {err:.4f} > 5% of their largest magnitude "
                 f"{scale:.4f}")
    return ranks[0]["seq"]["launches"]


# ---------------------------------------------------------------------------
# phase 19s: the sharded train step
# ---------------------------------------------------------------------------

SHARDED_TRAIN_MESH = (2, 2)       # phase 19s: ('data', 'model') gloo ranks
SHARDED_TRAIN = (1, 4, 512)       # steps, rows, tokens a row (19's 16 x 8 x
#                                   2,048 cut for gloo's time, and to 1
#                                   step for the smoke's; width and depth
#                                   whole)
BF16_U = 2.0 ** -8                # bf16's unit roundoff


def local_leaves(model, grid) -> list:
    """(this rank's block shape, dtype) of each param leaf on a mesh of
    ``grid``'s shape (``launch.mesh.MeshShape``), from the shapes alone."""
    from repro_torch import tree as T
    from repro_torch.distributed import sharding
    return [(sharding.local_shape(x.shape, ns.spec, grid), x.dtype)
            for x, ns in zip(T.leaves(model.shapes()),
                             T.leaves(model.shardings(grid)))]


def sharded_train_reckoning(cfg, model, b, s) -> dict:
    """The collectives of one step of phase 19s on each rank, by kind:
    calls and bytes (of the tensor each rank holds after the call),
    written from the shapes (``distributed/sharding.py``'s and
    ``models/transformer.py``'s docstrings). A micro-batch holds b / data
    rows of S tokens a rank, S split over 'model' (m ranks) between the
    blocks, bf16 activations. Forward: the embedding's all_reduce (rows,
    S, d); a layer's 2 all_gathers of the normed input (rows, S, d) and 2
    reduce_scatters of the row-parallel outputs (rows, S / m, d); the
    head's all_gather; the loss's all_reduces (the rows' maxima (rows, S,
    1) and (sum of exponentials, gold logit) (2, rows, S) over 'model',
    its (sum, count) over 'data'), float32. The backward recomputes each
    layer's 2 all_gathers and its attention's reduce_scatter (remat; the
    recompute stops at the last tensor the backward saved, before the
    MLP's reduce_scatter), and transposes: each reduce_scatter an
    all_gather, each all_gather of a block input a reduce_scatter (its
    readers compute a part a rank), the head's too, the embedding's
    slice into S an all_gather; the S-split norms' gradients (d,) are
    all-reduced over 'model', 2 a layer and the final norm's, float32.
    After the accum_steps micro-batches, each leaf's float32 gradient
    sum is all-reduced over 'data' (the rank's block), and the global
    norm's sum of squares of the split leaves over 'model'."""
    from repro_torch.launch import mesh as lmesh
    data, m = SHARDED_TRAIN_MESH
    rows = b // cfg.accum_steps // data
    d, n, act = cfg.d_model, cfg.n_layers, cfg.dtype.itemsize
    whole, part = rows * s * d * act, rows * (s // m) * d * act
    micro = {"all_gather": [6 * n + 2, (6 * n + 2) * whole],
             "reduce_scatter": [5 * n + 1, (5 * n + 1) * part],
             "all_reduce": [2 * n + 5, whole + rows * s * 4
                            + 2 * rows * s * 4 + 2 * 4 + (2 * n + 1) * d * 4]}
    grid = lmesh.MeshShape(("data", "model"), SHARDED_TRAIN_MESH)
    leaves = local_leaves(model, grid)
    out = {k: [c * cfg.accum_steps, x * cfg.accum_steps]
           for k, (c, x) in micro.items()}
    out["all_reduce"][0] += len(leaves) + 1
    out["all_reduce"][1] += sum(math.prod(loc) * 4 for loc, _ in leaves) \
        + 4
    return {k: {"calls": c, "bytes": x} for k, (c, x) in sorted(out.items())}


def bf16_mu_bound(mu_ref):
    """Per-element bound on |mu - mu_ref| of 19s's first moments after
    step 1 against the one-process run's: ``mu_bound``'s rule for a leaf
    that takes the plain mean (no int8 step), dg + 1e-6 of the leaf's
    largest |mu|, with dg = 16 BF16_U of it for GRAD_RTOL: both runs'
    gradients are bf16 tensors made by other partial sums and summed over
    two micro-batches in float32 (a rounding of u a micro-batch, and each
    activation's cotangent rounded to bf16 at every op of a 24-layer
    backward, which compound), so a gradient's error is a few u of its
    leaf's scale, not float32's GRAD_RTOL. One number a leaf."""
    top = float(mu_ref.double().abs().max())
    return 16 * BF16_U * top + 1e-6 * top


def sharded_train_rank(rank: int, world: int, init: str, device: str,
                       ref_mu=None) -> dict | None:
    """One rank of phase 19s: rank 0 is this process and brings the
    one-process run's first moments after step 1 (``ref_mu``, host
    tensors); the others are spawned with ``sharded_train_follower``.
    Under ``launch.train.run(..., mesh=)`` every rank draws danube's whole
    tree from seed 0 on the card, keeps its blocks and trains them
    (SHARDED_TRAIN steps of ``token_batch`` tokens, accum_steps 2); each
    step is timed, its metrics kept (the bits too), its flash_attention
    launches and collectives counted (launch counts set to 0 just before
    the run, read after each step), the moments after step 1 copied to the
    host. Then every rank's moment blocks go to rank 0, which holds each
    against the one-process run's block at that rank's coordinate
    (``bf16_mu_bound``). Returns, on rank 0, every rank's results."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    dev = lmesh.init_shard_group(rank, world, init_method=init,
                                 device=device, timeout_s=MESH_TIMEOUT_S)
    steps, b, s = SHARDED_TRAIN
    try:
        mesh = lmesh.make_mesh(SHARDED_TRAIN_MESH, ("data", "model"),
                               device=device)
        calls, metrics, bits, step_ms, launches, colls, mu1 = \
            [], [], [], [], [], [], []
        real_flash, real_step = ops.flash_attention, train.make_train_step
        coll = sharding.collectives()

        def rec_flash(q, k, v, **kw):
            if rank == 0 and not calls:   # layer 0, the first micro-batch
                calls.append((q.detach().clone(), k.detach().clone(),
                              v.detach().clone(),
                              {x: y for x, y in kw.items()
                               if x != "return_lse"}))
            return real_flash(q, k, v, **kw)

        def factory(model, ocfg, donate=False):
            fn = real_step(model, ocfg, donate)

            def step(*args):
                torch.cuda.synchronize(dev)
                before = ops.launch_counts()["flash_attention"]
                coll.reset()
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize(dev)
                step_ms.append(1e3 * (time.perf_counter() - t))
                colls.append(coll.as_dict())
                launches.append(ops.launch_counts()["flash_attention"]
                                - before)
                metrics.append({k: float(v) for k, v in out[2].items()})
                bits.append({k: v.float().cpu().numpy().tobytes().hex()
                             for k, v in sorted(out[2].items())})
                if not mu1:     # the moments after step 1, before step 2
                    mu1.extend(x.detach().to("cpu", copy=True)
                               for x in T.leaves(out[1].mu))
                return out
            return step
        torch.cuda.reset_peak_memory_stats(dev)
        ops.flash_attention, train.make_train_step = rec_flash, factory
        ops.reset_launch_counts()
        t = time.perf_counter()
        try:
            losses = train.run(TRAIN_ARCH, "full", steps, b, s, None, 0,
                               False, log_every=1, device=device, mesh=mesh)
        finally:
            ops.flash_attention, train.make_train_step = real_flash, \
                real_step
        run_s = time.perf_counter() - t
        counted = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        # every rank's moment blocks to rank 0, one leaf at a time
        coords = [None] * world
        dist.all_gather_object(coords, list(mesh.get_coordinate()))
        held = []
        model_specs = None
        if rank == 0:
            from repro_torch.configs import get_config
            from repro_torch.models.model import build_model
            model = build_model(get_config(TRAIN_ARCH))
            model_specs = [ns.spec for ns in T.leaves(model.shardings(mesh))]
        for i, x in enumerate(mu1):
            got = [torch.empty_like(x) for _ in range(world)] \
                if rank == 0 else None
            dist.gather(x, got, dst=0)
            if rank != 0:
                continue
            want = ref_mu[i]
            for r, g in enumerate(got):
                w = want
                for dim, e in enumerate(model_specs[i]):
                    if e is not None:
                        n = w.shape[dim] // SHARDED_TRAIN_MESH[1]
                        w = w.narrow(dim, coords[r][1] * n, n)
                wd, gd = w.to(dev), g.to(dev)
                err = (gd.double() - wd.double()).abs()
                bound = bf16_mu_bound(wd)
                top = float(wd.double().abs().max())
                held.append((i, r, float(err.max()) / max(top, 1e-30),
                             float(err.max()) / max(bound, 1e-300),
                             bool((err <= bound).all())))
                del wd, gd, err
        mine = dict(coord=list(mesh.get_coordinate()), losses=losses,
                    metrics=metrics, bits=bits, step_ms=step_ms,
                    launches=launches, colls=colls, counted=counted,
                    peak=peak, run_s=run_s)
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            return dict(ranks=every, held=held,
                        call=calls[0] if calls else None)
        return None
    finally:
        dist.destroy_process_group()


def sharded_train_follower(rank: int, world: int, init: str,
                           device: str) -> None:
    """A spawned rank of phase 19s: ``sharded_train_rank``, nothing
    returned (an exception ends the process with a non-zero exit)."""
    sharded_train_rank(rank, world, init, device)


def lse_kernel_row(torch, name, label, call):
    """A training forward call ``(q, k, v, kw)`` (the kernel asked for the
    rows' logsumexp) launched again on its inputs: its output held as in
    phase 11 (recorded under ``name``), its lse by ``hold_lse``, timed with
    lse beside its bound, the twin with lse and SDPA's flash backend on
    the same work. Returns the timing row."""
    from repro_torch.kernels import flash_attn, ref
    q, k, v, kw = call
    full = (f"{label}: q {tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
            f"{tuple(k.shape)} {str(k.dtype)[6:]}, {kw}")
    got = flash_attn.flash_attention(q, k, v, **kw)
    hold_bf16_attention(torch, full, got, q, k, v, kw, name)
    hold_lse(torch, name, full, got, q, k, v, kw)
    del got
    row = timed_row(
        torch, f"{name} (with lse) {label} B={q.shape[0]} Sq={q.shape[1]} "
        f"{q.shape[2]}/{k.shape[2]} heads, plain = the twin with lse",
        lambda: flash_attn.flash_attention(q, k, v, return_lse=True, **kw),
        lambda: ref.flash_attention_ref(q, k, v, operands=torch.bfloat16,
                                        return_lse=True, **kw), 10,
        flash_bound(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                    kw["kv_valid_len"]))
    if kw["q_offset"] != 0 or kw["kv_valid_len"] not in (None, q.shape[1]) \
            or (kw["window"] is not None and kw["window"] < q.shape[1]):
        fail(f"the SDPA yardstick assumes a causal prefill from position 0 "
             f"over its own keys, got {kw}")
    row["library_ms"] = sdpa_flash_row(torch, q, k, v, kw["causal"])
    lib = row["library_ms"]
    log(f"{name} {label}: kernel with lse {row['ms']:.5f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
        f"{row['bound_ms'] / row['ms']:.3f} of the kernel's time), twin "
        f"{row['plain_ms']:.5f}, SDPA flash "
        f"{'refused' if lib is None else f'{lib:.5f}'} ms on the device")
    return row


def phase_sharded_train(torch, dev) -> tuple[int, dict]:
    """Phase 19s: the sharded train step (autograd through the
    collectives, the vocabulary-parallel loss, AdamW on the blocks):
    h2o-danube-1.8b's full config through ``launch.train.run(...,
    mesh=)`` on a (2 data x 2 model) mesh of gloo ranks sharing the card
    (this process and 3 spawned). First the one-process run of the same
    steps on the same draw and batches (the witness: its losses, grad
    norms and first moments after step 1). Holds: loss and grad_norm
    equal on every rank bit for bit; each step's loss within 4 BF16_U of
    the one-process loss, relatively (each run's logits are bf16 numbers
    made by other partial sums, and the loss moves by at most twice a
    logit's error); the first moments after step 1 rank by rank within
    ``bf16_mu_bound`` of the one-process run's blocks; 96 flash_attention
    launches a rank a step; each rank's collectives a step equal to
    ``sharded_train_reckoning``. Returns (rank 0's flash_attention
    launches in the run, the kernel's row on rank 0's layer-0 call)."""
    import torch.multiprocessing as mp
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    steps, b, s = SHARDED_TRAIN
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    world = SHARDED_TRAIN_MESH[0] * SHARDED_TRAIN_MESH[1]
    want = sharded_train_reckoning(cfg, model, b, s)
    grid = lmesh.MeshShape(("data", "model"), SHARDED_TRAIN_MESH)
    leaves = local_leaves(model, grid)
    weights = sum(math.prod(loc) * dt.itemsize for loc, dt in leaves)
    n_loc = sum(math.prod(loc) for loc, _ in leaves)
    log(f"19s reckoning a rank (from shapes, {SHARDED_TRAIN_MESH[0]} data x "
        f"{SHARDED_TRAIN_MESH[1]} model): weights {weights / 1e9:.3f} GB, "
        f"float32 moments {2 * n_loc * 4 / 1e9:.3f} GB, the float32 "
        f"gradient sum {n_loc * 4 / 1e9:.3f} GB, one micro-batch's bf16 "
        f"gradients {weights / 1e9:.3f} GB: "
        f"{(2 * weights + 3 * n_loc * 4) / 1e9:.3f} GB a rank, "
        f"{world * (2 * weights + 3 * n_loc * 4) / 1e9:.3f} GB for the "
        f"{world}; collectives a step {json.dumps(want)}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the witness: the same steps in one process
    ref_mu, one = [], []
    real_step = train.make_train_step

    def factory(m, ocfg, donate=False):
        fn = real_step(m, ocfg, donate)

        def step(*args):
            out = fn(*args)
            one.append({k: float(v) for k, v in out[2].items()})
            if not ref_mu:
                ref_mu.extend(x.detach().to("cpu", copy=True)
                              for x in T.leaves(out[1].mu))
            return out
        return step
    t = time.perf_counter()
    train.make_train_step = factory
    try:
        one_losses = train.run(TRAIN_ARCH, "full", steps, b, s, None, 0,
                               False, log_every=1, device=dev)
    finally:
        train.make_train_step = real_step
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    log(f"19s one-process witness: {steps} steps of {b} x {s} in "
        f"{time.perf_counter() - t:.1f} s, losses {one_losses}, grad norms "
        f"{[m['grad_norm'] for m in one]}; peak {one_peak:.2f} GiB")

    store = ROOT / "build" / f"sharded-train-store-{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    init = f"file://{store}"
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    t = time.perf_counter()
    procs = [ctx.Process(target=sharded_train_follower,
                         args=(r, world, init, dev.type))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = sharded_train_rank(0, world, init, dev.type, ref_mu=ref_mu)
    finally:
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if store.exists():
            store.unlink()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        fail(f"19s: ranks exited with {codes}")
    del ref_mu
    ranks = out["ranks"]
    r0 = ranks[0]
    log(f"19s {world} ranks ran in {time.perf_counter() - t:.1f} s (3 "
        f"spawned; train.run {', '.join(f'{r['run_s']:.1f}' for r in ranks)}"
        f" s by rank, the whole draw included); peak allocated by rank "
        f"{', '.join(f'{r['peak'] / 2**30:.2f}' for r in ranks)} GiB "
        f"(the reckoning's {(2 * weights + 3 * n_loc * 4) / 2**30:.2f} GiB)")
    for i in range(steps):
        ms = [r["step_ms"][i] for r in ranks]
        log(f"19s step {i}: loss {r0['losses'][i]:.6f} (one process "
            f"{one_losses[i]:.6f}, |diff| "
            f"{abs(r0['losses'][i] - one_losses[i]):.3g}), grad_norm "
            f"{r0['metrics'][i]['grad_norm']:.6f} (one process "
            f"{one[i]['grad_norm']:.6f}); ms by rank "
            f"{', '.join(f'{x:.1f}' for x in ms)}; "
            f"{b * s / (max(ms) / 1e3):.1f} tokens/s; launches by rank "
            f"{[r['launches'][i] for r in ranks]}")
    log(f"19s rank 0's collectives a step: {json.dumps(r0['colls'][0])}")
    SAVED["19s"] = r0["colls"][0]         # phase 21b's witness
    for k, r in enumerate(ranks):
        if r["bits"] != r0["bits"]:
            fail(f"19s: rank {k}'s metrics differ from rank 0's: "
                 f"{r['metrics']} vs {r0['metrics']}")
        want_l = 2 * cfg.accum_steps * cfg.n_layers
        if r["launches"] != [want_l] * steps:
            fail(f"19s: rank {k} launched flash_attention {r['launches']} "
                 f"times by step, expected {want_l} (a forward and a "
                 f"recompute a layer, two micro-batches)")
        for i, got in enumerate(r["colls"]):
            if got != want:
                fail(f"19s: rank {k}'s collectives in step {i} "
                     f"{json.dumps(got)} differ from the reckoning "
                     f"{json.dumps(want)}")
    for i, (a, w) in enumerate(zip(r0["losses"], one_losses)):
        if not math.isfinite(a) or abs(a - w) > 4 * BF16_U * abs(w):
            fail(f"19s step {i}: the sharded loss {a} is not within "
                 f"4 u = {4 * BF16_U:.5f} of the one-process loss {w}, "
                 f"relatively")
    worst = max(out["held"], key=lambda h: h[3])
    log(f"19s first moments after step 1 against the one-process run's "
        f"blocks, {len(out['held'])} (leaf, rank) pairs: max |diff| over "
        f"the leaf's largest |mu| {max(h[2] for h in out['held']):.4g}, "
        f"at most {worst[3]:.4g} of the element's bound (leaf {worst[0]}, "
        f"rank {worst[1]})")
    if not all(h[4] for h in out["held"]):
        bad = [h[:2] for h in out["held"] if not h[4]]
        fail(f"19s: first moments outside bf16_mu_bound at (leaf, rank) "
             f"{bad}")
    log(f"19s loss and grad_norm equal on every rank bit for bit; "
        f"collectives by rank equal the reckoning in every step")
    print("kernels sharded-train " + json.dumps(
        {k: sum(r["counted"][k] for r in ranks) for k in r0["counted"]}),
        flush=True)
    row = lse_kernel_row(torch, "flash_attention/sharded-train",
                         "19s rank 0 layer 0", out["call"])
    return r0["counted"]["flash_attention"], row



# ---------------------------------------------------------------------------
# phase 20: the attention softcap on every kernel route
# ---------------------------------------------------------------------------

SOFTCAP = 50.0     # Gemma 2's published attn_logit_softcapping: a test input
SAVED: dict = {}   # what a later phase reuses of an earlier one's run


def softcap_routes(torch, dev) -> dict:
    """The softcap phase's inputs by route: (q, k, v, mask). danube's real
    layer-0 prefill inputs of phase 11 (B 8, S 2,048, 32 / 8 heads of 80,
    bf16 q, the float32 cache) on the tensor-core route, causal, and in
    float32 on the CUDA-core route; whisper's encoder shape (B 8, 1,500
    frames, 20 heads of 64, bf16) non-causal; MLA's (576, 512) at
    deepseek-v2-lite's prefill (B 8, S 2,048, 16 heads over the bf16
    latent cache, v its first 512 columns); recurrentgemma's hd 256 (B 8,
    S 3,072, 16 heads over one, window 2,048). Every route takes q scaled
    by 6, so that the scores reach the cap's bend and an uncapped kernel
    falls outside the bound (``phase_softcap``)."""
    g = torch.Generator(device=dev).manual_seed(29)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)
    q0, k0, v0, kw0 = SAVED.pop("lm_layer0")
    lat = rnd((8, 2048, 1, 576))
    return {
        "tc": (q0 * 6, k0, v0, dict(kw0)),
        "noncausal": (rnd((8, 1500, 20, 64), 6), rnd((8, 1500, 20, 64)),
                      rnd((8, 1500, 20, 64)), dict(causal=False)),
        "float32": (q0.float() * 6, k0, v0, dict(kw0)),
        "mla": (rnd((8, 2048, 16, 576), 6), lat, lat[..., :512],
                dict(causal=True)),
        "hd256": (rnd((8, 3072, 16, 256), 6), rnd((8, 3072, 1, 256)),
                  rnd((8, 3072, 1, 256)), dict(causal=True, window=2048)),
    }


def decode_row(torch, label, q, k, v, kw, time_it=True):
    """A call of the split-KV decode route (float32 q, Sq x g <= 64) held
    against the float32 plain version within ``attn_bound``, its lse by
    ``hold_lse``; with ``time_it``, timed: the kernel on the device
    (``event_ms`` behind a spin kernel, 50 calls; its two launches, the
    chunks and their combine, in one call), the plain version (one
    call), the bound (``kernels/cost.py``) and
    ``scaled_dot_product_attention`` on float32 copies of K/V made before
    the timed calls (``enable_gqa``; the mask as a boolean tensor where a
    key is masked). Returns the timing row (None without ``time_it``)."""
    from repro_torch.kernels import flash_attn, ref
    b, sq, hq, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    split = flash_attn.decode_design(b, sq, hq, hkv, sk, **kw)
    full = (f"{label} q {tuple(q.shape)}, k/v {tuple(k.shape)} "
            f"{str(k.dtype)[6:]}, {kw}, (rows, chunks) {split}")
    got = flash_attn.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    close(torch, "flash_attention/decode", full, got, want,
          attn_bound(torch, want))
    hold_lse(torch, "flash_attention/decode", full, got, q, k, v, kw)
    del got, want
    if not time_it:
        return None
    call = dict(kw, return_lse=True)
    ms = event_ms(torch, lambda: flash_attn.flash_attention(q, k, v, **call),
                  50, lead=True)
    plain_ms = event_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, return_lse=True, **kw))
    bound = flash_bound(q, k, v, kw["causal"], kw.get("window"),
                        kw.get("q_offset", 0), kw.get("kv_valid_len"))
    keys = torch.arange(sk, device=q.device)
    pos = kw.get("q_offset", 0) + torch.arange(sq, device=q.device)[:, None]
    valid = kw.get("kv_valid_len")
    ok = keys[None, :] < (sk if valid is None else valid)
    if kw["causal"]:
        ok = ok & (keys[None, :] <= pos)
    if kw.get("window"):
        ok = ok & (pos - keys[None, :] < kw["window"])
    mask = None if bool(ok.all()) else ok
    qs = q.transpose(1, 2)
    ks, vs = k.float().transpose(1, 2), v.float().transpose(1, 2)
    lib = event_ms(torch, lambda: (
        torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)), 50, lead=True)
    del ks, vs
    log(f"flash_attention/decode {label} (B {b}, {sk} slots, "
        f"{str(k.dtype)[6:]} K/V): kernel {ms:.5f} ms on the device, bound "
        f"{bound[0]:.5f} ms ({bound[1]}, {bound[0] / ms:.3f} of the "
        f"kernel's time), plain {plain_ms:.5f} ms (one call), SDPA on "
        f"float32 K/V {lib:.5f} ms on the device")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib)


def hold_seq_split_calls(torch, dev) -> None:
    """The kernel calls of a decode step over a sequence-split cache
    (``models.attention._seq_split_step``, the dry-run's decode cells) at
    full size, all on the split-KV decode route (float32 q, one row a
    request, danube's 32 / 8 heads of 80, bf16 K/V, non-causal, asked for
    the lse), each held and the rank and long forms timed
    (``decode_row``): at a danube decode_32k rank's shape (B 8 over the
    rank's 2,048 slots) the valid slots of a rolling cache (1,500), a
    window of 2,500 seen from a query 4,000 positions past the rank's
    first slot (its last 547 slots) and every slot valid ("rank"); and
    one long context, B 1 over 32,768 slots ("long"). Phase 11s holds
    and times the call its own sequence-split run made, float32 K/V."""
    g = torch.Generator(device=dev).manual_seed(2029)
    q = torch.randn((8, 1, 32, 80), generator=g, device=dev)
    k = torch.randn((8, 2048, 8, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((8, 2048, 8, 80), generator=g, device=dev).bfloat16()
    q1 = torch.randn((1, 1, 32, 80), generator=g, device=dev)
    k1 = torch.randn((1, 32768, 8, 80), generator=g, device=dev).bfloat16()
    v1 = torch.randn((1, 32768, 8, 80), generator=g, device=dev).bfloat16()
    forms = {"rolling": (q, k, v, dict(causal=False, kv_valid_len=1500)),
             "window": (q, k, v, dict(causal=False, window=2500,
                                      q_offset=4000)),
             "rank": (q, k, v, dict(causal=False)),
             "long": (q1, k1, v1, dict(causal=False))}
    for name, (qf, kf, vf, kw) in forms.items():
        decode_row(torch, f"20 seq-split decode call {name}", qf, kf, vf, kw,
                   time_it=name in ("rank", "long"))
    torch.cuda.empty_cache()


def phase_softcap(torch, dev) -> dict:
    """Phase 20: the attention softcap (cap 50) on each kernel template:
    ``flash_tc_kernel`` causal (danube's layer 0) and non-causal
    (whisper's encoder shape), the CUDA-core ``flash_fwd_kernel`` (float32
    q), ``flash_mla_kernel`` at (576, 512) and ``flash_wide_kernel`` at hd
    256 with a window.
    The path, ``models.attention.attend(..., softcap=)``, runs on each
    route's inputs with the launch counts set to 0 just before and read
    just after, route by route: one launch each. Each output is held as
    in phase 11 (bf16 q: against the capped twin with the flip term and
    the float32 plain version within ``flash_attention_rounding_bound``;
    float32 q: against the float32 plain version within ``attn_bound``),
    its lse by ``hold_lse``; the uncapped kernel's output on the same
    inputs must fall outside the bound against the capped float32 plain
    version somewhere (a kernel that ignored the cap would fail the hold);
    the kernel, its plain version (the twin for bf16 q) and
    the bound (``kernels/cost.py``) timed and logged, by CUDA events.
    ``scaled_dot_product_attention`` has no score cap: no library time.
    Then the capped backward: ``attend``'s gradients on the card against
    the CPU's at a training shape (B 2, S 512, danube's heads, bf16), each
    within ``ref.flash_attention_bwd_bound`` of float32 autograd, so the
    two within the sum of their bounds. Between the two, the calls of
    the sequence-split decode step (``hold_seq_split_calls``). Returns the
    kernels-line rows."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import attend, attend_onepass
    routes = softcap_routes(torch, dev)
    for q, k, v, kw in routes.values():
        kw["softcap"] = SOFTCAP
    outs, launches = {}, {}
    for name, (q, k, v, kw) in routes.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        outs[name] = attend(q, k, v, **kw)
        torch.cuda.synchronize()
        launches[name] = ops.launch_counts()["flash_attention"]
    print("kernels softcap " + json.dumps(launches), flush=True)
    if any(n != 1 for n in launches.values()):
        fail(f"20: attend(softcap=) launched flash_attention {launches} "
             f"times by route, expected once a route")
    rows = {}
    for name, (q, k, v, kw) in routes.items():
        kernel = f"flash_attention/softcap/{name}"
        label = (f"q {tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
                 f"{tuple(k.shape)} / {tuple(v.shape)} {str(k.dtype)[6:]}, "
                 f"{kw}")
        got = outs.pop(name)
        if q.dtype == torch.bfloat16:
            want, bound = hold_bf16_attention(torch, label, got, q, k, v, kw,
                                              kernel)
            plain = lambda: ref.flash_attention_ref(   # noqa: E731
                q, k, v, operands=torch.bfloat16, **kw)
        else:
            want = ref.flash_attention_ref(q, k, v, **kw)
            bound = attn_bound(torch, want)
            close(torch, kernel, label, got, want, bound)
            plain = lambda: ref.flash_attention_ref(q, k, v, **kw)  # noqa
        hold_lse(torch, kernel, label, got, q, k, v, kw)
        bare = ops.flash_attention(
            q, k, v, **{x: y for x, y in kw.items() if x != "softcap"})
        moved = float((got.double() - bare.double()).abs().max())
        over = int(((bare.double() - want.double()).abs() > bound).sum())
        if not over:
            fail(f"20 {kernel}: the uncapped kernel's output is within the "
                 f"bound the capped one is held to (the cap moves it by "
                 f"{moved:.4g}): a kernel that ignored the cap would pass")
        del got, want, bound, bare
        ms = event_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), 10,
                      warm=2)
        plain_ms = event_ms(torch, plain)
        bound = flash_bound(q, k, v, kw["causal"], kw.get("window"),
                            kw.get("q_offset", 0), kw.get("kv_valid_len"),
                            softcap=SOFTCAP)
        rows[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                            bound_by=bound[1], library_ms=None,
                            launches=launches[name])
        log(f"20 {kernel}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
            f"bound {bound[0]:.5f} ms ({bound[1]}) by CUDA events; the cap "
            f"moves the output by up to {moved:.4g} (uncapped kernel; "
            f"{over} elements outside the capped hold's bound); no library "
            f"call caps the scores")
        if name in ("mla", "hd256"):
            log_staged(q, k, v, kw, ms, f"20 {kernel}")
    del routes, outs
    torch.cuda.empty_cache()
    hold_seq_split_calls(torch, dev)
    # the capped backward on the card against the CPU's
    gen = torch.Generator().manual_seed(20)
    q = (6 * torch.randn((2, 512, 32, 80), generator=gen)).bfloat16()
    k = torch.randn((2, 512, 8, 80), generator=gen).bfloat16()
    v = torch.randn((2, 512, 8, 80), generator=gen).bfloat16()
    go = torch.randn((2, 512, 32, 80), generator=gen).bfloat16()
    kw = dict(causal=True, softcap=SOFTCAP)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attend_onepass(*f32, **kw), f32, go.float())
    got, bounds = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        x = [t.to(d).requires_grad_() for t in (q, k, v)]
        got[side] = torch.autograd.grad(attend(*x, **kw), x, go.to(d))
        with torch.no_grad():
            o, lse = ops.flash_attention(*x, return_lse=True, **kw)
            bounds[side] = ref.flash_attention_bwd_bound(
                *x, o, lse, go.to(d), **kw)
    for i, name in enumerate(("dq", "dk", "dv")):
        card_g, cpu_g = got["card"][i].double().cpu(), got["cpu"][i].double()
        for side, g_, b_ in (("card", card_g, bounds["card"][i].cpu()),
                             ("cpu", cpu_g, bounds["cpu"][i])):
            if not bool(((g_ - want[i].double()).abs() <= b_).all()):
                fail(f"20: the capped backward's {name} on the {side} is "
                     f"outside flash_attention_bwd_bound of float32 "
                     f"autograd")
        both = bounds["card"][i].cpu() + bounds["cpu"][i]
        diff = (card_g - cpu_g).abs()
        log(f"20 capped backward {name} (B 2, S 512, 32 / 8 heads of 80, "
            f"bf16): card vs CPU max |diff| {float(diff.max()):.4g}, at "
            f"most {float((diff / both).max()):.3g} of the summed bounds")
    return rows


# ---------------------------------------------------------------------------
# phase 21: the dry-run's accounting held against the card
# ---------------------------------------------------------------------------

def profiled_matmul_flops(torch, fn) -> tuple[float, object]:
    """(the matrix products' FLOPs ``torch.profiler``'s ``with_flops``
    gives for one call of fn: aten::mm, addmm, bmm, baddbmm and the
    convolutions; its other counted ops, elementwise, are left out as the
    accounting leaves them out; fn's result). Run with the checkpoint's
    early stop off, as ``op_stats.count`` runs (its docstring): the same
    program on both sides."""
    import torch.utils.checkpoint as checkpoint
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with checkpoint.set_checkpoint_early_stop(False), \
            profile(activities=[ProfilerActivity.CPU],
                    with_flops=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    keep = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::conv", "aten::convolution", "aten::_convolution")
    return float(sum(e.flops for e in prof.key_averages()
                     if e.flops and e.key.startswith(keep)
                     and not e.key.startswith("aten::conv_"))), out


def placed_bytes(torch, tree) -> tuple[int, int, int]:
    """(torch.cuda.memory_allocated() taken by a copy of the tensors of
    ``tree`` made here, their bytes, the bytes the caching allocator's
    512-byte blocks round them to)."""
    from repro_torch import tree as T
    leaves = [x for x in T.leaves(tree) if isinstance(x, torch.Tensor)]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    copy = [x.clone() for x in leaves]
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated() - before
    del copy
    torch.cuda.empty_cache()
    nbytes = [x.numel() * x.element_size() for x in leaves]
    return got, sum(nbytes), sum(-(-n // 512) * 512 for n in nbytes)


def phase_witness_card(torch, dev, card: str) -> None:
    """Phase 21a (right after phase 19, on its params and optimizer state,
    its full preset's config):
    the dry-run's accounting (``launch.op_stats.count`` on meta tensors on
    a one-rank ``AccountingMesh``) of danube's prefill of phase 11 (B 8,
    S 2,048, a float32 cache) and of phase 19's train step held against
    the card: the argument bytes against ``torch.cuda.memory_allocated()``
    of a copy of the placed params and cache, or params and optimizer
    state (the caching allocator gives whole 512-byte blocks, so the
    allocated bytes are the count's bytes rounded up a tensor at a time:
    that sum must be met exactly); the matrix products' FLOPs within 1% of
    ``torch.profiler``'s ``with_flops`` for the same step; the roofline
    step time (``launch/roofline.py``), the measured step time and MFU =
    model_flops / (t_measured x peak), each on its own line."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import op_stats, roofline, train
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.model import build_model
    fn, args, step_s = SAVED.pop("train_step")
    params, opt, batch = args
    cfg = train.preset_config(TRAIN_ARCH, "full")
    model = build_model(cfg)
    one = S.AccountingMesh(("data", "model"), (1, 1))
    meta = model.shapes()

    def meta_like(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    b, s = 8, 2048
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev)
    cache = model.init_cache(b, s, dtype=torch.float32, device=dev)
    mcache = model.init_cache(b, s, dtype=torch.float32, device="meta")

    def real_prefill():
        return model.prefill(params, tokens, cache)
    # the measured prefill: median of 5 after a warm-up
    real_prefill()
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_prefill()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    pre_s = float(np.median(ts))
    prof_pre, _ = profiled_matmul_flops(torch, real_prefill)
    with S.use_mesh(one):
        _, acc_pre = op_stats.count(
            lambda: model.prefill(meta, meta_like(tokens), mcache))
    got_pre = placed_bytes(torch, [params, cache])
    acc_pre_args = sum(x.numel() * x.element_size() for x in
                       S.tree_flatten([meta, mcache],
                                      is_leaf=lambda x: hasattr(x, "shape")
                                      )[0] if isinstance(x, torch.Tensor))
    del cache
    # the train step of phase 19 on its last step's arguments
    prof_tr, _ = profiled_matmul_flops(torch, lambda: fn(*args))
    from repro_torch.models.model import make_train_step
    from repro_torch.optim import adamw
    ocfg = adamw.AdamWConfig(warmup_steps=min(100, TRAIN_STEPS // 10 + 1),
                             decay_steps=TRAIN_STEPS)
    mopt = adamw.init(ocfg, meta)
    mbatch = {k: meta_like(v) for k, v in batch.items()}
    with S.use_mesh(one):
        _, acc_tr = op_stats.count(
            lambda: make_train_step(model, ocfg)(meta, mopt, mbatch))
    got_tr = placed_bytes(torch, [params, opt])
    acc_tr_args = sum(x.numel() * x.element_size() for x in
                      S.tree_flatten([meta, mopt],
                                     is_leaf=lambda x: hasattr(x, "shape")
                                     )[0] if isinstance(x, torch.Tensor))
    n_act = cfg.active_param_count()
    for name, acc, prof, got, args_b, t_meas, model_flops in (
            ("prefill (phase 11's, B 8 x 2,048)", acc_pre, prof_pre,
             got_pre, acc_pre_args, pre_s, 2.0 * n_act * b * s),
            (f"train step (phase 19's, {TRAIN_B} x {TRAIN_S})", acc_tr,
             prof_tr, got_tr, acc_tr_args, step_s,
             6.0 * n_act * TRAIN_B * TRAIN_S)):
        alloc, counted, rounded = got
        log(f"21 {name}: argument bytes counted {args_b} (accounting), "
            f"{counted} (the card's tensors), {rounded} rounded to 512-byte "
            f"blocks; torch.cuda.memory_allocated of their copy {alloc}")
        if args_b != counted or alloc != rounded:
            fail(f"21 {name}: the argument bytes {args_b} / {counted} and "
                 f"the allocation {alloc} / {rounded} differ")
        rel = abs(acc.matmul_flops - prof) / prof
        log(f"21 {name}: matrix-product FLOPs counted "
            f"{acc.matmul_flops:.6g}, torch.profiler with_flops {prof:.6g} "
            f"(|diff| {rel:.3g} of it); the kernels' "
            f"{json.dumps({k: v['launches'] for k, v in acc.kernels.items()})}"
            f" launches")
        if rel > 0.01:
            fail(f"21 {name}: the counted matmul FLOPs are not within 1% of "
                 f"the profiler's")
        terms = roofline.RooflineTerms(
            flops=acc.flops, hbm_bytes=acc.bytes, coll_bytes=acc.coll_bytes,
            chips=1, peak_flops=lmesh.PEAK_FLOPS_BF16, hbm_bw=lmesh.HBM_BW,
            link_bw=lmesh.ICI_BW, model_flops=model_flops)
        print(f"21 {name} roofline step time {terms.step_time_s * 1e3:.3f} "
              f"ms ({terms.bottleneck}; computed from shapes)", flush=True)
        print(f"21 {name} measured step time {t_meas * 1e3:.3f} ms "
              f"({card})", flush=True)
        mfu = model_flops / (t_meas * lmesh.PEAK_FLOPS_BF16)
        print(f"21 {name} MFU {mfu:.4f} = model_flops {model_flops:.6g} / "
              f"(t_measured x "
              f"{lmesh.PEAK_FLOPS_BF16:.4g} FLOP/s) on {card}; at the "
              f"roofline {terms.mfu:.4f}", flush=True)


def phase_witness_mesh(torch) -> None:
    """Phase 21b: the collectives of phase 11s's windows (a prefill, a
    decode step, each with its greedy token) on a (1 x 4)
    ``AccountingMesh`` and of phase 19s's train step on a (2 x 2) one,
    each rank's program run on meta tensors, by kind, calls and bytes,
    against what 11s's and 19s's rank 0 counted on the card (reused, not
    run again)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.models.model import build_model, greedy, make_train_step
    from repro_torch.optim import adamw
    cfg = get_config(SHARDED_ARCH)
    model = build_model(cfg)
    meta = model.shapes()
    b, s, n_gen = SHARDED_REQ
    coll = S.collectives()
    for m in range(SHARDED_MESH[1]):
        with S.use_mesh(S.AccountingMesh(("data", "model"), SHARDED_MESH,
                                         (0, m))):
            params = S.blocks_of(meta, model.specs())
            cache = model.init_cache(b, s + n_gen, dtype=torch.float32,
                                     device="meta")
            tok = torch.empty((b, s), dtype=torch.int64, device="meta")
            coll.reset()
            logits, cache = model.prefill(params, tok, cache)
            greedy(logits, cfg, b)
            got = {"prefill": coll.as_dict()}
            coll.reset()
            logits, cache = model.decode(params, tok[:, :1], cache)
            greedy(logits, cfg, b)
            got["decode"] = coll.as_dict()
        if got != SAVED["11s"]:
            fail(f"21b: the accounting mesh's 11s windows at (0, {m}) "
                 f"{json.dumps(got)} differ from the card's "
                 f"{json.dumps(SAVED['11s'])}")
    log(f"21b 11s windows on the (1 x 4) accounting mesh equal the card's "
        f"at every coordinate: {json.dumps(SAVED['11s'])}")
    from repro_torch.launch import train
    steps, b, s = SHARDED_TRAIN
    tcfg = train.preset_config(TRAIN_ARCH, "full")
    tmodel = build_model(tcfg)
    tmeta = tmodel.shapes()
    ocfg = adamw.AdamWConfig(warmup_steps=min(100, steps // 10 + 1),
                             decay_steps=steps)
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}     # token_batch's int32
    for d in range(SHARDED_TRAIN_MESH[0]):
        for m in range(SHARDED_TRAIN_MESH[1]):
            with S.use_mesh(S.AccountingMesh(("data", "model"),
                                             SHARDED_TRAIN_MESH, (d, m))):
                params = S.blocks_of(tmeta, tmodel.specs())
                opt = adamw.init(ocfg, params)
                step = make_train_step(tmodel, ocfg, donate=True)
                coll.reset()
                step(params, opt, batch)
                got = coll.as_dict()
            if got != SAVED["19s"]:
                fail(f"21b: the accounting mesh's 19s step at ({d}, {m}) "
                     f"{json.dumps(got)} differs from the card's "
                     f"{json.dumps(SAVED['19s'])}")
    log(f"21b 19s step on the (2 x 2) accounting mesh equals the card's at "
        f"every coordinate: {json.dumps(SAVED['19s'])}")


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

    card = phase("1", phase_card, torch)
    phase("2", phase_build_kernels)
    phase("3", phase_kernels_synthetic, torch, dev)
    eng, qt, build_s = phase("4", phase_build_index, torch, dev)
    counts, recall, qps, single = phase("5", phase_search, torch, eng, qt)
    phase("6", phase_breakdown, torch, eng, qt,
          1e3 * qt.shape[0] / sorted(qps)[len(qps) // 2])
    timing = phase("7", phase_kernels_real, torch, eng, qt)
    scan_call, gemv_counts, gemv_recall, gemv_qps = phase(
        "8", phase_gemv, torch, eng, qt, recall)
    recalls = {"mulfree/beam": recall, "mulfree/gemv": gemv_recall}
    ranked = phase("8b", phase_backends, torch, eng, qt, recalls)
    topo, sharded_counts, rep, med = phase("9", phase_sharded, torch, eng,
                                           qt, single, recall)
    phase("9b", phase_mixed_tier, torch, topo, qt)
    timing.update(phase("10", phase_new_kernels_real, torch, topo, rep,
                        scan_call, qt))
    del topo, scan_call
    mesh = phase("13", phase_mesh, torch, eng, qt, rep, med)
    anns = phase("13b", phase_anns_step, torch, eng, qt, qps, mesh)
    phase("9c", phase_skewed_tier, torch, eng)
    lm_counts, timing["flash_attention"] = phase("11", phase_lm, torch, dev,
                                                 eng)
    mla_launches, mla = phase("14", phase_mla, torch, dev, eng)
    phase("15", phase_ssm, torch, dev, eng)
    hd256_launches, hd256 = phase("16", phase_rglru, torch, dev, eng)
    noncausal_launches, noncausal = phase("17", phase_encdec, torch, dev, eng)
    phase("18", phase_vlm, torch, dev, eng)
    sharded_launches, sharded_row, decode_launches, seq_row = phase(
        "11s", phase_sharded_lm, torch, dev, eng)
    parts, icfg = [eng.index, eng.host], eng.icfg
    del eng
    mutable = phase("12", phase_mutable, torch, parts, icfg, qt)
    train_launches, train_row = phase("19", phase_train, torch, dev)
    phase("21a", phase_witness_card, torch, dev, card)
    phase("19w", phase_train_witness, torch, dev)
    phase("19b", phase_train_resume, torch, dev)
    phase("19c", phase_train_dp, torch, dev)
    phase("19d", phase_train_dp, torch, dev, pod=True)
    strain_launches, strain_row = phase("19s", phase_sharded_train, torch,
                                        dev)
    phase("21b", phase_witness_mesh, torch)
    softcap_rows = phase("20", phase_softcap, torch, dev)

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
    # the latent-attention instantiation (dk 576, dv 512) of phase 14
    kernels.append(dict(
        name="flash_attention/mla", route="cuda",
        source=src["flash_attention"][0], replaces=src["flash_attention"][1],
        launches=mla_launches, max_abs_err=ERRS["flash_attention/mla"],
        ms=mla["ms"], plain_ms=mla["plain_ms"], bound_ms=mla["bound_ms"],
        bound_by=mla["bound_by"], library_ms=mla["library_ms"]))
    # the head-dim-256 instantiation (the wide kernel) of phase 16
    kernels.append(dict(
        name="flash_attention/hd256", route="cuda",
        source=src["flash_attention"][0], replaces=src["flash_attention"][1],
        launches=hd256_launches, max_abs_err=ERRS["flash_attention/hd256"],
        ms=hd256["ms"], plain_ms=hd256["plain_ms"],
        bound_ms=hd256["bound_ms"], bound_by=hd256["bound_by"],
        library_ms=hd256["library_ms"]))
    # the tensor-core route without the causal mask (whisper, phase 17):
    # its non-causal launches in the counted run, layer 0's encoder call
    kernels.append(dict(
        name="flash_attention/noncausal", route="cuda",
        source=src["flash_attention"][0], replaces=src["flash_attention"][1],
        launches=noncausal_launches,
        max_abs_err=ERRS["flash_attention/noncausal"], ms=noncausal["ms"],
        plain_ms=noncausal["plain_ms"], bound_ms=noncausal["bound_ms"],
        bound_by=noncausal["bound_by"],
        library_ms=noncausal["library_ms"]))
    # the training path (phase 19): the kernel with its lse output, its
    # launches in the training run (a forward and a recompute a layer)
    kernels.append(dict(
        name="flash_attention/train", route="cuda",
        source=src["flash_attention"][0], replaces=src["flash_attention"][1],
        launches=train_launches, max_abs_err=ERRS["flash_attention/train"],
        ms=train_row["ms"], plain_ms=train_row["plain_ms"],
        bound_ms=train_row["bound_ms"], bound_by=train_row["bound_by"],
        library_ms=train_row["library_ms"]))
    # the sharded LM (phase 11s): rank 0's launches in the counted run, its
    # layer-0 call (8 / 2 heads of 80) held and timed
    kernels.append(dict(
        name="flash_attention/sharded", route="cuda",
        source=src["flash_attention"][0], replaces=src["flash_attention"][1],
        launches=sharded_launches,
        max_abs_err=ERRS["flash_attention/sharded"], ms=sharded_row["ms"],
        plain_ms=sharded_row["plain_ms"], bound_ms=sharded_row["bound_ms"],
        bound_by=sharded_row["bound_by"],
        library_ms=sharded_row["library_ms"]))
    # the sharded train step (phase 19s): rank 0's launches in its run,
    # its layer-0 call (16 / 4 heads of 80, with lse) held and timed
    kernels.append(dict(
        name="flash_attention/sharded-train", route="cuda",
        source=src["flash_attention"][0], replaces=src["flash_attention"][1],
        launches=strain_launches,
        max_abs_err=ERRS["flash_attention/sharded-train"],
        ms=strain_row["ms"], plain_ms=strain_row["plain_ms"],
        bound_ms=strain_row["bound_ms"], bound_by=strain_row["bound_by"],
        library_ms=strain_row["library_ms"]))
    # the attention softcap (phase 20), one row a kernel template's route:
    # its launch in the phase's counted run, its time by CUDA events; no
    # library call caps the scores (library_ms null)
    for name, row in softcap_rows.items():
        kernels.append(dict(
            name=name, route="cuda", source=src["flash_attention"][0],
            replaces=src["flash_attention"][1], launches=row["launches"],
            max_abs_err=ERRS[name], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    # the split-KV decode kernel: its launches in phase 11s's
    # sequence-split decode steps on rank 0, its times on the first of
    # those calls (float32 K/V); max_abs_err over every call held, phase
    # 20's full-size bf16 ones too
    kernels.append(dict(
        name="flash_attention/decode", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces=src["flash_attention"][1], launches=decode_launches,
        max_abs_err=ERRS["flash_attention/decode"], ms=seq_row["ms"],
        plain_ms=seq_row["plain_ms"], bound_ms=seq_row["bound_ms"],
        bound_by=seq_row["bound_by"], library_ms=seq_row["library_ms"]))
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
        f"{MESH_RANKS}-rank mesh (median of 5), {anns['beam']['qps']:.1f} / "
        f"{anns['gemv']['qps']:.1f} beam / gemv on the {ANNS_MESH[0]} x "
        f"{ANNS_MESH[1]} search step (median of 5); mutable tier QPS "
        f"{mutable['tier_qps']:.1f}, "
        f"recall drift at ef 64 "
        f"{abs(mutable['recall_mut64'] - mutable['recall_compact64']):.4f}; "
        f"no single PyTorch call computes binary_ip_rank, "
        f"topk_select (a dedup first), cluster_scan (a rank and a "
        f"selection) or beam_search (a graph search), so their library_ms "
        f"is null")
    log(f"total {time.perf_counter() - T0:.1f} s")
    print("phase seconds " + json.dumps(PHASE_S), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
