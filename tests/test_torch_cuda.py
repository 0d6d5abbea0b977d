"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with ``nvcc`` (sm_90a) and skip without one; on
such a machine run ``PYTHONPATH=src python -m pytest -q
tests/test_torch_cuda.py``. They import no JAX: the plain versions are
held against the JAX package by the other tests/test_torch_*.py files on
the CPU. The sweeps reach what the main path does not: code widths that
take the kernel's byte loop (W not a multiple of 16), dim % 8 != 0,
shift amounts at their edges, k == C, one-column and 4096-column rows,
rows wider than one launch holds (C = 4,160 in passes, O k = 4,800 as a
merge tree, EF = 1,500), merges of 1 to 8 runs with ties and unanswered
rows, cluster scans with INT_MIN / INT_MAX ranks, ranks falling or equal
in row order, empty and short clusters, inactive lanes, the nibble tables
of W = 256, the fused beam search on the adversarial cases of
``tests/test_torch_beam_design.py`` (duplicates, the visited quirk, ties,
INT_MIN / INT_MAX ranks, EF from 1 to 100, R 16 to 48, W 4 to 64, the hop
cap, inactive lanes, the cluster budget M = 17,089) and on lanes whose
state outgrows shared memory, and attention over every head dim the
kernel takes, GQA groups, ragged Sq and Sk, offsets, windows, cache
lengths, both types and strided inputs. The hamming and exact rank
policies of ``beam_search`` and ``cluster_scan`` run on their edge shapes:
W % 4 != 0, dim % 8 != 0, the scratch route, EF > 128, empty clusters,
pad rows, all-tied ranks, and (exact) NaN and inf ranks, float32 ranks
held bit for bit. The selection kernels' two routes
(warp and block) run on the same rows, from one lane slot to 32, across
both route boundaries, and on the rows of
``tests/test_torch_select_design.py`` (NaN, +-inf, -0.0), bitwise. The
mutable index runs on the card: its link in rounds against ``link_new``,
``compact(subset)`` against ``rebuild()``, and a mutable tier swapped in
mid-run. Two builds of one seed are the same bits (ROADMAP C5), a
two-rank mesh tier (``exec="mesh"``, gloo, both ranks on one card) equals
the in-process tier, the recurrent blocks (Mamba2's SSD, the RG-LRU)
equal their CPU runs, and the tensor-core route (bf16 q) runs without the
causal mask (whisper's encoder and cross-attention) at GQA groups 1 and 7,
ragged Sq / Sk, Sq = 1 over float32 K/V and the padded head dims 8 / 16.
The training path: every route's logsumexp output (``return_lse``)
against its twin, ``attend``'s gradients within
``ref.flash_attention_bwd_bound`` of float32 autograd, every arch's
gradients and one train step against the CPU's. The attention softcap on
each of the three kernel templates (output, lse and gradients). The
split-dv and wide kernels on their design's edges: 1, 2 and odd tile
counts, cluster pairs padded or with tile counts of their own, windows
and cache lengths inside a tile, head sets of 16 to 1, float32 K/V.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    beam_search, binary_ip, cluster_scan, flash_attn, merge_topk, ops, ref,
    topk_select)
from test_torch_beam_design import (  # noqa: E402
    CASES, beam_case, rank_operands, ranked_case)
from test_torch_select_design import (  # noqa: E402
    MERGE_CASES, TOPK_CASES, merge_case, same_bits, topk_case)

pytestmark = pytest.mark.cuda

INT_MAX = 2**31 - 1
INT_MIN = -2**31


@pytest.fixture
def card():
    """The CUDA device; the decision is made here, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rank_inputs(rng, n_lanes, n_rows, w, dim, t_rows=501):
    codes = rng.integers(0, 256, (t_rows, w), dtype=np.uint8)
    f_add = rng.integers(-(1 << 20), 1 << 20, (t_rows,), dtype=np.int32)
    f_add[::7] = INT_MAX
    rows = rng.integers(-1, t_rows, (n_lanes, n_rows)).astype(np.int32)
    lut = rng.integers(-(1 << 28), 1 << 28, (n_lanes, w * 8)).astype(
        np.int32)
    lut[:, dim:] = rng.integers(-9, 9, (n_lanes, w * 8 - dim))  # not counted
    sumq = rng.integers(-(1 << 30), 1 << 30, n_lanes).astype(np.int32)
    s1 = rng.integers(0, 33, n_lanes).astype(np.int32)   # 32: sign fill
    s2 = rng.integers(0, 33, n_lanes).astype(np.int32)
    s2[::3] = 31
    return codes, f_add, rows, lut, sumq, s1, s2


@pytest.mark.parametrize("n_lanes,n_rows,w,dim", [
    (300, 32, 16, 128),    # the main path's hop shape, scaled down
    (7, 1, 16, 125),       # the entry rank; dim % 8 != 0
    (5, 700, 16, 128),     # gemv-shaped: one lane per block, rows looped
    (9, 13, 4, 29),        # byte loop, W = 4
    (4, 40, 12, 96),       # byte loop, W = 12
    (3, 5, 32, 256),       # two 16-byte vectors per code
    (2, 3, 2048, 16384),   # a 64 KB LUT: above 48 KB of shared memory
])
def test_binary_ip_rank_kernel_bitwise(card, n_lanes, n_rows, w, dim):
    rng = np.random.default_rng(n_lanes * 1000 + w)
    args = [torch.from_numpy(a).to(card)
            for a in _rank_inputs(rng, n_lanes, n_rows, w, dim)]
    got = binary_ip.binary_ip_rank(*args, dim)
    want = ref.binary_ip_rank_ref(*args, dim)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_binary_ip_rank_kernel_unaligned_codes(card):
    """A code table that starts off a 16-byte boundary takes the byte loop
    and still agrees."""
    rng = np.random.default_rng(1)
    codes, *rest = _rank_inputs(rng, 6, 9, 16, 128, t_rows=64)
    buf = torch.empty(64 * 16 + 1, dtype=torch.uint8, device=card)
    shifted = buf[1:].view(64, 16)
    shifted.copy_(torch.from_numpy(codes))
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    args = [torch.from_numpy(a).to(card) for a in rest]
    assert torch.equal(binary_ip.binary_ip_rank(shifted, *args, 128),
                       ref.binary_ip_rank_ref(shifted, *args, 128))


def _cand_set(rng, q, c):
    ids = rng.integers(-1, max(2, c // 2), (q, c)).astype(np.int32)
    d = rng.random((q, c)).astype(np.float32)
    ids[:, -1:] = -1
    if q > 1:
        ids[0] = -1
    if q > 2:
        ids[1] = 7
    if c >= 8:
        d[:, 3:7] = 0.5
    return ids, d


@pytest.mark.parametrize("q,c,k", [
    (1, 1, 1), (3, 33, 5), (4, 64, 10), (7, 300, 10), (1024, 320, 10),
    (2, 10, 10), (8, 4096, 64), (5, 2048, 2048),
])
def test_topk_select_kernel_bitwise(card, q, c, k):
    rng = np.random.default_rng(q * 7 + c)
    ids, d = (torch.from_numpy(a).to(card) for a in _cand_set(rng, q, c))
    for got, want in zip(topk_select.topk_select(ids, d, k=k),
                         ref.topk_select_ref(ids, d, k=k)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("q,c,k", [(64, 4160, 10), (8, 9000, 100),
                                   (4, 4097, 2048)])
def test_topk_select_kernel_wide_rows_in_passes(card, q, c, k):
    """Rows wider than MAX_C go through the kernel in chunks and once more
    over the chunks' outputs (``chunked_select``), bitwise equal to one
    call of the plain version when each id carries one distance, as the
    rerank's do: C = nprobe ef = 4,160 at nprobe = 64, ef = 65."""
    rng = np.random.default_rng(c)
    ids = rng.integers(-1, c // 3, (q, c)).astype(np.int32)  # duplicates
    table = (rng.integers(0, 500, c // 3) / 8).astype(np.float32)
    d = np.where(ids >= 0, table[np.clip(ids, 0, None)], 0.0)
    ids[0] = -1
    ids, d = torch.from_numpy(ids).to(card), torch.from_numpy(d).to(card)
    ops.reset_launch_counts()
    got = topk_select.topk_select(ids, d, k=k)
    want = ref.topk_select_ref(ids, d, k=k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.launch_counts()["topk_select"] > 1
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        topk_select.topk_select(ids, d, k=topk_select.MAX_C // 2 + 1)


@pytest.mark.parametrize("fault", ["two distances", "nan", "-inf"])
def test_topk_select_kernel_refuses_rows_the_passes_cannot_hold(card,
                                                                fault):
    """A row wider than MAX_C that breaks the passes' conditions raises
    ValueError where the passes would differ from the plain version; the
    same row at MAX_C columns takes one launch and agrees with it."""
    c = topk_select.MAX_C + 1
    ids = torch.arange(c, dtype=torch.int32, device=card)[None].clone()
    d = torch.arange(c, dtype=torch.float32, device=card)[None] + 10
    if fault == "two distances":
        ids[0, c - 1] = 5
        d[0, c - 1] = 0.0
    else:
        d[0, 7] = float(fault)
    with pytest.raises(ValueError, match="one distance"):
        topk_select.topk_select(ids, d, k=10)
    if fault == "two distances":
        ids, d = ids[:, 1:].contiguous(), d[:, 1:].contiguous()
    else:
        ids, d = ids[:, :-1].contiguous(), d[:, :-1].contiguous()
    for got, want in zip(topk_select.topk_select(ids, d, k=10),
                         ref.topk_select_ref(ids, d, k=10)):
        assert torch.equal(got, want)


def _runs(rng, q, o, run):
    """O sorted runs per row in the sharded sink's slot layout: unfilled
    tails, an exact tie across runs and a fully unanswered row."""
    d3 = np.sort(rng.random((q, o, run)).astype(np.float32), axis=-1)
    ids3 = np.arange(q * o * run, dtype=np.int32).reshape(q, o, run)
    d3[:, 0, -2:] = np.inf
    ids3[:, 0, -2:] = -1
    if o > 1:
        d3[:, 1, 0] = d3[:, 0, 0]
        d3[:, 1] = np.sort(d3[:, 1], axis=-1)
    if q > 1:
        d3[1] = np.inf
        ids3[1] = -1
    return ids3.reshape(q, o * run), d3.reshape(q, o * run)


@pytest.mark.parametrize("q,o,run,k", [
    (1, 1, 4, 4), (4, 3, 10, 10), (1024, 8, 10, 10), (2, 6, 12, 7),
    (5, 8, 10, 3), (3, 1, 4096, 16),
])
def test_merge_topk_kernel_bitwise(card, q, o, run, k):
    rng = np.random.default_rng(q * 31 + o)
    ids, d = (torch.from_numpy(a).to(card) for a in _runs(rng, q, o, run))
    for got, want in zip(merge_topk.merge_topk(ids, d, k=k, run=run),
                         ref.merge_topk_ref(ids, d, k=k, run=run)):
        assert torch.equal(got, want)


def test_merge_topk_kernel_unsorted_rows_and_refusals(card):
    """The kernel sorts the row, so unsorted runs still merge right; rows
    wider than its shared memory (O k = 4,800) go through a tree of
    launches, bitwise; ragged runs are refused."""
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.random((9, 40)).astype(np.float32)).to(card)
    d[:, 5] = d[:, 30]                                 # a tie
    ids = torch.arange(360, dtype=torch.int32, device=card).view(9, 40)
    for got, want in zip(merge_topk.merge_topk(ids, d, k=10),
                         ref.merge_topk_ref(ids, d, k=10)):
        assert torch.equal(got, want)
    wide_ids, wide_d = (torch.from_numpy(a).to(card)
                        for a in _runs(rng, 16, 480, 10))
    ops.reset_launch_counts()
    for got, want in zip(merge_topk.merge_topk(wide_ids, wide_d, k=10),
                         ref.merge_topk_ref(wide_ids, wide_d, k=10)):
        assert torch.equal(got, want)
    assert ops.launch_counts()["merge_topk"] > 1
    with pytest.raises(ValueError, match="whole number of runs"):
        merge_topk.merge_topk(ids, d, k=10, run=7)


def _on_route(launch, ids, d, k, route, **kw):
    """One launch of ``route``; a warp launch on a row it cannot take must
    raise ValueError (and then the call returns None)."""
    if route == "warp" and topk_select.route_for(ids.shape[1], k) != "warp":
        with pytest.raises(ValueError, match="cannot take"):
            launch(ids, d, k=k, route=route, **kw)
        return None
    return launch(ids, d, k=k, route=route, **kw)


def test_select_kernels_report_the_route_limits(card):
    lib = topk_select._lib()
    assert lib.topk_select_warp_max_c() == topk_select.WARP_MAX_C
    assert lib.topk_select_warp_max_k() == topk_select.WARP_MAX_K
    assert lib.topk_select_max_c() == topk_select.MAX_C
    assert merge_topk._lib().merge_topk_max_w() == merge_topk.MAX_W
    assert topk_select.smem_bytes(320, "warp") == 4 * 4 * 1024
    assert topk_select.smem_bytes(4096, "block") == 8 * 4096 + 4096
    assert merge_topk.smem_bytes(80, "warp") == 0


@pytest.mark.parametrize("route", topk_select.ROUTES)
@pytest.mark.parametrize("name", TOPK_CASES)
def test_topk_select_routes_on_the_design_rows(card, name, route):
    """Both routes on the rows of ``tests/test_torch_select_design.py``
    (NaN, +-inf, -0.0, duplicates, pads, the route boundaries), bitwise
    in ids and in the bits of the distances."""
    ids, d, k = topk_case(name)
    ids, d = torch.from_numpy(ids).to(card), torch.from_numpy(d).to(card)
    got = _on_route(topk_select._launch, ids, d, k, route)
    torch.cuda.synchronize()
    if got is not None:
        assert same_bits(got, ref.topk_select_ref(ids, d, k=k))


@pytest.mark.parametrize("route", topk_select.ROUTES)
@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_topk_routes_on_the_design_rows(card, name, route):
    ids, d, k, run = merge_case(name)
    ids, d = torch.from_numpy(ids).to(card), torch.from_numpy(d).to(card)
    got = _on_route(merge_topk._launch, ids, d, k, route, run=run)
    torch.cuda.synchronize()
    if got is not None:
        assert same_bits(got, ref.merge_topk_ref(ids, d, k=k, run=run))


@pytest.mark.parametrize("route", topk_select.ROUTES)
@pytest.mark.parametrize("q,c,k", [
    (1024, 320, 10),   # the rerank's launch
    (8, 320, 10),      # the RAG retrieval's
    (1023, 80, 10),    # the origin merge's width; a ragged last block
    (5, 1, 1), (3, 31, 31), (7, 32, 32), (6, 33, 10), (4, 65, 20),
    (9, 129, 32), (2, 257, 7), (3, 513, 10), (5, 1000, 32),
    (4, 1024, 32),     # the warp route's last width and k
    (4, 1025, 10), (3, 100, 33), (2, 4096, 10),       # the block route's
])
def test_select_kernel_routes_bitwise(card, q, c, k, route):
    """Each lane-slot count R (1 to 32) of the warp route and the block
    route on the same rows, for both kernels (merge_topk with runs of one
    slot): duplicates, pads, ties."""
    rng = np.random.default_rng(q * 131 + c + k)
    ids, d = (torch.from_numpy(a).to(card) for a in _cand_set(rng, q, c))
    got = _on_route(topk_select._launch, ids, d, k, route)
    if got is not None:
        assert same_bits(got, ref.topk_select_ref(ids, d, k=k))
    d[ids < 0] = float("inf")
    got = _on_route(merge_topk._launch, ids, d, k, route, run=1)
    torch.cuda.synchronize()
    if got is not None:
        assert same_bits(got, ref.merge_topk_ref(ids, d, k=k, run=1))


def _scan_inputs(rng, n_lanes, m, w, n_clusters=5, kind="random"):
    """A flattened (n_clusters * m, W) table and n_lanes lanes over it. Odd
    lanes have an all-zero LUT and sumq, so their ranks are f_add itself,
    which holds INT_MIN, INT_MAX and ties. ``kind`` "falling", "equal" or
    "late" zeroes every LUT and sumq and sets f_add falling (every row
    passes the kernel's running threshold), all equal, or rising by 2 with
    each cluster's last row just inside the best 40 (the running threshold
    has settled by then), in row order."""
    t = n_clusters * m
    codes = rng.integers(0, 256, (t, w), dtype=np.uint8)
    f_add = rng.integers(-(1 << 12), 1 << 12, (t,), dtype=np.int32)
    f_add[::5] = INT_MAX
    f_add[1::7] = INT_MIN
    lut = rng.integers(-(1 << 28), 1 << 28, (n_lanes, w * 8)).astype(
        np.int32)
    sumq = rng.integers(-(1 << 30), 1 << 30, n_lanes).astype(np.int32)
    lut[1::2] = 0
    sumq[1::2] = 0
    base = (rng.integers(0, n_clusters, n_lanes) * m).astype(np.int32)
    nv = rng.integers(0, m + 1, n_lanes).astype(np.int32)
    nv[:3] = [0, m, min(3, m)]                        # empty, full, < EF
    f_add[base[1]:base[1] + 2] = [INT_MAX, INT_MIN]   # lane 1 ranks f_add
    s1 = rng.integers(0, 33, n_lanes).astype(np.int32)
    s2 = rng.integers(0, 33, n_lanes).astype(np.int32)
    s2[::3] = 31
    active = rng.random(n_lanes) < 0.8
    active[:3] = True
    if kind != "random":
        lut[:] = 0
        sumq[:] = 0
        i = np.arange(t) % m
        f_add = {"falling": m - i, "equal": 0 * i,
                 "late": np.where(i == m - 1, 2 * 40 - 3, 2 * i)}[kind]
        f_add = f_add.astype(np.int32)
    return codes, f_add, base, nv, lut, sumq, s1, s2, active


def _case(*shape, kind="random"):
    return pytest.param(*shape, kind,
                        id="-".join(map(str, shape))
                        + ("" if kind == "random" else f"-{kind}"))


@pytest.mark.parametrize("n_lanes,m,w,dim,ef,kind", [
    _case(64, 700, 16, 128, 40),     # the gemv path's shape, scaled down
    _case(9, 5000, 16, 125, 16),     # many merges; dim % 8 != 0
    _case(7, 40, 4, 29, 40),         # byte loop; EF == M
    _case(5, 3000, 16, 128, 1024),   # EF at the kernel's limit
    _case(3, 9000, 32, 256, 300),    # EF not a power of two
    _case(6, 5000, 16, 128, 40, kind="falling"),  # every row passes tau
    _case(6, 3000, 16, 128, 40, kind="equal"),    # all ranks tie
    _case(6, 3000, 16, 128, 40, kind="late"),     # the 40th best comes last
    _case(4, 17089, 16, 128, 40),    # the main path's cluster budget
    _case(3, 2000, 256, 2045, 40),   # W = 256: the nibble tables
    _case(300, 700, 16, 128, 40),    # more lanes than the card has SMs
])
def test_cluster_scan_kernel_bitwise(card, n_lanes, m, w, dim, ef, kind):
    rng = np.random.default_rng(n_lanes * 100 + w)
    args = [torch.from_numpy(a).to(card)
            for a in _scan_inputs(rng, n_lanes, m, w, kind=kind)]
    got = cluster_scan.cluster_scan(*args, dim, ef, m)
    want = ref.cluster_scan_ref(*args, dim, ef, m)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    if ef == m:                  # every row is kept: INT_MIN comes out last
        assert int(want[1][1, -1]) == INT_MIN


def test_cluster_scan_kernel_refuses_what_it_cannot_hold(card):
    """EF past PR 12's limit of 1,024 is served (EF = 1,500, and the
    largest served, max_ef(16) = 8,192 at M = 17,089, bitwise); EF beyond a
    cluster is refused, and EF beyond a block's shared memory raises
    NotImplementedError naming ROADMAP C3."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a).to(card)
            for a in _scan_inputs(rng, 5, 4000, 16)]
    for got, want in zip(cluster_scan.cluster_scan(*args, 128, 1500, 4000),
                         ref.cluster_scan_ref(*args, 128, 1500, 4000)):
        assert torch.equal(got, want)
    assert cluster_scan.max_ef(16) == 8192
    with pytest.raises(ValueError, match="ef = 4001"):
        cluster_scan.cluster_scan(*args, 128, 4001, 4000)
    big = [torch.from_numpy(a).to(card)
           for a in _scan_inputs(rng, 3, 17089, 16)]
    for got, want in zip(cluster_scan.cluster_scan(*big, 128, 8192, 17089),
                         ref.cluster_scan_ref(*big, 128, 8192, 17089)):
        assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        cluster_scan.cluster_scan(*big, 128, 8193, 17089)


def test_ops_send_cuda_tensors_to_the_kernels(card):
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(a).to(card)
            for a in _rank_inputs(rng, 4, 8, 16, 128)]
    ids, d = (torch.from_numpy(a).to(card) for a in _cand_set(rng, 4, 40))
    scan = [torch.from_numpy(a).to(card)
            for a in _scan_inputs(rng, 4, 50, 16)]
    ops.reset_launch_counts()
    ops.binary_ip_rank(*args, 128)
    ops.topk_select(ids, d, k=5)
    ops.merge_topk(ids, d, k=5)
    ops.cluster_scan(*scan, 128, 10, 50)
    q, k, v = _attn_inputs(card, 1, 70, 70, 4, 2, 64, torch.float32,
                           torch.float32)
    ops.flash_attention(q, k, v, causal=True)
    ops.beam_search(*(t.to(card) for t in beam_case(1, 4, 60, 8, 16)),
                    128, 10, 20, 60)
    assert ops.launch_counts() == {"binary_ip_rank": 1, "topk_select": 1,
                                   "merge_topk": 1, "cluster_scan": 1,
                                   "flash_attention": 1, "beam_search": 1}


def _hold_beam(card, args, dim, ef, iters, m):
    args = [t.to(card) for t in args]
    got = beam_search.beam_search(*args, dim, ef, iters, m)
    want = ref.beam_search_ref(*args, dim, ef, iters, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return want


@pytest.mark.parametrize("name", list(CASES))
def test_beam_search_kernel_bitwise(card, name):
    """The adversarial cases of the design mirror (phase 3 of the smoke
    holds the same kinds at the main path's shapes): ids, ranks and hops
    bitwise equal to the plain loop. Every M there but the quirk's is not a
    multiple of 32."""
    make, dim, ef, iters, m = CASES[name]
    _hold_beam(card, make(), dim, ef, iters, m)


@pytest.mark.parametrize("n_lanes,m,r,w,ef", [
    (16384, 17089, 32, 16, 40),  # the main path's lanes and cluster budget
    (300, 700, 32, 16, 40),    # more lanes than the card has SMs
    (40, 1000, 32, 16, 5000),  # 90 KB a lane: two lanes a block
    (3, 2_000_003, 8, 2, 20),  # the bitmap outgrows a block: scratch
])
def test_beam_search_kernel_large_state(card, n_lanes, m, r, w, ef):
    """The main path's shape, and lanes whose state takes fewer lanes a
    block, or global scratch."""
    want = _hold_beam(card, beam_case(m + ef, n_lanes, m, r, w, 1), 8 * w,
                      ef, 64, m)
    assert int(want[2].max()) > 1
    smem = beam_search.smem_bytes(ef, r, m, w)
    scratch = beam_search.scratch_bytes(n_lanes, ef, r, m, w)
    assert (smem == 0) == (scratch > 0) == (m > 1_000_000)


def _on_card(rank, card):
    return type(rank)(*(t.to(card) for t in rank))


def _equal_bits(a, b):
    """Equal dtype and values, a float32 tensor bit for bit."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _nan_inf_rows(rank):
    """An exact rank whose residual norms hold NaN and +inf: ranks NaN
    (inf - inf, inf * 0) and +inf."""
    rn = rank.residual_norm.clone()
    rn[::17] = float("nan")
    rn[3::19] = float("inf")
    return rank._replace(residual_norm=rn)


def _all_tied(rank):
    """Every rank of every lane equal: hamming over all-zero codes (the
    case's job), exact with zero residual and query norms (every rank
    +0.0)."""
    if rank.kind == "hamming":
        return rank
    return rank._replace(residual_norm=torch.zeros_like(rank.residual_norm),
                         query_norm=torch.zeros_like(rank.query_norm))


RANKED_BEAM = {  # name: (lanes, M, R, W, dim, EF, max_iters, clusters)
    "random_w16": (12, 300, 32, 16, 128, 40, 64, 3),
    "w5_dim37": (8, 200, 32, 5, 37, 40, 64, 3),      # W % 4, D % 8 != 0
    "w4_dim29": (8, 100, 32, 4, 29, 12, 64, 3),      # EF < R
    "ef200_r48": (6, 400, 48, 16, 128, 200, 64, 3),  # EF > 128, RP = 64
    "max_iters_cap": (8, 300, 32, 16, 128, 40, 5, 3),
    "tied": (8, 300, 32, 16, 128, 40, 64, 3),
    "nan_inf": (12, 300, 32, 16, 128, 40, 64, 3),
    "budget_m17089": (3, 17089, 32, 16, 128, 40, 64, 1),
    "scratch": (3, 2_000_003, 8, 2, 16, 20, 64, 1),  # the bitmap outgrows
}


def _ranked_params(table):
    return [pytest.param(kind, name, id=f"{kind}-{name}")
            for name in table for kind in ("hamming", "exact")
            if not (name == "nan_inf" and kind == "hamming")]


@pytest.mark.parametrize("kind,name", _ranked_params(RANKED_BEAM))
def test_ranked_beam_search_kernel_bitwise(card, kind, name):
    """The hamming and exact policies of the beam kernel against the plain
    loop: ids, ranks (float32 bit for bit) and hops."""
    n_lanes, m, r, w, dim, ef, iters, ncl = RANKED_BEAM[name]
    codes, rank, nbrs, base, entry, active = ranked_case(
        kind, m + w, n_lanes, m, r, w, dim, ncl, tied=name == "tied")
    if name == "tied":
        rank = _all_tied(rank)
    if name == "nan_inf":
        rank = _nan_inf_rows(rank)
    args = [t.to(card) for t in (codes, nbrs, base, entry, active)]
    rank = _on_card(rank, card)
    kw = dict(dim=dim, ef=ef, max_iters=iters, m=m)
    got = beam_search.ranked_beam_search(args[0], rank, *args[1:], **kw)
    want = ref.ranked_beam_search_ref(args[0], rank, *args[1:], **kw)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        assert _equal_bits(g, wnt)
    assert int(want[2].max()) > (0 if name == "nan_inf" else 1)
    if name == "scratch":
        assert beam_search.scratch_bytes(n_lanes, ef, r, m, w, kind) > 0
        assert beam_search.smem_bytes(ef, r, m, w, kind) == 0


RANKED_SCAN = {  # name: (lanes, M, W, dim, EF)
    "random_w16": (64, 700, 16, 128, 40),
    "w5_dim37": (7, 300, 5, 37, 40),       # W % 4, D % 8 != 0
    "ef_eq_m": (7, 40, 4, 29, 40),
    "ef300_w32": (3, 9000, 32, 256, 300),  # EF > 128
    "ef1500": (5, 4000, 16, 128, 1500),
    "tied": (6, 3000, 16, 128, 40),
    "nan_inf": (9, 3000, 16, 128, 40),
    "budget_m17089": (4, 17089, 16, 128, 40),
    "w256": (3, 2000, 256, 2045, 40),
}


@pytest.mark.parametrize("kind,name", _ranked_params(RANKED_SCAN))
def test_ranked_cluster_scan_kernel_bitwise(card, kind, name):
    """The hamming and exact policies of the scan kernel against the plain
    version, with empty clusters (n_valid 0), pad rows, inactive lanes and
    EF up to M: ids and ranks (float32 bit for bit)."""
    n_lanes, m, w, dim, ef = RANKED_SCAN[name]
    rng = np.random.default_rng(n_lanes * 100 + w)
    codes, _, base, nv, _, _, _, _, active = _scan_inputs(rng, n_lanes, m, w)
    if name == "tied":
        codes[:] = 0
    rank = rank_operands(kind, m + w, codes.shape[0], n_lanes, w, dim,
                         tie_rows=m)
    if name == "tied":
        rank = _all_tied(rank)
    if name == "nan_inf":
        rank = _nan_inf_rows(rank)
    args = [torch.from_numpy(a).to(card) for a in (codes, base, nv, active)]
    rank = _on_card(rank, card)
    got = cluster_scan.ranked_cluster_scan(args[0], rank, *args[1:], dim,
                                           ef, m)
    want = ref.ranked_cluster_scan_ref(args[0], rank, *args[1:], dim, ef, m)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        assert _equal_bits(g, wnt)
    assert int(nv[0]) == 0                    # lane 0's cluster is empty


def test_ranked_kernels_count_one_launch_each(card):
    """One beam_search and one cluster_scan launch, whatever the rank."""
    codes, rank, nbrs, base, entry, active = (
        t.to(card) if isinstance(t, torch.Tensor) else _on_card(t, card)
        for t in ranked_case("exact", 3, 4, 60, 8, 16, 128))
    ops.reset_launch_counts()
    ops.ranked_beam_search(codes, rank, nbrs, base, entry, active, 128, 10,
                           20, 60)
    nv = torch.full((4,), 60, dtype=torch.int32, device=card)
    ops.ranked_cluster_scan(codes, rank, base, nv, active, 128, 10, 60)
    hamming = _on_card(rank_operands("hamming", 3, codes.shape[0], 4, 16,
                                     128), card)
    ops.ranked_beam_search(codes, hamming, nbrs, base, entry, active, 128,
                           10, 20, 60)
    ops.ranked_cluster_scan(codes, hamming, base, nv, active, 128, 10, 60)
    counts = ops.launch_counts()
    assert counts["beam_search"] == 2 and counts["cluster_scan"] == 2


def test_query_path_arithmetic_is_batch_invariant_on_the_card(card):
    """On the card a library product or reduction of 256 rows differs in
    its last bits from the same rows of a 4,096-row one. The lane LUTs
    (``rabitq.prepare_query``, ``sign_code``) and the rerank distances
    sum through ``fixed_order``, so every row is the same bits in any
    batch: the sharded tier's partials equal the single engine's."""
    from repro_torch.core import rabitq, rerank
    g = torch.Generator(device=card).manual_seed(5)
    vec = torch.randn((200_000, 128), generator=g, device=card) * 3
    q = torch.randn((4096, 128), generator=g, device=card) * 3
    cand = torch.randint(-1, 200_000, (4096, 320), generator=g,
                         device=card, dtype=torch.int32)
    cent = torch.randn((4096, 128), generator=g, device=card) * 3
    rot = rabitq.random_rotation(g, 128, device=card)
    full = rerank.exact_sqdist(q, cand, vec)
    lut = rabitq.prepare_query(q, cent, rot)
    code = rabitq.sign_code(q, cent, rot, dim=128)
    for a, b in ((0, 1), (0, 100), (0, 256), (1000, 2024), (4000, 4096)):
        assert torch.equal(rerank.exact_sqdist(q[a:b], cand[a:b], vec),
                           full[a:b]), (a, b)
        part = rabitq.prepare_query(q[a:b], cent[a:b], rot)
        for got, want in zip(part, lut):
            assert torch.equal(got, want[a:b]), (a, b)
        assert torch.equal(rabitq.sign_code(q[a:b], cent[a:b], rot,
                                            dim=128), code[a:b])


def test_replicated_tier_and_placement_swap_on_the_card(card):
    """A heat-aware tier with hot clusters replicated (multi-owner routing
    through choose_owners) on the card: its ids equal the engine's own
    search bitwise, through the beam_search, topk_select and merge_topk
    kernels; after a rebalanced placement is swapped in (apply_placement
    re-slices the shards on the card) the ids are unchanged; hedged
    dispatch over two replicas a shard gives the same ids."""
    from repro_torch.core import compact_index, engine, placement, topology
    from repro_torch.data import synthetic
    from repro_torch.distributed.straggler import HedgeConfig
    x, _ = synthetic.clustered_vectors(11, 4000, 32, 16)
    q = synthetic.query_set(11, x, 96)
    icfg = compact_index.IndexConfig(dim=32, n_clusters=16, degree=8,
                                     knn_k=16)
    eng = engine.PIMCQGEngine.build(0, x, icfg,
                                    engine.SearchConfig(nprobe=4, ef=16,
                                                        k=5), device=card)
    want = eng.search(q)[0].ids.cpu().numpy()
    heat = np.ones(16)
    heat[[2, 5, 11]] = 40.0
    topo = topology.TopologyConfig(shards=4, buckets=(32, 96),
                                   replicate_hot=3,
                                   replica_factor=3).build(eng, heat=heat)
    assert topo.replicated
    ops.reset_launch_counts()
    rep = topo.run(q)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("beam_search", "topk_select",
                                       "merge_topk")), counts
    np.testing.assert_array_equal(rep.ids, want)
    bpc = eng.index.n_valid.cpu().numpy().astype(np.float64)
    heat2 = np.ones(16)
    heat2[[0, 7, 9]] = 40.0
    old = topo.placement
    new = placement.replicate_hot(
        placement.rebalance(old, heat2, bpc, move_penalty=0.0), heat2, bpc,
        top_h=3, copies=2, cap=old.resident_table.shape[1] - old.per_shard)
    topo.apply_placement(new)
    assert all(g[0].placed.codes.device == card for g in topo.groups)
    np.testing.assert_array_equal(topo.run(q).ids, want)
    hedged = topology.TopologyConfig(shards=4, replicas=2, buckets=(32, 96),
                                     hedge=HedgeConfig()).build(eng)
    np.testing.assert_array_equal(hedged.run(q).ids, want)


def _card_mutable(card, seed=0, n=20_000, dim=128, clusters=16, slab=128,
                  **kw):
    """A MutableIndex built on the card over a clustered corpus."""
    from repro_torch.core import compact_index
    from repro_torch.core.mutable_index import MutableIndex
    from repro_torch.data import synthetic
    x, _ = synthetic.clustered_vectors(seed, n, dim, clusters)
    icfg = compact_index.IndexConfig(dim=dim, n_clusters=clusters,
                                     degree=kw.pop("degree", 32),
                                     knn_k=kw.pop("knn_k", 64))
    return MutableIndex.build(0, x, icfg, slab=slab, device=card, **kw), x


def _churn_on_card(mut, rng, n_del, n_ins, first):
    """Delete n_del live rows, insert n_ins perturbed copies of live rows
    (the JAX package's update churn), on the card."""
    live = mut.live_ids().cpu().numpy()
    drop = rng.choice(live, n_del, replace=False)
    mut.delete(drop)
    src = rng.choice(mut.live_ids().cpu().numpy(), n_ins)
    vecs = mut.vectors[torch.as_tensor(src, device=mut.device)] + 0.05 * \
        torch.as_tensor(rng.standard_normal((n_ins, mut.dim)),
                        dtype=torch.float32, device=mut.device)
    mut.insert(np.arange(first, first + n_ins), vecs)
    return drop


def test_link_rounds_equal_link_new_on_the_card(card):
    """The mutable index's insert links in rounds across clusters; on the
    card it equals graph.link_new, one node after another on copies of the
    clusters, bit for bit (all its sums run in the fixed order)."""
    from repro_torch.core import graph
    mut, x = _card_mutable(card)
    rng = np.random.default_rng(1)
    mut.delete(rng.choice(mut.live_ids().cpu().numpy(), 300,
                          replace=False))
    before, base = mut.neighbors.clone(), mut.n_valid.clone()
    src = torch.as_tensor(rng.choice(len(x), 400), device=card)
    mut.insert(np.arange(len(x), len(x) + 400), mut.vectors[src] + 0.05)
    want = before.clone()
    for c in torch.nonzero(mut.n_valid != base).flatten().tolist():
        occ, sl = int(mut.n_valid[c]), mut.slot_gid[c]
        xs = torch.zeros((mut.budget, mut.dim), device=card)
        xs[sl >= 0] = mut.vectors[sl[sl >= 0].long()]
        graph.link_new(want[c], xs, occ, range(int(base[c]), occ),
                       r=mut.icfg.degree, knn_k=mut.icfg.knn_k,
                       prune_alpha=mut.icfg.prune_alpha)
    assert torch.equal(mut.neighbors, want)


def test_compact_subset_equals_rebuild_on_the_card(card):
    """compact(subset), each cluster encoded alone, equals rebuild()'s
    clusters, all encoded together, bit for bit on the card; so does the
    encoder over any grouping (a cluster's products run at its own shape,
    its sums in the fixed order)."""
    from repro_torch.core import compact_index
    mut, x = _card_mutable(card, seed=2)
    _churn_on_card(mut, np.random.default_rng(3), 500, 400, len(x))
    subset = sorted(mut.dirty)[1::3]
    mut.mem_bytes = 1
    mut.compact(clusters=subset)
    mut.mem_bytes = 8 << 30
    ridx, _ = mut.rebuild()
    for f in ("codes", "f_add", "neighbors", "entry", "n_valid", "node_ids",
              "alpha", "rho", "shift1", "shift2", "residual_norm",
              "cos_theta"):
        assert torch.equal(getattr(mut, f)[subset],
                           getattr(ridx, f)[subset]), f
    whole = compact_index.encode_clusters(mut.vectors, ridx.node_ids,
                                          mut.centroids, mut.rotation,
                                          mut.icfg)
    for group in ([0, 7, 3], [15], list(range(8, 15))):
        part = compact_index.encode_clusters(
            mut.vectors, ridx.node_ids[group], mut.centroids[group],
            mut.rotation, mut.icfg, mem_bytes=1)
        for k, v in part.items():
            assert torch.equal(v, whole[k][group]), (k, group)


def test_mutable_tier_apply_mid_run_on_the_card(card):
    """A 4-shard mutable tier on the card, churned, swapped in by apply
    from a run's ticker: no deleted id is served, the ids equal a single
    engine's over the same snapshot, and again after compact()."""
    from repro_torch.core import engine, topology
    from repro_torch.data import synthetic
    mut, x = _card_mutable(card, seed=4)
    q = synthetic.query_set(4, x, 128)
    scfg = engine.SearchConfig(nprobe=4, ef=32, k=10)
    topo = topology.TopologyConfig(shards=4, mutable=True,
                                   buckets=(32, 128)).build(
        mut.to_engine(scfg, n_shards=4))
    drop = _churn_on_card(mut, np.random.default_rng(5), 1000, 800, len(x))
    ticks = []

    def ticker(t):
        if not ticks:
            topo.apply(mut)
        ticks.append(t)
    ops.reset_launch_counts()
    rep = topo.run(q, ticker=ticker)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("beam_search", "topk_select",
                                       "merge_topk")), counts
    assert not np.isin(rep.ids, drop).any()
    single = mut.to_engine(scfg)
    np.testing.assert_array_equal(rep.ids, single.search(q)[0].ids.cpu())
    mut.compact()
    topo.apply(mut)
    single.refresh(*mut.snapshot())
    np.testing.assert_array_equal(topo.run(q).ids,
                                  single.search(q)[0].ids.cpu())


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, types and bits (floats compared as their bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return torch.equal(a, b)


def test_two_builds_of_one_seed_are_the_same_bits_on_the_card(card):
    """ROADMAP C5: k-means summed each cluster's members with index_add_,
    whose float order the card does not fix, so a seed built another index
    on every run. The members are now summed in fixed_order's order: two
    builds of one seed agree in every CompactIndex and HostStore field,
    bit for bit, and so do two k-means runs on the build's sample."""
    from repro_torch.core import compact_index, ivf
    from repro_torch.data import synthetic
    x, _ = synthetic.clustered_vectors(6, 60_000, 128, 64)
    xt = torch.from_numpy(x).to(card)
    icfg = compact_index.IndexConfig(dim=128, n_clusters=64, degree=32,
                                     knn_k=64, kmeans_sample=16_384)
    km = [ivf.kmeans(torch.Generator(device=card).manual_seed(0), xt, 64,
                     iters=12, sample=16_384) for _ in range(2)]
    for f in km[0]._fields:
        assert _same_bits(getattr(km[0], f), getattr(km[1], f)), f
    builds = [compact_index.build_compact_index(
        torch.Generator(device=card).manual_seed(0), xt, icfg)
        for _ in range(2)]
    (ia, ha), (ib, hb) = builds
    for f in ia._fields:
        a, b = getattr(ia, f), getattr(ib, f)
        assert a == b if f == "dim" else _same_bits(a, b), f
    for f in ha._fields:
        assert _same_bits(getattr(ha, f), getattr(hb, f)), f


def _hold_tier(got, want) -> None:
    """A tier's top-k against a reference (ROADMAP C4's rule): distances
    the same bits in every slot, ids equal wherever no other candidate
    lies at exactly the slot's distance."""
    (gi, gd), (wi, wd) = got, want
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))
    diff = gi != wi
    for i in np.nonzero(diff.any(1))[0]:
        for v in np.unique(wd[i][diff[i]]):
            sel = wd[i] == v
            assert v == wd[i, -1] or sorted(gi[i][sel]) == sorted(
                wi[i][sel]), (i, gi[i], wi[i])


def _card_mesh_rank(rank: int, world: int, init: str, out: str) -> None:
    """One rank of a 2-rank gloo mesh on the card: rank 0 serves mesh
    tiers beside their in-process twins and saves both, rank 1 follows."""
    import pathlib
    import torch.distributed as dist
    from repro_torch.core import compact_index, engine, execbackend, topology
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as lmesh
    dev = lmesh.init_shard_group(rank, world, init_method=init,
                                 device="cuda", timeout_s=120)
    try:
        mesh = lmesh.make_shard_mesh(world, device="cuda")
        if rank != 0:
            execbackend.MeshBackend.follow(mesh, dev)
            return
        stopper = execbackend.MeshBackend(mesh=mesh)
        try:
            x, _ = synthetic.clustered_vectors(12, 8000, 32, 16)
            q = synthetic.query_set(12, x, 37)
            icfg = compact_index.IndexConfig(dim=32, n_clusters=16,
                                             degree=8, knn_k=16)
            res = {}
            for scan in ("beam", "gemv"):
                eng = engine.PIMCQGEngine.build(
                    0, x, icfg, engine.SearchConfig(nprobe=3, ef=16, k=5,
                                                    scan=scan),
                    device=dev)
                cfg = topology.TopologyConfig(
                    shards=world, buckets=(8, 64), fill_threshold=64,
                    wait_limit_s=1e-3)
                inproc = cfg.build(eng)
                # queries whose probes all fall on shard 0: owner 1 sees no
                # probe in their flush
                tables, touches, _, _ = inproc._route_probes(q)
                only0 = q[touches[:, 0] & ~touches[:, 1]][:8]
                mb = execbackend.MeshBackend(mesh=mesh)
                tier = topology.TopologyConfig(
                    shards=world, buckets=(8, 64), fill_threshold=64,
                    wait_limit_s=1e-3, exec=mb).build(eng)
                tier.warm()
                mb.rank_stats(reset=True)
                for name, qq in (("all", q), ("only0", only0)):
                    for label, t in (("mesh", tier), ("inproc", inproc)):
                        rep = t.run(qq)
                        res[f"{scan}.{name}.{label}.ids"] = rep.ids
                        res[f"{scan}.{name}.{label}.dists"] = rep.dists
                    res[f"{scan}.{name}.n"] = np.asarray(len(qq))
                stats = mb.rank_stats()
                for s in stats:
                    res[f"{scan}.launches.{s['rank']}"] = np.asarray(
                        [s["launches"]["topk_select"],
                         s["launches"]["beam_search"],
                         s["launches"]["cluster_scan"]])
            np.savez(pathlib.Path(out) / "card_mesh.npz", **res)
        finally:
            stopper.close()
    finally:
        dist.destroy_process_group()


def test_two_rank_mesh_on_the_card_equals_inproc_tier(card, tmp_path,
                                                     monkeypatch):
    """exec="mesh" on the card: two ranks over gloo share one card (each a
    process of its own), bitwise against the in-process tier under C4's
    rule: every query of a 37-query stream (flushes of fewer rows than
    their bucket), and a stream whose probes all fall on shard 0 (owner 1
    searches nothing), by beam and by gemv; every rank launched its
    kernels. The libraries are built here first, so the ranks only load
    them."""
    import torch.multiprocessing as mp
    from repro_torch.kernels import _build
    _build.build_all()
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")   # one host: loopback
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=_card_mesh_rank,
                         args=(r, 2, init, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert [p.exitcode for p in procs] == [0, 0]
    r = np.load(tmp_path / "card_mesh.npz")
    for scan in ("beam", "gemv"):
        for name in ("all", "only0"):
            key = f"{scan}.{name}."
            assert len(r[key + "mesh.ids"]) == int(r[key + "n"]) > 0
            _hold_tier((r[key + "mesh.ids"], r[key + "mesh.dists"]),
                       (r[key + "inproc.ids"], r[key + "inproc.dists"]))
        kernel = 1 if scan == "beam" else 2
        for rank in range(2):
            launches = r[f"{scan}.launches.{rank}"]
            assert launches[0] > 0 and launches[kernel] > 0, launches


def _attn_inputs(card, b, sq, sk, hq, hkv, d, q_dtype, kv_dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g, device=card).to(q_dtype)
    k = torch.randn((b, sk, hkv, d), generator=g, device=card).to(kv_dtype)
    v = torch.randn((b, sk, hkv, d), generator=g, device=card).to(kv_dtype)
    return q, k, v


# float32 sums in another order than the plain version's: 2e-5 in float32;
# in bf16 output that order flips a rounding of q.dtype, one bf16 ulp at the
# outputs' size (|out| < 4: 2^-6), hence 1.6e-2.
_ATOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}


def _assert_attn_close(got, want, flip=None):
    """Within _ATOL everywhere and, for a bf16 output, within one bf16 ulp
    of each element's own value: the gap between neighbouring bf16 values is
    at most 2^-7 of the smaller one, so small outputs (late causal rows
    average many keys) get a bound of their own size, not the largest
    output's. ``flip`` (per row) adds ``ref.flash_attention_flip_bound``
    to that per-element bound: the tensor-core kernel against its twin,
    where one weight may round to the other bf16 neighbour."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, rtol=0, atol=_ATOL[want.dtype])
    if want.dtype == torch.bfloat16:
        extra = 0.0 if flip is None else flip
        over = (g - w).abs() > 2.0 ** -7 * w.abs() + 2e-5 + extra
        assert not over.any(), f"{int(over.sum())} elements over the bound"


def _assert_bf16_kernel(got, q, k, v, kw):
    """The tensor-core kernel (bf16 q) against its twin by the rule above
    with the flip term, and against the float32 plain version within the
    derived rounding bound."""
    twin = ref.flash_attention_ref(q, k, v, operands=torch.bfloat16, **kw)
    _assert_attn_close(got, twin, ref.flash_attention_flip_bound(q, k, v,
                                                                  **kw))
    plain = ref.flash_attention_ref(q, k, v, **kw)
    bound = ref.flash_attention_rounding_bound(q, k, v, **kw)
    assert ((got.double() - plain.double()).abs() <= bound).all()


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,q_off,valid,qt,kvt", [
    (2, 64, 64, 4, 4, 64, True, None, 0, None, "f32", "f32"),
    (1, 100, 100, 8, 2, 80, True, None, 0, None, "bf16", "f32"),  # serving
    (2, 33, 130, 4, 1, 96, True, None, 97, None, "f32", "f32"),   # q_offset
    (1, 200, 200, 4, 4, 128, True, 48, 0, None, "bf16", "bf16"),  # window
    (2, 70, 160, 8, 2, 80, True, 40, 60, 150, "bf16", "f32"),     # cache
    (1, 17, 93, 4, 2, 64, False, None, 0, 77, "f32", "bf16"),     # noncausal
    (1, 5, 300, 2, 1, 96, False, 100, 250, None, "f32", "f32"),
    (3, 1, 65, 4, 2, 128, True, None, 64, None, "bf16", "f32"),   # one row
    (1, 1100, 1100, 8, 2, 80, True, None, 0, None, "bf16", "f32"),  # 17 tiles
    (1, 1100, 1100, 32, 8, 80, True, None, 0, None, "bf16", "f32"),  # danube
    (1, 150, 300, 8, 2, 128, True, None, 150, None, "bf16", "bf16"),
    # head dim 160 (stablelm-12b): causal, ragged, GQA group 4, bf16 q over
    # float32 K/V; a window over bf16 K/V; the float32 route
    (2, 150, 213, 8, 2, 160, True, None, 63, None, "bf16", "f32"),
    (1, 200, 200, 4, 1, 160, True, 48, 0, None, "bf16", "bf16"),
    (2, 70, 130, 4, 1, 160, True, None, 50, 125, "f32", "f32"),
    # head dim 256 (recurrentgemma-9b: 16 query heads over one KV head, a
    # window): the split-dv kernel for bf16 q, GQA groups 16, 4 and 1,
    # ragged Sq / Sk, q_offset, kv_valid_len < Sk, a window that bites,
    # bf16 and float32 K/V; the float32 route
    (2, 300, 300, 16, 1, 256, True, 100, 0, None, "bf16", "bf16"),
    (1, 150, 400, 16, 1, 256, True, 130, 230, 390, "bf16", "f32"),
    (2, 77, 200, 8, 2, 256, True, None, 100, 190, "bf16", "bf16"),
    (1, 129, 129, 4, 4, 256, True, 64, 0, None, "bf16", "f32"),
    (1, 33, 300, 2, 1, 256, False, 80, 250, 290, "bf16", "bf16"),
    (2, 70, 130, 16, 1, 256, True, 50, 50, 125, "f32", "f32"),
    (1, 65, 65, 4, 2, 256, True, None, 0, None, "f32", "bf16"),
    # a decode step over a sequence-split cache (``attention._seq_split_step``):
    # one float32 row over the rank's bf16 slots, non-causal, the valid
    # slots of a rolling cache; a window from a query past the rank's slots
    (2, 1, 96, 32, 8, 80, False, None, 0, 40, "f32", "bf16"),
    (2, 1, 96, 32, 8, 80, False, 64, 150, 96, "f32", "bf16"),
    (1, 1, 64, 16, 1, 256, False, 40, 70, 64, "f32", "bf16"),
    # the split-KV decode route's edges (float32 q, Sq x g <= 64): chunks
    # that some rows cannot see (a window past a causal block), a single
    # valid key, Sq x g = 64 over float32 K/V against 65 (flash_fwd_kernel),
    # hd 256 at g 16, B 1 over 32,768 slots
    (1, 16, 700, 4, 1, 80, True, 40, 594, 610, "f32", "bf16"),
    (2, 1, 96, 32, 8, 80, False, None, 0, 1, "f32", "bf16"),
    (1, 16, 200, 64, 16, 80, True, None, 184, None, "f32", "f32"),
    (1, 13, 150, 10, 2, 64, True, None, 137, None, "f32", "bf16"),
    (2, 4, 300, 16, 1, 256, True, 100, 296, None, "f32", "bf16"),
    (1, 1, 32768, 32, 8, 80, False, None, 0, None, "f32", "bf16"),
    # phase 11s's sequence-split decode call on a rank: float32 K/V
    (4, 1, 130, 32, 8, 80, False, None, 512, 130, "f32", "f32"),
])
def test_flash_attention_kernel_matches_plain(card, b, sq, sk, hq, hkv, d,
                                              causal, window, q_off, valid,
                                              qt, kvt):
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    q, k, v = _attn_inputs(card, b, sq, sk, hq, hkv, d, types[qt], types[kvt],
                           seed=sq)
    kw = dict(causal=causal, window=window, q_offset=q_off,
              kv_valid_len=valid)
    got = flash_attn.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == (b, sq, hq, d)
    if q.dtype == torch.bfloat16:
        _assert_bf16_kernel(got, q, k, v, kw)
    else:
        _assert_attn_close(got, ref.flash_attention_ref(q, k, v, **kw))


def test_flash_attention_kernel_strided_and_tpu_view(card):
    """A slice of a longer cache (strided K/V) and the TPU kernel's
    (BH, S, d) signature both go through the same launch."""
    q, k, v = _attn_inputs(card, 2, 96, 160, 8, 2, 80, torch.bfloat16,
                           torch.float32)
    ks, vs = k[:, :96], v[:, :96]
    assert not ks.is_contiguous()
    _assert_bf16_kernel(flash_attn.flash_attention(q, ks, vs, causal=True),
                        q, ks.contiguous(), vs.contiguous(),
                        dict(causal=True))
    qf, kf, vf = (t[:, :, 0].contiguous().float() for t in (q, ks, vs))
    ops.reset_launch_counts()
    got = flash_attn.flash_attention_fwd(qf[:, 32:], kf, vf, causal=True,
                                         q_offset=32)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got, ref.flash_attention_ref(
        qf[:, 32:, None], kf[:, :, None], vf[:, :, None], causal=True,
        q_offset=32)[:, :, 0], rtol=0, atol=2e-5)


@pytest.mark.parametrize("kvt", ["f32", "bf16"])
def test_flash_attention_decode_route_unaligned_rows(card, kvt):
    """K/V rows that do not start on 16-byte boundaries (a head dim sliced
    out of a wider buffer, and a head dim that is not a whole number of
    16-byte groups) take the decode kernel's element loads."""
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn((2, 1, 32, 80), generator=g, device=card)
    wide = torch.randn((2, 300, 8, 83), generator=g, device=card).to(
        types[kvt])
    k, v = wide[..., 1:81], wide[..., 3:83]
    assert k.stride(-1) == 1 and not k.is_contiguous()
    kw = dict(causal=False, window=100, q_offset=280, kv_valid_len=290)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    _assert_attn_close(out, ref.flash_attention_ref(q, k, v, **kw))
    _, want = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert ((lse - want).abs()
            <= ref.flash_attention_lse_bound(q, k, want, **kw)).all()
    q12 = torch.randn((1, 3, 8, 12), generator=g, device=card)
    k12 = torch.randn((1, 50, 2, 12), generator=g, device=card).to(
        types[kvt])
    v12 = torch.randn((1, 50, 2, 12), generator=g, device=card).to(
        types[kvt])
    kw = dict(causal=True, q_offset=47)
    _assert_attn_close(flash_attn.flash_attention(q12, k12, v12, **kw),
                       ref.flash_attention_ref(q12, k12, v12, **kw))


@pytest.mark.parametrize("kvt", ["f32", "bf16"])
def test_flash_attention_kernel_unaligned_rows(card, kvt):
    """Rows that do not start on 16-byte boundaries (a head dim sliced out
    of a wider buffer) take the tensor-core kernel's element loads."""
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=card).manual_seed(3)
    qb = torch.randn((1, 90, 8, 82), generator=g, device=card).bfloat16()
    kb = torch.randn((1, 130, 2, 83), generator=g, device=card).to(types[kvt])
    vb = torch.randn((1, 130, 2, 83), generator=g, device=card).to(types[kvt])
    q, k, v = qb[..., 1:81], kb[..., 3:83], vb[..., 2:82]
    kw = dict(causal=True, q_offset=40)
    got = flash_attn.flash_attention(q, k, v, **kw)
    _assert_bf16_kernel(got, q.contiguous(), k.contiguous(), v.contiguous(),
                        kw)


def test_flash_attention_kernel_refuses_rows_without_keys(card):
    q, k, v = _attn_inputs(card, 1, 16, 32, 4, 2, 64, torch.float32,
                           torch.float32)
    with pytest.raises(ValueError, match="need their own key"):
        flash_attn.flash_attention(q, k, v, causal=True, q_offset=20)
    with pytest.raises(ValueError, match="need their own key"):
        flash_attn.flash_attention(q, k, v, causal=True, kv_valid_len=8)
    with pytest.raises(ValueError, match=r"outside \[1"):
        flash_attn.flash_attention(q, k, v, causal=False, kv_valid_len=0)
    with pytest.raises(ValueError, match="q_offset -1"):
        flash_attn.flash_attention(q, k, v, causal=False, q_offset=-1)
    with pytest.raises(ValueError, match="no valid key"):
        flash_attn.flash_attention(q, k, v, causal=False, window=4,
                                   q_offset=40)
    # past the widest instantiation (256), and not the MLA pair
    wide = _attn_inputs(card, 1, 16, 32, 4, 2, 264, torch.float32,
                        torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        flash_attn.flash_attention(*wide, causal=True)


# The C6 repair: the smoke configs' head dims (8 mistral, 12 phi3, 16
# danube / stablelm / grok) and the deepseek smoke's MLA pair (dk 40, dv
# 32) run in the instantiation that holds them, zero-padded in the kernel;
# heads in (160, 256) run in the 256 instantiation the same way.
@pytest.mark.parametrize("dk,dv", [(8, 8), (12, 12), (16, 16), (40, 32),
                                   (192, 192), (200, 176)])
@pytest.mark.parametrize("qt,kvt", [("bf16", "f32"), ("bf16", "bf16"),
                                    ("f32", "f32")])
def test_flash_attention_kernel_padded_head_dims(card, dk, dv, qt, kvt):
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=card).manual_seed(dk * 100 + dv)
    b, sq, sk, hq, hkv = 2, 70, 150, 4, 2
    q = torch.randn((b, sq, hq, dk), generator=g, device=card).to(types[qt])
    k = torch.randn((b, sk, hkv, dk), generator=g, device=card).to(types[kvt])
    v = torch.randn((b, sk, hkv, dv), generator=g, device=card).to(types[kvt])
    for kw in (dict(causal=True, q_offset=60, kv_valid_len=140),
               dict(causal=True, window=16, q_offset=80)):
        ops.reset_launch_counts()
        got = flash_attn.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 1
        assert got.shape == (b, sq, hq, dv) and got.dtype == q.dtype
        if q.dtype == torch.bfloat16:
            _assert_bf16_kernel(got, q, k, v, kw)
        else:
            _assert_attn_close(got, ref.flash_attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,valid,kvt", [
    (2, 300, 1500, 20, 20, 64, None, "bf16"),   # whisper's cross, g 1
    (2, 300, 300, 20, 20, 64, None, "bf16"),    # its encoder, one tile
    (1, 1, 1500, 20, 20, 64, None, "f32"),      # a decode step's cross
    (3, 1, 70, 14, 2, 64, None, "f32"),         # Sq = 1, g 7
    (1, 129, 1500, 14, 2, 64, 1400, "bf16"),    # g 7, kv_valid_len < Sk
    (2, 65, 150, 7, 1, 64, None, "f32"),        # g 7 over one KV head
    (2, 70, 150, 4, 4, 16, None, "f32"),        # the whisper smoke's hd
    (2, 9, 12, 7, 1, 8, None, "bf16"),          # internvl2 smoke's, F 12
])
def test_flash_attention_tensor_core_route_without_the_causal_mask(
        card, b, sq, sk, hq, hkv, d, valid, kvt):
    """bf16 q (``flash_tc_kernel``), causal=False: GQA groups 1 and 7 (a
    head set of one), Sq != Sk with ragged tiles (1,500 keys are 23 tiles
    and 28 keys), Sq = 1 (a decode step's cross-attention over the float32
    cache), kv_valid_len < Sk, the smoke head dims 16 and 8 zero-padded
    into 64: against the twin and the float32 plain version by the bf16
    rule."""
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    q, k, v = _attn_inputs(card, b, sq, sk, hq, hkv, d, torch.bfloat16,
                           types[kvt], seed=sq * 7 + sk)
    kw = dict(causal=False, kv_valid_len=valid)
    ops.reset_launch_counts()
    got = flash_attn.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.shape == (b, sq, hq, d) and got.dtype == torch.bfloat16
    _assert_bf16_kernel(got, q, k, v, kw)


def _mla_inputs(card, b, sq, sk, hq, hkv, kvt, alias, seed):
    """q_all (B, Sq, Hq, 576) bf16 and a latent cache (B, Sk, Hkv, 576):
    v is the view cache[..., :512] when ``alias``, else a tensor of its
    own."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, sq, hq, 576), generator=g, device=card).bfloat16()
    kc = torch.randn((b, sk, hkv, 576), generator=g, device=card).to(kvt)
    v = kc[..., :512] if alias else torch.randn(
        (b, sk, hkv, 512), generator=g, device=card).to(kvt)
    return q, kc, v


@pytest.mark.parametrize("b,sq,sk,hq,hkv,causal,q_off,valid,alias,kvt", [
    (1, 100, 100, 16, 1, True, 0, None, True, "bf16"),    # deepseek prefill
    (3, 70, 200, 16, 1, True, 120, 190, True, "bf16"),    # cache prefill
    (1, 130, 130, 1, 1, True, 0, None, False, "bf16"),    # g 1, own V
    (3, 33, 100, 16, 1, True, 60, 93, False, "bf16"),     # g 16, own V
    (2, 65, 65, 16, 1, True, 0, None, True, "f32"),       # float32 cache
    (1, 40, 140, 16, 1, True, 100, None, False, "f32"),
    (1, 50, 300, 16, 1, False, 0, 280, True, "bf16"),     # not causal
    (2, 40, 90, 32, 2, True, 50, None, True, "bf16"),     # two KV heads
    (1, 300, 300, 8, 1, True, 0, None, True, "bf16"),     # g 8, 5 tiles
])
def test_flash_attention_mla_kernel(card, b, sq, sk, hq, hkv, causal, q_off,
                                    valid, alias, kvt):
    """The latent-attention instantiation (dk 576, dv 512) against its twin
    and the float32 plain version, by the bf16 rule of the other head
    dims; v a view of the cache's rows or a tensor of its own."""
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    q, k, v = _mla_inputs(card, b, sq, sk, hq, hkv, types[kvt], alias,
                          seed=sq + sk)
    assert (v.data_ptr() == k.data_ptr()) == alias
    kw = dict(causal=causal, q_offset=q_off, kv_valid_len=valid)
    ops.reset_launch_counts()
    got = flash_attn.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.shape == (b, sq, hq, 512) and got.dtype == torch.bfloat16
    _assert_bf16_kernel(got, q, k, v, kw)


# The split-dv kernel (576, 512) and the wide kernel (256) where their
# design has edges: 1, 2 and an odd number of 64-key tiles; an odd count of
# blocks a KV head (a cluster pair padded by a block of no rows); causal
# neighbours in a cluster pair whose own tiles differ in number (the pair
# stages the union); a window that starts inside a tile; kv_valid_len
# inside the last tile; GQA head sets of 16, 8, 4, 2 and 1 (at 1 the wide
# kernel's warpgroups see different tiles); float32 K/V and an own V
# (the producer's loads and the V ring); capped. b, sq, sk, hq, hkv, dk,
# dv, causal, window, q_offset, kv_valid_len, K/V type, v a view of k, cap
SPLIT_EDGES = [
    (2, 40, 40, 16, 1, 576, 512, True, None, 0, None, "bf16", True, 0.0),
    (1, 128, 128, 16, 1, 576, 512, True, None, 0, None, "bf16", True, 0.0),
    (1, 16, 74, 16, 1, 576, 512, True, None, 58, None, "bf16", True, 0.0),
    (1, 9, 150, 16, 1, 576, 512, True, None, 141, None, "bf16", True, 0.0),
    (1, 100, 200, 16, 1, 576, 512, True, 37, 100, None, "bf16", True, 2.0),
    (2, 50, 200, 16, 1, 576, 512, True, None, 100, 150, "bf16", True, 0.0),
    (1, 70, 70, 8, 1, 576, 512, True, None, 0, None, "bf16", True, 0.0),
    (1, 70, 100, 8, 2, 576, 512, True, None, 30, None, "bf16", False, 0.0),
    (1, 66, 66, 4, 2, 576, 512, False, None, 0, 60, "bf16", True, 1.0),
    (1, 130, 130, 2, 2, 576, 512, True, None, 0, None, "bf16", True, 0.0),
    (1, 70, 130, 16, 1, 576, 512, True, None, 60, None, "f32", True, 2.0),
    (2, 30, 30, 16, 1, 256, 256, True, None, 0, None, "bf16", False, 0.0),
    (1, 100, 100, 16, 1, 256, 256, True, None, 0, None, "bf16", False, 0.0),
    (1, 32, 84, 16, 1, 256, 256, True, None, 52, None, "bf16", False, 0.0),
    (1, 17, 190, 16, 1, 256, 256, True, None, 173, None, "bf16", False, 0.0),
    (1, 200, 300, 16, 1, 256, 256, True, 100, 100, None, "bf16", False, 2.0),
    (1, 60, 300, 16, 1, 256, 256, True, 64, 230, 290, "bf16", False, 0.0),
    (1, 90, 90, 8, 1, 256, 256, True, 50, 0, None, "bf16", True, 0.0),
    (1, 90, 150, 8, 2, 256, 256, True, None, 60, None, "bf16", False, 1.0),
    (1, 100, 100, 4, 2, 256, 256, True, None, 0, None, "bf16", False, 0.0),
    (1, 200, 260, 2, 2, 256, 256, False, 90, 60, None, "bf16", False, 0.0),
    (1, 150, 150, 16, 1, 256, 256, True, 64, 0, None, "f32", False, 0.0),
    (2, 33, 300, 16, 1, 256, 256, False, 80, 250, 290, "f32", False, 2.0),
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dk,dv,causal,window,q_off,valid,"
                         "kvt,alias,cap", SPLIT_EDGES)
def test_flash_attention_split_kernels_on_their_edges(
        card, b, sq, sk, hq, hkv, dk, dv, causal, window, q_off, valid, kvt,
        alias, cap):
    """One launch, its output against the twin and the float32 plain
    version by the bf16 rule, its rows' logsumexp within
    ``ref.flash_attention_lse_bound`` of the twin's, and the output with lse
    the bits of the one without."""
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=card).manual_seed(sq * 31 + sk + dk)
    scale = 2.0 if cap else 1.0
    q = (scale * torch.randn((b, sq, hq, dk), generator=g, device=card)).to(
        torch.bfloat16)
    k = (scale * torch.randn((b, sk, hkv, dk), generator=g, device=card)).to(
        types[kvt])
    v = k[..., :dv] if alias else torch.randn(
        (b, sk, hkv, dv), generator=g, device=card).to(types[kvt])
    kw = dict(causal=causal, window=window, q_offset=q_off,
              kv_valid_len=valid, softcap=cap)
    ops.reset_launch_counts()
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert out.shape == (b, sq, hq, dv) and out.dtype == torch.bfloat16
    assert torch.equal(out, flash_attn.flash_attention(q, k, v, **kw))
    _assert_bf16_kernel(out, q, k, v, kw)
    _, twin = ref.flash_attention_ref(q, k, v, operands=torch.bfloat16,
                                      return_lse=True, **kw)
    assert ((lse - twin).abs()
            <= ref.flash_attention_lse_bound(q, k, twin, **kw)).all()


def test_flash_attention_float32_route_refuses_the_mla_pair(card):
    q, k, v = _mla_inputs(card, 1, 8, 8, 16, 1, torch.float32, True, 0)
    with pytest.raises(ValueError, match=r"float32 route does not take"):
        flash_attn.flash_attention(q.float(), k, v, causal=True)


def _archs():
    from repro_torch.configs import all_arch_ids
    return list(all_arch_ids())


@pytest.mark.parametrize("arch", _archs())
def test_serve_runs_on_the_card(card, arch):
    """ROADMAP C6: ``serve.run(arch, rag=True)`` on the card for every
    arch, all of which the port serves (smoke head dims 8, 12, 16 and the
    MLA pair 40 / 32 go through the kernel, zero-padded; whisper's encoder
    and cross-attention without the causal mask, internvl2's patches before
    the prompt), and the card's prefill logits held against the plain
    route on the CPU with the same params and stub frames / patches.

    Tolerance: each layer's attention is the tensor-core kernel (bf16 q) on
    the card, within its twin's bound (one bf16 flip, 2^-7 of an element)
    of the bf16 twin, which is within ``flash_attention_rounding_bound`` of
    the float32 plain version the CPU runs; the bf16 matmuls around it
    round on both sides (2^-8 relative each) in other orders. Carried over
    the smoke's 2-3 layers that is a few percent of the logits: 5% of the
    largest |logit|, the bound of the bf16 JAX-parity tests and of the
    smoke's decode-vs-prefill check."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    ops.reset_launch_counts()
    toks, ids = serve.run(arch, requests=2, prompt_len=16, gen=4, rag=True,
                          verbose=False, device="cuda")
    assert toks.shape == (2, 4) and ids.shape == (2, 4)
    cfg = get_smoke(arch)
    attention = sum(cfg.mixer_of(i) in ("attn", "swa", "lattn", "mla")
                    for i in range(cfg.n_layers))   # mamba2: none
    # whisper: its encoder's layers and a cross-attention a decoder layer
    # in the prefill, then the cross-attention in each of the 3 decode steps
    attention += cfg.enc_layers + cfg.n_layers * 4 if cfg.enc_layers else 0
    assert ops.launch_counts()["flash_attention"] == attention
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(3))
    cpu_gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 19), generator=cpu_gen)
    stub = {}
    if cfg.n_frames:
        stub["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                     generator=cpu_gen)
    if cfg.n_patches:
        stub["patches"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                      generator=cpu_gen)
    got, _ = model.prefill(params, tokens.to(card), model.init_cache(
        2, 24, dtype=torch.float32, device=card),
        **{k: t.to(card) for k, t in stub.items()})
    cpu = _to(params, "cpu")
    want, _ = model.prefill(cpu, tokens, model.init_cache(
        2, 24, dtype=torch.float32, device="cpu"), **stub)
    got, want = got.float().cpu(), want.float()
    real = slice(0, cfg.vocab_size)
    assert torch.isfinite(got[..., real]).all()
    scale = float(want[..., real].abs().max())
    assert float((got - want)[..., real].abs().max()) <= 0.05 * scale


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_recurrent_blocks_on_the_card_match_the_cpu(card, arch):
    """Mamba2's SSD (``ssm.ssd_apply``: the chunked form with a padded last
    chunk, then decode steps) and the RG-LRU (``rglru.rglru_apply``: the
    log-depth scan, then decode steps) on the card against the same calls
    on the CPU with the same float32 params and inputs. Both sides run
    float32 (TF32 is off for matmuls by default); the card's reductions and
    exp / softplus differ in their last bits, which the recurrence carries:
    1e-4 of the largest |output|."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import rglru, ssm
    import dataclasses
    cfg = dataclasses.replace(get_smoke(arch), param_dtype="float32")
    mamba = arch.startswith("mamba")
    init, apply, empty = (ssm.ssd_init, ssm.ssd_apply, ssm.ssm_empty_cache) \
        if mamba else (rglru.rglru_init, rglru.rglru_apply,
                       rglru.rglru_empty_cache)
    p = init(torch.Generator().manual_seed(5), cfg)
    x = torch.randn((2, 27, cfg.d_model),
                    generator=torch.Generator().manual_seed(6)) * 0.5
    outs = {}
    for dev in ("cpu", card):
        pd = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in p.items()}
        cache = empty(cfg, 2, torch.float32, device=dev)
        y, cache = apply(pd, x[:, :24].to(dev), cfg, cache=cache)
        ys = [y]
        for t in range(24, 27):
            y, cache = apply(pd, x[:, t:t + 1].to(dev), cfg, cache=cache)
            ys.append(y)
        outs[str(dev)] = (torch.cat(ys, 1).cpu(), cache)
    got, cg = outs[str(card)]
    want, cw = outs["cpu"]
    assert cg.pos == cw.pos == (32 + 3 if mamba else 27)   # C7's padded pos
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    for a, b in zip(cg[:-1], cw[:-1]):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * max(1.0, float(b.abs().max()))


def test_moe_layer_makes_no_host_sync_on_the_card(card):
    """The MoE layer's shapes are static: moe_apply on the card runs with
    CUDA's sync debug mode set to raise on any host synchronisation, and
    gives the bits of a run without the mode."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe
    cfg = get_smoke("deepseek-v2-lite-16b")
    p = moe.moe_init(torch.Generator(device=card).manual_seed(0), cfg)
    x = torch.randn((2, 40, cfg.d_model), device=card).to(cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.moe_apply(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again, aux2 = moe.moe_apply(p, x, cfg)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    assert torch.equal(out, again) and torch.equal(aux, aux2)


# ---------------------------------------------------------------------------
# the training path: the kernel's logsumexp output, autograd, a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,sk,hq,hkv,dk,dv,causal,window,q_off,valid,qt,"
                         "kvt,alias", [
    (2, 100, 100, 8, 2, 80, 80, True, None, 0, None, "bf16", "bf16", False),
    (1, 130, 130, 32, 8, 80, 80, True, 64, 0, None, "bf16", "bf16", False),
    (2, 70, 160, 8, 2, 80, 80, True, 40, 60, 150, "bf16", "f32", False),
    (2, 64, 64, 4, 4, 64, 64, True, None, 0, None, "f32", "f32", False),
    (1, 17, 93, 4, 2, 96, 96, False, None, 0, 77, "f32", "bf16", False),
    (1, 150, 150, 4, 1, 160, 160, True, None, 0, None, "bf16", "bf16", False),
    (2, 300, 300, 16, 1, 256, 256, True, 100, 0, None, "bf16", "bf16", False),
    (1, 65, 65, 4, 2, 256, 256, True, None, 0, None, "f32", "bf16", False),
    (1, 100, 100, 16, 1, 576, 512, True, 0, 0, None, "bf16", "bf16", True),
    (3, 33, 100, 16, 1, 576, 512, True, None, 60, 93, "bf16", "f32", False),
    (2, 24, 24, 4, 2, 16, 16, True, None, 0, None, "bf16", "bf16", False),
    (2, 24, 24, 4, 4, 12, 12, False, None, 0, None, "f32", "f32", False),
    (1, 20, 20, 4, 1, 40, 32, True, None, 0, None, "bf16", "bf16", False),
    # the sequence-split decode's calls (above)
    (2, 1, 96, 32, 8, 80, 80, False, None, 0, 40, "f32", "bf16", False),
    (2, 1, 96, 32, 8, 80, 80, False, 64, 150, 96, "f32", "bf16", False),
    # the split-KV decode route's edges (above)
    (1, 16, 700, 4, 1, 80, 80, True, 40, 594, 610, "f32", "bf16", False),
    (2, 1, 96, 32, 8, 80, 80, False, None, 0, 1, "f32", "bf16", False),
    (1, 16, 200, 64, 16, 80, 80, True, None, 184, None, "f32", "f32", False),
    (1, 13, 150, 10, 2, 64, 64, True, None, 137, None, "f32", "bf16",
     False),
    (2, 4, 300, 16, 1, 256, 256, True, 100, 296, None, "f32", "bf16", False),
    (1, 1, 32768, 32, 8, 80, 80, False, None, 0, None, "f32", "bf16",
     False),
])
def test_flash_attention_kernel_writes_the_rows_logsumexp(
        card, b, sq, sk, hq, hkv, dk, dv, causal, window, q_off, valid, qt,
        kvt, alias):
    """Each route (the CUDA-core kernel for float32 q, the tensor-core
    kernel, the split-dv kernel at hd 256 and (576, 512), the padded smoke
    dims) writes the rows' logsumexp with ``return_lse``: within
    ``ref.flash_attention_lse_bound`` of its twin's (bf16 q) or the float32
    plain version's (float32 q), and the twin's within it of the float32
    plain version's; its output is the bits of the call without lse."""
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=card).manual_seed(sq + dk)
    q = torch.randn((b, sq, hq, dk), generator=g, device=card).to(types[qt])
    k = torch.randn((b, sk, hkv, dk), generator=g, device=card).to(
        types[kvt])
    v = k[..., :dv] if alias else torch.randn(
        (b, sk, hkv, dv), generator=g, device=card).to(types[kvt])
    kw = dict(causal=causal, window=window or None, q_offset=q_off,
              kv_valid_len=valid)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_attn.flash_attention(q, k, v, **kw))
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    bf = torch.bfloat16 if qt == "bf16" else None
    _, twin = ref.flash_attention_ref(q, k, v, operands=bf, return_lse=True,
                                      **kw)
    _, plain = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    bound = ref.flash_attention_lse_bound(q, k, twin, **kw)
    assert ((lse - twin).abs() <= bound).all()
    assert ((twin - plain).abs() <= bound).all()


@pytest.mark.parametrize("causal,window,hq,hkv,dk,dv,alias", [
    (True, None, 32, 8, 80, 80, False),     # danube's heads
    (True, 48, 8, 2, 64, 64, False),
    (False, None, 4, 4, 64, 64, False),     # whisper's encoder form
    (True, None, 16, 1, 576, 512, True),    # MLA: v a view of k
])
def test_attend_gradients_on_the_card_within_the_bound(card, causal, window,
                                                       hq, hkv, dk, dv,
                                                       alias):
    """``attend``'s gradients on the card (the kernel's forward with its
    logsumexp, the plain backward) and on the CPU (the plain versions),
    bf16 inputs, each within ``ref.flash_attention_bwd_bound`` of
    autograd through the float32 one-pass attention."""
    from repro_torch.models.attention import attend, attend_onepass
    gen = torch.Generator().manual_seed(dk + hq)
    b, s = 2, 130
    q = torch.randn((b, s, hq, dk), generator=gen).bfloat16()
    kk = torch.randn((b, s, hkv, dk), generator=gen).bfloat16()
    vv = kk[..., :dv] if alias else torch.randn(
        (b, s, hkv, dv), generator=gen).bfloat16()
    go = torch.randn((b, s, hq, dv), generator=gen).bfloat16()
    kw = dict(causal=causal, window=window)
    leaves = (q, kk) if alias else (q, kk, vv)
    f32 = [t.float().requires_grad_() for t in leaves]
    fk = f32[1]
    want = torch.autograd.grad(attend_onepass(
        f32[0], fk, fk[..., :dv] if alias else f32[2], **kw), f32,
        go.float())
    for dev in (card, "cpu"):
        x = [t.to(dev).requires_grad_() for t in leaves]
        xv = x[1][..., :dv] if alias else x[2]
        out = attend(x[0], x[1], xv, **kw)
        got = torch.autograd.grad(out, x, go.to(dev))
        with torch.no_grad():
            o, lse = ops.flash_attention(x[0], x[1], xv, return_lse=True,
                                         **kw)
            bq, bk, bv = ref.flash_attention_bwd_bound(
                x[0], x[1], xv, o, lse, go.to(dev), **kw)
        if alias:      # dk and dv both reach the one latent tensor
            bk = bk.clone()
            bk[..., :dv] += bv
        for a, w, bnd in zip(got, want, (bq, bk, bv)):
            assert ((a.double().cpu() - w.double()).abs()
                    <= bnd.cpu()).all()


# the attention softcap on every route: b, sq, sk, hq, hkv, dk, dv, causal,
# window, q_offset, kv_valid_len, q type, K/V type, v a view of k, cap
SOFTCAP_CASES = [
    # the CUDA-core kernel (float32 q): hd 64, ragged, kv_valid_len; hd 256
    (2, 64, 64, 4, 4, 64, 64, True, None, 0, None, "f32", "f32", False, 2.0),
    (1, 17, 93, 4, 2, 96, 96, False, None, 0, 77, "f32", "bf16", False, 1.0),
    (2, 70, 130, 16, 1, 256, 256, True, 50, 50, 125, "f32", "f32", False,
     3.0),
    # flash_tc_kernel (bf16 q): danube's heads, causal and not, a window,
    # a cache prefill, hd 160, the padded smoke dims
    (1, 300, 300, 32, 8, 80, 80, True, None, 0, None, "bf16", "f32", False,
     2.0),
    (2, 300, 1500, 20, 20, 64, 64, False, None, 0, None, "bf16", "bf16",
     False, 2.0),
    (2, 70, 160, 8, 2, 80, 80, True, 40, 60, 150, "bf16", "f32", False, 1.0),
    (1, 150, 213, 8, 2, 160, 160, True, None, 63, None, "bf16", "bf16",
     False, 5.0),
    (2, 24, 24, 4, 2, 16, 16, True, None, 0, None, "bf16", "bf16", False,
     0.5),
    # flash_mla_kernel: (576, 512) over an aliased latent cache; and
    # flash_wide_kernel: hd 256 with a window
    (1, 100, 100, 16, 1, 576, 512, True, None, 0, None, "bf16", "bf16", True,
     2.0),
    (3, 33, 100, 16, 1, 576, 512, True, None, 60, 93, "bf16", "f32", False,
     50.0),
    (2, 300, 300, 16, 1, 256, 256, True, 100, 0, None, "bf16", "bf16", False,
     2.0),
    (1, 33, 300, 2, 1, 256, 256, False, 80, 250, 290, "bf16", "f32", False,
     1.0),
    # the split-KV decode kernel (float32 q, Sq x g <= 64), capped with its
    # lse: chunks some rows cannot see, and a decode_32k rank's call
    (1, 16, 700, 4, 1, 80, 80, True, 40, 594, 610, "f32", "bf16", False,
     2.0),
    (8, 1, 2048, 32, 8, 80, 80, False, None, 0, None, "f32", "bf16", False,
     3.0),
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dk,dv,causal,window,q_off,valid,qt,"
                         "kvt,alias,cap", SOFTCAP_CASES)
def test_flash_attention_softcap_kernel(card, b, sq, sk, hq, hkv, dk, dv,
                                        causal, window, q_off, valid, qt,
                                        kvt, alias, cap):
    """Each of the three kernel templates with ``softcap``: the output
    against the twin by the bf16 rule with the flip term and within
    ``flash_attention_rounding_bound`` of the float32 plain version (bf16
    q), or against the float32 plain version (float32 q); the lse within
    ``flash_attention_lse_bound``; inputs scaled by 2 so that the cap
    bites, and the capped output apart from the uncapped one."""
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=card).manual_seed(sq * 3 + dk)
    q = (2 * torch.randn((b, sq, hq, dk), generator=g, device=card)).to(
        types[qt])
    k = (2 * torch.randn((b, sk, hkv, dk), generator=g, device=card)).to(
        types[kvt])
    v = k[..., :dv] if alias else torch.randn(
        (b, sk, hkv, dv), generator=g, device=card).to(types[kvt])
    kw = dict(causal=causal, window=window, q_offset=q_off,
              kv_valid_len=valid, softcap=cap)
    ops.reset_launch_counts()
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert torch.equal(out, flash_attn.flash_attention(q, k, v, **kw))
    if qt == "bf16":
        _assert_bf16_kernel(out, q, k, v, kw)
    else:
        _assert_attn_close(out, ref.flash_attention_ref(q, k, v, **kw))
    bf = torch.bfloat16 if qt == "bf16" else None
    _, twin = ref.flash_attention_ref(q, k, v, operands=bf, return_lse=True,
                                      **kw)
    assert ((lse - twin).abs()
            <= ref.flash_attention_lse_bound(q, k, twin, **kw)).all()
    uncapped = flash_attn.flash_attention(q, k, v, **{**kw, "softcap": 0.0})
    if cap < 10:
        assert (uncapped.float() - out.float()).abs().max() > 1e-2


@pytest.mark.parametrize("causal,window,hq,hkv,dk,dv,alias", [
    (True, None, 32, 8, 80, 80, False),
    (False, None, 4, 4, 64, 64, False),
    (True, 48, 16, 1, 256, 256, False),
    (True, None, 16, 1, 576, 512, True),
])
def test_attend_softcap_gradients_on_the_card_within_the_bound(
        card, causal, window, hq, hkv, dk, dv, alias):
    """``attend(..., softcap=2)``'s gradients on the card (the kernel's
    capped forward with its logsumexp, the plain capped backward), bf16
    inputs, within ``ref.flash_attention_bwd_bound`` of autograd through
    the float32 one-pass attention with the cap."""
    from repro_torch.models.attention import attend, attend_onepass
    gen = torch.Generator().manual_seed(dk + hq + 1)
    b, s = 2, 130
    q = (2 * torch.randn((b, s, hq, dk), generator=gen)).bfloat16()
    kk = (2 * torch.randn((b, s, hkv, dk), generator=gen)).bfloat16()
    vv = kk[..., :dv] if alias else torch.randn(
        (b, s, hkv, dv), generator=gen).bfloat16()
    go = torch.randn((b, s, hq, dv), generator=gen).bfloat16()
    kw = dict(causal=causal, window=window, softcap=2.0)
    leaves = (q, kk) if alias else (q, kk, vv)
    f32 = [t.float().requires_grad_() for t in leaves]
    fk = f32[1]
    want = torch.autograd.grad(attend_onepass(
        f32[0], fk, fk[..., :dv] if alias else f32[2], **kw), f32,
        go.float())
    x = [t.to(card).requires_grad_() for t in leaves]
    xv = x[1][..., :dv] if alias else x[2]
    got = torch.autograd.grad(attend(x[0], x[1], xv, **kw), x, go.to(card))
    with torch.no_grad():
        o, lse = ops.flash_attention(x[0], x[1], xv, return_lse=True, **kw)
        bq, bk, bv = ref.flash_attention_bwd_bound(x[0], x[1], xv, o, lse,
                                                   go.to(card), **kw)
    if alias:
        bk = bk.clone()
        bk[..., :dv] += bv
    for a, w, bnd in zip(got, want, (bq, bk, bv)):
        assert ((a.double().cpu() - w.double()).abs() <= bnd.cpu()).all()


@pytest.mark.parametrize("arch", _archs())
def test_gradients_on_the_card_match_the_cpu(card, arch):
    """``value_and_grad`` of each smoke config with float32 params on the
    card (the attention kernel's float32 route and the plain backward)
    against the CPU's: the loss within 1e-4 relative, each grad leaf
    within 1e-3 of its largest |grad| (float32 sums in other orders,
    carried through 2-3 layers' backward)."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build_model, value_and_grad
    cfg = dataclasses.replace(get_smoke(arch), param_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    batch = _train_batch(cfg, 2, 24)
    want_l, _, want = value_and_grad(model, params, batch)
    got_l, _, got = value_and_grad(model, _to(params, card),
                                   {k: v.to(card) for k, v in batch.items()})
    assert abs(float(got_l) - float(want_l)) <= 1e-4 * abs(float(want_l))
    for path, a, w in zip([p for p, _ in tree.leaves_with_paths(params)],
                          got, want):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((a.cpu() - w).abs().max()) <= 1e-3 * scale, path


def _train_batch(cfg, b, s, seed=0):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen)}
    if cfg.n_frames:
        batch["frames"] = torch.randn((b, cfg.n_frames, cfg.d_model),
                                      generator=gen)
    if cfg.n_patches:
        batch["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model),
                                       generator=gen)
    return batch


def test_train_step_on_the_card_matches_the_cpu(card):
    """One ``make_train_step`` (accum 2) of the danube smoke in float32 on
    the card and on the CPU: the loss within 1e-4 relative, every param
    within 2.2 lr of the CPU's (a first AdamW step moves each param by lr
    (sign(g) + weight decay p): a grad near 0 may take the other sign on
    the other device) and the moments within 1e-3 of their largest
    value."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build_model, make_train_step
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_smoke("h2o-danube-1.8b"),
                              param_dtype="float32", accum_steps=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    ocfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=4)
    step = make_train_step(model, ocfg)
    batch = _train_batch(cfg, 4, 24, seed=5)
    p_cpu, o_cpu, m_cpu = step(params, adamw.init(ocfg, params), batch)
    pc = _to(params, card)
    p_gpu, o_gpu, m_gpu = step(pc, adamw.init(ocfg, pc),
                               {k: v.to(card) for k, v in batch.items()})
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= \
        1e-4 * abs(float(m_cpu["loss"]))
    lr = float(m_cpu["lr"])
    for a, w in zip(tree.leaves(p_gpu), tree.leaves(p_cpu)):
        assert float((a.cpu() - w).abs().max()) <= 2.2 * lr
    for a, w in zip(tree.leaves(o_gpu.nu), tree.leaves(o_cpu.nu)):
        assert float((a.cpu() - w).abs().max()) <= \
            1e-3 * max(float(w.abs().max()), 1e-30)
