"""The design of the ``beam_search`` CUDA kernel, mirrored in plain Python
and PyTorch on the CPU and held bitwise against the plain lock-step loop.

The kernel (``src/repro_torch/kernels/csrc/beam_search.cu``) runs one
lane's whole beam search in one warp. The mirror below takes its steps one
lane at a time, in the kernel's order and form:

  * selection by position: a ballot over the expanded flags, 32 at a time;
    the first unexpanded entry of the sorted beam is the best one;
  * the freshness test of a whole row against the bitmap as it was before
    the row, then the update;
  * the quirk of the reference's visited scatter (ROADMAP C1) in ballot
    form: the last slot <= 0 of the masked row, and whether it is a 0;
  * the rank through the lane's nibble tables (built once a lane; the
    table helpers of ``tests/test_torch_scan_design.py``, which mirror
    common.cuh's ``build_tables`` / ``table_sum``);
  * the neighbours' keys (signed rank as an ordered uint32 << 32 | column)
    sorted by the warp's bitonic network over RP slots;
  * the co-ranked stable merge into the best EF: beam entry i at i + the
    neighbours of lower rank, neighbour j at j + the beam entries of lower
    or equal rank.

(a) the mirror equals ``ref.beam_search_ref`` (the plain loop, the kernel's
    plain version) in ids, ranks and hops, on random lanes and on the
    adversarial cases that phase 3 of ``chip_smoke.py`` gives the kernel;
(b) three faults planted in the mirror each make (a) fail;
(c) the stop test of the float (exact) policy, on beams of float rank keys:
    stop where the first unexpanded entry's key is at or above the pad's,
    or where a NaN is in the beam's last slot, equals the plain loop's
    argmin test on the same beams (NaN, +inf, the F32_MAX pad, entries that
    outrank the pad); a planted fault (no NaN test) makes it fail.

The kernel itself is held against ``beam_search_ref`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the plain loop is held
against the JAX package's ``beam_search_lane`` by
``tests/test_torch_engine.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ranks import ExactRank, HammingRank  # noqa: E402
from test_torch_scan_design import (  # noqa: E402
    lane_tables, o3_epilogue, table_sums)

INT_MAX, INT_MIN = 2**31 - 1, -2**31
FAULTS = ("ties_to_neighbours", "update_before_test", "zero_by_any_zero")


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def order_key(r):
    """The kernel's ``order_key``: signed rank -> ordered uint32."""
    return (r + 2**32) % 2**32 ^ 0x80000000


def warp_bitonic(key):
    """The kernel's ``warp_bitonic``: the same compare-exchanges in the same
    stages over a power-of-two list."""
    key = list(key)
    p = len(key)
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            for i in range(p):
                ixj = i ^ j
                if ixj > i and (key[i] > key[ixj]) == ((i & k) == 0):
                    key[i], key[ixj] = key[ixj], key[i]
            j >>= 1
        k <<= 1
    return key


def mirror_lane(rank_of, row_of, entry, active, *, m, r, ef, max_iters,
                fault=None):
    """One lane's search in the kernel's steps. ``rank_of(x)`` is the O3
    rank of local id x >= 0, ``row_of(x)`` its neighbour row."""
    vis = [False] * (m + 1)
    b_rank, b_id, b_exp = [INT_MAX] * ef, [-1] * ef, [False] * ef
    b_rank[0] = rank_of(entry) if entry >= 0 else INT_MAX
    b_id[0] = entry
    if entry >= 0:
        vis[min(entry, m)] = True
    rp = 32
    while rp < r:
        rp <<= 1
    hops = 0
    for _ in range(max_iters if active else 0):
        sel = None
        for c in range(0, ef, 32):
            ballot = [i for i in range(c, c + 32) if i < ef and not b_exp[i]]
            if ballot:
                sel = ballot[0]
                break
        if sel is None or b_rank[sel] == INT_MAX:
            break
        node = b_id[sel]
        row = row_of(max(node, 0))
        x = []
        for nb in row:
            fresh = nb >= 0 and node >= 0 and not vis[min(nb, m - 1)]
            x.append(nb if fresh else -1)
            if fault == "update_before_test" and fresh and nb > 0:
                vis[min(nb, m - 1)] = True
        last, last_zero = -1, False
        for c in range(0, r, 32):
            le0 = [j for j in range(c, min(c + 32, r)) if x[j] <= 0]
            if le0:
                last, last_zero = le0[-1], x[le0[-1]] == 0
        for xj in x:
            if xj > 0:
                vis[min(xj, m - 1)] = True
        if fault == "zero_by_any_zero":
            vis[0] |= 0 in x
        elif last >= 0 and last_zero:
            vis[0] = True
        keys = [(order_key(rank_of(xj) if xj >= 0 else INT_MAX) << 32) | j
                for j, xj in enumerate(x)] + [2**64 - 1] * (rp - r)
        keys = warp_bitonic(keys)
        ties = fault == "ties_to_neighbours"
        new = [None] * ef
        for i in range(ef):
            probe = order_key(b_rank[i]) << 32
            below = sum(1 for k in keys[:r]
                        if (k >> 32 <= probe >> 32 if ties else k < probe))
            if i + below < ef:
                new[i + below] = (b_rank[i], b_id[i], b_exp[i] or i == sel)
        for j in range(min(r, ef)):
            rk = (keys[j] >> 32) - (1 << 31)
            below = sum(1 for br in b_rank if (br < rk if ties else br <= rk))
            if j + below < ef:
                new[j + below] = (rk, x[keys[j] & 0xFFFFFFFF], False)
        assert None not in new or fault, "co-ranking left a slot empty"
        new = [e if e is not None else (INT_MAX, -1, False) for e in new]
        b_rank = [e[0] for e in new]
        b_id = [e[1] for e in new]
        b_exp = [e[2] for e in new]
        hops += 1
    return b_id, b_rank, hops


def mirror(args, dim, ef, max_iters, m, fault=None):
    """Every lane of a ``beam_search_ref`` call through ``mirror_lane``;
    the ranks of a lane's whole cluster come from its nibble tables once,
    as the kernel ranks a row: the table sum, then the O3 epilogue."""
    codes, f_add, nbrs, base, entry, lut, sumq, s1, s2, active = args
    r, w = nbrs.shape[1], codes.shape[1]
    ids, ranks, hops = [], [], []
    for lane in range(base.shape[0]):
        rows = (int(base[lane]) + torch.arange(m)).clamp(
            0, codes.shape[0] - 1)
        one = slice(lane, lane + 1)
        sums = table_sums(codes[rows][None],
                          lane_tables(lut[one], dim, w, nibble=True),
                          nibble=True)
        table = o3_epilogue(sums, f_add[rows][None], sumq[one], s1[one],
                            s2[one])[0].tolist()
        nrows = nbrs[rows].tolist()
        i, rk, h = mirror_lane(
            lambda x: table[min(x, m - 1)], lambda x: nrows[min(x, m - 1)],
            int(entry[lane]), bool(active[lane]), m=m, r=r, ef=ef,
            max_iters=max_iters, fault=fault)
        ids.append(i)
        ranks.append(rk)
        hops.append(h)
    return (torch.tensor(ids, dtype=torch.int32),
            torch.tensor(ranks, dtype=torch.int32),
            torch.tensor(hops, dtype=torch.int32))


# ---------------------------------------------------------------------------
# inputs: random lanes and the adversarial cases of phase 3
# ---------------------------------------------------------------------------

def beam_case(seed, n_lanes, m, r, w, n_clusters=3):
    """Lanes over a flattened (n_clusters * m) cluster table. Neighbour
    rows hold -1 pads, duplicate ids, rows of all -1 and rows ending in 0,
    -1 (the quirk); odd lanes have a zero LUT and sumq, so their ranks are
    f_add itself, which holds INT_MAX, INT_MIN and, in cluster 0, only 8
    values (equal ranks across the beam and the neighbours); lane 1's entry
    ranks INT_MAX, lane 3's entry is -1 (an empty cluster); some lanes are
    inactive."""
    rng = np.random.default_rng(seed)
    t = n_clusters * m
    codes = rng.integers(0, 256, (t, w), dtype=np.uint8)
    f_add = rng.integers(-(1 << 12), 1 << 12, t).astype(np.int32)
    f_add[:m] = rng.integers(0, 8, m)
    f_add[::13] = INT_MAX
    f_add[5::17] = INT_MIN
    nbrs = rng.integers(0, m, (t, r)).astype(np.int32)
    nbrs[rng.random((t, r)) < 0.15] = -1
    nbrs[::3, 1] = nbrs[::3, 0]                      # duplicates in a row
    nbrs[::11] = -1                                  # rows of all -1
    nbrs[::7, -2:] = [0, -1]                         # 0 followed by -1
    lut = rng.integers(-(1 << 20), 1 << 20, (n_lanes, 8 * w)).astype(
        np.int32)
    sumq = rng.integers(-(1 << 24), 1 << 24, n_lanes).astype(np.int32)
    lut[1::2] = 0
    sumq[1::2] = 0
    s1 = rng.integers(0, 33, n_lanes).astype(np.int32)
    s2 = rng.integers(0, 33, n_lanes).astype(np.int32)
    s2[::3] = 31
    base = (rng.integers(0, n_clusters, n_lanes) * m).astype(np.int32)
    base[::4] = 0                                    # the tie cluster
    entry = rng.integers(0, m, n_lanes).astype(np.int32)
    if n_lanes > 1:
        f_add[base[1] + entry[1]] = INT_MAX          # entry at INT_MAX
    if n_lanes > 3:
        entry[3] = -1
    active = rng.random(n_lanes) < 0.85
    active[:2] = True
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        codes, f_add, nbrs, base, entry, lut, sumq, s1, s2, active))


def rank_operands(kind, seed, t, n_lanes, w, dim, tie_rows=0):
    """A rank tuple of ``kind`` ("hamming" or "exact") over t rows and
    n_lanes lanes, adversarial as ``beam_case``'s O3 operands are. Hamming:
    random qcodes, odd lanes all zero (a row ranks by its own popcount:
    many ties); the first ``tie_rows`` codes all zero. Exact: odd lanes have
    query_norm 0, so a row ranks rn * rn, and the first ``tie_rows`` rows
    take 8 residual norms only (equal ranks across the beam and the
    neighbours); zero residual norms, cos_theta 0 and below the 1e-6 floor,
    LUT entries past dim that must not count."""
    rng = np.random.default_rng(seed)
    if kind == "hamming":
        q = rng.integers(0, 256, (n_lanes, w), dtype=np.uint8)
        q[1::2] = 0
        return HammingRank(torch.from_numpy(q))
    rn = (rng.random(t) * 4).astype(np.float32)
    rn[:tie_rows] = rng.integers(0, 8, tie_rows) / 4
    rn[::9] = 0
    cos = rng.random(t).astype(np.float32)
    cos[::11] = 0
    cos[5::13] = 1e-7
    lut = (rng.standard_normal((n_lanes, 8 * w)) / np.sqrt(dim)).astype(
        np.float32)
    sum_lut = lut[:, :dim].sum(1, dtype=np.float32)
    lut[:, dim:] = rng.standard_normal((n_lanes, 8 * w - dim))  # not counted
    qn = (rng.random(n_lanes) * 3).astype(np.float32)
    qn[1::2] = 0
    return ExactRank(*(torch.from_numpy(np.ascontiguousarray(a))
                       for a in (rn, cos, lut, sum_lut, qn)))


def ranked_case(kind, seed, n_lanes, m, r, w, dim, n_clusters=3, tied=False):
    """``beam_case``'s lanes, graph and entries ranked by ``kind``: (codes,
    rank, nbrs, base_rows, entry, active). ``tied``: every code all zero,
    so each hamming lane ranks every row alike."""
    codes, _, nbrs, base, entry, _, _, _, _, active = beam_case(
        seed, n_lanes, m, r, w, n_clusters)
    if tied:
        codes = torch.zeros_like(codes)
    rank = rank_operands(kind, seed, codes.shape[0], n_lanes, w, dim,
                         tie_rows=m)
    return codes, rank, nbrs, base, entry, active


def quirk_case():
    """The minimal search of ROADMAP C1: node 0 enters the beam twice."""
    nbrs = np.array([[2, -1, -1], [0, -1, -1], [0, 3, -1], [-1, -1, -1]],
                    np.int32)
    z = np.zeros(1, np.int32)
    arrays = (np.zeros((4, 1), np.uint8), np.array([10, 5, 20, 30], np.int32),
              nbrs, z, np.ones(1, np.int32), np.zeros((1, 8), np.int32), z,
              np.full(1, 2, np.int32), np.full(1, 31, np.int32),
              np.ones(1, bool))
    return tuple(torch.from_numpy(a) for a in arrays)


CASES = {  # name: (args, dim, ef, max_iters, m)
    "quirk": (quirk_case, 8, 6, 10, 4),
    "random_ef40_r32_w16": (lambda: beam_case(1, 12, 300, 32, 16), 128, 40,
                            64, 300),
    "ef1": (lambda: beam_case(2, 8, 200, 32, 16), 128, 1, 64, 200),
    "ef_below_r": (lambda: beam_case(3, 8, 200, 32, 16), 121, 12, 64, 200),
    "ef100": (lambda: beam_case(4, 6, 400, 32, 16), 128, 100, 64, 400),
    "r16": (lambda: beam_case(5, 8, 300, 16, 16), 128, 40, 64, 300),
    "r48": (lambda: beam_case(6, 8, 300, 48, 16), 128, 40, 64, 300),
    "max_iters_cap": (lambda: beam_case(7, 8, 300, 32, 16), 128, 40, 5, 300),
    "w64": (lambda: beam_case(8, 6, 300, 32, 64), 500, 40, 64, 300),
    "w4_byte_loop": (lambda: beam_case(9, 8, 100, 32, 4), 29, 40, 64, 100),
    "budget_m17089": (lambda: beam_case(10, 3, 17089, 32, 16, 1), 128, 40,
                      64, 17089),
}


@pytest.fixture(scope="module")
def plain():
    """The plain loop's result of every case, computed once."""
    out = {}
    for name, (make, dim, ef, iters, m) in CASES.items():
        args = make()
        out[name] = (args, ref.beam_search_ref(*args, dim, ef, iters, m))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mirror_bitwise_vs_plain_loop(plain, name):
    _, dim, ef, iters, m = CASES[name]
    args, want = plain[name]
    got = mirror(args, dim, ef, iters, m)
    for g, w in zip(got, want):
        assert torch.equal(g, w), name
    if name == "quirk":
        assert (want[0] == 0).sum() == 2            # node 0 entered twice
    if name == "max_iters_cap":
        assert int(want[2].max()) == iters


def test_cases_reach_their_edges(plain):
    """The adversarial inputs do what their names say in the plain loop."""
    args, (ids, ranks, hops) = plain["random_ef40_r32_w16"]
    active, entry = args[9], args[4]
    assert (hops[~active] == 0).all() and (hops[active] > 0).any()
    assert int(hops[1]) == 0 and int(ranks[1, 0]) == INT_MAX  # entry INT_MAX
    assert int(hops[3]) == 0 and int(entry[3]) == -1
    every = torch.cat([v[1][1].flatten() for v in plain.values()])
    assert (every == INT_MIN).any() and (every == INT_MAX).any()
    dup = [(row[row >= 0].unique().numel() < (row >= 0).sum())
           for row in plain["r16"][1][0]]
    assert any(dup)                                  # an id kept twice


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(plain, fault):
    """Each fault changes the result of at least one case."""
    caught = []
    for name, (_, dim, ef, iters, m) in CASES.items():
        if name == "budget_m17089":
            continue
        args, want = plain[name]
        got = mirror(args, dim, ef, iters, m, fault=fault)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            caught.append(name)
    assert caught, f"planted fault {fault} went unnoticed"


# ---------------------------------------------------------------------------
# (c) the stop test of the float policy
# ---------------------------------------------------------------------------

F32_MAX = float(np.finfo(np.float32).max)
NAN_KEY = 0xFFC00000


def float_key(r):
    return int(ref.float_order_key(torch.tensor([r], dtype=torch.float32)))


def kernel_stops(ranks, expanded, fault=None):
    """beam_search.cu's stop test on a beam held as keys: the first
    unexpanded entry (the ballot), its key against the pad's, and (float
    policy) a NaN in the last slot."""
    keys = [float_key(r) for r in ranks]
    open_ = [i for i, e in enumerate(expanded) if not e]
    if not open_ or keys[open_[0]] >= float_key(F32_MAX):
        return True
    return fault != "no_nan_test" and keys[-1] == NAN_KEY


def plain_stops(ranks, expanded):
    """lockstep_beam_search's test: argmin of the frontier (expanded entries
    at the pad), live while it ranks below the pad."""
    r = torch.tensor(ranks, dtype=torch.float32)
    frontier = torch.where(torch.tensor(expanded), F32_MAX, r)
    return not bool(frontier[frontier.argmin()] < F32_MAX)


def float_beams(seed, n=400, ef=6):
    """Beams the kernel can hold: the first beam (the entry's rank, which
    may outrank the pad, then pads) and merged beams, sorted by key, in
    which only entries below the pad are ever expanded."""
    rng = np.random.default_rng(seed)
    special = [float("nan"), float("inf"), F32_MAX, 0.0, -1.5]
    beams = [([e] + [F32_MAX] * (ef - 1), [False] * ef) for e in special]
    for _ in range(n):
        vals = [float(v) for v in rng.standard_normal(ef)]
        for i in range(ef):
            if rng.random() < 0.2:
                vals[i] = special[rng.integers(0, 3)]
        vals.sort(key=float_key)
        exp = [bool(rng.random() < 0.5) and float_key(v) < float_key(F32_MAX)
               for v in vals]
        beams.append((vals, exp))
    return beams


@pytest.mark.parametrize("seed", [0, 1])
def test_float_stop_test_equals_plain_loop(seed):
    beams = float_beams(seed)
    assert any(plain_stops(*b) for b in beams)
    assert not all(plain_stops(*b) for b in beams)
    for ranks, expanded in beams:
        assert kernel_stops(ranks, expanded) == plain_stops(ranks, expanded)


def test_planted_fault_no_nan_test_fails():
    """Without the NaN test the kernel would expand past a NaN that the
    plain loop's argmin stops at."""
    beams = float_beams(0)
    assert any(kernel_stops(r, e, fault="no_nan_test") != plain_stops(r, e)
               for r, e in beams)
