"""The design of the ``topk_select`` and ``merge_topk`` CUDA kernels,
mirrored in plain PyTorch on the CPU and held bitwise against the plain
versions.

Both kernels (``src/repro_torch/kernels/csrc/topk_select.cu`` and
``merge_topk.cu``) key every slot of a row as the 64-bit integer
(order-preserving bits of its masked distance, column) and take one of two
routes, chosen from the row width and k alone (``topk_select.route_for``):

  warp route: one warp a row. ``topk_select`` first finds later duplicates
    in R steps, step r the columns 32 r to 32 r + 31, one a lane: a slot is
    a later duplicate when a lower lane of its step has its id
    (``__match_any_sync``) or an earlier step put its id in the warp's
    table (``atomicCAS``). That equals a table of each id's first column
    (``scatter_reduce`` "amin"), which is checked too. Each of the 32 lanes
    sorts its R slots (columns lane + 32 r), and k rounds of a minimum over
    the lanes' heads give the k best;
  block route: the whole row sorted by (id, column) to flag later
    duplicates, then by key (``merge_topk``: the key sort only).

The mirror takes the same steps. It is held bitwise (ids, and distances by
their bits, so NaN and -0.0 count) against ``ref.topk_select_ref`` and
``ref.merge_topk_ref`` on rows that reach every corner of the design, and
three faults planted in it (the last occurrence kept, ties to the higher
column, -0.0 before +0.0) each make that check fail. The kernels themselves
are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.topk_select import (  # noqa: E402
    MAX_C, WARP_MAX_C, WARP_MAX_K, route_for)

LANES = 32
INF_KEY = 0xFF800000               # float_key(+inf)
FILLER = 2**63 - 1                 # the key all ones, offset as below
NAN, INF = float("nan"), float("inf")


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def float_key(d, fault=None):
    """common.cuh's ``float_key`` as int64 in [0, 2^32): -0.0 ties with
    +0.0 (unless the fault "neg_zero_first" is planted), every NaN maps to
    the all-ones key."""
    if fault != "neg_zero_first":
        d = torch.where(d == 0, torch.zeros_like(d), d)
    u = d.view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(u >= 2**31, ~u & 0xFFFFFFFF, u | 2**31)
    return torch.where(torch.isnan(d), 0xFFFFFFFF, key)


def make_keys(d, cols, fault=None):
    """The 64-bit key (float_key << 32) | low word, offset by -2^63 into
    int64 so that its unsigned order is int64 order. The low word is the
    column, or under the fault "ties_high" its complement, so ties go to
    the higher column."""
    low = 0xFFFFFFFF - cols if fault == "ties_high" else cols
    return ((float_key(d, fault) - 2**31) << 32) | low


def key_cols(keys, fault=None):
    low = keys & 0xFFFFFFFF
    return 0xFFFFFFFF - low if fault == "ties_high" else low


def first_column_table(ids):
    """(Q, C) bool: the slots a keep-first dedup masks, from a table of
    each (row, id)'s first column (``scatter_reduce`` "amin"). Pads
    (id < 0) are masked too."""
    q, c = ids.shape
    real = ids >= 0
    rows = torch.arange(q)[:, None].expand(q, c)[real]
    cols = torch.arange(c).expand(q, c)[real]
    bad = ~real
    if not real.any():
        return bad
    _, inv = torch.unique(torch.stack([rows, ids[real].long()]), dim=1,
                          return_inverse=True)
    table = torch.full((int(inv.max()) + 1,), c).scatter_reduce(
        0, inv, cols, "amin")
    bad = bad.clone()
    bad[real] = table[inv] != cols
    return bad


def stepwise_later_duplicates(ids, fault=None):
    """(Q, C) bool: the warp route's keep-first. Step r takes the columns
    32 r to 32 r + 31; a slot is masked when it is a pad, when a lower lane
    of its step holds its id (the match), or when an earlier step put its
    id in the table (the CAS finds it). The fault "keep_last" walks the
    steps, and the lanes inside one, from the last column."""
    if fault == "keep_last":
        return stepwise_later_duplicates(ids.flip(1)).flip(1)
    q, c = ids.shape
    bad = ids < 0
    lower = torch.ones(LANES, LANES, dtype=torch.bool).tril(-1)  # [b, a<b]
    for a in range(0, c, LANES):
        step = ids[:, a:a + LANES]
        n = step.shape[1]
        match = (step[:, :, None] == step[:, None, :]) & lower[:n, :n]
        in_table = (step[:, :, None] == ids[:, None, :a]).any(-1)
        bad[:, a:a + n] |= match.any(-1) | in_table
    return bad


def sorted_later_duplicates(ids):
    """The block route's dedup: one sort of (id, column) keys; a slot whose
    id equals its predecessor's in sorted order is a later duplicate."""
    c = ids.shape[1]
    keys = (ids.long() << 32) | torch.arange(c)
    s = torch.sort(keys, dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    later = (s[:, 1:] >> 32) == (s[:, :-1] >> 32)
    dup.scatter_(1, s[:, 1:] & 0xFFFFFFFF, later)
    return dup | (ids < 0)


LANE_SLOTS = (1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 32)   # DISPATCH_LANE_SLOTS


def lane_slots(c):
    """common.cuh's ``DISPATCH_LANE_SLOTS``: the least R of LANE_SLOTS
    with 32 R >= c."""
    return next(r for r in LANE_SLOTS if LANES * r >= c)


def warp_topk(keys, k):
    """The warp route's selection from (Q, C) keys: lane l holds columns
    l + 32 r, r < R, sorts them (``lane_sort``); k rounds take the least
    lane head and advance that lane (``warp_select``). (Q, k) keys."""
    q, c = keys.shape
    r = lane_slots(c)
    cols = torch.arange(r)[None, :] * LANES + torch.arange(LANES)[:, None]
    lanes = torch.where(cols < c, keys[:, cols.clamp(max=c - 1)], FILLER)
    lanes = torch.sort(lanes, dim=-1).values                  # (Q, 32, R)
    lanes = torch.cat([lanes, torch.full((q, LANES, 1), FILLER)], -1)
    head = torch.zeros((q, LANES), dtype=torch.long)
    out = torch.empty((q, k), dtype=torch.long)
    for j in range(k):
        cur = torch.gather(lanes, 2, head[:, :, None])[:, :, 0]
        out[:, j], win = cur.min(-1)
        head[torch.arange(q), win] += 1
    return out


def block_topk(keys, k):
    """The block route's selection: one sort of the row's keys."""
    return torch.sort(keys, dim=1).values[:, :k]


def write_selected(sel, ids, dists, fault=None):
    """common.cuh's ``write_selected``: a key at +inf gives (+inf, -1);
    any other gives its column's distance and, where that is finite, its
    id."""
    cols = key_cols(sel, fault)
    d = torch.gather(dists, 1, cols)
    i = torch.gather(ids, 1, cols)
    at_inf = (sel >> 32) + 2**31 == INF_KEY
    d = torch.where(at_inf, INF, d)
    i = torch.where(at_inf | ~torch.isfinite(d), -1, i)
    return i.to(torch.int32), d


def mirror_topk_select(ids, dists, k, route, fault=None):
    c = ids.shape[1]
    cols = torch.arange(c).expand_as(ids)
    if route == "warp":
        bad = stepwise_later_duplicates(ids, fault)
    else:
        bad = sorted_later_duplicates(ids)
    keys = make_keys(torch.where(bad, INF, dists), cols, fault)
    sel = warp_topk(keys, k) if route == "warp" else block_topk(keys, k)
    return write_selected(sel, ids, dists, fault)


def mirror_merge_topk(ids, dists, k, route, fault=None):
    keys = make_keys(dists, torch.arange(ids.shape[1]).expand_as(ids), fault)
    sel = warp_topk(keys, k) if route == "warp" else block_topk(keys, k)
    return write_selected(sel, ids, dists, fault)


def same_bits(got, want):
    """ids equal, distances equal bit for bit (NaN and -0.0 included)."""
    return (torch.equal(got[0], want[0])
            and torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32)))


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------

def random_rows(rng, q, c, n_ids):
    ids = rng.integers(-1, n_ids, (q, c)).astype(np.int32)    # duplicates
    d = rng.integers(0, 40, (q, c)).astype(np.float32) / 8    # ties
    return ids, d


def topk_case(name):
    """(ids (Q, C) int32, dists (Q, C) f32, k) for one named case."""
    rng = np.random.default_rng(len(name) * 977)
    if name == "all_pads":
        ids, d = random_rows(rng, 3, 40, 30)
        ids[:] = -1
        return ids, d, 10
    if name == "one_id":
        ids, d = random_rows(rng, 3, 64, 30)
        ids[:] = 7
        return ids, d, 10
    if name == "later_dup_smaller":    # the first occurrence is the worse
        ids = np.array([[5, 3, 5, 9, 3, 5], [1, 1, 1, 2, 2, 2]], np.int32)
        d = np.array([[0.9, 0.5, 0.1, 0.7, 0.2, 0.0],
                      [0.8, 0.3, 0.1, 0.9, 0.2, 0.1]], np.float32)
        return ids, d, 4
    if name == "specials":             # NaN, +inf, -inf beside real ids
        ids = np.arange(12, dtype=np.int32)[None].repeat(4, 0)
        d = np.array([[NAN, 1, INF, -INF, 0.5, NAN, INF, 2, -INF, 0, 3, 4]]
                     * 4, np.float32)
        d[1] = np.roll(d[1], 5)
        ids[2, 3] = ids[2, 0]          # a -inf masked as a duplicate
        ids[2, 5] = ids[2, 1]          # a NaN masked as a duplicate
        ids[3, :6] = -1                # specials behind pads
        return ids, d, 12
    if name == "signed_zero":          # +0.0 at the lower column
        ids = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
        d = np.array([[0.0, -0.0, 1, 2, -0.0, 0.0, 3, 4],
                      [5, 6, -0.0, 0.0, 7, 8, 0.0, -0.0]], np.float32)
        return ids, d, 5
    if name == "ties":                 # equal distances, distinct ids
        ids = np.arange(70, dtype=np.int32)[None].repeat(3, 0)
        d = np.ones((3, 70), np.float32)
        d[1, ::3] = 0.5
        d[2, 33] = d[2, 1] = 0.25      # lanes 1 of slots 0 and 1
        return ids, d, 10
    if name == "fewer_than_k":         # 3 real slots, k = 10
        ids, d = random_rows(rng, 4, 50, 1000)
        ids[:, 3:] = -1
        ids[1, :] = 4                  # one distinct id
        return ids, d, 10
    if name == "c_not_multiple_of_32":
        ids, d = random_rows(rng, 5, 77, 50)
        return ids, d, 10
    if name == "c_1":
        ids, d = random_rows(rng, 6, 1, 3)
        return ids, d, 1
    if name == "k_eq_c":
        ids, d = random_rows(rng, 4, 20, 15)
        return ids, d, 20
    if name == "main_path":            # the rerank: C = nprobe ef = 320
        ids, d = random_rows(rng, 16, 320, 200)
        return ids, d, 10
    if name == "warp_width":           # C = WARP_MAX_C, k = WARP_MAX_K
        ids, d = random_rows(rng, 3, WARP_MAX_C, 600)
        return ids, d, WARP_MAX_K
    if name == "warp_width_plus_1":    # the block route's first width
        ids, d = random_rows(rng, 3, WARP_MAX_C + 1, 600)
        return ids, d, 10
    if name == "warp_k_plus_1":        # the block route's first k
        ids, d = random_rows(rng, 3, 96, 60)
        return ids, d, WARP_MAX_K + 1
    raise KeyError(name)


TOPK_CASES = ["all_pads", "one_id", "later_dup_smaller", "specials",
              "signed_zero", "ties", "fewer_than_k", "c_not_multiple_of_32",
              "c_1", "k_eq_c", "main_path", "warp_width",
              "warp_width_plus_1", "warp_k_plus_1"]


def merge_case(name):
    """(ids (Q, W) int32, dists (Q, W) f32, k, run) for one named case."""
    rng = np.random.default_rng(len(name) * 331)
    if name == "unsorted_runs":        # runs in no order, ties across runs
        d = rng.integers(0, 30, (6, 40)).astype(np.float32) / 4
        ids = np.arange(240, dtype=np.int32).reshape(6, 40)
        return ids, d, 10, 10
    if name == "sharded_sink":         # the origin merge: 8 sorted runs
        d = np.sort(rng.random((8, 8, 10)).astype(np.float32), -1)
        ids = np.arange(640, dtype=np.int32).reshape(8, 8, 10)
        d[:, 0, -2:], ids[:, 0, -2:] = INF, -1        # unfilled tails
        d[:, 1, 0] = d[:, 0, 0]                       # a tie across runs
        d[1], ids[1] = INF, -1                        # an unanswered row
        return ids.reshape(8, 80), d.reshape(8, 80), 10, 10
    if name == "specials":
        d = np.array([[NAN, 1, INF, -INF, 0.0, -0.0, INF, -INF, 0.0, NAN,
                       -0.0, 2]] * 2, np.float32)
        d[1] = d[1, ::-1]
        ids = np.arange(24, dtype=np.int32).reshape(2, 12)
        return ids, d, 12, 4
    if name == "fewer_than_k":
        d = np.full((3, 30), INF, np.float32)
        ids = np.full((3, 30), -1, np.int32)
        d[:, 4:6], ids[:, 4:6] = 1.0, 7
        return ids, d, 10, 10
    if name == "w_1":
        return (np.array([[3], [-1]], np.int32),
                np.array([[0.5], [INF]], np.float32), 1, 1)
    if name == "warp_width":
        d = rng.integers(0, 100, (3, WARP_MAX_C)).astype(np.float32)
        ids = np.arange(3 * WARP_MAX_C, dtype=np.int32).reshape(3, -1)
        return ids, d, WARP_MAX_K, WARP_MAX_K
    if name == "warp_width_plus_1":
        d = rng.integers(0, 100, (3, WARP_MAX_C + 1)).astype(np.float32)
        ids = np.arange(3 * (WARP_MAX_C + 1), dtype=np.int32).reshape(3, -1)
        return ids, d, 1, 1
    raise KeyError(name)


MERGE_CASES = ["unsorted_runs", "sharded_sink", "specials", "fewer_than_k",
               "w_1", "warp_width", "warp_width_plus_1"]


def as_torch(ids, d):
    return torch.from_numpy(ids), torch.from_numpy(d)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def test_route_boundaries():
    """The route depends on (C, k) alone; the warp route's last width and
    k, and the block route's first."""
    assert route_for(1, 1) == "warp"
    assert route_for(320, 10) == "warp"              # the rerank
    assert route_for(80, 10) == "warp"               # the origin merge
    assert route_for(WARP_MAX_C, WARP_MAX_K) == "warp"
    assert route_for(WARP_MAX_C + 1, 10) == "block"
    assert route_for(96, WARP_MAX_K + 1) == "block"
    assert route_for(MAX_C, 10) == "block"
    assert WARP_MAX_C == LANES * 32                  # 32 slots a lane


@pytest.mark.parametrize("name", TOPK_CASES)
def test_keep_first_steps_equal_first_column_table(name):
    """The warp route's ordered steps mask exactly the slots that a table
    of each id's first column masks, and so does the block route's sort by
    (id, column)."""
    ids = torch.from_numpy(topk_case(name)[0])
    want = first_column_table(ids)
    assert torch.equal(stepwise_later_duplicates(ids), want)
    assert torch.equal(sorted_later_duplicates(ids), want)


@pytest.mark.parametrize("name", TOPK_CASES)
def test_topk_select_mirror_equals_plain(name):
    """The route ``route_for`` picks, and the block route, which takes
    every row up to MAX_C columns, on the same rows."""
    ids, d, k = topk_case(name)
    ids, d = as_torch(ids, d)
    want = ref.topk_select_ref(ids, d, k=k)
    for route in {route_for(ids.shape[1], k), "block"}:
        assert same_bits(mirror_topk_select(ids, d, k, route), want), route
    if name == "later_dup_smaller":   # the worse first occurrence is kept
        assert want[0][0].tolist()[:3] == [3, 9, 5]
    if name == "signed_zero":         # ties by column, sign bits kept
        assert want[0][0].tolist()[:4] == [0, 1, 4, 5]
        assert torch.equal(want[1][0, :4].view(torch.int32),
                           d[0, [0, 1, 4, 5]].view(torch.int32))


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_topk_mirror_equals_plain(name):
    ids, d, k, run = merge_case(name)
    ids, d = as_torch(ids, d)
    want = ref.merge_topk_ref(ids, d, k=k, run=run)
    for route in {route_for(ids.shape[1], k), "block"}:
        assert same_bits(mirror_merge_topk(ids, d, k, route), want), route


@pytest.mark.parametrize("kernel,fault,name", [
    ("topk_select", "keep_last", "later_dup_smaller"),
    ("topk_select", "ties_high", "ties"),
    ("topk_select", "neg_zero_first", "signed_zero"),
    ("merge_topk", "ties_high", "unsorted_runs"),
    ("merge_topk", "neg_zero_first", "specials"),
])
def test_planted_faults_fail_the_check(kernel, fault, name):
    """Each fault, planted in the warp route's mirror, breaks bitwise
    agreement on its row; the same row agrees without it."""
    if kernel == "topk_select":
        ids, d, k = topk_case(name)
        ids, d = as_torch(ids, d)
        want = ref.topk_select_ref(ids, d, k=k)
        run = lambda f: mirror_topk_select(ids, d, k, "warp", f)  # noqa: E731
    else:
        ids, d, k, r = merge_case(name)
        ids, d = as_torch(ids, d)
        want = ref.merge_topk_ref(ids, d, k=k, run=r)
        run = lambda f: mirror_merge_topk(ids, d, k, "warp", f)  # noqa: E731
    assert not same_bits(run(fault), want)
    assert same_bits(run(None), want)
