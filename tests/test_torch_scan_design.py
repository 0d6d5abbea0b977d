"""The design of the ``cluster_scan`` CUDA kernel, mirrored in plain
PyTorch on the CPU and held bitwise against the plain versions.

The kernel (``src/repro_torch/kernels/csrc/cluster_scan.cu``) ranks a row
through per-lane partial-sum tables, one per code byte (or per 4-bit half
above W = 64), and selects the top-EF through a running threshold tau: a
row's 64-bit key enters a small candidate buffer only if it is below the
EF-th best key so far, and the buffer is merged into the sorted top-EF
before it could overflow. The mirror below takes the same two steps, with
the buffer's size and the rows per iteration as parameters:

  (a) the table sums equal ``binary_ip_rank_ref``'s masked sum bitwise;
  (b) the whole mirror equals ``cluster_scan_ref`` bitwise for small
      buffers, on rising, falling and equal ranks in row order, INT_MIN and
      INT_MAX ranks, n_valid of 0, below EF and M, EF = M and EF = 1024;
  (c) three faults planted in the mirror make (b) fail;
  (d) the float rank order key of the exact policy (common.cuh
      ``rank_order_key``), mirrored bit by bit: it equals
      ``ref.float_order_key``, orders NaN of either sign last (after +inf,
      after the F32_MAX pad), inverts, and a planted fault (a negative NaN
      keyed as it is, not canonicalised) breaks the order; the exact rank
      never gives -0.0, shown on rows built to cancel exactly.

The kernel itself is held against ``cluster_scan_ref`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

INT_MAX, INT_MIN = 2**31 - 1, -2**31
U32 = 2**32
ALL_ONES = 2**63 - 1          # the key all ones, as the offset int64 below


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def lane_tables(lut, dim, w, nibble, zero_past_dim=True):
    """(L, n_tables, entries) int64 in [0, 2^32): T[b][x] = the uint32 sum
    of lut[8b + j] over the set bits j of x (byte route, 256 entries per
    byte), or of lut[4h + j] (nibble route, 16 entries per half byte h).
    LUT entries at or past ``dim`` are zeroed first."""
    lut = lut.long()
    if zero_past_dim:
        lut = torch.where(torch.arange(8 * w) < dim, lut, 0)
    bits = 4 if nibble else 8
    x = torch.arange(1 << bits)
    sel = ((x[:, None] >> torch.arange(bits)) & 1).long()     # (X, bits)
    per = lut.view(lut.shape[0], -1, bits)                     # (L, B, bits)
    return (per[:, :, None, :] * sel).sum(-1) % U32            # (L, B, X)


def table_sums(codes, tables, nibble):
    """(L, R) S = the sum over code bytes of the table entries, mod 2^32;
    codes (L, R, W) uint8."""
    c = codes.long()
    if nibble:
        c = torch.stack([c & 15, c >> 4], -1).flatten(-2)     # (L, R, 2W)
    idx = c.permute(0, 2, 1)                                   # (L, B, R)
    got = torch.gather(tables, 2, idx)                         # (L, B, R)
    return got.sum(1) % U32


def o3_epilogue(s, f_add, sumq, s1, s2):
    """common.cuh's ``o3_rank`` on int64-carried uint32 sums; (L, R)."""
    t = ref.wrap_int32(2 * s - sumq.long()[:, None]).long()

    def shift(v, a):
        return v >> torch.where((a < 0) | (a > 31), 31, a)[:, None]
    third = torch.where(s2.long()[:, None] >= 31, 0,
                        shift(t, s2.long().clamp(max=30)))
    tp = ref.wrap_int32(t + shift(t, s1.long()) + third).long()
    return ref.wrap_int32(f_add.long() - tp)


def rank_keys(ranks, rows):
    """The kernel's key (rank_key(r) << 32) | row, offset by -2^63 into
    int64 so that its unsigned order is int64 order."""
    rk = (ranks.long() + 0x7FFFFFFF) % U32
    return ((rk - 2**31) << 32) | rows.long()


def key_fields(keys):
    """(rows, ranks) int32 of offset keys."""
    rows = (keys & 0xFFFFFFFF).to(torch.int32)
    rk = (keys >> 32) + 2**31
    return rows, ref.wrap_int32(rk - 0x7FFFFFFF)


def select(keys, ef, buf, it, first, merge_at, fault=None):
    """The kernel's running selection over one lane's keys in row order:
    the best efp keys kept sorted, tau = the EF-th of them. Rows come
    ``first`` at a time until tau is set, then ``it`` at a time; a key below
    tau is appended to a buffer of ``buf`` slots. Before an iteration, the
    buffer is merged with the top (one sort) if it could overflow, if
    ``merge_at`` keys wait, or if EF keys wait while tau is unset; and once
    more at the end."""
    efp = 1 << (ef - 1).bit_length()
    top = torch.full((efp,), ALL_ONES, dtype=torch.long)
    pending = []
    tau = ALL_ONES

    def merge():
        nonlocal top, tau
        allk = torch.cat([top, torch.tensor(pending, dtype=torch.long)])
        top = torch.sort(allk).values[:efp]
        pending.clear()
        tau = int(top[ef - 2 if fault == "tau_off_by_one" else ef - 1])
    r0 = 0
    while r0 < keys.numel():
        f = len(pending)
        guard = f > buf - it or f >= merge_at
        if (guard and fault != "drop_on_overflow") or (
                tau == ALL_ONES and f >= ef):
            merge()
        step = first if tau == ALL_ONES else it
        for k in keys[r0:r0 + step].tolist():
            if k < tau:
                if len(pending) < buf:
                    pending.append(k)
                elif fault != "drop_on_overflow":
                    raise AssertionError("the buffer overflowed")
        r0 += step
    if pending:
        merge()
    return top[:ef]


def mirror_scan(codes, f_add, base_rows, n_valid, lut, sumq, s1, s2, active,
                dim, ef, m, *, buf, it, first, merge_at, nibble=False,
                fault=None):
    """The kernel's two steps in plain PyTorch; the signature of
    ``ref.cluster_scan_ref`` plus the buffer, the rows per iteration, the
    merge policy (``select``) and the table route."""
    w = codes.shape[1]
    tables = lane_tables(lut, dim, w, nibble,
                         zero_past_dim=fault != "tables_not_zeroed")
    ids = torch.full((len(active), ef), -1, dtype=torch.int32)
    ranks = torch.full((len(active), ef), INT_MAX, dtype=torch.int32)
    for lane in range(len(active)):
        if not bool(active[lane]):
            continue
        nv = min(max(int(n_valid[lane]), 0), m)
        n_end = min(m, nv + ef)
        rows = torch.arange(n_end)
        g = (int(base_rows[lane]) + rows[:nv]).clamp(0, codes.shape[0] - 1)
        s = table_sums(codes[g][None], tables[lane:lane + 1], nibble)
        r = torch.full((n_end,), INT_MAX, dtype=torch.long)
        r[:nv] = o3_epilogue(s, f_add[g][None], sumq[lane:lane + 1],
                             s1[lane:lane + 1], s2[lane:lane + 1])[0].long()
        best = select(rank_keys(r, rows), ef, buf, it, first, merge_at, fault)
        ids[lane], ranks[lane] = key_fields(best)
    return ids, ranks


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def scan_inputs(rng, kind, m, ef, w=16, dim=125, n_lanes=5, n_clusters=3):
    """A (n_clusters * m, W) table and lanes over it, with LUT entries past
    ``dim`` set (they must not count). Lanes: n_valid 0, 3 (below EF), M,
    random, and one inactive lane. ``kind`` shapes the ranks in row order:
    with a zero LUT and sumq a row ranks f_add, so "rising", "falling" and
    "equal" set f_add; "extremes" mixes INT_MIN and INT_MAX into f_add;
    "late" ranks rising by 2 and the cluster's last row just inside the EF
    best, after the running threshold has settled; "random" ranks through a
    LUT of 2^28-sized entries."""
    t = n_clusters * m
    codes = rng.integers(0, 256, (t, w), dtype=np.uint8)
    lut = rng.integers(-(1 << 28), 1 << 28, (n_lanes, 8 * w)).astype(np.int32)
    sumq = rng.integers(-(1 << 30), 1 << 30, n_lanes).astype(np.int32)
    f_add = rng.integers(-(1 << 12), 1 << 12, t).astype(np.int32)
    if kind in ("rising", "falling", "equal", "extremes", "late"):
        lut[:, :dim] = 0
        sumq[:] = 0
        i = np.arange(t) % m
        f_add = {"rising": i, "falling": m - i, "equal": 0 * i,
                 "extremes": f_add, "late": 2 * i}[kind].astype(np.int32)
        if kind == "late":
            f_add[i == m - 1] = 2 * ef - 3     # between the EF-1-th and EF-th
        if kind == "extremes":
            f_add[::3] = INT_MAX
            f_add[1::5] = INT_MIN
    s1 = rng.integers(0, 33, n_lanes).astype(np.int32)
    s2 = rng.integers(0, 33, n_lanes).astype(np.int32)
    s2[::2] = 31
    base = (rng.integers(0, n_clusters, n_lanes) * m).astype(np.int32)
    nv = np.array([0, min(3, m), m] + [int(rng.integers(0, m + 1))]
                  * (n_lanes - 3), np.int32)
    active = np.ones(n_lanes, bool)
    active[-1] = False
    return [torch.from_numpy(a) for a in
            (codes, f_add, base, nv, lut, sumq, s1, s2, active)]


# ---------------------------------------------------------------------------
# (a) table sums
# ---------------------------------------------------------------------------

def masked_sum(codes, lut, dim):
    """``binary_ip_rank_ref``'s S: the sum of lut[:dim] over the set bits of
    each code, wrapped to int32; codes (L, R, W), lut (L, Dpad)."""
    bits = ref.unpack_bits(codes, dim).long()
    return ref.wrap_int32((bits * lut[:, None, :dim].long()).sum(-1))


@pytest.mark.parametrize("nibble", [False, True], ids=["byte", "nibble"])
@pytest.mark.parametrize("w,dim", [(4, 29), (4, 32), (16, 121), (16, 125),
                                   (16, 128), (32, 250), (32, 256)])
def test_table_sums_equal_masked_sum(w, dim, nibble):
    rng = np.random.default_rng(w * 1000 + dim)
    n_lanes, n_rows = 6, 40
    codes = torch.from_numpy(rng.integers(0, 256, (n_lanes, n_rows, w),
                                          dtype=np.uint8))
    codes[:, 0] = 255                        # every bit, padding bits too
    lut = rng.integers(-(1 << 28), 1 << 28, (n_lanes, 8 * w)).astype(np.int64)
    edge = np.array([INT_MAX, INT_MAX - 1, INT_MIN, INT_MIN + 1, -1, 1])
    lut[1] = rng.choice(edge, 8 * w)         # entries at and near +-2^31
    lut[2] = INT_MAX
    lut[3] = INT_MIN
    lut[4, ::2], lut[4, 1::2] = INT_MAX, INT_MIN
    lut = torch.from_numpy(lut.astype(np.int32))
    tables = lane_tables(lut, dim, w, nibble)
    s = table_sums(codes, tables, nibble)
    assert torch.equal(ref.wrap_int32(s), masked_sum(codes, lut, dim))
    # and the ranks built on them equal binary_ip_rank_ref's
    flat = codes.reshape(-1, w)
    f_add = torch.from_numpy(rng.integers(INT_MIN, INT_MAX, flat.shape[0],
                                          dtype=np.int64).astype(np.int32))
    rows = torch.arange(flat.shape[0], dtype=torch.int32).view(n_lanes, -1)
    sumq = torch.from_numpy(rng.integers(INT_MIN, INT_MAX, n_lanes,
                                         dtype=np.int64).astype(np.int32))
    s1 = torch.tensor([0, 1, 5, 31, 32, -3], dtype=torch.int32)
    s2 = torch.tensor([31, 2, 30, 33, 7, 31], dtype=torch.int32)
    got = o3_epilogue(s, f_add[rows.long()], sumq, s1, s2)
    want = ref.binary_ip_rank_ref(flat, f_add, rows, lut, sumq, s1, s2, dim)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (b) the threshold filter
# ---------------------------------------------------------------------------

FILTER_CASES = {          # kind, M, EF, W, dim, nibble tables
    "rising": ("rising", 300, 40, 16, 125, False),
    "falling": ("falling", 300, 40, 16, 125, False),
    "equal": ("equal", 300, 40, 16, 125, False),
    "extremes": ("extremes", 300, 40, 16, 121, False),
    "random": ("random", 300, 40, 16, 125, False),
    "late": ("late", 300, 40, 16, 125, False),
    "random_nibble": ("random", 200, 17, 16, 121, True),
    "ef_eq_m": ("extremes", 50, 50, 4, 29, False),
    "ef_1024": ("random", 1100, 1024, 16, 128, False),
}


def run_case(name, buf, fault=None):
    kind, m, ef, w, dim, nibble = FILTER_CASES[name]
    rng = np.random.default_rng(len(name) * 100 + m)
    args = scan_inputs(rng, kind, m, ef, w, dim,
                       n_lanes=4 if ef == 1024 else 5)
    it = max(1, buf // 3)
    got = mirror_scan(*args, dim, ef, m, buf=buf, it=it,
                      first=max(1, it // 2), merge_at=max(1, buf // 2),
                      nibble=nibble, fault=fault)
    want = ref.cluster_scan_ref(*args, dim, ef, m)
    return got, want


@pytest.mark.parametrize("buf", [1, 7, 64])
@pytest.mark.parametrize("name", list(FILTER_CASES))
def test_threshold_filter_equals_cluster_scan_ref(name, buf):
    (ids, ranks), (want_ids, want_ranks) = run_case(name, buf)
    assert torch.equal(ids, want_ids)
    assert torch.equal(ranks, want_ranks)
    kind, m, ef = FILTER_CASES[name][:3]
    if kind == "extremes" and ef == m:     # every row kept: INT_MIN last
        assert int(want_ranks[2, -1]) == INT_MIN


# ---------------------------------------------------------------------------
# (c) planted faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("buf", [1, 7, 64])
@pytest.mark.parametrize("fault,name", [
    ("tau_off_by_one", "late"),            # tau from the (EF-1)-th key
    ("drop_on_overflow", "falling"),       # no merge before overflow: a
                                           # full buffer drops its keys
    ("tables_not_zeroed", "random"),       # entries at d >= dim counted
])
def test_planted_faults_fail_the_filter_check(fault, name, buf):
    (ids, ranks), (want_ids, want_ranks) = run_case(name, buf, fault)
    assert not (torch.equal(ids, want_ids) and torch.equal(ranks, want_ranks))
    # the same case passes without the fault
    (ids, ranks), _ = run_case(name, buf)
    assert torch.equal(ids, want_ids) and torch.equal(ranks, want_ranks)


# ---------------------------------------------------------------------------
# (d) the float rank order key
# ---------------------------------------------------------------------------

F32_MAX_BITS = 0x7F7FFFFF


def rank_order_key(bits, canonical=True):
    """common.cuh's ``rank_order_key`` on a float32 bit pattern: a NaN
    becomes the positive quiet NaN (unless the planted fault drops that),
    then the sign decides the flip."""
    if canonical and (bits & 0x7F800000) == 0x7F800000 and bits & 0x7FFFFF:
        bits = 0x7FC00000
    return bits ^ (0xFFFFFFFF if bits & 0x80000000 else 0x80000000)


def rank_of_key(key):
    """common.cuh's ``rank_of_key``."""
    return key ^ (0x80000000 if key & 0x80000000 else 0xFFFFFFFF)


# float32 bit patterns in ascending order of the GEMV path (lax.top_k of
# the negated ranks: -0.0 first of the zeros); the NaNs, last, keep their
# order among themselves (ties to the lower row)
ORDERED = [0xFF800000,            # -inf
           0xFF7FFFFF,            # -F32_MAX
           0xBF800000,            # -1.0
           0x80000001,            # the smallest negative subnormal
           0x80000000,            # -0.0
           0x00000000,            # +0.0
           0x00000001,            # the smallest subnormal
           0x3F000000,            # 0.5
           F32_MAX_BITS,          # F32_MAX, the pad
           0x7F800000,            # +inf
           0x7FC00000,            # the quiet NaN
           0xFFC00000,            # a negative NaN
           0x7F800001,            # a signalling NaN
           0xFFFFFFFF]            # a negative NaN with every payload bit


def _shuffled(seed):
    order = np.random.default_rng(seed).permutation(len(ORDERED))
    return [ORDERED[i] for i in order], order


def _sorted_by(key_fn, bits):
    return sorted(range(len(bits)), key=lambda i: (key_fn(bits[i]), i))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float_order_key_mirror_equals_plain_and_orders(seed):
    bits, _ = _shuffled(seed)
    r = torch.tensor(np.array(bits, np.uint32).view(np.int32)).view(
        torch.float32)
    plain = ref.float_order_key(r).tolist()
    assert plain == [rank_order_key(b) for b in bits]
    got = [bits[i] for i in _sorted_by(rank_order_key, bits)]
    nan = [b for b in bits if (b & 0x7F800000) == 0x7F800000 and b & 0x7FFFFF]
    assert got == ORDERED[:10] + nan           # NaN of either sign last
    assert rank_order_key(F32_MAX_BITS) < rank_order_key(0x7F800000) \
        < rank_order_key(0xFFC00000)            # pad < inf < NaN
    for b in ORDERED[:10]:                      # the key inverts
        assert rank_of_key(rank_order_key(b)) == b
    assert rank_of_key(rank_order_key(0xFFC00000)) == 0x7FC00000
    # the scan's order equals ref.scan_order's on the same ranks
    want = torch.sort(ref.scan_order(r), stable=True).indices.tolist()
    assert want == _sorted_by(rank_order_key, bits)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planted_fault_uncanonicalised_nan_fails(seed):
    """Keyed as it is, a negative NaN's flipped bits sort it first."""
    bits, _ = _shuffled(seed)
    got = [bits[i] for i in _sorted_by(
        lambda b: rank_order_key(b, canonical=False), bits)]
    assert got[0] in (0xFFC00000, 0xFFFFFFFF)
    nan = [b for b in bits if (b & 0x7F800000) == 0x7F800000 and b & 0x7FFFFF]
    assert got != ORDERED[:10] + nan


def _exact_ranks(rn, qn, codes, lut, sum_lut, cos, dim):
    """ref.exact_rank_ref over one lane's rows."""
    n = len(rn)
    f = torch.float32
    return ref.exact_rank_ref(
        torch.tensor(codes, dtype=torch.uint8)[:, None],
        torch.tensor(rn, dtype=f), torch.tensor(cos, dtype=f),
        torch.arange(n, dtype=torch.int32)[None],
        torch.tensor(lut, dtype=f)[None], torch.tensor([sum_lut], dtype=f),
        torch.tensor([qn], dtype=f), dim)[0]


def test_exact_rank_cancels_to_positive_zero():
    """Rows built so that rn^2 + qn^2 equals 2 rn qn est exactly (dim 4,
    so sqrt(D) = 2: code 1 gives S = 0.5 and obar = 0.5, over cos 0.5 est =
    1; rn = qn = 3 gives 18 - 18), and zero norms with est = 1 and -1:
    every rank is +0.0, never -0.0, so the kernels' total-order key (-0.0
    before +0.0) and the plain beam's stable sort (-0.0 ties +0.0) never
    meet on a rank."""
    lut = [0.5, 0, 0, 0, 0, 0, 0, 0]
    for rn, qn, code in ((3.0, 3.0, 1), (0.0, 0.0, 1), (0.0, 0.0, 0),
                         (2.0, 2.0, 1)):
        sum_lut = 0.0 if code else 1.0           # code 0: obar = -0.5
        r = _exact_ranks([rn] * 3, qn, [code] * 3, lut, sum_lut,
                         [0.5] * 3, 4)
        assert (r.view(torch.int32) == 0).all(), (rn, qn, code, r)
    # and on random rows with every sign of est, no rank is -0.0
    rng = np.random.default_rng(5)
    rn = np.abs(rng.standard_normal(4000)).astype(np.float32)
    rn[::3] = 0
    codes = rng.integers(0, 256, 4000)
    for qn in (0.0, 1.5):
        r = _exact_ranks(rn, qn, codes, rng.standard_normal(8), 0.3,
                         rng.random(4000), 8)
        assert not (r.view(torch.int32) == -2**31).any()
