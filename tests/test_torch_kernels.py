"""The port's kernel seam on the CPU: the plain versions in
``repro_torch/kernels/ref.py`` against the JAX package's references, and the
dispatch-by-device rule of ``repro_torch/kernels/ops.py``.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``; they have no CPU mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import topk_select as jtopk  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    beam_search, binary_ip, cluster_scan, flash_attn, merge_topk, ops,
    topk_select)
from repro_torch.kernels import ref as tref  # noqa: E402

INT_MAX = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs test files in parallel workers, and
    timing-sensitive tests in other files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the JAX references, jitted once per shape (op-by-op dispatch is slow)
_jax_topk = jax.jit(jref.topk_select_ref, static_argnames="k")
_jax_rank_lanes = jax.jit(
    jax.vmap(jref.binary_ip_rank_ref, in_axes=(0, 0, 0, 0, 0, 0, None)),
    static_argnums=6)


def _rank_inputs(rng, n_lanes, n_rows, w, dim, t=97, s1=2, s2=31):
    codes = rng.integers(0, 256, (t, w), dtype=np.uint8)
    f_add = rng.integers(0, 1 << 20, (t,), dtype=np.int32)
    f_add[::5] = INT_MAX                    # pad rows of the compact index
    rows = rng.integers(-1, t, (n_lanes, n_rows)).astype(np.int32)
    lut = rng.integers(-4096, 4096, (n_lanes, w * 8)).astype(np.int32)
    lut[:, dim:] = 0
    sumq = lut.sum(-1).astype(np.int32)
    s1v = np.full(n_lanes, s1, np.int32)
    s2v = np.full(n_lanes, s2, np.int32)
    s2v[::2] = 31                           # alternate the 2-term form
    return codes, f_add, rows, lut, sumq, s1v, s2v


def _jax_rank_per_lane(codes, f_add, rows, lut, sumq, s1, s2, dim):
    """The JAX reference rank of each lane's gathered rows."""
    safe = np.clip(rows, 0, None)
    r = _jax_rank_lanes(codes[safe], f_add[safe], lut, sumq, s1, s2, dim)
    return np.where(rows >= 0, np.asarray(r), INT_MAX)


@pytest.mark.parametrize("n_lanes,n_rows,w,dim_off,s1,s2", [
    (4, 32, 16, 0, 2, 31), (3, 12, 4, 3, 1, 5), (5, 7, 8, 7, 3, 6),
    (2, 64, 2, 1, 4, 9), (6, 1, 16, 0, 2, 3),
])
def test_binary_ip_rank_ref_bitwise_vs_jax(rng, n_lanes, n_rows, w, dim_off,
                                           s1, s2):
    dim = w * 8 - dim_off
    args = _rank_inputs(rng, n_lanes, n_rows, w, dim, s1=s1, s2=s2)
    want = _jax_rank_per_lane(*args, dim)
    got = tref.binary_ip_rank_ref(*(torch.from_numpy(a) for a in args), dim)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_binary_ip_rank_ref_wraps_like_int32(rng):
    """Negative t, INT_MAX f_add and a LUT large enough to overflow S: the
    port's int64-carried arithmetic wraps exactly as the int32 reference."""
    w, dim = 4, 32
    codes = np.full((3, w), 255, np.uint8)
    f_add = np.array([INT_MAX, -INT_MAX, 0], np.int32)
    rows = np.array([[0, 1, 2, -1]], np.int32)
    lut = np.full((1, 32), 2**27, np.int32)          # S = 2^32 wraps to 0
    lut[0, :3] = -(2**30)
    sumq = np.array([-(2**31) + 5], np.int32)
    for s2 in (31, 4):
        args = (codes, f_add, rows, lut, sumq, np.array([1], np.int32),
                np.array([s2], np.int32))
        want = _jax_rank_per_lane(*args, dim)
        got = tref.binary_ip_rank_ref(*(torch.from_numpy(a) for a in args),
                                      dim)
        np.testing.assert_array_equal(got.numpy(), want)


def _cand_set(rng, q, c, with_ties=True):
    """The candidate sets of tests/test_topk_select.py: duplicates, -1
    pads, an all-pad row, a single-id row and exact distance ties."""
    ids = rng.integers(-1, max(2, c // 2), (q, c)).astype(np.int32)
    d = rng.random((q, c)).astype(np.float32)
    ids[:, -2:] = -1
    if q > 1:
        ids[0, :] = -1
    if q > 2:
        ids[1, :] = 7
    if with_ties and c >= 8:
        d[:, 3:7] = 0.5
    return ids, d


@pytest.mark.parametrize("q,c,k", [
    (1, 8, 4), (3, 33, 5), (4, 64, 10), (7, 300, 10), (8, 512, 16),
    (2, 10, 10),   # k == c
    (5, 320, 10),  # the rerank's C = nprobe * ef at the default config
])
def test_topk_select_ref_bitwise_vs_jax(rng, q, c, k):
    ids, d = _cand_set(rng, q, c)
    ri, rd = _jax_topk(jnp.asarray(ids), jnp.asarray(d), k=k)
    ti, td = tref.topk_select_ref(torch.from_numpy(ids), torch.from_numpy(d),
                                  k=k)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))


def _runs(rng, q, o, run):
    """tests/test_topk_select.py's merge inputs: pre-sorted disjoint runs
    with unfilled tails, an exact tie across runs and an unanswered row."""
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
    (1, 1, 4, 4), (4, 3, 10, 10), (7, 4, 5, 5), (5, 8, 10, 10),
    (3, 5, 10, 10), (2, 6, 12, 7),
])
def test_merge_topk_ref_bitwise_vs_jax(rng, q, o, run, k):
    """Against the JAX reference and the Pallas kernel in interpret mode."""
    ids, d = _runs(rng, q, o, run)
    ti, td = tref.merge_topk_ref(torch.from_numpy(ids), torch.from_numpy(d),
                                 k=k, run=run)
    for want in (jref.merge_topk_ref(jnp.asarray(ids), jnp.asarray(d), k=k),
                 jtopk.merge_topk(jnp.asarray(ids), jnp.asarray(d), k=k,
                                  run=run, interpret=True)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(td.numpy(), np.asarray(want[1]))


def _scan_inputs(rng, n_lanes, m, w, n_clusters=3):
    """A flattened (n_clusters * m, W) table and n_lanes lanes over it,
    with no rank near the int32 edges."""
    codes = rng.integers(0, 256, (n_clusters * m, w), dtype=np.uint8)
    f_add = rng.integers(0, 1 << 20, (n_clusters * m,), dtype=np.int32)
    lut = rng.integers(-4096, 4096, (n_lanes, w * 8)).astype(np.int32)
    sumq = lut.sum(-1).astype(np.int32)
    base = (rng.integers(0, n_clusters, n_lanes) * m).astype(np.int32)
    nv = rng.integers(0, m + 1, n_lanes).astype(np.int32)
    s1 = np.full(n_lanes, 2, np.int32)
    s2 = np.full(n_lanes, 31, np.int32)
    s2[1::2] = 5
    return (codes, f_add, base, nv, lut, sumq, s1, s2,
            np.ones(n_lanes, bool))


@pytest.mark.parametrize("n,w,ef,nv", [
    (64, 8, 4, 64), (300, 16, 10, 250), (1024, 16, 32, 1000),
    (513, 8, 16, 513),
])
def test_cluster_scan_ref_bitwise_vs_jax(rng, n, w, ef, nv):
    """Lane by lane against the JAX reference, on tests/test_kernels.py's
    sweep; lanes also take n_valid below EF and an empty cluster."""
    args = list(_scan_inputs(rng, 4, n, w))
    args[3][:] = [nv, 0, min(3, ef - 1), n]
    codes, f_add, base, n_valid, lut, sumq, s1, s2, _ = args
    dim = w * 8
    ids, ranks = tref.cluster_scan_ref(*(torch.from_numpy(a) for a in args),
                                       dim, ef, n)
    for lane in range(4):
        rows = slice(base[lane], base[lane] + n)
        wi, wr = jref.cluster_scan_ref(
            jnp.asarray(codes[rows]), jnp.asarray(f_add[rows]),
            jnp.asarray(lut[lane]), jnp.int32(sumq[lane]),
            jnp.int32(s1[lane]), jnp.int32(s2[lane]), dim, ef,
            jnp.int32(n_valid[lane]))
        np.testing.assert_array_equal(ids[lane].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(ranks[lane].numpy(), np.asarray(wr))


def _beam_inputs(rng, n_lanes, m, r, w, n_clusters=3):
    """A flattened (n_clusters * m) cluster table with neighbour rows of
    local ids (-1 pads, duplicates), and n_lanes lanes over it."""
    t = n_clusters * m
    codes = rng.integers(0, 256, (t, w), dtype=np.uint8)
    f_add = rng.integers(0, 1 << 10, (t,), dtype=np.int32)
    nbrs = rng.integers(-1, m, (t, r)).astype(np.int32)
    base = (rng.integers(0, n_clusters, n_lanes) * m).astype(np.int32)
    entry = rng.integers(0, m, n_lanes).astype(np.int32)
    lut = rng.integers(-64, 64, (n_lanes, w * 8)).astype(np.int32)
    sumq = lut.sum(-1).astype(np.int32)
    s1 = np.full(n_lanes, 2, np.int32)
    s2 = np.full(n_lanes, 31, np.int32)
    active = np.ones(n_lanes, bool)
    active[-1] = False
    return codes, f_add, nbrs, base, entry, lut, sumq, s1, s2, active


def test_ops_dispatch_cpu_tensors_to_plain_versions(rng):
    """CPU tensors take the plain version and launch nothing."""
    ops.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _rank_inputs(rng, 3, 5, 4, 32)]
    np.testing.assert_array_equal(
        ops.binary_ip_rank(*args, 32).numpy(),
        tref.binary_ip_rank_ref(*args, 32).numpy())
    ids, d = (torch.from_numpy(a) for a in _cand_set(rng, 4, 40))
    for a, b in zip(ops.topk_select(ids, d, k=6),
                    tref.topk_select_ref(ids, d, k=6)):
        assert torch.equal(a, b)
    for a, b in zip(ops.merge_topk(ids, d, k=5),
                    tref.merge_topk_ref(ids, d, k=5)):
        assert torch.equal(a, b)
    scan = [torch.from_numpy(a) for a in _scan_inputs(rng, 3, 20, 4)]
    for a, b in zip(ops.cluster_scan(*scan, 32, 6, 20),
                    tref.cluster_scan_ref(*scan, 32, 6, 20)):
        assert torch.equal(a, b)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       tref.flash_attention_ref(q, k, v, causal=True))
    beam = [torch.from_numpy(a) for a in _beam_inputs(rng, 4, 30, 5, 4)]
    for a, b in zip(ops.beam_search(*beam, 32, 6, 9, 30),
                    tref.beam_search_ref(*beam, 32, 6, 9, 30)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == dict.fromkeys(
        ("binary_ip_rank", "topk_select", "merge_topk", "cluster_scan",
         "flash_attention", "beam_search"), 0)


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """A wrapper launches its kernel or raises: it never computes a result
    on the CPU itself (and so never builds anything here)."""
    args = [torch.from_numpy(a) for a in _rank_inputs(rng, 2, 3, 4, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        binary_ip.binary_ip_rank(*args, 32)
    ids, d = (torch.from_numpy(a) for a in _cand_set(rng, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        topk_select.topk_select(ids, d, k=4)
    with pytest.raises(ValueError, match="CUDA"):
        merge_topk.merge_topk(ids, d, k=4)
    scan = [torch.from_numpy(a) for a in _scan_inputs(rng, 2, 20, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        cluster_scan.cluster_scan(*scan, 32, 6, 20)
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention(q, q, q, causal=True)
    beam = [torch.from_numpy(a) for a in _beam_inputs(rng, 2, 20, 4, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        beam_search.beam_search(*beam, 32, 6, 9, 20)
    assert ops.launch_counts() == dict.fromkeys(
        ("binary_ip_rank", "topk_select", "merge_topk", "cluster_scan",
         "flash_attention", "beam_search"), 0)


def test_unpack_bits_matches_jax(rng):
    packed = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    for dim in (24, 21):
        np.testing.assert_array_equal(
            tref.unpack_bits(torch.from_numpy(packed), dim).numpy(),
            np.asarray(jref.unpack_bits(jnp.asarray(packed), dim)))


def test_kernel_sources_name_their_tpu_kernels():
    """Each CUDA source carries its header note: the TPU kernel it replaces
    and what bounds it on the card."""
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        head = (_build.CSRC / f"{name}.cu").read_text()[:2500]
        assert "repro/kernels/" in head and "Replaces the Pallas" in head
        assert "bounds it on an H100" in head
