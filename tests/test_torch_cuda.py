"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with ``nvcc`` (sm_90a) and skip without one; on
such a machine run ``PYTHONPATH=src python -m pytest -q
tests/test_torch_cuda.py``. They import no JAX: the plain versions are
held against the JAX package by the other tests/test_torch_*.py files on
the CPU. The sweeps reach what the main path does not: code widths that
take the kernel's byte loop (W not a multiple of 16), dim % 8 != 0,
shift amounts at their edges, k == C, one-column and 4096-column rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import binary_ip, ops, ref, topk_select  # noqa: E402

INT_MAX = 2**31 - 1


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


def test_topk_select_kernel_refuses_too_wide_rows(card):
    ids = torch.zeros((2, topk_select.MAX_C + 1), dtype=torch.int32,
                      device=card)
    with pytest.raises(ValueError, match="at most"):
        topk_select.topk_select(ids, ids.float(), k=4)


def test_ops_send_cuda_tensors_to_the_kernels(card):
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(a).to(card)
            for a in _rank_inputs(rng, 4, 8, 16, 128)]
    ids, d = (torch.from_numpy(a).to(card) for a in _cand_set(rng, 4, 40))
    ops.reset_launch_counts()
    ops.binary_ip_rank(*args, 128)
    ops.topk_select(ids, d, k=5)
    assert ops.launch_counts() == {"binary_ip_rank": 1, "topk_select": 1}
