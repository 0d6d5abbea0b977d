"""Rows wider than the selection kernels hold (ROADMAP C3), on the CPU.

``topk_select`` takes a row of more than ``MAX_C`` columns in passes of the
same kernel (``topk_select.chunked_select``), and ``merge_topk`` a row of
more than ``MAX_W`` slots as a tree of launches (``merge_topk.merge_tree``).
Both compositions take the select function as a parameter; here it is the
plain version with a small row limit, so the passes run on the CPU and are
held bitwise against one call of the plain version on the whole row. The
kernels themselves go through the same compositions at C = 4,160 and
O k = 4,800 in ``tests/test_torch_cuda.py``.

Also here: every LM config, all of which the port serves, has a head dim
that the attention kernel takes (ROADMAP C2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_arch_ids, get_config, get_smoke  # noqa: E402,E501
from repro_torch.kernels import flash_attn, ref  # noqa: E402
from repro_torch.kernels.merge_topk import merge_tree  # noqa: E402
from repro_torch.kernels.topk_select import (  # noqa: E402
    check_chunkable, chunked_select)


def limited(fn, limit):
    """fn, refusing rows wider than ``limit`` (as the kernel would)."""
    def call(ids, d, **kw):
        assert ids.shape[1] <= limit and ids.is_contiguous()
        return fn(ids, d, **kw)
    return call


def rerank_rows(seed, q, c, n_ids):
    """Candidate rows as the rerank makes them: ids drawn with repeats
    (so duplicates straddle chunks), -1 pads, rows of all pads, and a
    distance that is a function of the id, on a coarse grid (ties across
    chunks), +inf for some ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n_ids, (q, c)).astype(np.int32)
    table = rng.integers(0, 50, n_ids).astype(np.float32) / 4
    table[::17] = np.inf
    ids[0] = -1
    if q > 2:
        ids[2, : c // 2] = ids[2, c // 2:c // 2 * 2]   # every id twice
    d = np.where(ids >= 0, table[np.clip(ids, 0, None)], 1.5)
    return torch.from_numpy(ids), torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("select", [ref.topk_select_ref], ids=["plain"])
@pytest.mark.parametrize("q,c,k,max_c,n_ids", [
    (6, 260, 10, 64, 300),     # five chunks, one pass after them
    (5, 65, 32, 64, 40),       # one column over; k = max_c // 2
    (4, 700, 30, 64, 2000),    # 11 chunks: the outputs take a second round
    (4, 1000, 1, 64, 50),      # k = 1
    (3, 128, 20, 64, 10),      # ten distinct ids: most of k is padding
])
def test_chunked_select_equals_one_call(select, q, c, k, max_c, n_ids):
    ids, d = rerank_rows(q * c + k, q, c, n_ids)
    got = chunked_select(limited(select, max_c), ids, d, k=k, max_c=max_c)
    want = ref.topk_select_ref(ids, d, k=k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_chunked_select_ties_and_duplicates_across_chunks():
    """A duplicate whose first occurrence is the last column of a chunk, a
    tie between chunks broken by the lower column, and an id whose first
    occurrence ranks outside its chunk's k but appears again later."""
    ids = torch.arange(40, dtype=torch.int32)[None].repeat(2, 1)
    d = torch.full((2, 40), 9.0)
    ids[:, 15] = 100
    d[:, 15] = 1.0
    ids[:, 20] = 100                                  # its duplicate
    d[:, 20] = 1.0
    d[:, 3] = d[:, 33] = 2.0                          # tie across chunks
    ids[1, 5] = 200                                   # first: rank > k
    d[1, 5] = 8.0
    d[1, :5] = 0.5
    ids[1, 25] = 200
    d[1, 25] = 8.0
    for k in (1, 3, 6, 8):
        got = chunked_select(limited(ref.topk_select_ref, 16), ids, d, k=k,
                             max_c=16)
        want = ref.topk_select_ref(ids, d, k=k)
        for g, w in zip(got, want):
            assert torch.equal(g, w), k


def test_chunked_select_needs_one_distance_per_id():
    """The limit the docstring states: a later duplicate that carries a
    smaller distance than its first occurrence, in another chunk, is kept
    by the passes where one call masks it."""
    ids = torch.arange(32, dtype=torch.int32)[None].clone()
    d = torch.arange(32, dtype=torch.float32)[None] + 10
    ids[0, 20] = 5                        # 5 again, with a smaller distance
    d[0, 20] = 0.0
    got = chunked_select(ref.topk_select_ref, ids, d, k=2, max_c=16)
    want = ref.topk_select_ref(ids, d, k=2)
    assert want[0].tolist() == [[0, 1]]
    assert got[0].tolist() == [[5, 0]]


def test_check_chunkable_passes_rerank_rows():
    """Rows as the rerank makes them meet both conditions: duplicates carry
    one distance, +inf distances and pads with any distance are allowed."""
    ids, d = rerank_rows(5, 6, 700, 300)
    d[0, :5] = float("nan")                            # row 0 is all pads
    check_chunkable(ids, d)


@pytest.mark.parametrize("fault", ["two distances", "nan", "-inf"])
def test_check_chunkable_refuses_what_the_passes_cannot_hold(fault):
    """The rows the CUDA wrapper refuses before its chunked passes, each of
    which the passes would select differently from one call."""
    ids, d = rerank_rows(6, 4, 200, 150)
    if fault == "two distances":
        ids[1, 1] = ids[1, 150] = 999                  # no other 999
        d[1, 1], d[1, 150] = 1.0, 0.5
    else:
        ids[2, 9] = 3
        d[2, ids[2] == 3] = float(fault)
    with pytest.raises(ValueError, match="one distance"):
        check_chunkable(ids, d)


def test_chunked_select_refuses_k_over_half_the_limit():
    ids, d = rerank_rows(1, 2, 100, 50)
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        chunked_select(ref.topk_select_ref, ids, d, k=33, max_c=64)


def sharded_rows(seed, q, o, run):
    """O sorted runs a row in the sharded sink's layout: unfilled tails
    (-1 / inf), exact ties across runs, an unanswered row, and -inf, NaN
    and -0.0 distances (the merge has no dedup, so the tree is exact on
    every value)."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, 40, (q, o, run)).astype(np.float32) / 8, -1)
    ids = np.arange(q * o * run, dtype=np.int32).reshape(q, o, run)
    d[:, 0, -2:] = np.inf
    ids[:, 0, -2:] = -1
    d[:, 1:, 0] = d[:, :1, 0]
    d[1] = np.inf
    ids[1] = -1
    if q > 3:
        d[3, 2, 1] = -np.inf
        d[3, 3, 2] = np.nan
        d[3, 4, 0] = -0.0
    return (torch.from_numpy(ids.reshape(q, o * run)),
            torch.from_numpy(d.reshape(q, o * run)))


@pytest.mark.parametrize("merge", [ref.merge_topk_ref], ids=["plain"])
@pytest.mark.parametrize("q,o,run,k,max_w", [
    (5, 48, 10, 10, 64),       # six runs a group, eight groups
    (4, 20, 30, 25, 64),       # two runs a group, k > run
    (4, 9, 100, 16, 64),       # a run wider than the limit
    (3, 300, 4, 32, 64),       # a tree of three levels
    (4, 8, 16, 8, 128),        # fits: one call
])
def test_merge_tree_equals_one_call(merge, q, o, run, k, max_w):
    ids, d = sharded_rows(q * o + run, q, o, run)
    got = merge_tree(limited(merge, max_w), ids, d, k=k, run=run,
                     max_w=max_w)
    want = ref.merge_topk_ref(ids, d, k=k, run=run)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_merge_tree_refuses_k_over_half_the_limit():
    ids, d = sharded_rows(2, 2, 10, 10)
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        merge_tree(ref.merge_topk_ref, ids, d, k=40, run=10, max_w=64)


def test_ported_lm_configs_have_kernel_head_dims():
    """Every LM config (the port serves them all since slice 14), at full
    width and as its smoke, has an attention shape that the kernel takes,
    so its prefill runs on the card: (hd, hd) for GQA, whisper's encoder
    self-attention and its cross-attention, (kv_lora + rope, kv_lora) for
    MLA (the absorbed form: q_all against the latent cache). A config
    without an attention mixer (mamba2) launches no attention and is
    skipped."""
    ported = []
    for name in all_arch_ids():
        for get in (get_config, get_smoke):
            cfg = get(name)
            if not set(cfg.pattern) & {"attn", "swa", "lattn", "mla"}:
                continue
            ported.append(cfg.name)
            mla = cfg.attn_kind == "mla"
            dk = cfg.kv_lora_rank + cfg.qk_rope_dim if mla else cfg.hd
            dv = cfg.kv_lora_rank if mla else cfg.hd
            assert flash_attn.instantiation(dk, dv) is not None, \
                (cfg.name, dk, dv)
            if get is get_config:
                assert flash_attn.instantiation(dk, dv) == \
                    (flash_attn.MLA_DIMS if mla else (dk, dv)), cfg.name
    assert {"stablelm-12b", "deepseek-v2-lite-16b", "grok-1-314b",
            "deepseek-smoke", "recurrentgemma-9b",
            "recurrentgemma-smoke", "whisper-large-v3", "whisper-smoke",
            "internvl2-1b", "internvl2-smoke"} <= set(ported)
    assert "mamba2-1.3b" not in ported
    # recurrentgemma's 256 runs in its own instantiation, its smoke's 16
    # zero-padded into 64
    assert flash_attn.instantiation(256, 256) == (256, 256)
    assert flash_attn.instantiation(16, 16) == (64, 64)
    assert flash_attn.instantiation(200, 176) == (256, 256)
    # whisper (20 / 20 heads) and internvl2 (14 / 2) at hd 64; their
    # smokes' 16 and 8 zero-padded into 64
    assert get_config("whisper-large-v3").hd == \
        get_config("internvl2-1b").hd == 64
    assert flash_attn.instantiation(8, 8) == (64, 64)
    assert get_config("deepseek-v2-lite-16b").attn_kind == "mla"
