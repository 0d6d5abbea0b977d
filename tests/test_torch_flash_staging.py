"""The K/V bytes the tensor-core attention kernels stage from L2
(``kernels/cost.py`` ``flash_staged_bytes``), held against a count over
blocks that follows the kernels' own index math (``block_item`` in
``kernels/csrc/flash_attn.cu``), and the figures at the serving path's
prefill shapes before and after the split-dv redesign, with the launch's
rule for cluster pairs (``flash_attn.split_design``). No JAX, no card."""

import pytest
import torch

from repro_torch.kernels import cost, flash_attn

TILE = 64


def brute_staged(*, b, sq, sk, hq, hkv, dk, dv, kv_bytes, causal, window,
                 q_offset, kv_valid_len, alias, rows, share):
    """Every block of the launch in blockIdx order, decoded as the kernel
    decodes it (``geometry`` and ``block_item``: per (batch row, KV head)
    the head sets fastest, then the query blocks from the last, the count
    padded to a multiple of the cluster with blocks of no rows), staging
    the tiles some row of it can see; the ``share`` blocks of a cluster
    stage the union of theirs once."""
    g = hq // hkv
    gh = next(x for x in (16, 8, 4, 2, 1) if g % x == 0)
    sets = g // gh
    rows_h = rows // gh
    n_qb = (sq + rows_h - 1) // rows_h
    real = sets * n_qb
    per = -(-real // share) * share
    kv_lim = min(sk, sk if kv_valid_len is None else kv_valid_len)
    spans = {}
    for x in range(b * hkv * per):
        bh, y = divmod(x, per)
        if y >= real:
            continue                    # a pad block: no rows, no tiles
        qb = n_qb - 1 - y // sets
        q0 = qb * rows_h
        lo = q_offset + q0
        hi = q_offset + min(q0 + rows_h, sq) - 1
        end = min(kv_lim, hi + 1) if causal else kv_lim
        first = (max(0, lo - window + 1) if window else 0) // TILE * TILE
        key = (bh, y // share)
        f, e = spans.get(key, (first, end))
        spans[key] = (min(f, first), max(e, end))
    tiles = sum((e - f + TILE - 1) // TILE for f, e in spans.values())
    return tiles * TILE * (dk + (0 if alias else dv)) * kv_bytes


CASES = [  # b, sq, sk, hq, hkv, dk, dv, kv_bytes, causal, window, q_offset,
    #        kv_valid_len, alias
    (2, 300, 300, 16, 1, 576, 512, 2, True, None, 0, None, True),
    (3, 70, 200, 16, 1, 576, 512, 4, True, None, 120, 190, False),
    (1, 257, 400, 16, 1, 256, 256, 2, True, 64, 130, 390, False),
    (2, 150, 200, 16, 4, 256, 256, 4, True, None, 40, 195, False),
    (1, 129, 129, 4, 4, 256, 256, 2, True, 48, 0, None, False),
    (1, 33, 300, 2, 1, 256, 256, 2, False, 80, 250, 290, False),
    (2, 77, 200, 8, 2, 200, 176, 2, True, None, 100, 190, True),
    (1, 300, 300, 8, 1, 576, 512, 2, True, None, 0, None, True),
    (2, 190, 523, 12, 4, 96, 96, 4, True, 128, 333, None, False),
]


@pytest.mark.parametrize("rows,share", [(64, 1), (128, 1), (64, 2),
                                        (128, 3)])
@pytest.mark.parametrize("case", CASES)
def test_staged_bytes_match_a_count_over_blocks(case, rows, share):
    (b, sq, sk, hq, hkv, dk, dv, kv_bytes, causal, window, q_offset, valid,
     alias) = case
    kw = dict(b=b, sq=sq, sk=sk, hq=hq, hkv=hkv, dk=dk, dv=dv,
              kv_bytes=kv_bytes, causal=causal, window=window,
              q_offset=q_offset, kv_valid_len=valid, alias=alias)
    assert cost.flash_staged_bytes(rows=rows, share=share, **kw) == \
        brute_staged(rows=rows, share=share, **kw)


MLA = dict(b=8, sq=2048, sk=2048, hq=16, hkv=1, dk=576, dv=512, kv_bytes=2,
           causal=True, alias=True)
HD256 = dict(b=8, sq=3072, sk=3072, hq=16, hkv=1, dk=256, dv=256,
             kv_bytes=2, causal=True, window=2048)


def _design(dk, dv, alias):
    """``flash_attn.split_design`` on meta tensors of a serving shape
    (contiguous bf16, so aligned)."""
    q = torch.empty((8, 64, 16, dk), dtype=torch.bfloat16, device="meta")
    k = torch.empty((8, 64, 1, dk), dtype=torch.bfloat16, device="meta")
    v = k[..., :dv] if alias else torch.empty(
        (8, 64, 1, dv), dtype=torch.bfloat16, device="meta")
    return flash_attn.split_design(q, k, v)


def test_staged_bytes_at_the_serving_shapes():
    """deepseek-v2-lite-16b's MLA prefill (B 8, S 2,048, 16 heads over the
    latent cache) and recurrentgemma-9b's local attention (B 8, S 3,072,
    16 heads over one, window 2,048). Before the redesign both kernels ran
    64-row blocks: 4,096 blocks of ~16.5 latent tiles (73,728 B each),
    about 5.0 GB, and 6,144 blocks of ~22 K + V tiles (65,536 B), about
    8.9 GB. The split-dv kernel keeps 64-row blocks at MLA's width (O is
    64 x 512) and the wide kernel serves 128 rows a block; both stage each
    tile once for a cluster pair of neighbouring blocks (TMA multicast):
    MLA's bytes halve, hd 256's fall to a quarter."""
    old_mla = cost.flash_staged_bytes(rows=64, **MLA)
    old_256 = cost.flash_staged_bytes(rows=64, **HD256)
    assert old_mla == 4_982_833_152
    assert old_256 == 8_858_370_048
    assert old_mla == brute_staged(rows=64, share=1, window=None,
                                   q_offset=0, kv_valid_len=None, **MLA)
    assert old_256 == brute_staged(rows=64, share=1, q_offset=0,
                                   kv_valid_len=None, alias=False,
                                   **{k: v for k, v in HD256.items()})
    assert _design(576, 512, True) == (64, 2)
    assert _design(256, 256, False) == (128, 2)
    new_mla = cost.flash_staged_bytes(rows=64, share=2, **MLA)
    new_256 = cost.flash_staged_bytes(rows=128, share=2, **HD256)
    assert new_mla == 2_491_416_576 == old_mla // 2
    assert new_256 == 2_214_592_512 == old_256 // 4
    assert new_256 == brute_staged(rows=128, share=2, q_offset=0,
                                   kv_valid_len=None, alias=False,
                                   **{k: v for k, v in HD256.items()})


def test_split_design_follows_the_launch_rule():
    """Cluster pairs only where the tiles come by TMA: bf16 K/V with
    aligned rows as wide as the instantiation; float32 K/V, a head dim
    padded into 256 or rows off 16-byte boundaries stage a tile a block."""
    assert _design(256, 256, True) == (128, 2)
    q = torch.empty((2, 8, 16, 256), dtype=torch.bfloat16, device="meta")
    k32 = torch.empty((2, 8, 1, 256), dtype=torch.float32, device="meta")
    assert flash_attn.split_design(q, k32, k32) == (128, 1)
    kb = torch.empty((2, 8, 1, 200), dtype=torch.bfloat16, device="meta")
    assert flash_attn.split_design(q[..., :200], kb, kb) == (128, 1)
    wide = torch.zeros((2, 8, 1, 584), dtype=torch.bfloat16)
    k_off = wide[..., 4:580]            # rows start 8 bytes off
    assert flash_attn.split_design(
        torch.zeros((2, 8, 16, 576), dtype=torch.bfloat16), k_off,
        k_off[..., :512]) == (64, 1)
    with pytest.raises(ValueError, match="split-dv or the wide"):
        flash_attn.split_design(q[..., :128], kb[..., :128], kb[..., :128])


def test_staged_bytes_do_not_move_the_bound():
    """The bound counts each input byte once, whatever a design stages."""
    work = cost.flash_attention(q_bytes=2, **{k: v for k, v in MLA.items()
                                               if k != "kv_bytes"},
                                kv_bytes=2)
    assert work.bound_by() == "operations"
    assert work.bytes < cost.flash_staged_bytes(rows=64, **MLA) / 8
