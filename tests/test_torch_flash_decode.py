"""The split-KV decode route of the attention kernel, on the CPU.

Float32 q whose query rows that read one KV head fit one block, Sq x (Hq /
Hkv) <= 64, takes ``csrc/flash_decode.cu`` (the decode step over a
sequence-split cache, ``models/attention.py`` ``_seq_split_step``). Here:
``flash_attn.decode_design``'s split (its chunks cover every key some row
sees once, none is empty at the launch, its rule at the shapes
``chip_smoke.py`` runs, nothing of it hangs on the lse) and the route's
edge at 64 rows; and ``ref.flash_decode_ref``, the kernel's split and
combine step by step, against the float32 plain version
``ref.flash_attention_ref`` within ``ref.flash_attention_order_bound`` (its
lse within ``ref.flash_attention_lse_bound``) and against the JAX package's
``attend_onepass`` on the same numpy inputs: Sq 1 to 16, GQA groups 1, 4
and 16, head dims 16, 80 and 256, windows and causal rows that leave whole
chunks empty for some rows, kv_valid_len 1, the softcap. The kernel itself
is held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import flash_attn, ref  # noqa: E402

TILE = flash_attn.DECODE_TILE
# float32 on both sides, sums in other orders: as tests/test_attention.py
# holds its two attends
ATOL = 2e-5


def _visible(sq, sk, causal, window, q_offset, valid):
    """{key: the rows' positions that see it} under the mask."""
    limit = min(sk, sk if valid is None else valid)
    seen = {}
    for p in range(q_offset, q_offset + sq):
        for j in range(limit):
            if (not causal or j <= p) and (window is None or p - j < window):
                seen.setdefault(j, []).append(p)
    return seen


# b, sq, hq, hkv, sk, causal, window, q_offset, kv_valid_len
SPLITS = [
    (8, 1, 32, 8, 2048, False, None, 0, None),      # a decode_32k rank
    (1, 1, 32, 8, 32768, False, None, 0, None),     # one long context
    (8, 1, 32, 8, 2048, False, None, 0, 1500),      # a rolling cache
    (8, 1, 32, 8, 2048, False, 2500, 4000, None),   # a window past the slots
    (4, 1, 32, 8, 130, False, None, 512, 130),      # phase 11s, rank 0
    (1, 16, 64, 16, 1000, True, 1, 990, None),      # one key a row
    (1, 16, 4, 1, 700, True, 40, 594, 610),         # window and valid
    (3, 4, 16, 4, 333, True, None, 329, None),
    (1, 1, 16, 1, 64, False, 40, 70, 64),
    (2, 1, 32, 8, 96, False, None, 0, 1),           # a single key
    (64, 1, 8, 2, 4096, False, None, 0, None),      # items past the target
]


@pytest.mark.parametrize("b,sq,hq,hkv,sk,causal,window,q_off,valid", SPLITS)
def test_decode_chunks_cover_the_visible_keys_once(b, sq, hq, hkv, sk, causal,
                                                   window, q_off, valid):
    """The chunks are whole tiles in order, abutting, and cover every key
    some row sees exactly once; every chunk holds a key some row sees (none
    is empty at the launch), and no more chunks are made than give
    ``DECODE_WARPS`` warps or than there are tiles."""
    kw = dict(causal=causal, window=window, q_offset=q_off,
              kv_valid_len=valid)
    rows, chunks = flash_attn.decode_design(b, sq, hq, hkv, sk, **kw)
    spans = flash_attn.decode_chunks(b, sq, hq, hkv, sk, **kw)
    assert rows == sq * (hq // hkv) and len(spans) == chunks >= 1
    seen = _visible(sq, sk, causal, window, q_off, valid)
    lo, hi = min(seen), max(seen) + 1
    assert spans[0][0] == lo // TILE * TILE and spans[-1][1] >= hi
    assert all(s[1] == t[0] for s, t in zip(spans, spans[1:]))
    assert all(s[0] % TILE == 0 and s[1] > s[0] for s in spans)
    covered = [j for s, e in spans for j in range(s, e) if j in seen]
    assert covered == sorted(seen)
    assert all(any(j in seen for j in range(s, e)) for s, e in spans)
    tiles = -(-hi // TILE) - lo // TILE
    assert chunks <= tiles
    assert chunks <= -(-flash_attn.DECODE_WARPS // (b * hkv))


def test_decode_design_at_the_smoke_shapes():
    """The rule at the shapes ``chip_smoke.py`` runs: a danube decode_32k
    rank (B 8, 8 KV heads, 2,048 slots): 64 items in 16 chunks of 128 keys,
    1,024 warps; B 1 over 32,768 slots: 8 items in 128 chunks of 256 keys;
    phase 11s's rank 0 (B 4, 130 slots): 5 chunks of one tile; phase 20's
    rolling cache (1,500 valid slots) and window (the last 547 slots)."""
    f = flash_attn.decode_design
    assert f(8, 1, 32, 8, 2048, causal=False) == (4, 16)
    assert flash_attn.decode_chunks(8, 1, 32, 8, 2048, causal=False)[1] \
        == (128, 256)
    assert f(1, 1, 32, 8, 32768, causal=False) == (4, 128)
    assert flash_attn.decode_chunks(1, 1, 32, 8, 32768, causal=False)[0] \
        == (0, 256)
    assert f(4, 1, 32, 8, 130, causal=False, q_offset=512,
             kv_valid_len=130) == (4, 5)
    assert f(8, 1, 32, 8, 2048, causal=False, kv_valid_len=1500) == (4, 16)
    assert f(8, 1, 32, 8, 2048, causal=False, window=2500,
             q_offset=4000) == (4, 9)


def test_decode_split_does_not_depend_on_the_lse():
    """``decode_design`` takes no lse argument, and the model of the
    kernel's split gives the same bits with and without it."""
    assert "return_lse" not in inspect.signature(
        flash_attn.decode_design).parameters
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 3, 8, 80), (2, 300, 2, 80), (2, 300, 2, 80)))
    kw = dict(causal=True, q_offset=290, window=100)
    out, lse = ref.flash_decode_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, ref.flash_decode_ref(q, k, v, **kw))
    assert lse.shape == (2, 8, 3)


@pytest.mark.parametrize("sq,hq,hkv,dtype,want", [
    (16, 64, 16, torch.float32, True),      # Sq x g = 64
    (1, 64, 1, torch.float32, True),
    (13, 10, 2, torch.float32, False),      # 65
    (65, 4, 4, torch.float32, False),
    (1, 65, 1, torch.float32, False),
    (1, 32, 8, torch.bfloat16, False),      # bf16 q: the tensor cores
])
def test_decode_route_takes_at_most_64_rows_of_float32_q(sq, hq, hkv, dtype,
                                                          want):
    assert flash_attn.decode_route(dtype, sq, hq, hkv) is want


# b, sq, sk, hq, hkv, d, causal, window, q_offset, kv_valid_len, softcap
MODEL_CASES = [
    (2, 1, 96, 32, 8, 80, False, None, 0, 40, 0.0),
    (2, 1, 300, 4, 1, 16, False, 64, 350, 300, 0.0),
    (1, 1, 64, 16, 1, 256, False, 40, 70, 64, 0.0),
    (1, 16, 700, 4, 1, 80, True, 40, 594, 610, 0.0),   # empty chunks
    (1, 16, 200, 64, 16, 16, True, 1, 150, None, 0.0),  # one key a row
    (3, 4, 333, 16, 4, 80, True, None, 40, None, 0.0),  # causal, empty
    (2, 1, 96, 32, 8, 80, False, None, 0, 1, 0.0),      # kv_valid_len 1
    (1, 8, 520, 16, 2, 256, True, None, 512, None, 30.0),
    (2, 2, 400, 8, 8, 16, False, 100, 420, None, 50.0),
    (1, 1, 2048, 16, 1, 80, False, None, 0, None, 0.0),
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,q_off,valid,cap",
                         MODEL_CASES)
def test_decode_model_matches_plain_and_jax(b, sq, sk, hq, hkv, d, causal,
                                            window, q_off, valid, cap):
    """``ref.flash_decode_ref`` (the kernel's split and combine) against
    the float32 plain version within ``flash_attention_order_bound``, its
    lse within ``flash_attention_lse_bound``, and against the JAX
    package's ``attend_onepass`` on the same inputs within ATOL."""
    rng = np.random.default_rng(sq * 1000 + sk)
    qn = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    kn = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    kw = dict(causal=causal, window=window, q_offset=q_off,
              kv_valid_len=valid, softcap=cap)
    rows, chunks = flash_attn.decode_design(
        b, sq, hq, hkv, sk, **{x: y for x, y in kw.items() if x != "softcap"})
    assert rows <= flash_attn.DECODE_ROWS
    out, lse = ref.flash_decode_ref(q, k, v, return_lse=True, **kw)
    want, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert ((out - want).abs() <= ref.flash_attention_order_bound(want)).all()
    bound = ref.flash_attention_lse_bound(q, k, want_lse, **kw)
    assert ((lse - want_lse).abs() <= bound).all()
    jw = np.asarray(JA.attend_onepass(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal=causal,
        window=window, q_offset=q_off, kv_valid_len=valid, softcap=cap))
    np.testing.assert_allclose(out.numpy(), jw, rtol=0, atol=ATOL)
