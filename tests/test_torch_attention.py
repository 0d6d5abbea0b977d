"""The port's attention on the CPU against the JAX package's.

``attend`` (the flash_attention seam, whose CPU route is the plain version
``flash_attention_ref``) is held against ``repro.models.attention.attend``
and ``attend_ref`` over tests/test_attention.py's sweep plus window,
q_offset and kv_valid_len cases; the TPU kernel's (BH, S, d) signature
against tests/test_flash_kernel.py's einsum oracle on its five cases (the
Pallas kernel itself no longer runs on the installed jax, so the oracle is
copied here); and the GQA block's rolling-window cache against the full
cache and against the JAX block with the same params. Inputs come from
numpy with a seed.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attn, ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

# float32 on both sides; the sums run in another order (the JAX scan's
# blocks of 16 keys, the port's tiles of 64), as in test_attention.py
ATOL = 2e-5


def _qkv(seed, b, sq, sk, hq, hkv, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dk)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dk)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dv)).astype(np.float32))


@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,dk,dv,causal,win,q_off,valid", [
        # tests/test_attention.py's sweep
        (2, 33, 33, 4, 2, 16, 16, True, None, 0, None),
        (2, 64, 64, 4, 4, 8, 8, True, 24, 0, None),
        (1, 17, 40, 6, 2, 8, 12, False, None, 0, None),
        (2, 128, 128, 2, 1, 32, 32, True, 32, 0, None),
        # q_offset, kv_valid_len and windows, as the cache paths use them
        (2, 20, 50, 4, 2, 16, 16, True, None, 30, None),
        (1, 24, 64, 4, 1, 8, 8, True, 16, 10, 40),
        (2, 9, 40, 2, 2, 8, 8, False, None, 0, 25),
        (1, 33, 100, 6, 3, 16, 16, True, 20, 60, 93),
        (2, 70, 130, 8, 2, 80, 80, True, 50, 60, 130),
        # recurrentgemma-9b's local attention: hd 256, 16 query heads over
        # one KV head, a window that bites
        (1, 70, 150, 16, 1, 256, 256, True, 48, 70, 140),
    ])
def test_attend_matches_jax(b, sq, sk, hq, hkv, dk, dv, causal, win, q_off,
                            valid):
    q, k, v = _qkv(sq * 7 + sk, b, sq, sk, hq, hkv, dk, dv)
    kw = dict(causal=causal, window=win, q_offset=q_off, kv_valid_len=valid)
    got = TA.attend(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), **kw).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        got, np.asarray(JA.attend(jq, jk, jv, kv_block=16, **kw)), atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(JA.attend_ref(jq, jk, jv, **kw)), atol=ATOL)
    ref_t = TA.attend_ref(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(ref_t, got, atol=ATOL)


def test_attend_bf16_keeps_q_dtype():
    """bf16 q over float32 K/V (the serving path's types): the output is
    bf16 and equals the JAX attend's on the same bf16 values to one bf16
    rounding (2^-8 of |out| < 4)."""
    q, k, v = _qkv(5, 2, 40, 40, 4, 2, 16, 16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = TA.attend(tq, torch.from_numpy(k), torch.from_numpy(v),
                    causal=True, window=24)
    assert got.dtype == torch.bfloat16
    want = JA.attend(jnp.asarray(tq.float().numpy()).astype(jnp.bfloat16),
                     jnp.asarray(k), jnp.asarray(v), causal=True, window=24,
                     kv_block=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1.6e-2)


def _oracle(q, k, v, causal, q_offset=0):
    """tests/test_flash_kernel.py's einsum oracle, copied."""
    s = jnp.einsum("bqd,bkd->bqk", q.astype(jnp.float32),
                   k.astype(jnp.float32)) / math.sqrt(q.shape[-1])
    if causal:
        qp = q_offset + jnp.arange(q.shape[1])[:, None]
        kp = jnp.arange(k.shape[1])[None, :]
        s = jnp.where(kp <= qp, s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bqk,bkd->bqd", p, v.astype(jnp.float32))


@pytest.mark.parametrize("bh,sq,sk,dk,dv,causal,dtype", [
    (2, 64, 64, 32, 32, True, "float32"),
    (3, 128, 128, 64, 64, True, "float32"),
    (1, 32, 96, 16, 24, False, "float32"),
    (2, 64, 64, 32, 32, True, "bfloat16"),
])
def test_flash_fwd_view_matches_oracle(bh, sq, sk, dk, dv, causal, dtype):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _qkv(bh + sq, bh, sq, sk, 1, 1, dk, dv))
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    out = flash_attn.flash_attention_fwd(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == (bh, sq, dv)
    want = _oracle(*(jnp.asarray(t.float().numpy()).astype(dtype)
                     for t in (q, k, v)), causal)
    atol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=atol)


def test_flash_fwd_view_q_offset_decode_chunk():
    """Chunked prefill: second half with q_offset equals the full pass."""
    q, k, v = (torch.from_numpy(a)[:, :, 0]
               for a in _qkv(1, 1, 64, 64, 1, 1, 16, 16))
    full = flash_attn.flash_attention_fwd(q, k, v, causal=True)
    part = flash_attn.flash_attention_fwd(q[:, 32:], k, v, causal=True,
                                          q_offset=32)
    np.testing.assert_allclose(part.numpy(), full[:, 32:].numpy(), atol=ATOL)
    np.testing.assert_allclose(
        part.numpy(), np.asarray(_oracle(*(jnp.asarray(t.numpy()) for t in (
            q[:, 32:], k, v)), True, q_offset=32)), atol=ATOL)


def test_attention_refuses_rows_without_keys():
    """The checks the kernel's wrapper makes run on the CPU route too."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 16, 32, 4, 2, 8, 8))
    with pytest.raises(ValueError, match="need their own key"):
        ops.flash_attention(q, k, v, causal=True, q_offset=20)
    with pytest.raises(ValueError, match="need their own key"):
        ops.flash_attention(q, k, v, causal=True, kv_valid_len=8)
    with pytest.raises(ValueError, match=r"outside \[1"):
        ops.flash_attention(q, k, v, causal=False, kv_valid_len=33)
    with pytest.raises(ValueError, match="no valid key"):
        ops.flash_attention(q, k, v, causal=False, window=4, q_offset=40)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        ops.flash_attention(q[:, :, :3], k, v, causal=True)


def _mini_cfgs(window=None):
    kw = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=64, window=window,
              rope_theta=100.0, param_dtype="float32")
    return JConfig(**kw), TConfig(**kw)


def test_rolling_window_cache_equals_full_cache():
    """Decoding with a rolling `window`-slot cache == full-length cache
    (tests/test_attention.py:57), and both equal the JAX block's steps on
    the same params."""
    jcfg, tcfg = _mini_cfgs(window=8)
    jp, _ = JA.gqa_init(jax.random.PRNGKey(2), jcfg)
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    steps = 24
    xs = (np.random.default_rng(2).standard_normal((1, steps, 32)) * 0.5
          ).astype(np.float32)
    full = TA.gqa_empty_cache(tcfg, 1, steps, torch.float32, device="cpu")
    roll = TA.gqa_empty_cache(tcfg, 1, 8, torch.float32, device="cpu")
    jroll = JA.KVCache(jnp.zeros((1, 8, 2, 8)), jnp.zeros((1, 8, 2, 8)),
                       jnp.zeros((), jnp.int32))
    outs_f, outs_r, outs_j = [], [], []
    for t in range(steps):
        pos = torch.tensor([[t]])
        x = torch.from_numpy(xs[:, t:t + 1])
        o_f, full = TA.gqa_apply(tp, x, tcfg, positions=pos, cache=full,
                                 window=8)
        o_r, roll = TA.gqa_apply(tp, x, tcfg, positions=pos, cache=roll,
                                 window=8)
        o_j, jroll = JA.gqa_apply(jp, jnp.asarray(xs[:, t:t + 1]), jcfg,
                                  positions=jnp.array([[t]]), cache=jroll,
                                  window=8)
        outs_f.append(o_f.numpy())
        outs_r.append(o_r.numpy())
        outs_j.append(np.asarray(o_j))
    assert roll.pos == full.pos == steps and isinstance(roll.pos, int)
    np.testing.assert_allclose(np.concatenate(outs_r, 1),
                               np.concatenate(outs_f, 1), atol=1e-5)
    np.testing.assert_allclose(np.concatenate(outs_r, 1),
                               np.concatenate(outs_j, 1), atol=1e-5)


def test_rolling_prefill_then_decode_matches_jax():
    """A prefill longer than the window stashes its tail in the rolling
    cache (the multi-token branch), then decodes from it."""
    jcfg, tcfg = _mini_cfgs(window=8)
    jp, _ = JA.gqa_init(jax.random.PRNGKey(4), jcfg)
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    xs = (np.random.default_rng(4).standard_normal((2, 15, 32)) * 0.5
          ).astype(np.float32)
    roll = TA.gqa_empty_cache(tcfg, 2, 8, torch.float32, device="cpu")
    jroll = JA.gqa_empty_cache(jcfg, 2, 8, jnp.float32)
    pos = np.arange(12)[None]
    o_t, roll = TA.gqa_apply(tp, torch.from_numpy(xs[:, :12]), tcfg,
                             positions=torch.from_numpy(pos), cache=roll,
                             window=8)
    o_j, jroll = JA.gqa_apply(jp, jnp.asarray(xs[:, :12]), jcfg,
                              positions=jnp.asarray(pos), cache=jroll,
                              window=8)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(roll.k.numpy(), np.asarray(jroll.k),
                               atol=1e-6)
    for t in range(12, 15):
        o_t, roll = TA.gqa_apply(tp, torch.from_numpy(xs[:, t:t + 1]), tcfg,
                                 positions=torch.tensor([[t]]), cache=roll,
                                 window=8)
        o_j, jroll = JA.gqa_apply(jp, jnp.asarray(xs[:, t:t + 1]), jcfg,
                                  positions=jnp.array([[t]]), cache=jroll,
                                  window=8)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


def test_unported_attention_raises():
    """Nothing of the attention is left unported: the softcap runs
    (tests/test_torch_softcap.py holds it against the JAX package), as MLA
    does (tests/test_torch_mla.py) and cross-attention does
    (test_cross_attention_matches_jax). What is still refused is a cap
    that is no cap: negative, infinite or NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 2, 2, 8, 8))
    out = TA.attend(q, k, v, causal=True, softcap=5.0)
    want = JA.attend(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                     jnp.asarray(v.numpy()), causal=True, softcap=5.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="softcap"):
        TA.attend(q, k, v, causal=True, softcap=-5.0)


@pytest.mark.parametrize("sq,f", [(4, 70), (1, 70), (9, 5)])
def test_cross_attention_matches_jax(sq, f):
    """gqa_apply with kv_override (the enc-dec decoder's cross-attention)
    on the GQA block of group 2, against the JAX block with the same
    params: q alone projected (no RoPE, though the config sets a theta),
    every one of the F encoder keys attended without the causal mask, at
    Sq > 1 (a prefill), Sq = 1 (a decode step) and Sq > F; the cache
    passed through untouched."""
    jcfg, tcfg = _mini_cfgs()
    jp, _ = JA.gqa_init(jax.random.PRNGKey(5), jcfg)
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(sq * 100 + f)
    x = rng.standard_normal((2, sq, 32)).astype(np.float32)
    k = rng.standard_normal((2, f, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, f, 2, 8)).astype(np.float32)
    pos = 30 + np.arange(sq)[None]
    cache = TA.gqa_empty_cache(tcfg, 2, 8, torch.float32, device="cpu")
    got, out = TA.gqa_apply(tp, torch.from_numpy(x), tcfg,
                            positions=torch.from_numpy(pos), cache=cache,
                            kv_override=(torch.from_numpy(k),
                                         torch.from_numpy(v)))
    want, _ = JA.gqa_apply(jp, jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos),
                           kv_override=(jnp.asarray(k), jnp.asarray(v)))
    assert out is cache and not cache.k.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# the training path: the logsumexp output and the backward
# ---------------------------------------------------------------------------

# float32 on both sides, sums in other orders (the JAX scan's blocks of 512
# keys and 16 / 64 in the forward); the gradients are sums of up to Sk
# products of O(1) terms: 1e-5 of each tensor's largest |gradient|
GRAD_RTOL = 1e-5


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dk,dv,causal,win,q_off,valid,alias", [
    (2, 33, 33, 4, 2, 16, 16, True, None, 0, None, False),   # causal, GQA
    (2, 64, 64, 4, 4, 8, 8, True, 24, 0, None, False),       # a window
    (1, 17, 40, 6, 2, 8, 12, False, None, 0, None, False),   # not causal
    (2, 20, 50, 4, 2, 16, 16, True, None, 30, None, False),  # q_offset
    (1, 24, 64, 4, 1, 8, 8, True, 16, 10, 40, False),        # cache prefill
    (2, 21, 21, 8, 1, 24, 16, True, None, 0, None, True),    # MLA's v = k
    (1, 12, 600, 4, 2, 8, 8, False, 500, 590, None, False),  # Sk > 512
])
def test_attend_gradients_match_jax_vjp(b, sq, sk, hq, hkv, dk, dv, causal,
                                        win, q_off, valid, alias):
    """(dq, dk, dv) of the port's ``attend`` (the plain forward with its
    logsumexp, then ``ref.flash_attention_bwd_ref``) against ``jax.vjp`` of
    the JAX package's ``attend`` (its custom VJP), float32. MLA's form
    passes v as a view of k: both gradients reach the one tensor. Sk = 600
    is not a multiple of the backward's blocks of 512."""
    q, k, v = _qkv(sq * 100 + sk, b, sq, sk, hq, hkv, dk, dv)
    go = np.random.default_rng(7).standard_normal(
        (b, sq, hq, dv)).astype(np.float32)
    kw = dict(causal=causal, window=win, q_offset=q_off, kv_valid_len=valid)

    def jfn(jq, jk, jv):
        return JA.attend(jq, jk, jk[..., :dv] if alias else jv, **kw)
    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(go))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TA.attend(tq, tk, tk[..., :dv] if alias else tv, **kw)
    leaves = (tq, tk) if alias else (tq, tk, tv)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(go))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


@pytest.mark.parametrize("causal,win,q_off,valid", [
    (True, None, 0, None), (True, 12, 8, 40), (False, None, 0, 30)])
def test_plain_lse_matches_jax_flash_fwd(causal, win, q_off, valid):
    """``flash_attention_ref(..., return_lse=True)``'s lse against the
    residual lse of the JAX package's ``_flash_fwd`` (m + log(max(l,
    1e-30)), natural log), float32; the output is the call without lse."""
    b, sq, sk, hq, hkv, d = 2, 24, 48, 4, 2, 16
    q, k, v = _qkv(5, b, sq, sk, hq, hkv, d, d)
    vl = sk if valid is None else valid
    _, jlse = JA._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.int32(q_off), jnp.int32(vl), causal, win,
                            16, 0.0)
    want = np.asarray(jlse).reshape(b, hq, sq)       # (b, hkv, g, sq)
    kw = dict(causal=causal, window=win, q_offset=q_off, kv_valid_len=valid)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ops.flash_attention(tq, tk, tv, return_lse=True, **kw)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=2e-5)
    assert torch.equal(out, ops.flash_attention(tq, tk, tv, **kw))


def test_attend_backward_gradcheck_float64():
    """``torch.autograd.gradcheck`` of the autograd Function (the plain
    forward and backward run in float64 for float64 inputs) at a tiny
    shape: causal with GQA, a window, and without the causal mask."""
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    q, k, v = t(1, 6, 4, 4), t(1, 6, 2, 4), t(1, 6, 2, 3)
    for kw in (dict(causal=True), dict(causal=True, window=2, q_offset=0),
               dict(causal=False, kv_valid_len=5)):
        assert torch.autograd.gradcheck(
            lambda a, b_, c: TA.attend(a, b_, c, **kw), (q, k, v))


def test_serving_attend_takes_no_lse():
    """Without gradients ``attend`` is the bare seam call (the serving
    path: no lse written); with them the autograd Function, whose forward
    is the same output."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 10, 10, 2, 1, 8, 8))
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)
    ops.flash_attention = spy
    try:
        plain = TA.attend(q, k, v, causal=True)
        diff = TA.attend(q.requires_grad_(), k, v, causal=True)
    finally:
        ops.flash_attention = real
    assert calls == [False, True]
    assert torch.equal(plain, diff.detach()) and diff.requires_grad


def test_flash_backward_bound_catches_planted_faults():
    """``ref.flash_attention_bwd_bound`` (the phase-19 rule of the smoke)
    holds the plain backward from a bf16 forward against autograd through
    the float32 one-pass attention, and catches a delta taken from an
    output off by 1% and an lse off by 1e-3."""
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return (torch.randn(shape, generator=gen) * 1.5).bfloat16()
    q, k, v, go = r(2, 64, 8, 16), r(2, 64, 2, 16), r(2, 64, 2, 16), \
        r(2, 64, 8, 16)
    kw = dict(causal=True)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(TA.attend_onepass(*f32, **kw), f32,
                               go.float())
    bound = ref.flash_attention_bwd_bound(q, k, v, out, lse, go, **kw)

    def worst(o, l):
        got = ref.flash_attention_bwd_ref(q, k, v, o, l, go, **kw)
        return max(float(((a.double() - w.double()).abs() / b).max())
                   for a, w, b in zip(got, want, bound))
    assert worst(out, lse) <= 1.0
    assert worst(out * 1.01, lse) > 1.0
    assert worst(out, lse + 1e-3) > 1.0
