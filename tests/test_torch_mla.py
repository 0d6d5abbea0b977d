"""The port's MLA attention (``repro_torch.models.attention.mla_*``) on the
CPU against the JAX package's absorbed ("latent") form: prefill with and
without a cache and decode steps, with the JAX params carried over through
``bridge.lm_params_from_numpy``; the one-tensor latent cache (v a view of
k); bf16 and float32 caches giving the same bits; and the attention's plain
versions at dk != dv (``ref.flash_attention_ref``, its bf16 twin and their
bounds) against JAX's ``attend`` and an einsum oracle. Inputs come from
numpy with a seed.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


def _cfgs(dtype="float32"):
    tc = dataclasses.replace(tconfigs.get_smoke(ARCH), param_dtype=dtype)
    return JConfig(**dataclasses.asdict(tc)), tc


def _pair(dtype="float32", seed=0):
    jc, tc = _cfgs(dtype)
    jp, _ = JA.mla_init(jax.random.PRNGKey(seed), jc)
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _x(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pos(p0, s):
    return (p0 + np.arange(s))[None, :]


def test_mla_init_has_the_jax_tree():
    """The port's own init: the JAX package's tree, 2-D projections,
    shapes and dtypes leaf for leaf; the bridge carries the JAX tree over
    unchanged (the same bits)."""
    jc, jp, tc, tp = _pair("bfloat16")
    mine = TA.mla_init(torch.Generator().manual_seed(0), tc)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, mine))
    for (path, a), b, c in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                               jax.tree.leaves(mine), jax.tree.leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.") == \
            str(c.dtype).removeprefix("torch."), path
        np.testing.assert_array_equal(
            np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
            else np.asarray(a),
            c.view(torch.int16).numpy().view(np.uint16)
            if c.dtype == torch.bfloat16 else c.numpy())
    assert mine["wq"].shape == (tc.d_model, tc.n_heads * (16 + 8))


def test_mla_prefill_without_cache_matches_jax():
    """float32 params, no cache (the full-sequence forward): to 2e-5
    (float32 sums in other orders; the attention runs at dk 40, dv 32)."""
    jc, jp, tc, tp = _pair()
    x = _x(1, (2, 19, tc.d_model))
    want, _ = JA.mla_apply(jp, jnp.asarray(x), jc,
                           positions=jnp.asarray(_pos(0, 19)))
    got, cache = TA.mla_apply(tp, torch.from_numpy(x), tc,
                              positions=torch.from_numpy(_pos(0, 19)))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_mla_prefill_and_decode_with_cache_match_jax():
    """float32 params: a cached prefill of 11 tokens then 4 decode steps
    (the plain one-pass attention), each output to 2e-5 and the latent
    cache (B, Smax, 1, kv_lora + rope) equal to JAX's to 1e-5."""
    jc, jp, tc, tp = _pair(seed=2)
    b, prompt, steps, smax = 3, 11, 4, 16
    xs = _x(2, (b, prompt + steps, tc.d_model))
    jcache = JA.mla_empty_cache(jc, b, smax, jnp.float32)
    tcache = TA.mla_empty_cache(tc, b, smax, torch.float32, device="cpu")
    assert tcache.k.shape == (b, smax, 1, tc.kv_lora_rank + tc.qk_rope_dim)
    pos = 0
    for s in (prompt,) + (1,) * steps:
        x = xs[:, pos:pos + s]
        want, jcache = JA.mla_apply(jp, jnp.asarray(x), jc,
                                    positions=jnp.asarray(_pos(pos, s)),
                                    cache=jcache)
        got, tcache = TA.mla_apply(tp, torch.from_numpy(x), tc,
                                   positions=torch.from_numpy(_pos(pos, s)),
                                   cache=tcache)
        pos += s
        assert tcache.pos == pos == int(jcache.pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5)


def test_mla_cache_is_one_tensor_and_v_a_view(monkeypatch):
    """The cache allocates one tensor, held as both k and v; the prefill
    hands the attention that tensor as k and its first kv_lora columns as
    v (a view of the same storage, row stride kv_lora + rope); a decode
    step does not reach the kernel seam."""
    _, _, tc, tp = _pair()
    cache = TA.mla_empty_cache(tc, 2, 12, torch.float32, device="cpu")
    assert cache.k is cache.v
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: seen.append((q, k, v, kw))
                        or real(q, k, v, **kw))
    x = torch.from_numpy(_x(3, (2, 9, tc.d_model)))
    _, cache = TA.mla_apply(tp, x, tc, positions=torch.arange(9)[None],
                            cache=cache)
    (q, k, v, kw), = seen
    width = tc.kv_lora_rank + tc.qk_rope_dim
    assert q.shape == (2, 9, tc.n_heads, width)
    assert k is cache.k and cache.k is cache.v
    assert v.data_ptr() == k.data_ptr() and v.shape[-1] == tc.kv_lora_rank
    assert v.stride() == k.stride()
    assert kw == dict(causal=True, window=None, q_offset=0, kv_valid_len=9)
    TA.mla_apply(tp, x[:, :1], tc, positions=torch.tensor([[9]]), cache=cache)
    assert len(seen) == 1


def test_bf16_and_f32_caches_give_the_same_bits():
    """bf16 params: the latent written to the cache is already bf16, so a
    float32 cache holds the same values as a bf16 one, and mla_apply gives
    the same bits through a prefill and two decode steps."""
    _, _, tc, tp = _pair("bfloat16", seed=4)
    xs = torch.from_numpy(_x(4, (2, 10, tc.d_model))).bfloat16()
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        cache = TA.mla_empty_cache(tc, 2, 10, dt, device="cpu")
        got = []
        for p0, s in ((0, 8), (8, 1), (9, 1)):
            o, cache = TA.mla_apply(tp, xs[:, p0:p0 + s], tc,
                                    positions=torch.arange(p0, p0 + s)[None],
                                    cache=cache)
            got.append(o)
        outs[dt] = (got, cache.k.float())
    for a, b in zip(outs[torch.bfloat16][0], outs[torch.float32][0]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(outs[torch.bfloat16][1], outs[torch.float32][1])


def _mla_attn_inputs(seed, b, sq, sk, hq, dk, dv):
    q = _x(seed, (b, sq, hq, dk))
    kc = _x(seed + 1, (b, sk, 1, dk))
    return q, kc, kc[..., :dv]


def _einsum_oracle(q, k, v, causal, q_offset, valid):
    """softmax(q k^T / sqrt(dk) + mask) v in float64, one KV head."""
    s = np.einsum("bqhd,bkd->bhqk", q.astype(np.float64),
                  k[:, :, 0].astype(np.float64)) / math.sqrt(q.shape[-1])
    qp = q_offset + np.arange(q.shape[1])[:, None]
    kp = np.arange(k.shape[1])[None, :]
    ok = (kp < valid) & ((kp <= qp) if causal else True)
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkd->bqhd", p, v[:, :, 0].astype(np.float64))


@pytest.mark.parametrize("b,sq,sk,hq,dk,dv,causal,q_off,valid", [
    (2, 19, 19, 4, 40, 32, True, 0, 19),       # the deepseek smoke
    (1, 70, 150, 16, 40, 32, True, 60, 130),   # a cache prefill, 3 tiles
    (1, 9, 70, 16, 576, 512, True, 61, 70),    # deepseek-v2-lite's width
    (2, 5, 80, 16, 576, 512, False, 0, 77),
])
def test_flash_ref_at_dk_ne_dv_matches_jax_attend(b, sq, sk, hq, dk, dv,
                                                  causal, q_off, valid):
    """``ref.flash_attention_ref`` (the plain version of the kernel) at
    dk != dv with v a view of k: to 2e-5 of JAX's ``attend`` and to 2e-5 of
    a float64 einsum oracle (float32 sums in other orders). The bf16 twin
    within ``flash_attention_rounding_bound`` of it, and the flip bound
    of the twin's rows of the right shape."""
    q, kc, v = _mla_attn_inputs(b * 100 + sq, b, sq, sk, hq, dk, dv)
    kw = dict(causal=causal, q_offset=q_off, kv_valid_len=valid)
    tq, tk = torch.from_numpy(q), torch.from_numpy(kc)
    tv = tk[..., :dv]
    got = ref.flash_attention_ref(tq, tk, tv, **kw)
    assert got.shape == (b, sq, hq, dv)
    want = JA.attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(),
                               _einsum_oracle(q, kc, v, causal, q_off, valid),
                               atol=2e-5)
    qb = tq.bfloat16()
    kb = tk.bfloat16().float()           # a cache of bf16-exact values
    twin = ref.flash_attention_ref(qb, kb, kb[..., :dv],
                                   operands=torch.bfloat16, **kw)
    plain = ref.flash_attention_ref(qb, kb, kb[..., :dv], **kw)
    bound = ref.flash_attention_rounding_bound(qb, kb, kb[..., :dv], **kw)
    assert bound.shape == plain.shape == twin.shape == (b, sq, hq, dv)
    assert ((twin.double() - plain.double()).abs() <= bound).all()
    flip = ref.flash_attention_flip_bound(qb, kb, kb[..., :dv], **kw)
    assert flip.shape == (b, sq, hq, 1) and (flip > 0).all()
