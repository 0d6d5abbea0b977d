"""The tensor-core attention kernel's numerics, held on the CPU.

The bf16-q kernel of ``csrc/flash_attn.cu`` rounds q, K, V and the softmax
weights P to bf16 and sums in float32. Its plain twin,
``ref.flash_attention_ref(..., operands=torch.bfloat16)``, rounds at the
same places; ``ref.flash_attention_rounding_bound`` bounds how far the twin
may sit from the float32 plain version. Here, with inputs from numpy seeds:
the twin within that bound of the float32 plain version and of the JAX
package's ``attend`` on the CPU; the bound's q/K/V term zero on bf16-exact
inputs, where a float32 cache and a bf16 one give the twin bitwise the same
result; and three faults planted in a copy of the twin, each of which the
bound catches. The kernel itself is held against the twin on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF16 = torch.bfloat16


def _qkv(seed, b, sq, sk, hq, hkv, d, exact=False):
    """q in bf16 (the serving path's type); K and V in float32, bf16-exact
    when ``exact`` (what the serving path's float32 cache holds)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, sq, hq, d),
                                             dtype=np.float32)).to(BF16)
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, hkv, d),
                                                 dtype=np.float32))
            for _ in range(2))
    if exact:
        k, v = k.to(BF16).float(), v.to(BF16).float()
    return q, k, v


# phase 3's shapes cut to a few hundred rows: groups 1 and 4, every head dim
# the kernel takes, a window, q_offset and kv_valid_len
CASES = [  # b, sq, sk, hq, hkv, d, causal, window, q_offset, kv_valid_len
    (2, 300, 300, 4, 4, 64, True, None, 0, None),
    (2, 257, 330, 8, 2, 80, True, None, 0, 300),
    (1, 190, 523, 8, 2, 96, True, 128, 333, None),
    (1, 129, 400, 8, 2, 80, True, 70, 250, 380),
    (1, 77, 200, 4, 1, 128, False, None, 0, 150),
    (1, 100, 300, 8, 2, 128, True, 37, 200, None),
    (3, 1, 65, 4, 1, 64, True, None, 64, None),
    # hd 256 (recurrentgemma-9b): 16 query heads over one KV head, a window
    # that bites
    (1, 150, 200, 16, 1, 256, True, 64, 40, 195),
]


def _kw(causal, window, q_off, valid):
    return dict(causal=causal, window=window, q_offset=q_off,
                kv_valid_len=valid)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,q_off,valid", CASES)
def test_twin_within_rounding_bound_of_float32_plain(b, sq, sk, hq, hkv, d,
                                                     causal, window, q_off,
                                                     valid, exact):
    q, k, v = _qkv(sq + sk + d, b, sq, sk, hq, hkv, d, exact)
    kw = _kw(causal, window, q_off, valid)
    twin = ref.flash_attention_ref(q, k, v, operands=BF16, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    bound = ref.flash_attention_rounding_bound(q, k, v, **kw)
    assert twin.dtype == BF16 and twin.shape == (b, sq, hq, d)
    assert ((twin.double() - plain.double()).abs() <= bound).all()


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,q_off,valid",
                         CASES[1:4])
def test_bf16_exact_inputs_round_only_p(b, sq, sk, hq, hkv, d, causal,
                                        window, q_off, valid):
    """On bf16-exact K/V (q is bf16) the bound is P's term and the order
    term alone, and the twin gives bitwise the same output from K/V kept in
    float32 as from the same K/V kept in bf16: the float32 cache loses
    nothing and only P is rounded."""
    q, k, v = _qkv(7 * sq + d, b, sq, sk, hq, hkv, d, exact=True)
    kw = _kw(causal, window, q_off, valid)
    a = ref.flash_attention_ref(q.float(), k, v.abs(), **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    expected = 2.0 ** -8 * a + ref.flash_attention_order_bound(want)
    assert torch.equal(ref.flash_attention_rounding_bound(q, k, v, **kw),
                       expected)
    assert torch.equal(
        ref.flash_attention_ref(q, k, v, operands=BF16, **kw),
        ref.flash_attention_ref(q, k.to(BF16), v.to(BF16), operands=BF16,
                                **kw))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,q_off,valid", [
    CASES[0], CASES[1], CASES[3], CASES[7],
])
def test_twin_within_rounding_bound_of_jax_attend(b, sq, sk, hq, hkv, d,
                                                  causal, window, q_off,
                                                  valid):
    """The JAX package's attend runs in float32 on the CPU; the twin stays
    within the same bound of it as of the port's float32 plain version."""
    q, k, v = _qkv(3 * sq + sk, b, sq, sk, hq, hkv, d, exact=True)
    kw = _kw(causal, window, q_off, valid)
    twin = ref.flash_attention_ref(q, k, v, operands=BF16, **kw)
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    got = JA.attend(jq, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                    kv_block=64, **kw)
    jax_out = torch.from_numpy(np.asarray(got, np.float32))
    bound = ref.flash_attention_rounding_bound(q, k, v, **kw)
    assert ((twin.double() - jax_out.double()).abs() <= bound).all()


# the MLA shapes, dk != dv with v the first dv columns of k's rows (the
# latent cache): the deepseek smoke's (40, 32) and deepseek-v2-lite's
# (576, 512) at g 16, one KV head
MLA_CASES = [  # b, sq, sk, hq, dk, dv, causal, q_offset, kv_valid_len
    (2, 150, 150, 4, 40, 32, True, 0, None),
    (1, 70, 200, 16, 40, 32, True, 120, 190),
    (1, 40, 130, 16, 576, 512, True, 90, None),
    (2, 20, 100, 16, 576, 512, False, 0, 77),
]


def _mla_qkv(seed, b, sq, sk, hq, dk, dv, exact):
    """q bf16; a latent cache (B, Sk, 1, dk) in float32 (bf16-exact when
    ``exact``) and v its view [..., :dv]."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, sq, hq, dk),
                                             dtype=np.float32)).to(BF16)
    kc = torch.from_numpy(rng.standard_normal((b, sk, 1, dk),
                                              dtype=np.float32))
    if exact:
        kc = kc.to(BF16).float()
    return q, kc, kc[..., :dv]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("b,sq,sk,hq,dk,dv,causal,q_off,valid", MLA_CASES)
def test_twin_within_rounding_bound_at_dk_ne_dv(b, sq, sk, hq, dk, dv,
                                                causal, q_off, valid, exact):
    """The bound at dk != dv: scores over dk columns, the output and its
    bound over dv; the twin within it of the float32 plain version, and on
    bf16-exact inputs the bound is P's term and the order term alone."""
    q, k, v = _mla_qkv(sq + dk, b, sq, sk, hq, dk, dv, exact)
    kw = dict(causal=causal, q_offset=q_off, kv_valid_len=valid)
    twin = ref.flash_attention_ref(q, k, v, operands=BF16, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    bound = ref.flash_attention_rounding_bound(q, k, v, **kw)
    assert twin.shape == plain.shape == bound.shape == (b, sq, hq, dv)
    assert ((twin.double() - plain.double()).abs() <= bound).all()
    if exact:
        a = ref.flash_attention_ref(q.float(), k, v.abs(), **kw)
        assert torch.equal(bound, 2.0 ** -8 * a
                           + ref.flash_attention_order_bound(plain))
        assert torch.equal(twin, ref.flash_attention_ref(
            q, k.to(BF16), k.to(BF16)[..., :dv], operands=BF16, **kw))
    flip = ref.flash_attention_flip_bound(q, k, v, **kw)
    assert flip.shape == (b, sq, hq, 1) and (flip > 0).all()


@pytest.mark.parametrize("b,sq,sk,hq,dk,dv,causal,q_off,valid",
                         MLA_CASES[1:3])
def test_twin_within_rounding_bound_of_jax_attend_at_dk_ne_dv(
        b, sq, sk, hq, dk, dv, causal, q_off, valid):
    """JAX's attend at the MLA shapes (as mla_apply calls it: the cache and
    its first kv_lora columns) in float32 on the CPU, within the bound of
    the twin."""
    q, k, v = _mla_qkv(3 * sq + dk, b, sq, sk, hq, dk, dv, exact=True)
    kw = dict(causal=causal, q_offset=q_off, kv_valid_len=valid)
    twin = ref.flash_attention_ref(q, k, v, operands=BF16, **kw)
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    jk = jnp.asarray(k.numpy())
    got = JA.attend(jq, jk, jk[..., :dv], **kw)
    jax_out = torch.from_numpy(np.asarray(got, np.float32))
    bound = ref.flash_attention_rounding_bound(q, k, v, **kw)
    assert ((twin.double() - jax_out.double()).abs() <= bound).all()


def _twin_copy(q, k, v, fault=None, block=128):
    """A copy of the twin (causal, no window, every key valid) with one of
    three faults a blockwise kernel can make: "last_tile" (every query
    block after the first skips the last KV tile it can see), "first_tile"
    (rows past 512 skip the first tile), "no_rescale" (O and l are not
    rescaled at tiles from key 1024 on)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.to(BF16).float().reshape(b, sq, hkv, g, d)
    k, v = k.to(BF16), v.to(BF16)
    scale = torch.tensor(ref.LOG2E / math.sqrt(d), dtype=torch.float32)
    rows = torch.arange(sq)
    last_key = torch.minimum((rows // block + 1) * block, torch.tensor(sq)) - 1
    m = torch.full((b, hkv, g, sq), ref.NEG_INF)
    l = torch.zeros((b, hkv, g, sq))
    acc = torch.zeros((b, hkv, g, sq, d))
    for j0 in range(0, sk, ref.FLASH_TILE):
        kj = k[:, j0:j0 + ref.FLASH_TILE].float()
        vj = v[:, j0:j0 + ref.FLASH_TILE].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kj)
        kv_pos = j0 + torch.arange(kj.shape[1])
        ok = kv_pos[None, :] <= rows[:, None]
        if fault == "last_tile":
            ok = ok & ~((rows >= block)
                        & (last_key // ref.FLASH_TILE
                           == j0 // ref.FLASH_TILE))[:, None]
        if fault == "first_tile" and j0 == 0:
            ok = ok & (rows < 512)[:, None]
        s = torch.where(ok, s * scale, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        if fault == "no_rescale" and j0 >= 1024:
            corr = torch.ones_like(corr)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(BF16).float(), vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


@pytest.fixture(scope="module")
def long_causal():
    """1,100 causal rows (17 KV tiles), danube's head dim, bf16-exact K/V,
    with the twin, the float32 plain version and the bound."""
    q, k, v = _qkv(1100, 1, 1100, 1100, 4, 1, 80, exact=True)
    kw = dict(causal=True)
    return (q, k, v, ref.flash_attention_ref(q, k, v, **kw),
            ref.flash_attention_rounding_bound(q, k, v, **kw))


def test_twin_copy_is_the_twin(long_causal):
    q, k, v, _, _ = long_causal
    assert torch.equal(_twin_copy(q, k, v),
                       ref.flash_attention_ref(q, k, v, causal=True,
                                               operands=BF16))


@pytest.mark.parametrize("fault", ["last_tile", "first_tile", "no_rescale"])
def test_bound_catches_planted_faults(long_causal, fault):
    q, k, v, plain, bound = long_causal
    bad = _twin_copy(q, k, v, fault)
    over = (bad.double() - plain.double()).abs() > bound
    assert over.any(), f"the bound misses the planted fault {fault}"
