"""The attention softcap of the port on the CPU against the JAX package's.

``attend(..., softcap=c)`` caps each scaled score at c tanh(s / c) before
the mask, forward and backward, on every route of the kernel seam. Here,
with inputs from numpy seeds: the port's ``attend`` and its gradients
against the JAX package's ``attend`` and ``jax.grad`` (tests/
test_attention.py's ``test_softcap_forward_and_grad`` on the port); each
route's plain version (float32, the tensor-core twin in bf16, the MLA pair
(576, 512), hd 256 with a window, non-causal, q_offset / kv_valid_len)
against the JAX package's ``_flash_fwd`` with its lse, and its backward
against ``_flash_bwd_rule``; the twin within
``ref.flash_attention_rounding_bound`` and its lse within
``ref.flash_attention_lse_bound`` of the float32 plain version; the
backward within ``ref.flash_attention_bwd_bound``, which catches a cap
left out of the backward. The kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

BF16 = torch.bfloat16
# float32 on both sides, sums in other orders (the JAX scan's blocks, the
# port's tiles of 64): as tests/test_attention.py holds its two attends
ATOL = 2e-5
# gradients: relative to the largest |gradient|, as test_torch_attention.py
GRAD_RTOL = 1e-5


def _qkv(seed, b, sq, sk, hq, hkv, dk, dv, kscale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dk)).astype(np.float32),
            (rng.standard_normal((b, sk, hkv, dk)) * kscale
             ).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dv)).astype(np.float32))


def test_softcap_attend_and_grad_match_jax():
    """tests/test_attention.py:36 on the port: q (1, 8, 2, 8), K scaled by
    3 so that the cap bites, cap 5, causal; the port's attend and dq of its
    sum against the JAX package's attend (kv_block 4) and attend_ref, and
    jax.grad of the same sum; dk and dv against jax.vjp too."""
    q, k, v = _qkv(1, 1, 8, 8, 2, 2, 8, 8, kscale=3.0)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kw = dict(causal=True, softcap=5.0)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TA.attend(tq, tk, tv, **kw)
    want = np.asarray(JA.attend(jq, jk, jv, kv_block=4, **kw))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(JA.attend_ref(jq, jk, jv, **kw)),
        atol=ATOL)
    # the cap changes the result: without it the output moves by far more
    plain = JA.attend(jq, jk, jv, causal=True, kv_block=4)
    assert np.abs(np.asarray(plain) - want).max() > 1e-2
    got = torch.autograd.grad(out.sum(), (tq, tk, tv))
    want_g = jax.grad(lambda a, b_, c: JA.attend(
        a, b_, c, kv_block=4, **kw).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    ref_g = jax.grad(lambda a: JA.attend_ref(a, jk, jv, **kw).sum())(jq)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref_g), atol=2e-4)
    for a, w in zip(got, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


# every route's shapes, cut small: b, sq, sk, hq, hkv, dk, dv, causal,
# window, q_offset, kv_valid_len
ROUTES = {
    "gqa_causal": (2, 70, 70, 8, 2, 16, 16, True, None, 0, None),
    "hd80_noncausal": (1, 40, 90, 4, 1, 80, 80, False, None, 0, 75),
    "offset_valid": (1, 24, 64, 4, 1, 8, 8, True, 16, 10, 40),
    "mla_576_512": (1, 20, 70, 4, 1, 576, 512, True, None, 0, None),
    "hd256_window": (1, 70, 150, 16, 1, 256, 256, True, 48, 70, 140),
}


def _jax_fwd(q, k, v, causal, win, q_off, valid, cap):
    """The JAX package's ``_flash_fwd`` at kv_block 16 (Sk padded to a
    whole block, as ``attend`` pads it): out (B, Sq, Hq, dv), lse (B, Hq,
    Sq)."""
    b, sq, hq, _ = q.shape
    sk = k.shape[1]
    pad = (-sk) % 16
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vl = sk if valid is None else valid
    out, lse = JA._flash_fwd(jnp.asarray(q), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.int32(q_off),
                             jnp.int32(vl), causal, win, 16, cap)
    out = np.moveaxis(np.asarray(out), 3, 1).reshape(b, sq, hq, -1)
    return out, np.asarray(lse).reshape(b, hq, sq), (kp, vp, vl)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plain_softcap_forward_matches_jax_flash_fwd(route):
    """The float32 plain version's output and lse at cap 2 against the JAX
    package's ``_flash_fwd`` (float32 both); the bf16 twin (the tensor-core
    kernels' rounding) within ``flash_attention_rounding_bound`` of the
    float32 plain version and its lse within ``flash_attention_lse_bound``
    of the JAX lse."""
    b, sq, sk, hq, hkv, dk, dv, causal, win, q_off, valid = ROUTES[route]
    q, k, v = _qkv(sq * 3 + dk, b, sq, sk, hq, hkv, dk, dv, kscale=2.0)
    cap = 2.0
    want, want_lse, _ = _jax_fwd(q, k, v, causal, win, q_off, valid, cap)
    kw = dict(causal=causal, window=win, q_offset=q_off, kv_valid_len=valid,
              softcap=cap)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ops.flash_attention(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=ATOL)
    qb = tq.to(BF16)
    twin, tlse = ref.flash_attention_ref(qb, tk, tv, operands=BF16,
                                         return_lse=True, **kw)
    bound = ref.flash_attention_rounding_bound(qb, tk, tv, **kw)
    want32 = ref.flash_attention_ref(qb.float(), tk, tv, **kw)
    assert bool(((twin.float() - want32).abs() <= bound).all())
    lbound = ref.flash_attention_lse_bound(qb, tk, tlse, **{
        x: kw[x] for x in ("causal", "window", "q_offset", "kv_valid_len",
                           "softcap")})
    lse32 = ref.flash_attention_ref(qb.float(), tk, tv, return_lse=True,
                                    **kw)[1]
    assert bool(((tlse - lse32).abs() <= lbound).all())


@pytest.mark.parametrize("route", ["gqa_causal", "hd80_noncausal",
                                   "offset_valid", "hd256_window"])
def test_plain_softcap_backward_matches_jax_bwd_rule(route):
    """``flash_attention_bwd_ref(..., softcap=2)`` from the plain forward's
    out and lse against the JAX package's ``_flash_bwd_rule`` on its own
    residuals (kv_block 16), float32."""
    b, sq, sk, hq, hkv, dk, dv, causal, win, q_off, valid = ROUTES[route]
    q, k, v = _qkv(sq + dk, b, sq, sk, hq, hkv, dk, dv, kscale=2.0)
    go = np.random.default_rng(9).standard_normal(
        (b, sq, hq, dv)).astype(np.float32)
    cap = 2.0
    _, _, (kp, vp, vl) = _jax_fwd(q, k, v, causal, win, q_off, valid, cap)
    g = hq // hkv
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
             jnp.int32(q_off), jnp.int32(vl), causal, win, 16, cap)
    _, res = JA._flash_fwd_rule(*jargs)
    gj = jnp.asarray(go.reshape(b, sq, hkv, g, dv).transpose(0, 2, 3, 1, 4))
    jdq, jdk, jdv, _, _ = JA._flash_bwd_rule(causal, win, 16, cap, res, gj)
    want = (np.asarray(jdq), np.asarray(jdk)[:, :sk], np.asarray(jdv)[:, :sk])
    kw = dict(causal=causal, window=win, q_offset=q_off, kv_valid_len=valid,
              softcap=cap)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ops.flash_attention(tq, tk, tv, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse,
                                      torch.from_numpy(go), **kw)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


def test_softcap_backward_bound_holds_and_catches_a_missing_cap():
    """``ref.flash_attention_bwd_bound(..., softcap=)`` (the smoke's rule
    for the softcap backward) holds the plain backward from a bf16 forward
    against autograd through the float32 one-pass attention with the cap,
    and catches the backward run without the cap's slope."""
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return (torch.randn(shape, generator=gen) * 2.0).bfloat16()
    q, k, v, go = r(2, 64, 8, 16), r(2, 64, 2, 16), r(2, 64, 2, 16), \
        r(2, 64, 8, 16)
    kw = dict(causal=True, softcap=3.0)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(TA.attend_onepass(*f32, **kw), f32,
                               go.float())
    bound = ref.flash_attention_bwd_bound(q, k, v, out, lse, go, **kw)

    def worst(**over):
        got = ref.flash_attention_bwd_ref(q, k, v, out, lse, go,
                                          **{**kw, **over})
        return max(float(((a.double() - w.double()).abs() / b).max())
                   for a, w, b in zip(got, want, bound))
    assert worst() <= 1.0
    assert worst(softcap=0.0) > 1.0


def test_softcap_gradcheck_float64():
    """``torch.autograd.gradcheck`` of ``attend`` with a cap at a tiny
    shape, float64 (the plain forward and backward keep float64)."""
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape) * 2
                                ).requires_grad_()
    q, k, v = t(1, 6, 4, 4), t(1, 6, 2, 4), t(1, 6, 2, 3)
    for kw in (dict(causal=True, softcap=1.5),
               dict(causal=False, kv_valid_len=5, softcap=0.7)):
        assert torch.autograd.gradcheck(
            lambda a, b_, c: TA.attend(a, b_, c, **kw), (q, k, v))


@pytest.mark.parametrize("cap", [-1.0, float("inf"), float("nan")])
def test_softcap_refuses_bad_caps(cap):
    """A cap that is negative, infinite or NaN is refused on both routes
    (``flash_attn.check_args``)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 4, 4, 2, 1, 8, 8))
    with pytest.raises(ValueError, match="softcap"):
        TA.attend(q, k, v, causal=True, softcap=cap)
