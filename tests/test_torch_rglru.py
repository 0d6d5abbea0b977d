"""The port's RG-LRU block (``repro_torch.models.rglru``) on the CPU against
the JAX package's (``repro.models.rglru``) with the same params, carried
over by ``repro_torch.bridge``: the log-depth scan of a prefill, the cache
it leaves and the decode recurrence, in float32 and bf16 at the
recurrentgemma smoke's size; the scan against sequential decode and
against a plain loop; and ROADMAP C7's split prefill. Inputs come from
numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

# float32: the scan's float order differs from JAX's associative_scan tree
# (each combine one exp, a multiply and an add, ~1e-7 relative, over
# log2 S levels) and the gates' matmuls sum in other orders: 1e-5 of the
# largest |output|. bf16: the projections round to bf16 (2^-8 relative) at
# the same places on both sides, but XLA's CPU matmul and torch's sum
# their float32 products in other orders first, so an element may round
# to the other bf16 neighbour, which the gates and the recurrence carry:
# 2% of the largest |output|.
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke("recurrentgemma-9b"),
                                param_dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke("recurrentgemma-9b"),
                                param_dtype=dtype))


def _params(jcfg, seed):
    jp, _ = JR.rglru_init(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _x(seed, b, s, d, dtype):
    x = (np.random.default_rng(seed).standard_normal((b, s, d)) * 0.5
         ).astype(np.float32)
    return jnp.asarray(x).astype(dtype), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= RTOL[dtype] * scale, \
        (np.abs(got - want).max(), scale)


def test_rglru_init_draws_the_jax_tree():
    """The port's own init: the JAX tree's keys, shapes and dtypes leaf for
    leaf, a^c = exp(-c softplus(lam)) in [0.9, 0.999] at r = 1; the bridge
    carries the JAX params' bits."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, 0)
    mine = TR.rglru_init(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, mine))
    for (path, a), b, c in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                               jax.tree.leaves(mine), jax.tree.leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.") == \
            str(c.dtype).removeprefix("torch."), path
        bits = c.view(torch.int16) if c.dtype == torch.bfloat16 else c
        np.testing.assert_array_equal(
            bits.numpy(), np.asarray(a).view(bits.numpy().dtype))
    a_c = torch.exp(-8.0 * torch.nn.functional.softplus(mine["lam"]))
    assert float(a_c.min()) >= 0.9 - 1e-6 and float(a_c.max()) <= 0.999 + 1e-6


@pytest.mark.parametrize("s", [1, 2, 5, 16, 37])
def test_scan_equals_a_plain_loop(s):
    """``_scan`` (ceil(log2 S) shifted steps) against h_t = exp(log_a_t)
    h_{t-1} + b_t in a loop, float32: 1e-5 of the largest |h| (the two sum
    the same terms in other orders)."""
    rng = np.random.default_rng(s)
    log_a = -torch.from_numpy(rng.uniform(0.0, 2.0, (2, s, 6))
                              .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, s, 6)).astype(np.float32))
    h, want = torch.zeros(2, 6), []
    for t in range(s):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        want.append(h)
    want = torch.stack(want, 1)
    got = TR._scan(log_a, b)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [3, 16, 33])
def test_rglru_prefill_without_cache_matches_jax(dtype, s):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 1)
    jx, tx = _x(s, 2, s, 64, dtype)
    jy, jc = JR.rglru_apply(jp, jx, jcfg)
    ty, tc = TR.rglru_apply(tp, tx, tcfg)
    assert jc is None and tc is None and ty.dtype == tx.dtype
    _close(ty, jy, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_prefill_and_decode_match_jax(dtype):
    """A prefill of 20 tokens into an empty cache, then four decode steps:
    every output, the state h and conv window after each call, and pos."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 2)
    jx, tx = _x(2, 2, 24, 64, dtype)
    jc = JR.rglru_empty_cache(jcfg, 2, jnp.float32)
    tc = TR.rglru_empty_cache(tcfg, 2, torch.float32, device="cpu")
    jy, jc = JR.rglru_apply(jp, jx[:, :20], jcfg, cache=jc)
    ty, tc = TR.rglru_apply(tp, tx[:, :20], tcfg, cache=tc)
    for t in range(20, 25):
        _close(ty, jy, dtype)
        _close(tc.h, jc.h, dtype)
        _close(tc.conv, jc.conv, dtype)
        assert isinstance(tc.pos, int) and tc.pos == int(jc.pos) == t
        if t == 24:
            break
        jy, jc = JR.rglru_apply(jp, jx[:, t:t + 1], jcfg, cache=jc)
        ty, tc = TR.rglru_apply(tp, tx[:, t:t + 1], tcfg, cache=tc)
    assert tc.h.dtype == torch.float32


def test_rglru_scan_matches_stepwise():
    """The scan of a prefill equals one decode step a token (float32, 2e-4
    as tests/test_ssm_rglru.py holds the JAX pair)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, 3)
    _, tx = _x(3, 2, 15, 64, "float32")
    y_scan, _ = TR.rglru_apply(tp, tx, tcfg)
    cache = TR.rglru_empty_cache(tcfg, 2, torch.float32, device="cpu")
    outs = []
    for t in range(15):
        o, cache = TR.rglru_decode(tp, tx[:, t:t + 1], tcfg, cache)
        outs.append(o)
    np.testing.assert_allclose(y_scan.numpy(), torch.cat(outs, 1).numpy(),
                               atol=2e-4)


def test_rglru_prefill_then_decode_continuity():
    """A prefill of 11 tokens, then one decode step, equals position 11 of
    a prefill of 12; the recurrence stays bounded."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, 4)
    _, tx = _x(4, 1, 12, 64, "float32")
    cache = TR.rglru_empty_cache(tcfg, 1, torch.float32, device="cpu")
    _, cache = TR.rglru_apply(tp, tx[:, :11], tcfg, cache=cache)
    y_dec, _ = TR.rglru_decode(tp, tx[:, 11:], tcfg, cache)
    y_full, _ = TR.rglru_apply(tp, tx, tcfg)
    np.testing.assert_allclose(y_dec.numpy(), y_full[:, 11:12].numpy(),
                               atol=2e-4)
    assert float(y_full.abs().max()) < 1e3


@pytest.mark.parametrize("split", [10, 18])
def test_c7_split_prefill_copies_the_reference(split):
    """ROADMAP C7, fact 3: a prefill into a non-empty cache seeds the scan
    with the cached state but convolves over zero padding, not the cached
    window, in both packages. Prefills of ``split`` then 20 - split tokens
    (2 tokens, fewer than conv_width - 1, keep the cached window's tail as
    the reference does) equal the JAX package's same split (float32); the
    second part differs from the prefill of all 20 by more than the
    tolerance."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 5)
    jx, tx = _x(5, 1, 20, 64, "float32")
    jc = JR.rglru_empty_cache(jcfg, 1, jnp.float32)
    tc = TR.rglru_empty_cache(tcfg, 1, torch.float32, device="cpu")
    ja, jc = JR.rglru_apply(jp, jx[:, :split], jcfg, cache=jc)
    jb, jc = JR.rglru_apply(jp, jx[:, split:], jcfg, cache=jc)
    ta, tc = TR.rglru_apply(tp, tx[:, :split], tcfg, cache=tc)
    tb, tc = TR.rglru_apply(tp, tx[:, split:], tcfg, cache=tc)
    for got, want in ((ta, ja), (tb, jb), (tc.h, jc.h), (tc.conv, jc.conv)):
        _close(got, want, "float32")
    assert tc.pos == int(jc.pos) == 20
    whole, _ = TR.rglru_apply(tp, tx, tcfg)
    gap = float((tb - whole[:, split:]).abs().max())
    assert gap > 100 * RTOL["float32"] * float(whole.abs().max())
