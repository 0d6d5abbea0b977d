"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) on the CPU
against the JAX package's (``repro.models.ssm``) with the same params,
carried over by ``repro_torch.bridge``: the chunked prefill, the cache it
leaves and the decode recurrence, in float32 and bf16 at the mamba2 smoke's
size; the chunked form against the port's own recurrence (the oracle of
tests/test_ssm_rglru.py); and ROADMAP C7's three facts of the reference.
Inputs come from numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

# float32: both sides run the same float32 steps in other orders (XLA's
# einsums and scan against torch's), ~1e-7 relative each, over a chunked
# form of a few dozen terms: 1e-5 of the largest |output|. bf16: the
# projections and the conv output round to bf16 (2^-8 relative) at the
# same places on both sides, but XLA's CPU matmul and torch's sum their
# float32 products in other orders before rounding, so an element may land
# on the other bf16 neighbour, which the float32 steps after it carry: 2%
# of the largest |output|.
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype="float32", **over):
    j = dataclasses.replace(jconfigs.get_smoke("mamba2-1.3b"),
                            param_dtype=dtype, **over)
    t = dataclasses.replace(tconfigs.get_smoke("mamba2-1.3b"),
                            param_dtype=dtype, **over)
    return j, t


def _params(jcfg, seed):
    jp, _ = JS.ssd_init(jax.random.PRNGKey(seed), jcfg)
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


def _jcache(cfg, b, dtype):
    return JS.ssm_empty_cache(cfg, b, dtype)


def test_ssd_init_draws_the_jax_tree():
    """The port's own init: the JAX tree's keys, shapes and dtypes leaf for
    leaf (its numbers come from another generator), A in [1, 16), dt's
    softplus in [1e-3, 1e-1], D ones; the bridge carries the JAX params'
    bits."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, 0)
    mine = TS.ssd_init(torch.Generator().manual_seed(0), tcfg)
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
    a = torch.exp(mine["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) < 16.0
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert torch.equal(mine["D"], torch.ones(8))        # 128 / 16 heads
    stacked = TS.ssd_init(torch.Generator().manual_seed(0), tcfg, stack=(3,))
    assert stacked["in_proj"].shape == (3, *mine["in_proj"].shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 19, 40])
def test_ssd_prefill_without_cache_matches_jax(dtype, s):
    """The chunked form with no cache: one chunk, a padded last chunk (19,
    40 over chunks of 16)."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 1)
    jx, tx = _x(s, 2, s, 64, dtype)
    jy, jc = JS.ssd_apply(jp, jx, jcfg)
    ty, tc = TS.ssd_apply(tp, tx, tcfg)
    assert jc is None and tc is None and ty.dtype == tx.dtype
    _close(ty, jy, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_prefill_and_decode_match_jax(dtype):
    """A prefill of 19 tokens into an empty cache, then four decode steps:
    every output, the state and conv window the cache holds after each
    call, and pos (32 after the prefill: ROADMAP C7, the padded length)."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 2)
    jx, tx = _x(2, 2, 23, 64, dtype)
    jc = _jcache(jcfg, 2, jnp.float32)
    tc = TS.ssm_empty_cache(tcfg, 2, torch.float32, device="cpu")
    jy, jc = JS.ssd_apply(jp, jx[:, :19], jcfg, cache=jc)
    ty, tc = TS.ssd_apply(tp, tx[:, :19], tcfg, cache=tc)
    assert tc.pos == int(jc.pos) == 32
    for t in range(19, 24):
        _close(ty, jy, dtype)
        _close(tc.state, jc.state, dtype)
        _close(tc.conv, jc.conv, dtype)
        assert isinstance(tc.pos, int) and tc.pos == int(jc.pos)
        if t == 23:
            break
        jy, jc = JS.ssd_apply(jp, jx[:, t:t + 1], jcfg, cache=jc)
        ty, tc = TS.ssd_apply(tp, tx[:, t:t + 1], tcfg, cache=tc)
    assert tc.pos == 36 and tc.state.dtype == torch.float32


def _recurrence(p, x, cfg):
    """tests/test_ssm_rglru.py's oracle on the port: one decode step a
    token from an empty cache."""
    cache = TS.ssm_empty_cache(cfg, x.shape[0], torch.float32, device="cpu")
    outs = []
    for t in range(x.shape[1]):
        o, cache = TS.ssd_decode(p, x[:, t:t + 1], cfg, cache)
        outs.append(o)
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("chunk,s", [(8, 24), (8, 21), (16, 40)])
def test_ssd_chunked_matches_the_recurrence(chunk, s):
    """The chunked dual form equals the token-by-token recurrence (float32,
    2e-4 as tests/test_ssm_rglru.py holds the JAX pair), and its final
    state and conv window the recurrence's (the window is the same
    projection, summed at another batch shape: 1e-6)."""
    jcfg, tcfg = _cfgs(chunk=chunk)
    _, tp = _params(jcfg, 3)
    _, tx = _x(3, 2, s, 64, "float32")
    y, c = TS.ssd_apply(tp, tx, tcfg, cache=TS.ssm_empty_cache(
        tcfg, 2, torch.float32, device="cpu"))
    y_rec, c_rec = _recurrence(tp, tx, tcfg)
    np.testing.assert_allclose(y.numpy(), y_rec.numpy(), atol=2e-4)
    np.testing.assert_allclose(c.state.numpy(), c_rec.state.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(c.conv.numpy(), c_rec.conv.numpy(),
                               atol=1e-6)


def test_ssd_chunk_padding_inert():
    """S not a multiple of the chunk: the prefix of a longer input gives
    the same outputs (dt = 0 at the pads)."""
    _, tcfg = _cfgs(chunk=8)
    _, tp = _params(_cfgs(chunk=8)[0], 4)
    _, tx = _x(4, 1, 24, 64, "float32")
    y19, _ = TS.ssd_apply(tp, tx[:, :19], tcfg)
    y24, _ = TS.ssd_apply(tp, tx, tcfg)
    np.testing.assert_allclose(y19.numpy(), y24[:, :19].numpy(), atol=2e-4)


def test_ssd_prefill_state_continues_decode():
    """A prefill of 16 tokens, then one decode step, equals position 16 of
    a prefill of 17 (tests/test_ssm_rglru.py's, on the port)."""
    jcfg, tcfg = _cfgs(chunk=8)
    _, tp = _params(jcfg, 5)
    _, tx = _x(5, 1, 17, 64, "float32")
    cache = TS.ssm_empty_cache(tcfg, 1, torch.float32, device="cpu")
    _, cache = TS.ssd_apply(tp, tx[:, :16], tcfg, cache=cache)
    y_last, _ = TS.ssd_decode(tp, tx[:, 16:], tcfg, cache)
    y_full, _ = TS.ssd_apply(tp, tx, tcfg)
    np.testing.assert_allclose(y_last.numpy(), y_full[:, 16:17].numpy(),
                               atol=2e-4)


def test_c7_split_prefill_copies_the_reference():
    """ROADMAP C7, fact 3: a prefill into a non-empty cache convolves over
    zero padding, not over the cached window, in both packages. A prefill
    of 10 then 9 tokens equals the JAX package's same split (float32, as
    above), and both differ from the prefill of all 19 by far more than
    the tolerance (the reference's own behaviour, kept as the parity
    contract); pos advances by the padded 16 + 16."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 6)
    jx, tx = _x(6, 1, 19, 64, "float32")
    jc = _jcache(jcfg, 1, jnp.float32)
    tc = TS.ssm_empty_cache(tcfg, 1, torch.float32, device="cpu")
    ja, jc = JS.ssd_apply(jp, jx[:, :10], jcfg, cache=jc)
    jb, jc = JS.ssd_apply(jp, jx[:, 10:], jcfg, cache=jc)
    ta, tc = TS.ssd_apply(tp, tx[:, :10], tcfg, cache=tc)
    tb, tc = TS.ssd_apply(tp, tx[:, 10:], tcfg, cache=tc)
    _close(ta, ja, "float32")
    _close(tb, jb, "float32")
    _close(tc.state, jc.state, "float32")
    assert tc.pos == int(jc.pos) == 19     # each part is one whole chunk
    whole, _ = TS.ssd_apply(tp, tx, tcfg)
    gap = float((tb - whole[:, 10:]).abs().max())
    assert gap > 100 * RTOL["float32"] * float(whole.abs().max())


def test_c7_short_prefill_raises():
    """ROADMAP C7, fact 2: a prefill of 2 tokens (2 <= S < conv_width - 1)
    into a cache. The reference returns a conv window of 2 rows where the
    cache holds 3, which its own decode cannot contract with the (4, C)
    conv weight; the port raises ValueError naming C7 instead of writing
    any window."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 7)
    jx, tx = _x(7, 1, 3, 64, "float32")
    jc0 = _jcache(jcfg, 1, jnp.float32)
    _, jc = JS.ssd_apply(jp, jx[:, :2], jcfg, cache=jc0)
    assert jc.conv.shape[1] == 2 != jc0.conv.shape[1] == 3
    with pytest.raises(Exception):
        JS.ssd_decode(jp, jx[:, 2:], jcfg, jc)
    tc = TS.ssm_empty_cache(tcfg, 1, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="C7"):
        TS.ssd_apply(tp, tx[:, :2], tcfg, cache=tc)
    # one token decodes, three fill the window: both as the reference
    y1, c1 = TS.ssd_apply(tp, tx[:, :1], tcfg, cache=tc)
    y3, c3 = TS.ssd_apply(tp, tx, tcfg, cache=tc)
    assert c1.pos == 1 and c3.pos == 3 and c3.conv.shape == tc.conv.shape
    _, jc3 = JS.ssd_apply(jp, jx, jcfg, cache=jc0)
    _close(c3.conv, jc3.conv, "float32")
