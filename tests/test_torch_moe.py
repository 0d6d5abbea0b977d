"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the
JAX package's ``repro/models/moe.py``: the routing bit for bit, the layer's
output and aux loss within stated tolerances, with the JAX params carried
over through ``bridge.lm_params_from_numpy``; and tests/test_moe.py's
behaviour (dense oracle, drops, shared experts, dest validity) on the port.
Inputs come from numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402


def _cfgs(e=4, k=2, cap=8.0, shared=0, kind="swiglu", dtype="float32"):
    kw = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, moe_d_ff=32, vocab_size=64,
              n_experts=e, n_experts_active=k, n_shared_experts=shared,
              capacity_factor=cap, mlp_kind=kind, param_dtype=dtype)
    return JConfig(**kw), TConfig(**kw)


def _params(jcfg, seed):
    jp, _ = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("s,k,e,cap", [
    (4, 2, 4, 2),       # tests/test_moe.py's shape: drops
    (12, 2, 4, 100),    # ample capacity: no drop
    (33, 6, 64, 4),     # deepseek's top-6 of 64, tight
    (20, 2, 8, 5),      # the deepseek smoke's (k 2 of 8), a few drops
    (7, 1, 3, 1),       # top-1, capacity 1
])
def test_route_row_bitwise(s, k, e, cap):
    """dest of every routed copy, with and without drops, equal to JAX's
    ``_route_row`` on the same top-k indices, row by row."""
    rng = np.random.default_rng(s * 100 + e)
    # k distinct experts a token, as top_k gives
    ti = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(s)])
                   for _ in range(3)]).astype(np.int32)
    got = TM.route_rows(torch.from_numpy(ti), cap, e)
    assert got.dtype == torch.int32 and got.shape == (3, s * k)
    for row in range(3):
        want = np.asarray(JM._route_row(jnp.asarray(ti[row]), k, cap, e))
        np.testing.assert_array_equal(got[row].numpy(), want)
    counts = np.bincount(ti.reshape(3, -1)[0], minlength=e)
    assert int((got[0] == e * cap).sum()) == int(np.maximum(
        counts - cap, 0).sum())


def test_route_row_capacity_and_dest_validity():
    """tests/test_moe.py's case: expert 0 asked 4 times at capacity 2."""
    ti = torch.tensor([[[0, 1], [0, 1], [0, 2], [0, 3]]], dtype=torch.int32)
    dest = TM.route_rows(ti, 2, 4).reshape(4, 2).numpy()
    e0 = dest[:, 0]
    assert (e0 == 8).sum() == 2
    assert sorted(d for d in e0 if d < 8) == [0, 1]


@pytest.mark.parametrize("cap,shared,kind", [
    (8.0, 0, "swiglu"), (1.0, 0, "swiglu"), (1.25, 1, "swiglu"),
    (1.25, 0, "geglu"), (0.5, 2, "geglu")],
    ids=["ample", "tight", "shared", "geglu", "geglu_shared_drops"])
def test_moe_apply_matches_jax_f32(cap, shared, kind):
    """float32 params: the output to 2e-5 (float32 sums in other orders over
    d = 16 and f = 32), the aux loss to 1e-6, the routing decisions equal
    (the router's probabilities agree to ~1e-7; no pair of the top-k and
    the next expert lies that close on these inputs, which the test
    asserts)."""
    jcfg, tcfg = _cfgs(cap=cap, shared=shared, kind=kind)
    jp, tp = _params(jcfg, seed=int(cap * 4) + shared)
    x = _x(int(cap * 10) + shared, (2, 24, 16))
    want, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    got, aux = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)

    probs, top_p, top_i = TM.route(tp, torch.from_numpy(x), tcfg)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    jtop_p, jtop_i = jax.lax.top_k(jprobs, tcfg.n_experts_active)
    srt = np.sort(np.asarray(jprobs), -1)[..., ::-1]
    margin = srt[..., tcfg.n_experts_active - 1] - srt[
        ..., tcfg.n_experts_active]
    assert margin.min() > 1e-5
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-7)


def test_moe_apply_matches_jax_bf16_at_the_deepseek_smoke():
    """The deepseek smoke's MoE (8 experts, top-2, one shared expert,
    bf16 weights) on a prompt-length input with drops (capacity 13 for 40
    tokens). Routing decisions equal to JAX's except at near-ties: each
    mismatching token's k-th and (k+1)-th JAX probabilities lie within
    1e-3 of each other (the router's float32 product of bf16 inputs sums
    in another order in XLA and torch, ~1e-6 relative). Output: bf16
    rounds at other places in XLA's CPU ops and torch's, 2^-8 relative a
    rounding; tokens whose routing agrees are held to 3% of the largest
    |output|."""
    jc = dataclasses.replace(JConfig(**dataclasses.asdict(
        tconfigs.get_smoke("deepseek-v2-lite-16b"))))
    tc = tconfigs.get_smoke("deepseek-v2-lite-16b")
    jp, tp = _params(jc, seed=5)
    x = _x(5, (2, 40, tc.d_model), scale=1.0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = bridge.lm_params_from_numpy(np.asarray(xb), "cpu")
    want, jaux = JM.moe_apply(jp, xb, jc)
    got, aux = TM.moe_apply(tp, xt, tc)
    assert got.dtype == torch.bfloat16

    jprobs = np.asarray(jax.nn.softmax(xb.astype(jnp.float32) @ jp["router"],
                                       axis=-1))
    _, jtop_i = jax.lax.top_k(jnp.asarray(jprobs), tc.n_experts_active)
    _, _, top_i = TM.route(tp, xt, tc)
    same = (np.sort(top_i.numpy(), -1) == np.sort(np.asarray(jtop_i), -1)
            ).all(-1)
    srt = np.sort(jprobs, -1)[..., ::-1]
    margin = srt[..., tc.n_experts_active - 1] - srt[..., tc.n_experts_active]
    assert (margin[~same] < 1e-3).all(), margin[~same]
    assert same.mean() > 0.9
    # a flipped choice in one token can move another's slot past capacity:
    # hold only the batch rows whose routing agrees everywhere
    rows = same.all(-1)
    assert rows.any()
    w = np.asarray(want.astype(jnp.float32))[rows]
    g = got.float().numpy()[rows]
    assert np.abs(g - w).max() <= 0.03 * np.abs(w).max()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)


def _dense_oracle(p, x, cfg):
    """Every expert computed densely, combined by the renormalised gates."""
    probs = torch.softmax(x @ p["router"], -1)
    top_p, top_i = torch.topk(probs, cfg.n_experts_active, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    eo = torch.stack([(torch.nn.functional.silu(x @ p["wg"][e])
                       * (x @ p["wi"][e])) @ p["wo"][e]
                      for e in range(cfg.n_experts)], dim=2)   # (B,S,E,d)
    w = torch.zeros_like(probs).scatter_(-1, top_i, top_p)
    return torch.einsum("bsed,bse->bsd", eo, w)


def test_dispatch_matches_dense_oracle_with_ample_capacity():
    """tests/test_moe.py's: with room for every copy the dispatch equals
    the dense computation (float32, 2e-5); the aux loss is positive."""
    _, tcfg = _cfgs(cap=8.0)
    p = TM.moe_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.from_numpy(_x(0, (2, 12, 16)))
    got, aux = TM.moe_apply(p, x, tcfg)
    torch.testing.assert_close(got, _dense_oracle(p, x, tcfg), rtol=0,
                               atol=2e-5)
    assert float(aux) > 0


def test_capacity_drops_are_bounded():
    """tests/test_moe.py's: at capacity factor 1 some copies drop; the
    output stays finite, a dropped copy adds nothing (the token's output is
    its surviving copies' gated sum), and many tokens match the oracle."""
    _, tcfg = _cfgs(cap=1.0)
    p = TM.moe_init(torch.Generator().manual_seed(1), tcfg)
    x = torch.from_numpy(_x(1, (1, 32, 16)))
    got, _ = TM.moe_apply(p, x, tcfg)
    assert torch.isfinite(got).all()
    _, _, top_i = TM.route(p, x, tcfg)
    dest = TM.route_rows(top_i, TM.capacity(tcfg, 32), tcfg.n_experts)
    assert int((dest == tcfg.n_experts * TM.capacity(tcfg, 32)).sum()) > 0
    frac_same = ((got - _dense_oracle(p, x, tcfg)).abs() < 1e-4).float()
    assert float(frac_same.mean()) > 0.3


def test_shared_experts_add_the_dense_path():
    """The shared experts are one dense MLP of n_shared * f columns added
    to the routed output."""
    _, tcfg = _cfgs(shared=2)
    p = TM.moe_init(torch.Generator().manual_seed(2), tcfg)
    assert p["shared"]["wi"].shape == (16, 64)
    x = torch.from_numpy(_x(2, (1, 8, 16)))
    got, _ = TM.moe_apply(p, x, tcfg)
    routed, _ = TM.moe_apply({k: v for k, v in p.items() if k != "shared"},
                             x, dataclasses.replace(tcfg, n_shared_experts=0))
    torch.testing.assert_close(
        got, routed + TL.mlp_apply(p["shared"], x, "swiglu", "silu"),
        rtol=0, atol=1e-6)


def test_decode_step_never_drops():
    """A decode step (S = 1) has capacity ceil(k / E * 1.25) = 1 an expert
    and k distinct experts: no copy drops, so its output is the dense
    oracle's."""
    _, tcfg = _cfgs(e=8, k=3, cap=1.25)
    p = TM.moe_init(torch.Generator().manual_seed(3), tcfg)
    x = torch.from_numpy(_x(3, (5, 1, 16)))
    assert TM.capacity(tcfg, 1) == 1
    got, _ = TM.moe_apply(p, x, tcfg)
    torch.testing.assert_close(got, _dense_oracle(p, x, tcfg), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_moe_init_has_the_jax_tree(arch):
    """The port's own init draws the JAX package's tree, shapes and dtypes
    leaf for leaf (its numbers come from another generator)."""
    tc = tconfigs.get_smoke(arch)
    jc = JConfig(**dataclasses.asdict(tc))
    jp, _ = JM.moe_init(jax.random.PRNGKey(0), jc)
    tp = TM.moe_init(torch.Generator().manual_seed(0), tc)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for (path, a), b in zip(jl, jax.tree.leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
