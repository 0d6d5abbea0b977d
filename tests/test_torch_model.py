"""The port's LM serving path (Model.prefill / decode, forward) on the CPU
against the JAX package's, with the JAX params carried over through
``repro_torch.bridge.lm_params_from_numpy``; and the config registry field
for field. Inputs come from numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model as tbuild, make_prefill_step, make_serve_step)

# the dense GQA archs; the MoE archs (grok-1: GQA + MoE + the logit
# softcap; deepseek-v2-lite: MLA + MoE with shared experts and a dense first
# layer); the recurrent archs (mamba2: SSD blocks, no MLP; recurrentgemma:
# RG-LRU + local attention, GeGLU, the logit softcap); the modality archs
# (internvl2: patches before the prompt; whisper: the encoder-decoder with
# cross-attention, tests/test_torch_encdec.py for its pieces)
DENSE = ("h2o-danube-1.8b", "phi3-mini-3.8b", "mistral-large-123b",
         "stablelm-12b")
MOE = ("grok-1-314b", "deepseek-v2-lite-16b")
RECURRENT = ("mamba2-1.3b", "recurrentgemma-9b")
MODAL = ("internvl2-1b", "whisper-large-v3")


def _pair(arch, seed=0, **over):
    jm = jbuild(dataclasses.replace(jconfigs.get_smoke(arch), **over))
    tm = tbuild(dataclasses.replace(tconfigs.get_smoke(arch), **over))
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _logits(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _stub_inputs(cfg, b, seed):
    """The modality frontends' stub embeddings, numpy float32: frames (B,
    n_frames, d) for an enc-dec config, patches (B, n_patches, d) for a
    vlm; {} for the others."""
    rng = np.random.default_rng(seed + 100)
    kw = {}
    if cfg.n_frames:
        kw["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        kw["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return kw


def _serve_both(jm, jp, tm, tp, b, prompt, gen, seed, teacher=False):
    """Prefill + greedy decode on both packages; yields the (JAX, port)
    logits and tokens of every step. With ``teacher`` the port is fed the
    JAX package's tokens. Enc-dec and vlm configs prefill with the same
    stub frames / patches on both sides."""
    toks = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab_size, (b, prompt)).astype(np.int32)
    stub = _stub_inputs(jm.cfg, b, seed)
    jc = jm.init_cache(b, prompt + gen, dtype=jnp.float32)
    tc = tm.init_cache(b, prompt + gen, dtype=torch.float32, device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jc,
                        **{k: jnp.asarray(v) for k, v in stub.items()})
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc,
                        **{k: torch.from_numpy(v) for k, v in stub.items()})
    for i in range(gen):
        jt = np.array(jnp.argmax(jl[:, -1:], -1).astype(jnp.int32))
        tt = torch.argmax(tl[:, -1:], -1).to(torch.int32)
        yield _logits(jl), _logits(tl), jt, tt.numpy()
        if i == gen - 1:
            break
        jl, jc = jm.decode(jp, jnp.asarray(jt), jc)
        tl, tc = tm.decode(tp, torch.from_numpy(jt) if teacher else tt, tc)


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + MODAL)
def test_prefill_decode_match_jax_f32(arch):
    """float32 params: logits to 1e-4 and equal greedy tokens at every
    step. The prompt (20) is longer than danube's smoke window (16), so its
    cache rolls; phi3 and mistral use the full cache, stablelm layernorm;
    grok and deepseek route through MoE (the prefill at capacity
    ceil(20 k / E * 1.25), which drops copies, a decode step at 1), and
    deepseek attends in latent space (MLA, dk 40 / dv 32); mamba2 runs the
    chunked SSD (20 tokens over chunks of 16: a padded last chunk) then
    its recurrence, recurrentgemma the RG-LRU scan and its rolling local
    attention (window 16); internvl2 prefills 8 patches before the prompt
    (GQA group 7), whisper encodes 12 frames and cross-attends to them in
    every step."""
    jm, jp, tm, tp = _pair(arch, param_dtype="float32")
    steps = 0
    for jl, tl, jt, tt in _serve_both(jm, jp, tm, tp, 2, 20, 6, seed=1):
        np.testing.assert_allclose(tl, jl, atol=1e-4)
        np.testing.assert_array_equal(tt, jt)
        steps += 1
    assert steps == 6


def test_rolling_cache_is_window_sized():
    """danube's smoke window (16) bounds its cache: the prefill of 20
    tokens takes the rolling path, and every later step writes modulo 16."""
    tm = tbuild(tconfigs.get_smoke("h2o-danube-1.8b"))
    cache = tm.init_cache(2, 26, dtype=torch.float32, device="cpu")
    assert cache["groups"][0].k.shape == (3, 2, 16, 2, 16)
    assert cache["groups"][0].pos == 0


def test_prefill_decode_match_jax_bf16():
    """bf16 params (the configs' default), the port fed the JAX package's
    tokens: bf16 rounds at other places in XLA's CPU ops and torch's (each
    rounding 2^-8 relative), which compounds over three layers to 1-2% of
    the largest |logit| on these configs; the bound is 5%, as
    chip_smoke.py's decode-vs-prefill check at full width."""
    jm, jp, tm, tp = _pair("h2o-danube-1.8b")
    assert tp["embed"].dtype == torch.bfloat16
    for jl, tl, _, _ in _serve_both(jm, jp, tm, tp, 2, 20, 6, seed=2,
                                    teacher=True):
        scale = np.abs(jl).max()
        assert np.abs(tl - jl).max() <= 0.05 * scale


def test_forward_and_step_builders_match_jax():
    """The full-sequence forward (no cache) and the step builders."""
    jm, jp, tm, tp = _pair("phi3-mini-3.8b", seed=3, param_dtype="float32")
    toks = np.random.default_rng(3).integers(0, 256, (2, 12)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 12, jm.cfg.vocab_padded) and aux == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    cache = tm.init_cache(2, 13, dtype=torch.float32, device="cpu")
    pl, cache = make_prefill_step(tm)(tp, cache, torch.from_numpy(toks))
    np.testing.assert_allclose(pl[:, 0].numpy(), tl[:, -1].numpy(),
                               atol=1e-4)
    nxt = torch.argmax(pl, -1).to(torch.int32)
    dl, cache = make_serve_step(tm)(tp, cache, nxt)
    assert cache["groups"][0].pos == 13 and dl.shape == pl.shape
    with pytest.raises(ValueError, match="cannot take 1 more"):
        make_serve_step(tm)(tp, cache, nxt)


def test_prefill_goes_through_the_attention_seam(monkeypatch):
    """Every layer of a prefill calls ops.flash_attention once (the chip
    counts its launches the same way); a decode step calls it not at all."""
    tm = tbuild(tconfigs.get_smoke("phi3-mini-3.8b"))
    tp = tm.init(torch.Generator().manual_seed(0))
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    cache = tm.init_cache(2, 10, dtype=torch.float32, device="cpu")
    logits, cache = tm.prefill(tp, torch.zeros((2, 8), dtype=torch.int64),
                               cache)
    assert len(calls) == tm.cfg.n_layers
    assert calls[0] == dict(causal=True, window=None, q_offset=0,
                            kv_valid_len=8)
    tm.decode(tp, torch.zeros((2, 1), dtype=torch.int32), cache)
    assert len(calls) == tm.cfg.n_layers
    assert torch.isfinite(logits[..., :tm.cfg.vocab_size]).all()


def test_init_draws_the_jax_shapes_and_dtypes():
    """The port's own seeded init has the JAX tree's structure, shapes and
    dtypes leaf for leaf (its numbers come from another generator)."""
    arch = "h2o-danube-1.8b"
    jp, _ = jbuild(jconfigs.get_smoke(arch)).init(jax.random.PRNGKey(0))
    tm = tbuild(tconfigs.get_smoke(arch))
    tp = tm.init(torch.Generator().manual_seed(0))
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    bl = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, bl)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for (path, a), b in zip(jl, jax.tree.leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    again = tm.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(tp), jax.tree.leaves(again)))
    w = tp["groups"][0]["mixer"]["wq"].float()
    assert float(w.abs().max()) <= 2 / np.sqrt(64) + 1e-6   # truncated at 2


@pytest.mark.parametrize("arch", sorted(jconfigs.ALIASES))
def test_configs_match_jax(arch):
    for get in ("get_config", "get_smoke"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.vocab_padded, t.hd, t.layer_plan(), t.param_count(),
                t.active_param_count(), t.sub_quadratic()) == \
            (j.vocab_padded, j.hd, j.layer_plan(), j.param_count(),
             j.active_param_count(), j.sub_quadratic())
        assert [t.mixer_of(i) for i in range(t.n_layers)] == \
            [j.mixer_of(i) for i in range(j.n_layers)]
        assert [t.mlp_of(i) for i in range(t.n_layers)] == \
            [j.mlp_of(i) for i in range(j.n_layers)]
        assert t.dtype == getattr(torch, j.param_dtype)
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.all_arch_ids() == jconfigs.all_arch_ids()


@pytest.mark.parametrize("arch", MODAL)
def test_modal_prefill_decode_match_jax_bf16(arch):
    """The enc-dec and vlm archs, which the port served not at all before
    (they raised naming ROADMAP A6), in bf16 params (the configs'
    default), the port fed the JAX package's tokens: 5% of the largest
    |logit| at every step, as the dense bf16 test; the same greedy tokens
    in this seed's every step."""
    jm, jp, tm, tp = _pair(arch, seed=9)
    assert tp["embed"].dtype == torch.bfloat16
    steps = 0
    for jl, tl, jt, tt in _serve_both(jm, jp, tm, tp, 2, 20, 6, seed=9,
                                      teacher=True):
        scale = np.abs(jl).max()
        assert np.abs(tl - jl).max() <= 0.05 * scale
        np.testing.assert_array_equal(tt, jt)
        steps += 1
    assert steps == 6


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_decode_match_jax_bf16(arch):
    """bf16 params, the port fed the JAX package's tokens: as the dense
    bf16 test, 5% of the largest |logit| at every step. MoE adds the
    router: XLA and torch sum its float32 product of bf16 inputs in other
    orders, which can flip a near-tied top-k choice; this seed's inputs
    flip none within the bound."""
    jm, jp, tm, tp = _pair(arch, seed=6)
    for jl, tl, _, _ in _serve_both(jm, jp, tm, tp, 2, 20, 6, seed=6,
                                    teacher=True):
        scale = np.abs(jl).max()
        assert np.abs(tl - jl).max() <= 0.05 * scale


@pytest.mark.parametrize("arch", MOE)
def test_forward_returns_the_moe_aux_loss(arch):
    """The full-sequence forward's logits to 1e-4 of JAX's and its aux
    loss (the Switch losses of the MoE layers, summed) to 1e-5; the
    first_k_dense prefix layer adds none."""
    jm, jp, tm, tp = _pair(arch, seed=7, param_dtype="float32")
    toks = np.random.default_rng(7).integers(0, 256, (2, 12)).astype(np.int32)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert aux.shape == () and aux.dtype == torch.float32
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_and_mla_trees_carry_over_leaf_for_leaf(arch):
    """``bridge.lm_params_from_numpy`` walks the MoE / MLA trees as it walks
    any: the JAX tree's structure, shapes, dtypes and bits, leaf for leaf,
    equal to the port's own init in structure, shapes and dtypes, down to
    the first_k_dense prefix (deepseek: one dense layer of d_ff 10944 at
    full width, the rest stacked MoE groups)."""
    jm, jp, tm, tp = _pair(arch)
    mine = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, mine))
    for (path, a), b, c in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                               jax.tree.leaves(tp), jax.tree.leaves(mine)):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.") == \
            str(c.dtype).removeprefix("torch."), path
        bits = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        np.testing.assert_array_equal(
            bits.numpy(), np.asarray(a).view(bits.numpy().dtype))
    n_pre, n_groups, _ = tm.cfg.layer_plan()
    if arch == "deepseek-v2-lite-16b":
        assert (n_pre, n_groups) == (1, 2)
        assert "mlp" in tp["prefix"][0] and "moe" in tp["groups"][0]
        assert tp["groups"][0]["moe"]["wi"].shape[:2] == (n_groups, 8)
        assert tconfigs.get_config(arch).layer_plan() == (1, 26, 0)
    else:
        assert n_pre == 0 and "moe" in tp["groups"][0]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_decode_match_jax_bf16(arch):
    """bf16 params, the port fed the JAX package's tokens: 5% of the
    largest |logit| at every step, as the dense bf16 test (bf16 rounds at
    other places in XLA's CPU ops and torch's; the recurrences carry it)."""
    jm, jp, tm, tp = _pair(arch, seed=8)
    assert tp["embed"].dtype == torch.bfloat16
    steps = 0
    for jl, tl, _, _ in _serve_both(jm, jp, tm, tp, 2, 20, 6, seed=8,
                                    teacher=True):
        scale = np.abs(jl).max()
        assert np.abs(tl - jl).max() <= 0.05 * scale
        steps += 1
    assert steps == 6


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_trees_carry_over_leaf_for_leaf(arch):
    """``bridge.lm_params_from_numpy`` walks the SSD and RG-LRU trees as it
    walks any: the JAX tree's structure, shapes, dtypes and bits, leaf for
    leaf, equal to the port's own init in structure, shapes and dtypes. A
    mamba2 block has no norm2 and no MLP (the ssm family); recurrentgemma's
    pattern slots are (rglru, rglru, lattn) with two rglru tail layers."""
    jm, jp, tm, tp = _pair(arch)
    mine = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, mine))
    for (path, a), b, c in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                               jax.tree.leaves(tp), jax.tree.leaves(mine)):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.") == \
            str(c.dtype).removeprefix("torch."), path
        bits = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        np.testing.assert_array_equal(
            bits.numpy(), np.asarray(a).view(bits.numpy().dtype))
    n_pre, n_groups, n_tail = tm.cfg.layer_plan()
    if arch == "mamba2-1.3b":
        assert (n_pre, n_groups, n_tail) == (0, 4, 0)
        assert set(tp["groups"][0]) == {"norm1", "mixer"}
        assert tp["groups"][0]["mixer"]["A_log"].shape == (4, 8)
    else:
        assert (n_pre, n_groups, n_tail) == (0, 1, 2)
        assert set(tp["tail"][0]) == {"norm1", "mixer", "norm2", "mlp"}
        assert "lam" in tp["groups"][0]["mixer"]
        assert tp["groups"][2]["mixer"]["wq"].shape == (1, 64, 4, 16)
        assert tconfigs.get_config(arch).layer_plan() == (0, 12, 2)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_cache_is_written_in_place(arch):
    """The recurrent archs' caches: mamba2's SSMCache (state float32, conv
    in the cache dtype) and recurrentgemma's RGLRUCache plus a rolling
    window-slot KVCache, each stacked on the group axis; a prefill writes
    the tensors the caller holds (the blocks return new state, copied into
    the layer's slice) and returns their pos (mamba2's counts the padding:
    ROADMAP C7)."""
    tm = tbuild(tconfigs.get_smoke(arch))
    tp = tm.init(torch.Generator().manual_seed(0))
    cache = tm.init_cache(2, 30, dtype=torch.float32, device="cpu")
    held = [t for part in ("groups", "tail") for c in cache[part]
            for t in c[:-1]]
    assert all(not t.any() for t in held)
    _, out = tm.prefill(tp, torch.ones((2, 20), dtype=torch.int64), cache)
    assert all(t.any() for t in held)
    for part in ("groups", "tail"):
        for c, o in zip(cache[part], out[part]):
            assert all(a is b for a, b in zip(c[:-1], o[:-1]))
    if arch == "mamba2-1.3b":
        g = out["groups"][0]
        assert g.state.shape == (4, 2, 8, 16, 16) and g.pos == 32
        assert g.state.dtype == torch.float32
    else:
        assert out["groups"][2].k.shape == (1, 2, 16, 1, 16)
        assert out["tail"][0].h.shape == (2, 64)
        assert [c.pos for c in out["groups"]] == [20, 20, 20]
