"""The port's encoder-decoder stack (``repro_torch.models.encdec``,
whisper-large-v3's backbone) and vlm input path (internvl2-1b's patch
prefix) on the CPU against the JAX package's, with the JAX params carried
over through ``bridge.lm_params_from_numpy``: the pieces (``sinusoid``,
``encode``, ``project_cross_kv``, cross-attention through ``gqa_apply``'s
``kv_override``), the teacher-forced decoder, the trees and caches, and the
attention seam's calls. Inputs come from numpy with a seed.

Tolerances: float32 params on both sides, the attention sums in another
order (the JAX package's blocks, the port's tiles of 64), as
tests/test_torch_model.py holds the dense archs: 1e-5 on a block's output
(values of order 1), 1e-4 on logits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model as tbuild, make_prefill_step, make_serve_step)

WHISPER, VLM = "whisper-large-v3", "internvl2-1b"


def _pair(arch, seed=0, dtype="float32"):
    jm = jbuild(dataclasses.replace(jconfigs.get_smoke(arch),
                                    param_dtype=dtype))
    tm = tbuild(dataclasses.replace(tconfigs.get_smoke(arch),
                                    param_dtype=dtype))
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n,d", [(1500, 1280), (12, 64), (7, 2)])
def test_sinusoid_matches_jax(n, d):
    """whisper's 1,500 encoder positions at d 1,280, the smoke's, and the
    degenerate half of one frequency. XLA's float32 exp and torch's round
    43 of whisper's 640 frequencies to neighbouring floats (2^-24 of a
    frequency <= 1), which moves the angle at position p by up to p 2^-24:
    the bound is two such steps at the last position plus 2e-6 for sin and
    cos themselves (1.8e-4 at 1,500; 2e-6 at the smoke's 12)."""
    pos = np.arange(n)
    got = TE.sinusoid(torch.from_numpy(pos), d).numpy()
    want = np.asarray(JE.sinusoid(jnp.asarray(pos), d))
    assert got.shape == want.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 + 2 * (n - 1) * 2.0 ** -24)


def test_encode_matches_jax():
    """The encoder (frames + sinusoid, two non-causal blocks, enc_norm)."""
    jm, jp, tm, tp = _pair(WHISPER, seed=1)
    frames = _x(1, (2, jm.cfg.n_frames, jm.cfg.d_model))
    want = JE.encode(jp, jm.cfg, jnp.asarray(frames))
    got = TE.encode(tp, tm.cfg, torch.from_numpy(frames))
    assert got.shape == (2, 12, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_project_cross_kv_matches_jax():
    """Every decoder layer's cross K/V, stacked (L, B, F, Hkv, hd)."""
    jm, jp, tm, tp = _pair(WHISPER, seed=2)
    mem = _x(2, (2, 12, 64))
    jk, jv = JE.project_cross_kv(jp, jm.cfg, jnp.asarray(mem))
    tk, tv = TE.project_cross_kv(tp, tm.cfg, torch.from_numpy(mem))
    assert tk.shape == tv.shape == (2, 2, 12, 4, 16)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("sq", [9, 1])
def test_cross_attention_matches_jax(sq, monkeypatch):
    """gqa_apply with kv_override at Sq > 1 (a prefill) and Sq = 1 (a
    decode step): one non-causal call of the attention seam over every
    encoder key, the cache passed through untouched."""
    jm, jp, tm, tp = _pair(WHISPER, seed=3)
    jl = jax.tree.map(lambda a: a[0], jp["dec"]["cross"])
    tl = {k: v[0] for k, v in tp["dec"]["cross"].items()}
    x, k, v = _x(3, (2, sq, 64)), _x(4, (2, 12, 4, 16)), _x(5, (2, 12, 4, 16))
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    sentinel = object()
    got, cache = TA.gqa_apply(tl, torch.from_numpy(x), tm.cfg,
                              positions=torch.arange(sq)[None],
                              cache=sentinel,
                              kv_override=(torch.from_numpy(k),
                                           torch.from_numpy(v)))
    want, _ = JA.gqa_apply(jl, jnp.asarray(x), jm.cfg,
                           positions=jnp.arange(sq)[None],
                           kv_override=(jnp.asarray(k), jnp.asarray(v)))
    assert cache is sentinel
    assert calls == [dict(causal=False, window=None, q_offset=0,
                          kv_valid_len=None)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_teacher_forced_forward_matches_jax(arch):
    """Model.forward: whisper's teacher-forced decoder (each layer's cross
    K/V projected from the memory; aux 0) and internvl2's patches before
    the tokens, every position's logits."""
    jm, jp, tm, tp = _pair(arch, seed=4)
    cfg = jm.cfg
    toks = np.random.default_rng(4).integers(0, 256, (2, 10)).astype(
        np.int32)
    batch = {"tokens": toks}
    if cfg.n_frames:
        batch["frames"] = _x(5, (2, cfg.n_frames, cfg.d_model))
    if cfg.n_patches:
        batch["patches"] = _x(6, (2, cfg.n_patches, cfg.d_model))
    jl, jaux = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, aux = tm.forward(tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert tl.shape == (2, 10 + cfg.n_patches, cfg.vocab_padded)
    assert aux.shape == () and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_teacher_forced_decoder_needs_the_memory():
    _, _, tm, tp = _pair(WHISPER)
    with pytest.raises(ValueError, match="encoder memory"):
        TE.decode_forward(tp, tm.cfg, torch.zeros((1, 3), dtype=torch.int64),
                          None)


def test_vlm_forward_without_patches_raises():
    """The JAX package's refusal (an assert there): a cache-less vlm
    forward needs its patches; a decode step (with a cache) does not."""
    _, _, tm, tp = _pair(VLM)
    with pytest.raises(ValueError, match="patch embeddings"):
        tm.forward(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_trees_carry_over_leaf_for_leaf(arch):
    """The bridge carries the enc-dec tree (embed, enc, enc_norm, dec,
    dec_norm, each block stacked on a leading layer axis) and the vlm tree
    (the decoder's plus patch_proj) leaf for leaf: structure, shapes,
    dtypes and bits; the port's own init has the same structure, shapes and
    dtypes."""
    jm, jp, tm, tp = _pair(arch, dtype="bfloat16")
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
    if arch == WHISPER:
        assert set(tp) == {"embed", "enc", "enc_norm", "dec", "dec_norm"}
        assert set(tp["dec"]) == {"norm1", "self", "norm_x", "cross",
                                  "norm2", "mlp"}
        assert tp["enc"]["attn"]["wq"].shape == (2, 64, 4, 16)
        assert tp["dec"]["mlp"]["wi"].shape == (2, 64, 128)
        assert "wg" not in tp["dec"]["mlp"]         # the plain GeLU MLP
    else:
        assert tp["patch_proj"].shape == (56, 56)
        assert tp["groups"][0]["mixer"]["wk"].shape == (3, 56, 1, 8)


def test_encdec_cache_is_written_in_place(monkeypatch):
    """whisper's cache: the self cache stacked (L, B, S, Hkv, hd) with one
    int pos, the cross K/V (L, B, F, Hkv, hd) in the cache's dtype; a
    prefill writes the caller's tensors (cross K/V whole, the self cache
    up to the prompt) and a decode step one more self slot, reading the
    cross K/V unchanged."""
    jm, jp, tm, tp = _pair(WHISPER, seed=5)
    cache = tm.init_cache(2, 10, dtype=torch.bfloat16, device="cpu")
    assert isinstance(cache, TE.EncDecCache)
    assert cache.self_kv.k.shape == (2, 2, 10, 4, 16)
    assert cache.cross_k.shape == (2, 2, 12, 4, 16)
    assert cache.self_kv.k.dtype == cache.cross_v.dtype == torch.bfloat16
    assert cache.self_kv.k.data_ptr() != cache.self_kv.v.data_ptr()
    assert cache.cross_k.data_ptr() != cache.cross_v.data_ptr()
    frames = torch.from_numpy(_x(6, (2, 12, 64)))
    toks = torch.ones((2, 6), dtype=torch.int64)
    _, out = tm.prefill(tp, toks, cache, frames=frames)
    assert out.self_kv.pos == 6 and cache.self_kv.pos == 0
    for a, b in ((out.self_kv.k, cache.self_kv.k), (out.cross_k,
                                                   cache.cross_k)):
        assert a is b
    assert cache.self_kv.k[:, :, :6].any() and \
        not cache.self_kv.k[:, :, 6:].any()
    mem = TE.encode(tp, tm.cfg, frames)
    ck, _ = TE.project_cross_kv(tp, tm.cfg, mem)
    assert torch.equal(cache.cross_k, ck.to(torch.bfloat16))
    held = cache.cross_k.clone()
    _, out = tm.decode(tp, torch.ones((2, 1), dtype=torch.int32), out)
    assert out.self_kv.pos == 7 and cache.self_kv.k[:, :, 6].any()
    assert torch.equal(cache.cross_k, held)
    with pytest.raises(ValueError, match="needs the frames"):
        tm.prefill(tp, toks, cache)


def test_vlm_cache_holds_the_patch_slots():
    """init_cache adds n_patches slots; a prefill of patches + S tokens
    leaves pos Np + S, and a decode step continues from there."""
    _, _, tm, tp = _pair(VLM, seed=6)
    cache = tm.init_cache(2, 10, dtype=torch.float32, device="cpu")
    assert cache["groups"][0].k.shape == (3, 2, 18, 1, 8)
    patches = torch.from_numpy(_x(7, (2, 8, 56)))
    _, out = tm.prefill(tp, torch.ones((2, 6), dtype=torch.int64), cache,
                        patches=patches)
    assert out["groups"][0].pos == 14
    _, out = tm.decode(tp, torch.ones((2, 1), dtype=torch.int32), out)
    assert out["groups"][0].pos == 15


@pytest.mark.parametrize("arch,prefill,step", [
    (WHISPER, [False] * 2 + [True, False] * 2, [False] * 2),
    (VLM, [True] * 3, [])])
def test_attention_seam_calls(arch, prefill, step, monkeypatch):
    """What the card launches: a whisper prefill calls the seam once for
    each encoder layer (non-causal), then per decoder layer its causal
    self-attention and its non-causal cross-attention; a decode step only
    the cross-attention (its self-attention reads the cache with
    attend_onepass). internvl2: one causal call a layer over patches +
    prompt, none in a decode step."""
    _, _, tm, tp = _pair(arch, seed=7)
    cfg = tm.cfg
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: (
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        or real(q, k, v, **kw)))
    kw = {}
    if cfg.n_frames:
        kw["frames"] = torch.from_numpy(_x(8, (2, cfg.n_frames,
                                               cfg.d_model)))
    if cfg.n_patches:
        kw["patches"] = torch.from_numpy(_x(8, (2, cfg.n_patches,
                                                cfg.d_model)))
    cache = tm.init_cache(2, 8, dtype=torch.float32, device="cpu")
    _, cache = tm.prefill(tp, torch.ones((2, 5), dtype=torch.int64), cache,
                          **kw)
    assert [c for c, _, _ in calls] == prefill
    if arch == WHISPER:
        assert calls[0][1:] == (12, 12) and calls[3][1:] == (5, 12)
    else:
        assert calls[0][1:] == (13, 16)       # 8 patch + 8 text slots
    calls.clear()
    tm.decode(tp, torch.ones((2, 1), dtype=torch.int32), cache)
    assert [c for c, _, _ in calls] == step
    assert all(c[1:] == (1, 12) for c in calls)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_step_builders_pass_the_stub_inputs(arch):
    """make_prefill_step hands frames (whisper) or patches (internvl2) to
    the prefill, so its logits equal Model.prefill's; make_serve_step then
    decodes from that cache."""
    _, _, tm, tp = _pair(arch, seed=8)
    cfg = tm.cfg
    name, n = ("frames", cfg.n_frames) if cfg.n_frames else \
        ("patches", cfg.n_patches)
    stub = {name: torch.from_numpy(_x(9, (2, n, cfg.d_model)))}
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 7)))
    want, _ = tm.prefill(tp, toks, tm.init_cache(
        2, 9, dtype=torch.float32, device="cpu"), **stub)
    got, cache = make_prefill_step(tm)(tp, tm.init_cache(
        2, 9, dtype=torch.float32, device="cpu"), toks, **stub)
    assert torch.equal(got, want)
    logits, _ = make_serve_step(tm)(tp, cache, torch.argmax(got, -1))
    assert logits.shape == got.shape and torch.isfinite(logits).all()
