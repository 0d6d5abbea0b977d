"""The port's AdamW (``repro_torch.optim.adamw``) and token batches
(``data.synthetic.token_batch``) on the CPU against the JAX package's.

AdamW: the same trees from numpy with a seed through ``adamw.update`` on
both sides, float32 params and a bf16 leaf, every schedule, clipping on and
off, several steps; the port's params and moments within 1e-6 (relative
to each leaf's largest value) of the JAX package's. The behaviours of
tests/test_optim_data.py run on the port. ``token_batch`` draws from a
``torch.Generator``, which cannot repeat ``jax.random``: its range,
determinism, label shift and its statistics (the rank-0 share of the Zipf
draw and the copy-motif rate) are held against the JAX package's draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import TokenDataConfig as JData  # noqa: E402
from repro.data.synthetic import token_batch as jtoken_batch  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.data.synthetic import TokenDataConfig, token_batch  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402


def _trees(seed):
    """A nested param tree (dicts, a list, a None slot, a bf16 leaf) and a
    gradient tree of its shapes, numpy."""
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"w": a(8, 16), "emb": a(32, 8),
              "blocks": [{"b": a(16), "k": a(4, 4)}, None],
              "b16": a(6, 5).astype(jnp.bfloat16)}
    grads = {"w": a(8, 16, scale=0.3), "emb": a(32, 8, scale=2.0),
             "blocks": [{"b": a(16, scale=0.1), "k": a(4, 4)}, None],
             "b16": a(6, 5).astype(jnp.bfloat16)}
    return params, grads


@pytest.mark.parametrize("schedule,clip,moment", [
    ("cosine", 1.0, "float32"), ("linear", 0.0, "float32"),
    ("const", 5.0, "float32"), ("cosine", 1.0, "bfloat16")])
def test_adamw_update_matches_jax(schedule, clip, moment):
    cfg_kw = dict(lr_peak=1e-2, lr_end=1e-3, warmup_steps=2, decay_steps=6,
                  weight_decay=0.05, clip_norm=clip, schedule=schedule,
                  moment_dtype=moment)
    jcfg, tcfg = JA.AdamWConfig(**cfg_kw), TA.AdamWConfig(**cfg_kw)
    params, _ = _trees(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.lm_params_from_numpy(params, "cpu")
    js, ts = JA.init(jcfg, jp), TA.init(tcfg, tp)
    for step in range(5):
        _, grads = _trees(step + 1)
        jp, js, jm = JA.update(jcfg, jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = TA.update(tcfg, bridge.lm_params_from_numpy(
            grads, "cpu"), ts, tp)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for j, t in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        jl, tl = jax.tree.leaves(j), tree.leaves(t)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert str(b.dtype)[6:] == str(np.asarray(a).dtype)
            a = np.asarray(a, np.float32)
            np.testing.assert_allclose(b.float().numpy(), a, rtol=0,
                                       atol=1e-6 * max(np.abs(a).max(), 1))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr_peak=1.0, lr_end=0.1, warmup_steps=10, decay_steps=100,
              schedule=schedule)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(
            float(TA.lr_at(TA.AdamWConfig(**kw), torch.tensor(s))),
            float(JA.lr_at(JA.AdamWConfig(**kw), jnp.int32(s))), rtol=1e-6)


def test_adamw_matches_numpy_reference():
    """tests/test_optim_data.py's numpy AdamW, on the port."""
    cfg = TA.AdamWConfig(lr_peak=1e-2, lr_end=1e-2, warmup_steps=0,
                         decay_steps=10, b1=0.9, b2=0.99, eps=1e-8,
                         weight_decay=0.01, clip_norm=0.0, schedule="const")
    p = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        5).astype(np.float32))}
    st = TA.init(cfg, p)
    pn = p["w"].numpy().astype(np.float64).copy()
    m = np.zeros(5)
    v = np.zeros(5)
    for t in range(1, 6):
        p, st, _ = TA.update(cfg, {"w": torch.ones(5) * 0.1 * t}, st, p)
        gn = np.ones(5) * 0.1 * t
        m = 0.9 * m + 0.1 * gn
        v = 0.99 * v + 0.01 * gn * gn
        mh, vh = m / (1 - 0.9 ** t), v / (1 - 0.99 ** t)
        pn = pn - 1e-2 * (mh / (np.sqrt(vh) + 1e-8) + 0.01 * pn)
    np.testing.assert_allclose(p["w"].numpy(), pn, rtol=2e-5)


def test_clip_norm_applies():
    cfg = TA.AdamWConfig(clip_norm=1.0, schedule="const", weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    _, _, metrics = TA.update(cfg, {"w": torch.ones(4) * 100.0},
                              TA.init(cfg, p), p)
    assert float(metrics["grad_norm"]) == 200.0


def test_schedule_shapes():
    cfg = TA.AdamWConfig(lr_peak=1.0, lr_end=0.1, warmup_steps=10,
                         decay_steps=100, schedule="cosine")
    lrs = [float(TA.lr_at(cfg, torch.tensor(s))) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 < lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-3


def test_update_leaves_its_inputs_and_keeps_types():
    """A functional step: the inputs are not written; params keep their
    types (bf16 stays bf16), moments take ``moment_dtype``."""
    params, grads = _trees(4)
    tp = bridge.lm_params_from_numpy(params, "cpu")
    tg = bridge.lm_params_from_numpy(grads, "cpu")
    cfg = TA.AdamWConfig(moment_dtype="bfloat16")
    st = TA.init(cfg, tp)
    before = [t.clone() for t in tree.leaves(tp)]
    new, st2, _ = TA.update(cfg, tg, st, tp)
    assert all(torch.equal(a, b) for a, b in zip(before, tree.leaves(tp)))
    assert int(st.step) == 0 and int(st2.step) == 1
    assert [t.dtype for t in tree.leaves(new)] == \
        [t.dtype for t in tree.leaves(tp)]
    assert {t.dtype for t in tree.leaves(st2.mu)} == {torch.bfloat16}
    assert new["blocks"][1] is None


def test_token_batch_deterministic_and_in_range():
    """tests/test_optim_data.py's checks, on the port."""
    cfg = TokenDataConfig(vocab_size=1000, seq_len=64, global_batch=4,
                          seed=3)
    b1, b2, b3 = token_batch(cfg, 7), token_batch(cfg, 7), token_batch(cfg, 8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].dtype == b1["labels"].dtype == torch.int32
    assert b1["tokens"].shape == (4, 64)
    assert int(b1["tokens"].max()) < 1000 and int(b1["tokens"].min()) >= 0
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    other = token_batch(TokenDataConfig(1000, 64, 4, seed=4), 7)
    assert not torch.equal(b1["tokens"], other["tokens"])


def _stats(seq: np.ndarray) -> tuple[float, float, float]:
    """(rank-0 share, share of the last id, share of positions >= 8 equal
    to the token 8 back)."""
    return (float((seq == 0).mean()), float((seq == seq.max()).mean()),
            float((seq[:, 8:] == seq[:, :-8]).mean()))


def test_token_batch_statistics_match_jax():
    """The same distribution as the JAX package's draws: Zipf(1.2) ranks by
    inverse CDF clipped to the vocabulary and 20% copies of the token 8
    back. Over 64 x 512 tokens a share's standard error is below 0.003;
    the shares agree within 0.02."""
    vocab = 512
    tcfg = TokenDataConfig(vocab_size=vocab, seq_len=511, global_batch=64,
                           seed=1)
    jcfg = JData(vocab_size=vocab, seq_len=511, global_batch=64, seed=1)
    tb, jb = token_batch(tcfg, 0), jtoken_batch(jcfg, 0)
    t = np.concatenate([tb["tokens"].numpy(), tb["labels"][:, -1:].numpy()],
                       axis=1)
    j = np.concatenate([np.asarray(jb["tokens"]),
                        np.asarray(jb["labels"])[:, -1:]], axis=1)
    assert t.max() <= vocab - 1 and j.max() <= vocab - 1
    for a, b in zip(_stats(t), _stats(j)):
        assert abs(a - b) <= 0.02, (_stats(t), _stats(j))
