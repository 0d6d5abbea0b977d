"""The port's token batches (``repro_torch.data.synthetic.token_batch``) and
its numpy threefry (``repro_torch.data.prng``) bit for bit against the JAX
package's ``token_batch`` and ``jax.random`` (ROADMAP C8).

The bit layout of ``jax.random`` depends on ``jax_threefry_partitionable``;
the port copies the ``True`` layout, the installed jax's default. The
``partitionable`` fixture sets it to ``True`` through ``jax.config`` for
each test and puts the previous value back after.

C8's smallest input: vocab 32,000 at seq 2,048 (h2o-danube's), where
numpy's float32 pow flipped 4 tokens in 8 steps of 16 sequences; the port
computes the pow in float64 and rounds once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.data import prng  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


@pytest.fixture(autouse=True)
def partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("step", [0, 1, 13, 2 ** 32 - 1])
def test_keys_match_jax(seed, step):
    """PRNGKey, fold_in and split: the same uint32 words."""
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(key), prng.PRNGKey(seed))
    folded = jax.random.fold_in(key, step)
    mine = prng.fold_in(prng.PRNGKey(seed), step)
    assert np.array_equal(np.asarray(folded), mine)
    for num in (2, 3):
        assert np.array_equal(np.asarray(jax.random.split(folded, num)),
                              prng.split(mine, num))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 37), (16, 2049)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1e-6, 1.0)])
def test_bits_and_uniform_match_jax(shape, bounds):
    """random_bits and float32 uniform (bits and floats), over sizes that
    are odd, even and past 2^15 elements."""
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    mine = prng.fold_in(prng.PRNGKey(5), 3)
    assert np.array_equal(np.asarray(jax.random.bits(key, shape)),
                          prng.random_bits(mine, shape))
    lo, hi = bounds
    want = jax.random.uniform(key, shape, minval=lo, maxval=hi)
    got = prng.uniform(mine, shape, lo, hi)
    assert got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("vocab,seq,batch", [(1000, 8, 1), (512, 511, 64),
                                             (32_000, 2048, 16)])
@pytest.mark.parametrize("seed", [0, 3])
def test_token_batch_bitwise_vs_jax(vocab, seq, batch, seed):
    """Tokens and labels equal the JAX package's for several steps; C8's
    input (vocab 32,000, seq 2,048) over 8 steps of 16 sequences."""
    steps = range(8) if vocab == 32_000 else (0, 1, 9)
    for step in steps:
        cfg = synthetic.TokenDataConfig(vocab, seq, batch, seed=seed)
        jcfg = jsynthetic.TokenDataConfig(vocab, seq, batch, seed=seed)
        got, want = synthetic.token_batch(cfg, step), \
            jsynthetic.token_batch(jcfg, step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_c8_smallest_input():
    """ROADMAP C8's recorded case: the reference's tokens."""
    got = synthetic.token_batch(synthetic.TokenDataConfig(1000, 8, 1), 0)
    assert got["tokens"].tolist() == [[2, 2, 0, 0, 999, 999, 999, 13]]


def test_the_cast_saturates_like_xla():
    """A draw near minval gives ~1e30 before the cast: clipped at the last
    id, as XLA's saturating cast and the clip give."""
    cfg = synthetic.TokenDataConfig(vocab_size=7, seq_len=4096,
                                    global_batch=4, seed=2)
    tok = synthetic.token_batch(cfg, 0)["tokens"]
    assert int(tok.max()) == 6 and int(tok.min()) >= 0
    np.testing.assert_array_equal(tok.numpy(), np.asarray(
        jsynthetic.token_batch(jsynthetic.TokenDataConfig(7, 4096, 4,
                                                          seed=2), 0)
        ["tokens"]))
