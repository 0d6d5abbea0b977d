"""The port's manifest checkpoints (``repro_torch.checkpoint.manifest``)
on the CPU: tests/test_checkpoint.py's cases on the port, and checkpoints
that cross between the packages: a smoke model's params and AdamW state
written by the JAX package restore in the port bit for bit, and the
reverse, with the same leaf paths and config hash."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import manifest as jmanifest  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import manifest  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 16), generator=g),
        "b16": (torch.randn((4, 4), generator=g) * 3).bfloat16(),
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": {"m": torch.ones(3) * 0.25, "empty": torch.zeros((0, 4))},
        "layers": [torch.arange(6, dtype=torch.int64), None],
    }


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def test_save_restore_bit_identical(tmp_path):
    state = _state(0)
    manifest.save(tmp_path, 5, state, config={"a": 1})
    out = manifest.restore(tmp_path, 5, state, config={"a": 1})
    assert out["layers"][1] is None
    for a, b in zip(tree.leaves(state), tree.leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_latest_step_and_atomicity(tmp_path):
    state = _state(1)
    for s in (1, 3, 10):
        manifest.save(tmp_path, s, state)
    assert manifest.latest_step(tmp_path) == 10
    (tmp_path / ".tmp_000000099").mkdir()      # a torn write
    assert manifest.latest_step(tmp_path) == 10
    assert manifest.latest_step(tmp_path / "none") is None


def test_corruption_detected(tmp_path):
    state = _state(2)
    d = manifest.save(tmp_path, 1, state)
    target = d / "arr_00000.npy"
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 0xFF
    target.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        manifest.restore(tmp_path, 1, state)


def test_config_hash_mismatch_rejected(tmp_path):
    state = _state(3)
    manifest.save(tmp_path, 1, state, config={"lr": 1e-4})
    with pytest.raises(ValueError):
        manifest.restore(tmp_path, 1, state, config={"lr": 5e-4})


def test_shape_and_count_mismatch_rejected(tmp_path):
    state = _state(5)
    manifest.save(tmp_path, 1, state)
    bad = dict(state, w=torch.zeros((8, 15)))
    with pytest.raises(ValueError, match="shape"):
        manifest.restore(tmp_path, 1, bad)
    with pytest.raises(ValueError, match="leaf count"):
        manifest.restore(tmp_path, 1, {"w": state["w"]})


def test_async_writer_overlap(tmp_path):
    w = manifest.AsyncWriter(str(tmp_path))
    state = _state(4)
    before = state["w"].clone()
    w.save(1, state)
    state["w"].add_(1.0)             # the snapshot was taken at save()
    w.save(2, state)                 # waits for 1, then fires 2
    w.wait()
    assert manifest.latest_step(tmp_path) == 2
    assert torch.equal(manifest.restore(tmp_path, 1, state)["w"], before)
    assert torch.equal(manifest.restore(tmp_path, 2, state)["w"],
                       state["w"])


def _jax_pair(arch, seed=0):
    """A smoke model's params and a two-step AdamW state, on both sides
    (the port's through the bridge)."""
    jm = jbuild(jconfigs.get_smoke(arch))
    jp = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(seed))
    ocfg = jadamw.AdamWConfig()

    @jax.jit
    def two_steps(p):
        s = jadamw.init(ocfg, p)
        g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.01, p)
        for _ in range(2):
            p, s, _ = jadamw.update(ocfg, g, s, p)
        return p, s
    jp, js = two_steps(jp)
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = bridge.adamw_state_from_numpy(
        np.asarray(js.step), jax.tree.map(np.asarray, js.mu),
        jax.tree.map(np.asarray, js.nu), "cpu")
    return {"p": jp, "o": js}, {"p": tp, "o": ts}


def _same_bits(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert str(b.dtype)[6:] == str(a.dtype) and a.shape == b.shape
        assert bytes(a.reshape(-1).view(np.uint8)) == \
            bytes(_bits(b).numpy())


def test_checkpoints_cross_between_the_packages(tmp_path):
    """JAX writes, the port restores (into the port's own tree), and the
    port writes, JAX restores: bit for bit both ways, on the deepseek smoke
    (a dense prefix layer, stacked MLA / MoE groups, bf16 params, float32
    moments, an int32 step); the manifests list the same leaf paths,
    entries and config hash."""
    arch = "deepseek-v2-lite-16b"
    jstate, tstate = _jax_pair(arch)
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    assert manifest.config_hash(tcfg) == jmanifest.config_hash(jcfg)
    jmanifest.save(tmp_path / "j", 2, jstate, config=jcfg)
    manifest.save(tmp_path / "t", 2, tstate, config=tcfg)
    mj = json.loads((tmp_path / "j" / "step_000000002" /
                     "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "step_000000002" /
                     "manifest.json").read_text())
    assert mj["paths"] == mt["paths"] and mj["index"] == mt["index"]
    assert mj["config_hash"] == mt["config_hash"]
    zeros = tree.tree_map(torch.zeros_like, tstate)
    got = manifest.restore(tmp_path / "j", 2, zeros, config=tcfg)
    assert isinstance(got["o"], tadamw.AdamWState)
    _same_bits(jstate, got)
    back = jmanifest.restore(tmp_path / "t", 2, jstate, config=jcfg)
    _same_bits(back, tstate)


def test_model_config_hashes_agree():
    """The two packages' ModelConfig reprs (and so their hashes) are equal
    for the smoke and full configs of every arch."""
    for arch in jconfigs.all_arch_ids():
        for get in ("get_smoke", "get_config"):
            j = getattr(jconfigs, get)(arch)
            t = getattr(tconfigs, get)(arch)
            assert manifest.config_hash(t) == jmanifest.config_hash(j), \
                (arch, get)
