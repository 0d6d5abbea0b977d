"""The port's training path on the CPU against the JAX package's.

``Model.loss`` and its gradients for every arch's smoke config (the port's
float32 params carried into the JAX package's tree) against
``jax.value_and_grad(model.loss)``; one ``make_train_step`` with
accum_steps 1 and 2 against the JAX package's step; remat on and off
giving the same gradients; ``launch.train.run`` on the CPU: a resume that
runs only the remaining steps, a torn checkpoint directory skipped for the
previous step, and the production meshes raising without their launch.
The JAX package's ``launch/train.run`` itself fails on the installed jax
(ROADMAP C), so the trainer is held by its behaviour and by these direct
calls.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.model import make_train_step as jmake_step  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.model import make_train_step, value_and_grad  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

ARCHS = tuple(jconfigs.all_arch_ids())
# float32 on both sides, sums in other orders through 2-3 layers and their
# backward: each grad leaf within 1e-4 of its largest |grad| (seen: 3e-6)
GRAD_RTOL = 1e-4


def _pair(arch, **over):
    """The JAX and port models of an arch's float32 smoke config and the
    port's params (drawn by the port) with their JAX twin (numpy leaves in
    the same tree)."""
    over = {"param_dtype": "float32", **over}
    jm = jbuild(dataclasses.replace(jconfigs.get_smoke(arch), **over))
    tm = tbuild(dataclasses.replace(tconfigs.get_smoke(arch), **over))
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    return jm, jp, tm, tp


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1                              # masked positions
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32), "labels": labels}
    if cfg.n_frames:
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(jm.cfg, 2, 16)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, _j(batch))
    tl, tparts, tg = value_and_grad(tm, tp, _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tparts[key]), float(jparts[key]),
                                   rtol=1e-5, atol=1e-7)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg) == len(paths)
    for path, a, w in zip(paths, tg, jleaves):
        w = np.asarray(w)
        assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
        np.testing.assert_allclose(
            a.numpy(), w, rtol=0, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-30),
            err_msg=path)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """One step of the danube smoke (float32, clipping on) against the JAX
    package's jitted step: the metrics within 1e-5 relative; the moments
    and params within what the step makes of grads that agree within
    GRAD_RTOL. The step's g (clipped) is mu / (1 - b1); each g within dg
    = GRAD_RTOL max |g| of the leaf moves mu by (1 - b1) dg and nu by (1 -
    b2)(2 |g| dg + dg^2). A first AdamW step moves a param by lr (g / (|g|
    + eps) + wd p): g / (|g| + eps) changes by at most dg eps / (|g| - dg
    + eps)^2 while the sign holds, by at most 2 when a g within dg of 0
    may take the other sign; and 1e-6 of the largest |p| for rounding."""
    jm, jp, tm, tp = _pair("h2o-danube-1.8b", accum_steps=accum)
    kw = dict(warmup_steps=1, decay_steps=4, weight_decay=0.1)
    jo, to = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    batch = _batch(jm.cfg, 4, 16, seed=accum)
    jp2, js2, jmet = jax.jit(jmake_step(jm, jo))(jp, jadamw.init(jo, jp),
                                                 _j(batch))
    tp2, ts2, tmet = make_train_step(tm, to)(tp, tadamw.init(to, tp),
                                             _t(batch))
    assert set(tmet) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, atol=1e-7)
    lr, eps = float(jmet["lr"]), jo.eps
    for p, m, v, tp_, tm_, tv_ in zip(
            jax.tree.leaves(jp2), jax.tree.leaves(js2.mu),
            jax.tree.leaves(js2.nu), tree.leaves(tp2), tree.leaves(ts2.mu),
            tree.leaves(ts2.nu)):
        p, m, v = (np.asarray(x, np.float64) for x in (p, m, v))
        g = np.abs(m / (1 - jo.b1))
        dg = GRAD_RTOL * g.max()
        assert np.all(np.abs(tm_.numpy() - m) <= (1 - jo.b1) * dg
                      + 1e-7 * np.abs(m).max())
        assert np.all(np.abs(tv_.numpy() - v) <= (1 - jo.b2) * (
            2 * g * dg + dg * dg) + 1e-7 * np.abs(v).max())
        move = np.minimum(2.0, dg * eps / (np.maximum(g - dg, 0) + eps) ** 2)
        assert np.all(np.abs(tp_.numpy() - p) <= lr * move
                      + 1e-6 * np.abs(p).max())


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-large-v3",
                                  "deepseek-v2-lite-16b"])
def test_remat_gives_the_same_gradients(arch):
    """cfg.remat recomputes each layer group (each enc-dec layer) in the
    backward: the attention runs twice there, and the gradients are the
    bits of a run without remat."""
    _, _, tm, tp = _pair(arch)
    off = tbuild(dataclasses.replace(tm.cfg, remat=False))
    batch = _t(_batch(tm.cfg, 2, 16))
    counts = []
    real = ops.flash_attention

    def count(*a, **kw):
        counts[-1] += 1
        return real(*a, **kw)
    ops.flash_attention = count
    try:
        counts.append(0)
        l_on, _, g_on = value_and_grad(tm, tp, batch)
        counts.append(0)
        l_off, _, g_off = value_and_grad(off, tp, batch)
    finally:
        ops.flash_attention = real
    assert counts[0] > counts[1] > 0
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_train_run_resumes_and_skips_a_torn_checkpoint(tmp_path, capsys):
    """``train.run`` on the CPU (the phi3 smoke): 6 steps with a checkpoint
    every 3, then --resume to 9 runs exactly 3 more; an uninterrupted
    9-step run's checkpoints without step 9 resume at 6 and give its last
    3 losses bit for bit; torn further (a stray .tmp_, a corrupted leaf in
    step 6) they resume at 3 and give its last 6."""
    kw = dict(arch="phi3-mini-3.8b", preset="smoke", batch=2, seq=16,
              ckpt_every=3, mesh_kind="test", log_every=100, device="cpu")
    first = train.run(steps=6, ckpt_dir=str(tmp_path / "a"), resume=False,
                      **kw)
    more = train.run(steps=9, ckpt_dir=str(tmp_path / "a"), resume=True,
                     **kw)
    assert len(first) == 6 and len(more) == 3
    assert "resumed from step 6" in capsys.readouterr().out
    whole = train.run(steps=9, ckpt_dir=str(tmp_path / "b"), resume=False,
                      **kw)
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "step_000000003", "step_000000006", "step_000000009"]
    shutil.copytree(tmp_path / "b", tmp_path / "c")
    shutil.rmtree(tmp_path / "c" / "step_000000009")
    assert train.run(steps=9, ckpt_dir=str(tmp_path / "c"), resume=True,
                     **kw) == whole[6:]
    (tmp_path / "c" / ".tmp_000000009").mkdir()
    leaf = tmp_path / "c" / "step_000000006" / "arr_00002.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    shutil.rmtree(tmp_path / "c" / "step_000000009")
    capsys.readouterr()
    assert train.run(steps=9, ckpt_dir=str(tmp_path / "c"), resume=True,
                     **kw) == whole[3:]
    out = capsys.readouterr().out
    assert "step 6 unusable (checksum mismatch" in out
    assert "resumed from step 3" in out


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-large-v3"])
def test_train_run_draws_stub_inputs(arch):
    """The vlm and enc-dec archs train with stub patches / frames drawn
    from the seed and the step: finite losses, the same from one seed."""
    a = train.run(arch, "smoke", 2, 2, 8, None, 0, False, device="cpu")
    b = train.run(arch, "smoke", 2, 2, 8, None, 0, False, device="cpu")
    assert a == b and all(np.isfinite(a))
    stub = train.stub_inputs(train.preset_config(arch, "smoke"), 2, 0, 1,
                             "cpu")
    assert set(stub) == ({"patches"} if arch == "internvl2-1b"
                         else {"frames"})
    assert all(v.dtype == torch.bfloat16 for v in stub.values())


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_unported_meshes_raise(mesh):
    """--mesh single / multi train on the production mesh (the sharded
    train step, tests/test_torch_sharded_train.py); without a process
    group of its 256 / 512 ranks the run raises launch.mesh's world-size
    error, naming the torchrun launch."""
    n = 256 if mesh == "single" else 512
    with pytest.raises(ValueError, match=f"needs {n} ranks.*torchrun "
                                         f"--nproc-per-node={n}"):
        train.run("phi3-mini-3.8b", "smoke", 1, 2, 8, None, 0, False,
                  mesh_kind=mesh, device="cpu")


def test_presets_match_jax():
    for arch in ("phi3-mini-3.8b", "h2o-danube-1.8b", "mamba2-1.3b"):
        for preset in ("smoke", "100m", "full"):
            t = train.preset_config(arch, preset)
            from repro.launch.train import preset_config as jpreset
            assert repr(t) == repr(jpreset(arch, preset))


def test_training_path_imports_no_jax():
    """Importing the training path leaves jax and repro out of
    sys.modules, in a fresh interpreter; ``python -m
    repro_torch.launch.train`` runs on the CPU when asked."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.launch.train, "
            "repro_torch.distributed.trainer, repro_torch.optim.adamw, "
            "repro_torch.checkpoint.manifest; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "mamba2-1.3b", "--steps", "2", "--batch",
                        "2", "--seq", "8", "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("[train] step") == 2
