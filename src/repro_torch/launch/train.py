"""Training launcher: config -> params -> train_step -> checkpointed loop
(counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --preset smoke --steps 50 --ckpt-dir /tmp/ckpt [--resume]

Presets: smoke (the arch's reduced config), 100m (the ~100M end-to-end
example scale) and full (the arch's exact config; h2o-danube-1.8b trains
at full width on one H100). The loop runs on the card unless ``--device
cpu`` (``run(..., device="cpu")``) asks for the CPU.

Fault tolerance as in the JAX package: manifest checkpoints every
``--ckpt-every`` steps and at the end, through the async writer;
``--resume`` restores the newest usable step (a corrupt or torn directory
is skipped with a printed message and the previous one loads) and runs only
the remaining steps. Batches are ``data.synthetic.token_batch`` of (seed,
step); the vlm's patches and the enc-dec's frames are stubs drawn from the
seed and the step.

``--mesh test`` trains on one device. ``--mesh single`` and ``--mesh
multi`` train the LM sharded over the production mesh (``launch.mesh.
make_production_mesh``: (16, 16) over ('data', 'model'), or (2, 16, 16)
over ('pod', 'data', 'model')), one process a rank under torchrun:

    torchrun --nproc-per-node=256 -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --preset full --mesh single

Each rank draws the whole param tree from the seed, as the JAX run does,
and keeps its blocks (``sharding.blocks_of``); every rank reads the whole
batch of each step and the model takes its rows (``models/model.py``'s
docstring); checkpoints are gathered whole leaf by leaf and written by
the origin, and a resume restores each rank's blocks
(``checkpoint/manifest.py``). Without a process group of 256 (512) ranks
the run raises ``launch.mesh``'s error, naming the launch. ``run(...,
mesh=m)`` trains the same loop on any DeviceMesh ``m`` over the
initialised group (the tests' and the smoke's smaller meshes).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import time

import torch
import torch.distributed as dist

from ..checkpoint import manifest
from ..configs import get_config, get_smoke
from ..data.synthetic import TokenDataConfig, token_batch
from ..distributed.sharding import blocks_of, use_mesh
from ..models.model import build_model, make_train_step
from ..optim import adamw
from . import mesh as lmesh

__all__ = ["preset_config", "stub_inputs", "run", "main"]

def preset_config(arch: str, preset: str):
    if preset == "full":
        return get_config(arch)
    cfg = get_smoke(arch)
    if preset == "100m":
        cfg = dataclasses.replace(
            cfg, n_layers=max(cfg.n_layers, 8),
            d_model=512, d_ff=2048 if cfg.d_ff else 0,
            n_heads=8 if cfg.n_heads else 0,
            n_kv_heads=min(8, max(cfg.n_kv_heads, 1)) if cfg.n_heads else 0,
            vocab_size=32000)
    return cfg


def stub_inputs(cfg, batch: int, seed: int, step: int, device) -> dict:
    """The modality frontends' stub embeddings of one step, bf16 standard
    normals drawn from (seed, step): patches (B, n_patches, d) for a vlm,
    frames (B, n_frames, d) for an enc-dec config, {} for the others."""
    out = {}
    for key, n in (("patches", cfg.n_patches), ("frames", cfg.n_frames)):
        if n:
            gen = torch.Generator().manual_seed(
                (int(seed) * 1_000_003 + int(step)) % (1 << 63))
            out[key] = torch.randn((batch, n, cfg.d_model), generator=gen
                                   ).to(device=device, dtype=torch.bfloat16)
    return out


def _restore_latest(ckpt_dir: str, like, cfg, shardings=None, say=print):
    """(step, state) of the newest step under ckpt_dir that restores, or
    (0, None); each unusable step is reported and skipped."""
    root = pathlib.Path(ckpt_dir)
    steps = sorted((int(p.name.split("_")[1]) for p in root.glob("step_*")),
                   reverse=True) if root.exists() else []
    for latest in steps:
        try:
            state = manifest.restore(ckpt_dir, latest, like, config=cfg,
                                     shardings=shardings)
        except Exception as e:                          # noqa: BLE001
            say(f"[train] step {latest} unusable ({e}); falling back",
                flush=True)
            continue
        say(f"[train] resumed from step {latest}", flush=True)
        return latest, state
    return 0, None


def run(arch: str, preset: str, steps: int, batch: int, seq: int,
        ckpt_dir: str | None, ckpt_every: int, resume: bool,
        mesh_kind: str = "test", log_every: int = 10, seed: int = 0,
        device="cuda", mesh=None) -> list[float]:
    """Train ``steps`` steps (fewer after a resume) on ``device``;
    returns the loss of each step run. ``mesh_kind`` single or multi, or
    a DeviceMesh ``mesh``: every rank of the mesh calls it and trains its
    blocks (the module's docstring), on its own card under ``device``
    'cuda'; the origin alone prints and writes checkpoints."""
    if mesh_kind not in ("test", "single", "multi"):
        raise ValueError(f"unknown mesh {mesh_kind!r}: test, single or multi")
    if mesh is None and mesh_kind != "test":
        mesh = lmesh.make_production_mesh(multi_pod=mesh_kind == "multi",
                                          device=device)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training asks for a card and none is visible: "
                           "pass device='cpu' to run on the CPU")
    say = print
    if mesh is not None:
        device = lmesh.rank_device(dist.get_rank(), device)
        if int(mesh.mesh.reshape(-1)[0]) != dist.get_rank():
            def say(*args, **kw):
                pass
    cfg = preset_config(arch, preset)
    model = build_model(cfg)
    with use_mesh(mesh):
        params = model.init(torch.Generator(device=device).manual_seed(seed))
        shardings = None
        if mesh is not None:
            params = blocks_of(params, model.specs())
            lay = model.shardings(mesh)
            shardings = {"p": lay, "o": adamw.AdamWState(None, lay, lay)}
        ocfg = adamw.AdamWConfig(warmup_steps=min(100, steps // 10 + 1),
                                 decay_steps=steps)
        opt_state = adamw.init(ocfg, params)
        # a rank holds its blocks once: the step writes them in place
        step_fn = make_train_step(model, ocfg, donate=mesh is not None)

        start, writer = 0, None
        if ckpt_dir:
            writer = manifest.AsyncWriter(ckpt_dir, config=cfg)
            if resume:
                start, state = _restore_latest(
                    ckpt_dir, {"p": params, "o": opt_state}, cfg, shardings,
                    say)
                if state is not None:
                    params, opt_state = state["p"], state["o"]

        dcfg = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, seed=seed)
        t0 = time.time()
        losses = []
        for step in range(start, steps):
            b = {k: v.to(device) for k, v in token_batch(dcfg, step).items()}
            b.update(stub_inputs(cfg, batch, seed, step, device))
            params, opt_state, m = step_fn(params, opt_state, b)
            losses.append(float(m["loss"]))
            if step % log_every == 0 or step == steps - 1:
                dt = time.time() - t0
                tps = (step - start + 1) * batch * seq / max(dt, 1e-9)
                say(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                    f"lr {float(m['lr']):.2e} gnorm "
                    f"{float(m['grad_norm']):.3f} tok/s {tps:,.0f}",
                    flush=True)
            if writer and ckpt_every and (step + 1) % ckpt_every == 0:
                writer.save(step + 1, {"p": params, "o": opt_state},
                            extra={"loss": losses[-1]}, shardings=shardings)
        if writer:
            if losses:
                writer.save(steps, {"p": params, "o": opt_state},
                            extra={"loss": losses[-1]}, shardings=shardings)
            writer.wait()
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="test",
                    choices=["test", "single", "multi"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.mesh != "test":
        lmesh.init_from_env(args.device)     # torchrun's group, if any
    try:
        run(args.arch, args.preset, args.steps, args.batch, args.seq,
            args.ckpt_dir, args.ckpt_every, args.resume, args.mesh,
            device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
