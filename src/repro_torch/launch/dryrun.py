"""The H100 dry-run: account every (arch x shape x mesh) cell on meta
tensors (counterpart of ``repro/launch/dryrun.py``, which lowers and
compiles each cell with XLA over 512 placeholder devices).

For each cell this makes the production mesh's shape, (16, 16) over
('data', 'model') or (2, 16, 16) over ('pod', 'data', 'model'), as an
``AccountingMesh`` (no processes) at the origin, or for a decode cell at
the last rank over 'model', which holds the newest slots, builds the rank's
params, optimizer state, cache and inputs as meta tensors (``Model.shapes``
and ``Model.specs`` through ``sharding.blocks_of``), runs the cell's step
(``make_train_step`` / ``Model.prefill`` / ``Model.decode``) once as that
rank under ``launch/op_stats.py``'s counter, and records:

  * memory: the argument bytes the rank holds (params, optimizer state,
    cache and its share of the inputs: the counterpart of XLA's
    ``argument_size_in_bytes``), the counted activation peak, and whether
    both fit the card's 80 GB,
  * the rank's FLOPs, HBM bytes and collective bytes by kind
    (``op_stats``: aten ops, the kernels by ``kernels/cost.py``, the
    collectives by ``distributed/sharding.py``'s counts),
  * the three roofline terms and the bottleneck (``launch/roofline.py``,
    on ``launch/mesh.py``'s H100 constants),
  * MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (serve) and the
    useful-compute ratio.

The counts are computed from shapes on the CPU: no time in a record is
measured. The layouts: the params' specs (the JAX package's), the batch
over ('pod', 'data'); a prefill's KV caches with their heads over 'model'
(``init_cache``), a decode cell's split on the SEQUENCE over 'model'
(``init_cache(..., seq_split=True)``: the reference's ``_cache_specs``;
each rank's partial through the kernel, combined by two all_reduces a
layer), every KV cache holding seq_len - 1 tokens (the step reads a full
cache; the reference's scan multiplies every slot whatever its pos), MLA's
latent cache, the recurrent states and an enc-dec cache in the port's own
layouts. Above ``FSDP_THRESHOLD_BYTES`` of params a model shard the
reference's FSDP layout (``Model(cfg, fsdp=True)``: ``sharding.fsdp_specs``,
each weight gathered over 'data' where a layer reads it, its gradient
reduce-scattered).

Usage (one JSON per cell in --out):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both [--out build/dryrun] [--only-missing]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from ..configs import all_arch_ids, get_config
from ..distributed import sharding as S
from ..models.attention import KVCache
from ..models.model import Model, make_train_step
from ..optim import adamw
from . import op_stats, roofline
from .mesh import HBM_BW, HBM_BYTES, ICI_BW, PEAK_FLOPS_BF16, \
    production_shape
from .shapes import CELLS, cell_applicable, input_specs

__all__ = ["FSDP_THRESHOLD_BYTES", "tree_bytes", "build_cell", "run_cell",
           "main"]

DP = ("pod", "data")
FSDP_THRESHOLD_BYTES = 8e9    # params a model shard above this -> FSDP


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (meta tensors too; other leaves, a
    cache's int pos, hold none)."""
    leaves, _ = S.tree_flatten(tree, is_leaf=lambda x: hasattr(x, "shape"))
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _param_bytes_per_model_shard(shapes, mesh) -> float:
    return tree_bytes(shapes) / S.axis_size("model", mesh)


def _input_share(inputs: dict, mesh) -> dict:
    """The rank's block of each input, its batch over ('pod', 'data'): the
    bytes its share of the inputs holds (the port's steps take the whole
    batch on every rank and read their rows of it)."""
    return {k: torch.empty(S.local_shape(v.shape, S.P(DP), mesh),
                           dtype=v.dtype, device="meta")
            for k, v in inputs.items()}


def _at_position(cache, pos: int):
    """The cache tree with each KV cache holding ``pos`` tokens (its
    tensors as they are): a decode cell's step reads a full cache."""
    if isinstance(cache, KVCache):
        return cache._replace(pos=pos)
    if isinstance(cache, dict):
        return {k: _at_position(v, pos) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_at_position(v, pos) for v in cache]
    if isinstance(cache, tuple) and hasattr(cache, "_replace"):
        return cache._replace(**{f: _at_position(getattr(cache, f), pos)
                                 for f in cache._fields})
    return cache


def build_cell(arch: str, shape: str, multi_pod: bool):
    """(the cell's step as a thunk on the rank's meta tensors, aux): the
    mesh, its argument bytes, MODEL_FLOPS and the param counts."""
    cfg = get_config(arch)
    cell = CELLS[shape]
    ms = production_shape(multi_pod=multi_pod)
    coord = None
    if cell.kind == "decode":       # the rank of the newest slots
        coord = [n - 1 if a == "model" else 0
                 for a, n in zip(ms.mesh_dim_names, ms.shape)]
    mesh = S.AccountingMesh(ms.mesh_dim_names, ms.shape, coord)
    fsdp = _param_bytes_per_model_shard(Model(cfg).shapes(), mesh) > \
        FSDP_THRESHOLD_BYTES
    model = Model(cfg, fsdp=fsdp)
    shapes = model.shapes()       # made here, outside the counted step
    inputs = input_specs(cfg, shape)
    with S.use_mesh(mesh):
        params = S.blocks_of(shapes, model.specs())
        args = [params, _input_share(inputs, mesh)]
        if cell.kind == "train":
            ocfg = adamw.AdamWConfig(
                moment_dtype="bfloat16" if cfg.param_count() > 2e11
                else "float32")
            opt = adamw.init(ocfg, params)
            args.append(opt)
            step = make_train_step(model, ocfg, donate=True)

            def fn():
                return step(params, opt, inputs)
            tokens = cell.global_batch * cell.seq_len
        else:
            cache = model.init_cache(cell.global_batch, cell.seq_len,
                                     dtype=torch.bfloat16, device="meta",
                                     seq_split=cell.kind == "decode")
            if cell.kind == "decode":
                cache = _at_position(cache, cell.seq_len - 1)
            args.append(cache)
            extras = {k: inputs[k] for k in ("frames", "patches")
                      if k in inputs}
            if cell.kind == "prefill":
                def fn():
                    return model.prefill(params, inputs["tokens"], cache,
                                         **extras)
                tokens = cell.global_batch * cell.seq_len
            else:
                def fn():
                    return model.decode(params, inputs["tokens"], cache)
                tokens = cell.global_batch
    n_active = cfg.active_param_count()
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n_active * tokens
    return fn, dict(mesh=mesh, arg_bytes=tree_bytes(args),
                    model_flops=model_flops, n_params=cfg.param_count(),
                    n_active=n_active, fsdp=fsdp)


def run_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    ok, reason = cell_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "status": "skip", "reason": reason}
    if not ok:
        return rec
    t0 = time.time()
    fn, aux = build_cell(arch, shape, multi_pod)
    t_build = time.time() - t0
    t0 = time.time()
    with S.use_mesh(aux["mesh"]):
        _, totals = op_stats.count(fn)
    t_count = time.time() - t0
    chips = aux["mesh"].size()
    terms = roofline.RooflineTerms(
        flops=totals.flops * chips, hbm_bytes=totals.bytes * chips,
        coll_bytes=totals.coll_bytes * chips, chips=chips,
        peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, link_bw=ICI_BW,
        model_flops=aux["model_flops"])
    peak = aux["arg_bytes"] + totals.activation_peak
    rec.update(
        status="ok",
        chips=chips,
        n_params=aux["n_params"],
        n_active=aux["n_active"],
        fsdp=aux["fsdp"],
        cache_layout=("GQA K/V sequence over 'model'"
                      if CELLS[shape].kind == "decode"
                      else "K/V heads over 'model'"),
        build_s=round(t_build, 2),
        count_s=round(t_count, 2),
        memory={"argument_size_in_bytes": aux["arg_bytes"],
                "activation_peak_bytes": totals.activation_peak,
                "fits_80gb": peak < HBM_BYTES},
        ops={"per_device_flops": totals.flops,
             "per_device_matmul_flops": totals.matmul_flops,
             "per_device_bytes": totals.bytes,
             "per_device_coll_bytes": totals.coll_bytes,
             "coll_by_op": totals.coll_by_op,
             "coll_calls": totals.coll_calls,
             "kernels": totals.kernels, "n_ops": totals.n_ops},
        roofline=terms.as_dict(),
        measured=False,
    )
    return rec


def _gb(rec: dict) -> float:
    return rec["memory"]["argument_size_in_bytes"] / 1e9


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--only-missing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(all_arch_ids()) if args.arch == "all" \
        else args.arch.split(",")
    shapes = list(CELLS) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                path = out / f"{arch}__{shape}__{mesh_name}.json"
                if args.only_missing and path.exists():
                    if json.loads(path.read_text()).get("status") in \
                            ("ok", "skip"):
                        continue
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mp)
                except Exception:                       # noqa: BLE001
                    n_err += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error",
                           "error": traceback.format_exc(limit=20)}
                rec["wall_s"] = round(time.time() - t0, 2)
                path.write_text(json.dumps(rec, indent=1, default=float))
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" tc={r['t_compute_s']:.3e}"
                             f" tm={r['t_memory_s']:.3e}"
                             f" tx={r['t_collective_s']:.3e}"
                             f" args={_gb(rec):.2f}GB")
                elif status == "error":
                    extra = " " + rec["error"].splitlines()[-1][:120]
                print(f"[{arch:22s}|{shape:11s}|{mesh_name}] {status}"
                      f" ({rec['wall_s']}s){extra}", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
