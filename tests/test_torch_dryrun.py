"""The H100 dry-run's pieces on the CPU against the JAX package's.

``launch/shapes.py`` and ``launch/roofline.py`` against
``repro/launch/shapes.py`` and ``repro/launch/roofline.py``;
``launch/op_stats.py`` on tests/test_hlo_stats.py's three cases and a
collective; the ``AccountingMesh`` against a real 2 x 2 gloo mesh, kind by
kind and byte for byte, on the danube smoke config's prefill, decode step
and train step (4 spawned ranks); the same cells' argument bytes and
FLOPs against the JAX package's compiled programs (``memory_analysis``,
``hlo_stats.weighted_totals``) on a 2 x 2 ``jax.sharding.Mesh`` of host
devices, lowered in a subprocess (its axes are ``Auto``: ``jax.make_mesh``
makes ``Explicit`` ones on the installed jax, under which the reference's
``constrain`` raises); ``lower_anns``' argument bytes against
``footprint`` and against the JAX package's ``lower_anns`` at a small
scale; and ``dryrun.run_cell`` on one cell of each kind. Inputs come from
seeds; the JAX subprocess and the ranks run at once.
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import all_arch_ids, get_config, get_smoke  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import anns_step, dryrun, op_stats, roofline  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.models.model import (Model, build_model,  # noqa: E402
                                      make_train_step)
from repro_torch.optim import adamw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-1.8b"
B, SEQ = 4, 8                 # the cells' batch and tokens
GRID = (2, 2)                 # ('data', 'model')
TIMEOUT_S = 60.0
JOIN_S = 120.0
LONG = 20                     # past the danube smoke's 16-slot window
SMALL = dict(n=4096, dim=32, n_clusters=16, budget=256, degree=8,
             nprobe=4, ef=8, k=4, queries=16, max_iters=8)

JAX_RUN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.devices()                       # the backend starts with 4 devices
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.distributed import sharding as jsh
from repro.launch import anns_step as JA
from repro.launch import dryrun as JD
from repro.launch.hlo_stats import weighted_totals
from repro.models.model import (build_model, make_prefill_step,
                                make_serve_step, make_train_step)
from repro.optim import adamw

out_path, arch, b, s, small = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4]), json.loads(sys.argv[5])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
cfg = get_smoke(arch)
model = build_model(cfg)
box = {}
def init(k):
    p, sp = model.init(k)
    box["s"] = sp
    return p
rec = {}
def stats(lowered):
    c = lowered.compile()
    return dict(args=int(c.memory_analysis().argument_size_in_bytes),
                flops=float(weighted_totals(c.as_text()).flops))
sds = jax.ShapeDtypeStruct
with mesh, jsh.use_mesh(mesh):
    p_shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    p_sh = JD._shardings(mesh, p_shapes, box["s"])
    tok = sds((b, s), jnp.int32)
    tok_sh = NamedSharding(mesh, jsh.resolve_spec(mesh, P(("pod", "data")),
                                                   (b, s)))
    c_shapes = jax.eval_shape(lambda: model.init_cache(b, s,
                                                       dtype=jnp.bfloat16))
    c_sh = JD._shardings(mesh, c_shapes, JD._cache_specs(c_shapes))
    rec["prefill"] = stats(jax.jit(
        make_prefill_step(model), in_shardings=(p_sh, c_sh, tok_sh)).lower(
            p_shapes, c_shapes, tok))
    one = sds((b, 1), jnp.int32)
    one_sh = NamedSharding(mesh, jsh.resolve_spec(mesh, P(("pod", "data")),
                                                   (b, 1)))
    rec["decode"] = stats(jax.jit(
        make_serve_step(model), in_shardings=(p_sh, c_sh, one_sh)).lower(
            p_shapes, c_shapes, one))
    rec["pos_bytes"] = sum(x.size * x.dtype.itemsize
                           for x in jax.tree.leaves(c_shapes)
                           if x.dtype == jnp.int32)
    ocfg = adamw.AdamWConfig()
    o_shapes = jax.eval_shape(lambda p: adamw.init(ocfg, p), p_shapes)
    o_sh = JD._shardings(mesh, o_shapes,
                         adamw.AdamWState(P(), box["s"], box["s"]))
    batch = {"tokens": tok, "labels": tok}
    rec["train"] = stats(jax.jit(
        make_train_step(model, ocfg),
        in_shardings=(p_sh, o_sh, {"tokens": tok_sh, "labels": tok_sh})
    ).lower(p_shapes, o_shapes, batch))
for owner in (False, True):
    lowered, _ = JA.lower_anns(mesh, JA.AnnsScale(**small),
                               owner_rerank=owner)
    rec[f"anns_{int(owner)}"] = int(
        lowered.compile().memory_analysis().argument_size_in_bytes)
json.dump(rec, open(out_path, "w"))
"""


# ---------------------------------------------------------------------------
# the reference's shapes and roofline
# ---------------------------------------------------------------------------

def test_cells_and_input_specs_match_the_reference():
    """``CELLS``, ``cell_applicable`` and ``input_specs`` against the JAX
    package's for all 40 arch x shape pairs: names, shapes and types."""
    from repro.configs import get_config as jget
    from repro.launch import shapes as jshapes
    assert shapes.SHAPES == jshapes.SHAPES
    for name, cell in shapes.CELLS.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(
            jshapes.CELLS[name])
    n = 0
    for arch in all_arch_ids():
        for shape in shapes.SHAPES:
            cfg, jcfg = get_config(arch), jget(arch)
            assert shapes.cell_applicable(cfg, shape) == \
                jshapes.cell_applicable(jcfg, shape)
            got, want = shapes.input_specs(cfg, shape), \
                jshapes.input_specs(jcfg, shape)
            assert sorted(got) == sorted(want), (arch, shape)
            for k in got:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype)[6:] == str(want[k].dtype)
            n += 1
    assert n == 40


def test_roofline_terms_match_the_reference():
    """``RooflineTerms.as_dict()`` equals the JAX package's on the same
    numbers, the H100 constants of ``launch/mesh.py`` as denominators."""
    from repro.launch.roofline import RooflineTerms as JTerms
    for nums in ((3e15, 2e12, 5e9, 256, 1e16), (1e9, 7e12, 0.0, 1, 0.0),
                 (0.0, 0.0, 0.0, 512, 0.0)):
        kw = dict(flops=nums[0], hbm_bytes=nums[1], coll_bytes=nums[2],
                  chips=nums[3], peak_flops=lmesh.PEAK_FLOPS_BF16,
                  hbm_bw=lmesh.HBM_BW, link_bw=lmesh.ICI_BW,
                  model_flops=nums[4])
        assert roofline.RooflineTerms(**kw).as_dict() == \
            JTerms(**kw).as_dict()


# ---------------------------------------------------------------------------
# op_stats: tests/test_hlo_stats.py's cases on the port's counter
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def _body(x, w):
    return torch.tanh(x @ w)


def test_loop_of_layers_counts_each_layer():
    """A loop of 8 layers counts exactly 2 128 256 256 8 FLOPs: 8 times
    one layer's (the reference weights its scan by the trip count; a
    Python loop is seen once a layer)."""
    def loop(x, ws):
        for i in range(ws.shape[0]):
            x = _body(x, ws[i])
        return x
    one = op_stats.weighted_totals(_body, _meta(128, 256), _meta(256, 256))
    t = op_stats.weighted_totals(loop, _meta(128, 256), _meta(8, 256, 256))
    assert t.flops == 2.0 * 128 * 256 * 256 * 8 == 8 * one.flops


def test_nested_loops_multiply():
    """3 outer iterations of 5 inner layers and one outer product: 3 x 6
    products of 2 128 256 256."""
    def outer(x, ws_outer, ws_inner):
        for i in range(ws_outer.shape[0]):
            for j in range(ws_inner.shape[0]):
                x = _body(x, ws_inner[j])
            x = _body(x, ws_outer[i])
        return x
    t = op_stats.weighted_totals(outer, _meta(128, 256), _meta(3, 256, 256),
                                 _meta(5, 256, 256))
    assert t.flops == 2.0 * 128 * 256 * 256 * (3 * 6)


def test_bytes_reasonable_for_simple_matmul():
    """A 512^2 float32 product: two 1 MB operands and a 1 MB result."""
    a = _meta(512, 512)
    t = op_stats.weighted_totals(lambda x, y: x @ y, a, a)
    assert 3e6 <= t.bytes <= 7e6, t.bytes
    assert t.flops == 2.0 * 512 ** 3


def test_collective_accounting_all_reduce():
    """An all_reduce over 4 ranks of an accounting mesh counts the bytes
    of the tensor each rank holds after it, and a one-rank axis none."""
    mesh = S.AccountingMesh(("d", "m"), (4, 1), (2, 0))
    x = _meta(256)
    with S.use_mesh(mesh):
        t = op_stats.weighted_totals(lambda: S.psum(x, "d"))
        one = op_stats.weighted_totals(lambda: S.psum(x, "m"))
    assert t.coll_by_op == {"all_reduce": 1024.0} and t.coll_bytes == 1024
    assert t.coll_calls == {"all_reduce": 1}
    assert one.coll_bytes == 0.0
    assert S.axis_index("d", mesh) == 2


# ---------------------------------------------------------------------------
# the accounting mesh against a real gloo mesh and against the reference
# ---------------------------------------------------------------------------

def _model():
    return build_model(get_smoke(ARCH))


def _cells(model, params, tokens, device) -> dict:
    """The collectives of a prefill, a decode step and a train step on the
    current mesh, by kind, from this rank's blocks ``params`` (the whole
    ``tokens`` (B, S) int32, as every rank passes them)."""
    coll = S.collectives()
    out = {}
    cache = model.init_cache(B, SEQ + 1, dtype=torch.bfloat16, device=device)
    coll.reset()
    model.prefill(params, tokens, cache)
    out["prefill"] = coll.as_dict()
    coll.reset()
    model.decode(params, tokens[:, :1], cache)
    out["decode"] = coll.as_dict()
    cache = model.init_cache(B, SEQ + 2, dtype=torch.bfloat16, device=device,
                             seq_split=True)
    coll.reset()
    model.prefill(params, tokens, cache)
    out["prefill_seq"] = coll.as_dict()
    coll.reset()
    model.decode(params, tokens[:, :1], cache)
    out["decode_seq"] = coll.as_dict()
    ocfg = adamw.AdamWConfig()
    opt = adamw.init(ocfg, params)
    coll.reset()
    make_train_step(model, ocfg)(params, opt,
                                 {"tokens": tokens, "labels": tokens})
    out["train"] = coll.as_dict()
    fsdp = Model(model.cfg, fsdp=True)
    whole = fsdp.shapes() if device == "meta" else \
        fsdp.init(torch.Generator().manual_seed(0))
    blocks = S.blocks_of(whole, fsdp.specs())
    opt = adamw.init(ocfg, blocks)
    coll.reset()
    make_train_step(fsdp, ocfg)(blocks, opt,
                                {"tokens": tokens, "labels": tokens})
    out["train_fsdp"] = coll.as_dict()
    return out


def _fsdp_vs_plain(mesh) -> dict:
    """One train step of the danube smoke config in float32 from the same
    whole params, with and without FSDP on the 2 x 2 mesh: whether the
    losses are the same bits, and each new param's whole tensor (gathered
    from the rank's blocks) the same bits; the grad norms' relative
    difference (the squares summed over other blocks)."""
    cfg = dataclasses.replace(get_smoke(ARCH), param_dtype="float32")
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    ocfg = adamw.AdamWConfig()
    out = {}
    with S.use_mesh(mesh):
        for tag, model in (("plain", Model(cfg)),
                           ("fsdp", Model(cfg, fsdp=True))):
            whole = model.init(torch.Generator().manual_seed(0))
            specs = model.specs()
            blocks = S.blocks_of(whole, specs)
            new, _, met = make_train_step(model, ocfg)(
                blocks, adamw.init(ocfg, blocks), batch)
            shard = model.shardings(mesh)
            leaves = [S.gather_whole(x, ns.spec) for x, ns in zip(
                S.tree_flatten(new, is_leaf=lambda x: hasattr(x, "shape"))[0],
                S.tree_flatten(shard, is_leaf=lambda x: hasattr(
                    x, "placements"))[0])]
            out[tag] = (met, leaves)
    (mp, lp), (mf, lf) = out["plain"], out["fsdp"]
    return {"loss": bool(torch.equal(mp["loss"], mf["loss"])),
            "params": all(torch.equal(a, b) for a, b in zip(lp, lf)),
            "n_leaves": len(lp),
            "norm_rel": float((mp["grad_norm"] - mf["grad_norm"]).abs()
                              / mp["grad_norm"])}


def _seq_vs_heads(mesh) -> dict:
    """Prefills and 3 teacher-forced decode steps each of the danube smoke
    config in float32 (params and caches): the rank's logits block with
    the cache split on the sequence, with it split on heads, and the
    one-process run's block; the largest |diff| of the first two against
    the third over the cases. The cases (prefill tokens, cache slots):
    (``LONG``, LONG + 3), whose prefill of 20 tokens wraps the smoke's
    16-slot rolling window cache; (2, LONG + 3), where the second rank's
    slots of that cache hold no key yet; (2, 10), a cache shorter than
    the window (not rolling), the second rank's slots empty too."""
    model = build_model(dataclasses.replace(get_smoke(ARCH),
                                            param_dtype="float32"))
    whole = model.init(torch.Generator().manual_seed(0))
    with S.use_mesh(mesh):
        params = S.blocks_of(whole, model.specs())
    rng = np.random.RandomState(3)
    tok = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                       (B, LONG + 3)).astype(np.int32))
    d, m = mesh.get_coordinate()
    v = model.cfg.vocab_padded

    def run(p, cache, n0):
        rows = []
        logits, cache = model.prefill(p, tok[:, :n0], cache)
        rows.append(logits[:, -1])
        for i in range(3):
            logits, cache = model.decode(p, tok[:, n0 + i:n0 + i + 1],
                                         cache)
            rows.append(logits[:, -1])
        return torch.stack(rows)
    out = {"seq": 0.0, "heads": 0.0, "scale": math.inf}
    for n0, slots in ((LONG, LONG + 3), (2, LONG + 3), (2, 10)):
        one = run(whole, model.init_cache(B, slots, torch.float32, "cpu"),
                  n0)
        want = one[:, d * B // 2:(d + 1) * B // 2,
                   m * v // 2:(m + 1) * v // 2]
        with S.use_mesh(mesh):
            seq = run(params, model.init_cache(B, slots, torch.float32,
                                               "cpu", seq_split=True), n0)
            heads = run(params, model.init_cache(B, slots, torch.float32,
                                                 "cpu"), n0)
        out = {"seq": max(out["seq"], float((seq - want).abs().max())),
               "heads": max(out["heads"],
                            float((heads - want).abs().max())),
               "scale": min(out["scale"], float(want.abs().max()))}
    return out


def _rank(rank: int, world: int, init: str, out: str) -> None:
    lmesh.init_shard_group(rank, world, init_method=init, device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        mesh = lmesh.make_mesh(GRID, ("data", "model"), device="cpu")
        model = _model()
        whole = model.init(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.RandomState(1).randint(
            0, model.cfg.vocab_size, (B, SEQ)).astype(np.int32))
        with S.use_mesh(mesh):
            params = S.blocks_of(whole, model.specs())
            got = _cells(model, params, tokens, "cpu")
        got["coord"] = list(mesh.get_coordinate())
        got["seq_vs_heads"] = _seq_vs_heads(mesh)
        got["fsdp_vs_plain"] = _fsdp_vs_plain(mesh)
        pathlib.Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 4 gloo ranks' collectives, the JAX package's compiled cells),
    the ranks and the JAX subprocess started together."""
    io = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true"}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_RUN, str(io / "jax.json"), ARCH, str(B),
         str(SEQ), json.dumps(SMALL)], env=env, cwd=ROOT)
    ctx = mp.get_context("spawn")
    init = f"file://{io / 'store'}"
    procs = [ctx.Process(target=_rank, args=(r, 4, init, str(io)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        code = jax_proc.wait(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    assert code == 0, f"the JAX run exited with {code}"
    ranks = [json.loads((io / f"rank{r}.json").read_text())
             for r in range(4)]
    return ranks, json.loads((io / "jax.json").read_text())


def _accounted(coord) -> tuple[dict, dict]:
    """(the cells' collectives, each cell's op_stats totals and argument
    bytes) of the rank at ``coord`` of a 2 x 2 accounting mesh, on meta
    tensors."""
    model = _model()
    tokens = torch.empty((B, SEQ), dtype=torch.int32, device="meta")
    mesh = S.AccountingMesh(("data", "model"), GRID, coord)
    with S.use_mesh(mesh):
        params = S.blocks_of(model.shapes(), model.specs())
        colls = _cells(model, params, tokens, "meta")
        share = torch.empty(S.local_shape((B, SEQ), S.P(("pod", "data"))),
                            dtype=torch.int32, device="meta")
        cache = model.init_cache(B, SEQ, dtype=torch.bfloat16, device="meta")
        ocfg = adamw.AdamWConfig()
        opt = adamw.init(ocfg, params)
        one = torch.empty((B, 1), dtype=torch.int32, device="meta")
        one_share = torch.empty(S.local_shape((B, 1), S.P(("pod", "data"))),
                                dtype=torch.int32, device="meta")
        cells = {
            "prefill": (lambda: model.prefill(params, tokens, cache),
                        [params, cache, share]),
            "decode": (lambda: model.decode(params, one, cache),
                       [params, cache, one_share]),
            "train": (lambda: make_train_step(model, ocfg)(
                params, opt, {"tokens": tokens, "labels": tokens}),
                [params, opt, share, share]),
        }
        totals = {name: (op_stats.weighted_totals(fn),
                         dryrun.tree_bytes(args))
                  for name, (fn, args) in cells.items()}
    return colls, totals


def test_accounting_mesh_counts_what_a_gloo_mesh_counts(runs):
    """Each rank's collectives, kind by kind, calls and bytes, in a
    prefill, a decode step and a train step: the accounting mesh at the
    rank's coordinate (meta tensors, no processes) against the real 2 x 2
    gloo mesh (the same program on real blocks)."""
    ranks, _ = runs
    assert sorted(tuple(r["coord"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        got, _ = _accounted(tuple(r["coord"]))
        for cell in ("prefill", "decode", "prefill_seq", "decode_seq",
                     "train", "train_fsdp"):
            assert got[cell] == r[cell], (r["coord"], cell)
            assert got[cell], cell             # a 2 x 2 mesh communicates
        # the sequence-split decode: q, k and v heads gathered, a max and a
        # sum all_reduce of the partial softmax over 'model'
        assert sorted(got["decode_seq"]) == ["all_gather", "all_reduce"]
        # FSDP: each weight gathered over 'data' where read (and again in
        # remat's recompute), its gradient reduce-scattered onto the block
        for kind in ("all_gather", "reduce_scatter"):
            assert got["train_fsdp"][kind]["calls"] > got["train"][kind][
                "calls"]


def _flash_keys_all(model, cell: str) -> float:
    """The attention FLOPs the reference's blockwise scan computes beyond
    the kernel's visible keys, for one rank of the 2 x 2 mesh: the scan
    multiplies every (query, key) pair of the padded cache (QK^T and PV,
    2 (dk + dv) a pair, each rank its Hq / 2 heads and B / 2 rows), where
    ``kernels/cost.py`` counts the keys the mask leaves (the kernel skips
    masked tiles). A decode step reads the cache in one pass on both
    sides, so it adds nothing; a train step is not reckoned here."""
    cfg = model.cfg
    if cell != "prefill":
        return 0.0
    from repro_torch.kernels import cost
    hq = cfg.n_heads // GRID[1]
    d = cfg.hd
    blk = min(512, SEQ)
    pad = -(-SEQ // blk) * blk
    every = 2 * (B // GRID[0]) * hq * SEQ * pad * (d + d)
    keys, _ = cost.visible_keys(SEQ, SEQ, True, cfg.window, 0, SEQ)
    visible = 2 * (B // GRID[0]) * hq * (d + d) * keys
    return cfg.n_layers * (every - visible)


def test_argument_bytes_and_flops_match_the_reference(runs):
    """At the origin of the 2 x 2 mesh, for the danube smoke config: the
    argument bytes of a prefill, a decode step (bf16 caches) and a train
    step equal the JAX package's ``argument_size_in_bytes`` (whose caches
    also hold their int32 ``pos``, stacked with the layer groups, a Python
    int in the port: reckoned); the prefill's and the decode step's FLOPs (the
    port's matrix products and the kernel's count) equal the reference's
    dot FLOPs once the attention's masked pairs, which the reference's
    scan multiplies and the kernel skips, are added
    (``_flash_keys_all``). Both count 2 m n k a product, so the tolerance
    is a float64 sum's rounding: 1e-9 relative."""
    _, ref = runs
    model = _model()
    _, totals = _accounted((0, 0))
    for cell in ("prefill", "decode", "train"):
        t, args = totals[cell]
        extra = ref["pos_bytes"] if cell != "train" else 0
        assert args + extra == ref[cell]["args"], (cell, args, ref[cell])
    for cell in ("prefill", "decode"):
        t, _ = totals[cell]
        want = ref[cell]["flops"]
        got = t.flops + _flash_keys_all(model, cell)
        assert math.isclose(got, want, rel_tol=1e-9), (cell, got, want)


def test_lower_anns_argument_bytes_match_footprint_and_the_reference(runs):
    """``lower_anns``' argument bytes equal ``footprint()``'s total on both
    production meshes at the SIFT1B scale (the owner-computes rerank: a
    rank holds its DP block of the vectors), and equal the JAX package's
    ``lower_anns``' ``argument_size_in_bytes`` at a small scale on the 2 x
    2 mesh, less the array its jit prunes (the reference lowers the
    vectors as DP blocks with and without the owner rerank; the port's
    plain rerank reads them whole, so only the owner form compares)."""
    _, ref = runs
    for multi in (False, True):
        shape = lmesh.production_shape(multi_pod=multi)
        _, arg_bytes, s = anns_step.lower_anns(shape, owner_rerank=True)
        assert arg_bytes == anns_step.footprint(shape, s)["total"]
    small = anns_step.AnnsScale(**SMALL)
    grid = lmesh.MeshShape(("data", "model"), GRID)
    totals, arg_bytes, _ = anns_step.lower_anns(grid, small,
                                                owner_rerank=True)
    assert arg_bytes == anns_step.footprint(grid, small)["total"]
    # jax.jit drops an argument the program never reads (keep_unused is
    # False): the search reads no rho (the estimator's scale, used by the
    # build), so the reference's argument bytes are the rest
    placed, _ = anns_step.index_specs(small, GRID[1])
    rho = S.blocks_of(placed.arrays.rho, S.P("model", None),
                      S.AccountingMesh(("data", "model"), GRID))
    assert arg_bytes - rho.numel() * rho.element_size() == ref["anns_1"] \
        == ref["anns_0"]
    assert set(totals.coll_by_op) == {"broadcast", "all_gather",
                                      "all_reduce_min"}
    assert totals.kernels["beam_search"]["launches"] == 1


def test_fsdp_train_step_gives_the_plain_step_bit_for_bit(runs):
    """The FSDP layout (``sharding.fsdp_specs``: each weight also split
    over 'data', gathered where a layer reads it, through one all_gather a
    mesh axis for the two-axis entries) trains the same step as the plain
    layout on the 2 x 2 gloo mesh: the same loss bits and every new param
    the same bits (its gradient's two partial sums over 'data' add in the
    reduce_scatter as in the plain step's all_reduce); the grad norm sums
    its squares over other blocks, so it may move in its last bits."""
    ranks, _ = runs
    for r in ranks:
        c = r["fsdp_vs_plain"]
        assert c["n_leaves"] > 10
        assert c["loss"] and c["params"], (r["coord"], c)
        assert c["norm_rel"] <= 1e-6, (r["coord"], c)


def test_fsdp_specs_follow_the_reference_preferences():
    """``sharding.fsdp_specs`` on the production mesh: grok-1-314b's MoE
    expert stacks, over 256 MB a rank even split 256 ways, take ('model',
    'data') on their 'model' dim; other weights 'data' on a spare trailing
    dim; vectors stay as they are; the argument bytes a rank holds drop by
    the data axis' 16 for every weight so split."""
    from repro_torch.models.transformer import decoder_specs
    model = Model(get_config("grok-1-314b"), fsdp=True)
    mesh = S.AccountingMesh(("data", "model"), (16, 16))
    shapes = model.shapes()
    with S.use_mesh(mesh):
        got = S.tree_flatten(model.specs(), is_leaf=lambda x: isinstance(
            x, S.P))[0]
    base = S.tree_flatten(decoder_specs(model.cfg), is_leaf=lambda x:
                          isinstance(x, S.P))[0]
    leaves = S.tree_flatten(shapes, is_leaf=lambda x: hasattr(x, "shape"))[0]
    two = [g for g, t in zip(got, leaves) if ("model", "data") in g]
    assert two and all(t.numel() * t.element_size() / 256 > 256e6
                       for g, t in zip(got, leaves) if ("model", "data") in g)
    for g, b, t in zip(got, base, leaves):
        if t.dim() < 2:
            assert g == b
        else:
            assert g != b and sum(("data" in (e if isinstance(e, tuple)
                                              else (e,))) for e in g) == 1


def test_sequence_split_decode_matches_head_split_and_one_process(runs):
    """The decode over a cache split on the sequence over 'model' (the
    JAX package's decode layout: ``_cache_specs``; each rank's partial
    through ``ops.flash_attention``, combined by its logsumexp), after a
    prefill that wraps the rolling window cache and after prefills that
    leave the second rank no key (its weight 0): each rank's logits block
    within 1e-4
    of the one-process run's, as the head-split cache's is (float32: the
    partial softmaxes add in another order; tests/test_torch_sharded_lm.py
    holds the head-split decode against the JAX package's mesh run)."""
    ranks, _ = runs
    for r in ranks:
        c = r["seq_vs_heads"]
        assert c["scale"] > 0.1
        assert c["seq"] <= 1e-4 and c["heads"] <= 1e-4, (r["coord"], c)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_dryrun_cell_records(shape):
    """``run_cell`` of h2o-danube-1.8b (sliding-window attention is
    sub-quadratic: every shape runs) on the 16 x 16 mesh: a record counted
    from shapes (``measured`` false), the roofline's terms consistent with
    its counts; a full-attention arch (phi3-mini-3.8b) skips long_500k
    with the reference's reason."""
    rec = dryrun.run_cell(ARCH, shape, False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["measured"] is False
    r = rec["roofline"]
    assert r["flops"] == rec["ops"]["per_device_flops"] * 256
    assert r["step_time_s"] == max(r["t_compute_s"], r["t_memory_s"],
                                   r["t_collective_s"]) > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    if shape == "decode_32k":     # the seq-split cache's step: the kernel
        n_layers = get_config(ARCH).n_layers
        assert rec["ops"]["kernels"]["flash_attention"]["launches"] == \
            n_layers
    skip = dryrun.run_cell("phi3-mini-3.8b", "long_500k", False)
    assert skip["status"] == "skip" and "sub-quadratic" in skip["reason"]
