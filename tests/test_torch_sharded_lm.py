"""The sharded LM (``sharding.constrain`` and tensor parallelism over
'model', batch parallelism over 'data') on the CPU, against the JAX
package's sharded LM.

Each run below is a smoke config in float32, its params drawn by the
port's init (seed 0) and its tokens (and frames or patches) by numpy;
both packages run the same numbers. The JAX runs come from two
subprocesses with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``:
every config's spec tree (``model.init``'s specs, through
``jax.eval_shape``, smoke and full) resolved on the production shape and
on a 2 x 2 grid; each run's prefill and 3 teacher-forced decode steps on a
``jax.sharding.Mesh`` of 2 x 2 host devices, whose axes are ``Auto``
(``jax.make_mesh`` makes ``Explicit`` ones on the installed jax, under
which the embedding gather raises), the params placed by
``shardings_tree``; and the danube smoke's block layout
(``NamedSharding.devices_indices_map``).

The port runs the same params (``bridge.lm_params_onto_mesh``) on 4
spawned gloo ranks, a 2 x 2 ('data', 'model') mesh, at the same time as
the JAX runs, and in one process. Bounds: logits within atol 1e-4 of the
JAX mesh run's and of the port's one-process run's (float32: the partial
sums over 'model' add in another order than one product), greedy tokens
equal. One spawn serves every multi-process check, under the group's
timeout and a join deadline. This module imports no JAX at its top: the
spawned ranks import it.
"""

import dataclasses
import hashlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config, get_smoke  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import (build_model, greedy,  # noqa: E402
                                      make_prefill_step, make_serve_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0             # a collective that waits longer fails a rank
JOIN_S = 240.0               # the ranks are killed after this
ATOL = 1e-4
STEPS = 3                    # teacher-forced decode steps after the prefill
B = 4
# each run: a smoke config in float32 (with overrides), its prompt length
RUNS = (
    dict(tag="danube", arch="h2o-danube-1.8b", S=8, over={}, layout=True),
    # (f) S = 7 does not divide by 'model': the residual stays whole
    dict(tag="danube_s7", arch="h2o-danube-1.8b", S=7, over={}),
    # (g) q split, kv replicated: whole GQA groups (4 q over 1 kv) ...
    dict(tag="kv1", arch="h2o-danube-1.8b", S=8, over={"n_kv_heads": 1}),
    # ... and groups cut by the split (6 q over 3 kv: heads 0-2 read 0,0,1)
    dict(tag="kv3", arch="h2o-danube-1.8b", S=8,
         over={"n_heads": 6, "n_kv_heads": 3, "head_dim": 16}),
    dict(tag="grok", arch="grok-1-314b", S=8, over={}),
    dict(tag="deepseek", arch="deepseek-v2-lite-16b", S=8, over={}),
    dict(tag="mamba2", arch="mamba2-1.3b", S=8, over={}),
    dict(tag="rgemma", arch="recurrentgemma-9b", S=8, over={}),
    dict(tag="whisper", arch="whisper-large-v3", S=8, over={}),
    # 7 q heads over 1 kv head: the attention replicated, the MLP split
    dict(tag="internvl", arch="internvl2-1b", S=8, over={}),
)
TAGS = [r["tag"] for r in RUNS]

JAX_RUN = r"""
import dataclasses, json, pickle, sys, types
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config, get_smoke, all_arch_ids
from repro.distributed import sharding as jsh
from repro.models.model import build_model, make_prefill_step, make_serve_step

io_dir, runs, steps, with_specs = sys.argv[1], json.loads(sys.argv[2]), int(
    sys.argv[3]), sys.argv[4] == "1"
grid = {"production": types.SimpleNamespace(shape={"data": 16, "model": 16}),
        "2x2": types.SimpleNamespace(shape={"data": 2, "model": 2})}
is_p = lambda x: isinstance(x, P)
enc = lambda e: list(e) if isinstance(e, tuple) else e
if with_specs:
    specs_out = {}
    for arch in all_arch_ids():
        for size, cfg in (("smoke", get_smoke(arch)),
                          ("full", get_config(arch))):
            box = {}
            def f(k):
                p, s = build_model(cfg).init(k)
                box["s"] = s
                return p
            shapes = jax.tree_util.tree_leaves(jax.eval_shape(
                f, jax.random.PRNGKey(0)))
            leaves = jax.tree_util.tree_flatten_with_path(box["s"],
                                                          is_leaf=is_p)[0]
            specs_out[f"{arch}/{size}"] = [dict(
                path=jax.tree_util.keystr(path), shape=list(sd.shape),
                spec=[enc(e) for e in spec],
                **{k: [enc(e) for e in jsh.resolve_spec(m, spec, sd.shape)]
                   for k, m in grid.items()}) for (path, spec), sd in
                zip(leaves, shapes)]
    json.dump(specs_out, open(f"{io_dir}/specs.json", "w"))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for run in runs:
    tag, s = run["tag"], run["S"]
    cfg = dataclasses.replace(get_smoke(run["arch"]), param_dtype="float32",
                              **run["over"])
    model = build_model(cfg)
    _, specs = model.init(jax.random.PRNGKey(0))
    with open(f"{io_dir}/{tag}.in.pkl", "rb") as fh:
        given = pickle.load(fh)
    params = jax.tree.map(jnp.asarray, given["params"])
    inputs = given["inputs"]
    b = inputs["tokens"].shape[0]
    sh = jsh.shardings_tree(mesh, params, specs)
    placed = jax.device_put(params, sh)
    cache = model.init_cache(b, s + steps, dtype=jnp.float32)
    stub = {k: jnp.asarray(v) for k, v in inputs.items() if k != "tokens"}
    tok = inputs["tokens"]
    with jsh.use_mesh(mesh):
        logits, cache = jax.jit(make_prefill_step(model))(
            placed, cache, jnp.asarray(tok[:, :s]), **stub)
        seen = [logits]
        serve = jax.jit(make_serve_step(model))
        for i in range(steps):
            logits, cache = serve(placed, cache,
                                  jnp.asarray(tok[:, s + i:s + i + 1]))
            seen.append(logits)
    layout = {}
    if run.get("layout"):
        for (path, leaf), ns in zip(
                jax.tree_util.tree_flatten_with_path(params)[0],
                jax.tree_util.tree_leaves(
                    sh, is_leaf=lambda x: isinstance(x, NamedSharding))):
            idx = ns.devices_indices_map(leaf.shape)
            layout[jax.tree_util.keystr(path)] = [
                [(sl.start or 0, leaf.shape[d] if sl.stop is None else
                  sl.stop) for d, sl in enumerate(idx[dev])]
                for dev in mesh.devices.flat]
    with open(f"{io_dir}/{tag}.jax.pkl", "wb") as fh:
        pickle.dump(dict(layout=layout, mesh=np.stack(
            [np.asarray(x[:, -1]) for x in seen])), fh)
"""


def _cfg(run):
    return dataclasses.replace(get_smoke(run["arch"]), param_dtype="float32",
                               **run["over"])


def _numpy(tree):
    """A param tree of tensors as numpy, None and the structure kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _write_inputs(io_dir: pathlib.Path, run) -> None:
    """The run's params (the port's init, float32, seed 0) and inputs
    (tokens, and frames or patches, from numpy seed 1), as numpy for both
    packages."""
    cfg = _cfg(run)
    rng = np.random.RandomState(1)
    inputs = {"tokens": rng.randint(0, cfg.vocab_size, (B, run["S"] + STEPS)
                                    ).astype(np.int32)}
    if cfg.enc_layers:
        inputs["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        inputs["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    with open(io_dir / f"{run['tag']}.in.pkl", "wb") as fh:
        pickle.dump(dict(params=_numpy(params), inputs=inputs), fh)


def _load(io_dir, tag, kind="in") -> dict:
    with open(pathlib.Path(io_dir) / f"{tag}.{kind}.pkl", "rb") as fh:
        return pickle.load(fh)


def _serve(model, params, ref, s: int) -> tuple[list, list]:
    """Prefill ``s`` tokens and STEPS teacher-forced decode steps: each
    step's last-position logits and greedy tokens (whole on every rank)."""
    tok = torch.from_numpy(ref["inputs"]["tokens"])
    stub = {k: torch.from_numpy(v) for k, v in ref["inputs"].items()
            if k != "tokens"}
    cache = model.init_cache(B, s + STEPS, dtype=torch.float32, device="cpu")
    logits, cache = make_prefill_step(model)(params, cache, tok[:, :s],
                                             **stub)
    seen, toks = [logits[:, -1]], [greedy(logits, model.cfg, B)]
    step = make_serve_step(model)
    for i in range(STEPS):
        logits, cache = step(params, cache, tok[:, s + i:s + i + 1])
        seen.append(logits[:, -1])
        toks.append(greedy(logits, model.cfg, B))
    return seen, toks


# ---------------------------------------------------------------------------
# ranks: one spawn of 4 for every multi-process check
# ---------------------------------------------------------------------------

def _constrain_round(mesh, rank: int) -> dict:
    """Every layout transition and fallback of ``constrain`` on the 2 x 2
    mesh, checked against the values each rank can compute for itself;
    the collectives each issued, by kind. Returns notes."""
    coll = sharding.collectives()
    d, m = mesh.get_coordinate()
    whole = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    mine = whole * (m + 1)            # a partial sum over 'model': 3 whole
    notes = {}

    def check(name, got, want, kinds):
        coll.reset()
        out = got()
        assert torch.equal(out, want), (name, out, want)
        notes[name] = sorted(coll.as_dict())
        assert notes[name] == kinds, (name, notes[name])
    with sharding.use_mesh(mesh):
        check("partial->replicated",
              lambda: sharding.constrain(mine, None, None,
                                         partial=L.MODEL),
              3 * whole, ["all_reduce"])
        check("partial->split",
              lambda: sharding.constrain(mine, L.MODEL, None,
                                         partial=L.MODEL),
              3 * whole[2 * m:2 * m + 2], ["reduce_scatter"])
        check("split->replicated",
              lambda: sharding.constrain(whole[:, 3 * m:3 * m + 3], None,
                                         None, have=(None, L.MODEL)),
              whole, ["all_gather"])
        check("replicated->split",
              lambda: sharding.constrain(whole, None, L.MODEL),
              whole[:, 3 * m:3 * m + 3], [])
        # an axis the mesh lacks is dropped: ('pod', 'data') is 'data'
        check("absent axis",
              lambda: sharding.constrain(whole, L.DATA, None),
              whole[2 * d:2 * d + 2], [])
        # a dim 'model' does not divide stays whole (a decode's S = 1);
        # its partial sum is all-reduced
        one = whole[:, None, :1].expand(4, 1, 2).contiguous()
        check("S = 1 stays whole",
              lambda: sharding.constrain(one * (m + 1), L.DATA, L.MODEL,
                                         None, partial=L.MODEL),
              3 * one[2 * d:2 * d + 2], ["all_reduce"])
        three = whole[:3]
        check("3 rows over 2",
              lambda: sharding.constrain(three, L.MODEL, None), three, [])
        check("unchanged",
              lambda: sharding.constrain(whole[2 * d:2 * d + 2], L.DATA,
                                         None, have=("data",)),
              whole[2 * d:2 * d + 2], [])
        # the last 'model' rank's rows reach both ranks of its group
        check("broadcast_from",
              lambda: sharding.broadcast_from(whole * m, L.MODEL, 1),
              whole, ["broadcast"])
        # greedy: the largest logit across the vocab blocks, the first of
        # equal ones; ties across the two blocks and inside one
        full = torch.zeros(4, 1, 8)
        full[0, 0, [1, 6]] = 5.0                  # tie across the blocks
        full[1, 0, [5, 7]] = 2.0                  # tie inside block 1
        full[2, 0, 3] = -1.0
        full[3] -= 1.0
        full[3, 0, 4] = 0.5
        local = full[2 * d:2 * d + 2, :, 4 * m:4 * m + 4]
        coll.reset()
        got = greedy(local, types.SimpleNamespace(vocab_padded=8), 4)
        want = torch.argmax(full, -1).to(torch.int32)
        assert torch.equal(got, want), (got, want)
        notes["greedy"] = coll.as_dict()
    return notes


def _rank(rank: int, world: int, init: str, io_dir: str, out: str) -> None:
    out = pathlib.Path(out)
    lmesh.init_shard_group(rank, world, init_method=init, device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        mesh = lmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
        notes = {"constrain": _constrain_round(mesh, rank)}
        res = {}
        for run in RUNS:
            tag, model = run["tag"], build_model(_cfg(run))
            ref = _load(io_dir, tag)
            local = bridge.lm_params_onto_mesh(
                ref["params"] if rank == 0 else None,
                model.specs() if rank == 0 else None, mesh, device="cpu")
            whole = bridge.lm_params_from_numpy(ref["params"], "cpu")
            with sharding.use_mesh(mesh):
                blocks = sharding.blocks_of(whole, model.specs())
            for (path, a), b in zip(T.leaves_with_paths(local),
                                    T.leaves(blocks)):
                assert torch.equal(a, b), (tag, path)
            if run.get("layout"):              # (c): held against JAX's map
                for path, x in T.leaves_with_paths(local):
                    res[f"block{path}"] = x.numpy()
            with sharding.use_mesh(mesh):
                sharding.collectives().reset()
                logits, toks = _serve(model, local, ref, run["S"])
                notes[f"{tag}.collectives"] = \
                    sharding.collectives().as_dict()
                res[f"{tag}.logits"] = torch.stack(logits).numpy()
                res[f"{tag}.tokens"] = torch.cat(toks, 1).numpy()
                if tag == "danube":
                    sharding.collectives().reset()
                    model.prefill(local, torch.from_numpy(
                        ref["inputs"]["tokens"][:, :run["S"]]),
                        model.init_cache(B, run["S"] + 1, torch.float32,
                                         "cpu"))
                    notes["danube.prefill"] = \
                        sharding.collectives().as_dict()
                    g = serve.generate(model, local, torch.from_numpy(
                        ref["inputs"]["tokens"][:, :run["S"]]), 4,
                        model.init_cache(B, run["S"] + 4, torch.float32,
                                         "cpu"))
                    res["generate.tokens"] = g.tokens.numpy()
        notes["coord"] = list(mesh.get_coordinate())
        np.savez(out / f"rank{rank}.npz", **res)
        (out / f"rank{rank}.json").write_text(json.dumps(notes))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the io directory, the 4 ranks' results, their notes). The inputs
    are written first; then the JAX runs (two subprocesses, the spec trees
    in the first) and the 4 spawned ranks go at once."""
    io_dir = tmp_path_factory.mktemp("sharded_lm")
    for run in RUNS:
        _write_inputs(io_dir, run)
    # XLA's CPU backend at its lowest optimisation level: the programs are
    # small, and compiling them is most of the JAX runs' time
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true"}
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_RUN, str(io_dir), json.dumps(part),
         str(STEPS), str(int(i == 0))], env=env, cwd=ROOT)
        for i, part in enumerate((RUNS[::2], RUNS[1::2]))]
    ctx = mp.get_context("spawn")
    init = f"file://{io_dir / 'store'}"
    procs = [ctx.Process(target=_rank, args=(r, 4, init, str(io_dir),
                                             str(io_dir)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [jp.wait(max(1.0, deadline - time.monotonic()))
                 for jp in jax_procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        for jp in jax_procs:
            if jp.poll() is None:
                jp.kill()
                jp.wait(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    assert codes == [0, 0], f"the JAX runs exited with {codes}"
    return (str(io_dir), [np.load(io_dir / f"rank{r}.npz") for r in range(4)],
            [json.loads((io_dir / f"rank{r}.json").read_text())
             for r in range(4)])


_ONE: dict = {}


def _one_process(io_dir, run):
    """The port's one-process run of ``run`` on the same params."""
    if run["tag"] not in _ONE:
        ref = _load(io_dir, run["tag"])
        model = build_model(_cfg(run))
        params = bridge.lm_params_from_numpy(ref["params"], "cpu")
        logits, toks = _serve(model, params, ref, run["S"])
        _ONE[run["tag"]] = (torch.stack(logits).numpy(),
                            torch.cat(toks, 1).numpy())
    return _ONE[run["tag"]]


def _assembled(results, notes, tag) -> np.ndarray:
    """The whole (steps, B, Vpad) logits from the 4 ranks' blocks, each
    placed at its mesh coordinate."""
    parts = {tuple(n["coord"]): r[f"{tag}.logits"] for r, n in
             zip(results, notes)}
    return np.concatenate([np.concatenate([parts[(i, j)] for j in range(2)],
                                          axis=2) for i in range(2)], axis=1)


# ---------------------------------------------------------------------------
# (a) the spec trees
# ---------------------------------------------------------------------------

def _spec_rows(specs, prefix=""):
    """(path, spec) of a spec tree in the JAX package's leaf order."""
    if specs is None:
        return []
    if isinstance(specs, sharding.P):
        return [(prefix, specs)]
    if isinstance(specs, dict):
        return [r for k in sorted(specs)
                for r in _spec_rows(specs[k], f"{prefix}[{k!r}]")]
    return [r for i, v in enumerate(specs)
            for r in _spec_rows(v, f"{prefix}[{i}]")]


def _plain(entries):
    return [list(e) if isinstance(e, tuple) else e for e in entries]


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", all_arch_ids())
def test_spec_tree_matches_jax(runs, arch, size):
    """Model.specs() against the JAX package's model.init(key)[1], leaf for
    leaf: the same paths, the same specs, and resolved on the production
    shape (16 x 16) and on 2 x 2 the same entries as JAX's resolve_spec;
    at the smoke size the port's init gives JAX's shapes."""
    want = json.loads((pathlib.Path(runs[0]) / "specs.json").read_text())[
        f"{arch}/{size}"]
    cfg = get_smoke(arch) if size == "smoke" else get_config(arch)
    got = _spec_rows(build_model(cfg).specs())
    assert [p for p, _ in got] == [w["path"] for w in want]
    grids = {"production": lmesh.production_shape(),
             "2x2": lmesh.MeshShape(("data", "model"), (2, 2))}
    for (path, spec), w in zip(got, want):
        assert _plain(spec) == w["spec"], path
        for name, grid in grids.items():
            assert _plain(sharding.resolve_entries(grid, spec, w["shape"])) \
                == w[name], (path, name)
    if size == "smoke":
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        assert [list(x.shape) for x in T.leaves(params)] == \
            [w["shape"] for w in want]


def test_fallbacks_resolve_as_jax_states_them():
    """The fallbacks the JAX package's docstring names: whisper's 20 heads
    at 'model' 8 and internvl's 14 replicate, the FFN stays split; a
    decode's S = 1 stays whole; an absent 'pod' is dropped."""
    grid = lmesh.MeshShape(("data", "model"), (1, 8))
    for arch, heads in (("whisper-large-v3", 20), ("internvl2-1b", 14)):
        cfg = get_config(arch)
        assert cfg.n_heads == heads
        assert sharding.resolve_entries(
            grid, A.gqa_specs()["wq"], (cfg.d_model, heads, cfg.hd)) == \
            sharding.P(None, None, None)
        assert sharding.resolve_entries(
            grid, L.mlp_specs(cfg.mlp_kind)["wi"], (cfg.d_model, cfg.d_ff)
        ) == sharding.P(None, "model")
    assert sharding.resolve_entries(grid, (L.DATA, L.MODEL, None),
                                    (4, 1, 2560)) == \
        sharding.P("data", None, None)


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.randn(2, 3, 4)
    with sharding.use_mesh(None):
        assert sharding.constrain(x, L.DATA, L.MODEL, None,
                                  partial=L.MODEL) is x
    assert sharding.constrain(x, L.DATA, None, L.MODEL) is x
    assert sharding.broadcast_from(x, L.MODEL, 1) is x
    assert torch.equal(greedy(x, build_model(get_smoke(
        "h2o-danube-1.8b")).cfg, 2), torch.argmax(x[:, -1:], -1).int())


# ---------------------------------------------------------------------------
# (b), (c): constrain's transitions, the blocks each rank holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "partial->replicated", "partial->split", "split->replicated",
    "replicated->split", "absent axis", "S = 1 stays whole", "3 rows over 2",
    "unchanged", "broadcast_from"])
def test_constrain_transitions(runs, name):
    """Checked on every rank inside the spawn (values each rank computes
    for itself); here, that every rank saw the same collectives."""
    _, _, notes = runs
    assert len({json.dumps(n["constrain"][name]) for n in notes}) == 1


def test_greedy_ties_across_vocab_blocks(runs):
    """Checked in the spawn against torch.argmax of the whole logits:
    ties across the two vocab blocks and inside one take the first index;
    one all_gather over 'model' of (value, index), one over 'data'."""
    _, _, notes = runs
    for n in notes:
        assert n["constrain"]["greedy"] == {
            "all_gather": {"calls": 2, "bytes": 2 * 2 * 2 * 8 + 4 * 4}}


def test_blocks_match_jax_named_sharding(runs):
    """Every rank's params from bridge.lm_params_onto_mesh equal
    sharding.blocks_of of the whole tree (every run, checked in the
    spawn); for the danube smoke, each rank's block of every leaf is the
    slice JAX's NamedSharding.devices_indices_map gives the rank's device
    (rank r at flat mesh position r)."""
    io_dir, results, _ = runs
    layout = _load(io_dir, "danube", "jax")["layout"]
    whole = dict(T.leaves_with_paths(
        bridge.lm_params_from_numpy(_load(io_dir, "danube")["params"],
                                    "cpu")))
    assert sorted(layout) == sorted(whole)
    for path, boxes in layout.items():
        for r, res in enumerate(results):
            want = whole[path][tuple(slice(*b) for b in boxes[r])]
            np.testing.assert_array_equal(res[f"block{path}"], want.numpy(),
                                          err_msg=f"{path} rank {r}")


# ---------------------------------------------------------------------------
# (d)-(g): the sharded runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS, ids=TAGS)
def test_sharded_run_matches_jax_and_one_process(runs, run):
    """Prefill and 3 teacher-forced decode steps on the 2 x 2 mesh: the
    assembled logits within 1e-4 of the JAX package's Auto-mesh run and of
    the port's one-process run over the real vocabulary; every rank's
    greedy tokens equal the one-process run's."""
    io_dir, results, notes = runs
    tag = run["tag"]
    cfg = _cfg(run)
    got = _assembled(results, notes, tag)[..., :cfg.vocab_size]
    one, one_toks = _one_process(io_dir, run)
    jax_mesh = _load(io_dir, tag, "jax")["mesh"][..., :cfg.vocab_size]
    np.testing.assert_allclose(got, jax_mesh, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, one[..., :cfg.vocab_size], rtol=0,
                               atol=ATOL)
    for r in results:
        np.testing.assert_array_equal(r[f"{tag}.tokens"], one_toks)


def test_generate_on_the_mesh(runs):
    """launch.serve.generate on every rank: the greedy tokens of a
    one-process generate, on every rank."""
    run = RUNS[0]
    ref = _load(runs[0], run["tag"])
    model = build_model(_cfg(run))
    params = bridge.lm_params_from_numpy(ref["params"], "cpu")
    tok = torch.from_numpy(ref["inputs"]["tokens"][:, :run["S"]])
    want = serve.generate(model, params, tok, 4, model.init_cache(
        B, run["S"] + 4, torch.float32, "cpu")).tokens.numpy()
    for r in runs[1]:
        np.testing.assert_array_equal(r["generate.tokens"], want)


@pytest.mark.parametrize("tag", ["danube", "danube_s7"])
def test_collectives_by_kind(runs, tag):
    """A run's collectives (prefill, 3 decode steps, each step's greedy)
    on every rank, by kind, against the reckoning: per layer of a prefill
    with S split (S = 8), 2 all_gathers and 2 reduce_scatters, plus the
    embedding's all_reduce and the last token's broadcast; with S whole
    (S = 7, and every decode step's S = 1) 2 all_reduces a layer plus the
    embedding's; each greedy 2 all_gathers (over 'model', over 'data')."""
    _, _, notes = runs
    n_layers = get_smoke("h2o-danube-1.8b").n_layers
    steps = STEPS + 1
    decode = STEPS * (2 * n_layers + 1)
    want = {"all_gather": 2 * steps, "all_reduce": decode}
    if tag == "danube":
        want["all_gather"] += 2 * n_layers
        want.update(reduce_scatter=2 * n_layers, broadcast=1)
        want["all_reduce"] += 1
    else:
        want["all_reduce"] += 2 * n_layers + 1
    for n in notes:
        got = {k: v["calls"] for k, v in n[f"{tag}.collectives"].items()}
        assert got == want, (got, want)
    for n in notes:
        assert {k: v["calls"] for k, v in n["danube.prefill"].items()} == {
            "all_gather": 2 * n_layers, "reduce_scatter": 2 * n_layers,
            "all_reduce": 1, "broadcast": 1}


# ---------------------------------------------------------------------------
# (h) the refusals; the single-card path
# ---------------------------------------------------------------------------

def test_refusals_name_roadmap_a6():
    """An MLA wq split mid-head, routed and shared experts split unlike,
    and a dim gathered over two axes at once raise naming A6 wherever
    they are met. (Training and retrieval on a mesh run since the sharded
    train step: ``tests/test_torch_sharded_train.py``.)"""
    mla = get_smoke("deepseek-v2-lite-16b")
    nope, rope = mla.head_dim, mla.qk_rope_dim
    with pytest.raises(NotImplementedError, match="A6"):
        A._mla_heads({"wq": torch.zeros(4, 3 * (nope + rope) // 2)}, mla,
                     nope, rope)
    with pytest.raises(NotImplementedError, match="A6"):
        sharding._single(("pod", "data"), "a gather")


def _digest(dtype: str) -> str:
    """The danube smoke's prefill of 8 tokens and 3 greedy decode steps
    with no mesh, on the CPU: every step's logits and the final cache."""
    cfg = dataclasses.replace(get_smoke("h2o-danube-1.8b"), param_dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 12, dtype=cfg.dtype, device="cpu")
    logits, cache = make_prefill_step(model)(params, cache, tokens)
    seen = [logits]
    step = make_serve_step(model)
    for _ in range(3):
        logits, cache = step(params, cache, logits.argmax(-1))
        seen.append(logits)
    h = hashlib.sha256()
    for x in seen:
        h.update(x.float().numpy().tobytes())
    for c in cache["groups"]:
        h.update(c.k.float().numpy().tobytes())
        h.update(c.v.float().numpy().tobytes())
    return h.hexdigest()


# the outputs of the commit before the sharded LM, on this path
PARENT_DIGESTS = {
    "bfloat16":
        "eb2b315b9404700a5be0e73558f59615436083bef532e6b2576aa6c958637800",
    "float32":
        "2a17d55e2d3fff7fed718f3a364c4791ed1e6c817cdafb3ad2759e4c577b721e"}


@pytest.mark.parametrize("dtype", sorted(PARENT_DIGESTS))
@pytest.mark.parametrize("inside", [False, True],
                         ids=["no-use_mesh", "use_mesh-None"])
def test_single_card_path_is_the_parent_commits(dtype, inside):
    """With no mesh, the danube smoke's prefill and decode give the parent
    commit's outputs bit for bit, inside use_mesh(None) and with no
    use_mesh at all."""
    if inside:
        with sharding.use_mesh(None):
            got = _digest(dtype)
    else:
        got = _digest(dtype)
    assert got == PARENT_DIGESTS[dtype]
