"""The sharded train step (autograd through ``sharding.constrain``'s
collectives, the vocabulary-parallel loss, the sharded AdamW step) and
retrieval on a mesh, on the CPU, against the JAX package's sharded run.

Each run is one of ``test_torch_sharded_lm.RUNS`` (a smoke config in
float32, its params drawn by the port's init, seed 0) with a batch of 4
from numpy, a quarter of its labels set to -1. The JAX runs come from two
subprocesses with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``:
``jax.value_and_grad(model.loss, has_aux=True)`` of every run, one
``make_train_step`` (danube, accum_steps 2) and the grok run on a (2 pod
x 1 data x 2 model) mesh, each jitted under ``sharding.use_mesh`` of a
``jax.sharding.Mesh`` with ``Auto`` axes, the params placed by
``shardings_tree``.

The port runs the same numbers on 4 spawned gloo ranks, a 2 x 2 ('data',
'model') mesh and then a (2, 1, 2) ('pod', 'data', 'model') one, at the
same time as the JAX runs: each rank passes its param blocks
(``sharding.blocks_of``) and the whole batch, and its gradient blocks
are gathered whole (``sharding.gather_whole``). Bounds: the loss within
1e-5 of JAX's and of the port's one-process loss, each gradient leaf
within GRAD_RTOL of its largest |gradient| (float32: the partial sums
over 'model' and the batch add in other orders than one product; seen
up to 6e-6). The same spawn holds each transition's backward, the
checkpoint paths, a sharded resume and retrieval on the mesh. It imports
no JAX at its top: the spawned ranks import it.
"""

import dataclasses
import hashlib
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import manifest  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import (build_model, make_train_step,  # noqa: E402
                                      value_and_grad)
from repro_torch.optim import adamw  # noqa: E402
from test_torch_sharded_lm import RUNS, TAGS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0             # a collective that waits longer fails a rank
JOIN_S = 300.0               # the ranks are killed after this
B = 4
GRAD_RTOL = 1e-4             # a leaf's error over its largest |gradient|
LOSS_ATOL = 1e-5
STEP = dict(tag="step", arch="h2o-danube-1.8b", S=8,
            over={"accum_steps": 2})
POD = dict(tag="pod", arch="grok-1-314b", S=8, over={})
OPT = dict(warmup_steps=1, decay_steps=4, weight_decay=0.1)
RESUME = dict(arch="h2o-danube-1.8b", preset="smoke", batch=4, seq=8,
              ckpt_every=2, mesh_kind="test", log_every=100, device="cpu")

JAX_RUN = r"""
import dataclasses, json, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.distributed import sharding as jsh
from repro.models.model import build_model, make_train_step
from repro.optim import adamw

io_dir, runs, opt = sys.argv[1], json.loads(sys.argv[2]), json.loads(
    sys.argv[3])
devs = np.array(jax.devices())
for run in runs:
    mesh = Mesh(devs.reshape(2, 1, 2), ("pod", "data", "model")) \
        if run["tag"] == "pod" else Mesh(devs.reshape(2, 2),
                                         ("data", "model"))
    cfg = dataclasses.replace(get_smoke(run["arch"]), param_dtype="float32",
                              **run["over"])
    model = build_model(cfg)
    _, specs = model.init(jax.random.PRNGKey(0))
    with open(f"{io_dir}/{run['tag']}.in.pkl", "rb") as fh:
        given = pickle.load(fh)
    params = jax.tree.map(jnp.asarray, given["params"])
    batch = {k: jnp.asarray(v) for k, v in given["batch"].items()}
    placed = jax.device_put(params, jsh.shardings_tree(mesh, params, specs))
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    with jsh.use_mesh(mesh):
        if run["tag"] == "step":
            ocfg = adamw.AdamWConfig(**opt)
            p2, s2, met = jax.jit(make_train_step(model, ocfg))(
                placed, adamw.init(ocfg, placed), batch)
            out = dict(metrics={k: float(v) for k, v in met.items()},
                       params=leaves(p2), mu=leaves(s2.mu), nu=leaves(s2.nu))
        else:
            (loss, parts), grads = jax.jit(jax.value_and_grad(
                model.loss, has_aux=True))(placed, batch)
            out = dict(loss=float(loss), ce=float(parts["ce"]),
                       aux=float(parts["aux"]), grads=leaves(grads))
    with open(f"{io_dir}/{run['tag']}.jax.pkl", "wb") as fh:
        pickle.dump(out, fh)
"""


def _cfg(run):
    return dataclasses.replace(get_smoke(run["arch"]), param_dtype="float32",
                               **run["over"])


def _numpy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _write_inputs(io_dir: pathlib.Path, run) -> None:
    """The run's params (the port's init, float32, seed 0) and its batch
    (numpy seed 1: tokens, labels with a quarter set to -1, frames or
    patches), as numpy for both packages."""
    cfg = _cfg(run)
    rng = np.random.RandomState(1)
    s = run["S"]
    labels = rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels[rng.random_sample((B, s)) < 0.25] = -1
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, s)
                                   ).astype(np.int32), "labels": labels}
    if cfg.enc_layers:
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    with open(io_dir / f"{run['tag']}.in.pkl", "wb") as fh:
        pickle.dump(dict(params=_numpy(params), batch=batch), fh)


def _load(io_dir, tag, kind="in") -> dict:
    with open(pathlib.Path(io_dir) / f"{tag}.{kind}.pkl", "rb") as fh:
        return pickle.load(fh)


def _inputs(io_dir, run):
    """(model, whole params, batch) of a run, as the port takes them."""
    given = _load(io_dir, run["tag"])
    params = T.tree_map(torch.from_numpy, given["params"])
    return (build_model(_cfg(run)), params,
            {k: torch.from_numpy(v) for k, v in given["batch"].items()})


# ---------------------------------------------------------------------------
# ranks: one spawn of 4 for every multi-process check
# ---------------------------------------------------------------------------

def _transitions(mesh) -> dict:
    """Each layout transition's backward on the mesh, checked on every rank
    against the gradient of the gathered computation: a whole (4, 6)
    tensor X, a whole coefficient C, the loss sum(C Y) of the output Y in
    its layout (a rank's block for a split Y; for a replicated Y with
    whole cotangents the same loss on every rank; with partial ones, one
    rank's share of it). The gradient each rank gets is X's cotangent C in
    X's layout. Returns the collectives each backward issued, by kind."""
    d, m = mesh.get_coordinate()
    X = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    C = torch.linspace(-1.0, 2.0, 24).reshape(4, 6)
    rows, cols = slice(2 * m, 2 * m + 2), slice(3 * m, 3 * m + 3)
    notes = {}

    def check(name, x, fwd, loss_c, want):
        x = x.clone().requires_grad_(True)
        y = fwd(x)
        sharding.collectives().reset()
        torch.sum(loss_c * y).backward()
        assert torch.allclose(x.grad, want, atol=0, rtol=1e-6), \
            (name, x.grad, want)
        notes[name] = sharding.collectives().as_dict()

    share = C * (m + 1) / 3       # partial cotangents: their sum over m is C
    with sharding.use_mesh(mesh):
        con = sharding.constrain
        check("partial->replicated", X * (m + 1),
              lambda x: con(x, None, None, partial=L.MODEL), C, C)
        check("partial->split", X * (m + 1),
              lambda x: con(x, L.MODEL, None, partial=L.MODEL), C[rows], C)
        check("split->replicated", X[:, cols],
              lambda x: con(x, None, None, have=(None, L.MODEL)), C,
              C[:, cols])
        check("replicated->split", X,
              lambda x: con(x, None, L.MODEL), C[:, cols], C)
        check("partial->replicated, partial cotangents", X * (m + 1),
              lambda x: con(x, None, None, partial=L.MODEL,
                            grad_partial=L.MODEL), share, C)
        check("split->replicated, partial cotangents", X[:, cols],
              lambda x: con(x, None, None, have=(None, L.MODEL),
                            grad_partial=L.MODEL), share, C[:, cols])
        zero = torch.zeros_like(C)
        zero[:, cols] = C[:, cols]
        check("replicated->split, partial cotangents", X,
              lambda x: con(x, None, L.MODEL, grad_partial=L.MODEL),
              C[:, cols], zero)
        check("sum_grad", X, lambda x: sharding.sum_grad(x, L.MODEL), share,
              C)
        check("grad_once", X, lambda x: sharding.grad_once(x, L.MODEL), C,
              C if m == 0 else torch.zeros_like(C))
        check("broadcast_from", X * m,
              lambda x: sharding.broadcast_from(x, L.MODEL, 1), C,
              C if m == 1 else torch.zeros_like(C))
        check("psum over the batch", X * (d + 1),
              lambda x: sharding.psum(x, L.DATA), C, C)
    return notes


def _two_batch_axes(mesh3) -> dict:
    """On the (pod, data, model) mesh: the moves two batch axes at once
    need. ``block_of`` takes a rank's rows of a dim split over ('pod',
    'data') together (pod outermost); ``psum`` reduces over both in one
    group, its gradient passing through."""
    pod, _, m = mesh3.get_coordinate()
    X = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    with sharding.use_mesh(mesh3):
        assert torch.equal(sharding.block_of(X, sharding.P(L.DATA)),
                           X[2 * pod:2 * pod + 2])
        x = (X * (pod + 1)).requires_grad_(True)
        sharding.collectives().reset()
        y = sharding.psum(x, L.DATA)
        assert torch.equal(y, 3 * X)
        torch.sum(X * y).backward()
        assert torch.equal(x.grad, X)
        return sharding.collectives().as_dict()


def _gathered(tree, model, mesh) -> list:
    """Each leaf of a tree of blocks (params, grads or moments) whole."""
    lay = T.leaves(model.shardings(mesh))
    return [sharding.gather_whole(x, ns.spec).numpy()
            for x, ns in zip(T.leaves(tree), lay)]


def _grads(io_dir, run, mesh) -> dict:
    model, whole, batch = _inputs(io_dir, run)
    with sharding.use_mesh(mesh):
        local = sharding.blocks_of(whole, model.specs())
        sharding.collectives().reset()
        loss, parts, g = value_and_grad(model, local, batch)
        coll = sharding.collectives().as_dict()
        grads = _gathered(g, model, mesh)
    return dict(loss=float(loss), ce=float(parts["ce"]),
                aux=float(parts["aux"]), grads=grads, coll=coll)


def _backward_elsewhere(io_dir, mesh) -> None:
    """The danube run's backward from another thread, as autograd runs a
    card's backward on a device thread that ``use_mesh`` (thread-local)
    does not reach: remat's recompute must still run under the forward's
    mesh. Its gradients are the bits of the backward on this thread."""
    model, whole, batch = _inputs(io_dir, RUNS[0])
    with sharding.use_mesh(mesh):
        local = sharding.blocks_of(whole, model.specs())
        live = [p.detach().requires_grad_(True) for p in T.leaves(local)]
        loss, _ = model.loss(T.unflatten_like(local, live), batch)
        here = torch.autograd.grad(loss, live, retain_graph=True)
    got = {}
    t = threading.Thread(target=lambda: got.update(
        g=torch.autograd.grad(loss, live)))
    t.start()
    t.join()
    assert all(torch.equal(a, b) for a, b in zip(got["g"], here))


def _step(io_dir, mesh) -> dict:
    """One make_train_step of STEP on the mesh: its metrics (bits), the
    new params and moments gathered whole; the new state is saved as a
    sharded checkpoint (step 1 under ckpt_mesh)."""
    model, whole, batch = _inputs(io_dir, STEP)
    ocfg = adamw.AdamWConfig(**OPT)
    with sharding.use_mesh(mesh):
        local = sharding.blocks_of(whole, model.specs())
        p2, s2, met = make_train_step(model, ocfg)(
            local, adamw.init(ocfg, local), batch)
        out = dict(metrics={k: float(v) for k, v in met.items()},
                   bits={k: v.numpy().tobytes().hex() for k, v in
                         met.items()},
                   params=_gathered(p2, model, mesh),
                   mu=_gathered(s2.mu, model, mesh),
                   nu=_gathered(s2.nu, model, mesh))
        lay = model.shardings(mesh)
        manifest.save(pathlib.Path(io_dir) / "ckpt_mesh", 1,
                      {"p": p2, "o": s2}, config=model.cfg,
                      shardings={"p": lay, "o": adamw.AdamWState(
                          None, lay, lay)})
    return out


def _restore_one(io_dir, mesh) -> None:
    """The one-process checkpoint (ckpt_one, step 3) restored on the
    mesh: every rank's blocks equal blocks_of of the whole state, bit for
    bit."""
    model = build_model(_cfg(STEP))
    with open(pathlib.Path(io_dir) / "one_state.pkl", "rb") as fh:
        whole = T.tree_map(torch.from_numpy, pickle.load(fh))
    with sharding.use_mesh(mesh):
        lay = model.shardings(mesh)
        shard = {"p": lay, "o": adamw.AdamWState(None, lay, lay)}
        mine = {"p": sharding.blocks_of(whole["p"], model.specs()),
                "o": adamw.AdamWState(
                    whole["o"].step,
                    sharding.blocks_of(whole["o"].mu, model.specs()),
                    sharding.blocks_of(whole["o"].nu, model.specs()))}
        like = T.tree_map(torch.zeros_like, mine)
        got = manifest.restore(pathlib.Path(io_dir) / "ckpt_one", 3, like,
                               config=model.cfg, shardings=shard)
    for a, b in zip(T.leaves(got), T.leaves(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _resume(io_dir, mesh) -> dict:
    """launch.train.run on the mesh (the danube smoke, bf16): 4 steps with
    a checkpoint every 2; a copy of its checkpoints without step 4 resumed
    to 4. Returns both runs' losses."""
    root = pathlib.Path(io_dir)
    whole = train.run(steps=4, ckpt_dir=str(root / "run_a"), resume=False,
                      mesh=mesh, **RESUME)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.copytree(root / "run_a", root / "run_b")
        shutil.copytree(root / "run_a" / "step_000000004",
                        root / "run_a_step4")
        shutil.rmtree(root / "run_b" / "step_000000004")
    dist.barrier()
    resumed = train.run(steps=4, ckpt_dir=str(root / "run_b"), resume=True,
                        mesh=mesh, **RESUME)
    return dict(whole=whole, resumed=resumed)


def _retrieve(io_dir, mesh, rank) -> dict:
    """serve.generate with retrieval on the mesh (the danube run's params
    and prompt): every rank encodes its logits block, rank 0 (the origin)
    serves the queries from its engine, and checks its ids against
    engine.search of the queries."""
    from repro_torch.core import compact_index, engine
    from repro_torch.core.pipeline import StreamingScheduler, bucket_ladder
    from repro_torch.data.synthetic import clustered_vectors
    model, whole, batch = _inputs(io_dir, RUNS[0])
    sched = eng = None
    if rank == 0:
        x, _ = clustered_vectors(0, 2000, 32, 8)
        eng = engine.PIMCQGEngine.build(
            0, x, compact_index.IndexConfig(dim=32, n_clusters=8, degree=8,
                                            knn_k=16),
            engine.SearchConfig(nprobe=2, ef=16, k=4), n_shards=2,
            device="cpu")
        sched = StreamingScheduler(eng, buckets=bucket_ladder(B),
                                   fill_threshold=2, wait_limit_s=5e-3)
    with sharding.use_mesh(mesh):
        local = sharding.blocks_of(whole, model.specs())
        enc = serve.mean_pool_encoder(local, 32, vocab=model.cfg.vocab_padded)
        sharding.collectives().reset()
        out = serve.generate(model, local, batch["tokens"], 3,
                             model.init_cache(B, batch["tokens"].shape[1] + 3,
                                              torch.float32, "cpu"),
                             scheduler=sched, encoder=enc)
        coll = sharding.collectives().as_dict()
    if rank == 0:
        res, _ = eng.search(torch.from_numpy(out.queries))
        assert np.array_equal(out.report.ids, res.ids.numpy())
    return dict(ids=out.report.ids, queries=out.queries,
                tokens=out.tokens.numpy(), coll=coll)


def _rank(rank: int, world: int, init: str, io_dir: str) -> None:
    torch.set_num_threads(2)    # 4 ranks beside the JAX runs, tests beside
    lmesh.init_shard_group(rank, world, init_method=init, device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        mesh = lmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
        notes = {"coord": list(mesh.get_coordinate()),
                 "transitions": _transitions(mesh)}
        res = {tag: _grads(io_dir, run, mesh)
               for tag, run in zip(TAGS, RUNS)}
        _backward_elsewhere(io_dir, mesh)
        res["step"] = _step(io_dir, mesh)
        _restore_one(io_dir, mesh)
        res["resume"] = _resume(io_dir, mesh)
        res["retrieve"] = _retrieve(io_dir, mesh, rank)
        mesh3 = lmesh.make_mesh((2, 1, 2), ("pod", "data", "model"),
                                device="cpu")
        notes["two_batch_axes"] = _two_batch_axes(mesh3)
        res["pod"] = _grads(io_dir, POD, mesh3)
        with open(pathlib.Path(io_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(dict(res=res, notes=notes), fh)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the io directory, the 4 ranks' results). The inputs and a
    one-process checkpoint are written first; then the two JAX
    subprocesses and the 4 spawned ranks go at once."""
    io_dir = tmp_path_factory.mktemp("sharded_train")
    for run in (*RUNS, STEP, POD):
        _write_inputs(io_dir, run)
    model, whole, _ = _inputs(io_dir, STEP)
    gen = torch.Generator().manual_seed(5)
    state = {"p": whole, "o": adamw.AdamWState(
        torch.tensor(3, dtype=torch.int32),
        T.tree_map(lambda x: torch.randn(x.shape, generator=gen), whole),
        T.tree_map(lambda x: torch.rand(x.shape, generator=gen), whole))}
    manifest.save(io_dir / "ckpt_one", 3, state, config=model.cfg)
    with open(io_dir / "one_state.pkl", "wb") as fh:
        pickle.dump(T.tree_map(lambda t: t.numpy(), state), fh)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true"}
    jobs = [*RUNS, STEP, POD]
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_RUN, str(io_dir), json.dumps(part),
         json.dumps(OPT)], env=env, cwd=ROOT)
        for part in (jobs[::2], jobs[1::2])]
    ctx = mp.get_context("spawn")
    init = f"file://{io_dir / 'store'}"
    procs = [ctx.Process(target=_rank, args=(r, 4, init, str(io_dir)))
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
    ranks = []
    for r in range(4):
        with open(io_dir / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return str(io_dir), ranks


def _close(got: list, want: list, paths: list, what: str) -> None:
    """Each leaf within GRAD_RTOL of its largest |value|."""
    assert len(got) == len(want) == len(paths)
    for path, a, w in zip(paths, got, want):
        w = np.asarray(w)
        assert a.shape == w.shape, (what, path)
        np.testing.assert_allclose(
            a, w, rtol=0, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what} {path}")


_ONE: dict = {}


def _one_process(io_dir, run):
    """The port's one-process value_and_grad of a run."""
    if run["tag"] not in _ONE:
        model, whole, batch = _inputs(io_dir, run)
        loss, parts, g = value_and_grad(model, whole, batch)
        _ONE[run["tag"]] = (float(loss), {k: float(v) for k, v in
                                          parts.items()},
                            [x.numpy() for x in g],
                            [p for p, _ in T.leaves_with_paths(whole)])
    return _ONE[run["tag"]]


# ---------------------------------------------------------------------------
# the gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", [*RUNS, POD], ids=[*TAGS, "pod"])
def test_sharded_grads_match_jax_and_one_process(runs, run):
    """value_and_grad on the mesh (the 2 x 2 one; grok's "pod" run on the
    (2, 1, 2) one): the loss equal on every rank bit for bit and within
    LOSS_ATOL of the JAX package's sharded loss and of the one-process
    loss; each gradient leaf, gathered whole, within GRAD_RTOL of JAX's
    and of the one-process run's."""
    io_dir, ranks = runs
    tag = run["tag"]
    mine = [r["res"][tag] for r in ranks]
    assert len({m["loss"] for m in mine}) == 1, [m["loss"] for m in mine]
    got = mine[0]
    want = _load(io_dir, tag, "jax")
    loss, _, one, paths = _one_process(io_dir, run)
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL
    assert abs(got["loss"] - loss) <= LOSS_ATOL
    _close(got["grads"], want["grads"], paths, f"{tag} vs JAX")
    _close(got["grads"], one, paths, f"{tag} vs one process")


@pytest.mark.parametrize("tag", ["danube", "grok", "deepseek", "internvl",
                                 "pod"])
def test_vocab_parallel_loss_and_moe_aux(runs, tag):
    """The loss's parts on the mesh against the one-process Model.loss and
    JAX's: the vocabulary-parallel cross-entropy of the rank's logits
    block (grok's logit softcap and internvl's text-only slice before
    it), and the MoE layers' Switch loss with its means over the whole
    batch (grok, deepseek; and over ('pod', 'data') on the three-axis
    mesh), within 1e-6 relative."""
    io_dir, ranks = runs
    run = POD if tag == "pod" else RUNS[TAGS.index(tag)]
    _, parts, _, _ = _one_process(io_dir, run)
    want = _load(io_dir, tag, "jax")
    for r in ranks:
        got = r["res"][tag]
        for key in ("ce", "aux"):
            for ref in (parts[key], want[key]):
                assert abs(got[key] - ref) <= 1e-6 * max(abs(ref), 1.0), \
                    (key, got[key], ref)
    if tag in ("grok", "deepseek", "pod"):
        assert parts["aux"] > 0


def _moved(p, m, v, tp, tm, tv, jo, lr):
    """tests/test_torch_train.py's bounds on a first AdamW step from
    gradients within GRAD_RTOL of each other."""
    p, m, v = (np.asarray(x, np.float64) for x in (p, m, v))
    g = np.abs(m / (1 - jo["b1"]))
    dg = GRAD_RTOL * g.max()
    assert np.all(np.abs(tm - m) <= (1 - jo["b1"]) * dg
                  + 1e-7 * np.abs(m).max())
    assert np.all(np.abs(tv - v) <= (1 - jo["b2"]) * (2 * g * dg + dg * dg)
                  + 1e-7 * np.abs(v).max())
    move = np.minimum(2.0, dg * jo["eps"] / (np.maximum(g - dg, 0)
                                             + jo["eps"]) ** 2)
    assert np.all(np.abs(tp - p) <= lr * move + 1e-6 * np.abs(p).max())


def test_train_step_matches_jax(runs):
    """One make_train_step of the danube smoke (float32, accum_steps 2, a
    quarter of the labels -1) on the mesh: loss and grad_norm equal on
    every rank bit for bit and within 1e-5 relative of the JAX package's
    sharded step; the params and both moments, gathered whole, within the
    bounds tests/test_torch_train.py derives for a first step."""
    io_dir, ranks = runs
    steps = [r["res"]["step"] for r in ranks]
    assert len({json.dumps(s["bits"], sort_keys=True) for s in steps}) == 1
    got, want = steps[0], _load(io_dir, "step", "jax")
    assert set(got["metrics"]) == set(want["metrics"])
    for key, w in want["metrics"].items():
        assert abs(got["metrics"][key] - w) <= 1e-5 * abs(w) + 1e-7, key
    jo = dataclasses.asdict(adamw.AdamWConfig(**OPT))
    for p, m, v, tp, tm, tv in zip(want["params"], want["mu"], want["nu"],
                                   got["params"], got["mu"], got["nu"]):
        _moved(p, m, v, tp, tm, tv, jo, want["metrics"]["lr"])


def test_micro_batches_come_from_the_whole_batch(runs):
    """The accum-2 step's loss is the JAX package's, whose micro-batches are
    rows [0, 2) and [2, 4) of the whole batch, each split over 'data':
    the mean of the two one-process micro-batch losses. Rows taken
    otherwise (each rank's own rows, micro-batched) weigh the unevenly
    masked labels otherwise."""
    io_dir, ranks = runs
    model, whole, batch = _inputs(io_dir, STEP)
    halves = [float(model.loss(whole, {k: v[i:i + 2] for k, v in
                                       batch.items()})[0]) for i in (0, 2)]
    other = [float(model.loss(whole, {k: v[[i, i + 2]] for k, v in
                                      batch.items()})[0]) for i in (0, 1)]
    got = ranks[0]["res"]["step"]["metrics"]["loss"]
    assert abs(got - sum(halves) / 2) <= 1e-6
    assert abs(sum(other) / 2 - sum(halves) / 2) > 1e-3


# ---------------------------------------------------------------------------
# the transitions, the two batch axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "partial->replicated", "partial->split", "split->replicated",
    "replicated->split", "partial->replicated, partial cotangents",
    "split->replicated, partial cotangents",
    "replicated->split, partial cotangents", "sum_grad", "grad_once",
    "broadcast_from", "psum over the batch"])
def test_transition_backward(runs, name):
    """Each transition's backward (checked on every rank in the spawn
    against X's cotangent C in X's layout) issued its transpose: the
    collective of sharding.py's tables, the same on every rank."""
    _, ranks = runs
    want = {"partial->replicated": [], "partial->split": ["all_gather"],
            "split->replicated": [], "replicated->split": ["all_gather"],
            "partial->replicated, partial cotangents": ["all_reduce"],
            "split->replicated, partial cotangents": ["reduce_scatter"],
            "replicated->split, partial cotangents": [],
            "sum_grad": ["all_reduce"], "grad_once": [],
            "broadcast_from": [], "psum over the batch": []}[name]
    for r in ranks:
        assert sorted(r["notes"]["transitions"][name]) == want, \
            r["notes"]["transitions"][name]


def test_two_batch_axes_move_together(runs):
    """block_of splits a dim over ('pod', 'data') together and psum sums
    over both in one group (one all_reduce), on every rank of the (2, 1,
    2) mesh (checked in the spawn). A gather over both at once is still
    refused, naming A6."""
    _, ranks = runs
    for r in ranks:
        assert r["notes"]["two_batch_axes"] == {
            "all_reduce": {"calls": 1, "bytes": 4 * 6 * 4}}
    with pytest.raises(NotImplementedError, match="A6"):
        sharding._single(("pod", "data"), "a gather")


def test_collectives_of_a_sharded_step(runs):
    """The danube run's value_and_grad (S = 8 split over 'model', remat)
    by kind, against the reckoning: the forward's (embedding all_reduce,
    2 all_gathers and 2 reduce_scatters a layer, the head's all_gather,
    the loss's 3 all_reduces) and the remat recompute's (2 all_gathers
    and the attention's reduce_scatter a layer: the recompute stops at
    the last tensor the backward saved, before the MLP's); the backward's
    transposes (2 all_gathers and 2 reduce_scatters a layer, the head's
    reduce_scatter, the embedding slice's all_gather), the norms'
    gradients (2 all_reduces a layer, the final norm's), and each leaf's
    gradient all-reduced over 'data'."""
    _, ranks = runs
    cfg = get_smoke("h2o-danube-1.8b")
    n, leaves = cfg.n_layers, 12
    want = {"all_gather": 2 * n + 1 + 2 * n + 2 * n + 1,
            "reduce_scatter": 2 * n + n + 2 * n + 1,
            "all_reduce": 1 + 3 + 2 * n + 1 + leaves}
    for r in ranks:
        got = {k: v["calls"] for k, v in r["res"]["danube"]["coll"].items()}
        assert got == want, (got, want)


# ---------------------------------------------------------------------------
# checkpoints, resume
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_restores_in_one_process_and_jax(runs):
    """The step's new state, saved on the mesh (each leaf gathered whole,
    the origin writing), restores in one process into the whole tree bit
    for bit equal to the gathered state, and in the JAX package bit for
    bit the same; the files carry no trace of the mesh."""
    io_dir, ranks = runs
    import jax.numpy as jnp
    from repro.checkpoint import manifest as jmanifest
    from repro.optim import adamw as jadamw
    got = ranks[0]["res"]["step"]
    model, whole, _ = _inputs(io_dir, STEP)
    like = {"p": T.tree_map(torch.zeros_like, whole),
            "o": adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                                  T.tree_map(torch.zeros_like, whole),
                                  T.tree_map(torch.zeros_like, whole))}
    back = manifest.restore(pathlib.Path(io_dir) / "ckpt_mesh", 1, like,
                            config=model.cfg)
    assert int(back["o"].step) == 1
    for name, part in (("params", back["p"]), ("mu", back["o"].mu),
                       ("nu", back["o"].nu)):
        for a, b in zip(T.leaves(part), got[name]):
            assert np.array_equal(a.numpy(), b), name
    import repro.configs as jconfigs
    jcfg = dataclasses.replace(jconfigs.get_smoke(STEP["arch"]),
                               param_dtype="float32", **STEP["over"])
    jlike = {"p": T.tree_map(lambda t: jnp.asarray(t.numpy()), like["p"]),
             "o": jadamw.AdamWState(
                 jnp.zeros((), jnp.int32),
                 T.tree_map(lambda t: jnp.asarray(t.numpy()), like["p"]),
                 T.tree_map(lambda t: jnp.asarray(t.numpy()), like["p"]))}
    jback = jmanifest.restore(pathlib.Path(io_dir) / "ckpt_mesh", 1, jlike,
                              config=jcfg)
    import jax
    for a, b in zip(jax.tree.leaves(jback), T.leaves(back)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_backward_on_another_thread(runs):
    """The backward issued from a thread the mesh was not set on (a card's
    autograd device thread) gives the same gradients (checked in the
    spawn: remat's recompute re-enters the forward's mesh); here, that
    every rank got past it."""
    _, ranks = runs
    assert all("step" in r["res"] for r in ranks)


def test_one_process_checkpoint_restores_on_the_mesh(runs):
    """A checkpoint written in one process restores on the mesh: every
    rank's blocks bit for bit blocks_of the whole state (checked in the
    spawn; here, that every rank got there)."""
    _, ranks = runs
    assert all("step" in r["res"] for r in ranks)


def test_sharded_resume_equals_uninterrupted(runs):
    """launch.train.run on the mesh: a resume from step 2 gives the last 2
    losses of an uninterrupted 4-step run bit for bit, on every rank, and
    writes a step-4 checkpoint with the same bytes."""
    io_dir, ranks = runs
    for r in ranks:
        res = r["res"]["resume"]
        assert len(res["whole"]) == 4 and res["resumed"] == res["whole"][2:]
    a = pathlib.Path(io_dir) / "run_a_step4"
    b = pathlib.Path(io_dir) / "run_b" / "step_000000004"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        if name != "manifest.json":
            assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_train_on_the_mesh_matches_one_process(runs):
    """The same loop in one process: the sharded run's losses within 2e-2
    of it (bf16 params: the sharded sums round otherwise)."""
    _, ranks = runs
    one = train.run(steps=4, ckpt_dir=None, resume=False, **RESUME)
    got = ranks[0]["res"]["resume"]["whole"]
    assert np.allclose(got, one, rtol=0, atol=2e-2), (got, one)


# ---------------------------------------------------------------------------
# retrieval on the mesh
# ---------------------------------------------------------------------------

def test_retrieval_on_the_mesh(runs):
    """serve.generate with retrieval on the 2 x 2 mesh: the queries the
    ranks encoded (a vocabulary-parallel softmax, gathered over 'data')
    within 1e-5 of the one-process encoder's on the same logits, the
    same on every rank; the origin's ids equal engine.search of them
    (checked in the spawn) and reach every rank."""
    io_dir, ranks = runs
    model, whole, batch = _inputs(io_dir, RUNS[0])
    cache = model.init_cache(B, batch["tokens"].shape[1] + 3, torch.float32,
                             "cpu")
    logits, cache = model.prefill(whole, batch["tokens"], cache)
    tok = ranks[0]["res"]["retrieve"]["tokens"]
    logits, _ = model.decode(whole, torch.from_numpy(tok[:, :1]), cache)
    want = serve.mean_pool_encoder(whole, 32)(logits)
    for r in ranks:
        got = r["res"]["retrieve"]
        np.testing.assert_allclose(got["queries"], want, rtol=0, atol=1e-5)
        assert np.array_equal(got["ids"], ranks[0]["res"]["retrieve"]["ids"])
        assert np.array_equal(got["tokens"], tok)
        assert got["coll"]["broadcast_object"]["calls"] == 1


# ---------------------------------------------------------------------------
# the single-card path
# ---------------------------------------------------------------------------

def _train_digest(dtype: str) -> str:
    """Two steps of the danube smoke's make_train_step (accum_steps 2, a
    quarter of the labels -1) with no mesh, on the CPU: every metric, the
    params and both moments."""
    cfg = dataclasses.replace(get_smoke("h2o-danube-1.8b"), param_dtype=dtype,
                              accum_steps=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    ocfg = adamw.AdamWConfig(warmup_steps=2, decay_steps=4)
    opt = adamw.init(ocfg, params)
    step = make_train_step(model, ocfg)
    rng = np.random.default_rng(3)
    h = hashlib.sha256()
    for _ in range(2):
        labels = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int64)
        labels[rng.random((4, 8)) < 0.25] = -1
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 8))), "labels": torch.from_numpy(labels)}
        params, opt, m = step(params, opt, batch)
        for k in sorted(m):
            h.update(m[k].float().numpy().tobytes())
    for x in T.leaves((params, opt.mu, opt.nu)):
        h.update(x.float().numpy().tobytes())
    return h.hexdigest()


# the outputs of the commit before the sharded train step, on this path
PARENT_DIGESTS = {
    "bfloat16":
        "60b623626519d5abf5c11e08713324ccdd98850fca92530297ac0c2ebbde76eb",
    "float32":
        "f64dba79abcb666aa36329a87305cb1fb24b3da064007c58c5f1f1da44b83ca2"}


@pytest.mark.parametrize("dtype", sorted(PARENT_DIGESTS))
@pytest.mark.parametrize("inside", [False, True],
                         ids=["no-use_mesh", "use_mesh-None"])
def test_single_card_train_step_is_the_parent_commits(dtype, inside):
    """With no mesh, the danube smoke's train step gives the parent
    commit's outputs bit for bit, inside use_mesh(None) and with no
    use_mesh at all."""
    if inside:
        with sharding.use_mesh(None):
            got = _train_digest(dtype)
    else:
        got = _train_digest(dtype)
    assert got == PARENT_DIGESTS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_donated_update_is_the_same_bits(dtype):
    """adamw.update with donate writes the step into the given params and
    moments, a slice of the leading dim at a time: the bits of the
    update that returns new tensors, for leaves larger than a slice (cut
    into several), small ones and a 0-d one."""
    gen = torch.Generator().manual_seed(0)

    def draw(shape, fn=torch.randn):
        return fn(shape, generator=gen)
    big = (3, 1 << 23)
    params = {"big": draw(big).to(dtype), "rows": draw((600, 7)).to(dtype),
              "one": draw(()).to(dtype)}
    grads = T.tree_map(lambda x: draw(x.shape).to(dtype), params)
    cfg = adamw.AdamWConfig(warmup_steps=1)
    state = adamw.AdamWState(torch.tensor(2, dtype=torch.int32),
                             T.tree_map(lambda x: draw(x.shape), params),
                             T.tree_map(lambda x: draw(x.shape, torch.rand),
                                        params))
    want = adamw.update(cfg, grads, state, params)
    mine = (T.tree_map(torch.clone, params), adamw.AdamWState(
        state.step, T.tree_map(torch.clone, state.mu),
        T.tree_map(torch.clone, state.nu)))
    got = adamw.update(cfg, grads, mine[1], mine[0], donate=True)
    assert all(a is b for a, b in zip(T.leaves(got[0]), T.leaves(mine[0])))
    for a, b in zip(T.leaves((want[0], want[1].mu, want[1].nu)),
                    T.leaves((got[0], got[1].mu, got[1].nu))):
        assert torch.equal(a, b)


def test_mixed_ssd_split_refused_in_training():
    """An SSD block whose params split unlike over 'model' does not train
    (its cotangents would mix whole and partial sums): it raises naming
    A6 under autograd, and serves."""
    from repro_torch.models import ssm
    cfg = get_smoke("mamba2-1.3b")
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    block = p["groups"][0]["mixer"]
    mixed = dict(block, A_log=block["A_log"][..., :4])
    with torch.enable_grad():
        with pytest.raises(NotImplementedError, match="A6"):
            ssm.ssd_split(T.tree_map(lambda x: x[0], mixed), cfg)
    with torch.no_grad():
        assert ssm.ssd_split(T.tree_map(lambda x: x[0], mixed), cfg)
