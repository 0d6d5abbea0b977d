"""The port's data-parallel trainer and gradient compression
(``repro_torch.distributed.trainer`` / ``compress``) on the CPU.

``quantize_int8`` against the JAX package's bit for bit; the error
feedback's residual; the DP step at world size 1 (an in-process gloo
group) against the JAX package's ``make_dp_train_step`` on a one-device
mesh; two spawned gloo ranks against the port's ``make_train_step`` on the
whole batch (tests/test_distributed.py's tolerance, 5e-2) with their
params equal bit for bit; the hierarchical ('pod', 'data') step at (1, 1)
against the JAX package's, and on four spawned ranks (2 pod x 2 data)
against ``make_train_step`` on the whole batch.

A first AdamW step moves each param by about lr whatever its gradient, so
the params cannot show a wrong reduction; the first moment can: after one
step without clipping mu = (1 - b1) g, g the reduced gradient, in
float32. Each DP test holds mu leaf by leaf within ``_mu_bound``.
The spawned ranks start from the params the test process drew
(``_save_params``).

JAX is imported inside the tests that compare with it: the spawned ranks
import this module.
"""

import dataclasses
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import compress, trainer  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.models.model import build_model, make_train_step  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "phi3-mini-3.8b"
JOIN_S = 120.0
# the reference test's AdamW: warm-up 1 (lr 3e-4 at the step), no clipping
OPT = dict(warmup_steps=1, decay_steps=4, clip_norm=0.0)
# float32 gradients of one batch summed in other orders (the JAX package's
# and the port's; the whole batch and its halves): each within 1e-4 of its
# leaf's largest |grad| (tests/test_torch_train.py's GRAD_RTOL)
GRAD_RTOL = 1e-4


def _mu_bound(mu_ref, n, both_quantized=False):
    """Per-element bound on |mu - mu_ref| after one step, mu_ref =
    (1 - b1) g_ref from a reduction over ``n`` ranks that is exact
    (``make_train_step``) or, with ``both_quantized``, int8-compressed
    too. ``compressed_psum_mean`` cuts a leaf's flat gradient into n
    shards and rounds each to its int8 grid, step max|shard| / 127: half
    a step of the shard's largest |g|, which itself may exceed g_ref's by
    dg = GRAD_RTOL max |g_ref| (the float32 orders); a reference that is
    quantized too adds its own half step; then dg, and 1e-6 of the
    largest |mu| for the roundings of the quantization and of mu. A leaf
    that takes the plain mean (its flat size does not tile n, or is under
    8 a rank) has no step. All in mu's units ((1 - b1) g)."""
    m = np.abs(np.asarray(mu_ref, np.float64)).reshape(-1)
    top = m.max()
    dg = GRAD_RTOL * top
    if m.size % n or m.size < n * 8:
        half = np.zeros_like(m)
    else:
        shard = m.reshape(n, -1).max(1)
        half = np.repeat(shard + dg, m.size // n) / 254
        if both_quantized:
            half = half + np.repeat(shard, m.size // n) / 254
    return (half + dg + 1e-6 * top).reshape(np.shape(mu_ref))


def _hold_mu(got, want, n, both_quantized=False):
    for i, (a, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        a = np.asarray(a, np.float32)
        assert a.shape == w.shape, i
        excess = np.abs(a.astype(np.float64) - w) - _mu_bound(
            w, n, both_quantized)
        assert excess.max() <= 0, (i, float(np.abs(a - w).max()))


def _setup(seed=0):
    cfg = dataclasses.replace(get_smoke(ARCH), param_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
        for k in ("tokens", "labels")}
    return cfg, model, params, batch


def _save_params(out, params) -> None:
    """The test process's params, for its spawned ranks (``_setup_from``):
    every rank then starts from the same bits as the reference. Drawing
    them in each rank does not promise that on the CPU: two processes'
    ``erfinv_`` of one leaf's init have been seen to differ in its last
    rows, now and then."""
    np.savez(pathlib.Path(out) / "params.npz",
             **{f"p{i}": t.numpy() for i, t in enumerate(tree.leaves(params))})


def _setup_from(out):
    """``_setup()`` in a spawned rank, its params those ``_save_params``
    wrote."""
    cfg, model, params, batch = _setup()
    saved = np.load(pathlib.Path(out) / "params.npz")
    return cfg, model, tree.unflatten_like(params, [
        torch.from_numpy(saved[f"p{i}"]) for i in range(len(saved.files))]), \
        batch


def _group(tmp_path, name="pg"):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / name}",
                            rank=0, world_size=1)


def test_quantize_int8_matches_jax():
    import jax.numpy as jnp
    from repro.distributed import compress as jcompress
    x = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    x[3] = 0.5 * np.abs(x).max() / 127 * 127       # a half-way value
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    tq, ts = compress.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    back = compress.dequantize_int8(tq, ts)
    assert np.array_equal(back.numpy(), np.asarray(
        jcompress.dequantize_int8(jq, js)))
    # half a step, and the roundings of x / s and q s (ulps of |x|)
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        float(ts) / 2 + 1e-6 * np.abs(x).max()


def test_compressed_mean_and_feedback_at_world_one(tmp_path):
    """At one rank the compressed mean is the int8 round trip; with error
    feedback the residual (before - reduced) is what the next step adds,
    each within half a quantization step."""
    _group(tmp_path)
    try:
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (8, 16)).astype(np.float32))
        e = torch.full((8, 16), 0.01)
        before = compress.apply_feedback({"w": g}, {"w": e})["w"]
        assert torch.equal(before, g + e)
        got = compress.compressed_psum_mean(before)
        q, s = compress.quantize_int8(before)
        assert torch.equal(got, compress.dequantize_int8(q, s))
        assert float((before - got).abs().max()) <= \
            float(s) / 2 + 1e-6 * float(before.abs().max())
        tiny = torch.arange(5.0)             # < 8 a rank: the plain mean
        assert torch.equal(compress.compressed_psum_mean(tiny), tiny)
        zero = compress.init_feedback({"w": g, "n": [None, torch.ones(3)]})
        assert zero["n"][0] is None and float(zero["w"].abs().sum()) == 0
    finally:
        dist.destroy_process_group()


def _world_one_vs_jax(tmp_path, axes):
    """The DP step at one rank on a mesh of ``axes`` (None: the default
    group) against the JAX package's on a one-device mesh of the same
    axes; see ``test_dp_step_at_world_one_matches_jax``."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import compress as jcompress
    from repro.distributed.trainer import make_dp_train_step as jdp
    from repro.models.model import build_model as jbuild
    from repro.configs import get_smoke as jsmoke
    from repro.optim import adamw as jadamw
    from torch.distributed.device_mesh import init_device_mesh
    cfg, model, params, batch = _setup()
    jm = jbuild(dataclasses.replace(jsmoke(ARCH), param_dtype="float32"))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jo = jadamw.AdamWConfig(**OPT)
    mesh = jax.make_mesh((1,) * len(axes or ("data",)), axes or ("data",))
    jp2, jo2, jfb, jm_ = jdp(jm, jo, mesh)(
        jp, jadamw.init(jo, jp), jcompress.init_feedback(jp),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    to = adamw.AdamWConfig(**OPT)
    _group(tmp_path)
    try:
        group = None if axes is None else init_device_mesh(
            "cpu", (1,) * len(axes), mesh_dim_names=axes)
        tp2, to2, tfb, tm = trainer.make_dp_train_step(model, to, group)(
            params, adamw.init(to, params), compress.init_feedback(params),
            batch)
    finally:
        dist.destroy_process_group()
    _, exact, _ = make_train_step(model, to)(params, adamw.init(to, params),
                                             batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    mu = [t.numpy() for t in tree.leaves(to2.mu)]
    _hold_mu(mu, jax.tree.leaves(jo2.mu), 1, both_quantized=True)
    _hold_mu(mu, [t.numpy() for t in tree.leaves(exact.mu)], 1)
    lr = float(jm_["lr"])
    for a, b in zip(jax.tree.leaves(jp2), tree.leaves(tp2)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 2 * lr + 1e-6 * np.abs(a).max()
    for a, b, p in zip(jax.tree.leaves(jfb), tree.leaves(tfb),
                       tree.leaves(params)):
        a = np.asarray(a)
        step = np.abs(a).max() * 254 + 1e-12      # |g| <= 127.5 steps
        assert np.abs(b.numpy() - a).max() <= step / 127


def test_dp_step_at_world_one_matches_jax(tmp_path):
    """The DP step (compressed, with error feedback) at one rank against
    the JAX package's on a one-device mesh, same params and batch: the
    loss within 1e-5; the first moment within ``_mu_bound`` of the JAX
    package's (both quantized) and of the port's ``make_train_step``'s
    (exact); params within 2 lr (a first AdamW step moves a param by lr g
    / (|g| + eps); a gradient that rounds to another int8 step, or to 0,
    on one side moves it by up to 2 lr) plus 1e-6 of the largest |param|;
    the feedback (the quantization residual) within one int8 step of each
    leaf (max |g| / 127)."""
    _world_one_vs_jax(tmp_path, None)


def _dp_rank(rank: int, world: int, init: str, out: str) -> None:
    """A spawned rank: the DP step on the global batch, its params saved."""
    lmesh.init_shard_group(rank, world, init_method=init, device="cpu",
                           timeout_s=JOIN_S)
    try:
        _, model, params, batch = _setup_from(out)
        to = adamw.AdamWConfig(**OPT)
        p2, o2, _, m = trainer.make_dp_train_step(model, to)(
            params, adamw.init(to, params), compress.init_feedback(params),
            batch)
        small = torch.arange(5.0) * (rank + 1)    # under 8 a rank: plain
        big = torch.linspace(-1.0, 1.0, 64) * (rank + 1)
        means = dict(small=compress.compressed_psum_mean(small).numpy(),
                     big=compress.compressed_psum_mean(big).numpy(),
                     plain=compress.psum_mean(big).numpy())
        np.savez(pathlib.Path(out) / f"rank{rank}.npz",
                 loss=float(m["loss"]), **means,
                 **{f"l{i}": t.numpy() for i, t in enumerate(tree.leaves(p2))},
                 **{f"m{i}": t.numpy()
                    for i, t in enumerate(tree.leaves(o2.mu))})
    finally:
        dist.destroy_process_group()


def test_dp_step_two_ranks_matches_train_step(tmp_path):
    """Two spawned gloo ranks take half the batch each: their params and
    first moments are equal bit for bit after the step; the moments within
    ``_mu_bound`` of ``make_train_step``'s on the whole batch (a sum in
    place of the mean, or any reduction off by more than an int8 step,
    fails here), the params within the reference test's 5e-2 (and 2
    lr); and both means of ``compress`` on values that differ by rank,
    which the smoke's leaves (all of them compressed) do not reach."""
    _, model, params, batch = _setup()
    _save_params(tmp_path, params)
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=_dp_rank, args=(r, 2, init, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert [p.exitcode for p in procs] == [0, 0]
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    to = adamw.AdamWConfig(**OPT)
    ref, ref_o, m = make_train_step(model, to)(
        params, adamw.init(to, params), batch)
    assert abs(float(r0["loss"]) - float(m["loss"])) < 1e-3
    want_mu = [t.numpy() for t in tree.leaves(ref_o.mu)]
    for i in range(len(want_mu)):
        assert np.array_equal(r0[f"m{i}"].view(np.uint32),
                              r1[f"m{i}"].view(np.uint32))
    _hold_mu([r0[f"m{i}"] for i in range(len(want_mu))], want_mu, 2)
    # the reductions alone, on rank-dependent values (x and 2 x): the
    # plain means exact or to float32 rounding, the compressed one within
    # half an int8 step of each shard
    mean = 1.5 * np.linspace(-1.0, 1.0, 64, dtype=np.float32)
    assert np.array_equal(r0["small"], 1.5 * np.arange(5.0, dtype=np.float32))
    np.testing.assert_allclose(r0["plain"], mean, rtol=0, atol=1e-6)
    step = np.repeat(np.abs(mean).reshape(2, -1).max(1), 32) / 254
    assert np.all(np.abs(r0["big"] - mean) <= step + 1e-6)
    lr = float(m["lr"])
    for i, want in enumerate(tree.leaves(ref)):
        a, b = r0[f"l{i}"], r1[f"l{i}"]
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        diff = np.abs(a - want.numpy()).max()
        assert diff <= 5e-2 and diff <= 2 * lr + 1e-6


def test_hierarchical_group_raises_naming_a6(tmp_path):
    """(Named when a ('pod', 'data') mesh raised naming ROADMAP A6; it is
    ported now.) The ('pod', 'data') DP step at (1, 1) against the JAX
    package's ``make_dp_train_step`` on a (1, 1) ('pod', 'data') mesh, by
    ``test_dp_step_at_world_one_matches_jax``'s bounds; a one-axis 'data'
    mesh is a DP group; a mesh with neither axis and more than one raises
    ValueError."""
    from torch.distributed.device_mesh import init_device_mesh
    (tmp_path / "a").mkdir()
    _world_one_vs_jax(tmp_path / "a", ("pod", "data"))
    _, model, _, _ = _setup()
    _group(tmp_path)
    try:
        one = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        assert callable(trainer.make_dp_train_step(model,
                                                   adamw.AdamWConfig(), one))
        other = init_device_mesh("cpu", (1, 1), mesh_dim_names=("x", "y"))
        with pytest.raises(ValueError, match="'pod' or 'data'"):
            trainer.make_dp_train_step(model, adamw.AdamWConfig(), other)
    finally:
        dist.destroy_process_group()


def _c9_values(pod: int, data: int) -> torch.Tensor:
    """A rank's 64 gradient values for ROADMAP C9's pin: the first half
    grows with the pod index, the second with the data index, so that a
    compression over 'pod' and one over 'data' quantize on other grids."""
    base = torch.linspace(-1.0, 1.0, 64)
    scale = torch.cat([torch.full((32,), 1.0 + 7.0 * pod),
                       torch.full((32,), 1.0 + 3.0 * data)])
    return base * scale + 0.01 * (2 * pod + data)


def _two_stage(vals, compress_pod: bool) -> torch.Tensor:
    """The reduction of ``vals[p][d]`` over a (2, 2) ('pod', 'data') mesh
    in one process: the plain mean over one axis, then the int8 mean over
    the other (each of its 2 shards on its own grid), 'data' compressed
    unless ``compress_pod``."""
    def q8(x):
        return torch.cat([compress.dequantize_int8(*compress.quantize_int8(
            h)) for h in x.reshape(2, -1)])
    if compress_pod:      # plain over 'data', then compressed over 'pod'
        m = [(vals[p][0] + vals[p][1]) / 2 for p in range(2)]
    else:                 # the reference's order
        m = [(vals[0][d] + vals[1][d]) / 2 for d in range(2)]
    return q8((m[0] + m[1]) / 2)


def _pod_rank(rank: int, world: int, init: str, out: str) -> None:
    """A spawned rank of the (2 pod x 2 data) step, its results saved."""
    from torch.distributed.device_mesh import init_device_mesh
    lmesh.init_shard_group(rank, world, init_method=init, device="cpu",
                           timeout_s=JOIN_S)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
        _, model, params, batch = _setup_from(out)
        to = adamw.AdamWConfig(**OPT)
        p2, o2, _, m = trainer.make_dp_train_step(model, to, mesh)(
            params, adamw.init(to, params), compress.init_feedback(params),
            batch)
        g = _c9_values(*mesh.get_coordinate())
        reduced = trainer.reduce_mean(g, trainer.data_groups(mesh)[0])
        np.savez(pathlib.Path(out) / f"rank{rank}.npz",
                 loss=float(m["loss"]), c9=reduced.numpy(),
                 **{f"l{i}": t.numpy() for i, t in enumerate(tree.leaves(p2))},
                 **{f"m{i}": t.numpy()
                    for i, t in enumerate(tree.leaves(o2.mu))})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    """The four spawned ranks of the (2 pod x 2 data) step, their saved
    results by rank."""
    tmp_path = tmp_path_factory.mktemp("pod")
    _, _, params, _ = _setup()
    _save_params(tmp_path, params)
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=_pod_rank, args=(r, 4, init, str(tmp_path)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert [p.exitcode for p in procs] == [0] * 4
    return params, [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]


def test_hierarchical_dp_step_four_ranks_matches_train_step(pod_run):
    """Four spawned gloo ranks on a (2 pod x 2 data) mesh, one row of the
    4-row batch each (i_pod 2 + i_data): a plain mean over 'pod', then the
    compressed mean over 'data' (the reference's order, ROADMAP C9). Every
    rank's params and first moments are equal bit for bit; the moments
    within ``_mu_bound(mu, 2)`` of ``make_train_step``'s on the whole
    batch (the pod mean is exact to float32 orders, within the bound's
    dg; the compression then cuts the pod-mean gradient into the 2 shards
    of 'data'); the params within 5e-2 and 2 lr; the loss within 1e-3."""
    params, ranks = pod_run
    _, model, _, batch = _setup()
    to = adamw.AdamWConfig(**OPT)
    ref, ref_o, m = make_train_step(model, to)(
        params, adamw.init(to, params), batch)
    assert abs(float(ranks[0]["loss"]) - float(m["loss"])) < 1e-3
    want_mu = [t.numpy() for t in tree.leaves(ref_o.mu)]
    for r in ranks[1:]:
        for i in range(len(want_mu)):
            assert np.array_equal(r[f"m{i}"].view(np.uint32),
                                  ranks[0][f"m{i}"].view(np.uint32))
            assert np.array_equal(r[f"l{i}"].view(np.uint32),
                                  ranks[0][f"l{i}"].view(np.uint32))
    _hold_mu([ranks[0][f"m{i}"] for i in range(len(want_mu))], want_mu, 2)
    lr = float(m["lr"])
    for i, want in enumerate(tree.leaves(ref)):
        diff = np.abs(ranks[0][f"l{i}"] - want.numpy()).max()
        assert diff <= 5e-2 and diff <= 2 * lr + 1e-6


def test_c9_pod_mean_then_compressed_data(pod_run):
    """ROADMAP C9, kept on purpose: the JAX package's hierarchical
    reduction takes the plain mean over 'pod' and compresses over 'data'
    (its code; its docstring says the reverse). On the four spawned ranks
    (the step above), ``trainer.reduce_mean`` of rank-dependent values
    equals, bit for bit on every rank, the pod mean followed by the int8
    mean over 'data', and not the reverse order, which quantizes on other
    grids."""
    vals = [[_c9_values(p, d) for d in range(2)] for p in range(2)]
    want = _two_stage(vals, compress_pod=False)
    reverse = _two_stage(vals, compress_pod=True)
    assert not torch.equal(want, reverse)
    for r in range(4):
        got = pod_run[1][r]["c9"]
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.numpy().view(np.uint32))
