"""The port's RAG serving loop (``repro_torch.launch.serve``) on the CPU
against the JAX package's: ``generate`` with the JAX params and the JAX
engine's index carried over through ``repro_torch.bridge``, against the JAX
package's prefill / decode / scheduler loop (launch/serve.py ``run``), on
each of the three ways ``--rag`` serves; and the launcher's flag checks
(tests/test_launch.py's), re-expressed. Inputs come from numpy with a seed.
"""

import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core.compact_index import IndexConfig as JIndexConfig  # noqa: E402
from repro.core.mutable_index import MutableIndex as JMutableIndex  # noqa: E402
from repro.data.synthetic import clustered_vectors  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core import compact_index as tci  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core.mutable_index import MutableIndex  # noqa: E402
from repro_torch.core import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-1.8b"
B, PROMPT, GEN = 32, 16, 6     # 32 x k = 128 id slots: 99% allows one
SCFG = dict(nprobe=2, ef=16, k=4)       # launch/serve.py's retrieval setup
ICFG = dict(dim=32, n_clusters=8, degree=8, knn_k=16)


@pytest.fixture(scope="module")
def stack():
    """serve.py's engine (2000 x 32, 8 clusters, 2 shards) and smoke model
    (float32 params, so greedy tokens can be held equal), built by the JAX
    package, with the port's bridged copies."""
    x, _ = clustered_vectors(0, 2000, 32, 8)
    je = jengine.PIMCQGEngine.build(jax.random.PRNGKey(0), x,
                                    JIndexConfig(**ICFG),
                                    jengine.SearchConfig(**SCFG), n_shards=2)
    pl = je.place
    te = tengine.PIMCQGEngine(
        bridge.compact_index_from_numpy(
            {f: getattr(je.index, f) for f in je.index._fields},
            device="cpu"),
        bridge.host_store_from_numpy(je.host.vectors, je.host.centroids,
                                     device="cpu"),
        bridge.placement_from_numpy(pl.order, pl.shard_of, pl.local_slot,
                                    pl.n_shards, pl.per_shard, pl.load,
                                    pl.mem),
        tci.IndexConfig(**ICFG), tengine.SearchConfig(**SCFG), device="cpu")
    jm = jbuild(dataclasses.replace(jsmoke(ARCH), param_dtype="float32"))
    tm = tbuild(dataclasses.replace(tsmoke(ARCH), param_dtype="float32"))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return je, te, jm, jp, tm, tp


def _schedulers(mode, je, te):
    stream = dict(buckets=jpipeline.bucket_ladder(B), fill_threshold=B // 2,
                  wait_limit_s=5e-3)
    if mode == "stream":
        return (jpipeline.StreamingScheduler(je, **stream),
                tpipeline.StreamingScheduler(te, **stream))
    if mode == "fleet":
        return (jfleet.FleetScheduler(jfleet.replicate_engine(je, 2),
                                      **stream),
                tfleet.FleetScheduler(tfleet.replicate_engine(te, 2),
                                      **stream))
    return (jfleet.TopologyConfig(shards=2, **stream).build(je),
            tfleet.TopologyConfig(shards=2, **stream).build(te))


def _jax_loop(jm, jp, tokens, sched, encoder):
    """launch/serve.py run()'s loop on the JAX package."""
    cache = jm.init_cache(B, PROMPT + GEN, dtype=jnp.float32)
    logits, cache = jm.prefill(jp, jnp.asarray(tokens), cache)
    out = [jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)]
    q = rep = None
    for i in range(GEN - 1):
        logits, cache = jm.decode(jp, out[-1], cache)
        out.append(jnp.argmax(logits[:, -1:], -1).astype(jnp.int32))
        if i == 0:
            q = encoder(logits)
            rep = sched.run(q)
    return np.asarray(jnp.concatenate(out, 1)), q, rep, logits


@pytest.mark.parametrize("mode", ["stream", "fleet", "sharded"])
def test_generate_matches_jax_loop(stack, mode):
    """Tokens equal in every position; the encoded queries to 1e-5; the
    retrieved ids in >= 99% of slots (the int LUT rounds a float, so an
    entry may differ by one, as in slice 1's contract)."""
    je, te, jm, jp, tm, tp = stack
    tokens = np.random.default_rng(7).integers(
        0, jm.cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jsched, tsched = _schedulers(mode, je, te)
    jtoks, jq, jrep, jlogits = _jax_loop(
        jm, jp, tokens, jsched, jserve.mean_pool_encoder(jp, 32))
    out = tserve.generate(
        tm, tp, torch.from_numpy(tokens), GEN,
        tm.init_cache(B, PROMPT + GEN, dtype=torch.float32, device="cpu"),
        scheduler=tsched, encoder=tserve.mean_pool_encoder(tp, 32))
    assert out.tokens.shape == (B, GEN) and out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), jtoks)
    np.testing.assert_allclose(out.queries, jq, atol=1e-5)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    assert out.report.ids.shape == jrep.ids.shape == (B, SCFG["k"])
    assert (out.report.ids == jrep.ids).mean() >= 0.99
    assert min(out.prefill_s, out.decode_s, out.retrieve_s) >= 0.0


@pytest.mark.parametrize("mode", ["stream", "sharded"])
def test_generate_after_churn_matches_jax_loop(stack, mode):
    """--churn's path from one built state: each package's MutableIndex over
    serve.py's index (the JAX one bridged in), the JAX package's churn
    round (run() in launch/serve.py) against the port's ``churn_round``
    (10%: 200 deletes, 200 inserts, compaction, then ``apply`` on the tier
    or ``refresh`` on the engine), then the decode loop's retrieval: ids
    in >= 99% of slots, as test_generate_matches_jax_loop holds them."""
    je, te, jm, jp, tm, tp = stack
    icfg = ICFG
    slab = max(16, round(0.1 * 2000))
    jmut = JMutableIndex(je.index, je.host, JIndexConfig(**icfg), slab=slab)
    tmut = MutableIndex(te.index, te.host, tci.IndexConfig(**icfg),
                        slab=slab)
    jeng = jmut.to_engine(jengine.SearchConfig(**SCFG), n_shards=2)
    teng = tmut.to_engine(tengine.SearchConfig(**SCFG), n_shards=2)
    stream = dict(buckets=jpipeline.bucket_ladder(B), fill_threshold=B // 2,
                  wait_limit_s=5e-3)
    if mode == "stream":
        jsched = jpipeline.StreamingScheduler(jeng, **stream)
        tsched = tpipeline.StreamingScheduler(teng, **stream)
    else:
        jsched = jfleet.TopologyConfig(shards=2, mutable=True,
                                       **stream).build(jeng)
        tsched = tfleet.TopologyConfig(shards=2, mutable=True,
                                       **stream).build(teng)
    n_churn = max(1, int(round(0.1 * jmut.n_live)))
    jmut.delete(jmut.live_ids()[:n_churn])
    jmut.insert(np.arange(2000, 2000 + n_churn),
                np.random.default_rng(1).standard_normal(
                    (n_churn, 32)).astype(np.float32))
    compacted = jmut.compact()
    if mode == "stream":
        jeng.refresh(*jmut.snapshot())
    else:
        jsched.apply(jmut)
    assert tserve.churn_round(tmut, 0.1, 0, 2000, tsched, teng) == \
        (n_churn, compacted)
    np.testing.assert_array_equal(tmut.node_ids.numpy(), jmut.node_ids)
    tokens = np.random.default_rng(7).integers(
        0, jm.cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    _, _, jrep, _ = _jax_loop(jm, jp, tokens, jsched,
                              jserve.mean_pool_encoder(jp, 32))
    out = tserve.generate(
        tm, tp, torch.from_numpy(tokens), GEN,
        tm.init_cache(B, PROMPT + GEN, dtype=torch.float32, device="cpu"),
        scheduler=tsched, encoder=tserve.mean_pool_encoder(tp, 32))
    assert (out.report.ids == jrep.ids).mean() >= 0.99
    deleted = np.asarray(je.index.node_ids)
    deleted = np.sort(deleted[deleted >= 0])[:n_churn]
    assert not np.isin(out.report.ids, deleted).any()


def test_generate_without_retrieval_and_encoders(stack):
    _, _, jm, jp, tm, tp = stack
    tokens = torch.zeros((2, 5), dtype=torch.int64)
    out = tserve.generate(tm, tp, tokens, 1, tm.init_cache(
        2, 6, dtype=torch.float32, device="cpu"))
    assert out.tokens.shape == (2, 1) and out.report is None
    with pytest.raises(ValueError, match="both a scheduler and an encoder"):
        tserve.generate(tm, tp, tokens, 2, None,
                        encoder=tserve.logit_slice_encoder(8))
    logits = np.random.default_rng(1).standard_normal(
        (2, 1, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        tserve.logit_slice_encoder(8)(torch.from_numpy(logits)),
        jserve.logit_slice_encoder(8)(jnp.asarray(logits)))
    np.testing.assert_allclose(
        tserve.mean_pool_encoder(tp, 32)(torch.from_numpy(logits)),
        jserve.mean_pool_encoder(jp, 32)(jnp.asarray(logits)), atol=1e-6)
    with pytest.raises(ValueError, match="< engine dim"):
        tserve.mean_pool_encoder(tp, 65)
    assert set(tserve.ENCODERS) == set(jserve.ENCODERS)


@pytest.mark.parametrize("kw", [
    dict(), dict(fleet=2), dict(fleet=2, sharded=True),
    dict(fleet=2, tenants="a:2,b:1"),
    dict(fleet=2, sharded=True, tenants="latency:4:hamming,recall:1:exact"),
    dict(zipf=1.0), dict(fleet=2, sharded=True, zipf=1.2),
    dict(churn=0.1), dict(fleet=2, sharded=True, churn=0.1)],
    ids=["stream", "fleet", "sharded", "fleet_tenants", "sharded_tenants",
         "zipf", "sharded_zipf", "churn", "sharded_churn"])
def test_run_serves_rag(kw, capsys):
    """Every --rag way of serving, --tenants, --zipf and --churn included,
    runs and reports; tenants get their report lines, zipf its heat line,
    churn its swap line."""
    toks, retrieved = tserve.run(ARCH, requests=2, prompt_len=16, gen=4,
                                 rag=True, device="cpu", **kw)
    assert toks.shape == (2, 4)
    assert retrieved is not None and retrieved.shape == (2, 4)
    out = capsys.readouterr().out
    assert "[serve] rag:" in out
    if "tenants" in kw:
        assert out.count("[serve] rag: tenant ") == 2
    if "zipf" in kw:
        assert "zipf(s=" in out
    if "churn" in kw:
        assert "[serve] rag: churned 200 deletes + 200 inserts" in out


def test_generate_with_tenants_matches_jax_loop(stack):
    """--tenants' path: the decode batch tagged in turn with a hamming
    tenant and an exact tenant on a shards=2 x replicas=2 tier of both
    backends, against the JAX package's loop on the same tier; ids in
    >= 99% of slots, the same per-tenant admission counts."""
    je, te, jm, jp, tm, tp = stack
    tokens = np.random.default_rng(8).integers(
        0, jm.cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    spec = "latency:4:hamming,recall:1:exact"
    labels = [("latency", "recall")[i % 2] for i in range(B)]
    cfg = dict(shards=2, replicas=2, modes=("exact", "hamming"),
               buckets=jpipeline.bucket_ladder(B), fill_threshold=B // 2,
               wait_limit_s=5e-3)
    jsched = jfleet.TopologyConfig(tenants=tuple(jserve.parse_tenants(spec)),
                                   **cfg).build(je)
    tsched = tfleet.TopologyConfig(tenants=tuple(tserve.parse_tenants(spec)),
                                   **cfg).build(te)
    cache = jm.init_cache(B, PROMPT + GEN, dtype=jnp.float32)
    logits, cache = jm.prefill(jp, jnp.asarray(tokens), cache)
    logits, cache = jm.decode(
        jp, jnp.argmax(logits[:, -1:], -1).astype(jnp.int32), cache)
    jrep = jsched.run(jserve.mean_pool_encoder(jp, 32)(logits),
                      tenant=labels)
    out = tserve.generate(
        tm, tp, torch.from_numpy(tokens), GEN,
        tm.init_cache(B, PROMPT + GEN, dtype=torch.float32, device="cpu"),
        scheduler=tsched, encoder=tserve.mean_pool_encoder(tp, 32),
        tenant=labels)
    assert (out.report.ids == jrep.ids).mean() >= 0.99
    for name in ("latency", "recall"):
        got, want = out.report.tenants[name], jrep.tenants[name]
        assert got["n_admitted"] == want["n_admitted"] == B // 2
        assert got["backend"] == want["backend"]


def test_serve_rejects_inconsistent_topology_flags():
    """tests/test_launch.py's: flag misuse raises before any model is
    built."""
    with pytest.raises(ValueError, match="--fleet >= 2"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=1, sharded=True)
    with pytest.raises(ValueError, match="--sharded"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=2, replicas=2)
    with pytest.raises(ValueError, match="--replicas"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=2, sharded=True,
                   replicas=0)
    with pytest.raises(ValueError, match="--exec mesh"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=2, exec="mesh")
    with pytest.raises(ValueError, match="one device per shard"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=2, sharded=True,
                   replicas=2, exec="mesh")
    with pytest.raises(ValueError, match=r"--churn must be in \[0, 1\)"):
        tserve.run(ARCH, 2, 16, 4, rag=True, churn=1.0)
    with pytest.raises(ValueError, match="needs --rag"):
        tserve.run(ARCH, 2, 16, 4, churn=0.1)
    with pytest.raises(ValueError, match="--zipf exponent"):
        tserve.run(ARCH, 2, 16, 4, rag=True, zipf=0.0)
    with pytest.raises(ValueError, match="needs --rag"):
        tserve.run(ARCH, 2, 16, 4, zipf=1.0)
    with pytest.raises(ValueError, match="no day-2 mutation path"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=2, churn=0.1)


def test_parse_tenants_validates_loudly():
    """tests/test_launch.py's, over the port's registry (mulfree, exact and
    hamming, as the JAX package's)."""
    specs = tserve.parse_tenants("latency:4:mulfree, recall:1")
    assert [t.name for t in specs] == ["latency", "recall"]
    assert [t.weight for t in specs] == [4.0, 1.0]
    assert [t.backend for t in specs] == ["mulfree", None]
    specs = tserve.parse_tenants("latency:4:hamming, recall:1:exact")
    assert [t.backend for t in specs] == ["hamming", "exact"]
    for bad, msg in [("a:1,,b:1", "empty entry"), ("justaname", "name:weight"),
                     (":3", "name:weight"), ("a:heavy", "not a number"),
                     ("a:0", "weight must be > 0"),
                     ("a:-2", "weight must be > 0"),
                     ("a:1:warp-drive", "unknown backend"),
                     ("a:1,a:2", "duplicate")]:
        with pytest.raises(ValueError, match=msg):
            tserve.parse_tenants(bad)


def test_serve_rejects_tenant_flag_misuse():
    with pytest.raises(ValueError, match="needs --rag"):
        tserve.run(ARCH, 2, 16, 4, rag=False, fleet=2, tenants="a:1,b:1")
    with pytest.raises(ValueError, match="--fleet >= 2"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=1, tenants="a:1,b:1")
    with pytest.raises(ValueError, match="need --sharded"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=2,
                   tenants="a:1:mulfree,b:1")
    with pytest.raises(ValueError, match="weight must be > 0"):
        tserve.run(ARCH, 2, 16, 4, rag=True, fleet=2, tenants="a:0,b:1")


@pytest.mark.parametrize("kw,match", [
    (dict(churn=0.1), "needs --rag"),
    (dict(rag=True, churn=1.0), r"--churn must be in \[0, 1\)"),
    (dict(rag=True, fleet=2, churn=0.1), "no day-2 mutation path"),
], ids=["no_rag", "out_of_range", "replicated_fleet"])
def test_churn_flag_misuse_raises(kw, match):
    """--churn's flag checks, the JAX package's ValueErrors."""
    with pytest.raises(ValueError, match=match):
        tserve.run(ARCH, 2, 16, 4, device="cpu", **kw)


@pytest.mark.parametrize("kw,item", [
    (dict(fleet=2, sharded=True, exec="mesh"), "torchrun --nproc-per-node=2"),
], ids=["exec_mesh"])
def test_unported_flags_raise(kw, item):
    """--exec mesh is served (ROADMAP A4): without a process group of
    --fleet ranks, run() raises make_shard_mesh's ValueError, which names
    the launch."""
    with pytest.raises(ValueError, match=item):
        tserve.run(ARCH, 2, 16, 4, rag=True, device="cpu", **kw)


def test_main_turns_flag_misuse_into_usage_errors(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--rag",
                                      "--sharded"])
    with pytest.raises(SystemExit) as e:
        tserve.main()
    assert e.value.code == 2
    assert "--fleet >= 2" in capsys.readouterr().err


def test_port_imports_no_jax():
    """Importing the LM path and the launcher leaves jax out of
    sys.modules, in a fresh interpreter."""
    code = ("import sys, repro_torch.launch.serve, repro_torch.models.model; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for mod in ("repro_torch.launch.serve", "repro_torch.models.model"):
        assert importlib.util.find_spec(mod) is not None
