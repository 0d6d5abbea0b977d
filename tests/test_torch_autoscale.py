"""The port's replica autoscaler (``core/autoscale.py``) and
``ServingTopology.scale_replicas``, held against the JAX package
(tests/test_autoscale.py's cases, re-expressed).

The control loop runs on scripted ``TopologyReport``-shaped reports
against a recording FakeTopo, the same script through both packages'
``Autoscaler``: the same actions, reasons and group sizes at every step.
The live loop runs on lazy fake shard engines under the virtual clock of
tests/test_torch_hedge.py, so its saturation and idleness are exact.
"""

import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import autoscale as jautoscale  # noqa: E402
from repro_torch.core import autoscale  # noqa: E402
from test_torch_hedge import indexed_queries, virtual_tier  # noqa: E402,F401

jtopology = importlib.import_module("repro.core.topology")


class FakeTopo:
    """Enough ServingTopology surface for the control loop: groups,
    fifo_depth, the cluster partition and a recording scale_replicas."""

    def __init__(self, n_groups=2, replicas=1, fifo_depth=4, part_of=None):
        self.groups = [[object() for _ in range(replicas)]
                       for _ in range(n_groups)]
        self.fifo_depth = fifo_depth
        self.part_of = part_of
        self.calls = []

    def scale_replicas(self, group, n):
        self.calls.append((group, n))
        g = self.groups[group]
        while len(g) < n:
            g.append(object())
        while len(g) > n:
            g.pop()
        return len(g)


def _report(occ=(0.0, 0.0), shed=0.0, p99=1.0, tenants=None,
            cluster_hits=None, queries=None, depth=4):
    per_engine = [{"shard": g, "replica": 0,
                   "max_in_flight": int(round(o * depth)),
                   "queries": queries[g] if queries is not None else 32}
                  for g, o in enumerate(occ)]
    return types.SimpleNamespace(
        per_engine=per_engine, shed_fraction=shed, p99_ms=p99,
        tenants=tenants or {}, cluster_hits=cluster_hits)


def _random_script(seed, n=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(_report(
            occ=tuple(rng.choice([0.0, 0.25, 0.5, 1.0], 2)),
            shed=float(rng.choice([0.0, 0.0, 0.05])),
            p99=float(rng.choice([1.0, 50.0])),
            cluster_hits=rng.integers(0, 5, 8) if rng.random() < 0.5
            else None,
            queries=list(rng.integers(0, 40, 2))))
    return out


PART = np.repeat(np.arange(2), 4)
HOT_TENANTS = {"a": {"n_admitted": 5, "p99_ms": 5.0},
               "b": {"n_admitted": 5, "p99_ms": 80.0},
               "idle": {"n_admitted": 0, "p99_ms": 999.0}}

SCENARIOS = {
    "occupancy_up": (dict(up_patience=2), {},
                     [_report(occ=(1.0, 0.0))] * 3),
    "shed_to_hottest_by_heat": (
        dict(), dict(part_of=PART),
        [_report(shed=0.2, cluster_hits=np.array([0, 0, 0, 0, 9, 9, 9, 9]))]),
    "heat_falls_back_to_queries": (
        dict(), {}, [_report(shed=0.2, queries=[3, 50])]),
    "p99_worst_admitted_tenant": (
        dict(p99_high_ms=50.0), {},
        [_report(p99=10.0, tenants=HOT_TENANTS, queries=[40, 2])]),
    "down_after_patience_clamped": (
        dict(down_patience=3, min_replicas=1), dict(replicas=2),
        [_report(occ=(0.0, 0.0))] * 7),
    "clamped_at_max": (dict(max_replicas=3, step=2), {},
                       [_report(occ=(1.0, 1.0))] * 4),
    "hysteresis": (
        dict(up_patience=2, down_patience=2), dict(replicas=2),
        [_report(occ=(1.0, 0.0)), _report(occ=(0.5, 0.5)),
         _report(occ=(1.0, 0.0)), _report(occ=(0.0, 0.0)),
         _report(occ=(1.0, 1.0)), _report(occ=(1.0, 1.0)),
         _report(occ=(0.0, 0.0)), _report(occ=(0.0, 0.0))]),
    "random_0": (dict(up_patience=1, down_patience=2, p99_high_ms=20.0),
                 dict(part_of=PART), _random_script(0)),
    "random_1": (dict(max_replicas=6, step=2, down_patience=1),
                 dict(replicas=3), _random_script(1)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_autoscaler_actions_match_jax(name):
    """The same scripted reports through both packages' Autoscaler: the
    same observations, actions (group, direction, sizes, reason) and
    scale_replicas calls at every step."""
    pol_kw, topo_kw, script = SCENARIOS[name]
    runs = []
    for mod in (autoscale, jautoscale):
        topo = FakeTopo(**topo_kw)
        scaler = mod.Autoscaler(topo, mod.AutoscalePolicy(**pol_kw))
        log = []
        for rep in script:
            obs = scaler.observe(rep)
            acts = scaler.step(rep)
            log.append((obs, [(a.group, a.direction, a.n_before, a.n_after,
                               a.reason) for a in acts],
                        [len(g) for g in topo.groups]))
        runs.append((log, topo.calls))
    assert runs[0] == runs[1]
    assert runs[0][1]                     # every script makes a move


@pytest.mark.parametrize("kw", [
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
    dict(shed_high=1.0), dict(p99_high_ms=0.0), dict(occupancy_high=0.0),
    dict(occupancy_low=0.9, occupancy_high=0.9), dict(up_patience=0),
    dict(step=0)],
    ids=["min", "min_max", "shed", "p99", "occ_high", "occ_low",
         "patience", "step"])
def test_policy_validation_matches_jax(kw):
    msgs = []
    for mod in (autoscale, jautoscale):
        with pytest.raises(ValueError) as e:
            mod.AutoscalePolicy(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(TypeError, match="AutoscalePolicy"):
        autoscale.Autoscaler(FakeTopo(), policy="on")


def test_tenant_fair_heat_matches_jax():
    """Per-tenant heat combined by admission weight, not volume; the
    global mass kept; the fallbacks of a report without per-tenant heat."""
    hits = np.array([90.0, 0.0, 10.0, 0.0])
    rep = types.SimpleNamespace(cluster_hits=hits, tenants={
        "noisy": {"weight": 1.0, "cluster_hits": np.array([90, 0, 0, 0])},
        "light": {"weight": 1.0, "cluster_hits": np.array([0, 0, 10, 0])}})
    np.testing.assert_allclose(autoscale.tenant_fair_heat(rep),
                               [50.0, 0.0, 50.0, 0.0])
    for weight in (1.0, 2.0, 0.5):
        rep.tenants["light"]["weight"] = weight
        np.testing.assert_array_equal(autoscale.tenant_fair_heat(rep),
                                      jautoscale.tenant_fair_heat(rep))
    rep.tenants = {}
    np.testing.assert_array_equal(autoscale.tenant_fair_heat(rep), hits)
    rep.cluster_hits = None
    assert autoscale.tenant_fair_heat(rep) is None


# ---------------------------------------------------------------------------
# the live topology: scale_replicas and the wired loop, on lazy fakes
# ---------------------------------------------------------------------------

def test_scale_replicas_structural(virtual_tier):
    make, _ = virtual_tier
    topo, groups = make(2, 1)
    leader = groups[0][0]
    assert topo.scale_replicas(0, 3) == 3
    assert [len(g) for g in topo.groups] == [3, 1]
    assert all(e.index is leader.index for e in topo.groups[0])
    assert topo.scale_replicas(0, 1) == 1
    assert topo.groups[0] == [leader]
    with pytest.raises(ValueError, match="group 5 outside 0..1"):
        topo.scale_replicas(5, 2)
    with pytest.raises(ValueError, match="need at least one replica"):
        topo.scale_replicas(0, 0)


def test_results_stay_correct_across_resizes(virtual_tier):
    make, _ = virtual_tier
    n = 24
    q = indexed_queries(n)
    topo, _ = make(2, 1, service_s=1e-4, n_queries=n)
    for sizes in [(2, 1), (3, 2), (1, 1)]:
        for g, s in enumerate(sizes):
            topo.scale_replicas(g, s)
        rep = topo.run(q)
        assert rep.replicas == list(sizes)
        np.testing.assert_array_equal(rep.ids[:, 0], np.arange(n))


def test_autoscaler_wired_through_live_topology(virtual_tier):
    """A burst saturates the FIFO credits -> both groups grow; two idle
    trickles shrink them back; ids stay correct at every size (exact
    under the virtual clock)."""
    make, _ = virtual_tier
    n, depth = 16, 2
    q = indexed_queries(n)
    policy = autoscale.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                       occupancy_high=0.9,
                                       occupancy_low=0.5, up_patience=1,
                                       down_patience=2)
    topo, _ = make(2, 1, service_s=5e-3, n_queries=n, fifo_depth=depth,
                   max_batch=4, autoscale=policy)
    assert isinstance(topo.autoscaler, autoscale.Autoscaler)
    rep = topo.run(q, np.zeros(n))
    assert max(pe["max_in_flight"] for pe in rep.per_engine) == depth
    ups = topo.autoscaler.step(rep)
    assert {a.direction for a in ups} == {"up"}
    assert [len(g) for g in topo.groups] == [2, 2]
    for _ in range(policy.down_patience):
        rep = topo.run(q, np.arange(n) * (6 * 5e-3))
        np.testing.assert_array_equal(rep.ids[:, 0], np.arange(n))
        topo.autoscaler.step(rep)
    assert [len(g) for g in topo.groups] == [1, 1]
    downs = [a for a in topo.autoscaler.actions if a.direction == "down"]
    assert len(downs) == 2


def test_serving_topology_rejects_bad_autoscale_like_jax(virtual_tier):
    make, _ = virtual_tier
    with pytest.raises(ValueError) as got:
        make(autoscale="on")
    eng = types.SimpleNamespace(
        scfg=types.SimpleNamespace(k=3, nprobe=2, mode="fake"),
        index=types.SimpleNamespace(n_clusters=8), buckets=(),
        host=types.SimpleNamespace(vectors=None), compile_count=0)
    with pytest.raises(ValueError) as want:
        jtopology.ServingTopology([[eng]], buckets=(4,), autoscale="on")
    assert str(got.value) == str(want.value)
