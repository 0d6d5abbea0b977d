"""The port's event simulator (``repro_torch.core.pipeline``:
``EventSimulator``, ``RetryPolicy``, ``SimReport``,
``round_robin_batches``) against the JAX package's on the cases of
tests/test_pipeline.py and the two simulator cases of
tests/test_straggler.py: the same inputs give equal reports, field for
field (host code on both sides, so equal means equal bits), and the port's
reports pass the JAX tests' own assertions.
"""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import pipeline as jpipe  # noqa: E402
from repro.distributed import straggler as jstrag  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.distributed import straggler as tstrag  # noqa: E402

PACKAGES = {"jax": (jpipe, jstrag), "torch": (tpipe, tstrag)}


def _costs(p):
    link = p.LinkModel(setup_s=5e-6, bw_bytes_s=1e9, knee_bytes=8192,
                       congestion=0.3)
    return p.StageCosts(
        t_pre=lambda n: 2e-6 * n + 1e-6,
        t_proc=lambda n: 40e-6 * n + 10e-6,
        t_post=lambda n: 15e-6 * n + 2e-6,
        link=link, query_bytes=512, result_bytes=512)


def _tenancy_costs(p):
    link = p.LinkModel(setup_s=5e-6, bw_bytes_s=1e9, knee_bytes=8192,
                       congestion=0.3)
    return p.StageCosts(
        t_pre=lambda n: 5e-5 * n + 1e-6,
        t_proc=lambda n: 1e-5 * n + 5e-6,
        t_post=lambda n: 2e-6 * n + 1e-6,
        link=link, query_bytes=512, result_bytes=512)


def _sim_costs(p):
    link = p.LinkModel(setup_s=1e-6, bw_bytes_s=50e9, knee_bytes=1 << 20)
    return p.StageCosts(t_pre=lambda n: 1e-6,
                        t_proc=lambda n: 100e-6 * n + 20e-6,
                        t_post=lambda n: 2e-6,
                        link=link, query_bytes=64, result_bytes=64)


def _mixed_stream(rng, rates, window, n_pus):
    arrs, tids, pus = [], [], []
    for t, rate in enumerate(rates):
        n = int(rate * window)
        arrs.append(np.sort(rng.uniform(0.0, window, n)))
        tids.append(np.full(n, t, int))
        pus.append(rng.integers(0, n_pus, n))
    arr = np.concatenate(arrs)
    order = np.argsort(arr, kind="stable")
    return (arr[order], np.concatenate(pus)[order],
            np.concatenate(tids)[order])


# ---------------------------------------------------------------------------
# the scenarios: each runs one package and returns its reports
# ---------------------------------------------------------------------------

def policy_ordering(p, s):
    sim = p.EventSimulator(n_pus=16, costs=_costs(p), rerank_workers=4)
    n = 2000
    rng = np.random.default_rng(0)
    pus = rng.integers(0, 16, n)
    arr = np.cumsum(rng.exponential(5e-6, n))
    return dict(pq=sim.per_query(n, pus), bs=sim.batch_sync(n, 256, pus),
                p1=sim.pipeline(n, 1, pus),
                dyn=sim.dynamic(arr, pus, threshold=8, wait_limit_s=1e-3))


def tuner_and_ladder(p, s):
    n, per_q = p.tune_minibatch(_costs(p))
    return dict(n=n, per_q=per_q, ladders=[
        p.bucket_ladder(64), p.bucket_ladder(64, 12),
        p.bucket_ladder(16, 128), p.bucket_ladder(1)])


def round_robin(p, s):
    return dict(even=p.round_robin_batches(np.repeat(np.arange(4), 8), 4),
                uneven=p.round_robin_batches(np.array([0] * 9 + [1] * 4), 4))


def interleave_vs_grouped(p, s):
    sim = p.EventSimulator(n_pus=16, costs=_costs(p), rerank_workers=4)
    pus = np.arange(2000) % 16
    per_pu: dict[int, list] = {}
    for i, pu in enumerate(pus):
        per_pu.setdefault(int(pu), []).append(i)
    grouped = [(pu, len(qs[j:j + 8]), 0.0) for pu, qs in per_pu.items()
               for j in range(0, len(qs), 8)]
    return dict(inter=sim._run_batches(p.round_robin_batches(pus, 8)),
                grouped=sim._run_batches(grouped))


def end_of_stream(p, s):
    sim = p.EventSimulator(n_pus=2, costs=_costs(p), rerank_workers=1)
    return dict(
        one=sim.dynamic(np.array([0.0]), np.array([0]), threshold=10,
                        wait_limit_s=1e-3),
        two=sim.dynamic(np.array([0.0, 4e-4]), np.array([0, 1]),
                        threshold=10, wait_limit_s=1e-3))


def shedding(p, s):
    sim = p.EventSimulator(n_pus=4, costs=_costs(p), rerank_workers=2)
    rng = np.random.default_rng(0)
    n = 4000
    pus = rng.integers(0, 4, n)

    def offered(mult):
        return np.cumsum(rng.exponential(1.0 / (mult * 20000.0), n))
    arr8 = offered(8)
    return dict(
        noshed=sim.dynamic(arr8, pus, threshold=8, wait_limit_s=1e-3),
        shed=sim.dynamic(arr8, pus, threshold=8, wait_limit_s=1e-3,
                         shed_deadline_s=2e-3),
        shed4=sim.dynamic(offered(4), pus, threshold=8, wait_limit_s=1e-3,
                          shed_deadline_s=2e-3))


def breakdown(p, s):
    sim = p.EventSimulator(n_pus=8, costs=_costs(p), rerank_workers=4)
    return dict(rep=sim.pipeline(500, 8))


def retries(p, s):
    sim = p.EventSimulator(n_pus=4, costs=_costs(p), rerank_workers=2)
    rng = np.random.default_rng(1)
    n = 4000
    pus = rng.integers(0, 4, n)
    arr = np.cumsum(rng.exponential(1.0 / (8 * 20000.0), n))
    kw = dict(threshold=8, wait_limit_s=1e-3, shed_deadline_s=2e-3)
    return dict(
        base=sim.dynamic(arr, pus, **kw),
        rt=sim.dynamic(arr, pus, retry=p.RetryPolicy(max_attempts=3,
                                                     backoff_s=4e-3), **kw),
        one=sim.dynamic(arr, pus, retry=p.RetryPolicy(max_attempts=1), **kw),
        no_dl=sim.dynamic(arr, pus, threshold=8, wait_limit_s=1e-3,
                          retry=p.RetryPolicy(max_attempts=3,
                                              backoff_s=4e-3)))


def single_tenant(p, s):
    sim = p.EventSimulator(n_pus=4, costs=_costs(p), rerank_workers=2)
    rng = np.random.default_rng(0)
    n = 2000
    pus = rng.integers(0, 4, n)
    arr = np.cumsum(rng.exponential(1.0 / (2 * 20000.0), n))
    kw = dict(threshold=8, wait_limit_s=1e-3)
    return dict(plain=sim.dynamic(arr, pus, **kw),
                labeled=sim.dynamic(arr, pus, tenant_of=np.zeros(n, int),
                                    **kw))


def noisy_neighbor(p, s):
    sim = p.EventSimulator(n_pus=4, costs=_tenancy_costs(p),
                           rerank_workers=4)
    rng = np.random.default_rng(3)
    arr, pus, tid = _mixed_stream(rng, [4000, 32000], 0.125, 4)
    kw = dict(threshold=8, wait_limit_s=1e-3, shed_deadline_s=2e-3)
    v = tid == 0
    return dict(
        shared=sim.dynamic(arr, pus, tenant_of=tid, tenant_weights=[4, 1],
                           tenant_deadline_s=[1.0, 2e-3], **kw),
        iso=sim.dynamic(arr[v], pus[v],
                        tenant_of=np.zeros(int(v.sum()), int),
                        tenant_weights=[4.0], tenant_deadline_s=[1.0], **kw),
        n_victim=int(v.sum()), n_aggressor=int((~v).sum()))


def weighted_goodput(p, s):
    sim = p.EventSimulator(n_pus=4, costs=_tenancy_costs(p),
                           rerank_workers=4)
    rng = np.random.default_rng(5)
    arr, pus, tid = _mixed_stream(rng, [30000, 30000], 0.1, 4)
    return dict(r=sim.dynamic(arr, pus, tenant_of=tid, tenant_weights=[3, 1],
                              tenant_deadline_s=[20e-3, 20e-3], threshold=8,
                              wait_limit_s=1e-3, shed_deadline_s=20e-3),
                counts=[int((tid == t).sum()) for t in (0, 1)])


def hedged_tail(p, s):
    sim = p.EventSimulator(n_pus=4, costs=_sim_costs(p), rerank_workers=2,
                           fifo_depth=4)
    speed = [10.0, 1.0, 1.0, 1.0]
    base = sim.pipeline(256, 8, pu_speed=speed)
    dr = s.DeadlineReissue(k=2.0, max_reissue=1,
                           tracker=s.EwmaTracker(alpha=0.2))
    hedged = sim.pipeline(256, 8, pu_speed=speed, hedge=dr,
                          hedge_groups=[[0, 1], [2, 3]])
    return dict(base=base, hedged=hedged)


def hedged_deterministic(p, s):
    sim = p.EventSimulator(n_pus=4, costs=_sim_costs(p), rerank_workers=2)
    runs = []
    for _ in range(2):
        dr = s.DeadlineReissue(k=2.0, max_reissue=1)
        runs.append(sim.pipeline(128, 8, pu_speed=[10, 1, 1, 1], hedge=dr,
                                 hedge_groups=[[0, 1], [2, 3]]))
    return dict(a=runs[0], b=runs[1])


# ---------------------------------------------------------------------------
# the JAX tests' own assertions, on one package's results
# ---------------------------------------------------------------------------

def check_policy_ordering(r):
    assert r["dyn"].qps > r["bs"].qps
    assert r["dyn"].qps > 1.8 * r["pq"].qps
    assert r["dyn"].qps > r["p1"].qps


def check_tuner_and_ladder(r):
    n, per_q = r["n"], r["per_q"]
    assert n >= 2 and n * 512 <= 8192
    assert per_q[n] <= 1.05 * min(per_q.values())
    assert r["ladders"] == [(1, 2, 4, 8, 16, 32, 64),
                            (1, 2, 4, 8, 12, 16, 32, 64),
                            (1, 2, 4, 8, 16), (1,)]


def check_round_robin(r):
    assert [b[0] for b in r["even"]] == [0, 1, 2, 3, 0, 1, 2, 3]
    assert all(b[1] == 4 for b in r["even"])
    assert [b[0] for b in r["uneven"]] == [0, 1, 0, 0]
    assert [b[1] for b in r["uneven"]] == [4, 4, 4, 1]


def check_interleave_vs_grouped(r):
    assert r["inter"].qps >= r["grouped"].qps * 0.99
    assert r["inter"].mean_latency_s <= r["grouped"].mean_latency_s


def check_end_of_stream(r):
    assert r["one"].n_queries == 1 and r["one"].makespan_s >= 1e-3
    assert r["two"].makespan_s >= 4e-4 + 1e-3


def check_shedding(r):
    noshed, shed = r["noshed"], r["shed"]
    assert noshed.shed_fraction == 0.0 and shed.n_shed > 0
    assert shed.n_queries + shed.n_shed == 4000
    assert shed.mean_latency_s < noshed.mean_latency_s / 3
    assert shed.mean_latency_s < 5 * 2e-3
    assert shed.qps <= 1.25 * r["shed4"].qps


def check_breakdown(r):
    rep = r["rep"]
    assert rep.n_queries == 500 and rep.makespan_s > 0
    pool = {"prep": 1, "xfer_in": 1, "xfer_out": 1, "search": 8,
            "rerank": 4}
    for stage, frac in rep.stage_busy.items():
        assert 0 <= frac <= pool[stage] + 1e-3, (stage, frac)


def check_retries(r):
    base, rt, one, no_dl = r["base"], r["rt"], r["one"], r["no_dl"]
    assert base.n_retries == 0 and rt.n_retries > 0
    assert rt.shed_fraction < base.shed_fraction
    assert rt.n_queries + rt.n_shed == 4000
    assert rt.qps >= base.qps / 1.5
    assert rt.mean_latency_s >= base.mean_latency_s
    assert one.n_retries == 0 and one.n_shed == base.n_shed
    assert no_dl.n_retries == 0 and no_dl.n_shed == 0


def check_single_tenant(r):
    plain, labeled = r["plain"], r["labeled"]
    assert labeled.qps == plain.qps
    assert labeled.makespan_s == plain.makespan_s
    assert labeled.mean_latency_s == plain.mean_latency_s
    assert labeled.n_shed == plain.n_shed == 0
    assert labeled.tenant_queries == {0: plain.n_queries}
    assert labeled.tenant_shed == {0: 0}
    assert plain.tenant_queries == {}


def check_noisy_neighbor(r):
    shared, iso = r["shared"], r["iso"]
    assert shared.tenant_shed[0] == 0
    assert shared.tenant_shed[1] >= int(0.25 * r["n_aggressor"])
    assert shared.tenant_queries[0] == r["n_victim"]
    assert shared.tenant_p99_s[0] <= 1.5 * iso.tenant_p99_s[0]


def check_weighted_goodput(r):
    rep = r["r"]
    assert rep.tenant_shed[0] > 0 and rep.tenant_shed[1] > 0
    ratio = rep.tenant_queries[0] / rep.tenant_queries[1]
    assert 0.8 * 3.0 <= ratio <= 1.2 * 3.0
    for t in (0, 1):
        assert rep.tenant_queries[t] + rep.tenant_shed[t] == r["counts"][t]


def check_hedged_tail(r):
    base, hedged = r["base"], r["hedged"]
    assert base.n_queries == hedged.n_queries == 256
    assert base.n_reissued == 0 and base.n_duplicate_drops == 0
    assert hedged.n_reissued > 0
    assert hedged.n_duplicate_drops == hedged.n_reissued
    assert hedged.p99_latency_s <= base.p99_latency_s / 2.0
    assert hedged.qps >= base.qps


def check_hedged_deterministic(r):
    a, b = r["a"], r["b"]
    assert a.p99_latency_s == b.p99_latency_s
    assert a.n_reissued == b.n_reissued
    assert a.makespan_s == b.makespan_s


SCENARIOS = {
    "policy_ordering": (policy_ordering, check_policy_ordering),
    "tuner_and_ladder": (tuner_and_ladder, check_tuner_and_ladder),
    "round_robin": (round_robin, check_round_robin),
    "interleave_vs_grouped": (interleave_vs_grouped,
                              check_interleave_vs_grouped),
    "end_of_stream": (end_of_stream, check_end_of_stream),
    "shedding": (shedding, check_shedding),
    "breakdown": (breakdown, check_breakdown),
    "retries": (retries, check_retries),
    "single_tenant": (single_tenant, check_single_tenant),
    "noisy_neighbor": (noisy_neighbor, check_noisy_neighbor),
    "weighted_goodput": (weighted_goodput, check_weighted_goodput),
    "hedged_tail": (hedged_tail, check_hedged_tail),
    "hedged_deterministic": (hedged_deterministic,
                             check_hedged_deterministic),
}


def _plain(x):
    """A report (or a container of them) as plain Python values."""
    if dataclasses.is_dataclass(x):
        return {"type": type(x).__name__, **_plain(dataclasses.asdict(x))}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def _equal(a, b, path="") -> None:
    """Field-for-field equality, NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulator_reports_equal_jax(name):
    """The same inputs through both packages give equal reports, and the
    port's pass the JAX test's assertions."""
    scenario, check = SCENARIOS[name]
    want = scenario(*PACKAGES["jax"])
    got = scenario(*PACKAGES["torch"])
    _equal(_plain(got), _plain(want))
    check(got)


@pytest.mark.parametrize("kw,match", [
    (dict(max_attempts=0), "max_attempts"),
    (dict(backoff_s=-1.0), "backoff_s"),
])
def test_retry_policy_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tpipe.RetryPolicy(**kw)


@pytest.mark.parametrize("kw,match", [
    (dict(tenant_of=[0, 1], tenant_weights=[1.0, 0.0]),
     "positive tenant weights"),
    (dict(tenant_of=[0, 0], shed_deadline_s=1e-3), "retry"),
], ids=["weights", "retry"])
def test_tenant_validation_matches_jax(kw, match):
    """tests/test_pipeline.py's tenant validation, the same message from
    both packages."""
    for p in (jpipe, tpipe):
        sim = p.EventSimulator(n_pus=2, costs=_costs(p), rerank_workers=1)
        extra = dict(retry=p.RetryPolicy(max_attempts=2)) \
            if match == "retry" else {}
        with pytest.raises(ValueError, match=match):
            sim.dynamic(np.array([0.0, 1e-4]), np.array([0, 1]),
                        threshold=4, wait_limit_s=1e-3, **kw, **extra)
