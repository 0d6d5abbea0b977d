"""Signal-driven topology autoscaling and heat-driven rebalancing
(counterpart of ``repro/core/autoscale.py``; host side, numpy).

``TopologyReport`` carries the shed fraction, per-tenant latency
percentiles, per-worker credit occupancy (``max_in_flight`` against the
FIFO depth) and the per-cluster scatter heat (``cluster_hits``). Between
streams:

  * ``Autoscaler`` grows a shard group's replicas when the tier sheds,
    misses its latency target or runs its workers at credit saturation for
    ``up_patience`` reports, and shrinks an idle group after
    ``down_patience`` reports (fast up, slow down; streaks reset after
    every action). Global signals are attributed to the hottest group.
  * ``Rebalancer`` re-places clusters when one shard carries more than
    ``skew_high`` times its fair share of routed probes
    (``placement.rebalance``, then the hot set re-picked at the same
    replica capacity) and swaps the placement in through
    ``ServingTopology.apply_placement``, which keeps every engine's shapes.

Replica and worker trees are rebuilt per ``run()``, so a between-runs
resize or swap never meets a half-changed tier.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import compact_index as compact_index_mod
from . import placement as placement_mod

__all__ = ["AutoscalePolicy", "Autoscaler", "ScaleAction",
           "RebalancePolicy", "Rebalancer", "RebalanceAction",
           "tenant_fair_heat"]


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds + hysteresis for the replica autoscaler.

    ``p99_high_ms`` is the latency SLO trigger — it checks the WORST
    per-tenant p99 when tenants are configured (a noisy neighbor must not
    hide a starved tenant inside the global percentile) and the global
    p99 otherwise. ``None`` disables the latency trigger."""

    min_replicas: int = 1
    max_replicas: int = 4
    shed_high: float = 0.01          # shed_fraction above this = overload
    p99_high_ms: float | None = None
    occupancy_high: float = 0.9      # worker credit saturation
    occupancy_low: float = 0.25      # idle enough to consider shrinking
    up_patience: int = 1             # consecutive hot reports before growing
    down_patience: int = 3           # consecutive idle reports before shrinking
    step: int = 1                    # replicas added/removed per action

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if not 0.0 <= self.shed_high < 1.0:
            raise ValueError(f"shed_high must be in [0, 1), got {self.shed_high}")
        if self.p99_high_ms is not None and not self.p99_high_ms > 0:
            raise ValueError(f"p99_high_ms must be > 0 or None, "
                             f"got {self.p99_high_ms}")
        if not 0.0 < self.occupancy_high <= 1.0:
            raise ValueError(f"occupancy_high must be in (0, 1], "
                             f"got {self.occupancy_high}")
        if not 0.0 <= self.occupancy_low < self.occupancy_high:
            raise ValueError(
                f"need 0 <= occupancy_low < occupancy_high, got "
                f"{self.occupancy_low} vs {self.occupancy_high}")
        if self.up_patience < 1 or self.down_patience < 1:
            raise ValueError("patience counters must be >= 1")
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")


@dataclasses.dataclass(frozen=True)
class ScaleAction:
    """One autoscaler decision, kept in ``Autoscaler.actions`` for the
    bench/ops log."""
    group: int
    direction: str           # "up" | "down"
    n_before: int
    n_after: int
    reason: str


class Autoscaler:
    """Consumes ``TopologyReport``s, resizes ``topo``'s shard groups.

    Call ``step(report)`` after every stream; it returns the list of
    ``ScaleAction``s applied (possibly empty). ``observe`` alone computes
    the per-group signal dicts without acting — the unit-test seam."""

    def __init__(self, topo, policy: AutoscalePolicy | None = None):
        if policy is None:
            policy = AutoscalePolicy()
        if not isinstance(policy, AutoscalePolicy):
            raise TypeError(f"policy must be an AutoscalePolicy, "
                            f"got {type(policy).__name__}")
        self.topo = topo
        self.policy = policy
        n_groups = len(topo.groups)
        self._hot = [0] * n_groups
        self._idle = [0] * n_groups
        self.actions: list[ScaleAction] = []

    # -- signal extraction ---------------------------------------------------
    def observe(self, report) -> list[dict]:
        """Per-shard-group signal dict: occupancy (max worker credit
        utilisation), heat share, and whether the group carries the
        tier-global overload signals (shed / p99 breach)."""
        n_groups = len(self.topo.groups)
        occ = np.zeros(n_groups)
        queries = np.zeros(n_groups)
        depth = max(int(getattr(self.topo, "fifo_depth", 1)), 1)
        for pe in report.per_engine:
            g = int(pe.get("shard", 0))
            if 0 <= g < n_groups:
                occ[g] = max(occ[g], pe.get("max_in_flight", 0) / depth)
                queries[g] += pe.get("queries", 0)

        heat = self._heat_share(report, n_groups, queries)
        hottest = int(np.argmax(heat)) if heat.max() > 0 else 0

        p99 = self._worst_p99(report)
        shed_hot = report.shed_fraction > self.policy.shed_high
        p99_hot = (self.policy.p99_high_ms is not None
                   and math.isfinite(p99) and p99 > self.policy.p99_high_ms)

        out = []
        for g in range(n_groups):
            carries_global = g == hottest
            hot = (occ[g] >= self.policy.occupancy_high
                   or (carries_global and (shed_hot or p99_hot)))
            idle = (not hot and occ[g] <= self.policy.occupancy_low
                    and report.shed_fraction == 0.0 and not p99_hot)
            out.append({
                "occupancy": float(occ[g]), "heat": float(heat[g]),
                "queries": float(queries[g]), "hottest": carries_global,
                "hot": bool(hot), "idle": bool(idle),
            })
        return out

    def _heat_share(self, report, n_groups: int,
                    queries: np.ndarray) -> np.ndarray:
        """Per-group share of scatter heat: fold ``cluster_hits`` through
        the cluster partition when both exist, else fall back to per-group
        served-query counts."""
        hits = getattr(report, "cluster_hits", None)
        part_of = getattr(self.topo, "part_of", None)
        if hits is not None and part_of is not None:
            part_of = np.asarray(part_of)
            if len(hits) == len(part_of):
                heat = np.zeros(n_groups)
                np.add.at(heat, part_of, np.asarray(hits, np.float64))
                if heat.sum() > 0:
                    return heat / heat.sum()
        total = queries.sum()
        return queries / total if total > 0 else np.zeros(n_groups)

    def _worst_p99(self, report) -> float:
        tenants = getattr(report, "tenants", None) or {}
        per_tenant = [t.get("p99_ms", float("nan")) for t in tenants.values()
                      if t.get("n_admitted", 0) > 0]
        per_tenant = [p for p in per_tenant if math.isfinite(p)]
        if per_tenant:
            return max(per_tenant)
        p = report.p99_ms
        return p if math.isfinite(p) else float("nan")

    # -- the control loop ----------------------------------------------------
    def step(self, report) -> list[ScaleAction]:
        """Update streaks from one report and apply any due resizes."""
        pol = self.policy
        applied: list[ScaleAction] = []
        for g, sig in enumerate(self.observe(report)):
            if sig["hot"]:
                self._hot[g] += 1
                self._idle[g] = 0
            elif sig["idle"]:
                self._idle[g] += 1
                self._hot[g] = 0
            else:
                self._hot[g] = 0
                self._idle[g] = 0

            n = len(self.topo.groups[g])
            if self._hot[g] >= pol.up_patience and n < pol.max_replicas:
                target = min(n + pol.step, pol.max_replicas)
                self.topo.scale_replicas(g, target)
                applied.append(ScaleAction(
                    group=g, direction="up", n_before=n, n_after=target,
                    reason=(f"occupancy={sig['occupancy']:.2f} "
                            f"shed={report.shed_fraction:.3f} hot streak "
                            f"{self._hot[g]}>={pol.up_patience}")))
                self._hot[g] = 0
                self._idle[g] = 0
            elif self._idle[g] >= pol.down_patience and n > pol.min_replicas:
                target = max(n - pol.step, pol.min_replicas)
                self.topo.scale_replicas(g, target)
                applied.append(ScaleAction(
                    group=g, direction="down", n_before=n, n_after=target,
                    reason=(f"occupancy={sig['occupancy']:.2f} idle streak "
                            f"{self._idle[g]}>={pol.down_patience}")))
                self._hot[g] = 0
                self._idle[g] = 0
        self.actions.extend(applied)
        return applied

    def __repr__(self) -> str:
        return (f"Autoscaler(groups={[len(g) for g in self.topo.groups]}, "
                f"actions={len(self.actions)})")


# ---------------------------------------------------------------------------
# SHARD-axis action: heat-driven placement rebalancing
# ---------------------------------------------------------------------------

def tenant_fair_heat(report) -> np.ndarray | None:
    """Fold per-tenant ``cluster_hits`` into ONE placement heat vector
    where each tenant contributes in proportion to its admission WEIGHT,
    not its query volume — a noisy tenant's hotspot cannot silently starve
    a light tenant's placement. Each tenant's heat is normalized to sum to
    its weight share, then the combined vector is rescaled to the global
    ``cluster_hits`` mass so downstream thresholds keep their units.
    Returns None when the report carries no per-tenant heat (replicated
    tiers, or reports predating the per-tenant counters)."""
    hits = getattr(report, "cluster_hits", None)
    tenants = getattr(report, "tenants", None) or {}
    per = [(t.get("weight", 1.0), np.asarray(t["cluster_hits"], np.float64))
           for t in tenants.values()
           if t.get("cluster_hits") is not None
           and np.asarray(t["cluster_hits"]).sum() > 0]
    if not per:
        return None if hits is None else np.asarray(hits, np.float64)
    wsum = sum(w for w, _ in per)
    fair = sum((w / wsum) * (h / h.sum()) for w, h in per)
    total = float(np.asarray(hits).sum()) if hits is not None else 1.0
    return fair * total


@dataclasses.dataclass(frozen=True)
class RebalancePolicy:
    """Heat-skew trigger + migration cost model for the SHARD-axis
    autoscaling action: when measured scatter heat concentrates on one
    shard, re-place clusters through ``placement.rebalance`` (+ re-pick
    the replicated hot set) and swap the result into the live topology
    via ``ServingTopology.apply_placement``, which swap-based rebalancing
    allows because it preserves every engine's cluster count.

    ``skew_high`` triggers on the hottest shard's share of routed load
    relative to the fair share 1/S (1.5 = "one shard carries 1.5x its
    fair share"); ``patience`` consecutive skewed reports are required
    (the same anti-flapping hysteresis the replica autoscaler uses).
    ``move_penalty`` prices migration (see ``placement.rebalance``);
    ``min_hits`` ignores reports too small to trust; ``tenant_fair``
    combines per-tenant heat by tenant weight instead of raw volume."""

    skew_high: float = 1.5
    patience: int = 1
    move_penalty: float = 0.02
    max_moves: int | None = None
    min_hits: int = 1
    tenant_fair: bool = True

    def __post_init__(self):
        if not self.skew_high > 1.0:
            raise ValueError(f"skew_high must be > 1 (1 = perfectly "
                             f"balanced), got {self.skew_high}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if not self.move_penalty >= 0:
            raise ValueError(f"move_penalty must be >= 0, "
                             f"got {self.move_penalty}")
        if self.max_moves is not None and self.max_moves < 2:
            raise ValueError(f"max_moves must be >= 2 (one swap) or None, "
                             f"got {self.max_moves}")
        if self.min_hits < 0:
            raise ValueError(f"min_hits must be >= 0, got {self.min_hits}")


@dataclasses.dataclass(frozen=True)
class RebalanceAction:
    """One applied rebalance, kept in ``Rebalancer.actions``."""
    skew_before: float       # hottest-shard load share x n_shards
    n_moved: int             # primary clusters whose shard changed
    replicated: int          # clusters carrying replica owners after
    reason: str


class Rebalancer:
    """Consumes ``TopologyReport``s, re-places clusters on the live
    ``ServingTopology`` — the SHARD-axis sibling of ``Autoscaler``
    (which only grows replicas and cannot split a hot shard's data).

    Call ``step(report)`` between streams; it returns the applied
    ``RebalanceAction`` or None. The new placement is bootstrapped from
    the current one (``placement.rebalance``: migration-minimizing swaps)
    and, when the topology replicates hot clusters, the replicated set is
    re-picked from the fresh heat with the SAME per-shard replica
    capacity, so ``apply_placement`` re-slices into identical shapes."""

    def __init__(self, topo, policy: RebalancePolicy | None = None):
        if policy is None:
            policy = RebalancePolicy()
        if not isinstance(policy, RebalancePolicy):
            raise TypeError(f"policy must be a RebalancePolicy, "
                            f"got {type(policy).__name__}")
        self.topo = topo
        self.policy = policy
        self._skewed = 0
        self.actions: list[RebalanceAction] = []

    def observe(self, report) -> dict:
        """Skew signal from one report: the hottest shard's share of
        routed queries (``shard_probes`` — actual per-shard load, which
        under replication differs from primary-ownership heat) over the
        fair share 1/S."""
        s_n = len(self.topo.groups)
        probes = getattr(report, "shard_probes", None)
        if probes is None or np.asarray(probes).sum() <= 0:
            hits = getattr(report, "cluster_hits", None)
            if hits is None:
                return {"skew": 0.0, "total": 0.0}
            probes = np.zeros(s_n, np.float64)
            np.add.at(probes, np.asarray(self.topo.part_of),
                      np.asarray(hits, np.float64))
        probes = np.asarray(probes, np.float64)
        total = probes.sum()
        skew = float(probes.max() / total * s_n) if total > 0 else 0.0
        return {"skew": skew, "total": total,
                "shares": probes / total if total > 0 else probes}

    def _heat(self, report) -> np.ndarray:
        heat = tenant_fair_heat(report) if self.policy.tenant_fair else None
        if heat is None:
            heat = np.asarray(report.cluster_hits, np.float64)
        return heat

    def _bytes_per_cluster(self, idx) -> np.ndarray:
        eng0 = self.topo.groups[0][0]
        bpn = compact_index_mod.compact_bytes_per_node(
            eng0.icfg.dim, eng0.icfg.degree)
        if getattr(self.topo, "mutable", False):
            return np.full(idx.n_clusters, float(idx.budget) * bpn)
        return idx.n_valid.cpu().numpy().astype(np.float64) * bpn

    def step(self, report) -> RebalanceAction | None:
        """Update the skew streak from one report; rebalance when due."""
        pol = self.policy
        sig = self.observe(report)
        hits = getattr(report, "cluster_hits", None)
        if hits is None or sig["total"] < pol.min_hits:
            return None
        if sig["skew"] >= pol.skew_high:
            self._skewed += 1
        else:
            self._skewed = 0
            return None
        if self._skewed < pol.patience:
            return None
        self._skewed = 0

        topo = self.topo
        old = topo.placement
        heat = self._heat(report)
        idx = topo._src_index
        bpc = self._bytes_per_cluster(idx)
        new = placement_mod.rebalance(
            old, heat, bpc, mem_budget=getattr(topo, "mem_budget", None),
            move_penalty=pol.move_penalty, max_moves=pol.max_moves)
        if old.replicated:
            # re-pick the hot set from fresh heat, SAME capacity/copies —
            # identical resident counts, so the swap stays shape-stable
            copies = old.owners_of.shape[1] - 1
            top_h = int((old.owners_of[:, 1] >= 0).sum())
            cap = old.resident_table.shape[1] - old.per_shard
            new = placement_mod.replicate_hot(
                new, heat, bpc, top_h=top_h, copies=copies,
                mem_budget=getattr(topo, "mem_budget", None), cap=cap)
        n_moved = int((new.shard_of != old.shard_of).sum())
        if n_moved == 0 and not old.replicated:
            return None                   # nothing worth moving
        topo.apply_placement(new)
        act = RebalanceAction(
            skew_before=sig["skew"], n_moved=n_moved,
            replicated=int((new.owners_of[:, 1] >= 0).sum())
            if new.replicated else 0,
            reason=(f"skew={sig['skew']:.2f}>={pol.skew_high} over "
                    f"{pol.patience} report(s), {n_moved} primaries moved"))
        self.actions.append(act)
        return act

    def __repr__(self) -> str:
        return f"Rebalancer(actions={len(self.actions)})"
