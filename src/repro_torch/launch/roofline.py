"""Roofline terms from a dry-run's per-rank counts (counterpart of
``repro/launch/roofline.py``), on the H100 constants of ``launch/mesh.py``.

    compute term    = FLOPs / (chips x peak FLOP/s)
    memory term     = HBM bytes / (chips x HBM bandwidth)
    collective term = collective bytes / (chips x link bandwidth)

All three numerators are SYSTEM totals: ``launch/op_stats.py`` counts one
rank's program (aten ops on meta tensors, the port's kernels by
``kernels/cost.py``, the collectives by ``distributed/sharding.py``'s
counts) and the dry-run multiplies by the chip count. Replicated work is
counted on every chip that executes it: the roofline measures time, not
uniqueness.

MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (serve): the
useful-compute yardstick; the counted / model ratio shows remat and
replication waste.
"""

from __future__ import annotations

import dataclasses

__all__ = ["RooflineTerms"]


@dataclasses.dataclass
class RooflineTerms:
    flops: float            # system flops
    hbm_bytes: float        # system HBM traffic
    coll_bytes: float       # system bytes crossing links
    chips: int
    peak_flops: float
    hbm_bw: float
    link_bw: float
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * self.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate: the slowest term (perfect
        overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step time."""
        t = self.step_time_s
        return (self.model_flops / (t * self.chips * self.peak_flops)
                if t else 0.0)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "mfu": self.mfu,
        }
