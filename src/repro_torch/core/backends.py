"""Ranking backends of the query path (counterpart of
``repro/core/backends.py``).

A backend owns its slice of the placed index (``index_arrays``), its
per-lane LUT preparation (``prepare_lanes``) and its search kernels
(``search_lanes`` for the beam search, ``rank_ids`` for one hop of the
plain loop, ``scan_cluster`` for the full scan), and declares its rank
dtype and pad rank, so that core/beam_search.py does not depend on any one
backend. ``SearchConfig.mode`` is a registry key.

Every call is batched over lanes: ``shard`` is the placed index with its
shard and cluster axes flattened to one leading (S*Cl,) axis, ``cl`` (L,)
holds each lane's flat cluster index, and a lane bundle holds (L, ...)
tensors. Only the paper's production backend, ``mulfree``, is ported so
far; ``exact`` and ``hamming`` are still to port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from . import mulfree
from ..kernels import ops as kernel_ops
from ..kernels.ref import lockstep_beam_search, wrap_int32

__all__ = ["LaneConfig", "RankingBackend", "register_backend", "get_backend",
           "available_backends", "MulFreeBackend", "MulFreeArrays",
           "MulFreeLanes"]

INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class LaneConfig:
    """Search geometry shared by every lane of one search."""
    ef: int
    max_iters: int
    dim: int


class MulFreeArrays(NamedTuple):
    """O3's slice of the compact index."""
    f_add: torch.Tensor   # (..., M) int32
    rho: torch.Tensor     # (...,) f32
    shift1: torch.Tensor  # (...,) int32
    shift2: torch.Tensor  # (...,) int32


class MulFreeLanes(NamedTuple):
    """Integer LUT per lane; the scale is folded in on the host."""
    lut: torch.Tensor     # (L, Dpad) int32
    sumq: torch.Tensor    # (L,) int32


class RankingBackend:
    """One candidate-ranking variant of the in-PU search."""

    name: str = "?"
    rank_dtype: torch.dtype = torch.int32

    @property
    def pad_rank(self):
        """Sentinel rank for -1 / invalid ids; sorts after every real rank."""
        raise NotImplementedError

    def index_arrays(self, idx) -> Any:
        """This backend's per-node / per-cluster tensors of a CompactIndex."""
        raise NotImplementedError

    def prepare_lanes(self, qv, cv, rotation, arrays, lane_cl, dim: int):
        """Per-lane LUTs. qv / cv (L, D) query / centroid rows, ``arrays``
        this backend's flat slice, lane_cl (L,) flat cluster ids."""
        raise NotImplementedError

    def rank_ids(self, shard, cl, ids, lanes, dim: int):
        """Rank (L, R) local node ids of cluster cl[l] per lane; -1 ids get
        ``pad_rank``."""
        raise NotImplementedError

    def rank_cluster(self, shard, cl, lanes, dim: int):
        """Rank every node of cluster cl[l] per lane: (L, M)."""
        raise NotImplementedError

    def search_lanes(self, shard, cl, lanes, cfg: LaneConfig, active):
        """The greedy beam search of every lane over cluster cl[l]:
        -> (ids (L, EF) int32 local, ranks (L, EF), hops (L,) int32).
        ``active`` (L,) bool marks the lanes to search; the others rank
        their entry and report 0 hops. This default is the plain lock-step
        loop (``ref.lockstep_beam_search``), ranking each hop's neighbours
        with ``rank_ids``. No registered backend takes it today:
        ``MulFreeBackend`` overrides it with one ``beam_search`` launch."""
        m, r = shard.neighbors.shape[-2:]
        return lockstep_beam_search(
            shard.neighbors.reshape(-1, r), cl.to(torch.int32) * m,
            shard.entry[cl], active, m=m, ef=cfg.ef,
            max_iters=cfg.max_iters, pad=self.pad_rank,
            rank_dtype=self.rank_dtype,
            rank=lambda ids: self.rank_ids(shard, cl, ids, lanes, cfg.dim))

    def scan_cluster(self, shard, cl, lanes, dim: int, ef: int, active):
        """The EF best nodes of cluster cl[l] per lane, in the order of the
        reference's ``lax.top_k`` over the negated int32 ranks: ascending
        rank, ties to the lower node id, nodes at n_valid or beyond ranking
        ``pad_rank``, a rank of INT_MIN last (its negation wraps to
        itself). -> (ids (L, EF) int32 local, ranks (L, EF)). ``active``
        (L,) bool marks the lanes the engine keeps; this default ranks
        every lane through the (L, M) table of ``rank_cluster``."""
        m = shard.codes.shape[-2]
        node_valid = torch.arange(m, device=cl.device)[None, :] \
            < shard.n_valid[cl][:, None]
        r = torch.where(node_valid, self.rank_cluster(shard, cl, lanes, dim),
                        self.pad_rank)
        neg, ids = torch.sort(wrap_int32(-r.long()), dim=1, descending=True,
                              stable=True)
        return ids[:, :ef].to(torch.int32), wrap_int32(-neg[:, :ef].long())


_REGISTRY: dict[str, RankingBackend] = {}


def register_backend(backend: RankingBackend) -> RankingBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> RankingBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown ranking backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


class MulFreeBackend(RankingBackend):
    """O3: int LUT adds + shift-add 1/alpha."""

    name = "mulfree"
    rank_dtype = torch.int32

    @property
    def pad_rank(self):
        return INT_MAX

    def index_arrays(self, idx) -> MulFreeArrays:
        return MulFreeArrays(f_add=idx.f_add, rho=idx.rho,
                             shift1=idx.shift1, shift2=idx.shift2)

    def prepare_lanes(self, qv, cv, rotation, arrays: MulFreeArrays,
                      lane_cl, dim) -> MulFreeLanes:
        zero = torch.zeros_like(arrays.rho[lane_cl])
        consts = mulfree.ClusterConstants(
            zero, arrays.rho[lane_cl],
            mulfree.AlphaShifts(zero.int(), zero.int(), zero))
        lut, sumq = mulfree.prepare_int_lut(qv, cv, rotation, consts, dim)
        return MulFreeLanes(lut=lut, sumq=sumq)

    def _rank_rows(self, shard, cl, rows, lanes: MulFreeLanes, dim):
        a: MulFreeArrays = shard.arrays
        return kernel_ops.binary_ip_rank(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            a.f_add.reshape(-1), rows.contiguous(), lanes.lut, lanes.sumq,
            a.shift1[cl].contiguous(), a.shift2[cl].contiguous(), dim)

    def rank_ids(self, shard, cl, ids, lanes: MulFreeLanes, dim):
        m = shard.codes.shape[-2]
        rows = cl[:, None].to(torch.int32) * m + ids.clamp(0, m - 1)
        rows = torch.where(ids >= 0, rows, -1).to(torch.int32)
        return self._rank_rows(shard, cl, rows, lanes, dim)

    def rank_cluster(self, shard, cl, lanes: MulFreeLanes, dim):
        m = shard.codes.shape[-2]
        rows = cl[:, None].to(torch.int32) * m + torch.arange(
            m, dtype=torch.int32, device=cl.device)
        return self._rank_rows(shard, cl, rows, lanes, dim)

    def search_lanes(self, shard, cl, lanes: MulFreeLanes, cfg, active):
        """One ``beam_search`` launch runs every lane's whole loop, the O3
        rank of each hop fused in; the same ids, ranks and hops as the plain
        loop of the base class."""
        a: MulFreeArrays = shard.arrays
        m, r = shard.neighbors.shape[-2:]
        return kernel_ops.beam_search(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            a.f_add.reshape(-1), shard.neighbors.reshape(-1, r),
            (cl.to(torch.int32) * m).contiguous(),
            shard.entry[cl].contiguous(), lanes.lut, lanes.sumq,
            a.shift1[cl].contiguous(), a.shift2[cl].contiguous(),
            active.contiguous(), cfg.dim, cfg.ef, cfg.max_iters, m)

    def scan_cluster(self, shard, cl, lanes: MulFreeLanes, dim, ef, active):
        """One ``cluster_scan`` launch over all lanes: the fused rank and
        top-EF, without the (L, M) rank table; inactive lanes read
        nothing."""
        a: MulFreeArrays = shard.arrays
        m = shard.codes.shape[-2]
        return kernel_ops.cluster_scan(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            a.f_add.reshape(-1), (cl.to(torch.int32) * m).contiguous(),
            shard.n_valid[cl].contiguous(), lanes.lut, lanes.sumq,
            a.shift1[cl].contiguous(), a.shift2[cl].contiguous(),
            active.contiguous(), dim, ef, m)


register_backend(MulFreeBackend())
