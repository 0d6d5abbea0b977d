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
tensors. Three backends are registered, as in the JAX package:
``mulfree`` (the paper's O3 kernel), ``exact`` (the SymphonyQG estimator
with per-node ``cos_theta``, float32 ranks: the comparand of the paper's
recall claim) and ``hamming`` (the sign-only pre-rank, no per-node
metadata). Each runs its beam search in one ``beam_search`` launch and its
GEMV scan in one ``cluster_scan`` launch, its rank fused into both
(``KernelBackend``); a backend registered from outside that only ranks
(``rank_ids`` / ``rank_cluster``) takes the base class's plain loop and
rank table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from . import mulfree, rabitq
from ..kernels import ops as kernel_ops
from ..kernels import ref as kernel_ref
from ..kernels.ranks import F32_MAX, INT_MAX, ExactRank, HammingRank, O3Rank

__all__ = ["LaneConfig", "RankingBackend", "KernelBackend",
           "register_backend", "get_backend", "available_backends",
           "MulFreeBackend", "ExactBackend", "HammingBackend",
           "MulFreeArrays", "ExactArrays", "HammingArrays", "MulFreeLanes",
           "ExactLanes", "HammingLanes", "meta_tensor"]


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


class ExactArrays(NamedTuple):
    """The SymphonyQG estimator's per-node factors."""
    residual_norm: torch.Tensor   # (..., M) f32
    cos_theta: torch.Tensor       # (..., M) f32


class ExactLanes(NamedTuple):
    lut: torch.Tensor         # (L, Dpad) f32 rotated unit query residual
    sum_lut: torch.Tensor     # (L,) f32
    query_norm: torch.Tensor  # (L,) f32


class HammingArrays(NamedTuple):
    """The sign-only pre-rank needs nothing beyond the shared codes."""


class HammingLanes(NamedTuple):
    qcode: torch.Tensor       # (L, W) uint8 packed sign code of the query


def meta_tensor(shape, dtype=torch.float32) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` without storage (the JAX
    package's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _rows(shard, cl, ids) -> torch.Tensor:
    """Flat code-table rows of the (L, R) local ids of cluster cl[l], -1
    where an id is -1."""
    m = shard.codes.shape[-2]
    rows = cl[:, None].to(torch.int32) * m + ids.clamp(0, m - 1)
    return torch.where(ids >= 0, rows, -1).to(torch.int32)


def _cluster_rows(shard, cl) -> torch.Tensor:
    """(L, M) flat rows of every node of cluster cl[l]."""
    m = shard.codes.shape[-2]
    return cl[:, None].to(torch.int32) * m + torch.arange(
        m, dtype=torch.int32, device=cl.device)


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

    def array_specs(self, lead: tuple[int, ...], budget: int, dim: int
                    ) -> Any:
        """``index_arrays``'s tree as meta tensors (no storage) with leading
        dims ``lead`` (e.g. (S, C/S)): shapes and dtypes for accounting at
        scales no device holds (the JAX package's ``ShapeDtypeStruct``
        stand-ins)."""
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
        with ``rank_ids``. No registered backend takes it: each is a
        ``KernelBackend``, which overrides it with one ``beam_search``
        launch."""
        m, r = shard.neighbors.shape[-2:]
        return kernel_ref.lockstep_beam_search(
            shard.neighbors.reshape(-1, r), cl.to(torch.int32) * m,
            shard.entry[cl], active, m=m, ef=cfg.ef,
            max_iters=cfg.max_iters, pad=self.pad_rank,
            rank_dtype=self.rank_dtype,
            rank=lambda ids: self.rank_ids(shard, cl, ids, lanes, cfg.dim))

    def scan_cluster(self, shard, cl, lanes, dim: int, ef: int, active):
        """The EF best nodes of cluster cl[l] per lane, in the order of the
        reference's ``lax.top_k`` over the negated ranks
        (``ref.scan_order``): ascending rank, ties to the lower node id,
        nodes at n_valid or beyond ranking ``pad_rank``; an int32 rank of
        INT_MIN last (its negation wraps to itself), a float32 rank in
        total order (-0.0 first, NaN last). -> (ids (L, EF) int32 local,
        ranks (L, EF)). ``active`` (L,) bool marks the lanes the engine
        keeps; this default ranks every lane through the (L, M) table of
        ``rank_cluster``."""
        m = shard.codes.shape[-2]
        node_valid = torch.arange(m, device=cl.device)[None, :] \
            < shard.n_valid[cl][:, None]
        r = torch.where(node_valid, self.rank_cluster(shard, cl, lanes, dim),
                        self.pad_rank)
        ids = torch.sort(kernel_ref.scan_order(r), dim=1,
                         stable=True).indices[:, :ef]
        return ids.to(torch.int32), torch.gather(r, 1, ids)


class KernelBackend(RankingBackend):
    """A backend whose rank the ``beam_search`` and ``cluster_scan`` kernels
    carry: ``search_lanes`` and ``scan_cluster`` are one launch of each,
    given the kernels' rank operands (``rank_operands``); on CPU tensors
    the seam runs their plain versions."""

    def rank_operands(self, shard, cl, lanes):
        """The kernels' rank tuple (``kernels/ranks.py``) over the flat
        code table and the L lanes."""
        raise NotImplementedError

    def search_lanes(self, shard, cl, lanes, cfg: LaneConfig, active):
        """One ``beam_search`` launch runs every lane's whole loop, the
        rank of each hop fused in; the same ids, ranks and hops as the
        plain loop of the base class."""
        m, r = shard.neighbors.shape[-2:]
        return kernel_ops.ranked_beam_search(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            self.rank_operands(shard, cl, lanes),
            shard.neighbors.reshape(-1, r),
            (cl.to(torch.int32) * m).contiguous(),
            shard.entry[cl].contiguous(), active.contiguous(), cfg.dim,
            cfg.ef, cfg.max_iters, m)

    def scan_cluster(self, shard, cl, lanes, dim, ef, active):
        """One ``cluster_scan`` launch over all lanes: the fused rank and
        top-EF, without the (L, M) rank table; inactive lanes read
        nothing."""
        m = shard.codes.shape[-2]
        return kernel_ops.ranked_cluster_scan(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            self.rank_operands(shard, cl, lanes),
            (cl.to(torch.int32) * m).contiguous(),
            shard.n_valid[cl].contiguous(), active.contiguous(), dim, ef, m)


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


class MulFreeBackend(KernelBackend):
    """O3: int LUT adds + shift-add 1/alpha."""

    name = "mulfree"
    rank_dtype = torch.int32

    @property
    def pad_rank(self):
        return INT_MAX

    def index_arrays(self, idx) -> MulFreeArrays:
        return MulFreeArrays(f_add=idx.f_add, rho=idx.rho,
                             shift1=idx.shift1, shift2=idx.shift2)

    def array_specs(self, lead, budget, dim) -> MulFreeArrays:
        return MulFreeArrays(f_add=meta_tensor((*lead, budget), torch.int32),
                             rho=meta_tensor(lead, torch.float32),
                             shift1=meta_tensor(lead, torch.int32),
                             shift2=meta_tensor(lead, torch.int32))

    def prepare_lanes(self, qv, cv, rotation, arrays: MulFreeArrays,
                      lane_cl, dim) -> MulFreeLanes:
        zero = torch.zeros_like(arrays.rho[lane_cl])
        consts = mulfree.ClusterConstants(
            zero, arrays.rho[lane_cl],
            mulfree.AlphaShifts(zero.int(), zero.int(), zero))
        lut, sumq = mulfree.prepare_int_lut(qv, cv, rotation, consts, dim)
        return MulFreeLanes(lut=lut, sumq=sumq)

    def rank_operands(self, shard, cl, lanes: MulFreeLanes) -> O3Rank:
        a: MulFreeArrays = shard.arrays
        return O3Rank(a.f_add.reshape(-1), lanes.lut, lanes.sumq,
                      a.shift1[cl].contiguous(), a.shift2[cl].contiguous())

    def _rank_rows(self, shard, cl, rows, lanes: MulFreeLanes, dim):
        o3 = self.rank_operands(shard, cl, lanes)
        return kernel_ops.binary_ip_rank(
            shard.codes.reshape(-1, shard.codes.shape[-1]), o3.f_add,
            rows.contiguous(), o3.lut, o3.sumq, o3.s1, o3.s2, dim)

    def rank_ids(self, shard, cl, ids, lanes: MulFreeLanes, dim):
        return self._rank_rows(shard, cl, _rows(shard, cl, ids), lanes, dim)

    def rank_cluster(self, shard, cl, lanes: MulFreeLanes, dim):
        return self._rank_rows(shard, cl, _cluster_rows(shard, cl), lanes,
                               dim)


class ExactBackend(KernelBackend):
    """The per-node float estimator: SymphonyQG's, the baseline the paper
    measures the O3 kernel's recall against."""

    name = "exact"
    rank_dtype = torch.float32

    @property
    def pad_rank(self):
        return F32_MAX

    def index_arrays(self, idx) -> ExactArrays:
        return ExactArrays(residual_norm=idx.residual_norm,
                           cos_theta=idx.cos_theta)

    def array_specs(self, lead, budget, dim) -> ExactArrays:
        return ExactArrays(
            residual_norm=meta_tensor((*lead, budget), torch.float32),
            cos_theta=meta_tensor((*lead, budget), torch.float32))

    def prepare_lanes(self, qv, cv, rotation, arrays, lane_cl,
                      dim) -> ExactLanes:
        qlut = rabitq.prepare_query(qv, cv, rotation)
        pad = (-dim) % 8
        g = torch.nn.functional.pad(qlut.lut, (0, pad)) if pad else qlut.lut
        return ExactLanes(lut=g.contiguous(), sum_lut=qlut.sum_lut,
                          query_norm=qlut.query_norm)

    def rank_operands(self, shard, cl, lanes: ExactLanes) -> ExactRank:
        a: ExactArrays = shard.arrays
        return ExactRank(a.residual_norm.reshape(-1),
                         a.cos_theta.reshape(-1), lanes.lut, lanes.sum_lut,
                         lanes.query_norm)

    def _rank_rows(self, shard, cl, rows, lanes: ExactLanes, dim):
        e = self.rank_operands(shard, cl, lanes)
        return kernel_ref.exact_rank_ref(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            e.residual_norm, e.cos_theta, rows, e.lut, e.sum_lut,
            e.query_norm, dim)

    def rank_ids(self, shard, cl, ids, lanes: ExactLanes, dim):
        return self._rank_rows(shard, cl, _rows(shard, cl, ids), lanes, dim)

    def rank_cluster(self, shard, cl, lanes: ExactLanes, dim):
        return self._rank_rows(shard, cl, _cluster_rows(shard, cl), lanes,
                               dim)


class HammingBackend(KernelBackend):
    """popcount(code XOR sign(q)): ranks by angle alone, with no per-node
    metadata and a lane payload of one packed sign code (D/8 bytes)."""

    name = "hamming"
    rank_dtype = torch.int32

    @property
    def pad_rank(self):
        return INT_MAX

    def index_arrays(self, idx) -> HammingArrays:
        return HammingArrays()

    def array_specs(self, lead, budget, dim) -> HammingArrays:
        return HammingArrays()

    def prepare_lanes(self, qv, cv, rotation, arrays, lane_cl,
                      dim) -> HammingLanes:
        return HammingLanes(qcode=rabitq.sign_code(qv, cv, rotation,
                                                   dim=dim).contiguous())

    def rank_operands(self, shard, cl, lanes: HammingLanes) -> HammingRank:
        return HammingRank(lanes.qcode)

    def rank_ids(self, shard, cl, ids, lanes: HammingLanes, dim):
        return kernel_ref.hamming_rank_ref(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            _rows(shard, cl, ids), lanes.qcode)

    def rank_cluster(self, shard, cl, lanes: HammingLanes, dim):
        return kernel_ref.hamming_rank_ref(
            shard.codes.reshape(-1, shard.codes.shape[-1]),
            _cluster_rows(shard, cl), lanes.qcode)


register_backend(MulFreeBackend())
register_backend(ExactBackend())
register_backend(HammingBackend())
