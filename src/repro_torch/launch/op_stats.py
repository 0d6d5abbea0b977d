"""Per-rank FLOPs, HBM bytes and collective bytes of one rank's program
(counterpart of ``repro/launch/hlo_stats.py``, which reads them from XLA's
per-device HLO).

The port has no compiler to ask, so it runs the rank's program once on
meta tensors (no memory, no numbers) under a ``TorchDispatchMode`` that
sees every aten op:

* FLOPs: matmuls, convolutions and the fused attention ops by
  ``torch.utils.flop_counter``'s formulas (2 m n k for a product);
  elementwise ops count none, as there.
* HBM bytes: each op's tensor operands plus its results (an in-place
  op's result, which is an operand, once), as XLA's traffic counts an
  instruction's;
  views, metadata ops and allocations move nothing (``_FREE_OPS``, the
  reference's ``_FREE_OPS``).
* The port's kernels: a call on meta tensors takes ``kernels/ops.py``'s
  meta route, which counts as one op costed by ``kernels/cost.py`` (its
  operations as the tensor-core FLOPs of the same time, ``Work.flops``;
  its bytes).
* Collectives: ``distributed/sharding.py``'s counts of the run, by kind;
  under an ``AccountingMesh`` they are what a real mesh would count.
* The activation peak: the most bytes of op results alive at once (a
  result that is no view of an operand counts from its op until its
  tensor is freed; a kernel's outputs are allocations and count too).
  Tensors made before the run, the arguments, are not in it.

A layer stack is a Python loop in the port, so every layer's ops are seen
once each: there is no trip count to weight (the reference's while-loop
weighting is what ``weighted_totals`` there is for).

Remat (``torch.utils.checkpoint``) is counted whole: ``count`` runs with
the checkpoint's early stop off, so a region's recompute runs every op of
the region, as XLA's remat does. (With early stop on, the recompute stops
once the backward has the tensors it needs, and where it stops differs
under a dispatch mode; a program run with early stop on may therefore do
a few ops less in each region than the count.)
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..distributed import sharding
from ..kernels import cost

__all__ = ["OpTotals", "OpCounter", "count", "weighted_totals"]

aten = torch.ops.aten

# views, metadata and allocations: no bytes moved
_FREE_OPS = frozenset(p for p in (
    aten.view, aten._unsafe_view, aten.reshape, aten.expand, aten.permute,
    aten.transpose, aten.t, aten.squeeze, aten.unsqueeze, aten.slice,
    aten.select, aten.as_strided, aten.alias, aten.detach, aten.split,
    aten.split_with_sizes, aten.unbind, aten.chunk, aten.narrow,
    aten.view_as, aten.empty, aten.empty_like, aten.new_empty,
    aten.empty_strided, aten.new_empty_strided, aten.lift_fresh,
    aten.unfold, aten.diagonal, aten.movedim, aten.expand_as,
    aten._reshape_alias, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_same_size, aten.set_,
    aten._local_scalar_dense,
) if p is not None)


# the allocations among them: their results hold memory of their own
_ALLOC_OPS = frozenset((aten.empty, aten.empty_like, aten.new_empty,
                        aten.empty_strided, aten.new_empty_strided))


@dataclasses.dataclass
class OpTotals:
    """One rank's counts: ``flops`` (aten products and the kernels'
    operations, ``Work.flops``), ``bytes`` (HBM traffic), ``coll_bytes``
    and ``coll_by_op`` (collectives by kind: bytes), ``kernels`` (by name:
    launches, flops, bytes), ``n_ops`` (aten ops seen, views included),
    ``activation_peak`` (bytes)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    coll_calls: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    matmul_flops: float = 0.0
    n_ops: int = 0
    activation_peak: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op run under it (see the
    module's docstring), and the kernels' work reported through
    ``cost.record``; ``totals`` holds them."""

    def __init__(self):
        super().__init__()
        self.totals = OpTotals()
        self._live = 0

    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self._live += n
        self.totals.activation_peak = max(self.totals.activation_peak,
                                          self._live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    def kernel(self, name: str, work: cost.Work) -> None:
        k = self.totals.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += work.flops()
        k["bytes"] += work.bytes
        self.totals.flops += work.flops()
        self.totals.bytes += work.bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.totals.n_ops += 1
        if packet in _FREE_OPS:
            if packet in _ALLOC_OPS:
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        self._alloc(t)
            return out
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.totals.flops += f
            self.totals.matmul_flops += f
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        ids = {id(t) for t in ins}
        fresh = [t for t in tree_flatten(out)[0]
                 if isinstance(t, torch.Tensor) and id(t) not in ids]
        self.totals.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in fresh)
        for t in fresh:
            if t._base is None:
                self._alloc(t)
        return out


def count(fn: Callable, *args, **kwargs) -> tuple[Any, OpTotals]:
    """(``fn(*args, **kwargs)``, its ``OpTotals``): the aten ops and
    kernel calls it runs, and the collectives ``sharding.collectives()``
    counts meanwhile (reset before and restored after: the caller's
    counts are not changed)."""
    counts = sharding.collectives()
    saved = counts.counts
    counts.counts = {}
    counter = OpCounter()
    try:
        with cost.recording(counter.kernel), \
                torch.utils.checkpoint.set_checkpoint_early_stop(False), \
                counter:
            out = fn(*args, **kwargs)
        coll = counts.as_dict()
    finally:
        counts.counts = saved
    t = counter.totals
    t.coll_by_op = {k: float(v["bytes"]) for k, v in coll.items()}
    t.coll_calls = {k: v["calls"] for k, v in coll.items()}
    t.coll_bytes = float(sum(t.coll_by_op.values()))
    return out, t


def weighted_totals(fn: Callable, *args, **kwargs) -> OpTotals:
    """``count``'s totals alone (the reference's ``weighted_totals`` of a
    compiled program's HLO; a Python loop needs no trip-count weight)."""
    return count(fn, *args, **kwargs)[1]
