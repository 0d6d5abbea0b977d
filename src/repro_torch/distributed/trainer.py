"""Data-parallel trainer with explicit collectives (counterpart of
``repro/distributed/trainer.py``), one process a rank over
``torch.distributed``.

Each rank holds the whole params and optimizer state, takes its slice of
the global batch, and reduces the gradients by hand, so that the reduction
can be compressed (``distributed/compress.py``). The JAX package's
``shard_map`` over the ('pod', 'data') axes is one rank a data shard here.
On a ('pod', 'data') DeviceMesh the reduction is hierarchical, in the
JAX package's order: a plain mean over 'pod', then the compressed mean
over 'data'. That is what the reference's code does; its docstring says
the reverse ("compress only the cross-pod hop"), which ROADMAP C9 records.

The group's collective backend follows ``launch.mesh.collective_backend``:
NCCL when each rank has a card of its own, gloo otherwise (ranks that share
the one card of the chip machine, or run on the CPU).

Equivalence with ``models.model.make_train_step`` on the whole batch is
held by ``tests/test_torch_trainer.py``.
"""

from __future__ import annotations

from typing import Callable

import torch.distributed as dist

from .. import tree as T
from ..models.model import Model, value_and_grad
from ..optim import adamw
from . import compress

__all__ = ["make_dp_train_step", "data_groups", "reduce_mean"]


def data_groups(group) -> tuple[list, int, int]:
    """(the process groups of the data axes, in the reference's reduction
    order: 'pod' then 'data'; this rank's block of the batch; the number of
    blocks) for ``group``: a process group (None for the default one) or a
    DeviceMesh. A mesh reduces over its 'pod' and 'data' axes, with the
    batch split first-axis-outermost (i_pod |data| + i_data, the
    reference's ``P(('pod', 'data'))``); any other axis of it holds
    replicas, which compute the same. A mesh without either axis must have
    one axis, which serves as 'data'."""
    names = getattr(group, "mesh_dim_names", None)
    if names is None:
        return [group], dist.get_rank(group), dist.get_world_size(group)
    names = list(names)
    axes = [a for a in ("pod", "data") if a in names]
    if not axes:
        if len(names) != 1:
            raise ValueError(f"a DP mesh needs a 'pod' or 'data' axis, got "
                             f"{tuple(names)}")
        axes = names
    coord = group.get_coordinate()
    idx, n = 0, 1
    for a in axes:
        size = group.shape[names.index(a)]
        idx, n = idx * size + coord[names.index(a)], n * size
    return [group.get_group(a) for a in axes], idx, n


def reduce_mean(g, groups: list, compress_grads: bool = True):
    """The mean of ``g`` over the ranks of ``groups`` (``data_groups``'),
    in float32: a plain mean over each group but the last, then the
    compressed (or plain) mean over the last."""
    g = g.float()
    for fast in groups[:-1]:
        g = compress.psum_mean(g, fast)
    if compress_grads:
        return compress.compressed_psum_mean(g, groups[-1])
    return compress.psum_mean(g, groups[-1])


def make_dp_train_step(model: Model, opt_cfg: adamw.AdamWConfig, group=None,
                       *, compress_grads: bool = True,
                       error_feedback: bool = True) -> Callable:
    """Pure data parallelism over ``group`` (a process group, None for the
    default one, or a DeviceMesh with 'pod' and / or 'data' axes); params
    replicated on every rank.

    Returns train_step(params, opt_state, feedback, batch) -> (params,
    opt_state, feedback, metrics {"loss", "grad_norm", "lr"}). ``batch``
    is the global batch, the same on every rank; the rank of data block i
    of n takes rows [i B / n, (i + 1) B / n) of its leading axis (the JAX
    package's batch sharding). Each gradient leaf takes a plain mean over
    every data axis but the last, then the (compressed) mean over the
    last. ``feedback`` is ``compress.init_feedback(params)`` at the first
    step."""
    groups, block, n = data_groups(group)

    def reduce_one(g):
        return reduce_mean(g, groups, compress_grads)

    def train_step(params, opt_state, feedback, batch):
        local = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                                 f"split over {n} ranks")
            local[k] = v.reshape(n, v.shape[0] // n, *v.shape[1:])[block]
        loss, _, g = value_and_grad(model, params, local)
        grads = T.unflatten_like(params, list(g))
        if error_feedback:
            grads = compress.apply_feedback(grads, feedback)
        before = grads
        grads = T.tree_map(reduce_one, grads)
        if error_feedback:
            feedback = T.tree_map(lambda b, a: b.float() - a.float(),
                                  before, grads)
        loss = loss.float()
        for g in groups:
            loss = compress.psum_mean(loss, g)
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, feedback, {"loss": loss, **om}

    return train_step
