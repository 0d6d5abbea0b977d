"""Data-parallel trainer with explicit collectives (counterpart of
``repro/distributed/trainer.py``), one process a rank over
``torch.distributed``.

Each rank holds the whole params and optimizer state, takes its slice of
the global batch, and reduces the gradients by hand, so that the reduction
can be compressed (``distributed/compress.py``). The JAX package's
``shard_map`` over the ('pod', 'data') axes is one rank a data shard here;
its hierarchical form (a plain mean inside the pod, the compressed one
across pods) needs a mesh of more than one axis, which is the sharded LM of
ROADMAP A6 and raises ``NotImplementedError``.

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

__all__ = ["make_dp_train_step"]

_A6 = ("ROADMAP A6 (the sharded LM: a mesh of more than one axis, such as "
       "the hierarchical ('pod', 'data') reduction)")


def _data_group(group):
    """The process group of a 1-D data axis: ``group`` itself, the default
    group for None, or the group of a one-axis DeviceMesh."""
    names = getattr(group, "mesh_dim_names", None)
    if names is None:
        return group
    if len(names) != 1 or "pod" in names:
        raise NotImplementedError(f"a DP group over mesh axes {names} is not "
                                  f"ported: {_A6}")
    return group.get_group(0)


def make_dp_train_step(model: Model, opt_cfg: adamw.AdamWConfig, group=None,
                       *, compress_grads: bool = True,
                       error_feedback: bool = True) -> Callable:
    """Pure data parallelism over ``group`` (a process group, None for the
    default one, or a one-axis ``DeviceMesh``); params replicated on every
    rank.

    Returns train_step(params, opt_state, feedback, batch) -> (params,
    opt_state, feedback, metrics {"loss", "grad_norm", "lr"}). ``batch``
    is the global batch, the same on every rank; rank r takes rows [r B /
    n, (r + 1) B / n) of its leading axis (the JAX package's batch
    sharding). ``feedback`` is ``compress.init_feedback(params)`` at the
    first step."""
    group = _data_group(group)

    def reduce_one(g):
        g = g.float()
        if compress_grads:
            return compress.compressed_psum_mean(g, group)
        return compress.psum_mean(g, group)

    def train_step(params, opt_state, feedback, batch):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        local = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                                 f"split over {n} ranks")
            local[k] = v.reshape(n, v.shape[0] // n, *v.shape[1:])[rank]
        loss, _, g = value_and_grad(model, params, local)
        grads = T.unflatten_like(params, list(g))
        if error_feedback:
            grads = compress.apply_feedback(grads, feedback)
        before = grads
        grads = T.tree_map(reduce_one, grads)
        if error_feedback:
            feedback = T.tree_map(lambda b, a: b.float() - a.float(),
                                  before, grads)
        loss = loss.float().clone()
        dist.all_reduce(loss, group=group)
        loss = loss / n
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, feedback, {"loss": loss, **om}

    return train_step
