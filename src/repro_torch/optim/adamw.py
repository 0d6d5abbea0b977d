"""AdamW and its learning-rate schedules (counterpart of
``repro/optim/adamw.py``), over the port's trees of tensors.

The formulas and their float32 arithmetic are the JAX package's: the
gradient clipped by its global norm, bias correction in float32, weight
decay decoupled and applied to every leaf, each param computed in float32
and cast back to its own type, the moments kept in ``moment_dtype``
(float32 by default). Trees pair their leaves in the JAX package's order
(``repro_torch.tree``). On a mesh the trees hold a rank's blocks; only
the global norm reads across ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import tree as T
from ..distributed.sharding import psum

__all__ = ["AdamWState", "AdamWConfig", "lr_at", "init", "global_norm",
           "update"]


class AdamWState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_end: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    schedule: str = "cosine"      # cosine | linear | const


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: a linear warm-up
    times the cosine, linear or constant decay."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        dec = cfg.lr_end + 0.5 * (cfg.lr_peak - cfg.lr_end) * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        dec = cfg.lr_peak + (cfg.lr_end - cfg.lr_peak) * t
    else:
        dec = torch.tensor(cfg.lr_peak, dtype=torch.float32,
                           device=step.device)
    return warm * dec


_DONATE_ROWS = 1 << 24   # elements a slice of a donated in-place update


def _moment_type(cfg: AdamWConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Step 0 and zero moments of each param's shape, on its device."""
    md = _moment_type(cfg)
    first = T.leaves(params)
    dev = first[0].device if first else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=md, device=p.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      T.tree_map(zeros, params), T.tree_map(zeros, params))


def global_norm(tree: Any, split: list | None = None) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 sums of squares.
    ``split``: on a mesh, where ``tree`` holds this rank's blocks, the mesh
    axes each leaf is split over: a leaf's sum of squares is summed over
    them (all-reduced with those of the leaves split alike), a replicated
    leaf's counted once, so every rank gets the norm of the whole tree."""
    if split is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in T.leaves(tree)))
    groups: dict = {}
    for x, axes in zip(T.leaves(tree), split):
        groups[axes] = groups.get(axes, 0) + torch.sum(torch.square(
            x.float()))
    return torch.sqrt(sum(psum(groups[axes], axes) if axes else groups[axes]
                          for axes in sorted(groups)))


def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any,
           split: list | None = None, donate: bool = False
           ) -> tuple[Any, AdamWState, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}). The
    inputs are not written; every output is a new tensor. With ``donate``
    (the JAX package's ``donate_argnums``) each leaf's new param and
    moments are written into the given ones instead, leaf by leaf, the
    same bits in the memory of one state. On a mesh the trees hold this
    rank's blocks and ``split`` says how each leaf is split
    (``global_norm``); the update is elementwise on the blocks."""
    gnorm = global_norm(grads, split)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    scale = torch.minimum(one, cfg.clip_norm / torch.clamp(gnorm, min=1e-9)) \
        if cfg.clip_norm else one
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    md = _moment_type(cfg)

    def upd(p, g, m, v):
        g = g.float() * scale
        m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat, vhat = m1 / b1c, v1 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return ((p.float() - lr * delta).to(p.dtype), m1.to(md), v1.to(md))

    def upd_in_place(p, g, m, v):
        """``upd`` written into p, m and v, a slice of the leading dim at a
        time (elementwise, so the same bits): the float32 temporaries of a
        slice of ``_DONATE_ROWS`` elements, not of the whole leaf."""
        rows = max(1, _DONATE_ROWS // max(1, p[0].numel())) if p.ndim else 1
        for i in range(0, p.shape[0] if p.ndim else 1, rows):
            sl = slice(i, i + rows) if p.ndim else ...
            for dst, x in zip((p[sl], m[sl], v[sl]),
                              upd(p[sl], g[sl], m[sl], v[sl])):
                dst.copy_(x)
        return p, m, v

    outs = [(upd_in_place if donate else upd)(p, g, m, v)
            for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                                  T.leaves(state.mu), T.leaves(state.nu))]
    new_p = T.unflatten_like(params, [o[0] for o in outs])
    new_m = T.unflatten_like(params, [o[1] for o in outs])
    new_v = T.unflatten_like(params, [o[2] for o in outs])
    return new_p, AdamWState(step, new_m, new_v), \
        {"grad_norm": gnorm, "lr": lr}
