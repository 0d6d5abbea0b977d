"""AdamW and its learning-rate schedules (counterpart of
``repro/optim/adamw.py``), over the port's trees of tensors.

The formulas and their float32 arithmetic are the JAX package's: the
gradient clipped by its global norm, bias correction in float32, weight
decay decoupled and applied to every leaf, each param computed in float32
and cast back to its own type, the moments kept in ``moment_dtype``
(float32 by default). Trees pair their leaves in the JAX package's order
(``repro_torch.tree``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import tree as T

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


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
           ) -> tuple[Any, AdamWState, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}). The
    inputs are not written; every output is a new tensor."""
    gnorm = global_norm(grads)
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

    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        T.leaves(params), T.leaves(grads), T.leaves(state.mu),
        T.leaves(state.nu))]
    new_p = T.unflatten_like(params, [o[0] for o in outs])
    new_m = T.unflatten_like(params, [o[1] for o in outs])
    new_v = T.unflatten_like(params, [o[2] for o in outs])
    return new_p, AdamWState(step, new_m, new_v), \
        {"grad_norm": gnorm, "lr": lr}
