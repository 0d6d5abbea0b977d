"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch
(counterpart of ``repro/models/moe.py``).

Dispatch is per batch row and one-hot-free, as in the JAX package: routed
(token, expert-choice) copies are sorted stably by expert id, each copy's
slot within its expert is its rank from a searchsorted, and the tokens
scatter into a static (B, E, C, d) capacity buffer. A copy past its
expert's capacity C = ceil(S k / E * capacity_factor) goes to the drop
sink, row E C, which is cut off: the earlier tokens of a row keep their
place (token priority), and a dropped copy adds nothing to its token's
output. The top-k gates are renormalised to sum to 1 before the drops, so
a drop is not made up for. Every shape is static and nothing syncs with
the host.

The expert products are plain batched matmuls (``torch.bmm``), as the JAX
package leaves them to XLA; there is no kernel of its own here.

On a mesh (``moe_specs``): the router is replicated, so every rank of a
'model' group routes its (whole-S) rows identically; the capacity buffer
is replicated over 'model' (its ``constrain``, JAX ``moe.py:99``); each
rank holds a d_ff block of every expert, so the hidden state lies split on
f (``:106``) and the row-parallel ``wo``, the gather back and the
weighted combine (all linear in it) give a partial sum over 'model', as
the shared experts' MLP does; the output ``constrain`` (``:120``)
reduces their sum into the residual's layout (``resid``). The aux loss's
two means are reduced over the batch axes (``_aux``). In training the
router's part of the block reads a part a rank too: its cotangents are
partial sums over 'model' (the replicated router's gradient is
all-reduced, the loss's cotangent counted once), as
``distributed/sharding.py``'s docstring sets out.

Aux loss: the Switch load-balance loss, E * sum_e (share of tokens whose
first choice is e) * (mean router probability of e), a 0-d float32 tensor.
"""

from __future__ import annotations

import math

import torch

from ..distributed.sharding import (P, axis_size, constrain, current_mesh,
                                    grad_once, psum, sum_grad)
from . import layers as L

__all__ = ["moe_init", "moe_specs", "moe_apply", "route", "route_rows",
           "capacity"]


def capacity(cfg, seq: int) -> int:
    """Slots each expert holds for one batch row of ``seq`` tokens."""
    return int(math.ceil(seq * cfg.n_experts_active / cfg.n_experts
                         * cfg.capacity_factor))


def moe_init(gen: torch.Generator, cfg, *, stack: tuple = ()) -> dict:
    """The JAX package's tree: ``router`` float32 (d, E), ``wi`` / ``wg``
    (E, d, f) and ``wo`` (E, f, d) in cfg.dtype, and the ``shared`` dense
    MLP of n_shared_experts * f columns; ``stack`` prepends the n_groups
    axis of stacked layers."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    router = torch.empty((*stack, d, e), dtype=torch.float32,
                         device=gen.device)
    p = {"router": router.normal_(generator=gen) * 0.02,
         "wi": L.trunc_normal(gen, (*stack, e, d, f), 1.0 / math.sqrt(d),
                              cfg.dtype),
         "wg": L.trunc_normal(gen, (*stack, e, d, f), 1.0 / math.sqrt(d),
                              cfg.dtype),
         "wo": L.trunc_normal(gen, (*stack, e, f, d), 1.0 / math.sqrt(f),
                              cfg.dtype)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, cfg.n_shared_experts * f, cfg.dtype,
                                 cfg.mlp_kind, stack=stack)
    return p


def moe_specs(cfg) -> dict:
    """The JAX package's ``moe_init`` specs: the router replicated, each
    expert's d_ff over 'model' (wi / wg columns, wo rows), the shared
    experts' MLP as ``mlp_specs``."""
    s = {"router": P(None, None), "wi": P(None, None, L.MODEL),
         "wg": P(None, None, L.MODEL), "wo": P(None, L.MODEL, None)}
    if cfg.n_shared_experts:
        s["shared"] = L.mlp_specs(cfg.mlp_kind)
    return s


def route_rows(top_i: torch.Tensor, cap: int, n_experts: int
               ) -> torch.Tensor:
    """``_route_row`` of every batch row: top_i (B, S, k) -> dest (B, S k)
    int32, dest[b, i] = expert * cap + slot for routed copy i (flattened
    (S, k)), or n_experts * cap (dropped) past the expert's capacity."""
    b = top_i.shape[0]
    flat_e = top_i.reshape(b, -1).long()
    sk = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=1, stable=True)  # token priority
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=top_i.device).expand(b, -1)
    first = torch.searchsorted(sorted_e, experts.contiguous(), side="left")
    slot = torch.arange(sk, device=top_i.device) - torch.gather(
        first, 1, sorted_e)                            # rank within expert
    dest_sorted = torch.where(slot < cap, sorted_e * cap + slot,
                              n_experts * cap)
    return torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted).to(
        torch.int32)


def route(p, x: torch.Tensor, cfg):
    """The router: (probs (B, S, E), gates (B, S, k), experts (B, S, k)),
    float32 softmax probabilities, the top-k of them renormalised to sum
    to 1, and their expert ids, the most probable first."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_p, top_i = torch.topk(probs, cfg.n_experts_active, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def _aux(probs: torch.Tensor, top_i: torch.Tensor, e: int, rb, part):
    """The Switch loss: E * sum_e (share of first choices e) * (mean
    probability of e), both over the whole batch and sequence. On a mesh
    a rank holds rows ``rb`` of the batch: both are reduced over the batch
    axes before their product (a product of local means is not the
    product of the global ones); ``part``: the router's cotangents are
    partial sums over 'model' (its readers compute a part a rank), so the
    whole cotangent of the replicated loss is counted once."""
    b, s = top_i.shape[:2]
    counts = torch.zeros(e, dtype=torch.float32, device=top_i.device
                         ).index_add_(0, top_i[..., 0].reshape(-1),
                                      torch.ones(b * s, dtype=torch.float32,
                                                 device=top_i.device))
    if current_mesh() is None:
        return e * torch.sum(counts / (b * s) * probs.mean(dim=(0, 1)))
    n = b * s * axis_size(rb)
    frac, mean = psum(torch.stack([counts, probs.sum(dim=(0, 1))]), rb) / n
    aux = e * torch.sum(frac * mean)
    return grad_once(aux, L.MODEL) if part else aux


def moe_apply(p, x: torch.Tensor, cfg, resid=None):
    """x (B, S, d) -> (out (B, S, d) in x.dtype, aux_loss 0-d float32).
    On a mesh x is whole on S and ``resid`` the residual's layout, as in
    ``attention.gqa_apply``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    cap = capacity(cfg, s)
    f = cfg.moe_d_ff or cfg.d_ff
    partial = L.MODEL if p["wo"].shape[-2] != f else None
    router = p["router"] if partial is None else \
        sum_grad(p["router"], L.MODEL)      # read by the split experts
    probs, top_p, top_i = route({"router": router}, x, cfg)
    aux = _aux(probs, top_i, e, None if resid is None else resid[0],
               partial)

    dest = route_rows(top_i, cap, e).long()                    # (B, S k)

    # scatter the routed copies into (B, E C + 1, d): row E C is the sink
    xk = x.repeat_interleave(k, dim=1)                         # (B, S k, d)
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), xk)
    buf = buf[:, :-1].reshape(b, e, cap, d)

    # expert FFN, one bmm per weight over the experts: (E, B C, d)
    h_in = buf.transpose(0, 1).reshape(e, b * cap, d)
    h = torch.bmm(h_in, p["wi"])
    g = torch.bmm(h_in, p["wg"])
    act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
    eo = torch.bmm(L.act_fn(act)(g) * h, p["wo"])               # (E, B C, d)
    eo = eo.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    # gather back (a dropped copy reads the zero row) + weighted combine
    eo = torch.cat([eo, eo.new_zeros((b, 1, d))], dim=1)
    routed = torch.gather(eo, 1, dest[..., None].expand(-1, -1, d))
    out = torch.einsum("bskd,bsk->bsd", routed.reshape(b, s, k, d).float(),
                       top_p).to(x.dtype)

    if cfg.n_shared_experts:
        if L.mlp_partial(p["shared"], cfg.n_shared_experts * f) != partial:
            raise NotImplementedError(
                "the routed and the shared experts' d_ff split unlike over "
                "'model': ROADMAP A6 (the sharded LM)")
        out = out + L.mlp_apply(p["shared"], x, cfg.mlp_kind, act)
    if resid is not None:
        out = constrain(out, *resid, have=(resid[0],), partial=partial)
    return out, aux
