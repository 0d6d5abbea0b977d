"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
counterpart of ``repro/models/rglru.py``).

Per-channel gated linear recurrence:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is linear in h, so a prefill runs it as a log-depth scan
over the sequence (``_scan``: the reference's ``jax.lax.associative_scan``
with the same combine, written as ceil(log2 S) shifted steps in float32;
its float order differs from the reference's tree), and decode as one
update a token. The block around it is Griffin's recurrent block: two
input projections (gate branch: GeLU, the tanh form as ``jax.nn.gelu``;
recurrent branch: a causal conv1d of width 4, no activation, then the
RG-LRU), their elementwise product, an output projection.

Plain PyTorch: the JAX package computes all of it outside any Pallas
kernel. As in the reference (ROADMAP C7), a prefill into a non-empty cache
convolves over zero padding, not over the cached window, and seeds the
scan with the cached state.

On a mesh (``rglru_specs``) the channels lie over 'model': the gate branch,
the input projection, the conv and the recurrence run on the rank's
channels (u's ``constrain``, JAX ``rglru.py:94``, is their layout), but
the (w, w) gate matrices ``wa`` / ``wi`` take the whole of u to give the
rank's output channels, so u is all-gathered for them (a collective their
column split forces); ``wo`` is row-parallel and the output ``constrain``
(``:110``, ``:131``) reduces it into the residual's layout. The cache
follows the channels: h (B, w) as P(DATA, MODEL), the conv window (B,
W - 1, w) as P(DATA, None, MODEL). Under autograd the gathered u is read a
part a rank (each rank's gate columns), so its gather's backward is a
reduce_scatter (``distributed/sharding.py``'s docstring).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import P, constrain, local_shape
from . import layers as L

__all__ = ["RGLRUCache", "rglru_init", "rglru_specs", "rglru_apply",
           "rglru_decode", "rglru_empty_cache"]

_C = 8.0


class RGLRUCache(NamedTuple):
    h: torch.Tensor      # (B, W_rnn) float32 recurrent state
    conv: torch.Tensor   # (B, conv_width - 1, W_rnn)
    pos: int


def rglru_init(gen: torch.Generator, cfg, *, stack: tuple = ()) -> dict:
    """The JAX package's tree and dtypes: wy, wx (d, w), conv_w (W, w),
    conv_b (w,), wa, wi (w, w) and wo (w, d) in cfg.dtype; ba, bi and lam
    (w,) in float32, lam drawn so that a^c lies in [0.9, 0.999] at r = 1
    (the paper's App. A). ``stack`` prepends the n_groups axis."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    dev = gen.device

    def dense(d_in, d_out, scale=None):
        return L.dense_init(gen, d_in, d_out, cfg.dtype, scale=scale,
                            stack=stack)

    def zeros(dtype):
        return torch.zeros((*stack, w), dtype=dtype, device=dev)

    conv_w = torch.empty((*stack, cfg.conv_width, w), dtype=torch.float32,
                         device=dev).normal_(generator=gen)
    u = torch.empty((*stack, w), dtype=torch.float32,
                    device=dev).uniform_(0.9, 0.999, generator=gen)
    return {"wy": dense(d, w), "wx": dense(d, w),
            "conv_w": (conv_w / math.sqrt(cfg.conv_width)).to(cfg.dtype),
            "conv_b": zeros(cfg.dtype),
            "wa": dense(w, w), "ba": zeros(torch.float32),
            "wi": dense(w, w), "bi": zeros(torch.float32),
            # softplus^-1(-ln u / c)
            "lam": torch.log(torch.expm1(-torch.log(u) / _C)),
            "wo": dense(w, d, 1.0 / math.sqrt(w))}


def rglru_specs() -> dict:
    """The JAX package's ``rglru_init`` specs: the channels over 'model'
    (the (w, w) gate matrices by their output columns), wo's rows."""
    m = L.MODEL
    return {"wy": P(None, m), "wx": P(None, m), "conv_w": P(None, m),
            "conv_b": P(m), "wa": P(None, m), "ba": P(m), "wi": P(None, m),
            "bi": P(m), "lam": P(m), "wo": P(m, None)}


def _gates(p, u: torch.Tensor, rb=None):
    """u (B, S, W), the conv's output -> (log_a, gated input), both
    float32. On a mesh, u holds the rank's channels and is all-gathered
    for the gate matrices' products."""
    uf = u.float()
    whole = uf if p["wa"].shape[-2] == u.shape[-1] else constrain(
        uf, rb, None, None, have=(rb, None, L.MODEL), grad_partial=L.MODEL)
    r = torch.sigmoid(whole @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(whole @ p["wi"].float() + p["bi"])
    log_a = -_C * F.softplus(p["lam"]) * r                      # < 0
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * (i * uf)


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """Depthwise causal conv1d, no activation: the taps summed in float32
    over zero padding, cast back to u's type."""
    width, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(width):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return (out + b.float()).to(u.dtype)


def _scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t from h = 0, over axis 1: the
    inclusive scan of the combine (a1, b1) . (a2, b2) = (a1 + a2, exp(a2)
    b1 + b2), by ceil(log2 S) steps that each combine every element with
    the one ``d`` before it (d = 1, 2, 4, ...)."""
    d, s = 1, log_a.shape[1]
    while d < s:
        b = torch.cat([b[:, :d], torch.exp(log_a[:, d:]) * b[:, :-d]
                       + b[:, d:]], dim=1)
        log_a = torch.cat([log_a[:, :d], log_a[:, d:] + log_a[:, :-d]],
                          dim=1)
        d *= 2
    return b


def _out(p, hy: torch.Tensor, cfg, resid) -> torch.Tensor:
    """(h y) @ wo, reduced into the residual's layout on a mesh."""
    w = cfg.rnn_width or cfg.d_model
    rb = None if resid is None else resid[0]
    return constrain(hy @ p["wo"], *((L.DATA, None, None) if resid is None
                                     else resid), have=(rb,),
                     partial=L.MODEL if p["wo"].shape[-2] != w else None)


def rglru_apply(p, x: torch.Tensor, cfg, *, cache: RGLRUCache | None = None,
                resid=None):
    """x (B, S, d_model) -> (out (B, S, d_model), new cache or None); with
    a cache and S == 1, one step of the recurrence (``rglru_decode``). The
    cache's tensors are not written: a new RGLRUCache is returned. On a
    mesh x is whole on S and ``resid`` the residual's layout, as in
    ``attention.gqa_apply``."""
    b, s, _ = x.shape
    if cache is not None and s == 1:
        return rglru_decode(p, x, cfg, cache, resid=resid)
    rb = None if resid is None else resid[0]
    y = L.act_fn("gelu")(x @ p["wy"])                           # gate branch
    u_in = x @ p["wx"]
    u = _conv(u_in, p["conv_w"], p["conv_b"])
    u = constrain(u, L.DATA, None, L.MODEL, have=(rb, None, None if
                  u.shape[-1] == (cfg.rnn_width or cfg.d_model) else L.MODEL))
    log_a, gi = _gates(p, u, rb)
    if cache is not None:
        # seed the scan with the cached state as a virtual step 0
        log_a = torch.cat([torch.zeros_like(log_a[:, :1]), log_a], dim=1)
        gi = torch.cat([cache.h.float()[:, None], gi], dim=1)
    h = _scan(log_a, gi)
    if cache is not None:
        h = h[:, 1:]
    out = _out(p, h.to(x.dtype) * y, cfg, resid)
    if cache is None:
        return out, None
    new_conv = u_in[:, -(cfg.conv_width - 1):]
    if s < cfg.conv_width - 1:
        wide = torch.promote_types(cache.conv.dtype, new_conv.dtype)
        new_conv = torch.cat([cache.conv[:, s:].to(wide),
                              new_conv.to(wide)], dim=1)
    return out, RGLRUCache(h[:, -1].to(cache.h.dtype),
                           new_conv.to(cache.conv.dtype), cache.pos + s)


def rglru_decode(p, x: torch.Tensor, cfg, cache: RGLRUCache, resid=None):
    """One token of the recurrence. x (B, 1, d_model); on a mesh as
    ``rglru_apply``."""
    y = L.act_fn("gelu")(x @ p["wy"])                           # (B,1,W)
    u_new = x @ p["wx"]                                         # (B,1,W)
    wide = torch.promote_types(cache.conv.dtype, u_new.dtype)
    hist = torch.cat([cache.conv.to(wide), u_new.to(wide)], dim=1)
    u = (torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float())
         + p["conv_b"].float())[:, None].to(x.dtype)
    log_a, gi = _gates(p, u, None if resid is None else resid[0])
    h = torch.exp(log_a[:, 0]) * cache.h.float() + gi[:, 0]     # (B, W)
    out = _out(p, h[:, None].to(x.dtype) * y, cfg, resid)
    return out, RGLRUCache(h.to(cache.h.dtype),
                           hist[:, 1:].to(cache.conv.dtype), cache.pos + 1)


def rglru_empty_cache(cfg, batch: int, dtype, *, stack: tuple = (),
                      device="cuda") -> RGLRUCache:
    """Zero state and conv window; on a mesh this rank's channel blocks,
    lifted over ``stack``."""
    w = cfg.rnn_width or cfg.d_model
    lift = (None,) * len(stack)
    h = local_shape((*stack, batch, w), P(*lift, L.DATA, L.MODEL))
    conv = local_shape((*stack, batch, cfg.conv_width - 1, w),
                       P(*lift, L.DATA, None, L.MODEL))
    return RGLRUCache(
        h=torch.zeros(h, dtype=torch.float32, device=device),
        conv=torch.zeros(conv, dtype=dtype, device=device), pos=0)
