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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers as L

__all__ = ["RGLRUCache", "rglru_init", "rglru_apply", "rglru_decode",
           "rglru_empty_cache"]

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


def _gates(p, u: torch.Tensor):
    """u (B, S, W), the conv's output -> (log_a, gated input), both
    float32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(uf @ p["wi"].float() + p["bi"])
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


def rglru_apply(p, x: torch.Tensor, cfg, *, cache: RGLRUCache | None = None):
    """x (B, S, d_model) -> (out (B, S, d_model), new cache or None); with
    a cache and S == 1, one step of the recurrence (``rglru_decode``). The
    cache's tensors are not written: a new RGLRUCache is returned."""
    b, s, _ = x.shape
    if cache is not None and s == 1:
        return rglru_decode(p, x, cfg, cache)
    y = L.act_fn("gelu")(x @ p["wy"])                           # gate branch
    u_in = x @ p["wx"]
    u = _conv(u_in, p["conv_w"], p["conv_b"])
    log_a, gi = _gates(p, u)
    if cache is not None:
        # seed the scan with the cached state as a virtual step 0
        log_a = torch.cat([torch.zeros_like(log_a[:, :1]), log_a], dim=1)
        gi = torch.cat([cache.h.float()[:, None], gi], dim=1)
    h = _scan(log_a, gi)
    if cache is not None:
        h = h[:, 1:]
    out = (h.to(x.dtype) * y) @ p["wo"]
    if cache is None:
        return out, None
    new_conv = u_in[:, -(cfg.conv_width - 1):]
    if s < cfg.conv_width - 1:
        wide = torch.promote_types(cache.conv.dtype, new_conv.dtype)
        new_conv = torch.cat([cache.conv[:, s:].to(wide),
                              new_conv.to(wide)], dim=1)
    return out, RGLRUCache(h[:, -1].to(cache.h.dtype),
                           new_conv.to(cache.conv.dtype), cache.pos + s)


def rglru_decode(p, x: torch.Tensor, cfg, cache: RGLRUCache):
    """One token of the recurrence. x (B, 1, d_model)."""
    y = L.act_fn("gelu")(x @ p["wy"])                           # (B,1,W)
    u_new = x @ p["wx"]                                         # (B,1,W)
    wide = torch.promote_types(cache.conv.dtype, u_new.dtype)
    hist = torch.cat([cache.conv.to(wide), u_new.to(wide)], dim=1)
    u = (torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float())
         + p["conv_b"].float())[:, None].to(x.dtype)
    log_a, gi = _gates(p, u)                                    # (B,1,W)
    h = torch.exp(log_a[:, 0]) * cache.h.float() + gi[:, 0]
    out = (h[:, None].to(x.dtype) * y) @ p["wo"]
    return out, RGLRUCache(h.to(cache.h.dtype),
                           hist[:, 1:].to(cache.conv.dtype), cache.pos + 1)


def rglru_empty_cache(cfg, batch: int, dtype, *, stack: tuple = (),
                      device="cuda") -> RGLRUCache:
    w = cfg.rnn_width or cfg.d_model
    return RGLRUCache(
        h=torch.zeros((*stack, batch, w), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((*stack, batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device),
        pos=0)
