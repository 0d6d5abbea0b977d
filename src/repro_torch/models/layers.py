"""Core NN primitives (counterpart of ``repro/models/layers.py``):
functional, over plain dicts of tensors.

Params keep the JAX package's layouts and dtypes, so a JAX param tree
carries over one to one (``repro_torch.bridge.lm_params_from_numpy``). The
JAX package's init pairs each param with a sharding spec; the port's
``*_specs`` functions return the same specs as a tree of their own
(``Model.specs``), with the logical axes ``DATA`` and ``MODEL``.

On a mesh (``sharding.use_mesh``) a rank holds the block of every param
that its resolved spec gives it. ``mlp_apply`` is then Megatron's MLP:
``wi`` / ``wg`` column-parallel, ``wo`` row-parallel, so its output is a
partial sum over 'model' when ``wo`` is split (``mlp_partial``); the
caller reduces it where the layout changes.

Init draws truncated normals from an explicit ``torch.Generator``: the same
distributions as ``jax.random``, not the same numbers. Dtype policy: params
in cfg.dtype (bf16 by default), math in float32 where it matters (norms,
rope, softmax), outputs cast back.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import P, current_mesh, use_mesh

__all__ = ["DATA", "MODEL", "trunc_normal", "dense_init", "embed_init",
           "norm_init", "norm_specs", "norm_apply", "act_fn", "rope_freqs",
           "apply_rope", "mlp_init", "mlp_specs", "mlp_apply", "mlp_partial",
           "logits_softcap", "remat", "EMBED_SPEC"]

DATA = ("pod", "data")  # batch axes ('pod' collapses onto 'data' when absent)
MODEL = "model"
EMBED_SPEC = P(MODEL, None)   # the vocab rows over 'model'


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, scale: float, dtype
                 ) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in float32 on
    the generator's device by the inverse CDF, then cast to ``dtype``.
    A tensor of more than 2^30 elements is drawn one slice of its leading
    axis at a time (deepseek-v2-lite's 26 stacked layers of 64 experts
    would take 19 GB of float32 at once)."""
    if len(shape) > 1 and math.prod(shape) > 2**30:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for i in range(shape[0]):
            out[i] = trunc_normal(gen, shape[1:], scale, dtype)
        return out
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return w.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               scale: float | None = None, stack: tuple = ()) -> torch.Tensor:
    """Truncated-normal (*stack, d_in, d_out) linear weight, scale
    1/sqrt(d_in) unless given."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return trunc_normal(gen, (*stack, d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype
               ) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=gen.device)
    return (w.normal_(generator=gen) * 0.02).to(dtype)


def norm_init(d: int, kind: str, *, stack: tuple = (), device="cuda"
              ) -> dict:
    ones = torch.ones((*stack, d), dtype=torch.float32, device=device)
    if kind == "layernorm":
        return {"scale": ones, "bias": torch.zeros_like(ones)}
    return {"scale": ones}


def norm_specs(kind: str) -> dict:
    if kind == "layernorm":
        return {"scale": P(None), "bias": P(None)}
    return {"scale": P(None)}


# ---------------------------------------------------------------------------
# apply helpers
# ---------------------------------------------------------------------------

def norm_apply(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation; "gelu" keeps that
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device="cuda") -> torch.Tensor:
    """(dim//2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S). Rotates the two HALVES of the
    head (x[..., :hd/2], x[..., hd/2:]) as the JAX package does, not
    interleaved pairs."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., :, None].float() * inv             # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN): swiglu / geglu / plain 2-layer
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype, kind: str, *,
             stack: tuple = ()) -> dict:
    p = {"wi": dense_init(gen, d, d_ff, dtype, stack=stack)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, d_ff, dtype, stack=stack)
    p["wo"] = dense_init(gen, d_ff, d, dtype, scale=1.0 / math.sqrt(d_ff),
                         stack=stack)
    return p


def mlp_specs(kind: str) -> dict:
    """wi / wg column-parallel, wo row-parallel (the JAX package's
    ``mlp_init``)."""
    s = {"wi": P(None, MODEL)}
    if kind in ("swiglu", "geglu"):
        s["wg"] = P(None, MODEL)
    s["wo"] = P(MODEL, None)
    return s


def mlp_partial(p, d_ff: int) -> str | None:
    """'model' when ``mlp_apply``'s output is a partial sum over it (this
    rank holds ``wo``'s rows of a split d_ff), else None."""
    return MODEL if p["wo"].shape[-2] != d_ff else None


def mlp_apply(p, x: torch.Tensor, kind: str, act: str) -> torch.Tensor:
    f = act_fn(act)
    if kind in ("swiglu", "geglu"):
        a = "silu" if kind == "swiglu" else "gelu"
        h = act_fn(a)(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = f(x @ p["wi"])
    return h @ p["wo"]


def logits_softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


def remat(cfg, fn, *args):
    """fn(*args), recomputed in the backward (``torch.utils.checkpoint``)
    when ``cfg.remat`` is set and autograd is on: the JAX package's
    ``jax.checkpoint`` of a layer group (a decoder pattern unit, an
    enc-dec layer) in a cacheless pass. The recompute runs under the mesh
    of the forward: autograd runs a card's backward on a thread of its
    own, which ``sharding.use_mesh`` (thread-local) does not reach."""
    if cfg.remat and torch.is_grad_enabled():
        mesh = current_mesh()

        def under_mesh(*a):
            with use_mesh(mesh):
                return fn(*a)
        return checkpoint(under_mesh, *args, use_reentrant=False)
    return fn(*args)
