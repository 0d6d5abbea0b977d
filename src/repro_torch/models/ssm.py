"""Mamba2: SSD (state-space duality) blocks, a chunked scan for prefill and
an O(1) recurrence for decode (counterpart of ``repro/models/ssm.py``).

The SSD recurrence per head (state N = cfg.ssm_state, head dim P):

    h_t = exp(a_t) h_{t-1} + dt_t * (B_t ⊗ x_t),   a_t = -exp(A_log) dt_t
    y_t = C_t · h_t + D x_t

A prefill runs the chunked dual form (arXiv:2405.21060 §6): the sequence is
split into chunks of Q tokens; within a chunk the quadratic "attention"
form (``_intra_chunk``), across chunks a loop over the chunks carries the
(H, N, P) state (``_inter_chunk``; the JAX package's ``lax.scan``). Decode
is the recurrence itself, one state update a token.

Plain PyTorch: the JAX package computes all of it outside any Pallas
kernel. The dtypes are the reference's at every step: the projections in
the params' type, dt, the state and y in float32, y cast back before
``out_proj``.

The reference's cache behaviour is kept as it is (ROADMAP C7): a prefill
pads S up to a multiple of the chunk and advances ``pos`` by the padded
length (no output depends on it: the block uses no positions), and a
prefill into a non-empty cache convolves over zero padding, not over the
cached window. Where the reference writes a conv window of the wrong shape
(a prefill of 2 <= S < conv_width - 1 tokens into a cache, which its own
decode cannot read), the port raises ``ValueError`` naming C7.

On a mesh (``ssd_specs``) the heads lie over 'model'. in_proj's packed
columns (z | x | B | C | dt) split into blocks that cut across the parts,
so its output is all-gathered (a collective the heads' ``constrain``, JAX
``ssm.py:120``, forces); the conv's channels (x | B | C) are split the same
way, so a rank convolves its own block of channels (its block of the conv
cache) and the result is all-gathered; x and dt then keep the rank's
heads (a local slice: the ``constrain`` at ``:120``), B and C stay whole.
The gate norm is an RMSNorm over the whole d_inner with its scale split,
so its sum of squares is all-reduced; ``out_proj`` is row-parallel and the
output ``constrain`` (``:102``) reduces it into the residual's layout.
The cache: the state (B, H, N, P) as P(DATA, MODEL, None, None), the conv
window (B, W - 1, C) as P(DATA, None, MODEL).

Under autograd on a mesh the block's replicated tensors (the whole
in_proj and conv outputs, B and C) are read a part a rank, so their
cotangents are partial sums over 'model' and every ``constrain`` here says
so (``grad_partial``): the two gathers' backward is a reduce_scatter,
the heads' slices zero-pad, and the gate norm's all-reduced sum of squares
is all-reduced again in the backward (each rank normalises its own
channels with it).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import P, axis_index, constrain, local_shape
from . import layers as L

__all__ = ["SSMCache", "ssd_init", "ssd_specs", "ssd_apply", "ssd_decode",
           "ssm_empty_cache"]

NEG_INF = -1e30


class SSMCache(NamedTuple):
    state: torch.Tensor   # (B, H, N, P) float32
    conv: torch.Tensor    # (B, W-1, conv_channels): the conv's lookback
    pos: int              # tokens seen, padding included (ROADMAP C7)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    pdim = cfg.ssm_head_dim
    return d_inner, pdim, d_inner // pdim


def ssd_init(gen: torch.Generator, cfg, *, stack: tuple = ()) -> dict:
    """The JAX package's tree and dtypes: in_proj (d, 2 d_inner + 2 N + H),
    conv_w (W, C), conv_b (C,) in cfg.dtype; A_log, dt_bias, D (H,) and
    gate_norm in float32; out_proj (d_inner, d). ``stack`` prepends the
    n_groups axis of stacked layers."""
    d = cfg.d_model
    d_inner, _, nheads = _dims(cfg)
    n = cfg.ssm_state
    conv_ch = d_inner + 2 * n                      # x, B, C go through the conv
    dev = gen.device

    def uniform(lo, hi):
        u = torch.empty((*stack, nheads), dtype=torch.float32, device=dev)
        return u.uniform_(lo, hi, generator=gen)

    conv_w = torch.empty((*stack, cfg.conv_width, conv_ch),
                         dtype=torch.float32, device=dev)
    conv_w.normal_(generator=gen)
    return {
        "in_proj": L.dense_init(gen, d, 2 * d_inner + 2 * n + nheads,
                                cfg.dtype, stack=stack),
        "conv_w": (conv_w / math.sqrt(cfg.conv_width)).to(cfg.dtype),
        "conv_b": torch.zeros((*stack, conv_ch), dtype=cfg.dtype,
                              device=dev),
        # S4D-real style: A in [1, 16), dt bias log-uniform in [1e-3, 1e-1]
        "A_log": torch.log(1.0 + 15.0 * uniform(0.0, 1.0)),
        "dt_bias": torch.log(torch.expm1(10.0 ** uniform(-3.0, -1.0))),
        "D": torch.ones((*stack, nheads), dtype=torch.float32, device=dev),
        "gate_norm": L.norm_init(d_inner, "rmsnorm", stack=stack,
                                 device=dev),
        "out_proj": L.dense_init(gen, d_inner, d, cfg.dtype,
                                 scale=1.0 / math.sqrt(d_inner), stack=stack),
    }


def ssd_specs() -> dict:
    """The JAX package's ``ssd_init`` specs: in_proj's packed columns, the
    conv's channels, the per-head vectors and the gate norm over 'model',
    out_proj's rows."""
    return {"in_proj": P(None, L.MODEL), "conv_w": P(None, L.MODEL),
            "conv_b": P(L.MODEL), "A_log": P(L.MODEL),
            "dt_bias": P(L.MODEL), "D": P(L.MODEL),
            "gate_norm": {"scale": P(L.MODEL)}, "out_proj": P(L.MODEL, None)}


def ssd_split(p, cfg) -> bool:
    """Whether this rank holds a part of the block (its params split over
    'model'). Under autograd a block is split whole or not at all: the
    cotangents inside a split block are partial sums over 'model' (the
    module's docstring), which a block of replicated and split parts
    would mix."""
    d_inner, _, nheads = _dims(cfg)
    n = cfg.ssm_state
    parts = [p["in_proj"].shape[-1] != 2 * d_inner + 2 * n + nheads,
             p["conv_w"].shape[-1] != d_inner + 2 * n,
             p["A_log"].shape[-1] != nheads,
             p["gate_norm"]["scale"].shape[-1] != d_inner,
             p["out_proj"].shape[-2] != d_inner]
    if any(parts) and not all(parts) and torch.is_grad_enabled():
        raise NotImplementedError(
            "training an SSD block whose params split unlike over 'model' "
            "is not ported: ROADMAP A6 (the sharded LM)")
    return any(parts)


def _split_proj(zxbcdt: torch.Tensor, cfg):
    d_inner, _, nheads = _dims(cfg)
    n = cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, nheads], dim=-1)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d with SiLU: u (B, S, C), w (W, C) -> (B, S,
    C) in u's type, the taps summed in float32 over zero padding."""
    width, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(width):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return F.silu(out + b.float()).to(u.dtype)


def _gated_out(p, y: torch.Tensor, z: torch.Tensor, cfg, rb=None,
               out_entries=(L.DATA, None, None)) -> torch.Tensor:
    """The gated RMSNorm and out_proj. On a mesh with the norm's scale
    split, y and z are taken at the rank's channels and the sum of squares
    over d_inner is all-reduced; the row-parallel product is reduced into
    ``out_entries``."""
    d_inner, _, _ = _dims(cfg)
    sc = p["gate_norm"]["scale"].shape[-1]
    if sc == d_inner:
        y = L.norm_apply(p["gate_norm"], (y * F.silu(z.float())).to(y.dtype),
                         "rmsnorm")
    else:
        lo = axis_index(L.MODEL) * sc
        if y.shape[-1] != sc:
            y = y[..., lo:lo + sc]
        g = (y * F.silu(z[..., lo:lo + sc].float())).to(y.dtype).float()
        ss = constrain((g * g).sum(-1, keepdim=True), rb, None, None,
                       have=(rb,), partial=L.MODEL, grad_partial=L.MODEL)
        y = (g * torch.rsqrt(ss / d_inner + 1e-6)
             * p["gate_norm"]["scale"]).to(y.dtype)
    out = y.to(p["out_proj"].dtype) @ p["out_proj"]
    return constrain(out, *out_entries, have=(rb,), partial=L.MODEL
                     if p["out_proj"].shape[-2] != d_inner else None)


def _in_proj(p, x: torch.Tensor, cfg, rb) -> torch.Tensor:
    """x @ in_proj, whole: a rank's block of the packed columns is
    all-gathered."""
    zxbcdt = x @ p["in_proj"]
    d_inner, _, nheads = _dims(cfg)
    if zxbcdt.shape[-1] != 2 * d_inner + 2 * cfg.ssm_state + nheads:
        zxbcdt = constrain(zxbcdt, rb, None, None, have=(rb, None, L.MODEL),
                           grad_partial=L.MODEL)
    return zxbcdt


def _chunk(t: torch.Tensor, c_loc: int) -> torch.Tensor:
    """The rank's block of ``c_loc`` channels of t (B, S, C)."""
    if c_loc == t.shape[-1]:
        return t
    return t[..., axis_index(L.MODEL) * c_loc:][..., :c_loc]


def _whole_channels(t: torch.Tensor, conv_ch: int, rb) -> torch.Tensor:
    """A conv output of the rank's channel block, all-gathered."""
    if t.shape[-1] == conv_ch:
        return t
    return constrain(t, rb, None, None, have=(rb, None, L.MODEL),
                     grad_partial=L.MODEL)


def _project(p, x: torch.Tensor, cfg, rb=None):
    """in_proj and the causal conv: (z, conv_in, xs, bmat, cmat, dt), dt
    the raw projection; conv_in the rank's channel block on a mesh."""
    d_inner, _, _ = _dims(cfg)
    n = cfg.ssm_state
    z, xs, bmat, cmat, dt = _split_proj(_in_proj(p, x, cfg, rb), cfg)
    conv_in = _chunk(torch.cat([xs, bmat, cmat], dim=-1),
                     p["conv_w"].shape[-1])
    conv_out = _whole_channels(
        _causal_conv(conv_in, p["conv_w"], p["conv_b"]), d_inner + 2 * n, rb)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    return z, conv_in, xs, bmat, cmat, dt


def _intra_chunk(cum, cc, bc, dtc, xc) -> torch.Tensor:
    """The quadratic form inside each chunk: y_i = sum_{j <= i} (C_i . B_j)
    exp(cum_i - cum_j) dt_j x_j. cum, dtc (B, nc, Q, H); cc, bc (B, nc, Q,
    N); xc (B, nc, Q, H, P); all float32. Returns (B, nc, Q, H, P)."""
    q = cum.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cum.device))
    lmat = torch.exp(torch.where(mask[None, None, :, :, None], seg, NEG_INF))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)               # (B,nc,Q,Q)
    w = cb[..., None] * lmat * dtc[:, :, None, :, :]           # (B,nc,Q,Q,H)
    return torch.einsum("bcijh,bcjhp->bcihp", w, xc)


def _chunk_states(cum, bc, dtc, xc):
    """Each chunk's own end state, sum_q exp(cum_last - cum_q) dt_q B_q ⊗
    x_q, (B, nc, H, N, P), and its total decay cum_last, (B, nc, H)."""
    decay_last = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,Q,H)
    wx = (decay_last * dtc)[..., None] * xc                     # (B,nc,Q,H,P)
    return torch.einsum("bcqn,bcqhp->bchnp", bc, wx), cum[:, :, -1, :]


def _inter_chunk(s_chunk, a_total, init, cc, cum):
    """The recurrence across chunks (the reference's ``lax.scan``): the
    state entering chunk c is carried from ``init``; each chunk's rows read
    it through C and their decay. Returns (y_inter (B, nc, Q, H, P), the
    final state (B, H, N, P))."""
    st, prev = init, []
    for c in range(s_chunk.shape[1]):
        prev.append(st)                                # state BEFORE chunk c
        st = torch.exp(a_total[:, c])[..., None, None] * st + s_chunk[:, c]
    s_prev = torch.stack(prev, dim=1)                           # (B,nc,H,N,P)
    y = torch.einsum("bcqn,bchnp->bcqhp", cc, s_prev)
    return y * torch.exp(cum)[..., None], st


def ssd_apply(p, x: torch.Tensor, cfg, *, cache: SSMCache | None = None,
              resid=None):
    """x (B, S, d_model) -> (out (B, S, d_model), new cache or None). The
    chunked SSD; with a cache and S == 1, the recurrence (``ssd_decode``).
    The cache's tensors are not written: a new SSMCache is returned. On a
    mesh x is whole on S and ``resid`` the residual's layout, as in
    ``attention.gqa_apply``."""
    if cache is not None and x.shape[1] == 1:
        return ssd_decode(p, x, cfg, cache, resid=resid)
    b, s, _ = x.shape
    if cache is not None and s < cfg.conv_width - 1:
        raise ValueError(
            f"a prefill of {s} tokens into an SSM cache: the reference "
            f"writes a conv window of {s} rows where the cache holds "
            f"{cfg.conv_width - 1}, which its decode cannot read (ROADMAP "
            f"C7); prefill at least {cfg.conv_width - 1} tokens or one")
    d_inner, pdim, nheads = _dims(cfg)
    n = cfg.ssm_state
    rb = None if resid is None else resid[0]
    out_entries = (L.DATA, None, None) if resid is None else tuple(resid)
    z, conv_in, xs, bmat, cmat, dt = _project(p, x, cfg, rb)
    xh = constrain(xs.reshape(b, s, nheads, pdim), L.DATA, None, L.MODEL,
                   None, have=(rb,), grad_partial=L.MODEL)
    nheads = xh.shape[2]                                # this rank's heads
    dt = F.softplus(constrain(dt, L.DATA, None, L.MODEL, have=(rb,),
                              grad_partial=L.MODEL).float()
                    + p["dt_bias"])                             # (B,S,H)

    # pad to a chunk multiple; dt = 0 at pads -> a = 0 (identity decay) and
    # no state contribution, so padding is exactly inert
    q = min(cfg.chunk, s)
    s_pad = (-s) % q
    s_true = s
    if s_pad:
        def pad2(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, s_pad))
        xh, dt, bmat, cmat = pad2(xh), pad2(dt), pad2(bmat), pad2(cmat)
        s = s + s_pad
    a = -torch.exp(p["A_log"]) * dt                             # (B,S,H)
    nc = s // q
    cum = torch.cumsum(a.reshape(b, nc, q, nheads), dim=2)      # (B,nc,Q,H)
    xc = xh.reshape(b, nc, q, nheads, pdim).float()
    dtc = dt.reshape(b, nc, q, nheads)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()

    y_intra = _intra_chunk(cum, cc, bc, dtc, xc)
    s_chunk, a_total = _chunk_states(cum, bc, dtc, xc)
    init = torch.zeros((b, nheads, n, pdim), dtype=torch.float32,
                       device=x.device) if cache is None \
        else cache.state.float()
    y_inter, final_state = _inter_chunk(s_chunk, a_total, init, cc, cum)

    y = (y_intra + y_inter).reshape(b, s, nheads, pdim) \
        + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, nheads * pdim)[:, :s_true]
    out = _gated_out(p, y, z, cfg, rb, out_entries)
    if cache is None:
        return out, None
    new_conv = conv_in[:, -(cfg.conv_width - 1):].to(cache.conv.dtype)
    return out, SSMCache(final_state.to(cache.state.dtype), new_conv,
                         cache.pos + s)


def ssd_decode(p, x: torch.Tensor, cfg, cache: SSMCache, resid=None):
    """One token of the recurrence. x (B, 1, d_model); on a mesh as
    ``ssd_apply``."""
    b = x.shape[0]
    d_inner, pdim, nheads = _dims(cfg)
    n = cfg.ssm_state
    rb = None if resid is None else resid[0]
    out_entries = (L.DATA, None, None) if resid is None else tuple(resid)
    z, xs, bmat, cmat, dt = _split_proj(_in_proj(p, x, cfg, rb), cfg)
    conv_in = _chunk(torch.cat([xs, bmat, cmat], dim=-1),
                     p["conv_w"].shape[-1])                     # (B,1,C)
    wide = torch.promote_types(cache.conv.dtype, conv_in.dtype)
    hist = torch.cat([cache.conv.to(wide), conv_in.to(wide)], dim=1)
    conv_out = _whole_channels(F.silu(
        torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float())
        + p["conv_b"].float())[:, None].to(x.dtype), d_inner + 2 * n, rb)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)

    xh = constrain(xs.reshape(b, nheads, pdim), L.DATA, L.MODEL, None,
                   have=(rb,)).float()
    nheads = xh.shape[1]                                # this rank's heads
    dt1 = F.softplus(constrain(dt[:, 0], L.DATA, L.MODEL, have=(rb,))
                     .float() + p["dt_bias"])                   # (B,H)
    a = torch.exp(-torch.exp(p["A_log"]) * dt1)                 # (B,H)
    bx = torch.einsum("bn,bhp->bhnp", bmat[:, 0].float(), xh)
    state = a[..., None, None] * cache.state.float() \
        + dt1[..., None, None] * bx
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), state) \
        + p["D"][None, :, None] * xh
    out = _gated_out(p, y.reshape(b, 1, nheads * pdim), z, cfg, rb,
                     out_entries)
    return out, SSMCache(state.to(cache.state.dtype),
                         hist[:, 1:].to(cache.conv.dtype), cache.pos + 1)


def ssm_empty_cache(cfg, batch: int, dtype, *, stack: tuple = (),
                    device="cuda") -> SSMCache:
    """Zero state and conv window; on a mesh this rank's blocks (see the
    module's docstring), lifted over ``stack``."""
    d_inner, pdim, nheads = _dims(cfg)
    conv_ch = d_inner + 2 * cfg.ssm_state
    lift = (None,) * len(stack)
    state = local_shape((*stack, batch, nheads, cfg.ssm_state, pdim),
                        P(*lift, L.DATA, L.MODEL, None, None))
    conv = local_shape((*stack, batch, cfg.conv_width - 1, conv_ch),
                       P(*lift, L.DATA, None, L.MODEL))
    return SSMCache(
        state=torch.zeros(state, dtype=torch.float32, device=device),
        conv=torch.zeros(conv, dtype=dtype, device=device),
        pos=0)
