"""Attention family (counterpart of ``repro/models/attention.py``): GQA
(full / sliding-window) and MLA (DeepSeek-V2's latent attention), with a KV
cache.

Every prefill attends through ``attend``, which is the CUDA kernel
``flash_attention`` on a card (``kernels/csrc/flash_attn.cu``; its plain
version ``kernels/ref.py`` ``flash_attention_ref`` on the CPU), so the
(S, S) score matrix is never held. Decode reads the cache in one pass with
``attend_onepass`` (scores are (B, H, 1, S)): plain PyTorch, as in the JAX
package, which has no kernel there.

MLA is the absorbed ("latent") form, as in the JAX package: q is taken
into latent space, the cache holds one KV head of width kv_lora + rope, and
V is a view of that cache; the prefill runs the kernel at dk 576 / dv 512
(deepseek-v2-lite). recurrentgemma's local attention ("lattn": 16 query
heads over one KV head at head dim 256, a window of 2,048) prefills over
its in-pass K/V through the kernel at hd 256 and stashes the window's tail
in a rolling cache of ``window`` slots, which decode reads.

Cross-attention (``gqa_apply``'s ``kv_override``: whisper's decoder over
the encoder memory's cached K/V) attends through ``attend`` without the
causal mask, in prefill and in every decode step (Sq = 1), as the JAX
package does; whisper's encoder self-attention is non-causal too.

Training differentiates ``attend`` through ``_FlashAttention``, the
counterpart of the JAX package's custom VJP: its forward is the same kernel
asked for the rows' logsumexp beside the output, its backward the plain
flash backward ``ref.flash_attention_bwd_ref`` (recompute P block by block
from q, k and the logsumexp; plain PyTorch on both devices, as the JAX
package computes it outside any Pallas kernel). A call that needs no
gradient takes the serving path, which writes no logsumexp.

On a mesh (``sharding.use_mesh``) the heads lie over 'model', as the JAX
package's specs put them (``gqa_specs``, ``mla_specs``; the divisibility
fallback replicates a head count the axis does not divide): q / k / v come
out of the rank's column blocks already split on heads, which is their
``constrain`` target (JAX ``attention.py:269``), so no collective runs
there; ``attend`` (the kernel) sees the rank's own heads; ``wo`` is
row-parallel, so the output is a partial sum that the output ``constrain``
(``:336``) reduces into the residual's layout (``resid``). Where q's heads
are split and k / v's are replicated (a kv head count 'model' does not
divide), the rank's q heads r hq_loc + i read kv heads (r hq_loc + i) // g
of the replicated set (``_local_kv``). The KV cache follows the heads:
(B, S, Hkv, hd) lies as P(DATA, None, MODEL, None), replicated where Hkv
does not divide; MLA's latent cache (one head) is replicated over 'model'.

A KV cache may instead lie split on the SEQUENCE over 'model'
(``SeqKVCache``, ``init_cache(..., seq_split=True)``), the JAX package's
decode layout (``repro/launch/dryrun.py`` ``_cache_specs``: its dry-run's
decode cells), heads whole on every rank: a decode step all-gathers the
rank's q heads and the new k / v heads over 'model', writes the new row
on the rank that holds its slot, attends over the rank's slots through
the kernel (``flash_attention`` asked for the rows' logsumexp, float32 q
over the cache in its own type), and combines the partials by their
logsumexp: a max all_reduce of it, then one sum all_reduce over 'model'
of exp(lse - max) times the output and of exp(lse - max) itself, a
weight of 0 on a rank that holds no key the query sees (flash-decoding);
its output keeps the rank's q heads for the row-parallel ``wo``. A
prefill into it (from position 0) attends over its in-pass K / V through
the kernel and writes the rows of the rank's slots. MLA's latent cache,
the recurrent states and an enc-dec cache keep their layouts.

The attention softcap (``softcap`` > 0: each scaled score s becomes
softcap tanh(s / softcap) before the mask) runs through the kernel on
every route, and the backward multiplies dS by the cap's slope.

Layout: (B, S, H, d) at every public function, as in the JAX package.
``KVCache.pos`` is a Python int (the JAX package traces it as a scalar): a
device tensor would cost a host sync in every layer of every step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..distributed.sharding import (P, axis_index, axis_size, constrain,
                                    local_shape, psum, sum_grad)
from ..kernels import ops, ref
from ..kernels.ref import NEG_INF
from . import layers as L

__all__ = ["attend", "attend_ref", "attend_onepass", "KVCache",
           "SeqKVCache", "gqa_init",
           "gqa_specs", "gqa_apply", "gqa_empty_cache", "mla_init",
           "mla_specs", "mla_apply", "mla_empty_cache", "split_axis"]

_A6 = "ROADMAP A6 (the rest of the LM stack)"


class _FlashAttention(torch.autograd.Function):
    """``attend`` with a gradient: the kernel's forward with the rows'
    logsumexp, saved with q, k, v and the output; the plain flash backward.
    v may be a view of k (MLA): autograd sums the two gradients into the
    tensor both view."""

    @staticmethod
    def forward(ctx, q, k, v, mask: dict):
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                 **ctx.mask)
        return dq, dk, dv, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int | None = None, q_offset: int = 0,
           kv_valid_len: int | None = None, softcap: float = 0.0
           ) -> torch.Tensor:
    """Online-softmax ("flash") attention through the kernel seam.

    q (B, Sq, Hq, dk)   k (B, Sk, Hkv, dk)   v (B, Sk, Hkv, dv),
    Hq % Hkv == 0. Returns (B, Sq, Hq, dv) in q.dtype.
    q_offset: absolute position of q[0] (chunked prefill).
    kv_valid_len: mask keys at positions >= this (cache prefill).
    The JAX package's ``kv_block`` only orders its float sums; the kernel
    scans keys in tiles of ``ref.FLASH_TILE``, the backward in blocks of
    ``ref.BWD_KV_BLOCK`` (its 512). ``softcap`` > 0 caps each scaled
    score at softcap tanh(s / softcap) before the mask, forward and
    backward (0 is off). Differentiable where grad mode is on and an input
    requires grad; the serving path is the bare kernel."""
    mask = dict(causal=causal, window=window, q_offset=q_offset,
                kv_valid_len=kv_valid_len)
    if softcap:
        mask["softcap"] = softcap
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, mask)
    return ops.flash_attention(q, k, v, **mask)


def attend_ref(q, k, v, *, causal, window=None, q_offset=0,
               kv_valid_len=None, softcap: float = 0.0):
    """Naive O(S^2)-memory oracle for tests."""
    return attend_onepass(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, kv_valid_len=kv_valid_len,
                          softcap=softcap)


def attend_onepass(q, k, v, *, causal, window=None, q_offset=0,
                   kv_valid_len=None, kv_positions=None,
                   softcap: float = 0.0):
    """Single-pass softmax attention (decode: Sq is tiny).

    kv_positions: explicit absolute position per cache slot (rolling window
    caches); entries < 0 are masked; causal/window masking is implied by the
    rolling-buffer invariant and skipped."""
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    qf = (q.float() / math.sqrt(dk)).reshape(b, sq, hkv, g, dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    if kv_positions is not None:
        ok = (kv_positions >= 0)[None, :].expand(sq, sk)
    else:
        kv_pos = torch.arange(sk, device=dev)
        ok = torch.ones((sq, sk), dtype=torch.bool, device=dev) \
            if kv_valid_len is None else \
            (kv_pos[None, :] < kv_valid_len).expand(sq, sk)
        if causal:
            ok = ok & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            ok = ok & (q_pos[:, None] - kv_pos[None, :] < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor    # (B, Smax, Hkv, dk)
    v: torch.Tensor    # (B, Smax, Hkv, dv)
    pos: int           # tokens already cached


class SeqKVCache(KVCache):
    """A ``KVCache`` whose slots lie split over 'model' (rank r holds
    slots [r S / m, (r + 1) S / m) of every head): the module's docstring.
    Made only where 'model' divides the slots."""
    __slots__ = ()


def gqa_init(gen: torch.Generator, cfg, *, stack: tuple = ()) -> dict:
    """Projections stored 3-D, (d, H, hd) / (H, hd, d), as in the JAX
    package; ``stack`` prepends the n_groups axis of stacked layers."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.head_dim or d // hq

    def head_w(shape, scale):
        return L.trunc_normal(gen, (*stack, *shape), scale, cfg.dtype)

    return {"wq": head_w((d, hq, hd), 1.0 / math.sqrt(d)),
            "wk": head_w((d, hkv, hd), 1.0 / math.sqrt(d)),
            "wv": head_w((d, hkv, hd), 1.0 / math.sqrt(d)),
            "wo": head_w((hq, hd, d), 1.0 / math.sqrt(hq * hd))}


def gqa_specs() -> dict:
    """Heads over 'model' (the JAX package's ``gqa_init``)."""
    return {"wq": P(None, L.MODEL, None), "wk": P(None, L.MODEL, None),
            "wv": P(None, L.MODEL, None), "wo": P(L.MODEL, None, None)}


def split_axis(local: int, whole: int) -> str | None:
    """'model' when a rank holds ``local`` of ``whole`` (a dim split over
    it), None when it holds the whole dim."""
    return L.MODEL if local != whole else None


def _local_kv(k: torch.Tensor, v: torch.Tensor, hq_loc: int, cfg):
    """k, v (B, S, Hkv_loc, d) as this rank's q heads read them. Heads
    split on both (or on neither): as they are, the GQA group intact.
    q's split and kv's replicated (the fallback): the kv heads
    (r hq_loc + i) // g of this rank's q heads r hq_loc + i, as a slice of
    whole groups where they form them, else one kv head a q head."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq_loc == hq or k.shape[2] != hkv:
        return k, v
    g = hq // hkv
    first = axis_index(L.MODEL) * hq_loc
    idx = [(first + i) // g for i in range(hq_loc)]
    n = idx[-1] - idx[0] + 1
    if hq_loc % n == 0 and idx == [idx[0] + i // (hq_loc // n)
                                   for i in range(hq_loc)]:
        return k.narrow(2, idx[0], n), v.narrow(2, idx[0], n)
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _resid_io(resid):
    """(the batch entry of the residual's layout, the output constrain's
    entries): the JAX package's (DATA, None, None) without ``resid``."""
    if resid is None:
        return None, (L.DATA, None, None)
    return resid[0], tuple(resid)


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul; the result is contiguous."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def gqa_apply(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              cache: KVCache | None = None, window: int | None = None,
              kv_override=None, causal: bool = True, resid=None):
    """x (B, S, d). Train/prefill when cache is None or being filled;
    decode when S == 1 against an existing cache.

    Window caches may be ROLLING: allocated with `window` slots, written
    modulo window; kv slot positions are then reconstructed analytically.
    The cache's tensors are written IN PLACE (the JAX package returns new
    arrays; in place saves a copy of the cache per step) and returned in a
    KVCache with the advanced pos.

    kv_override: (k, v) (B, F, Hkv, hd), the encoder memory's K/V for
    cross-attention: q alone is projected (no RoPE), attends to every key
    through ``attend`` (the kernel on a card, Sq = 1 in decode too), and
    the cache is passed through unchanged.

    On a mesh, x is whole on S and ``resid`` is the residual stream's
    resolved layout (B, S, d), which the output is reduced into; the
    params, the cache and kv_override hold this rank's heads."""
    b, sq, _ = x.shape
    rb, out_entries = _resid_io(resid)
    hq_loc = p["wq"].shape[-2]
    q = constrain(_proj_heads(x, p["wq"]), L.DATA, None, L.MODEL, None,
                  have=(rb, None, split_axis(hq_loc, cfg.n_heads)))
    partial = split_axis(p["wo"].shape[-3], cfg.n_heads)
    if kv_override is not None:
        out = attend(q, *_local_kv(*kv_override, hq_loc, cfg), causal=False)
        return constrain(_out_proj(out, p["wo"]), *out_entries,
                         have=(rb,), partial=partial), cache
    hkv_at = split_axis(p["wk"].shape[-2], cfg.n_kv_heads)
    wk, wv = p["wk"], p["wv"]
    if hkv_at is None and hq_loc != cfg.n_heads:
        # K / V replicated, each rank reading its q heads' part of them
        # (``_local_kv``): their projections' gradients are partial sums
        wk, wv = sum_grad(wk, L.MODEL), sum_grad(wv, L.MODEL)
    k = constrain(_proj_heads(x, wk), L.DATA, None, L.MODEL, None,
                  have=(rb, None, hkv_at))
    v = constrain(_proj_heads(x, wv), L.DATA, None, L.MODEL, None,
                  have=(rb, None, hkv_at))
    if cfg.rope_theta:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if isinstance(cache, SeqKVCache):
        out = _seq_split_step(q, k, v, cache, cfg, rb, hq_loc, window,
                              causal)
        return constrain(_out_proj(out, p["wo"]), *out_entries, have=(rb,),
                         partial=partial), cache._replace(pos=cache.pos + sq)
    if cache is None:
        out = attend(q, *_local_kv(k, v, hq_loc, cfg), causal=causal,
                     window=window)
    else:
        pos = cache.pos
        slots = cache.k.shape[1]
        rolling = window is not None and slots == window
        if rolling:
            if sq == 1:
                slot = pos % window
                cache.k[:, slot:slot + 1] = k
                cache.v[:, slot:slot + 1] = v
                # slot s holds absolute position pos - ((pos - s) mod W)
                kv_positions = pos - (pos - torch.arange(
                    window, device=x.device)) % window
                out = attend_onepass(q, *_local_kv(cache.k, cache.v, hq_loc,
                                                   cfg),
                                     causal=True, q_offset=pos,
                                     kv_positions=kv_positions)
            else:
                # prefill from zero: attend over in-pass K/V, stash the tail
                out = attend(q, *_local_kv(k, v, hq_loc, cfg), causal=causal,
                             window=window, q_offset=pos)
                take = min(window, sq)
                idx = (pos + sq - take + torch.arange(
                    take, device=x.device)) % window
                cache.k[:, idx] = k[:, -take:].to(cache.k.dtype)
                cache.v[:, idx] = v[:, -take:].to(cache.v.dtype)
        else:
            if pos + sq > slots:
                raise ValueError(f"KV cache of {slots} slots holds {pos} "
                                 f"tokens and cannot take {sq} more")
            cache.k[:, pos:pos + sq] = k
            cache.v[:, pos:pos + sq] = v
            kc, vc = _local_kv(cache.k, cache.v, hq_loc, cfg)
            if sq == 1:
                out = attend_onepass(q, kc, vc, causal=True, window=window,
                                     q_offset=pos, kv_valid_len=pos + 1)
            else:
                out = attend(q, kc, vc, causal=True, window=window,
                             q_offset=pos, kv_valid_len=pos + sq)
        cache = cache._replace(pos=pos + sq)
    return constrain(_out_proj(out, p["wo"]), *out_entries, have=(rb,),
                     partial=partial), cache


def _whole_heads(t: torch.Tensor, whole: int, rb) -> torch.Tensor:
    """(B, S, H_loc, d) of this rank's heads as every head (an all_gather
    over 'model' where they are split)."""
    return constrain(t, L.DATA, None, None, None,
                     have=(rb, None, split_axis(t.shape[2], whole)))


def _seq_split_step(q, k, v, cache: SeqKVCache, cfg, rb, hq_loc: int,
                    window: int | None, causal: bool) -> torch.Tensor:
    """The attention of ``gqa_apply`` over a ``SeqKVCache`` (the module's
    docstring): writes the new rows of this rank's slots in place and
    returns the output of this rank's q heads (B, Sq, hq_loc, hd)."""
    m, r = axis_size(L.MODEL), axis_index(L.MODEL)
    b, sq = q.shape[:2]
    pos, slots = cache.pos, cache.k.shape[1]
    total, lo = slots * m, r * slots
    rolling = window is not None and total == window
    if sq > 1 and pos:
        raise ValueError(f"a prefill into a sequence-split cache starts at "
                         f"position 0, not {pos}")
    if not rolling and pos + sq > total:
        raise ValueError(f"KV cache of {total} slots holds {pos} tokens and "
                         f"cannot take {sq} more")
    kw, vw = _whole_heads(k, cfg.n_kv_heads, rb), \
        _whole_heads(v, cfg.n_kv_heads, rb)
    # the new rows that land in this rank's slots (a rolling cache keeps
    # the last `window` positions, slot t % window), as slices
    first = max(pos, pos + sq - total) if rolling else pos
    t = first
    while t < pos + sq:
        slot = t % total
        run = min(pos + sq - t, total - slot)
        a, z = max(slot, lo), min(slot + run, lo + slots)
        if a < z:
            src = slice(t - pos + a - slot, t - pos + z - slot)
            cache.k[:, a - lo:z - lo] = kw[:, src].to(cache.k.dtype)
            cache.v[:, a - lo:z - lo] = vw[:, src].to(cache.v.dtype)
        t += run
    if sq > 1:                          # the prefill: in-pass keys
        return attend(q, *_local_kv(k, v, hq_loc, cfg), causal=causal,
                      window=window)
    qw = _whole_heads(q, cfg.n_heads, rb)
    hq = cfg.n_heads
    # this rank's keys: its slots below pos + 1 (a rolling cache then
    # holds the last `window` positions, all in reach), within the window
    n = min(max(pos + 1 - lo, 0), slots)
    if n and not rolling and window is not None and \
            pos - (lo + n - 1) >= window:
        n = 0
    if n:
        out, lse = ops.flash_attention(
            qw.float(), cache.k, cache.v, causal=False,
            window=None if rolling else window, q_offset=pos - lo,
            kv_valid_len=n, return_lse=True)
    else:                   # no key here: a weight of 0 in the sums below
        out = torch.zeros((b, 1, hq, cache.v.shape[-1]),
                          dtype=torch.float32, device=q.device)
        lse = torch.full((b, hq, 1), -math.inf, dtype=torch.float32,
                         device=q.device)
    top = psum(lse, L.MODEL, op="max")
    w = torch.exp(lse - top).transpose(1, 2)[..., None]    # (B, 1, Hq, 1)
    both = psum(torch.cat([out * w, w], -1), L.MODEL)
    out = (both[..., :-1] / both[..., -1:]).to(q.dtype)
    return out.narrow(2, r * hq_loc, hq_loc) if hq_loc != hq else out


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    hq, hd, d = wo.shape
    return out.reshape(*out.shape[:2], hq * hd) @ wo.reshape(hq * hd, d)


def gqa_empty_cache(cfg, batch: int, max_len: int, dtype, *,
                    stack: tuple = (), device="cuda",
                    seq_split: bool = False) -> KVCache:
    """Zero K / V of (*stack, B, max_len, Hkv, hd); on a mesh this rank's
    block of P(DATA, None, MODEL, None), lifted over ``stack``, or with
    ``seq_split`` a ``SeqKVCache``, its block of P(DATA, MODEL, None,
    None), where 'model' divides max_len (else the heads' layout)."""
    hkv = cfg.n_kv_heads
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    whole = (*stack, batch, max_len, hkv, hd)
    lift = (None,) * len(stack)
    m = axis_size(L.MODEL)
    kind = KVCache
    if seq_split and m > 1 and max_len % m == 0:
        shape, kind = local_shape(whole, P(*lift, L.DATA, L.MODEL)), \
            SeqKVCache
    else:
        shape = local_shape(whole, P(*lift, L.DATA, None, L.MODEL, None))
    return kind(torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device), 0)


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2 family), latent-space (absorbed) formulation
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, *, stack: tuple = ()) -> dict:
    """The JAX package's tree, its 2-D projections: wq (d, H (nope +
    rope)), wdkv (d, lora + rope), kv_norm, wuk (lora, H nope), wuv (lora,
    H vd), wo (H vd, d); ``stack`` prepends the n_groups axis."""
    d, hq = cfg.d_model, cfg.n_heads
    nope = cfg.head_dim or 128
    rope, lora, vd = cfg.qk_rope_dim, cfg.kv_lora_rank, cfg.mla_v_dim

    def dense(d_in, d_out, scale=None):
        return L.dense_init(gen, d_in, d_out, cfg.dtype, scale=scale,
                            stack=stack)

    return {"wq": dense(d, hq * (nope + rope)),
            "wdkv": dense(d, lora + rope),
            "kv_norm": L.norm_init(lora, "rmsnorm", stack=stack,
                                   device=gen.device),
            "wuk": dense(lora, hq * nope),
            "wuv": dense(lora, hq * vd),
            "wo": dense(hq * vd, d, 1.0 / math.sqrt(hq * vd))}


def mla_specs() -> dict:
    """The JAX package's ``mla_init`` specs: the head columns of wq, wuk
    and wuv over 'model', wo's rows; the latent projection replicated."""
    return {"wq": P(None, L.MODEL), "wdkv": P(None, None),
            "kv_norm": L.norm_specs("rmsnorm"), "wuk": P(None, L.MODEL),
            "wuv": P(None, L.MODEL), "wo": P(L.MODEL, None)}


def _mla_heads(p, cfg, nope: int, rope: int) -> int:
    """This rank's head count: wq's column block holds whole heads, or
    the sharded path does not run."""
    hq_loc, cols = divmod(p["wq"].shape[-1], nope + rope)
    if cols:
        raise NotImplementedError(
            f"MLA's wq split into {p['wq'].shape[-1]} columns cuts a head "
            f"of {nope + rope}: ROADMAP A6 (the sharded LM)")
    return hq_loc


def mla_apply(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              cache: KVCache | None = None, resid=None):
    """x (B, S, d). Queries are absorbed into latent space (q_nope @ W_uk),
    so attention runs with ONE KV head of width kv_lora + rope: dk 576, dv
    512 at deepseek-v2-lite's width. K is the normalised latent with the
    decoupled rope key, V its first kv_lora columns, up-projected by W_uv
    after the weighted sum.

    The cache is one tensor (B, Smax, 1, kv_lora + rope), as the JAX
    package's KVCache(kc, kc, pos): written in place, read as k and, through
    the view kc[..., :kv_lora], as v. A prefill attends through ``attend``
    (the kernel on a card), a decode step (S == 1) through the plain
    ``attend_onepass``, as in the JAX package.

    On a mesh, x is whole on S, the rank holds its heads' columns of wq,
    wuk and wuv and its rows of wo, and the latent K / V (one head) and
    the cache are replicated over 'model'; ``resid`` as in ``gqa_apply``."""
    nope = cfg.head_dim or 128
    rope, lora, vd = cfg.qk_rope_dim, cfg.kv_lora_rank, cfg.mla_v_dim
    hq = _mla_heads(p, cfg, nope, rope)
    b, sq, _ = x.shape
    rb, out_entries = _resid_io(resid)

    q = (x @ p["wq"]).view(b, sq, hq, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    wuk = p["wuk"].view(lora, hq, nope)
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope.float(),
                         wuk.float()).to(x.dtype)
    q_all = constrain(torch.cat([q_lat, q_rope], dim=-1),  # (B,S,H,l+r)
                      L.DATA, None, L.MODEL, None,
                      have=(rb, None, split_axis(hq, cfg.n_heads)))

    wdkv, kv_norm = p["wdkv"], p["kv_norm"]
    if hq != cfg.n_heads:
        # the latent K / V replicated, each rank attending with its heads:
        # the latent projection's and its norm's gradients are partial sums
        wdkv = sum_grad(wdkv, L.MODEL)
        kv_norm = {k: sum_grad(v, L.MODEL) for k, v in kv_norm.items()}
    ckv = x @ wdkv                                    # (B, S, lora+rope)
    lat = L.norm_apply(kv_norm, ckv[..., :lora], "rmsnorm")
    k_rope = L.apply_rope(ckv[..., None, lora:], positions, cfg.rope_theta)
    kv = torch.cat([lat[..., None, :], k_rope], dim=-1)   # (B, S, 1, l+r)
    # score scale: MLA normalizes by sqrt(nope + rope), not the latent width
    kv = kv * torch.tensor(math.sqrt((lora + rope) / (nope + rope)),
                           dtype=x.dtype, device=x.device)

    if cache is None:
        out = attend(q_all, kv, kv[..., :lora], causal=True)
    else:
        pos, kc = cache.pos, cache.k
        if pos + sq > kc.shape[1]:
            raise ValueError(f"MLA cache of {kc.shape[1]} slots holds {pos} "
                             f"tokens and cannot take {sq} more")
        kc[:, pos:pos + sq] = kv
        cache = KVCache(kc, kc, pos + sq)
        fn = attend_onepass if sq == 1 else attend
        out = fn(q_all, kc, kc[..., :lora], causal=True, q_offset=pos,
                 kv_valid_len=pos + sq)
    wuv = p["wuv"].view(lora, hq, vd)
    o = torch.einsum("bshl,lhv->bshv", out.float(), wuv.float()).to(x.dtype)
    return constrain(o.reshape(b, sq, hq * vd) @ p["wo"], *out_entries,
                     have=(rb,), partial=split_axis(hq, cfg.n_heads)), cache


def mla_empty_cache(cfg, batch: int, max_len: int, dtype, *,
                    stack: tuple = (), device="cuda") -> KVCache:
    """One zero tensor (*stack, B, max_len, 1, kv_lora + rope), held as
    both k and v; on a mesh this rank's batch block (replicated over
    'model')."""
    shape = local_shape((*stack, batch, max_len, 1,
                         cfg.kv_lora_rank + cfg.qk_rope_dim),
                        P(*(None,) * len(stack), L.DATA))
    z = torch.zeros(shape, dtype=dtype, device=device)
    return KVCache(z, z, 0)
