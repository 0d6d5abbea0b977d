"""Encoder-decoder stack, whisper-large-v3's backbone (counterpart of
``repro/models/encdec.py``).

The conv / mel frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, n_frames, d_model) and adds sinusoidal
positions. The decoder is a pre-LN transformer with causal self-attention
(KV-cached), cross-attention to the encoder memory (its K/V projected once
at prefill and cached) and a plain GeLU MLP; token and output embeddings
are tied, LayerNorm, no RoPE (absolute sinusoidal positions on both sides).

Every attention goes through ``attention.attend``, the kernel on a card:
the encoder's self-attention and every cross-attention without the causal
mask (cross-attention at Sq = 1 in each decode step too), the decoder's
self-attention causal in a prefill; a decode step's self-attention reads
the cache with the plain ``attend_onepass``, as in the dense archs.

Both stacks keep the JAX package's params stacked on a leading layer axis
(``enc``, ``dec``), so its tree carries over one to one; where it
``lax.scan``s over them, the port loops over the layers; a cacheless
pass with autograd on recomputes each layer in the backward when
``cfg.remat`` is set (its ``jax.checkpoint`` of each layer body). The decoder's
self cache is one KVCache of (L, B, S, Hkv, hd) tensors, written in place
one layer slice at a time, with one Python int pos (the JAX package's is an
(L,) array of one value).

On a mesh (``encdec_specs``; the JAX package puts no ``seq_constrain``
here, so the residual stays whole on S): a rank takes its batch rows of
the frames and tokens, the attention runs on its heads (whisper's 20 at a
'model' size that does not divide them fall back to replicated, the
JAX package's stated design), the cross K/V and the caches hold its kv
heads (P(None, DATA, None, MODEL, None) on the stacked tensors), the
MLPs are Megatron's, the tied embedding's vocab rows lie over 'model'
(a masked lookup whose partial sum is all-reduced at x's ``constrain``,
JAX ``encdec.py:135``, before the positions are added) and the logits
come back as the rank's vocabulary block (``:182``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..distributed.sharding import P, block_of, constrain, local_shape, sum_grad
from . import attention as A
from . import layers as L
from .config import ModelConfig
from .transformer import (_layer, _local_mask, _slice, _whole_seq,
                          embed_lookup, lift, reads_part, resid_spec)

__all__ = ["EncDecCache", "sinusoid", "encdec_init", "encdec_specs",
           "encode", "project_cross_kv", "decode_forward",
           "encdec_empty_cache"]


class EncDecCache(NamedTuple):
    self_kv: A.KVCache      # stacked (L, B, S, Hkv, hd) self-attention cache
    cross_k: torch.Tensor   # (L, B, F, Hkv, hd)
    cross_v: torch.Tensor


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) -> (S, d) float32 transformer sinusoidal embedding."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _mlp(gen, cfg, stack):
    return L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, cfg.mlp_kind,
                      stack=stack)


def _norm(cfg, stack, dev):
    return L.norm_init(cfg.d_model, cfg.norm, stack=stack, device=dev)


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig, stack: tuple
                    ) -> dict:
    dev = gen.device
    return {"norm1": _norm(cfg, stack, dev),
            "attn": A.gqa_init(gen, cfg, stack=stack),
            "norm2": _norm(cfg, stack, dev),
            "mlp": _mlp(gen, cfg, stack)}


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig, stack: tuple
                    ) -> dict:
    dev = gen.device
    return {"norm1": _norm(cfg, stack, dev),
            "self": A.gqa_init(gen, cfg, stack=stack),
            "norm_x": _norm(cfg, stack, dev),
            "cross": A.gqa_init(gen, cfg, stack=stack),
            "norm2": _norm(cfg, stack, dev),
            "mlp": _mlp(gen, cfg, stack)}


def encdec_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The JAX package's tree on the generator's device: embed, enc
    (stacked on enc_layers), enc_norm, dec (stacked on n_layers),
    dec_norm."""
    return {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                  cfg.dtype),
            "enc": _enc_block_init(gen, cfg, (cfg.enc_layers,)),
            "enc_norm": _norm(cfg, (), gen.device),
            "dec": _dec_block_init(gen, cfg, (cfg.n_layers,)),
            "dec_norm": _norm(cfg, (), gen.device)}


def encdec_specs(cfg: ModelConfig) -> dict:
    """The JAX package's spec tree of ``encdec_init``: the embedding's
    vocab rows over 'model', the stacked layers' specs lifted."""
    norm = L.norm_specs(cfg.norm)
    mlp = L.mlp_specs(cfg.mlp_kind)
    return {"embed": L.EMBED_SPEC,
            "enc": lift({"norm1": norm, "attn": A.gqa_specs(),
                         "norm2": norm, "mlp": mlp}),
            "enc_norm": norm,
            "dec": lift({"norm1": norm, "self": A.gqa_specs(),
                         "norm_x": norm, "cross": A.gqa_specs(),
                         "norm2": norm, "mlp": mlp}),
            "dec_norm": norm}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mlp_res(lp, x, cfg, resid=None):
    h = _whole_seq(L.norm_apply(lp["norm2"], x, cfg.norm), resid,
                   resid is not None and reads_part(lp["mlp"], "dense", cfg))
    y = L.mlp_apply(lp["mlp"], h, cfg.mlp_kind, cfg.act)
    if resid is not None:
        y = constrain(y, *resid, have=(resid[0],),
                      partial=L.mlp_partial(lp["mlp"], cfg.d_ff))
    return x + y


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d_model) stub embeddings -> encoder memory (B, F, d)
    in cfg.dtype (on a mesh: the rank's batch rows of the whole frames)."""
    b, f = frames.shape[:2]
    pos = torch.arange(f, device=frames.device)
    resid = resid_spec(cfg, b, f, False)
    x = block_of(frames, P(L.DATA)).to(cfg.dtype) + \
        sinusoid(pos, cfg.d_model)[None].to(cfg.dtype)

    def layer(li, xx):
        lp = _slice(params["enc"], li)
        h = _whole_seq(L.norm_apply(lp["norm1"], xx, cfg.norm), resid,
                       resid is not None and reads_part(lp["attn"], "attn",
                                                        cfg))
        y, _ = A.gqa_apply(lp["attn"], h, cfg, positions=pos[None],
                           causal=False, resid=resid)
        return _mlp_res(lp, xx + y, cfg, resid)

    for li in range(cfg.enc_layers):
        x = L.remat(cfg, layer, li, x)
    return L.norm_apply(params["enc_norm"], x, cfg.norm)


def _cross_kv(lp, memory, cfg):
    wk, wv = lp["cross"]["wk"], lp["cross"]["wv"]
    if wk.shape[-2] == cfg.n_kv_heads and \
            lp["cross"]["wq"].shape[-2] != cfg.n_heads:
        # replicated K / V read a part a rank (``gqa_apply``)
        wk, wv = sum_grad(wk, L.MODEL), sum_grad(wv, L.MODEL)
    return A._proj_heads(memory, wk), A._proj_heads(memory, wv)


def project_cross_kv(params, cfg: ModelConfig, memory: torch.Tensor):
    """Every decoder layer's cross K/V of the encoder memory (prefill-once):
    two (L, B, F, Hkv, hd) tensors in memory's dtype."""
    kv = [_cross_kv(_slice(params["dec"], li), memory, cfg)
          for li in range(cfg.n_layers)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def decode_forward(params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: EncDecCache | None, *,
                   memory: torch.Tensor | None = None,
                   logits_slice: int | None = None):
    """The decoder over tokens (B, S). cache=None -> the teacher-forced
    full-sequence pass (memory required, each layer's cross K/V projected
    from it); otherwise prefill / decode against the cache, whose self
    cache is written in place and whose cross K/V are read as they are.

    Returns (logits, new_cache)."""
    b, sq = tokens.shape
    dev = tokens.device
    pos0 = 0 if cache is None else cache.self_kv.pos
    pos = pos0 + torch.arange(sq, device=dev)
    resid = resid_spec(cfg, b, sq, False)
    rb = None if resid is None else resid[0]
    x, part = embed_lookup(params["embed"], block_of(tokens, P(L.DATA)), cfg)
    x = constrain(x, L.DATA, None, None, have=(rb,), partial=part) + \
        sinusoid(pos, cfg.d_model)[None].to(cfg.dtype)
    positions = pos[None]
    if cache is None and memory is None:
        raise ValueError("the teacher-forced decoder pass needs the "
                         "encoder memory")
    part = resid is not None and reads_part(params["dec"]["self"], "attn",
                                            cfg)
    cross_part = resid is not None and reads_part(params["dec"]["cross"],
                                                  "attn", cfg)
    if cache is None:           # every layer's cross K/V read a part a rank
        memory = _whole_seq(memory, resid, cross_part)

    def layer(li, xx):
        lp = _slice(params["dec"], li)
        h = _whole_seq(L.norm_apply(lp["norm1"], xx, cfg.norm), resid, part)
        kv = None if cache is None else _layer(cache.self_kv, li)
        y, _ = A.gqa_apply(lp["self"], h, cfg, positions=positions,
                           cache=kv, resid=resid)
        xx = xx + y
        h = _whole_seq(L.norm_apply(lp["norm_x"], xx, cfg.norm), resid,
                       cross_part)
        cross = _cross_kv(lp, memory, cfg) if cache is None else \
            (cache.cross_k[li], cache.cross_v[li])
        y, _ = A.gqa_apply(lp["cross"], h, cfg, positions=positions,
                           kv_override=cross, resid=resid)
        return _mlp_res(lp, xx + y, cfg, resid)

    for li in range(cfg.n_layers):
        x = layer(li, x) if cache is not None else L.remat(cfg, layer, li, x)

    new_cache = None if cache is None else cache._replace(
        self_kv=cache.self_kv._replace(pos=pos0 + sq))
    head = params["embed"].T
    x = _whole_seq(L.norm_apply(params["dec_norm"], x, cfg.norm), resid,
                   head.shape[-1] != cfg.vocab_padded)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    logits = x @ head
    logits = logits + _local_mask(cfg, head.shape[-1], dev).to(logits.dtype)
    return constrain(logits, L.DATA, None, L.MODEL, have=(
        rb, None, A.split_axis(head.shape[-1], cfg.vocab_padded))), new_cache


def encdec_empty_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device="cuda") -> EncDecCache:
    """Zero self cache (L, B, max_len, Hkv, hd) at pos 0 and zero cross
    K/V (L, B, n_frames, Hkv, hd), all in ``dtype``; on a mesh this rank's
    blocks of P(None, DATA, None, MODEL, None)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)

    def z(s):
        return torch.zeros(local_shape(s, P(None, L.DATA, None, L.MODEL)),
                           dtype=dtype, device=device)
    cross = (*shape[:2], cfg.n_frames, *shape[3:])
    return EncDecCache(A.KVCache(z(shape), z(shape), 0), z(cross), z(cross))
