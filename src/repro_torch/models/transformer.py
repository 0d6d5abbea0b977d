"""Decoder-only LM: embedding, mixer/MLP blocks, stacked layer groups
(counterpart of ``repro/models/transformer.py``).

Layer stacking keeps the JAX package's structure, so its params carry over
one to one: the per-layer mixer is cfg.pattern[i % len(pattern)]; layers are
grouped into repeating pattern units whose params are stacked on a leading
n_groups axis; first_k_dense prefix layers and the pattern remainder (tail)
stand alone. Where the JAX package ``lax.scan``s a unit over the stacked
params, the port loops over the stacked slices in Python. Its ``remat`` is
kept: a forward with autograd on and no cache runs each group slice (one
pattern unit) under ``torch.utils.checkpoint`` when ``cfg.remat`` is set,
so the backward recomputes the group's activations from its input, as
``jax.checkpoint(group_body)`` does (the prefix and tail layers are not
recomputed there either). ``constrain`` (sharding annotations) has no
meaning on one card and is dropped (the sharded LM is ROADMAP A6).

Caches mirror the param structure: {"prefix": [...], "groups": [one
cache per pattern slot, its tensors stacked on a leading n_groups axis],
"tail": [...]}: a KVCache (k, v), an MLA KVCache (one (n_groups, B, S, 1,
kv_lora + rope) tensor as both k and v), an SSMCache (state, conv) or an
RGLRUCache (h, conv), each with a Python int pos. A forward writes every
cache tensor in place (a block that returns new tensors has them copied
into its layer's slice) and returns the caches with the blocks' new pos.

Ported mixers: attn, swa and lattn (GQA), mla (latent attention), mamba
(Mamba2's SSD, ``ssm.py``) and rglru (RecurrentGemma's RG-LRU,
``rglru.py``); MLPs: dense, moe (top-k routed experts with capacity, plus
shared experts; the first_k_dense prefix layers dense), whose Switch aux
losses are summed over the layers, and none (the ssm family: the block is
its mixer). A vlm config (``n_patches``) adds ``patch_proj``: a forward
given patch embeddings (B, Np, d) prepends their projection to the token
embeddings (internvl2's stub vision tower, as in the JAX package). The
enc-dec stack (whisper) is ``encdec.py``; the attention softcap raises
NotImplementedError naming ROADMAP A6.
"""

from __future__ import annotations

import torch

from . import attention as A
from . import layers as L
from . import moe as M
from . import rglru as R
from . import ssm as S
from .config import ModelConfig

__all__ = ["block_init", "block_apply", "block_empty_cache", "decoder_init",
           "decoder_empty_cache", "decoder_forward"]

GQA_KINDS = ("attn", "swa", "lattn")
MIXERS = (*GQA_KINDS, "mla", "mamba", "rglru")
MLPS = ("dense", "moe", "none")
_A6 = "ROADMAP A6 (the rest of the LM stack)"


def _refuse(mixer: str, mlp: str = "none") -> None:
    if mixer not in MIXERS or mlp not in MLPS:
        raise NotImplementedError(f"block ({mixer!r}, {mlp!r}) is not "
                                  f"ported: {_A6}")


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, mixer: str, mlp: str,
               *, stack: tuple = ()) -> dict:
    """The JAX package's block tree: norm1 and the mixer, then norm2 and
    the MLP (dense or moe) unless the block has none (the ssm family)."""
    _refuse(mixer, mlp)
    dev = gen.device
    if mixer == "mla":
        mix = A.mla_init(gen, cfg, stack=stack)
    elif mixer in GQA_KINDS:
        mix = A.gqa_init(gen, cfg, stack=stack)
    elif mixer == "mamba":
        mix = S.ssd_init(gen, cfg, stack=stack)
    else:
        mix = R.rglru_init(gen, cfg, stack=stack)
    p = {"norm1": L.norm_init(cfg.d_model, cfg.norm, stack=stack,
                              device=dev),
         "mixer": mix}
    if mlp == "none":
        return p
    p["norm2"] = L.norm_init(cfg.d_model, cfg.norm, stack=stack, device=dev)
    if mlp == "moe":
        p["moe"] = M.moe_init(gen, cfg, stack=stack)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                              cfg.mlp_kind, stack=stack)
    return p


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, mixer: str, mlp: str,
                *, positions: torch.Tensor, cache=None):
    """Returns (x, new_cache, aux_loss); aux_loss is the MoE's Switch loss,
    a 0-d float32 tensor (0 for a dense MLP or none)."""
    _refuse(mixer, mlp)
    h = L.norm_apply(p["norm1"], x, cfg.norm)
    if mixer == "mla":
        y, cache = A.mla_apply(p["mixer"], h, cfg, positions=positions,
                               cache=cache)
    elif mixer in GQA_KINDS:
        win = cfg.window if mixer in ("swa", "lattn") else None
        y, cache = A.gqa_apply(p["mixer"], h, cfg, positions=positions,
                               cache=cache, window=win)
    elif mixer == "mamba":
        y, cache = S.ssd_apply(p["mixer"], h, cfg, cache=cache)
    else:
        y, cache = R.rglru_apply(p["mixer"], h, cfg, cache=cache)
    x = x + y
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if mlp == "none":
        return x, cache, zero
    h = L.norm_apply(p["norm2"], x, cfg.norm)
    if mlp == "moe":
        y, aux = M.moe_apply(p["moe"], h, cfg)
        return x + y, cache, aux
    act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
    return x + L.mlp_apply(p["mlp"], h, cfg.mlp_kind, act), cache, zero


def block_empty_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                      dtype, *, stack: tuple = (), device="cuda"):
    _refuse(mixer)
    if mixer == "mla":
        return A.mla_empty_cache(cfg, batch, max_len, dtype, stack=stack,
                                 device=device)
    if mixer == "mamba":
        return S.ssm_empty_cache(cfg, batch, dtype, stack=stack,
                                 device=device)
    if mixer == "rglru":
        return R.rglru_empty_cache(cfg, batch, dtype, stack=stack,
                                   device=device)
    # window-bounded mixers only ever read the trailing `window` slots
    ln = max_len if cfg.window is None or mixer == "attn" \
        else min(max_len, cfg.window)
    return A.gqa_empty_cache(cfg, batch, ln, dtype, stack=stack,
                             device=device)


# ---------------------------------------------------------------------------
# stacked init
# ---------------------------------------------------------------------------

def decoder_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The param tree on the generator's device, in the JAX package's
    structure; group params carry a leading n_groups axis."""
    n_pre, n_groups, n_tail = cfg.layer_plan()
    plen = len(cfg.pattern)
    p = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, cfg.dtype),
         "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_padded,
                                    cfg.dtype)
    if cfg.n_patches:
        p["patch_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model,
                                       cfg.dtype)
    p["prefix"] = [block_init(gen, cfg, cfg.mixer_of(i), cfg.mlp_of(i))
                   for i in range(n_pre)]
    p["groups"] = [block_init(gen, cfg, cfg.mixer_of(n_pre + j),
                              cfg.mlp_of(n_pre + j), stack=(n_groups,))
                   if n_groups else None for j in range(plen)]
    first_tail = n_pre + n_groups * plen
    p["tail"] = [block_init(gen, cfg, cfg.mixer_of(first_tail + t),
                            cfg.mlp_of(first_tail + t))
                 for t in range(n_tail)]
    return p


def decoder_empty_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                        device="cuda") -> dict:
    n_pre, n_groups, n_tail = cfg.layer_plan()
    plen = len(cfg.pattern)

    def one(mixer, stack=()):
        return block_empty_cache(cfg, mixer, batch, max_len, dtype,
                                 stack=stack, device=device)

    first_tail = n_pre + n_groups * plen
    return {
        "prefix": [one(cfg.mixer_of(i)) for i in range(n_pre)],
        "groups": [one(cfg.mixer_of(n_pre + j), (n_groups,)) if n_groups
                   else None for j in range(plen)],
        "tail": [one(cfg.mixer_of(first_tail + t)) for t in range(n_tail)],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _vocab_mask(cfg, device="cuda") -> torch.Tensor:
    """(Vpad,) additive mask: -1e30 on padding columns."""
    v = torch.arange(cfg.vocab_padded, device=device)
    return torch.where(v < cfg.vocab_size, 0.0, -1e30).float()


def _slice(tree, g: int):
    """Layer g of a stacked param dict."""
    return {k: _slice(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def _layer(c, g: int):
    """Layer g of a stacked cache: every tensor field sliced at g (views,
    so a block's in-place write lands in the stack)."""
    return c._replace(**{f: getattr(c, f)[g] for f in c._fields
                         if f != "pos"})


def _store(dst, new):
    """A block's returned cache ``new`` written into ``dst``'s tensors: a
    field that is already dst's memory (the attention blocks write their
    caches in place) is left as it is, a new tensor (the recurrent blocks
    return new state) is copied in. Returns dst with new's pos."""
    for f in dst._fields:
        if f == "pos":
            continue
        d, n = getattr(dst, f), getattr(new, f)
        if n.data_ptr() != d.data_ptr() or n.stride() != d.stride():
            d.copy_(n)
    return dst._replace(pos=new.pos)


def decoder_forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                    cache=None, patches: torch.Tensor | None = None,
                    logits_slice: int | None = None):
    """tokens (B, S) int. cache=None -> full-sequence forward (all logits).
    With cache -> prefill/decode; logits for the last `logits_slice` tokens.
    patches (B, Np, d) (vlm configs): projected by ``patch_proj`` and put
    before the tokens, whose positions then start at Np; a vlm forward
    without a cache needs them.

    Returns (logits, new_cache, aux_loss_sum): the sum over the layers of
    the MoE layers' Switch losses, a 0-d float32 tensor (0 without MoE)."""
    n_pre, n_groups, n_tail = cfg.layer_plan()
    plen = len(cfg.pattern)
    x = params["embed"][tokens.long()]
    if cfg.n_patches and patches is not None:
        x = torch.cat([patches.to(cfg.dtype) @ params["patch_proj"], x],
                      dim=1)
    elif cfg.n_patches and cache is None:
        raise ValueError(f"{cfg.name}: a vlm forward without a cache needs "
                         f"the patch embeddings")
    seq = x.shape[1]
    pos0 = 0 if cache is None else _cache_pos(cache)
    positions = (pos0 + torch.arange(seq, device=x.device))[None, :]
    new_cache = {"prefix": [], "groups": [], "tail": []} \
        if cache is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_block(p, xx, li, c):
        return block_apply(p, xx, cfg, cfg.mixer_of(li), cfg.mlp_of(li),
                           positions=positions, cache=c)

    for i in range(n_pre):
        c = None if cache is None else cache["prefix"][i]
        x, c2, aux = run_block(params["prefix"][i], x, i, c)
        aux_total = aux_total + aux
        if cache is not None:
            new_cache["prefix"].append(_store(c, c2))

    pos = [None] * plen

    def group(gi, xx, aux_acc):
        """Group gi: layers n_pre + gi * plen + j; with a cache, each
        block's state is written into its slice and its pos kept."""
        for j in range(plen):
            c = None if cache is None else _layer(cache["groups"][j], gi)
            xx, c2, aux = run_block(_slice(params["groups"][j], gi), xx,
                                    n_pre + j, c)
            aux_acc = aux_acc + aux
            if cache is not None:
                pos[j] = _store(c, c2).pos
        return xx, aux_acc

    for gi in range(n_groups):              # the JAX package's lax.scan
        x, aux_total = group(gi, x, aux_total) if cache is not None \
            else L.remat(cfg, group, gi, x, aux_total)
    if cache is not None and n_groups:
        new_cache["groups"] = [s._replace(pos=p) for s, p in
                               zip(cache["groups"], pos)]

    first_tail = n_pre + n_groups * plen
    for t in range(n_tail):
        c = None if cache is None else cache["tail"][t]
        x, c2, aux = run_block(params["tail"][t], x, first_tail + t, c)
        aux_total = aux_total + aux
        if cache is not None:
            new_cache["tail"].append(_store(c, c2))

    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.logits_softcap(x @ head, cfg.logit_softcap)
    logits = logits + _vocab_mask(cfg, x.device).to(logits.dtype)
    return logits, new_cache, aux_total


def _cache_pos(cache) -> int:
    for part in ("prefix", "tail"):
        if cache[part]:
            return cache[part][0].pos
    for g in cache["groups"]:
        if g is not None:
            return g.pos
    raise ValueError("empty cache")
