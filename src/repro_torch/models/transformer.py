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
recomputed there either).

On a mesh (``sharding.use_mesh``; ``decoder_specs`` is the JAX package's
spec tree, the stacked groups' specs lifted by a leading None) every rank
runs the forward on its own blocks, SPMD, with the JAX package's
``constrain`` points as explicit collectives (``sharding.constrain``).
The caller passes the whole tokens; a rank takes its batch rows
(``DATA``) and gets back its block of the logits, P(DATA, None, MODEL).
Besides the ``constrain`` points, three collectives are forced by a
layout, as GSPMD forces them: (1) the embedding's rows lie over 'model',
so a rank looks up the tokens it holds and the partial sum is all-reduced
at x's ``constrain`` (JAX ``transformer.py:213``); (2) under
``cfg.seq_shard`` the residual stream lies split on S between blocks
(Megatron sequence parallelism, ``:222-234``): before a mixer or an MLP
the normed input is all-gathered on S (q / k / v's ``constrain`` wants S
whole), and the row-parallel output's reduction scatters onto S (a
reduce_scatter: the output ``constrain`` and the block's
``seq_constrain`` as one, as XLA's reduce-scatter creator makes them); a
sequence 'model' does not divide (decode's S = 1) stays whole, and the
reductions are all-reduces; (3) ``logits_slice`` of an S-split residual:
its last rows lie on the last 'model' rank, which broadcasts them.
The vocabulary-split logits then need no collective (``:288``).

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
enc-dec stack (whisper) is ``encdec.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import (P, axis_index, axis_size, block_of,
                                    broadcast_from, constrain, current_mesh,
                                    resolve_entries, sum_grad)
from . import attention as A
from . import layers as L
from . import moe as M
from . import rglru as R
from . import ssm as S
from .config import ModelConfig

__all__ = ["block_init", "block_specs", "block_apply", "block_empty_cache",
           "decoder_init", "decoder_specs", "decoder_empty_cache",
           "decoder_forward", "lift", "resid_spec", "embed_lookup", "Gather",
           "FSDP_AXIS"]

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


def block_specs(cfg: ModelConfig, mixer: str, mlp: str) -> dict:
    """The JAX package's specs of one block (``block_init``'s tree)."""
    _refuse(mixer, mlp)
    mix = {"mla": A.mla_specs, "mamba": S.ssd_specs,
           "rglru": R.rglru_specs}.get(mixer, A.gqa_specs)()
    s = {"norm1": L.norm_specs(cfg.norm), "mixer": mix}
    if mlp == "none":
        return s
    s["norm2"] = L.norm_specs(cfg.norm)
    if mlp == "moe":
        s["moe"] = M.moe_specs(cfg)
    else:
        s["mlp"] = L.mlp_specs(cfg.mlp_kind)
    return s


def _whole_seq(h: torch.Tensor, resid, part: bool = False) -> torch.Tensor:
    """A block input as its mixer or MLP reads it, whole on S: Megatron-SP's
    all_gather when the residual lies split on S (q / k / v's
    ``constrain`` wants S whole). ``part``: the reader computes a part a
    rank (its params split over 'model'), so the cotangent it gives h is
    a partial sum over 'model' (the module's docstring): the gather's
    backward is then a reduce_scatter, and a whole-S h goes through
    ``sum_grad`` (an all_reduce backward)."""
    if resid is None:
        return h
    if resid[1] is not None:
        return constrain(h, resid[0], None, None, have=resid,
                         grad_partial=L.MODEL if part else None)
    return sum_grad(h, L.MODEL) if part else h


def _norm(p, x: torch.Tensor, cfg: ModelConfig, resid) -> torch.Tensor:
    """``norm_apply`` on the residual stream; where its rows lie split on
    S, the norm's gradient on a rank is a partial sum over that axis."""
    if resid is not None and resid[1] is not None:
        p = {k: sum_grad(v, resid[1]) for k, v in p.items()}
    return L.norm_apply(p, x, cfg.norm)


def reads_part(p, kind: str, cfg: ModelConfig) -> bool:
    """Whether a mixer or an MLP of kind ``kind`` computes a part a rank
    from its input: its params (``p``, this rank's blocks) split over
    'model', the column-parallel products of tensor parallelism."""
    if kind in GQA_KINDS:
        return p["wq"].shape[-2] != cfg.n_heads
    if kind == "mla":
        nope = cfg.head_dim or 128
        return p["wq"].shape[-1] != cfg.n_heads * (nope + cfg.qk_rope_dim)
    if kind == "mamba":
        return S.ssd_split(p, cfg)
    if kind == "rglru":
        return p["wx"].shape[-1] != (cfg.rnn_width or cfg.d_model)
    if kind == "moe":
        return p["wo"].shape[-2] != (cfg.moe_d_ff or cfg.d_ff)
    return L.mlp_partial(p, cfg.d_ff) is not None


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, mixer: str, mlp: str,
                *, positions: torch.Tensor, cache=None, resid=None):
    """Returns (x, new_cache, aux_loss); aux_loss is the MoE's Switch loss,
    a 0-d float32 tensor (0 for a dense MLP or none). On a mesh, x is this
    rank's block of the residual stream, laid out as ``resid``
    (``resid_spec``), and so is the returned x."""
    _refuse(mixer, mlp)
    h = _whole_seq(_norm(p["norm1"], x, cfg, resid), resid,
                   resid is not None and reads_part(p["mixer"], mixer, cfg))
    if mixer == "mla":
        y, cache = A.mla_apply(p["mixer"], h, cfg, positions=positions,
                               cache=cache, resid=resid)
    elif mixer in GQA_KINDS:
        win = cfg.window if mixer in ("swa", "lattn") else None
        y, cache = A.gqa_apply(p["mixer"], h, cfg, positions=positions,
                               cache=cache, window=win, resid=resid)
    elif mixer == "mamba":
        y, cache = S.ssd_apply(p["mixer"], h, cfg, cache=cache, resid=resid)
    else:
        y, cache = R.rglru_apply(p["mixer"], h, cfg, cache=cache,
                                 resid=resid)
    x = x + y
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if mlp == "none":
        return x, cache, zero
    key = "moe" if mlp == "moe" else "mlp"
    h = _whole_seq(_norm(p["norm2"], x, cfg, resid), resid,
                   resid is not None and reads_part(p[key], mlp, cfg))
    if mlp == "moe":
        y, aux = M.moe_apply(p["moe"], h, cfg, resid=resid)
        return x + y, cache, aux
    act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
    y = L.mlp_apply(p["mlp"], h, cfg.mlp_kind, act)
    if resid is not None:       # the row-parallel product into the residual
        y = constrain(y, *resid, have=(resid[0],),
                      partial=L.mlp_partial(p["mlp"], cfg.d_ff))
    return x + y, cache, zero


def block_empty_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                      dtype, *, stack: tuple = (), device="cuda",
                      seq_split: bool = False):
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
                             device=device, seq_split=seq_split)


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


def lift(specs):
    """Specs of a block stacked on a leading n_groups axis: P(None, *s)
    (the JAX package's ``_stack_init``)."""
    if isinstance(specs, dict):
        return {k: lift(v) for k, v in specs.items()}
    return P(None, *specs)


def decoder_specs(cfg: ModelConfig) -> dict:
    """The JAX package's spec tree of ``decoder_init``'s params, leaf for
    leaf: the embedding's vocab rows and lm_head's vocab columns over
    'model', the blocks' specs, the stacked groups' lifted."""
    n_pre, n_groups, n_tail = cfg.layer_plan()
    plen = len(cfg.pattern)
    s = {"embed": L.EMBED_SPEC, "final_norm": L.norm_specs(cfg.norm)}
    if not cfg.tie_embeddings:
        s["lm_head"] = P(None, L.MODEL)
    if cfg.n_patches:
        s["patch_proj"] = P(None, None)
    s["prefix"] = [block_specs(cfg, cfg.mixer_of(i), cfg.mlp_of(i))
                   for i in range(n_pre)]
    s["groups"] = [lift(block_specs(cfg, cfg.mixer_of(n_pre + j),
                                    cfg.mlp_of(n_pre + j)))
                   if n_groups else None for j in range(plen)]
    first_tail = n_pre + n_groups * plen
    s["tail"] = [block_specs(cfg, cfg.mixer_of(first_tail + t),
                             cfg.mlp_of(first_tail + t))
                 for t in range(n_tail)]
    return s


def decoder_empty_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                        device="cuda", seq_split: bool = False) -> dict:
    n_pre, n_groups, n_tail = cfg.layer_plan()
    plen = len(cfg.pattern)

    def one(mixer, stack=()):
        return block_empty_cache(cfg, mixer, batch, max_len, dtype,
                                 stack=stack, device=device,
                                 seq_split=seq_split)

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


def resid_spec(cfg: ModelConfig, batch: int, seq: int, seq_shard: bool
               ) -> P | None:
    """The residual stream's layout (B, S, d) on the current mesh, resolved
    with the fallbacks: the batch over DATA, S over 'model' under
    ``seq_shard``; None without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return resolve_entries(mesh, (L.DATA, L.MODEL if seq_shard else None,
                                  None), (batch, seq, cfg.d_model))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, cfg
                 ) -> tuple[torch.Tensor, str | None]:
    """(the rows of ``tokens``, the axis they are a partial sum over). A
    rank holding a block of the vocab rows (P(MODEL, None)) looks up the
    tokens in it and zeros the others: the sum over 'model' is the lookup
    of the whole table."""
    if table.shape[0] == cfg.vocab_padded:
        return table[tokens.long()], None
    idx = tokens.long() - axis_index(L.MODEL) * table.shape[0]
    mine = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(mine, idx, 0)]
    return rows * mine[..., None].to(rows.dtype), L.MODEL


def _last_rows(x: torch.Tensor, n: int, resid, part: bool) -> torch.Tensor:
    """The last ``n`` positions of the residual (all of them for n =
    None), whole on S: the last 'model' rank broadcasts its tail of an
    S-split residual. ``part``: the vocabulary-split head reads them
    (``_whole_seq``)."""
    if resid is not None and resid[1] is not None and n is not None \
            and n <= x.shape[1]:
        return broadcast_from(x[:, -n:].contiguous(), resid[1],
                              axis_size(resid[1]) - 1)
    x = _whole_seq(x, resid, part)
    return x if n is None else x[:, -n:]


FSDP_AXIS = "data"    # the mesh axis FSDP also splits the weights over


@dataclasses.dataclass(frozen=True)
class Gather:
    """An FSDP leaf of ``Model.layout``: the rank holds the block of the
    resolved entries ``have`` and a layer reads the block of ``want``."""
    have: tuple
    want: tuple


def _read(p, lay):
    """The params ``p`` as a layer reads them: each ``Gather`` leaf of
    ``lay`` (a tree of p's structure, or None / False for none) gathered
    from its FSDP block to its base block through ``constrain`` (an
    all_gather over 'data'; its transpose reduce-scatters the weight's
    gradient, a partial sum over 'data', onto the block)."""
    if lay is None or lay is False:
        return p
    if isinstance(lay, Gather):
        return constrain(p, *lay.want, have=lay.have, grad_partial=FSDP_AXIS)
    if isinstance(lay, dict):
        return {k: _read(v, lay[k]) for k, v in p.items()}
    return type(p)(_read(v, w) for v, w in zip(p, lay))


def _stacked(lay):
    """``lay`` of a stacked group as one layer reads it: each ``Gather``'s
    leading (stack) entry dropped; a stack split over 'data' (FSDP's last
    resort) has no layer block, so the whole stack is gathered first
    (``_whole_stack``)."""
    if lay is None or lay is False:
        return lay
    if isinstance(lay, Gather):
        return Gather(lay.have[1:], lay.want[1:])
    return {k: _stacked(v) for k, v in lay.items()}


def _whole_stack(p, lay):
    """The stacked params ``p`` with each leaf split over 'data' on its
    stack dim gathered whole on that dim (and its ``lay`` entry with it)."""
    if lay is None or lay is False:
        return p, lay
    if isinstance(lay, Gather):
        if lay.have[0] is None:
            return p, lay
        g = Gather((lay.want[0], *lay.have[1:]), lay.want)
        x = constrain(p, *g.have, have=lay.have, grad_partial=FSDP_AXIS)
        return x, (False if g.have == g.want else g)
    out = {k: _whole_stack(v, lay[k]) for k, v in p.items()}
    return {k: v[0] for k, v in out.items()}, \
        {k: v[1] for k, v in out.items()}


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
                    logits_slice: int | None = None, layout=None):
    """tokens (B, S) int. cache=None -> full-sequence forward (all logits).
    With cache -> prefill/decode; logits for the last `logits_slice` tokens.
    patches (B, Np, d) (vlm configs): projected by ``patch_proj`` and put
    before the tokens, whose positions then start at Np; a vlm forward
    without a cache needs them.

    ``layout``: ``Model.layout()`` (FSDP): each layer's weights are
    gathered where the layer reads them (``_read``).

    Returns (logits, new_cache, aux_loss_sum): the sum over the layers of
    the MoE layers' Switch losses, a 0-d float32 tensor (0 without MoE)."""
    lay = layout or {}

    def read(key, i=None):
        p, w = params[key], lay.get(key)
        if i is not None:
            p, w = p[i], (None if w is None else w[i])
        return _read(p, w)
    n_pre, n_groups, n_tail = cfg.layer_plan()
    plen = len(cfg.pattern)
    b = tokens.shape[0]
    rb = None if current_mesh() is None else resolve_entries(
        current_mesh(), (L.DATA,), (b,))[0]
    x, part = embed_lookup(read("embed"), block_of(tokens, P(L.DATA)), cfg)
    x = constrain(x, L.DATA, None, None, have=(rb,), partial=part)
    if cfg.n_patches and patches is not None:
        px = block_of(patches, P(L.DATA)).to(cfg.dtype)
        x = torch.cat([px @ read("patch_proj"), x], dim=1)
    elif cfg.n_patches and cache is None:
        raise ValueError(f"{cfg.name}: a vlm forward without a cache needs "
                         f"the patch embeddings")
    seq = x.shape[1]
    pos0 = 0 if cache is None else _cache_pos(cache)
    positions = (pos0 + torch.arange(seq, device=x.device))[None, :]
    new_cache = {"prefix": [], "groups": [], "tail": []} \
        if cache is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    resid = resid_spec(cfg, b, seq, cfg.seq_shard)
    if resid is not None:               # the seq_constrain: a local slice
        x = constrain(x, *resid, have=(rb,))

    def run_block(p, xx, li, c):
        return block_apply(p, xx, cfg, cfg.mixer_of(li), cfg.mlp_of(li),
                           positions=positions, cache=c, resid=resid)

    for i in range(n_pre):
        c = None if cache is None else cache["prefix"][i]
        x, c2, aux = run_block(read("prefix", i), x, i, c)
        aux_total = aux_total + aux
        if cache is not None:
            new_cache["prefix"].append(_store(c, c2))

    pos = [None] * plen
    stacks = [_whole_stack(params["groups"][j],
                           None if "groups" not in lay else lay["groups"][j])
              for j in range(plen)] if n_groups else []

    def group(gi, xx, aux_acc):
        """Group gi: layers n_pre + gi * plen + j; with a cache, each
        block's state is written into its slice and its pos kept."""
        for j in range(plen):
            c = None if cache is None else _layer(cache["groups"][j], gi)
            stack, slay = stacks[j]
            xx, c2, aux = run_block(_read(_slice(stack, gi), _stacked(slay)),
                                    xx, n_pre + j, c)
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
        x, c2, aux = run_block(read("tail", t), x, first_tail + t, c)
        aux_total = aux_total + aux
        if cache is not None:
            new_cache["tail"].append(_store(c, c2))

    head = read("embed").T if cfg.tie_embeddings else read("lm_head")
    x = _last_rows(_norm(read("final_norm"), x, cfg, resid), logits_slice,
                   resid, head.shape[-1] != cfg.vocab_padded)
    logits = L.logits_softcap(x @ head, cfg.logit_softcap)
    logits = logits + _local_mask(cfg, head.shape[-1], x.device).to(
        logits.dtype)
    return constrain(logits, L.DATA, None, L.MODEL, have=(
        rb, None, A.split_axis(head.shape[-1], cfg.vocab_padded))), \
        new_cache, aux_total


def _local_mask(cfg, cols: int, device) -> torch.Tensor:
    """``_vocab_mask`` over this rank's ``cols`` vocabulary columns."""
    mask = _vocab_mask(cfg, device)
    if cols == mask.shape[0]:
        return mask
    return mask.narrow(0, axis_index(L.MODEL) * cols, cols)


def _cache_pos(cache) -> int:
    for part in ("prefix", "tail"):
        if cache[part]:
            return cache[part][0].pos
    for g in cache["groups"]:
        if g is not None:
            return g.pos
    raise ValueError("empty cache")
