"""Model factory + train / serve step builders, the port's public
modeling API (counterpart of ``repro/models/model.py``):

    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss, parts = model.loss(params, batch)
    step = make_train_step(model, opt_cfg)   # (params, opt, batch) -> ...
    cache = model.init_cache(batch, max_len, dtype=torch.float32)
    logits, cache = model.prefill(params, tokens, cache)  # frames=, patches=
    logits, cache = model.decode(params, tokens1, cache)

``init`` returns the param tree alone; ``specs`` returns the sharding
specs the JAX package's init pairs with it. Every arch of ``repro_torch.configs`` is served and
trained: the dense GQA archs, grok-1 (GQA with MoE and the logit softcap),
deepseek-v2-lite (MLA with MoE and shared experts), mamba2 (SSD blocks),
recurrentgemma (RG-LRU with local attention), whisper (the encoder-decoder
of ``encdec.py``: a prefill takes frames (B, F, d), encodes them and
caches every decoder layer's cross K/V) and internvl2 (a vlm: a prefill
takes patches (B, Np, d), put before the prompt; ``init_cache`` adds their
Np slots). Both modality frontends are stubs, as in the JAX package.

``batch`` dicts: tokens / labels (B, S) int; enc-dec adds frames (B, F,
d), vlm patches (B, Np, d). ``forward`` is the teacher-forced pass with
autograd on (each layer group recomputed in the backward when
``cfg.remat``); the serving calls run under ``torch.no_grad``.

FSDP (``Model(cfg, fsdp=True)``, the JAX package's dry-run layout above
8e9 bytes of params a model shard): on a mesh, ``specs`` are
``sharding.fsdp_specs`` of the JAX package's (every weight also split
over 'data'), each rank holds those blocks, and the forward gathers each
weight back to its base layout where a layer reads it
(``transformer.decoder_forward``'s ``layout``: an all_gather over 'data',
whose transpose reduce-scatters the weight's gradient over 'data', so the
batch reduction skips 'data' for those leaves). Decoder-only models.

The sharded LM (ROADMAP A6): under ``sharding.use_mesh(mesh)``, a
('data', 'model') DeviceMesh (or ('pod', 'data', 'model')), each rank
holds the block of every param that ``model.shardings(mesh)`` gives it
(``bridge.lm_params_onto_mesh``, or ``sharding.blocks_of`` of a tree
drawn whole on every rank), ``init_cache`` makes its block of the cache,
and ``prefill`` / ``decode`` take the whole tokens and return the rank's
block P(DATA, None, MODEL) of the logits (``transformer.py``'s
docstring); ``greedy`` gives every rank the whole batch's tokens. Every
family runs so, and trains so: ``loss`` takes the whole batch and is the
vocabulary-parallel cross-entropy of the rank's logits block (the same
loss on every rank), ``value_and_grad`` gives each rank the gradient
block of its param blocks (autograd through the collectives,
``distributed/sharding.py``'s docstring, then one reduction over the
batch axes), and ``make_train_step`` takes its micro-batches from the
whole batch and runs AdamW on the blocks. Outside a mesh nothing
changes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from .. import tree as T
from ..distributed.sharding import (P, axis_index, block_of, constrain,
                                    current_mesh, fsdp_specs, psum,
                                    resolve_entries, shardings_tree,
                                    tree_flatten, tree_unflatten)
from ..optim import adamw
from . import encdec, transformer
from . import layers as L
from .config import ModelConfig

__all__ = ["Model", "build_model", "value_and_grad", "make_train_step",
           "make_serve_step", "make_prefill_step", "greedy"]

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    fsdp: bool = False

    # -- init ----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """Params on the generator's device, drawn from it."""
        if self.cfg.enc_layers:
            return encdec.encdec_init(gen, self.cfg)
        return transformer.decoder_init(gen, self.cfg)

    def specs(self) -> dict:
        """The JAX package's sharding specs of ``init``'s tree, leaf for
        leaf (its ``init`` returns them beside the params); with ``fsdp``
        on a mesh, their ``sharding.fsdp_specs``."""
        if self.cfg.enc_layers:
            if self.fsdp:
                raise NotImplementedError(
                    f"{self.cfg.name}: FSDP of an enc-dec model is not "
                    f"ported: ROADMAP A7")
            return encdec.encdec_specs(self.cfg)
        base = transformer.decoder_specs(self.cfg)
        mesh = current_mesh()
        if not self.fsdp or mesh is None:
            return base
        return fsdp_specs(base, self.shapes(), mesh)

    def layout(self):
        """With ``fsdp`` on a mesh, a tree of the params' structure whose
        leaves are a ``transformer.Gather`` (the rank's resolved FSDP
        entries and the base ones) where they differ, else False
        (``decoder_forward`` gathers the former where a layer reads them);
        None without FSDP."""
        mesh = current_mesh()
        if not self.fsdp or mesh is None:
            return None
        shapes, structure = tree_flatten(self.shapes(), is_leaf=_is_leaf)
        spec = lambda x: x is None or isinstance(x, P)        # noqa: E731
        base = tree_flatten(transformer.decoder_specs(self.cfg),
                            is_leaf=spec)[0]
        have = tree_flatten(self.specs(), is_leaf=spec)[0]
        out = []
        for t, b, h in zip(shapes, base, have):
            if t is None:
                out.append(None)
                continue
            hb = resolve_entries(mesh, h, t.shape)
            bb = resolve_entries(mesh, b, t.shape)
            out.append(False if hb == bb else transformer.Gather(hb, bb))
        return tree_unflatten(structure, out)

    def shapes(self) -> dict:
        """``init``'s tree as meta tensors: the whole shapes and types, no
        memory, no numbers drawn (the JAX package's ``jax.eval_shape``);
        made once a model (``specs``, ``layout`` and ``shardings`` read it
        inside a step, where an accounting run would count a new one)."""
        return self._shapes

    @functools.cached_property
    def _shapes(self) -> dict:
        return self.init(_MetaGenerator())

    def shardings(self, mesh) -> dict:
        """A ``sharding.NamedSharding`` for each param: its spec resolved on
        the whole shape, with the divisibility fallbacks."""
        return shardings_tree(mesh, self.shapes(), self.specs())

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda", seq_split: bool = False):
        """max_len counts text tokens; a vlm's patch slots are added here.
        An enc-dec cache is an ``encdec.EncDecCache``, any other a dict.
        On a mesh, this rank's block of the cache for ``batch`` requests;
        ``seq_split``: its GQA caches split on the sequence over 'model'
        (``attention.SeqKVCache``, the JAX package's decode layout; an
        enc-dec cache keeps its layout)."""
        max_len = max_len + self.cfg.n_patches
        if self.cfg.enc_layers:
            return encdec.encdec_empty_cache(self.cfg, batch, max_len, dtype,
                                             device=device)
        return transformer.decoder_empty_cache(self.cfg, batch, max_len,
                                               dtype, device=device,
                                               seq_split=seq_split)

    # -- forward -------------------------------------------------------------
    def forward(self, params, batch: dict):
        """Full-sequence logits (the training forward, without a cache) and
        the aux loss: the MoE layers' Switch losses summed, a 0-d float32
        tensor (0 for a model without MoE). ``batch`` holds tokens (B, S),
        and frames (enc-dec) or patches (vlm)."""
        cfg = self.cfg
        if cfg.enc_layers:
            memory = encdec.encode(params, cfg, batch["frames"])
            logits, _ = encdec.decode_forward(params, cfg, batch["tokens"],
                                              None, memory=memory)
            return logits, torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
        logits, _, aux = transformer.decoder_forward(
            params, cfg, batch["tokens"], patches=batch.get("patches"),
            layout=self.layout())
        return logits, aux

    def loss(self, params, batch: dict):
        """(loss, {"ce", "aux"}): the float32 logsumexp cross-entropy of the
        logits against ``batch["labels"]`` over the labels >= 0 (a vlm's
        text logits only), plus router_aux_coef times the aux loss. On a
        mesh, the batch is the whole batch and the cross-entropy the
        vocabulary-parallel one (``_sharded_ce``)."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        if cfg.n_patches:                      # vlm: text logits only
            logits = logits[:, cfg.n_patches:]
        labels = batch["labels"]
        if current_mesh() is not None:
            ce = _sharded_ce(logits, labels, cfg)
            return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        # a masked label (< 0) reads column 0; its term is multiplied by 0
        gold = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None]
                            )[..., 0]
        mask = (labels >= 0).float()
        ce = torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
        return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache, *,
                frames: torch.Tensor | None = None,
                patches: torch.Tensor | None = None):
        """Fill the cache with tokens (B, S); logits (B, 1, Vpad) of the
        last position. The cache's tensors are written in place (an SSM
        cache's pos counts the chunk padding, as the JAX package's: ROADMAP
        C7). An enc-dec model encodes ``frames`` (B, F, d) and writes every
        decoder layer's cross K/V into the cache, cast to its dtype; a vlm
        puts ``patches`` (B, Np, d) before the tokens."""
        cfg = self.cfg
        if cfg.enc_layers:
            if frames is None:
                raise ValueError(f"{cfg.name}: an enc-dec prefill needs the "
                                 f"frames")
            memory = encdec.encode(params, cfg, frames)
            ck, cv = encdec.project_cross_kv(params, cfg, memory)
            cache.cross_k.copy_(ck)
            cache.cross_v.copy_(cv)
            return encdec.decode_forward(params, cfg, tokens, cache,
                                         logits_slice=1)
        logits, cache, _ = transformer.decoder_forward(
            params, cfg, tokens, cache=cache, patches=patches,
            logits_slice=1, layout=self.layout())
        return logits, cache

    @torch.no_grad()
    def decode(self, params, tokens: torch.Tensor, cache):
        """One decode step; tokens (B, 1)."""
        if self.cfg.enc_layers:
            return encdec.decode_forward(params, self.cfg, tokens, cache,
                                         logits_slice=1)
        logits, cache, _ = transformer.decoder_forward(
            params, self.cfg, tokens, cache=cache, logits_slice=1,
            layout=self.layout())
        return logits, cache


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: ``init`` with it
    builds the tree's shapes and types and nothing else."""

    @property
    def device(self):
        return torch.device("meta")


def _is_leaf(x) -> bool:
    return x is None or hasattr(x, "shape")


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _sharded_ce(logits: torch.Tensor, labels: torch.Tensor, cfg
                ) -> torch.Tensor:
    """The cross-entropy of the whole batch from this rank's logits block
    P(DATA, None, MODEL) (Megatron's vocabulary-parallel loss): the rows'
    maxima and sums of exponentials reduced over 'model', the gold logit
    taken on the rank whose columns hold the label (zero elsewhere, summed
    with the exponentials in one all_reduce), the sum of the masked terms
    and the count of labels >= 0 reduced over the batch axes. Its backward
    is softmax minus one-hot on each rank's columns, over the global count
    (the all_reduces' transposes are identities)."""
    rb = resolve_entries(current_mesh(), (L.DATA,), (labels.shape[0],))[0]
    labels = block_of(labels, P(L.DATA)).long()
    lf = logits.float()
    cols = lf.shape[-1]
    split = cols != cfg.vocab_padded
    top = lf.detach().amax(-1, keepdim=True)
    if split:
        top = psum(top, L.MODEL, op="max")
    idx = labels - (axis_index(L.MODEL) * cols if split else 0)
    mine = (idx >= 0) & (idx < cols) & (labels >= 0)
    gold = torch.gather(lf, -1, torch.where(mine, idx, 0)[..., None]
                        )[..., 0] * mine
    se = torch.exp(lf - top).sum(-1)
    if split:
        se, gold = psum(torch.stack([se, gold]), L.MODEL)
    mask = (labels >= 0).float()
    lse = top[..., 0] + torch.log(se)
    tot, n = psum(torch.stack([torch.sum((lse - gold) * mask), mask.sum()]),
                  rb)
    return tot / torch.clamp(n, min=1.0)


def greedy(logits: torch.Tensor, cfg: ModelConfig, batch: int
           ) -> torch.Tensor:
    """The greedy tokens (B, 1) int32 of the last position of logits (B,
    T, Vpad): ``torch.argmax``'s, the first of equal maxima. On a mesh,
    ``logits`` is this rank's block P(DATA, None, MODEL) of ``batch``
    rows; each rank takes its block's maximum and its first index, the
    'model' group all-gathers the pairs and keeps the largest value, the
    smallest global index among equal ones (a collective the vocabulary's
    split forces), and a batch split over 'data' is all-gathered, so every
    rank returns the whole batch's tokens."""
    last = logits[:, -1:]
    if current_mesh() is None:
        return torch.argmax(last, -1).to(torch.int32)
    cols = last.shape[-1]
    idx = torch.argmax(last, -1)                                  # (b, 1)
    pair = torch.stack([last.gather(-1, idx[..., None])[..., 0].double(),
                        (idx + axis_index(L.MODEL) * cols).double()], -1)
    if cols != cfg.vocab_padded:
        pair = constrain(pair[None], None, have=(L.MODEL,))  # (m, b, 1, 2)
        val, gidx = pair[..., 0], pair[..., 1]
        top = val.max(0).values
        pair = torch.where(val == top, gidx, float("inf")).min(0).values
    else:
        pair = pair[..., 1]
    rb = resolve_entries(current_mesh(), (L.DATA,), (batch,))[0]
    return constrain(pair.to(torch.int32), None, None, have=(rb, None))


def _local_grads(model: Model, params, batch: dict):
    """(loss, parts, this rank's grads): the backward on the rank's blocks,
    each gradient exact over 'model' and, on a mesh, a partial sum over
    the batch axes."""
    live = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        loss, parts = model.loss(T.unflatten_like(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _batch_axes(batch: dict):
    """The batch axes the rows of ``batch`` split over on the current
    mesh (its resolved DATA entry), or None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return resolve_entries(mesh, (L.DATA,), (batch["tokens"].shape[0],))[0]


def value_and_grad(model: Model, params, batch: dict):
    """(loss, parts, grads as a list in ``tree.leaves(params)``'s order):
    ``jax.value_and_grad(model.loss, has_aux=True)``. The grads are taken
    by ``torch.autograd.grad`` over the param leaves, each in its param's
    type; the params themselves are not marked. On a mesh, each rank
    passes its param blocks and the whole batch and gets the gradient
    block of each: its backward's, all-reduced over the batch axes."""
    loss, parts, grads = _local_grads(model, params, batch)
    return loss, parts, _batch_sum(list(grads), _batch_axes(batch), model)


def _batch_sum(grads: list, rb, model: Model) -> list:
    """Each gradient all-reduced over the batch axes ``rb`` (none without
    a mesh), in the list's place, one leaf at a time; an FSDP leaf's over
    them less 'data' (its gather's transpose reduce-scattered it over
    'data')."""
    if rb is None:
        return grads
    lay = model.layout()
    lay = T.leaves(lay) if lay is not None else [None] * len(grads)
    rest = tuple(a for a in ((rb,) if isinstance(rb, str) else rb)
                 if a != transformer.FSDP_AXIS)
    for i, g in enumerate(grads):
        axes = (rest or None) if isinstance(lay[i], transformer.Gather) \
            else rb
        if axes is not None:
            grads[i] = psum(g, axes)
    return grads


def _split_axes(model: Model) -> list | None:
    """The mesh axes each param leaf is split over on the current mesh
    (``global_norm`` sums a leaf's squares over them), or None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return [tuple(a for e in ns.spec if e is not None
                  for a in (e if isinstance(e, tuple) else (e,)))
            for ns in T.leaves(model.shardings(mesh))]


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    donate: bool = False) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics {"loss", "ce", "aux", "grad_norm", "lr"} as 0-d tensors.

    cfg.accum_steps > 1 splits the batch's leading axis into that many
    micro-batches, sums their grads in float32 and divides by their count
    (the JAX package's ``lax.scan`` branch: its metrics then hold the mean
    loss as "ce" and an aux of 0); the live activations are those of one
    micro-batch. On a mesh (the module's docstring) the micro-batches come
    from the whole batch, as the JAX package's reshape makes them, before
    a rank takes its rows of each; their summed grads are all-reduced over
    the batch axes once, and the global norm sums each leaf's squares over
    the axes it is split over. ``donate``: the step writes the new params
    and moments into the given ones (``adamw.update``)."""
    accum = model.cfg.accum_steps
    split = {}

    def train_step(params, opt_state, batch):
        mesh = current_mesh()
        if mesh not in split:
            split.clear()
            split[mesh] = _split_axes(model)
        if accum <= 1:
            loss, parts, g = value_and_grad(model, params, batch)
            grads = T.unflatten_like(params, list(g))
        else:
            gsum, lsum = None, None
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss_i, _, g = _local_grads(model, params, mb)
                if gsum is None:
                    gsum = [x.float() for x in g]
                    lsum = loss_i.float()
                else:
                    for acc, x in zip(gsum, g):
                        acc.add_(x)
                    lsum = lsum + loss_i
                del g
            gsum = _batch_sum(gsum, _batch_axes(mb), model)
            grads = T.unflatten_like(params, [x.div_(accum) for x in gsum])
            loss = lsum / accum
            parts = {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                    device=loss.device)}
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params, split=split[mesh],
                                             donate=donate)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, cache, tokens) -> (next_token_logits, cache)."""

    def serve_step(params, cache, tokens):
        return model.decode(params, tokens, cache)

    return serve_step


def make_prefill_step(model: Model) -> Callable:
    """prefill_step(params, cache, tokens, frames=None, patches=None) ->
    (last-position logits, cache); frames reach an enc-dec model, patches a
    vlm (``Model.prefill`` reads neither for any other)."""
    def prefill_step(params, cache, tokens, frames=None, patches=None):
        return model.prefill(params, tokens, cache, frames=frames,
                             patches=patches)

    return prefill_step
