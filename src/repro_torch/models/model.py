"""Model factory + serve step builders, the port's public modeling API
(counterpart of ``repro/models/model.py``, serving half):

    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(batch, max_len, dtype=torch.float32)
    logits, cache = model.prefill(params, tokens, cache)
    logits, cache = model.decode(params, tokens1, cache)

``init`` returns the param tree alone (the JAX package pairs it with
sharding specs). Served: the dense GQA archs, grok-1 (GQA with MoE and the
logit softcap), deepseek-v2-lite (MLA with MoE and shared experts), mamba2
(SSD blocks) and recurrentgemma (RG-LRU with local attention). ``forward``
returns the summed MoE aux loss beside the logits. Enc-dec and vlm configs
raise NotImplementedError naming ROADMAP A6, and ``loss`` and
``make_train_step`` come with the training slice there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import transformer
from .config import ModelConfig

__all__ = ["Model", "build_model", "make_serve_step", "make_prefill_step"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- init ----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """Params on the generator's device, drawn from it."""
        return transformer.decoder_init(gen, self.cfg)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
        return transformer.decoder_empty_cache(self.cfg, batch, max_len,
                                               dtype, device=device)

    # -- forward -------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, batch: dict):
        """Full-sequence logits (the training forward, without a cache) and
        the aux loss: the MoE layers' Switch losses summed, a 0-d float32
        tensor (0 for a model without MoE)."""
        logits, _, aux = transformer.decoder_forward(params, self.cfg,
                                                     batch["tokens"])
        return logits, aux

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache: dict):
        """Fill the cache with tokens (B, S); logits (B, 1, Vpad) of the
        last position. The cache's tensors are written in place (an SSM
        cache's pos counts the chunk padding, as the JAX package's: ROADMAP
        C7)."""
        logits, cache, _ = transformer.decoder_forward(
            params, self.cfg, tokens, cache=cache, logits_slice=1)
        return logits, cache

    @torch.no_grad()
    def decode(self, params, tokens: torch.Tensor, cache: dict):
        """One decode step; tokens (B, 1)."""
        logits, cache, _ = transformer.decoder_forward(
            params, self.cfg, tokens, cache=cache, logits_slice=1)
        return logits, cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, cache, tokens) -> (next_token_logits, cache)."""

    def serve_step(params, cache, tokens):
        return model.decode(params, tokens, cache)

    return serve_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, cache, tokens):
        return model.prefill(params, tokens, cache)

    return prefill_step
