"""internvl2-1b [vlm] — InternViT frontend (STUB) + Qwen2-0.5B-style LM.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. [arXiv:2404.16821]

The vision tower is a stub per the brief: input_specs() supplies
precomputed patch embeddings (B, 256, d_model); a linear projector maps
them into the LM embedding space. 14 heads do not divide the 16-way TP
axis -> attention weights replicate, FFN stays sharded (DESIGN.md §5).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    n_patches=256,
    pattern=("attn",),
    rope_theta=1e6,
    mlp_kind="swiglu",
    tie_embeddings=True,
    accum_steps=1,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", n_layers=3, d_model=56, n_heads=7,
        n_kv_heads=1, d_ff=128, vocab_size=256, n_patches=8, accum_steps=1)
