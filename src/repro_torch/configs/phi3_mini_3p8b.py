"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA (kv == heads).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064. [arXiv:2404.14219]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    pattern=("attn",),
    rope_theta=10000.0,
    mlp_kind="swiglu",
    accum_steps=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi3-smoke", n_layers=3, d_model=48, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab_size=256, accum_steps=1)
