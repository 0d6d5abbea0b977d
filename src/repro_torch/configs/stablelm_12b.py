"""stablelm-12b [dense] — GQA, large vocab.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-12b]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    pattern=("attn",),
    rope_theta=10000.0,
    mlp_kind="swiglu",
    norm="layernorm",
    accum_steps=4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, accum_steps=1)
