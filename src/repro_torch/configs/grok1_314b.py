"""grok-1-314b [moe] — 8 experts top-2, GQA, logit softcap.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
[hf:xai-org/grok-1]

long_500k: SKIPPED (full attention). Optimizer moments run bf16 at this
scale (DESIGN.md §5).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    moe_d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    n_experts_active=2,
    pattern=("attn",),
    rope_theta=10000.0,
    mlp_kind="geglu",
    logit_softcap=30.0,
    accum_steps=4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="grok1-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, moe_d_ff=96, vocab_size=256,
        n_experts=4, n_experts_active=2, accum_steps=1)
