"""mistral-large-123b [dense] — full attention GQA.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
[hf:mistralai/Mistral-Large-Instruct-2407]

long_500k: SKIPPED (pure full attention — see DESIGN.md §Arch-applicability).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    pattern=("attn",),
    rope_theta=1e6,
    mlp_kind="swiglu",
    accum_steps=2,                 # 123B train cell: bound live activations
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mistral-large-smoke", n_layers=4, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=160, vocab_size=256, accum_steps=1)
