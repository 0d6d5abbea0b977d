"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000, window 2048.
Pattern (rglru, rglru, lattn): 12 scanned groups of 3 + 2 tail layers.
[arXiv:2402.19427]

long_500k RUNS: RG-LRU state is O(1), local attention cache is a rolling
2048-slot window.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    window=2048,
    rnn_width=4096,
    conv_width=4,
    pattern=("rglru", "rglru", "lattn"),
    rope_theta=10000.0,
    mlp_kind="geglu",
    act="gelu",
    tie_embeddings=True,
    logit_softcap=30.0,
    accum_steps=4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        window=16, rnn_width=64, accum_steps=1)
