"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB.

32L (enc) + 32L (dec) d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
[arXiv:2212.04356]

input_specs() feeds precomputed frame embeddings (B, 1500, d_model) — the
mel+conv frontend is a stub per the brief. LayerNorm + plain GeLU MLP +
sinusoidal positions (no RoPE). 20 heads don't divide 16-way TP ->
attention replicates, FFN sharded.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    n_frames=1500,
    pattern=("attn",),
    rope_theta=0.0,
    norm="layernorm",
    act="gelu",
    mlp_kind="mlp",
    tie_embeddings=True,
    accum_steps=4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, n_frames=12, accum_steps=1)
