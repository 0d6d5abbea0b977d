"""mamba2-1.3b [ssm] — SSD, attention-free. [arXiv:2405.21060]

48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128; d_inner=2*d=4096,
headdim=64 -> 64 SSD heads. No MLP (d_ff=0): the SSD block IS the layer.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    chunk=256,
    pattern=("mamba",),
    norm="rmsnorm",
    tie_embeddings=True,
    accum_steps=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=4, d_model=64, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, chunk=16, accum_steps=1)
