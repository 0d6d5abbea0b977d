"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE.

27L d_model=2048 16H (GQA kv=16 -> MLA) d_ff=1408(expert) vocab=102400,
MoE 64 routed top-6 + 2 shared; first layer dense (d_ff=10944).
[arXiv:2405.04434; hf DeepSeek-V2-Lite]

Note (DESIGN.md): the brief's inline cell lists "64e top-6" as the primary
spec ("160 routed" is V2-full); we follow the cell: 64 routed experts.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,              # qk nope dim
    attn_kind="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    mla_v_dim=128,
    d_ff=10944,                # dense (first_k_dense) layers
    moe_d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_experts_active=6,
    n_shared_experts=2,
    first_k_dense=1,
    pattern=("mla",),
    rope_theta=10000.0,
    mlp_kind="swiglu",
    accum_steps=4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4,
        head_dim=16, kv_lora_rank=32, qk_rope_dim=8, mla_v_dim=16,
        d_ff=128, moe_d_ff=32, vocab_size=256, n_experts=8,
        n_experts_active=2, n_shared_experts=1, first_k_dense=1, accum_steps=1)
