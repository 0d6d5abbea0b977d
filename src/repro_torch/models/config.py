"""ModelConfig — one dataclass covering all 10 assigned architecture families
(counterpart of ``repro/models/config.py``; ``dtype`` is a ``torch.dtype``).

Frozen, with tuple fields, so a config compares and hashes by value.
"""

from __future__ import annotations

import dataclasses

import torch

VOCAB_PAD = 256  # pad vocab to a multiple (Megatron-style) for TP divisibility


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int | None = None
    norm: str = "rmsnorm"
    act: str = "silu"
    mlp_kind: str = "swiglu"       # swiglu | geglu | mlp
    rope_theta: float = 10000.0    # 0 = no rope (whisper)
    window: int | None = None      # sliding-window size for 'swa'/'lattn'
    attn_kind: str = "gqa"         # gqa | mla
    # MLA (DeepSeek)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    mla_v_dim: int = 128
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    # RG-LRU
    rnn_width: int | None = None
    # repeating mixer pattern: entries attn | swa | mla | mamba | rglru
    pattern: tuple = ("attn",)
    # enc-dec / multimodal stubs
    enc_layers: int = 0
    n_frames: int = 0              # audio stub: encoder frames
    n_patches: int = 0             # vlm stub: image patches
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    param_dtype: str = "bfloat16"
    remat: bool = True
    accum_steps: int = 1
    # Megatron-style sequence parallelism: residual stream sharded over
    # 'model' on S between blocks (training/prefill paths; decode S=1 makes
    # the constraint a no-op via the divisibility fallback)
    seq_shard: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD) * VOCAB_PAD

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def mixer_of(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def mlp_of(self, i: int) -> str:
        if self.family == "ssm":
            return "none"
        if self.n_experts and i >= self.first_k_dense:
            return "moe"
        return "dense"

    def layer_plan(self) -> tuple[int, int, int]:
        """(n_prefix, n_groups, n_tail): prefix = first_k_dense unscanned
        layers; body scanned in groups of len(pattern); tail = remainder."""
        plen = len(self.pattern)
        body = self.n_layers - self.first_k_dense
        return self.first_k_dense, body // plen, body % plen

    def sub_quadratic(self) -> bool:
        """Does the arch support the long_500k decode cell? True when no
        mixer requires an unbounded full-attention cache read (SSM/RG-LRU
        state is O(1); 'swa'/'lattn' caches are window-bounded)."""
        return all(m not in ("attn", "mla") for m in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_padded
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            m = self.mixer_of(i)
            if m in ("attn", "swa", "lattn"):
                hd = self.hd
                total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            elif m == "mla":
                nope, rope, lora, vd = (self.head_dim or 128,
                                        self.qk_rope_dim, self.kv_lora_rank,
                                        self.mla_v_dim)
                total += d * self.n_heads * (nope + rope) + d * (lora + rope) \
                    + lora * self.n_heads * (nope + vd) + self.n_heads * vd * d
            elif m == "mamba":
                di = self.ssm_expand * d
                total += d * (2 * di + 2 * self.ssm_state + di // self.ssm_head_dim) \
                    + di * d
            elif m == "rglru":
                w = self.rnn_width or d
                total += 2 * d * w + 2 * w * w + w * d
            mlp = self.mlp_of(i)
            f = self.d_ff
            if mlp == "dense" and f:
                total += (3 if self.mlp_kind in ("swiglu", "geglu") else 2) * d * f
            elif mlp == "moe":
                fe = self.moe_d_ff or self.d_ff
                total += self.n_experts * 3 * d * fe + d * self.n_experts
                total += self.n_shared_experts * 3 * d * fe
        if self.enc_layers:   # encoder stack + cross-attn in decoder
            hd = self.hd
            total += self.enc_layers * (4 * d * self.n_heads * hd
                                        + 2 * d * self.d_ff)
            total += self.n_layers * 4 * d * self.n_heads * hd  # cross attn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only active experts)."""
        if not self.n_experts:
            return self.param_count()
        fe = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.n_experts_active) * 3 * self.d_model * fe
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.mlp_of(i) == "moe")
        return self.param_count() - n_moe_layers * inactive
