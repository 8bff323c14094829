"""Architecture configuration (the port's own copy of ``repro.core.types``).

``ArchConfig`` describes a model architecture with the same fields and
derived properties as the JAX package, so a config built on either side
names the same model; ``ShapeConfig`` carries the JAX package's fields
and ``ParallelConfig`` those of its fields that the port reads.  Only what
the port uses is kept: the section and hardware types arrive with the
slices that need them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | audio | hybrid | vit
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 = full attention
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- hybrid (jamba): attention every `attn_period` layers at `attn_offset`,
    #     MoE every `moe_period` layers at `moe_offset` ---
    attn_period: int = 0
    attn_offset: int = 0
    moe_period: int = 0
    moe_offset: int = 1
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    frontend_frames: int = 0         # stubbed modality frontend: #frames
    frontend_dim: int = 0            # stubbed modality frontend: embed dim
    # --- VLM (pixtral-style; frontend stubbed) ---
    vision_dim: int = 0              # patch-embedding dim delivered by the stub
    max_image_tokens: int = 0        # static per-batch image-token capacity
    # --- numerics / layer flavor ---
    dtype: str = "bfloat16"
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"          # swiglu | gelu
    norm_type: str = "rms"           # rms | ln
    # --- physical layout (numerics-neutral) ---
    # zero Q-heads appended per KV group, sliced off before the output
    # projection (same math)
    head_pad: int = 0
    # embed/unembed rows appended; padded logits are masked to -1e30
    vocab_pad: int = 0

    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_pad

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period:
            return i % self.attn_period == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.is_moe:
            return False
        if self.moe_period:
            return i % self.moe_period == self.moe_offset
        return True

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


@dataclass(frozen=True)
class ParallelConfig:
    """Per-section training configuration C^s (paper §3.2): the fields of
    the JAX package's that the port reads so far.  Its train steps run
    dp = tp = pp = cp = 1 and raise on anything else (ROADMAP.md, A6),
    which adds the remaining fields."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    cp: int = 1
    mbs: int = 1            # micro-batch size per DP shard
    remat: bool = True
    grad_compress: str = "none"   # "none" | "bf16" | "int8"
