"""Architecture configuration (the port's own copy of ``repro.core.types``).

``ArchConfig`` describes a model architecture with the same fields and
derived properties (and analytic parameter counts, which the cost
model reads) as the JAX package, so a config built on either side names
the same model; ``ShapeConfig`` carries the JAX package's fields (``SHAPES`` its
dry-run cells) and
``ParallelConfig`` those of its fields that the port reads.
``SectionConfig`` is a section of a compound workload;
``HardwareSpec`` the constants the cost model plans with, and ``H100``
the card the port runs on (the JAX package's default, the TPU v5e, is
left out: every cost-model call in the port passes ``hw=``).
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

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports 500K-token decode without a full KV
        cache."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

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

    # --- analytic parameter counts (used by the cost model) --------------- #
    def attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.hd
        p = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            p += (h + 2 * kv) * hd
        return p

    def mlp_params(self) -> int:
        if self.mlp_act == "gelu":
            return 2 * self.d_model * self.d_ff
        return 3 * self.d_model * self.d_ff          # SwiGLU

    def moe_params(self) -> int:
        return self.num_experts * 3 * self.d_model * self.d_ff \
            + self.d_model * self.num_experts

    def mamba_params(self) -> int:
        d_in = self.ssm_expand * self.d_model
        nheads = d_in // self.ssm_headdim
        proj_in = self.d_model * (2 * d_in + 2 * self.ssm_state + nheads)
        conv = (d_in + 2 * self.ssm_state) * self.ssm_conv
        return proj_in + conv + 3 * nheads + d_in * self.d_model

    def layer_params(self, i: int) -> int:
        p = 2 * self.d_model                          # norms
        if self.family == "ssm":
            return p + self.mamba_params()
        if self.is_attn_layer(i):
            p += self.attn_params()
        else:
            p += self.mamba_params()
        if self.is_moe_layer(i):
            p += self.moe_params()
        elif self.d_ff > 0:
            p += self.mlp_params()
        return p

    def total_params(self) -> int:
        body = sum(self.layer_params(i) for i in range(self.num_layers))
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (2 * self.d_model + self.attn_params()
                                         + self.mlp_params())
            enc += self.frontend_dim * self.d_model
        vlm = self.vision_dim * self.d_model if self.vision_dim else 0
        return body + emb + head + enc + vlm + self.d_model

    def active_params(self) -> int:
        """Active (per-token) parameters: all of them unless MoE."""
        if not self.is_moe:
            return self.total_params()
        dense = self.total_params() - sum(
            self.moe_params() for i in range(self.num_layers)
            if self.is_moe_layer(i))
        active_moe = sum(
            self.experts_per_token * 3 * self.d_model * self.d_ff
            + self.d_model * self.num_experts
            for i in range(self.num_layers) if self.is_moe_layer(i))
        return dense + active_moe


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


#: the reference's dry-run cells (``repro/core/types.py::SHAPES``)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ParallelConfig:
    """Per-section training configuration C^s (paper §3.2): the fields of
    the JAX package's that the port reads.  A step runs dp, tp, pp and cp
    above 1 on a section mesh, cp with tp too, and refuses pp with cp (as
    the reference does).
    The reference's ``cp_impl`` picks a kernel tier; the port dispatches
    by device and has none.  ``sequence_parallel`` is an XLA layout knob
    and is not ported either."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    cp: int = 1
    mbs: int = 1            # micro-batch size per DP shard
    fanout: int = 1         # DP^producer * fanout = DP^consumer  (paper eq. 1)
    remat: bool = True
    zero_opt: bool = True   # shard optimizer state over the data axis
    grad_compress: str = "none"   # "none" | "bf16" | "int8"
    # --- CP attention (dist.context; active when cp > 1) ---
    cp_mode: str = "auto"         # "auto" | "ulysses" | "ulysses_mqa" |
    #   "allgather" -- auto picks ulysses when heads divide, else the
    #   comm-model-cheaper of ulysses_mqa / allgather
    cp_overlap_chunks: int = 1    # >1: per-chunk K/V all-to-alls under
    #   ulysses, partial flash outputs merged exactly; must divide S/cp

    @property
    def devices(self) -> int:
        return self.dp * self.tp * self.pp * self.cp

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SectionConfig:
    """A section: a logically independent component with its own C^s."""
    name: str
    arch: ArchConfig
    parallel: ParallelConfig
    trainable: bool = True           # False => forward-only (frozen teacher)
    critical: bool = False           # the critical section (paper §3.2)
    seq_scale: float = 1.0           # e.g. ViT sees 4x the visual tokens
    #                                  the LM consumes (pre-downsampling)

    def replace(self, **kw) -> "SectionConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class HardwareSpec:
    """Per-device constants the cost model plans with.  No default: each
    instance names its device."""
    name: str
    peak_flops_bf16: float           # FLOP/s per device, dense
    hbm_bandwidth: float             # bytes/s per device
    ici_bandwidth: float             # bytes/s per link and direction
    hbm_bytes: int                   # device memory


# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data sheet
# (dense rates, no sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB,
# NVLink 900 GB/s in total, i.e. 450 GB/s per direction.  The rates assume
# the card's full 700 W power limit.
H100 = HardwareSpec(name="h100_sxm", peak_flops_bf16=989e12,
                    hbm_bandwidth=3.35e12, ici_bandwidth=450e9,
                    hbm_bytes=80 * 10**9)
