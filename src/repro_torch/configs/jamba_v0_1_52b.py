"""jamba-v0.1-52b  [hybrid]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Layer layout: period-8 blocks with attention at offset 4 (1 attn : 7 mamba),
MoE on every second layer (offset 1).  SSM layers use the Mamba substrate
(d_state=16, expand=2, conv=4 as in Jamba).
"""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    num_experts=16,
    experts_per_token=2,
    attn_period=8,
    attn_offset=4,
    moe_period=2,
    moe_offset=1,
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
)
