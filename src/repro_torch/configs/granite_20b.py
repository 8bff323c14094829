"""granite-20b  [dense]  52L d_model=6144 48H (GQA kv=1 / MQA) d_ff=24576
vocab=49152 — code model  [arXiv:2405.04324; hf].

d_ff = 4×d_model with a GELU MLP (GPT-BigCode heritage — a SwiGLU at this
d_ff would be a 28B model, not 20B); decoder layout otherwise llama-style
(pre-RMSNorm + RoPE) per the assignment note.
"""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp_act="gelu",
)
