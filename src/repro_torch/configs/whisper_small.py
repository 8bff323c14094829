"""whisper-small  [audio]  12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865
— enc-dec, conv frontend (stub)  [arXiv:2212.04356; unverified].

The conv/audio frontend is stubbed: ``input_specs()`` provides precomputed
frame embeddings [B, 1500, 768].  Backbone: 12 bidirectional encoder layers
+ 12 decoder layers (self + cross attention), GELU MLP, LayerNorm.
"""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=12,
    frontend_frames=1500,
    frontend_dim=768,
    mlp_act="gelu",
    norm_type="ln",
)
