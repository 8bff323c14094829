"""pixtral-12b  [vlm]  40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

Per the assignment the modality frontend is a STUB: ``input_specs()``
delivers precomputed 1024-dim patch embeddings which the backbone projects
and scatters into the token stream.
"""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    vision_dim=1024,
    max_image_tokens=1024,
)
