"""ViT encoder section for compound VLM workloads (paper §2.1/§4.1).

Counterpart of ``repro/models/vlm.py``.  The ``pixtral-12b`` arch stubs
its frontend (the backbone consumes precomputed patch embeddings — see
``transformer.embed_tokens``).  This module is the *compound-workload*
ViT: a bidirectional transformer over patch embeddings that forms its own
section, followed by the 4:1 sequence downsampling the paper describes
(Qwen3-VL style) and a projection into the LM's embedding space.  Its
attention is the flash kernel with ``causal=False``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.types import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm
from repro_torch.models.common import ParamSpec, torch_dtype
from repro_torch.models.transformer import apply_norm, norm_specs


def vit_config(*, num_layers=24, d_model=1024, num_heads=16, d_ff=4096,
               patch_dim=768, downsample=4, out_dim=4096,
               name="vit-encoder") -> ArchConfig:
    return ArchConfig(
        name=name, family="vit", num_layers=num_layers, d_model=d_model,
        num_heads=num_heads, num_kv_heads=num_heads, d_ff=d_ff,
        vocab_size=0, head_dim=d_model // num_heads,
        frontend_dim=patch_dim, vision_dim=out_dim,
        # reuse fields: frontend_dim = raw patch dim; vision_dim = LM d_model
        moe_offset=downsample,   # stash the downsample factor
    )


def downsample_factor(cfg: ArchConfig) -> int:
    return cfg.moe_offset or 4


def vit_specs(cfg: ArchConfig) -> dict:
    dt = torch_dtype(cfg.dtype)
    layer = {"norm1": norm_specs(cfg), "attn": att.attn_specs(cfg),
             "norm2": norm_specs(cfg), "mlp": mlpm.mlp_specs(cfg)}
    ds = downsample_factor(cfg)
    return {
        "patch_proj": ParamSpec((cfg.frontend_dim, cfg.d_model),
                                ("frames_dim", "embed"), "normal", dt, (0,)),
        "layers": cm.stack_specs(layer, cfg.num_layers),
        "final_norm": norm_specs(cfg),
        "merge_proj": ParamSpec((cfg.d_model * ds, cfg.vision_dim),
                                ("embed", "vision"), "normal", dt, (0,)),
    }


def _layer_fwd(lp, x, cfg: ArchConfig):
    h = att.attention(lp["attn"], apply_norm(lp["norm1"], x, cfg), cfg,
                      causal=False)
    x = x + h
    return x + mlpm.mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)


def vit_encode(p, cfg: ArchConfig, patches: torch.Tensor, *,
               remat: bool = True) -> torch.Tensor:
    """patches [B, P, patch_dim] -> visual embeddings [B, P/ds, out_dim].

    The ViT attends over the full (long) patch sequence, then merges
    ``ds`` consecutive tokens (pixel-unshuffle style) into one LM-space
    embedding.  Under context parallelism ``patches`` is this rank's
    sequence shard, its attention runs through the installed
    ``attention_impl``, and each rank merges the ``ds`` consecutive tokens
    of its own shard (so the shard must hold a multiple of ``ds``).  With
    ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), as ``transformer.py``'s
    sub-layers do: the flash kernel runs twice per layer in a backward."""
    B, P, _ = patches.shape
    x = cm.shard_act(patches.to(p["patch_proj"].dtype) @ p["patch_proj"],
                     "hidden")
    checkpoint = remat and torch.is_grad_enabled()
    for lp in cm.unbind_layers(p["layers"]):
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                _layer_fwd, lp, x, cfg, use_reentrant=False,
                context_fn=att.remat_context)
        else:
            x = _layer_fwd(lp, x, cfg)
        x = cm.shard_act(x, "hidden")
    x = apply_norm(p["final_norm"], x, cfg)
    ds = downsample_factor(cfg)
    if P % ds:
        raise ValueError(
            f"vit_encode: {P} patches (a sequence shard's, under context "
            f"parallelism) are not a multiple of the downsample factor "
            f"{ds}: the merge would join tokens across a shard boundary")
    x = x.reshape(B, P // ds, ds * cfg.d_model)
    return x @ p["merge_proj"]
