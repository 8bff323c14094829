"""Architecture registry: the ten assigned archs (the port's own copy of
``repro.configs``; the compound workloads arrive with the runtime slice).

``get_config(name)`` returns the full published config;
``get_reduced(name)`` returns a family-preserving shrunken config for CPU
tests (small layers/width/experts/vocab, same layer layout).
"""
from __future__ import annotations

import importlib
import math
from typing import Dict

from repro_torch.core.types import ArchConfig

_MODULES = {
    "granite-20b": "granite_20b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-3-8b": "granite_3_8b",
    "mixtral-8x22b": "mixtral_8x22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-130m": "mamba2_130m",
    "pixtral-12b": "pixtral_12b",
    "whisper-small": "whisper_small",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    """Every assigned arch's full config, keyed by name in
    :data:`ARCH_NAMES` order."""
    return {n: get_config(n) for n in ARCH_NAMES}


def get_reduced(name: str) -> ArchConfig:
    return reduce_config(get_config(name))


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving shrink for CPU tests."""
    period = 1
    if cfg.attn_period:
        period = cfg.attn_period
    if cfg.moe_period:
        period = math.lcm(period, cfg.moe_period)
    layers = max(2, period)
    kv = cfg.num_kv_heads
    heads = cfg.num_heads
    if heads > 0:
        if kv == heads:
            heads, kv = 4, 4
        elif kv == 1:
            heads, kv = 4, 1
        else:
            heads, kv = 4, 2
    kw = dict(
        num_layers=layers,
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32 if heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.is_moe:
        kw["num_experts"] = min(cfg.num_experts, 4)
        kw["experts_per_token"] = min(cfg.experts_per_token, 2)
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
        kw["ssm_headdim"] = 32
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["frontend_frames"] = 16
        kw["frontend_dim"] = 32
    if cfg.vision_dim:
        kw["vision_dim"] = 32
        kw["max_image_tokens"] = 8
    return cfg.replace(**kw)
