"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper).

Counterpart of ``repro/models/mlp.py``; the activation is taken in float32
and cast back, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import ArchConfig
from repro_torch.models.common import ParamSpec, torch_dtype


def mlp_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    if cfg.mlp_act == "gelu":
        return {
            "w_in": ParamSpec((d, f), ("embed", "mlp"), "normal", dt, (0,)),
            "b_in": ParamSpec((f,), ("mlp",), "zeros", dt),
            "w_out": ParamSpec((f, d), ("mlp", "embed"), "normal", dt, (0,)),
            "b_out": ParamSpec((d,), ("embed_nosplit",), "zeros", dt),
        }
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp"), "normal", dt, (0,)),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), "normal", dt, (0,)),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), "normal", dt, (0,)),
    }


def mlp(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_act == "gelu":
        h = x @ p["w_in"] + p["b_in"]
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ p["w_out"] + p["b_out"]
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]
