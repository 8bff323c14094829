"""Mamba-2 block (SSD) with chunked-scan training and recurrent decode.

Counterpart of ``repro/models/mamba.py``.  A single input projection
produces (z, x, B, C, dt); (x, B, C) go through a short depthwise causal
conv; the SSD scan runs per head (``kernels.ops.ssd_scan``: the CUDA
kernel on the card); the output is gated by silu(z), RMS-normed and
projected.

Decode cache per layer: ``{"conv": [B, conv_w - 1, conv_ch]`` in the model
dtype, ``"ssm": [B, nheads, headdim, n]`` float32}.  As for attention, the
cache is allocated once (:func:`new_cache`) and prefill and decode write
into it in place.  Unlike the JAX prefill, which calls ``ssd_chunked_jnp``
for the final state, the port's prefill takes it from the kernel too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.types import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_decode_step
from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec, torch_dtype


def dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    n = cfg.ssm_state
    conv_ch = d_in + 2 * n
    return d_in, nheads, n, conv_ch


def mamba_specs(cfg: ArchConfig) -> dict:
    """A_log, D, dt_bias and norm are float32 whatever ``cfg.dtype`` is."""
    d = cfg.d_model
    d_in, nheads, n, conv_ch = dims(cfg)
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * n + nheads),
                             ("embed", "d_inner"), "normal", dt, (0,)),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), ("conv", "d_inner"),
                            "normal", dt, (0,)),
        "conv_b": ParamSpec((conv_ch,), ("d_inner",), "zeros", dt),
        "A_log": ParamSpec((nheads,), ("ssm_heads",), "zeros", f32),
        "D": ParamSpec((nheads,), ("ssm_heads",), "ones", f32),
        "dt_bias": ParamSpec((nheads,), ("ssm_heads",), "zeros", f32),
        "norm": ParamSpec((d_in,), ("d_inner",), "ones", f32),
        "out_proj": ParamSpec((d_in, d), ("d_inner", "embed"),
                              "normal", dt, (0,)),
    }


def _split(zxbcdt, cfg: ArchConfig):
    d_in, nheads, n, _ = dims(cfg)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * n]
    dt_raw = zxbcdt[..., d_in + d_in + 2 * n:]
    return z, xBC, dt_raw


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along seq. xBC [B, S, Ch]; w [W, Ch].

    Returns (out [B, S, Ch], new_state [B, W-1, Ch]).  A sum of W shifted
    products, as in the JAX package: ``F.conv1d`` would go through cuDNN,
    whose default TF32 changes float32 results on the card."""
    W = w.shape[0]
    S = xBC.shape[1]
    xp = torch.cat([xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[-1])),
                    xBC], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    new_state = xp[:, xp.shape[1] - (W - 1):]
    return F.silu(out.float()).to(xBC.dtype), new_state


def _gate_norm_out(p, y, z, cfg: ArchConfig):
    y = cm.rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"],
                    cfg.norm_eps)
    return y @ p["out_proj"]


def mamba(p, x, cfg: ArchConfig, *, cache: Optional[dict] = None):
    """Full-sequence Mamba-2. x: [B, S, D] -> [B, S, D].

    With ``cache`` (tensors of :func:`new_cache`'s shapes for one layer),
    the conv window and the final SSM state are written into it (prefill)."""
    B, S, _ = x.shape
    d_in, nheads, n, _ = dims(cfg)
    z, xBC, dt_raw = _split(x @ p["in_proj"], cfg)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :d_in].unflatten(-1, (nheads, cfg.ssm_headdim))
    Bm = xBC[..., d_in:d_in + n]
    Cm = xBC[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if cache is not None:
        y, state = kops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], return_state=True)
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(state)
    else:
        y = kops.ssd_scan(xs, dt, A, Bm, Cm, p["D"])
    return _gate_norm_out(p, y.reshape(B, S, d_in), z, cfg)


def mamba_decode(p, x, cache: dict, cfg: ArchConfig):
    """One-token decode. x: [B, 1, D]; writes ``cache`` ({"conv", "ssm"})
    in place and returns (out [B, 1, D], cache)."""
    B = x.shape[0]
    d_in, nheads, n, _ = dims(cfg)
    z, xBC, dt_raw = _split(x @ p["in_proj"], cfg)
    window = torch.cat([cache["conv"], xBC], dim=1)          # [B, W, Ch]
    out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC1 = F.silu(out.float()).to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    xt = xBC1[:, :d_in].unflatten(-1, (nheads, cfg.ssm_headdim))
    Bt = xBC1[:, d_in:d_in + n]
    Ct = xBC1[:, d_in + n:]
    dtt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    state, y = ssd_decode_step(cache["ssm"], xt, dtt, A, Bt, Ct, p["D"])
    cache["ssm"].copy_(state)
    return _gate_norm_out(p, y.reshape(B, 1, d_in), z, cfg), cache


def new_cache(B: int, cfg: ArchConfig, dtype, device,
              layers: Optional[int] = None) -> dict:
    """Zeroed decode cache, optionally with a leading stacked-layers axis."""
    d_in, nheads, n, conv_ch = dims(cfg)
    lead = () if layers is None else (layers,)
    return {
        "conv": torch.zeros(lead + (B, cfg.ssm_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (B, nheads, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=device),
    }
