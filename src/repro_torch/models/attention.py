"""GQA attention with RoPE, optional QKV bias, sliding window, KV cache.

Counterpart of ``repro/models/attention.py``.  Three entry points:

* ``attention``         -- full-sequence (prefill / forward); flash kernel.
* ``attention_prefill`` -- full-sequence + writes the KV cache.
* ``attention_decode``  -- one new token against a (possibly rolling) cache.

Cache layout (per layer): ``{"k": [B, C, KV, hd], "v": [B, C, KV, hd]}``
where C = cache capacity (= prompt + generated length, or the sliding
window for SWA archs).  Keys are stored post-RoPE.

Unlike the JAX package, whose arrays are immutable, the cache is allocated
once (by the caller, or here when it passes none) and both prefill and
decode write into it in place; ``attention_decode`` returns the same
tensors it was given.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.types import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec, torch_dtype


def attn_specs(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = torch_dtype(cfg.dtype)
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"),
                        "normal", dt, (0,)),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        "normal", dt, (0,)),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        "normal", dt, (0,)),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        "normal", dt, (0, 1)),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros", dt)
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros", dt)
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros", dt)
    return specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * k, d)


def _project_qkv(p, x, cfg: ArchConfig, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _pad_q_heads(q, cfg: ArchConfig):
    """Append cfg.head_pad zero Q-heads, preserving KV-group layout; they
    are sliced off again before the output projection (same math)."""
    if not cfg.head_pad:
        return q
    B, S, H, D = q.shape
    KV = cfg.num_kv_heads
    G = H // KV
    Gp = (H + cfg.head_pad) // KV
    qg = F.pad(q.reshape(B, S, KV, G, D), (0, 0, 0, Gp - G))
    return qg.reshape(B, S, KV * Gp, D)


def _unpad_o_heads(o, cfg: ArchConfig, H: int):
    if not cfg.head_pad:
        return o
    B, S, Hp, D = o.shape
    KV = cfg.num_kv_heads
    G = H // KV
    og = o.reshape(B, S, KV, Hp // KV, D)[:, :, :, :G]
    return og.reshape(B, S, H, D)


def attention(p, x, cfg: ArchConfig, *,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal attention. x: [B, S, D]."""
    B, S, _ = x.shape
    H = cfg.num_heads
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = cm.shard_act(_pad_q_heads(q, cfg), "attn_q")
    o = kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                             segment_q=segment_ids, segment_kv=segment_ids)
    o = _unpad_o_heads(cm.shard_act(o, "attn_q"), cfg, H)
    return _out_proj(o, p["wo"])


def new_cache(B: int, cache_len: int, cfg: ArchConfig, dtype, device,
              layers: Optional[int] = None) -> dict:
    """Zeroed KV cache, optionally with a leading stacked-layers axis."""
    shape = (B, cache_len, cfg.num_kv_heads, cfg.hd)
    if layers is not None:
        shape = (layers,) + shape
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(p, x, cfg: ArchConfig, *, cache_len: int,
                      cache: Optional[dict] = None):
    """Causal attention over the prompt; returns (out, cache).

    cache_len -- cache capacity.  For SWA archs this may be < S: the cache
    keeps only the trailing ``cache_len`` positions (rolling layout: slot =
    pos % cache_len).  ``cache`` -- tensors of [B, cache_len, KV, hd] to
    write into (zeroed ones are allocated when it is None)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = cm.shard_act(_pad_q_heads(q, cfg), "attn_q")
    o = kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    o = _unpad_o_heads(cm.shard_act(o, "attn_q"), cfg, H)
    out = _out_proj(o, p["wo"])
    if cache is None:
        cache = new_cache(B, cache_len, cfg, k.dtype, x.device)
    if cache_len >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    else:
        # rolling window: keep the last cache_len keys at slot pos % cache_len
        shift = S % cache_len
        cache["k"].copy_(torch.roll(k[:, S - cache_len:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - cache_len:], shift, dims=1))
    return out, cache


def attention_decode(p, x, cache: dict, cfg: ArchConfig, *, pos: int):
    """One-token decode. x: [B, 1, D]; pos: absolute position (int).
    Writes the new key/value into ``cache`` in place."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    slot = pos % C
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    # absolute position of each slot s: pos - ((pos - s) mod C); valid if >= 0
    slots = torch.arange(C, device=x.device)
    abs_pos = pos - torch.remainder(pos - slots, C)
    valid = abs_pos >= 0
    if cfg.sliding_window > 0:
        valid &= (pos - abs_pos) < cfg.sliding_window
    out = _attend_full(q, cache["k"], cache["v"], p, cfg, valid=valid)
    return out, cache


def _attend_full(q, kc, vc, p, cfg: ArchConfig, valid):
    """Direct (non-flash) attention of a single query over a full cache."""
    B, S, H, D = q.shape
    KV = kc.shape[2]
    G = H // KV
    qr = q.reshape(B, S, KV, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qr, kc.float()) * (D ** -0.5)
    logits = logits.masked_fill(~valid, -1e30)
    prob = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", prob, vc.float())
    o = o.reshape(B, S, H, D).to(q.dtype)
    return _out_proj(o, p["wo"])
