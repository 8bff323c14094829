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

``attention_impl(fn)`` installs a full-sequence attention implementation
for the calling thread, as the reference's does for its trace: the train
step and the compound runtime install ``dist.context.cp_attention_impl``
on a context-parallel section, so every self-attention call of the model
runs over the sequence shards without the model knowing about meshes.
The contract is the reference's, ``fn(q, k, v, *, causal, window,
segment_q, segment_kv, scale) -> o``, plus ``fn.positions(S, device)``:
the global positions of this rank's S rows, which RoPE takes (the port's
tensors are the rank's shard, where the reference's are global).  The
setting is per thread, because sections run on worker threads of one
process; :func:`remat_context` carries it into a checkpointed layer's
recompute, which autograd may run on another thread.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.types import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec, torch_dtype


_IMPL = threading.local()


@contextlib.contextmanager
def attention_impl(fn):
    """Install ``fn`` as this thread's full-sequence attention for the
    duration of the context (serving paths are unaffected)."""
    prev = getattr(_IMPL, "fn", None)
    _IMPL.fn = fn
    try:
        yield
    finally:
        _IMPL.fn = prev


def current_impl():
    """The attention implementation installed on this thread, or None."""
    return getattr(_IMPL, "fn", None)


def remat_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute runs
    under the implementation that was installed when the forward ran."""
    return contextlib.nullcontext(), attention_impl(current_impl())


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


def _project_q(p, x, cfg: ArchConfig, positions, rope: bool = True):
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    return cm.apply_rope(q, positions, cfg.rope_theta) if rope else q


def _project_qkv(p, x, cfg: ArchConfig, positions):
    q = _project_q(p, x, cfg, positions)
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return q, cm.apply_rope(k, positions, cfg.rope_theta), v


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


def attention(p, x, cfg: ArchConfig, *, causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None,
              kv_override=None) -> torch.Tensor:
    """Full-sequence attention (causal, or bidirectional for the ViT and
    whisper's encoder). x: [B, S, D].  ``kv_override`` = (k, v)
    [B, T, KV, hd] makes it cross-attention (whisper's decoder over the
    encoder's output; T may differ from S), position-free: q gets no RoPE,
    as the reference's ``rope=False`` (set there exactly where
    ``kv_override`` is) gives.  The reference projects k and v from x and
    then discards them there; here they are not projected, which gives the
    same numbers."""
    B, S, _ = x.shape
    H = cfg.num_heads
    impl = current_impl()
    if kv_override is None:
        positions = (impl.positions(S, x.device) if impl is not None
                     else torch.arange(S, device=x.device))[None, :]
        q, k, v = _project_qkv(p, x, cfg, positions)
    else:                                             # cross-attention
        q = _project_q(p, x, cfg, None, rope=False)
        k, v = kv_override
    q = cm.shard_act(_pad_q_heads(q, cfg), "attn_q")
    if impl is not None:
        o = impl(q, k, v, causal=causal, window=cfg.sliding_window,
                 segment_q=segment_ids, segment_kv=segment_ids, scale=None)
    else:
        o = kops.flash_attention(q, k, v, causal=causal,
                                 window=cfg.sliding_window,
                                 segment_q=segment_ids,
                                 segment_kv=segment_ids)
    o = _unpad_o_heads(cm.shard_act(o, "attn_q"), cfg, H)
    return _out_proj(o, p["wo"])


def new_cache(B: int, cache_len: int, cfg: ArchConfig, dtype, device,
              layers: Optional[int] = None,
              kv_heads: Optional[int] = None) -> dict:
    """Zeroed KV cache, optionally with a leading stacked-layers axis;
    ``kv_heads`` (default ``cfg.num_kv_heads``): a tensor-parallel rank's
    share of the heads."""
    kv = cfg.num_kv_heads if kv_heads is None else kv_heads
    shape = (B, cache_len, kv, cfg.hd)
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


@dataclass(frozen=True)
class SeqSplit:
    """A decode cache whose sequence is split over ``group`` (the serving
    layout of a KV-head count the ``model`` axis does not divide,
    ``dist.sharding.kv_cache_spec``'s flash-decoding split): the rank at
    ``index`` of ``size`` holds slots ``[index * C_loc, (index + 1) *
    C_loc)`` of a cache of ``size * C_loc`` slots."""
    group: Any
    size: int
    index: int


def attention_decode(p, x, cache: Optional[dict], cfg: ArchConfig, *,
                     pos: int, kv_override=None,
                     split: Optional[SeqSplit] = None):
    """One-token decode. x: [B, 1, D]; pos: absolute position (int).
    Writes the new key/value into ``cache`` in place and returns (out,
    cache).  With ``kv_override`` = (k, v), a static cross-attention cache
    (``cache`` is None), q gets no RoPE and the output alone is returned,
    as in the reference.

    ``split``: ``cache`` holds this rank's slice of the slots
    (:class:`SeqSplit`).  The rank whose slice holds the new slot writes
    it; every rank attends over its own slots, and the partial (o, lse)
    of the group's ranks merge exactly (``merge_flash_partials``)."""
    B = x.shape[0]
    if kv_override is not None:                       # cross-attention
        q = _project_q(p, x, cfg, None, rope=False)
        return _attend_full(q, *kv_override, p, cfg, valid=None)
    C_loc = cache["k"].shape[1]
    C = C_loc * (split.size if split is not None else 1)
    off = C_loc * (split.index if split is not None else 0)
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    slot = pos % C
    if off <= slot < off + C_loc:
        cache["k"][:, slot - off] = k[:, 0]
        cache["v"][:, slot - off] = v[:, 0]
    # absolute position of each slot s: pos - ((pos - s) mod C); valid if >= 0
    slots = off + torch.arange(C_loc, device=x.device)
    abs_pos = pos - torch.remainder(pos - slots, C)
    valid = abs_pos >= 0
    if cfg.sliding_window > 0:
        valid &= (pos - abs_pos) < cfg.sliding_window
    if split is None:
        out = _attend_full(q, cache["k"], cache["v"], p, cfg, valid=valid)
        return out, cache
    from repro_torch.kernels.flash_attention import merge_flash_partials
    o, lse = _attend_partial(q, cache["k"], cache["v"], valid)
    o_parts = [torch.empty_like(o) for _ in range(split.size)]
    lse_parts = [torch.empty_like(lse) for _ in range(split.size)]
    dist.all_gather(o_parts, o, group=split.group)
    dist.all_gather(lse_parts, lse, group=split.group)
    o, _ = merge_flash_partials(o_parts, lse_parts)
    return _out_proj(o.to(q.dtype), p["wo"]), cache


def _attend_partial(q, kc, vc, valid):
    """One query's attention over this rank's slots -> (o [B,1,H,D], lse
    [B,1,H]) in float32, the partials a sequence-split decode merges."""
    B, S, H, D = q.shape
    KV = kc.shape[2]
    G = H // KV
    qr = q.reshape(B, S, KV, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qr, kc.float()) * (D ** -0.5)
    logits = logits.masked_fill(~valid, -1e30)
    lse = torch.logsumexp(logits, dim=-1)                     # [B,KV,G,S]
    prob = torch.exp(logits - lse[..., None])
    o = torch.einsum("bkgst,btkd->bskgd", prob, vc.float())
    return (o.reshape(B, S, H, D).contiguous(),
            lse.permute(0, 3, 1, 2).reshape(B, S, H).contiguous())


def _attend_full(q, kc, vc, p, cfg: ArchConfig, valid):
    """Direct (non-flash) attention of a single query over a full cache."""
    B, S, H, D = q.shape
    KV = kc.shape[2]
    G = H // KV
    qr = q.reshape(B, S, KV, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qr, kc.float()) * (D ** -0.5)
    if valid is not None:
        logits = logits.masked_fill(~valid, -1e30)
    prob = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", prob, vc.float())
    o = o.reshape(B, S, H, D).to(q.dtype)
    return _out_proj(o, p["wo"])
