"""Decoder-only LM: specs, forward, prefill and decode.

Counterpart of ``repro/models/transformer.py`` for the families whose
sub-layers are attention + MLP (``dense``) or Mamba-2 with no FFN
(``ssm``).  Layers are grouped as in the JAX package: a group is a period
of sub-layers whose parameters are stacked over the number of repeats (the
``layers`` axis); a Python loop over that axis takes the place of
``lax.scan``.  MoE sub-layers arrive with a later slice (ROADMAP.md, A7)
and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.types import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import mamba as mb
from repro_torch.models import mlp as mlpm
from repro_torch.models.common import ParamSpec, torch_dtype


# --------------------------------------------------------------------------- #
# Norm helpers
# --------------------------------------------------------------------------- #
def norm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    if cfg.norm_type == "ln":
        return {"scale": ParamSpec((d,), ("embed_nosplit",), "ones"),
                "bias": ParamSpec((d,), ("embed_nosplit",), "zeros")}
    return {"scale": ParamSpec((d,), ("embed_nosplit",), "ones")}


def apply_norm(p, x, cfg: ArchConfig):
    if cfg.norm_type == "ln":
        return cm.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return cm.rms_norm(x, p["scale"], cfg.norm_eps)


# --------------------------------------------------------------------------- #
# Layer-kind layout
# --------------------------------------------------------------------------- #
def layer_kinds(cfg: ArchConfig) -> list:
    """Per layer: (mixer, ffn) with mixer in {attn, mamba}, ffn in {mlp, moe,
    None}."""
    kinds = []
    for i in range(cfg.num_layers):
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        if cfg.is_moe_layer(i):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "mlp"
        else:
            ffn = None
        kinds.append((mixer, ffn))
    return kinds


def group_layout(cfg: ArchConfig) -> Tuple[list, int]:
    """Returns (period_kinds, repeats). The whole stack is `repeats` copies
    of `period_kinds`."""
    kinds = layer_kinds(cfg)
    period = cfg.attn_period if cfg.attn_period else 1
    if cfg.moe_period:
        period = math.lcm(period, cfg.moe_period)
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not divide "
                         f"into periods of {period}")
    reps = cfg.num_layers // period
    pk = kinds[:period]
    if any(kinds[r * period:(r + 1) * period] != pk for r in range(reps)):
        raise ValueError(f"{cfg.name}: layer kinds are not periodic")
    return pk, reps


def _check_kind(mixer: str, ffn: Optional[str]) -> None:
    if mixer not in ("attn", "mamba") or ffn not in ("mlp", None):
        raise NotImplementedError(
            f"sub-layer ({mixer}, {ffn}) is not ported yet; see ROADMAP.md, "
            "A7")


def _sublayer_specs(cfg: ArchConfig, mixer: str, ffn: Optional[str]) -> dict:
    _check_kind(mixer, ffn)
    s: dict = {"norm1": norm_specs(cfg)}
    if mixer == "attn":
        s["attn"] = att.attn_specs(cfg)
    else:
        s["mamba"] = mb.mamba_specs(cfg)
    if ffn is not None:
        s["norm2"] = norm_specs(cfg)
        s[ffn] = mlpm.mlp_specs(cfg)
    return s


def lm_specs(cfg: ArchConfig) -> dict:
    dt = torch_dtype(cfg.dtype)
    pk, reps = group_layout(cfg)
    period = {f"sub{j}": _sublayer_specs(cfg, mixer, ffn)
              for j, (mixer, ffn) in enumerate(pk)}
    specs = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), "embed", dt),
        "final_norm": norm_specs(cfg),
        "layers": cm.stack_specs(period, reps),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"), "normal", dt, (0,))
    return specs


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked over the layers axis (views)."""
    return cm.tree_map(lambda x: x[i], tree)


# --------------------------------------------------------------------------- #
# Forward passes
# --------------------------------------------------------------------------- #
def _ffn(lp, x, cfg: ArchConfig, ffn: Optional[str]):
    if ffn is None:
        return x
    return x + mlpm.mlp(lp[ffn], apply_norm(lp["norm2"], x, cfg), cfg)


def embed_tokens(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    return p["embed"][batch["tokens"]]


def _sublayer_fwd(lp, x, cfg: ArchConfig, mixer: str, ffn: Optional[str],
                  segment_ids):
    """One (mixer, ffn) sub-layer; ``repro`` returns (x, aux) and its aux
    is 0 for every sub-layer the port has."""
    h = apply_norm(lp["norm1"], x, cfg)
    if mixer == "attn":
        h = att.attention(lp["attn"], h, cfg, segment_ids=segment_ids)
    else:
        h = mb.mamba(lp["mamba"], h, cfg)
    return _ffn(lp, x + h, cfg, ffn)


def lm_forward(p, cfg: ArchConfig, batch: dict, *, remat: bool = True,
               logits_out: bool = True):
    """Full-sequence causal forward. Returns (logits [B, S, V] or, with
    ``logits_out=False``, the final-normed hidden states [B, S, D]; aux).

    With ``remat`` each sub-layer runs under
    ``torch.utils.checkpoint`` (non-reentrant) in place of
    ``jax.checkpoint``: its activations are recomputed in the backward,
    so the flash or SSD kernel runs twice per layer in a training step.
    Without autograd recording (serving, the frozen teacher) nothing is
    saved and ``remat`` changes nothing."""
    pk, reps = group_layout(cfg)
    x = cm.shard_act(embed_tokens(p, cfg, batch), "hidden")
    segment_ids = batch.get("segment_ids")
    checkpoint = remat and torch.is_grad_enabled()
    # one unbind per leaf: its backward stacks the layers' gradients once,
    # where indexing would add a zero-filled full-size gradient per layer
    layers = cm.tree_map(lambda x: x.unbind(0), p["layers"])
    for r in range(reps):
        period = cm.tree_map(lambda xs: xs[r], layers)
        for j, (mixer, ffn) in enumerate(pk):
            _check_kind(mixer, ffn)
            lp = period[f"sub{j}"]
            if checkpoint:
                x = torch.utils.checkpoint.checkpoint(
                    _sublayer_fwd, lp, x, cfg, mixer, ffn, segment_ids,
                    use_reentrant=False)
            else:
                x = _sublayer_fwd(lp, x, cfg, mixer, ffn, segment_ids)
            x = cm.shard_act(x, "hidden")
    x = apply_norm(p["final_norm"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not logits_out:
        return x, aux
    return unembed(p, cfg, x), aux


def unembed(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embed"].T
    else:
        logits = x @ p["unembed"]
    if cfg.vocab_pad:
        # mask padded vocab slots: exact lse/softmax of the unpadded model
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = logits.masked_fill(~valid, -1e30)
    return cm.shard_act(logits, "logits")


def lm_loss(p, cfg: ArchConfig, batch: dict, *, remat: bool = True,
            aux_weight: float = 0.01):
    """-> (loss, {"ce", "aux"}): masked-mean cross-entropy plus the
    weighted aux loss (0 for the dense family)."""
    logits, aux = lm_forward(p, cfg, batch, remat=remat)
    loss = cm.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# --------------------------------------------------------------------------- #
# Prefill / decode (serving)
# --------------------------------------------------------------------------- #
def kv_cache_len(cfg: ArchConfig, total_len: int) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, total_len)
    return total_len


def lm_prefill(p, cfg: ArchConfig, batch: dict, *, extra_cache: int = 0):
    """Prompt processing. Returns (last-token logits [B, V], cache).

    The cache holds, per sub-layer, ``{"k", "v": [repeats, B, C, KV, hd]}``
    for attention, with C = ``kv_cache_len(cfg, S + extra_cache)``, or
    ``{"conv": [repeats, B, W-1, Ch], "ssm": [repeats, B, h, p, n]}`` for
    Mamba-2; it is allocated once here and written in place by
    :func:`lm_decode`."""
    pk, reps = group_layout(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    clen = kv_cache_len(cfg, S + extra_cache)
    x = embed_tokens(p, cfg, batch)
    caches = {}
    for j, (mixer, ffn) in enumerate(pk):
        _check_kind(mixer, ffn)
        caches[f"sub{j}"] = (
            att.new_cache(B, clen, cfg, x.dtype, x.device, layers=reps)
            if mixer == "attn" else
            mb.new_cache(B, cfg, x.dtype, x.device, layers=reps))
    for r in range(reps):
        period = _layer(p["layers"], r)
        for j, (mixer, ffn) in enumerate(pk):
            lp = period[f"sub{j}"]
            h = apply_norm(lp["norm1"], x, cfg)
            cache = _layer(caches[f"sub{j}"], r)
            if mixer == "attn":
                h, _ = att.attention_prefill(lp["attn"], h, cfg,
                                             cache_len=clen, cache=cache)
            else:
                h = mb.mamba(lp["mamba"], h, cfg, cache=cache)
            x = _ffn(lp, x + h, cfg, ffn)
    x = apply_norm(p["final_norm"], x, cfg)
    logits = unembed(p, cfg, x[:, -1:])[:, 0]
    return logits, caches


def lm_decode(p, cfg: ArchConfig, cache: dict, token: torch.Tensor, pos: int):
    """One decode step. token [B, 1] int; pos: absolute position (int).
    Writes into ``cache`` in place; returns (logits [B, V], cache)."""
    pk, reps = group_layout(cfg)
    x = p["embed"][token]
    for r in range(reps):
        period = _layer(p["layers"], r)
        for j, (mixer, ffn) in enumerate(pk):
            _check_kind(mixer, ffn)
            lp = period[f"sub{j}"]
            h = apply_norm(lp["norm1"], x, cfg)
            layer_cache = _layer(cache[f"sub{j}"], r)
            if mixer == "attn":
                h, _ = att.attention_decode(lp["attn"], h, layer_cache, cfg,
                                            pos=pos)
            else:
                h, _ = mb.mamba_decode(lp["mamba"], h, layer_cache, cfg)
            x = _ffn(lp, x + h, cfg, ffn)
    x = apply_norm(p["final_norm"], x, cfg)
    logits = unembed(p, cfg, x)[:, 0]
    return logits, cache
