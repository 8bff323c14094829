"""Whisper-style encoder-decoder backbone.

Counterpart of ``repro/models/encdec.py``.  The conv/audio frontend is a
stub, as in the reference: the batch carries precomputed frame embeddings
``frames`` [B, F, frontend_dim], which one matrix projects to d_model.
The backbone is ``encoder_layers`` bidirectional encoder layers and
``num_layers`` decoder layers (causal self-attention, cross-attention over
the encoder's output, GELU MLP).  Self-attention uses RoPE (the
reference's departure from Whisper's learned absolute embeddings);
cross-attention is position-free.

Layers are stacked on axis 0 of ``enc_layers`` / ``dec_layers``; a Python
loop over that axis takes the place of ``lax.scan``.  With ``remat`` each
layer runs under ``torch.utils.checkpoint`` (non-reentrant), as
``transformer.lm_forward``'s sub-layers do: a decoder layer recomputes its
cross-attention keys and values from the encoder's output in the backward,
and the encoder's output is an input of every decoder layer's checkpointed
function, so its gradient from every cross-attention reaches the encoder.

Serving cache: ``{"self": {"k", "v": [L, B, S + extra, KV, hd]},
"cross": {"k", "v": [L, B, F, KV, hd]}}``, the reference's tree.  It is
allocated once by :func:`encdec_prefill`; :func:`encdec_decode` writes the
self cache in place and reads the cross cache.

Serving runs Megatron tensor parallelism where
``transformer.sharded_forward`` installs a ``tp`` (the sharded serving
steps, ``train.step.build_prefill_step``): every attention (the
encoder's, the decoder's self- and cross-attention) on this rank's heads,
its caches on its ``kv_heads``, and every MLP on its ``d_ff`` slice, each
region between ``tp.enter`` and ``tp.exit`` as in
``transformer._sublayer_fwd``.  Training does not install one for this
family.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.types import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm
from repro_torch.models.common import ParamSpec, torch_dtype
from repro_torch.models.transformer import (_layer, apply_norm, norm_specs,
                                            unembed)


def _enc_layer_specs(cfg: ArchConfig) -> dict:
    return {"norm1": norm_specs(cfg), "attn": att.attn_specs(cfg),
            "norm2": norm_specs(cfg), "mlp": mlpm.mlp_specs(cfg)}


def _dec_layer_specs(cfg: ArchConfig) -> dict:
    return {"norm1": norm_specs(cfg), "self_attn": att.attn_specs(cfg),
            "norm_c": norm_specs(cfg), "cross_attn": att.attn_specs(cfg),
            "norm2": norm_specs(cfg), "mlp": mlpm.mlp_specs(cfg)}


def encdec_specs(cfg: ArchConfig) -> dict:
    dt = torch_dtype(cfg.dtype)
    return {
        "frontend_proj": ParamSpec((cfg.frontend_dim, cfg.d_model),
                                   ("frames_dim", "embed"), "normal",
                                   dt, (0,)),
        "enc_layers": cm.stack_specs(_enc_layer_specs(cfg),
                                     cfg.encoder_layers),
        "enc_norm": norm_specs(cfg),
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), "embed", dt),
        "dec_layers": cm.stack_specs(_dec_layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_specs(cfg),
        "unembed": ParamSpec((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab"), "normal", dt, (0,)),
    }


def _run(fn, checkpoint: bool, *args):
    if checkpoint:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _tp():
    """The tensor parallelism ``transformer.sharded_forward`` installed on
    this thread, or None."""
    from repro_torch.models import transformer as tf
    return getattr(tf._SHARDED, "value", (None, None, None))[0]


def _attn_region(fn, h):
    """``fn(h)``, an attention on this rank's heads under TP: ``h`` enters
    the model group, the partial outputs are summed over it."""
    tp = _tp()
    if tp is None or not tp.attn:
        return fn(h)
    return tp.exit(fn(tp.enter(h)))


def _mlp(fp, h, cfg: ArchConfig):
    """The MLP, on this rank's ``d_ff`` slice under TP (``b_out``, which is
    not sliced, enters scaled by 1/tp: it is added on every rank before
    the sum)."""
    tp = _tp()
    if tp is None or not tp.ffn:
        return mlpm.mlp(fp, h, cfg)
    if cfg.mlp_act == "gelu":
        fp = dict(fp, b_out=tp.enter(fp["b_out"]) / tp.size)
    return tp.exit(mlpm.mlp(fp, tp.enter(h), cfg))


def _enc_layer(lp, x, cfg: ArchConfig):
    h = apply_norm(lp["norm1"], x, cfg)
    x = x + _attn_region(
        lambda h: att.attention(lp["attn"], h, cfg, causal=False), h)
    h = apply_norm(lp["norm2"], x, cfg)
    return x + _mlp(lp["mlp"], h, cfg)


def encode(p, cfg: ArchConfig, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames [B, F, frontend_dim] -> the encoder's output [B, F, D]."""
    x = frames.to(p["frontend_proj"].dtype) @ p["frontend_proj"]
    checkpoint = remat and torch.is_grad_enabled()
    for lp in cm.unbind_layers(p["enc_layers"]):
        x = _run(_enc_layer, checkpoint, lp, x, cfg)
    return apply_norm(p["enc_norm"], x, cfg)


def _cross_kv(lp, enc_out: torch.Tensor):
    """Cross-attention keys and values [B, F, KV, hd] of one decoder
    layer, each one contiguous matrix product of the encoder's output."""
    return (att._proj(enc_out, lp["cross_attn"]["wk"]),
            att._proj(enc_out, lp["cross_attn"]["wv"]))


def _cross(lp, x, cfg: ArchConfig, kv) -> torch.Tensor:
    h = apply_norm(lp["norm_c"], x, cfg)
    return x + _attn_region(
        lambda h: att.attention(lp["cross_attn"], h, cfg, causal=False,
                                kv_override=kv), h)


def _mlp_block(lp, x, cfg: ArchConfig) -> torch.Tensor:
    h = apply_norm(lp["norm2"], x, cfg)
    return x + _mlp(lp["mlp"], h, cfg)


def _dec_layer(lp, x, enc_out, cfg: ArchConfig):
    h = apply_norm(lp["norm1"], x, cfg)
    x = x + att.attention(lp["self_attn"], h, cfg, causal=True)
    x = _cross(lp, x, cfg, _cross_kv(lp, enc_out))
    return _mlp_block(lp, x, cfg)


def decode_train(p, cfg: ArchConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *, remat: bool = True
                 ) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens`` [B, S] -> final-normed hidden
    states [B, S, D]."""
    x = p["embed"][tokens]
    checkpoint = remat and torch.is_grad_enabled()
    for lp in cm.unbind_layers(p["dec_layers"]):
        x = _run(_dec_layer, checkpoint, lp, x, enc_out, cfg)
    return apply_norm(p["final_norm"], x, cfg)


def encdec_forward(p, cfg: ArchConfig, batch: dict, *,
                   remat: bool = True) -> torch.Tensor:
    """Logits [B, S, V] of the decoder over ``batch["tokens"]`` given
    ``batch["frames"]``."""
    enc_out = encode(p, cfg, batch["frames"], remat=remat)
    x = decode_train(p, cfg, batch["tokens"], enc_out, remat=remat)
    return unembed(p, cfg, x)


def encdec_loss(p, cfg: ArchConfig, batch: dict, *, remat: bool = True):
    """-> (loss, {"ce", "aux"}): the masked-mean cross-entropy; aux is 0."""
    logits = encdec_forward(p, cfg, batch, remat=remat)
    ce = cm.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def encdec_prefill(p, cfg: ArchConfig, batch: dict, *,
                   extra_cache: int = 0):
    """Encode ``batch["frames"]`` and run the decoder over the prompt
    ``batch["tokens"]`` [B, S] -> (last logits [B, V], cache)."""
    enc_out = encode(p, cfg, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    L, F = cfg.num_layers, enc_out.shape[1]
    kv = p["dec_layers"]["self_attn"]["wk"].shape[-2]    # a TP rank's share
    x = p["embed"][tokens]
    cache = {"self": att.new_cache(B, S + extra_cache, cfg, x.dtype,
                                   x.device, layers=L, kv_heads=kv),
             "cross": {k: torch.empty((L, B, F, kv, cfg.hd),
                                      dtype=x.dtype, device=x.device)
                       for k in ("k", "v")}}
    for i, lp in enumerate(cm.unbind_layers(p["dec_layers"])):
        h = apply_norm(lp["norm1"], x, cfg)
        h = _attn_region(lambda h: att.attention_prefill(
            lp["self_attn"], h, cfg, cache_len=S + extra_cache,
            cache=_layer(cache["self"], i))[0], h)
        x = x + h
        cross = _layer(cache["cross"], i)
        for c, kv in zip((cross["k"], cross["v"]), _cross_kv(lp, enc_out)):
            c.copy_(kv)
        x = _cross(lp, x, cfg, (cross["k"], cross["v"]))
        x = _mlp_block(lp, x, cfg)
    x = apply_norm(p["final_norm"], x, cfg)
    return unembed(p, cfg, x[:, -1:])[:, 0], cache


def encdec_decode(p, cfg: ArchConfig, cache: dict, token: torch.Tensor,
                  pos: int):
    """One decode step. token [B, 1]; pos: absolute position (int).  Writes
    the self cache in place; returns (logits [B, V], cache)."""
    x = p["embed"][token]
    for i, lp in enumerate(cm.unbind_layers(p["dec_layers"])):
        h = apply_norm(lp["norm1"], x, cfg)
        h = _attn_region(lambda h: att.attention_decode(
            lp["self_attn"], h, _layer(cache["self"], i), cfg, pos=pos)[0],
            h)
        x = x + h
        h = apply_norm(lp["norm_c"], x, cfg)
        cross = _layer(cache["cross"], i)
        x = x + _attn_region(lambda h: att.attention_decode(
            lp["cross_attn"], h, None, cfg, pos=pos,
            kv_override=(cross["k"], cross["v"])), h)
        x = _mlp_block(lp, x, cfg)
    x = apply_norm(p["final_norm"], x, cfg)
    return unembed(p, cfg, x)[:, 0], cache
