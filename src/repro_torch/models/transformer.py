"""Decoder-only LM: specs, forward, prefill and decode.

Counterpart of ``repro/models/transformer.py``: sub-layers are an
attention or Mamba-2 mixer followed by an MLP (``dense``), a
mixture-of-experts FFN (``moe``) or no FFN (``ssm``).  Layers are grouped
as in the JAX package: a group is a period of sub-layers whose parameters
are stacked over the number of repeats (the ``layers`` axis); a Python
loop over that axis takes the place of ``lax.scan``.

VLM archs (``cfg.vision_dim > 0``) additionally scatter projected patch
embeddings (``batch["image_embeds"]``) into the token stream.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.types import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import mamba as mb
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
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
    if mixer not in ("attn", "mamba") or ffn not in ("mlp", "moe", None):
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
        s[ffn] = (moem.moe_specs(cfg) if ffn == "moe"
                  else mlpm.mlp_specs(cfg))
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
    if cfg.vision_dim:
        specs["vision_proj"] = ParamSpec((cfg.vision_dim, cfg.d_model),
                                         ("vision", "embed"), "normal",
                                         dt, (0,))
    return specs


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked over the layers axis (views)."""
    return cm.tree_map(lambda x: x[i], tree)


# --------------------------------------------------------------------------- #
# Forward passes
# --------------------------------------------------------------------------- #
def _ffn(lp, x, cfg: ArchConfig, ffn: Optional[str], *,
         collect_stats: bool = False, tp=None):
    """The residual FFN block -> (x, aux, stats): aux is the MoE
    sub-layer's load-balancing loss, None for an MLP or no FFN; stats its
    router statistics with ``collect_stats`` (else None).  ``tp``: see
    :func:`_sublayer_fwd`."""
    if ffn is None:
        return x, None, None
    h = apply_norm(lp["norm2"], x, cfg)
    tp_ffn = tp is not None and tp.ffn
    aux = stats = None
    whole = _whole_sequence() if ffn == "moe" else None
    if whole is not None:
        h = whole[0](h)
    if ffn == "mlp":
        fp = lp[ffn]
        if tp_ffn:
            if cfg.mlp_act == "gelu":
                # added on every rank before the all-reduce: 1/tp each
                fp = dict(fp, b_out=tp.enter(fp["b_out"]) / tp.size)
            h = tp.enter(h)
        h = mlpm.mlp(fp, h, cfg)
    else:
        out = moem.moe(lp[ffn], h, cfg, return_stats=collect_stats,
                       tp_in=tp.enter if tp_ffn else None)
        h, aux = out[0], out[1]
        if collect_stats:
            stats = out[2]
    if tp_ffn:
        h = tp.exit(h)
    if whole is not None:
        h = whole[1](h)
    return x + h, aux, stats


def _whole_sequence():
    """Under context parallelism (an installed attention implementation
    with ``whole_sequence``): the (gather, own columns) pair that runs a
    layer over the whole sequence -- a Mamba mixer, whose scan carries
    state from one sequence shard into the next, and a MoE layer, whose
    per-sample capacity counts the sample's every token.  None
    otherwise."""
    impl = att.current_impl()
    if getattr(impl, "whole_sequence", None) is None:
        return None
    return impl.whole_sequence, impl.own_columns


def _slot_offset(shard_len: int, device):
    """The global position of this rank's first token: under context
    parallelism (an installed attention implementation) its sequence
    shard's, else 0."""
    impl = att.current_impl()
    if impl is None:
        return 0
    return impl.positions(shard_len, device)[0]


def vision_scatter(p, cfg: ArchConfig, x: torch.Tensor,
                   batch: dict) -> torch.Tensor:
    """Replace the token embeddings at the valid image slots
    (``image_pos`` [B, K] where ``image_valid`` [B, K] is 1) with the
    projected ``image_embeds`` [B, K, vision_dim]: an out-of-place
    ``index_put(accumulate=True)`` of ``upd - cur * valid``, the
    reference's ``x.at[b, pos].add(...)`` (invalid slots add exactly 0).

    ``x`` may be a sequence shard [B, S/cp, D] (context parallelism): the
    image slots stay global, and the shard takes those whose position
    falls inside it, shifted by its first position (:func:`_slot_offset`);
    a slot outside is invalid here and adds 0, so the cotangent of
    ``image_embeds`` sums over the sequence ranks to the whole one."""
    if not (cfg.vision_dim and "image_embeds" in batch):
        return x
    vh = batch["image_embeds"].to(x.dtype) @ p["vision_proj"]
    pos = batch["image_pos"].long() - _slot_offset(x.shape[1], x.device)
    inside = (pos >= 0) & (pos < x.shape[1])
    valid = (batch["image_valid"].to(x.dtype)
             * inside.to(x.dtype))[..., None]                    # [B,K,1]
    pos = torch.where(inside, pos, torch.zeros_like(pos))
    b_ix = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(pos)
    upd = vh * valid
    cur = x[b_ix, pos]
    return x.index_put((b_ix, pos), upd - cur * valid, accumulate=True)


def vocab_rows(table: torch.Tensor, tokens: torch.Tensor,
               off: int) -> torch.Tensor:
    """The rows of an embedding lookup that fall in this rank's vocabulary
    slice ``table`` (rows ``[off, off + Vs)`` of the whole), the others 0:
    the lookup is their sum over the slices, exact because each row lives
    in one."""
    tok = tokens.long()
    vs = table.shape[0]
    x = table[(tok - off).clamp(0, vs - 1)]
    mine = ((tok >= off) & (tok < off + vs)).to(x.dtype)
    return x * mine[..., None]


def _tp():
    return getattr(_SHARDED, "value", (None, None, None))[0]


def embed_tokens(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The token embeddings, image embeddings spliced in.  Under
    :func:`sharded_forward`'s vocab-parallel ``tp`` with tied embeddings,
    ``p["embed"]`` is this rank's vocabulary slice: each rank looks up its
    rows (:func:`vocab_rows`) and the model group sums them."""
    tp = _tp()
    if tp is not None and tp.vocab and cfg.tie_embeddings:
        x = tp.exit(vocab_rows(p["embed"], batch["tokens"],
                               tp.vocab_offset(p["embed"].shape[0])))
    else:
        x = p["embed"][batch["tokens"]]
    return vision_scatter(p, cfg, x, batch)


def _sublayer_fwd(lp, x, cfg: ArchConfig, mixer: str, ffn: Optional[str],
                  segment_ids, causal: bool = True,
                  collect_stats: bool = False, tp=None):
    """One (mixer, ffn) sub-layer -> (x, aux), as the reference's; aux is
    the MoE loss, and None (the reference's constant 0) for a sub-layer
    without a router.  With ``collect_stats`` (MoE sub-layers) -> (x, aux,
    stats), the [2, E] router statistics of ``moe(..., return_stats=
    True)``, the linear quantities an exact aux over a split batch is
    rebuilt from.

    ``tp`` (a ``dist.pipeline.TensorParallel``): Megatron tensor
    parallelism.  The caller passes this rank's ``heads``/``kv_heads``
    slices of the attention weights (``tp.attn``) and its ``mlp`` slices
    of the FFN weights (``tp.ffn``); each region's output is then a
    partial sum, all-reduced by ``tp.exit``, and its input enters through
    ``tp.enter``.  Mamba mixers stay whole.

    Under context parallelism a Mamba mixer and a MoE layer run over the
    whole sequence (:func:`_whole_sequence`)."""
    h = apply_norm(lp["norm1"], x, cfg)
    if mixer == "attn":
        tp_attn = tp is not None and tp.attn
        h = att.attention(lp["attn"], tp.enter(h) if tp_attn else h, cfg,
                          causal=causal, segment_ids=segment_ids)
        if tp_attn:
            h = tp.exit(h)
    else:
        whole = _whole_sequence()
        h = (whole[1](mb.mamba(lp["mamba"], whole[0](h), cfg))
             if whole is not None else mb.mamba(lp["mamba"], h, cfg))
    x, aux, stats = _ffn(lp, x + h, cfg, ffn, collect_stats=collect_stats,
                         tp=tp)
    if collect_stats:
        return x, aux, stats
    return x, aux


_SHARDED = threading.local()


@contextlib.contextmanager
def sharded_forward(*, tp=None, stats_mean: Optional[Callable] = None,
                    kv_split: Optional[att.SeqSplit] = None):
    """Install, for this thread's :func:`lm_forward`, :func:`lm_prefill`
    and :func:`lm_decode` calls, Megatron tensor parallelism (``tp``, see
    :func:`_sublayer_fwd`; the caller passes the rank's slices of the
    parameters) and ``stats_mean``, which averages a MoE layer's router
    statistics over the ranks that split the batch (its data and sequence
    ranks), so that each layer's aux is the reference's over the
    micro-batch's global rows.  ``kv_split``: :func:`lm_decode`'s attention
    caches hold this rank's slice of the sequence
    (``models.attention.SeqSplit``).  Checkpointed layers get ``tp`` as an
    argument, so a recompute on another thread runs under it too."""
    prev = getattr(_SHARDED, "value", (None, None, None))
    _SHARDED.value = (tp, stats_mean, kv_split)
    try:
        yield
    finally:
        _SHARDED.value = prev


def aux_from_stats(stats: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A MoE layer's load-balancing loss ``E * sum(frac * prob) / K`` from
    its [2, E] router statistics (``moe``'s aux on the same rows)."""
    return cfg.num_experts * torch.sum(stats[0] * stats[1]) \
        / cfg.experts_per_token


def lm_forward(p, cfg: ArchConfig, batch: dict, *, causal: bool = True,
               remat: bool = True, logits_out: bool = True):
    """Full-sequence forward, causal unless ``causal=False`` (the ``vit``
    family). Returns (logits [B, S, V] or, with ``logits_out=False``, the
    final-normed hidden states [B, S, D]; aux).

    With ``remat`` each sub-layer runs under
    ``torch.utils.checkpoint`` (non-reentrant) in place of
    ``jax.checkpoint``: its activations are recomputed in the backward,
    so the flash or SSD kernel runs twice per layer in a training step.
    Without autograd recording (serving, the frozen teacher) nothing is
    saved and ``remat`` changes nothing.

    aux is the sum of every MoE sub-layer's load-balancing loss (0 for a
    model without one), as the reference's scan sums it.  Under a
    vocab-parallel ``tp`` (:func:`sharded_forward`) the output layer is a
    vocabulary slice: take ``logits_out=False`` and :func:`hidden_ce`."""
    pk, _ = group_layout(cfg)
    tp, stats_mean, _ = getattr(_SHARDED, "value", (None, None, None))
    x = cm.shard_act(embed_tokens(p, cfg, batch), "hidden")
    segment_ids = batch.get("segment_ids")
    checkpoint = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for period in cm.unbind_layers(p["layers"]):
        for j, (mixer, ffn) in enumerate(pk):
            _check_kind(mixer, ffn)
            lp = period[f"sub{j}"]
            stats = stats_mean is not None and ffn == "moe"
            args = (lp, x, cfg, mixer, ffn, segment_ids, causal, stats, tp)
            if checkpoint:
                out = torch.utils.checkpoint.checkpoint(
                    _sublayer_fwd, *args, use_reentrant=False,
                    context_fn=att.remat_context)
            else:
                out = _sublayer_fwd(*args)
            x, a = out[0], out[1]
            if stats:
                a = aux_from_stats(stats_mean(out[2]), cfg)
            x = cm.shard_act(x, "hidden")
            if a is not None:
                aux = aux + a
    x = apply_norm(p["final_norm"], x, cfg)
    if not logits_out:
        return x, aux
    if tp is not None and tp.vocab:
        raise ValueError(
            "lm_forward under a vocab-parallel tp holds one slice of the "
            "output layer: take logits_out=False and hidden_ce")
    return unembed(p, cfg, x), aux


def unembed(p, cfg: ArchConfig, x: torch.Tensor, *,
            offset: int = 0) -> torch.Tensor:
    """Logits of the output layer in ``p`` (``embed`` tied, else
    ``unembed``), whose first vocabulary row is ``offset`` (a slice of the
    vocabulary, or the whole at 0), padded rows masked."""
    if cfg.tie_embeddings:
        logits = x @ p["embed"].T
    else:
        logits = x @ p["unembed"]
    if cfg.vocab_pad:
        # mask padded vocab slots: exact lse/softmax of the unpadded model
        valid = offset + torch.arange(logits.shape[-1],
                                      device=x.device) < cfg.vocab_size
        logits = logits.masked_fill(~valid, -1e30)
    return cm.shard_act(logits, "logits")


def output_layer(p, cfg: ArchConfig) -> torch.Tensor:
    """The whole output layer [D, V] (``embed.T`` tied, else
    ``unembed``); under :func:`sharded_forward`'s vocab-parallel ``tp``
    gathered from the model ranks' slices (``tp.gather_vocab``), its
    gradient summed back into each rank's slice."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    tp = _tp()
    return tp.gather_vocab(w) if tp is not None and tp.vocab else w


def hidden_ce(p, cfg: ArchConfig, h: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked-mean cross-entropy of the final-normed hidden ``h``.
    Under :func:`sharded_forward`'s vocab-parallel ``tp`` each model rank
    forms only its slice's logits, ``h`` enters the region through
    ``tp.enter`` (its gradient summed over the group) and the slices
    combine in ``tp.nll`` (``dist.pipeline.vocab_parallel_nll``)."""
    tp = _tp()
    if tp is None or not tp.vocab:
        return cm.cross_entropy(unembed(p, cfg, h), labels, mask)
    w = p["embed"] if cfg.tie_embeddings else p["unembed"].T
    logits = unembed(p, cfg, tp.enter(h),
                     offset=tp.vocab_offset(w.shape[0])).float()
    return cm.masked_mean(tp.nll(logits, labels), mask)


def lm_loss(p, cfg: ArchConfig, batch: dict, *, remat: bool = True,
            aux_weight: float = 0.01):
    """-> (loss, {"ce", "aux"}): masked-mean cross-entropy plus the
    weighted aux loss (the MoE load-balancing loss; 0 without a router)."""
    h, aux = lm_forward(p, cfg, batch, remat=remat, logits_out=False)
    loss = hidden_ce(p, cfg, h, batch["labels"], batch.get("loss_mask"))
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
    :func:`lm_decode`.  A MoE sub-layer takes its capacity at this call's
    S, as the reference's ``_sublayer_prefill`` does.

    Under :func:`sharded_forward`'s ``tp`` (the serving step builders,
    ``train.step.build_prefill_step``), attention that passes the TP gates
    runs on this rank's heads and fills its ``kv_heads`` slice of the
    cache, and the FFN on its ``d_ff`` slice; Mamba mixers stay whole."""
    pk, reps = group_layout(cfg)
    tp = getattr(_SHARDED, "value", (None, None, None))[0]
    tp_attn = tp is not None and tp.attn
    tokens = batch["tokens"]
    B, S = tokens.shape
    clen = kv_cache_len(cfg, S + extra_cache)
    x = embed_tokens(p, cfg, batch)
    caches = {}
    for j, (mixer, ffn) in enumerate(pk):
        _check_kind(mixer, ffn)
        caches[f"sub{j}"] = (
            att.new_cache(B, clen, cfg, x.dtype, x.device, layers=reps,
                          kv_heads=p["layers"][f"sub{j}"]["attn"]["wk"]
                          .shape[-2])
            if mixer == "attn" else
            mb.new_cache(B, cfg, x.dtype, x.device, layers=reps))
    for r in range(reps):
        period = _layer(p["layers"], r)
        for j, (mixer, ffn) in enumerate(pk):
            lp = period[f"sub{j}"]
            h = apply_norm(lp["norm1"], x, cfg)
            cache = _layer(caches[f"sub{j}"], r)
            if mixer == "attn":
                h, _ = att.attention_prefill(
                    lp["attn"], tp.enter(h) if tp_attn else h, cfg,
                    cache_len=clen, cache=cache)
                if tp_attn:
                    h = tp.exit(h)
            else:
                h = mb.mamba(lp["mamba"], h, cfg, cache=cache)
            x = _ffn(lp, x + h, cfg, ffn, tp=tp)[0]
    x = apply_norm(p["final_norm"], x, cfg)
    logits = unembed(p, cfg, x[:, -1:])[:, 0]
    return logits, caches


def lm_decode(p, cfg: ArchConfig, cache: dict, token: torch.Tensor, pos: int):
    """One decode step. token [B, 1] int; pos: absolute position (int).
    Writes into ``cache`` in place; returns (logits [B, V], cache).  A MoE
    sub-layer's capacity at S = 1 is K slots an expert, so decode drops no
    token.  Under :func:`sharded_forward`, ``tp`` as in :func:`lm_prefill`,
    and ``kv_split``: each attention cache holds this rank's slice of the
    sequence, attended there and merged over the split's group."""
    pk, reps = group_layout(cfg)
    tp, _, kv_split = getattr(_SHARDED, "value", (None, None, None))
    tp_attn = tp is not None and tp.attn
    x = p["embed"][token]
    for r in range(reps):
        period = _layer(p["layers"], r)
        for j, (mixer, ffn) in enumerate(pk):
            _check_kind(mixer, ffn)
            lp = period[f"sub{j}"]
            h = apply_norm(lp["norm1"], x, cfg)
            layer_cache = _layer(cache[f"sub{j}"], r)
            if mixer == "attn":
                h, _ = att.attention_decode(
                    lp["attn"], tp.enter(h) if tp_attn else h, layer_cache,
                    cfg, pos=pos, split=kv_split)
                if tp_attn:
                    h = tp.exit(h)
            else:
                h, _ = mb.mamba_decode(lp["mamba"], h, layer_cache, cfg)
            x = _ffn(lp, x + h, cfg, ffn, tp=tp)[0]
    x = apply_norm(p["final_norm"], x, cfg)
    logits = unembed(p, cfg, x)[:, 0]
    return logits, cache
