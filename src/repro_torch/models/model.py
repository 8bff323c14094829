"""Model factory: ``build_model(cfg)`` returns a :class:`Model`.

Counterpart of ``repro/models/model.py``.  The port's :class:`Model` is an
``nn.Module`` that holds its parameter tree (the JAX package's keys,
shapes and stacked ``layers`` axis), so its methods take no ``params``
argument:

* ``forward(batch)``            -- logits [B, S, V]
* ``loss(batch, params=None)``  -- (loss, {"ce", "aux"}), differentiable
* ``prefill(batch, extra_cache)``-- (last logits [B, V], cache)
* ``decode(cache, token, pos)`` -- one serving step (writes the cache in place)
* ``specs()``                   -- the ParamSpec tree (:func:`model_specs`)
* ``param_shapes()``, ``input_specs(shape)``, ``cache_specs(shape)`` --
  meta tensors (shape and dtype, no storage) of the parameters, of every
  input of a :class:`ShapeConfig` cell and of its decode cache: the
  dry-run's contract (:mod:`repro_torch.launch.dryrun`), which
  ``dist.sharding.data_shardings``/``cache_shardings`` read too

Every family of the reference is ported: ``dense`` (attention + MLP),
``moe`` (attention + a top-k mixture of experts, whose load-balancing loss
joins the loss), ``ssm`` (Mamba-2), ``hybrid`` (jamba: attention and
Mamba-2 mixers interleaved, MoE on every other layer), ``vlm`` (the dense
path with projected image embeddings scattered into the token stream),
``vit`` (encoder-only, bidirectional attention, a loss of CE alone; no
prefill or decode) and ``audio`` (whisper's encoder-decoder,
:mod:`repro_torch.models.encdec`; its batches carry ``frames``).  An
unknown family raises ``NotImplementedError`` naming ROADMAP.md.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.types import ArchConfig, ShapeConfig
from repro_torch.models import common as cm
from repro_torch.models import encdec as ed
from repro_torch.models import mamba as mb
from repro_torch.models import transformer as tf

_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "vit", "audio")


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters (leaves that require
    grad)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        out: dict = {k: p for k, p in self.named_parameters(recurse=False)}
        for k, m in self.named_children():
            out[k] = m.tree()
        return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)
        self.encoder = cfg.family == "vit"
        self.audio = cfg.family == "audio"

    def param_tree(self) -> dict:
        return self.params.tree()

    def specs(self) -> dict:
        """The ParamSpec tree the parameters follow (``repro``'s
        ``Model.specs()``), which the sharding rules read."""
        return model_specs(self.cfg)

    def param_shapes(self) -> dict:
        return param_shapes(self.cfg)

    def input_specs(self, shape: ShapeConfig) -> dict:
        return input_specs(self.cfg, shape)

    def cache_specs(self, shape: ShapeConfig) -> dict:
        return cache_specs(self.cfg, shape)

    @torch.inference_mode()
    def forward(self, batch: dict) -> torch.Tensor:
        if self.audio:
            return ed.encdec_forward(self.param_tree(), self.cfg, batch)
        return tf.lm_forward(self.param_tree(), self.cfg, batch,
                             causal=not self.encoder)[0]

    def loss(self, batch: dict, params: Optional[dict] = None,
             *, remat: bool = True):
        """(loss, {"ce", "aux"}) on ``params`` (default: the model's own),
        recorded by autograd; ``repro``'s ``Model.loss(p, batch)``.  The
        encoder-only ``vit`` family's loss is the masked CE alone."""
        p = self.param_tree() if params is None else params
        if self.audio:
            return ed.encdec_loss(p, self.cfg, batch, remat=remat)
        if not self.encoder:
            return tf.lm_loss(p, self.cfg, batch, remat=remat)
        h, aux = tf.lm_forward(p, self.cfg, batch, causal=False,
                               remat=remat, logits_out=False)
        ce = tf.hidden_ce(p, self.cfg, h, batch["labels"],
                          batch.get("loss_mask"))
        return ce, {"ce": ce, "aux": aux}

    def _decoder(self, what: str) -> None:
        if self.encoder:
            raise NotImplementedError(
                f"{self.cfg.name}: the encoder-only vit family has no "
                f"{what} (the reference's Model.{what} is None)")

    @torch.inference_mode()
    def prefill(self, batch: dict, extra_cache: int = 0):
        self._decoder("prefill")
        if self.audio:
            return ed.encdec_prefill(self.param_tree(), self.cfg, batch,
                                     extra_cache=extra_cache)
        return tf.lm_prefill(self.param_tree(), self.cfg, batch,
                             extra_cache=extra_cache)

    @torch.inference_mode()
    def decode(self, cache: dict, token: torch.Tensor, pos: int):
        self._decoder("decode")
        if self.audio:
            return ed.encdec_decode(self.param_tree(), self.cfg, cache,
                                    token, pos)
        return tf.lm_decode(self.param_tree(), self.cfg, cache, token, pos)


def model_specs(cfg: ArchConfig) -> dict:
    """The ParamSpec tree of ``cfg``'s parameters."""
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; see "
            "ROADMAP.md")
    return ed.encdec_specs(cfg) if cfg.family == "audio" else tf.lm_specs(cfg)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def param_shapes(cfg: ArchConfig) -> dict:
    """Meta tensors of ``cfg``'s parameter tree (``repro``'s
    ``Model.param_shapes()``)."""
    return cm.tree_map(lambda s: _meta(s.shape, s.dtype), model_specs(cfg))


def _img_tokens(cfg: ArchConfig, seq_len: int) -> int:
    """Static image-token capacity per sample for VLM archs."""
    if not cfg.vision_dim:
        return 0
    cap = cfg.max_image_tokens or min(seq_len // 4, 2048)
    return min(cap, seq_len)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta tensors of every model input of this (arch x shape) cell, the
    reference's ``input_specs`` in the port's dtypes: tokens, labels and
    image positions are int64 (PyTorch's index dtype, where the reference
    has int32), ``image_valid`` int32, frames and image embeddings bf16."""
    B, S = shape.global_batch, shape.seq_len
    i64 = torch.int64
    if shape.kind == "decode":
        return {"token": _meta((B, 1), i64)}
    batch: dict = {"tokens": _meta((B, S), i64)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), i64)
        batch["loss_mask"] = _meta((B, S), torch.float32)
    if cfg.family == "audio":
        batch["frames"] = _meta((B, cfg.frontend_frames, cfg.frontend_dim),
                                torch.bfloat16)
    if cfg.vision_dim:
        K = _img_tokens(cfg, S)
        batch["image_embeds"] = _meta((B, K, cfg.vision_dim), torch.bfloat16)
        batch["image_pos"] = _meta((B, K), i64)
        batch["image_valid"] = _meta((B, K), torch.int32)
    return batch


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta tensors of the decode cache of a cell holding ``seq_len``
    context (the rolling window for SWA archs), in the layout
    ``lm_prefill``/``encdec_prefill`` allocate: per sub-layer of a period
    ``{"k", "v": [reps, B, C, KV, hd]}`` or ``{"conv": [reps, B, W-1, Ch],
    "ssm": [reps, B, h, p, n] float32}``; whisper's ``{"self", "cross"}``
    over its ``num_layers`` decoder layers, the cross cache over the
    frames.  The attention and ``conv`` leaves take the model's dtype."""
    B, S = shape.global_batch, shape.seq_len
    dt = cm.torch_dtype(cfg.dtype)
    clen = tf.kv_cache_len(cfg, S)
    kv = cfg.num_kv_heads
    hd = cfg.hd if cfg.num_heads else 0

    def attn_cache(lead, T):
        return {k: _meta(lead + (B, T, kv, hd), dt) for k in ("k", "v")}

    if cfg.family == "audio":
        L = (cfg.num_layers,)
        return {"self": attn_cache(L, clen),
                "cross": attn_cache(L, cfg.frontend_frames)}
    pk, reps = tf.group_layout(cfg)
    out = {}
    for j, (mixer, _) in enumerate(pk):
        if mixer == "attn":
            out[f"sub{j}"] = attn_cache((reps,), clen)
        else:
            _, nheads, n, conv_ch = mb.dims(cfg)
            out[f"sub{j}"] = {
                "conv": _meta((reps, B, cfg.ssm_conv - 1, conv_ch), dt),
                "ssm": _meta((reps, B, nheads, cfg.ssm_headdim, n),
                             torch.float32)}
    return out


def build_model(cfg: ArchConfig, params: Optional[dict] = None, *,
                device="cuda", seed: int = 0) -> Model:
    """A :class:`Model` for ``cfg`` on ``device``: with ``params`` (e.g. from
    :func:`repro_torch.convert.params_from_numpy`) or initialised from a
    ``torch.Generator`` seeded with ``seed``."""
    specs = model_specs(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = cm.init_params(specs, gen, device)
    want = cm.tree_map(lambda s: tuple(s.shape), specs)
    got = cm.tree_map(lambda x: tuple(x.shape), params)
    if got != want:
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"model's specs:\n got {got}\nwant {want}")
    return Model(cfg, params)
