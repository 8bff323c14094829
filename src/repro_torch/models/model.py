"""Model factory: ``build_model(cfg)`` returns a :class:`Model`.

Counterpart of ``repro/models/model.py``.  The port's :class:`Model` is an
``nn.Module`` that holds its parameter tree (the JAX package's keys,
shapes and stacked ``layers`` axis), so its methods take no ``params``
argument:

* ``forward(batch)``            -- logits [B, S, V]
* ``loss(batch, params=None)``  -- (loss, {"ce", "aux"}), differentiable
* ``prefill(batch, extra_cache)``-- (last logits [B, V], cache)
* ``decode(cache, token, pos)`` -- one serving step (writes the cache in place)

The ``dense`` (attention + MLP) and ``ssm`` (Mamba-2) families are
ported; every other family raises ``NotImplementedError`` naming its
slice in ROADMAP.md.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.types import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

_PORTED = ("dense", "ssm")
_LATER = {
    "moe": "A7 (MoE)",
    "hybrid": "A7 (jamba: its Mamba-2 layers run, its MoE is not ported)",
    "audio": "A7 (whisper encoder-decoder)",
    "vlm": "A5 (MLLM)",
    "vit": "A5 (MLLM)",
}


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

    def param_tree(self) -> dict:
        return self.params.tree()

    @torch.inference_mode()
    def forward(self, batch: dict) -> torch.Tensor:
        return tf.lm_forward(self.param_tree(), self.cfg, batch)[0]

    def loss(self, batch: dict, params: Optional[dict] = None,
             *, remat: bool = True):
        """(loss, {"ce", "aux"}) on ``params`` (default: the model's own),
        recorded by autograd; ``repro``'s ``Model.loss(p, batch)``."""
        p = self.param_tree() if params is None else params
        return tf.lm_loss(p, self.cfg, batch, remat=remat)

    @torch.inference_mode()
    def prefill(self, batch: dict, extra_cache: int = 0):
        return tf.lm_prefill(self.param_tree(), self.cfg, batch,
                             extra_cache=extra_cache)

    @torch.inference_mode()
    def decode(self, cache: dict, token: torch.Tensor, pos: int):
        return tf.lm_decode(self.param_tree(), self.cfg, cache, token, pos)


def build_model(cfg: ArchConfig, params: Optional[dict] = None, *,
                device="cuda", seed: int = 0) -> Model:
    """A :class:`Model` for ``cfg`` on ``device``: with ``params`` (e.g. from
    :func:`repro_torch.convert.params_from_numpy`) or initialised from a
    ``torch.Generator`` seeded with ``seed``."""
    if cfg.family not in _PORTED:
        later = _LATER.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; see "
            f"ROADMAP.md, {later}")
    specs = tf.lm_specs(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = cm.init_params(specs, gen, device)
    want = cm.tree_map(lambda s: tuple(s.shape), specs)
    got = cm.tree_map(lambda x: tuple(x.shape), params)
    if got != want:
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"model's specs:\n got {got}\nwant {want}")
    return Model(cfg, params)
