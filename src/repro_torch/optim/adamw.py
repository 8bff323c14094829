"""AdamW with float32 master weights and global-norm clipping.

Counterpart of ``repro/optim/adamw.py``.  The state mirrors the parameter
tree: ``mu``, ``nu`` and ``master`` are float32 trees of the same keys and
shapes.  Unlike the JAX package, whose arrays are immutable, :func:`update`
writes ``mu``, ``nu`` and ``master`` in place under ``torch.no_grad()``
and returns a state holding the same tensors: a student's state at
qwen1.5-0.5b's width is about 5.6 GB, and a second copy per step would
double it.  The new parameters are fresh tensors in the gradients' dtype.
``DonatedStateError``/``check_live`` guard XLA's buffer donation, which
PyTorch has no counterpart of; they are left out (ROADMAP.md, port
conventions).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import torch
import torch.profiler

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor           # scalar int32
    mu: Any                      # float32 tree
    nu: Any                      # float32 tree
    master: Any                  # float32 master weights


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params) -> AdamWState:
    """Zero moments and a float32 copy of ``params`` (never an alias)."""
    with torch.no_grad():
        zeros = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), params)
        return AdamWState(
            torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device),
            zeros, tree_map(torch.clone, zeros),
            tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                     params))


def global_norm(tree) -> torch.Tensor:
    with torch.no_grad():
        return torch.sqrt(torch.stack(
            [x.float().square().sum() for x in tree_leaves(tree)]).sum())


def update(grads, state: AdamWState, lr: Union[torch.Tensor, float],
           cfg: AdamWConfig = AdamWConfig(),
           gnorm: Optional[torch.Tensor] = None):
    """One AdamW step -> (new params in the grads' dtypes, state, grad norm).

    ``gnorm`` overrides the clip norm with a precomputed value (a joint
    norm across sections); passing it with clipping disabled raises, since
    it would be silently ignored.  ``state``'s tensors are updated in
    place (see the module docstring)."""
    if gnorm is not None and cfg.clip_norm <= 0:
        raise ValueError(
            f"adamw.update: gnorm= was passed but clipping is disabled "
            f"(clip_norm={cfg.clip_norm}) — the precomputed joint norm "
            "would be silently ignored; enable clip_norm or drop gnorm=")
    with torch.no_grad(), torch.profiler.record_function("adamw.update"):
        if gnorm is None:
            gnorm = global_norm(grads)
        if cfg.clip_norm > 0:
            scale = torch.where(gnorm > cfg.clip_norm,
                                cfg.clip_norm / gnorm,
                                torch.ones_like(gnorm))
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        step = state.step + 1
        t = step.float()
        bc1 = 1.0 - torch.pow(cfg.b1, t)
        bc2 = 1.0 - torch.pow(cfg.b2, t)
        new = []
        for g, mu, nu, m in zip(tree_leaves(grads), tree_leaves(state.mu),
                                tree_leaves(state.nu),
                                tree_leaves(state.master)):
            gf = g.float() * scale
            mu.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            nu.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
            step_v = (mu / bc1) / ((nu / bc2).sqrt_().add_(cfg.eps))
            m.sub_(lr * (step_v + cfg.weight_decay * m))
            new.append(m.to(g.dtype, copy=True))
        return (tree_unflatten(grads, new),
                AdamWState(step, state.mu, state.nu, state.master), gnorm)
