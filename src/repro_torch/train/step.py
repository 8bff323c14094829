"""The single-device train step: loss, backward, micro-batch gradient
accumulation, AdamW.

Counterpart of ``repro/train/step.py::build_train_step`` in its plain
regime on one device: the global batch is split into
``num_microbatches`` micro-batches (the JAX package's shard-major layout
with ``dp_total = 1``), each micro-batch's gradient is accumulated in
float32, and one ``adamw.update`` follows.  PyTorch runs eagerly, so there
is no jit and no sharding tree; ``step`` is a plain function.  Data,
tensor, pipeline and context parallelism and gradient compression are
not ported yet and raise (ROADMAP.md, A6).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.types import ParallelConfig, ShapeConfig
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim import adamw, schedules


def check_single_device(parallel: ParallelConfig, what: str) -> None:
    """Raise for every ParallelConfig knob the port does not run yet."""
    multi = {k: getattr(parallel, k) for k in ("dp", "tp", "pp", "cp")
             if getattr(parallel, k) != 1}
    if multi:
        raise NotImplementedError(
            f"{what}: {multi} needs the multi-device regimes, which are not "
            "ported yet; see ROADMAP.md, A6")
    if (parallel.grad_compress or "none") != "none":
        raise NotImplementedError(
            f"{what}: grad_compress={parallel.grad_compress!r} is not ported "
            "yet; see ROADMAP.md, A6")


def num_microbatches(shape: ShapeConfig, parallel: ParallelConfig) -> int:
    """Gradient-accumulation depth for this shape on one device.

    Raises when the global batch cannot be laid out as ``[n_micro, mbs]``,
    rather than train on duplicated data."""
    denom = parallel.mbs
    if shape.global_batch > denom and shape.global_batch % denom:
        raise ValueError(
            f"global_batch={shape.global_batch} is not a multiple of "
            f"dp_total*mbs=1*{parallel.mbs}: grad accumulation would train "
            "on duplicated data with an inflated effective batch; adjust "
            "ShapeConfig.global_batch or ParallelConfig.mbs")
    return max(shape.global_batch // denom, 1)


def _split_microbatches(batch: dict, n_micro: int, dp_total: int = 1):
    """[GB, ...] -> a list of ``n_micro`` batches of [GB / n_micro, ...],
    shard-major as in the JAX package (contiguous when ``dp_total`` is 1).
    Raises on batches that do not divide."""
    def split(x):
        gb = x.shape[0]
        mgb = gb // n_micro
        per = mgb // dp_total
        if per == 0 or gb % n_micro or mgb % dp_total:
            raise ValueError(
                f"cannot split batch dim {gb} into {n_micro} microbatches "
                f"× {dp_total} DP shards: global_batch must be a multiple "
                "of dp_total*mbs")
        y = x.reshape((dp_total, n_micro, per) + x.shape[1:])
        return y.transpose(0, 1).reshape((n_micro, mgb) + x.shape[1:])
    split_tree = tree_map(split, batch)
    return [tree_map(lambda x: x[i], split_tree) for i in range(n_micro)]


def accumulate_and_update(loss_fn: Callable, params: dict,
                          opt_state: adamw.AdamWState, batch: dict,
                          step_idx, *, n_micro: int, lr_fn: Callable,
                          opt_cfg: adamw.AdamWConfig):
    """``loss_fn(params, mb) -> (loss, metrics)`` over the micro-batches of
    ``batch``: float32 gradient accumulation, then one AdamW update.

    Returns (new params, optimizer state, metrics) with metrics ``loss``,
    ``grad_norm`` and ``lr`` plus the micro-batch mean of every scalar
    ``loss_fn`` reports.  The new parameters are fresh leaves that
    require grad, ready for the next step."""
    leaves = tree_leaves(params)
    if not all(x.requires_grad for x in leaves):
        raise ValueError("the train step differentiates with respect to the "
                         "parameter tree: its leaves must require grad")
    mbs = [batch] if n_micro == 1 else _split_microbatches(batch, n_micro)
    g_acc, sums = None, {}
    for mb in mbs:
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            if n_micro == 1:
                g_acc = list(grads)
            elif g_acc is None:
                g_acc = [g.float() for g in grads]
            else:
                for a, g in zip(g_acc, grads):
                    a.add_(g.float())
            for k, v in {"loss": loss, **metrics}.items():
                sums[k] = sums.get(k, 0.0) + v.detach().float()
        del loss, metrics, grads
    if n_micro > 1:
        with torch.no_grad():
            g_acc = [(a / n_micro).to(p.dtype) for a, p in zip(g_acc, leaves)]
    lr = lr_fn(step_idx)
    new_params, opt_state, gnorm = adamw.update(
        tree_unflatten(params, g_acc), opt_state, lr, opt_cfg)
    new_params = tree_map(lambda x: x.requires_grad_(), new_params)
    out = {k: v / n_micro for k, v in sums.items()}
    out.update(grad_norm=gnorm, lr=lr)
    return new_params, opt_state, out


def default_lr_schedule():
    return functools.partial(schedules.warmup_cosine, peak_lr=3e-4,
                             warmup_steps=100, total_steps=10_000)


def build_train_step(model: Model, parallel: ParallelConfig,
                     shape: ShapeConfig, *, lr_schedule=None,
                     opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """-> ``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    {"loss", "grad_norm", "lr", "ce", "aux"})``.

    ``params`` is a parameter tree whose leaves require grad (the model's
    own ``param_tree()`` at the first step, the returned tree after);
    ``opt_state`` comes from ``adamw.init`` and is updated in place."""
    check_single_device(parallel, f"build_train_step({model.cfg.name})")
    n_micro = num_microbatches(shape, parallel)
    lr_fn = lr_schedule or default_lr_schedule()

    def loss_fn(p, mb):
        return model.loss(mb, params=p, remat=parallel.remat)

    def step(params, opt_state, batch, step_idx):
        return accumulate_and_update(loss_fn, params, opt_state, batch,
                                     step_idx, n_micro=n_micro, lr_fn=lr_fn,
                                     opt_cfg=opt_cfg)

    return step
