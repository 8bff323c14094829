"""Pipeline and tensor parallelism on spawned gloo ranks: the port's
``build_pp_loss`` and the train step's pp regime and plain regime at
tp > 1.

    python tests/torch_drivers/driver_pipeline.py CASE WORLD IN.npz OUT.npz

``loss``: the cases of :data:`LOSS_CASES`, each from ``<case>/params/
<path>`` (float32) and one global batch ``<case>/batch/<key>``: each rank
takes its blocks (``loss_fn.local``) of a ``DeviceMesh`` of the case's
axes over the first ranks of the world (the others skip the case), runs
``loss_fn.value_and_grad`` and the forward ``loss_fn`` alone; rank 0
writes ``<case>/{loss,fwd_loss,info}`` and the gathered
``<case>/grads/<path>``.

``pp_step`` / ``tp_step`` / ``layout``: the cases of
:data:`PP_STEP_CASES` / :data:`TP_STEP_CASES` / :data:`LAYOUT_CASES`, one
sharded train step each at its ``ParallelConfig`` on ``section_mesh``
over the first ranks of the world, fed each rank's block of the global
batch (``step.block``); rank 0 writes ``<case>/{loss, grad_norm}`` and the
gathered ``<case>/params/<path>``.  A case whose name ends in
``_planted`` runs with the fault :data:`PLANTED` names, which the bounds
must catch: every gradient leaf the model axis does not split summed over
``model`` as well, each repeated KV head's gradient taken from one of its
copies instead of their sum, one data rank's rows counted twice in the
replicated layout, or the first vocabulary slice left out of the
vocab-parallel log-sum-exp.

Prints ``DRIVER_OK pipeline CASE``.  Imports no ``jax`` and nothing of
``repro``.
"""
import contextlib
import functools
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dist_util import flat, nest, spawn
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import ParallelConfig, ShapeConfig
from repro_torch.dist import pipeline as pl
from repro_torch.dist import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_like
from repro_torch.models.model import build_model, model_specs
from repro_torch.optim import adamw, schedules
from repro_torch.train import step as step_mod

#: (name, arch, config overrides, mesh axes, mesh shape, n_micro,
#: vocab_parallel, global batch): tests/drivers/driver_train_step_dist.py's
#: and driver_pipeline_cp.py's meshes, qwen's tied table, pipe 4 on both
#: CE paths, and pp x tp with and without attention inside the gates
LOSS_CASES = [
    ("g_d2p2", "granite-3-8b", dict(num_layers=4), ("data", "pipe"),
     (2, 2), 2, "auto", 8),
    ("mix_d2p2", "mixtral-8x22b", dict(num_layers=2), ("data", "pipe"),
     (2, 2), 2, "auto", 8),
    ("q_d2p2", "qwen1.5-0.5b", {}, ("data", "pipe"), (2, 2), 2, "auto", 8),
    ("g_pod", "granite-3-8b", dict(num_layers=4), ("pod", "data", "pipe"),
     (2, 2, 2), 2, "auto", 8),
    ("g_podstage", "granite-3-8b", dict(num_layers=4), ("pod", "data"),
     (2, 4), 2, "auto", 16),
    ("g_p4_vp", "granite-3-8b", dict(num_layers=4), ("pipe",), (4,), 4,
     True, 8),
    ("g_p4_masked", "granite-3-8b", dict(num_layers=4), ("pipe",), (4,), 4,
     False, 8),
    ("g_p2m2", "granite-3-8b", dict(num_layers=4), ("pipe", "model"),
     (2, 2), 2, "auto", 8),
    ("g20_p2m2", "granite-20b", {}, ("pipe", "model"), (2, 2), 2, "auto",
     8),
]

#: (name, arch, config overrides, ParallelConfig knobs):
#: driver_train_step_dist.py's pp2 and pp2tp2 steps (granite, 4 layers)
PP_STEP_CASES = [
    ("pp2", "granite-3-8b", dict(num_layers=4), dict(dp=2, pp=2, mbs=2)),
    ("pp2tp2", "granite-3-8b", dict(num_layers=4),
     dict(dp=2, pp=2, tp=2, mbs=2)),
]

#: the plain regime at tp 2 and, past the KV heads, at tp 4 (granite,
#: 2 KV heads) and tp 2 (granite-20b, one): each KV head repeated over
#: its query-head group; the MoE and hybrid families at dp 2
TP_STEP_CASES = [
    ("g_d2t2", "granite-3-8b", dict(num_layers=4), dict(dp=2, tp=2, mbs=2)),
    ("g_d2t4", "granite-3-8b", dict(num_layers=4), dict(dp=2, tp=4, mbs=2)),
    ("g20_d2t2", "granite-20b", {}, dict(dp=2, tp=2, mbs=2)),
    ("mix_d2t2", "mixtral-8x22b", dict(num_layers=2),
     dict(dp=2, tp=2, mbs=2)),
    ("mix_d2", "mixtral-8x22b", dict(num_layers=2), dict(dp=2, mbs=2)),
    ("jamba_d2", "jamba-v0.1-52b", {}, dict(dp=2, mbs=2)),
    ("g_d2t2_planted", "granite-3-8b", dict(num_layers=4),
     dict(dp=2, tp=2, mbs=2)),
    ("g_d2t4_planted", "granite-3-8b", dict(num_layers=4),
     dict(dp=2, tp=4, mbs=2)),
]
STEP_GB, STEP_S = 8, 16

#: (name, arch, config overrides, ParallelConfig knobs, (global batch,
#: sequence)): the batch layouts the reference keeps legal (a batch of 3
#: on 2 data ranks with an odd sequence, replicated, here on 2 of the 4
#: ranks, also for whisper, whose frames the reference's rule splits over
#: the data ranks all the same; the pipeline at a batch of 1, its
#: sequence over the data ranks gathered to run replicated), the tied
#: vocabulary split over 4 model ranks with 3 padded rows, and the
#: planted faults of both
LAYOUT_CASES = [
    ("rep_b3_d2", "qwen1.5-0.5b", {}, dict(dp=2, mbs=4), (3, 15)),
    ("rep_b3_d2_planted", "qwen1.5-0.5b", {}, dict(dp=2, mbs=4), (3, 15)),
    ("whisper_b3_d2", "whisper-small", {}, dict(dp=2, mbs=4), (3, 15)),
    ("pp_b1_d2p2", "granite-3-8b", dict(num_layers=4), dict(dp=2, pp=2),
     (1, 16)),
    ("vp_q_t4", "qwen1.5-0.5b", dict(vocab_size=509, vocab_pad=3),
     dict(tp=4, mbs=8), (8, 16)),
    ("vp_q_t4_planted", "qwen1.5-0.5b", dict(vocab_size=509, vocab_pad=3),
     dict(tp=4, mbs=8), (8, 16)),
]
# tests/drivers/driver_train_step_dist.py:32-36
STEP_OPT = adamw.AdamWConfig(eps=1e-3)
STEP_LR = functools.partial(schedules.constant, peak_lr=1e-3)


def _cast(tree, specs):
    """IN.npz's float32 leaves back to their parameters' dtypes."""
    if isinstance(tree, dict):
        return {k: _cast(v, specs[k]) for k, v in tree.items()}
    return tree.to(specs.dtype)


def _params(arrays, name, cfg):
    return _cast(params_from_numpy(nest(arrays, f"{name}/params/"),
                                   device="cpu"), model_specs(cfg))


def _batch(arrays, name):
    return {k: torch.from_numpy(v)
            for k, v in nest(arrays, f"{name}/batch/").items()}


def case_loss(rank, world, arrays, out):
    for name, arch, over, axes, shape, n_micro, vp, _ in LOSS_CASES:
        cfg = get_reduced(arch).replace(dtype="float32", **over)
        n = int(np.prod(shape))
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                          mesh_dim_names=axes)
        if rank >= n:
            continue
        loss_fn, info = pl.build_pp_loss(cfg, mesh, n_micro,
                                         vocab_parallel=vp)
        full = _params(arrays, name, cfg)
        local = loss_fn.local(full)
        batch = _batch(arrays, name)
        loss, grads = loss_fn.value_and_grad(local, batch)
        fwd = loss_fn(local, batch)
        specs = tree_like(grads, loss_fn.specs)
        got = shd.gather_tree(grads, specs, mesh)
        if rank == 0:
            out[f"{name}/loss"] = np.array([float(loss)])
            out[f"{name}/fwd_loss"] = np.array([float(fwd)])
            out[f"{name}/info"] = np.array(json.dumps(info))
            out.update(flat(got, f"{name}/grads/"))


def _unsplit_over_model_fault(reduce_grads):
    """``reduce_grads`` that also sums over ``model`` every gradient whose
    block the model axis does not split."""
    def planted(grads, specs, mesh, axes, have=None):
        grads = list(grads)
        for i, h in enumerate(have or [None] * len(grads)):
            used = {a for e in (h or ()) for a in shd._axes(e)}
            if shd.AXIS_MODEL not in used:
                dist.all_reduce(grads[i],
                                group=mesh.get_group(shd.AXIS_MODEL))
        return reduce_grads(grads, specs, mesh, axes, have)
    return planted


def _one_copy(x, d, times):
    """``shd.fold_repeats`` planted wrong: each repeated entry's gradient
    from its first copy alone."""
    return x.unflatten(d, (-1, times)).select(d + 1, 0)


def _twice_on_rank0(weights):
    """``DataLayout.weights`` planted wrong: data rank 0's micro-batches
    counted twice."""
    def planted(self, mbs):
        w = weights(self, mbs)
        return w * 2 if self.rank == 0 else w
    return planted


def _without_first_slice(partials):
    """``dist.pipeline.vocab_partials`` planted wrong: the slice at offset
    0 adds nothing to the exponential sums."""
    def planted(logits, labels, off, mx):
        ex, se, gold, col, mine = partials(logits, labels, off, mx)
        return ex, se * (off != 0), gold, col, mine
    return planted


def _plant(name):
    """Install case ``name``'s planted fault (:data:`PLANTED`) -> a
    function that removes it."""
    fault = PLANTED.get(name)
    if fault == "rows_twice":
        original = step_mod.DataLayout.weights
        step_mod.DataLayout.weights = _twice_on_rank0(original)
        return lambda: setattr(step_mod.DataLayout, "weights", original)
    if fault == "lse_slice":
        original = pl.vocab_partials
        pl.vocab_partials = _without_first_slice(original)
        return lambda: setattr(pl, "vocab_partials", original)
    if fault == "model_sum":
        original = step_mod.reduce_grads
        step_mod.reduce_grads = _unsplit_over_model_fault(original)
        return lambda: setattr(step_mod, "reduce_grads", original)
    if fault == "kv_one_copy":
        original = shd.fold_repeats
        shd.fold_repeats = _one_copy
        return lambda: setattr(shd, "fold_repeats", original)
    return lambda: None


#: the planted cases' faults
PLANTED = {"g_d2t2_planted": "model_sum", "g_d2t4_planted": "kv_one_copy",
           "rep_b3_d2_planted": "rows_twice", "vp_q_t4_planted": "lse_slice"}


def _step_cases(rank, world, arrays, out, cases):
    for name, arch, over, knobs, *shape in cases:
        gb, seq = shape[0] if shape else (STEP_GB, STEP_S)
        cfg = get_reduced(arch).replace(dtype="float32", **over)
        params = _params(arrays, name, cfg)
        model = build_model(cfg, params, device="cpu")
        par = ParallelConfig(**knobs)
        mesh = shd.section_mesh(range(par.devices), par)
        if rank >= par.devices:
            continue
        step = step_mod.build_train_step(
            model, par, ShapeConfig("t", "train", seq, gb),
            mesh=mesh, lr_schedule=STEP_LR, opt_cfg=STEP_OPT)
        sh = step.shardings
        p = shd.shard_tree(model.param_tree(), sh["params"], mesh)
        opt = adamw.init(shd.shard_tree(model.param_tree(),
                                        sh["opt"].master, mesh))
        batch = step.block(_batch(arrays, name))
        undo = _plant(name)
        try:
            with logit_width() as width:
                p, opt, met = step(p, opt, batch, 0)
        finally:
            undo()
        new = shd.gather_tree(p, tree_like(p, sh["params"]), mesh)
        if rank == 0:
            out[f"{name}/logit_width"] = np.array(width)
            out[f"{name}/loss"] = np.array([float(met["loss"])])
            out[f"{name}/grad_norm"] = np.array([float(met["grad_norm"])])
            out.update(flat(new, f"{name}/params/"))


@contextlib.contextmanager
def logit_width():
    """Record, in the list it yields, the widest logit tensor
    ``models.transformer.unembed`` forms meanwhile."""
    original, widest = tf.unembed, [0]

    def recording(*args, **kw):
        logits = original(*args, **kw)
        widest[0] = max(widest[0], logits.shape[-1])
        return logits
    tf.unembed = recording
    try:
        yield widest
    finally:
        tf.unembed = original


def case_pp_step(rank, world, arrays, out):
    _step_cases(rank, world, arrays, out, PP_STEP_CASES)


def case_tp_step(rank, world, arrays, out):
    _step_cases(rank, world, arrays, out, TP_STEP_CASES)


def case_layout(rank, world, arrays, out):
    _step_cases(rank, world, arrays, out, LAYOUT_CASES)


def work(rank, world, case, in_path, out_path):
    arrays = np.load(in_path)
    out = {}
    globals()[f"case_{case}"](rank, world, arrays, out)
    if rank == 0:
        np.savez(out_path, **out)


if __name__ == "__main__":
    case, world = sys.argv[1], int(sys.argv[2])
    spawn(work, world, case, *sys.argv[3:5])
    print(f"DRIVER_OK pipeline {case}")
