"""Elastic-restore driver: a ZeRO state saved by a sharded run on one mesh
restores on another, on spawned gloo ranks.

    python tests/torch_drivers/driver_elastic.py save 4 DIR IN.npz FULL.npz
    python tests/torch_drivers/driver_elastic.py restore 2 DIR IN.npz FULL.npz

``IN.npz`` holds the reduced qwen1.5-0.5b's bfloat16 parameters as float32
(``params/<path>``) and one global batch (``batch/<key>``).

``save``: the ranks build the model, lay its parameters and optimizer
state out on ``section_mesh`` with ``ParallelConfig(dp=WORLD,
zero_opt=True)``, take one sharded step so that mu, nu, master and step
hold values, and save ``{"params", "opt"}`` as checkpoint 1 under ``DIR``
(a collective save).  Rank 0 writes the gathered full state to
``FULL.npz`` (bf16 leaves as their int16 words).

``restore``: the ranks restore checkpoint 1 under other specs, on the
``WORLD`` data ranks with the optimizer state not extended (``zero_opt``
False) and on a mesh whose ``model`` axis holds the ``WORLD`` ranks
(``zero_opt`` True there); each restored tree is gathered again and must
equal ``FULL.npz`` bit for bit.  Prints ``DRIVER_OK elastic``.
"""
import sys

import numpy as np
import torch

from dist_util import nest, spawn
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import ParallelConfig, ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.common import flatten_with_path, tree_like, tree_map
from repro_torch.models.model import build_model, model_specs
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod

CFG = get_reduced("qwen1.5-0.5b")          # bfloat16 parameters


def _params(arrays):
    return _cast(params_from_numpy(nest(arrays, "params/"), device="cpu"),
                 model_specs(CFG))


def _cast(tree, specs):
    if isinstance(tree, dict):
        return {k: _cast(v, specs[k]) for k, v in tree.items()}
    return tree.to(specs.dtype)


def _words(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _specs(mesh, zero: bool):
    specs = model_specs(CFG)
    rules = shd.rules_for(CFG, mesh)
    return {"params": shd.param_shardings(specs, mesh, rules),
            "opt": shd.opt_state_shardings(specs, mesh, rules, zero=zero)}


def _gathered(state, shardings, mesh) -> dict:
    full = {"params": shd.gather_tree(
        state["params"], tree_like(state["params"], shardings["params"]),
        mesh)}
    o, so = state["opt"], shardings["opt"]
    full["opt"] = adamw.AdamWState(
        o.step, *(shd.gather_tree(getattr(o, k), tree_like(
            getattr(o, k), getattr(so, k)), mesh)
                  for k in ("mu", "nu", "master")))
    return {p: _words(x) for p, x in flatten_with_path(full)}


def save(rank, world, ckdir, in_path, full_path):
    arrays = np.load(in_path)
    model = build_model(CFG, _params(arrays), device="cpu")
    par = ParallelConfig(dp=world, mbs=1, zero_opt=True)
    mesh = shd.section_mesh(range(world), par)
    batch = {k: torch.from_numpy(v) for k, v in nest(arrays,
                                                     "batch/").items()}
    step = step_mod.build_train_step(
        model, par, ShapeConfig("t", "train", batch["tokens"].shape[1],
                                batch["tokens"].shape[0]), mesh=mesh)
    sh = {k: step.shardings[k] for k in ("params", "opt")}
    full = model.param_tree()
    params = shd.shard_tree(full, sh["params"], mesh)
    opt = adamw.init(shd.shard_tree(full, sh["opt"].master, mesh))
    params, opt, _ = step(params, opt, step.block(batch), 0)
    state = {"params": params, "opt": opt}
    Checkpointer(ckdir, async_save=False).save(1, state, shardings=sh,
                                               mesh=mesh)
    words = _gathered(state, sh, mesh)
    if rank == 0:
        np.savez(full_path, **words)


def restore(rank, world, ckdir, in_path, full_path):
    want = np.load(full_path)
    ck = Checkpointer(ckdir)
    for par, zero in ((ParallelConfig(dp=world), False),
                      (ParallelConfig(tp=world), True)):
        mesh = shd.section_mesh(range(world), par)
        sh = _specs(mesh, zero)
        zeros = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                         model_specs(CFG))
        target = {"params": shd.shard_tree(zeros, sh["params"], mesh),
                  "opt": adamw.init(shd.shard_tree(zeros, sh["opt"].master,
                                                   mesh))}
        got = _gathered(ck.restore(1, target, shardings=sh, mesh=mesh), sh,
                        mesh)
        assert sorted(got) == sorted(want.files), (sorted(got), want.files)
        for k, v in got.items():
            if v.dtype != want[k].dtype or not np.array_equal(v, want[k]):
                raise AssertionError(f"{par}: leaf {k} differs")


if __name__ == "__main__":
    mode, world = sys.argv[1], int(sys.argv[2])
    spawn({"save": save, "restore": restore}[mode], world, *sys.argv[3:6])
    print("DRIVER_OK elastic")
