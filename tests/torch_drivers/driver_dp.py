"""Data-parallel driver: the port's sharded train step on spawned gloo
ranks.

    python tests/torch_drivers/driver_dp.py WORLD CASES.json IN.npz OUT.npz

``CASES.json`` lists cases ``{"name", "arch", "over", "mbs", "zero",
"steps", "batch", "seq", "compress", "lr", "spec_dtypes"}``: the port's
reduced config of ``arch`` with ``over`` applied, its parameters from
``IN.npz`` (``<name>/params/<path>``, float32, cast to the model's
parameter dtypes when ``spec_dtypes``) and one global batch a step
(``<name>/batch<i>/<key>``).  Every rank builds the same model and a
``section_mesh`` over all ranks with ``ParallelConfig(dp=WORLD, mbs,
zero_opt)``, runs the steps on its blocks of the batches (``step.block``:
its rows, or its sequence columns where a batch does not divide the data
ranks) and gathers the final parameters and master
weights; the ranks' losses must agree.  Rank 0 writes ``<name>/loss``,
``<name>/grad_norm``, ``<name>/params/<path>`` and
``<name>/master/<path>`` to ``OUT.npz``.  Prints ``DRIVER_OK dp``.
"""
import functools
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from dist_util import flat, nest, spawn
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import ParallelConfig, ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.common import tree_like
from repro_torch.models.model import build_model, model_specs
from repro_torch.optim import adamw, schedules
from repro_torch.train import step as step_mod

# the port's trajectory tests give AdamW eps = 1e-3 (tests/test_torch_train.py
# says why)
OPT_EPS = 1e-3


def run_case(case: dict, arrays, mesh, world: int) -> dict:
    name = case["name"]
    cfg = get_reduced(case["arch"]).replace(**case["over"])
    params = params_from_numpy(nest(arrays, f"{name}/params/"), device="cpu")
    if case.get("spec_dtypes"):
        params = _cast(params, model_specs(cfg))
    model = build_model(cfg, params, device="cpu")
    par = ParallelConfig(dp=world, mbs=case["mbs"], zero_opt=case["zero"],
                         grad_compress=case.get("compress", "none"))
    shape = ShapeConfig("t", "train", case["seq"], case["batch"])
    steps = case["steps"]
    step = step_mod.build_train_step(
        model, par, shape, mesh=mesh,
        lr_schedule=functools.partial(
            schedules.warmup_cosine, peak_lr=case["lr"], warmup_steps=1,
            total_steps=steps) if case["lr"] else None,
        opt_cfg=adamw.AdamWConfig(eps=OPT_EPS))
    sh = step.shardings
    full = model.param_tree()
    params = shd.shard_tree(full, sh["params"], mesh)
    opt = adamw.init(shd.shard_tree(full, sh["opt"].master, mesh))
    compress = par.grad_compress != "none"
    ef = sh["ef_init"](params) if compress else None
    losses, gnorms = [], []
    for i in range(steps):
        batch = step.block({k: torch.from_numpy(v) for k, v in
                            nest(arrays, f"{name}/batch{i}/").items()})
        if compress:
            params, opt, met, ef = step(params, opt, batch, i, ef)
        else:
            params, opt, met = step(params, opt, batch, i)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    got = torch.tensor(losses, dtype=torch.float64)
    every = [torch.empty_like(got) for _ in range(world)]
    dist.all_gather(every, got)
    if not all(torch.equal(e, got) for e in every):
        raise AssertionError(f"{name}: the ranks' losses differ: {every}")
    out = {f"{name}/loss": np.array(losses),
           f"{name}/grad_norm": np.array(gnorms)}
    out.update(flat(shd.gather_tree(params, tree_like(params, sh["params"]),
                                    mesh), f"{name}/params/"))
    out.update(flat(shd.gather_tree(opt.master, tree_like(
        opt.master, sh["opt"].master), mesh), f"{name}/master/"))
    if compress:
        res = max(float(x.abs().max()) for x in
                  [v for v in _leaves(ef)])
        peak = torch.tensor([res], dtype=torch.float64)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        out[f"{name}/ef_max"] = peak.numpy()
    return out


def _cast(tree, specs):
    if isinstance(tree, dict):
        return {k: _cast(v, specs[k]) for k, v in tree.items()}
    return tree.to(specs.dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def work(rank, world, cases_path, in_path, out_path):
    torch.use_deterministic_algorithms(True)
    cases = json.loads(open(cases_path).read())
    arrays = np.load(in_path)
    mesh = shd.section_mesh(range(world), ParallelConfig(dp=world))
    out = {}
    for case in cases:
        out.update(run_case(case, arrays, mesh, world))
    if rank == 0:
        np.savez(out_path, **out)


if __name__ == "__main__":
    world = int(sys.argv[1])
    spawn(work, world, *sys.argv[2:5])
    print("DRIVER_OK dp")
