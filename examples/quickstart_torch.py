"""Quickstart on the PyTorch port: train a small LM end to end with its
public API.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py          # the card

The counterpart of ``examples/quickstart.py``: config -> model -> sharded
train step on a one-rank mesh -> train loop with checkpointing every 20
steps and straggler monitoring.  The process group is this process alone
(gloo on the CPU, NCCL on the card); ``repro_torch.launch.train`` under
``torchrun`` runs the same step on several ranks.
"""
import argparse
import functools
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.types import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import sharding as shd
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, schedules
from repro_torch.train import step as step_mod
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = ArchConfig(name="quickstart-lm", family="dense", num_layers=4,
                     d_model=256, num_heads=4, num_kv_heads=2, d_ff=704,
                     vocab_size=2048, head_dim=64, dtype="float32")
    parallel = ParallelConfig(mbs=4)
    shape = ShapeConfig("quickstart", "train", 128, 8)
    if args.device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = shd.section_mesh([0], parallel)
        model = build_model(cfg, device=args.device, seed=0)
        step = step_mod.build_train_step(
            model, parallel, shape, mesh=mesh,
            lr_schedule=functools.partial(schedules.constant, peak_lr=3e-3))
        full = model.param_tree()
        print(f"params: {sum(x.numel() for x in tree_leaves(full)) / 1e6:.2f}"
              f"M on {args.device}, mesh {shd.mesh_shape(mesh)}")
        shardings = {k: step.shardings[k] for k in ("params", "opt")}
        opt = adamw.init(shd.shard_tree(full, shardings["opt"].master, mesh))
        params = shd.shard_tree(full, shardings["params"], mesh)
        with tempfile.TemporaryDirectory() as ckdir:
            ck = Checkpointer(ckdir, keep_last_n=2)
            res = train(step, params=params, opt_state=opt,
                        batches=lm_batches(batch=8, seq_len=128, vocab=2048,
                                           seed=0, device=args.device),
                        num_steps=40, checkpointer=ck, checkpoint_every=20,
                        log_every=10, mesh=mesh, shardings=shardings)
            print(f"loss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
                  f"({res.steps_run} steps, {res.stragglers} stragglers, "
                  f"checkpoints at {ck.all_steps()})")
            if not res.losses[-1] < res.losses[0]:
                raise RuntimeError("did not learn")
    finally:
        dist.destroy_process_group()
    print("quickstart OK")


if __name__ == "__main__":
    main()
