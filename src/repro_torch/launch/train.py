"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 5 --batch 4 --seq 2048 --dtype bfloat16

Counterpart of ``repro/launch/train.py`` with the same options and
presets, plus ``--device`` (``cuda`` by default) and ``--seed`` (weights
from a seeded ``torch.Generator``, batches from ``lm_batches`` with that
seed).  ``--arch <id> --reduced --device cpu`` runs the reduced config on
the CPU.

``--data N`` trains data-parallel with FSDP and ZeRO sharding and
``--model M`` tensor-parallel (Megatron TP, ``dist.pipeline``), one
process per rank, launched by ``torchrun``::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --data 2 --model 2 --device cpu \
        --arch qwen1.5-0.5b --reduced --batch 8 --seq 32

The process group comes from the environment ``torchrun`` sets (NCCL on
``cuda``, one card a rank, gloo on ``--device cpu``), and the world size
must equal ``--data`` x ``--model``.  Every rank builds the same seeded
model and draws the same global batch on the host, and moves only its
block to the device (``step.block``, the reference's layout): its rows
where ``--batch`` divides ``--data``, else its sequence columns where
``--seq`` does, else the whole batch; ``--batch`` below ``--data`` is
legal.
Without ``torchrun``, ``--data`` or ``--model`` above 1 raises and says how
to launch.
``--ckpt-dir DIR`` saves ``{"params", "opt"}`` there every
``--ckpt-every`` steps and at the end, and a run given a directory that
holds a checkpoint resumes from the latest one: run the same command again
after an interruption.  Like the JAX package's launcher, a resumed run
starts the batches again from the first (ROADMAP.md, C9).
It prints each logged step, the cold (first) and warm step times,
tokens/s, and how many times the flash-attention and SSD-scan kernels were
launched.
"""
from __future__ import annotations

import argparse
import functools
import os
import statistics
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCH_NAMES
from repro_torch.core.types import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import PRESETS, resolve_config
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, schedules
from repro_torch.train import step as step_mod
from repro_torch.train.loop import TrainResult, train


@dataclass
class TrainRun:
    cfg: ArchConfig
    n_params: int
    mbs: int
    batch: int
    seq: int
    result: TrainResult
    seconds: float               # the whole loop, first step included
    flash_launches: int          # flash kernel launches during the loop
    ssd_launches: int            # SSD kernel launches during the loop
    checkpointer: Optional[Checkpointer] = None
    shardings: Optional[dict] = None   # {"params", "opt"} specs on a mesh

    def summary(self) -> str:
        r = self.result
        resumed = ("" if r.resumed_from is None
                   else f" (resumed from step {r.resumed_from})")
        if not r.steps_run:
            return f"done: 0 steps{resumed}"
        toks = self.batch * self.seq
        warm = r.step_times[1:] or r.step_times
        warm_s = statistics.mean(warm)
        return (f"done: {r.steps_run} steps{resumed}, loss "
                f"{r.losses[0]:.3f} -> "
                f"{r.losses[-1]:.3f}, {r.steps_run * toks / self.seconds:.0f}"
                f" tok/s, stragglers={r.stragglers}\n"
                f"step: cold {r.step_times[0] * 1e3:.1f} ms, warm "
                f"{warm_s * 1e3:.1f} ms ({toks / warm_s:.0f} tok/s)\n"
                f"flash kernel launches: {self.flash_launches}, ssd kernel "
                f"launches: {self.ssd_launches}")


def run(arch: str = "lm-20m", *, reduced: bool = False, steps: int = 100,
        batch: int = 8, seq: int = 256, mbs: int = 0, lr: float = 3e-3,
        data: int = 1, model: int = 1, dtype: str = "float32",
        device: str = "cuda", seed: int = 0, log_every: int = 10,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        batches: Optional[Iterator] = None, mesh=None) -> TrainRun:
    """Build ``arch`` with seeded random weights and train it up to step
    ``steps`` on ``batches`` (default: ``lm_batches`` from ``seed``),
    checkpointing under ``ckpt_dir`` and resuming from it when given.

    ``mesh`` (``dist.sharding.section_mesh`` over an initialised process
    group, of ``data`` x ``model`` ranks) runs the sharded step; every rank
    calls ``run`` with the same arguments (``batches`` global, drawn on the
    host by default), takes this rank's block of each batch and moves it to
    ``device``, and the result's parameters and optimizer state are this
    rank's blocks."""
    if data * model > 1 and mesh is None:
        raise RuntimeError(
            f"--data {data} --model {model} runs one process per rank: "
            f"launch it with python -m torch.distributed.run "
            f"--nproc-per-node {data * model} -m repro_torch.launch.train "
            f"--data {data} --model {model} ... (ROADMAP.md, A6.1, A6.4)")
    cfg = resolve_config(arch, reduced=reduced, dtype=dtype)
    shape = ShapeConfig("cli", "train", seq, batch)
    mbs = mbs or max(batch // data, 1)
    parallel = ParallelConfig(dp=data, tp=model, mbs=mbs)
    m = build_model(cfg, device=device, seed=seed)
    step = step_mod.build_train_step(
        m, parallel, shape, mesh=mesh,
        lr_schedule=functools.partial(
            schedules.warmup_cosine, peak_lr=lr,
            warmup_steps=max(steps // 10, 1), total_steps=steps))
    params = m.param_tree()
    n_params = sum(x.numel() for x in tree_leaves(params))
    shardings = None
    if mesh is None:
        opt = adamw.init(params)
        where = ""
    else:
        shardings = {k: step.shardings[k] for k in ("params", "opt")}
        opt = adamw.init(shd.shard_tree(params, shardings["opt"].master,
                                        mesh))
        params = shd.shard_tree(params, shardings["params"], mesh)
        where = f" mesh={shd.mesh_shape(mesh)}"
    if mesh is None or shd.is_origin(mesh):
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device} "
              f"mbs={mbs}{where}")
    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    if batches is None:
        batches = lm_batches(batch=batch, seq_len=seq, vocab=cfg.vocab_size,
                             seed=seed,
                             device=device if mesh is None else "cpu")
    if mesh is not None:
        batches = ({k: v.to(device) for k, v in step.block(b).items()}
                   for b in batches)
    n0, m0 = fa.flash_fwd.launches, ssd.ssd_fwd.launches
    t0 = time.perf_counter()
    res = train(step, params=params, opt_state=opt, batches=batches,
                num_steps=steps, checkpointer=ck, checkpoint_every=ckpt_every,
                log_every=log_every, mesh=mesh,
                shardings=shardings)
    seconds = time.perf_counter() - t0
    return TrainRun(cfg, n_params, mbs, batch, seq, res, seconds,
                    fa.flash_fwd.launches - n0, ssd.ssd_fwd.launches - m0,
                    ck, shardings)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-20m",
                    help=f"preset {list(PRESETS)} or one of {ARCH_NAMES}")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of an assigned arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mbs", type=int, default=0,
                    help="microbatch size per DP shard (0 = whole batch)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    kw = dict(reduced=args.reduced, steps=args.steps, batch=args.batch,
              seq=args.seq, mbs=args.mbs, lr=args.lr, data=args.data,
              model=args.model, dtype=args.dtype, device=args.device,
              seed=args.seed, ckpt_dir=args.ckpt_dir or None,
              ckpt_every=args.ckpt_every)
    if "WORLD_SIZE" not in os.environ:
        res = run(args.arch, **kw)
        print(res.summary())
        return res
    # one rank of a torchrun launch
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        world = dist.get_world_size()
        if world != args.data * args.model:
            raise ValueError(
                f"torchrun started {world} ranks for --data {args.data} x "
                f"--model {args.model}")
        mesh = shd.section_mesh(range(world), ParallelConfig(
            dp=args.data, tp=args.model))
        res = run(args.arch, mesh=mesh, **kw)
        if dist.get_rank() == 0:
            print(res.summary())
    finally:
        dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
