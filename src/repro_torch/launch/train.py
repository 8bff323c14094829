"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 5 --batch 4 --seq 2048 --dtype bfloat16

Counterpart of ``repro/launch/train.py`` with the same options and
presets, plus ``--device`` (``cuda`` by default) and ``--seed`` (weights
from a seeded ``torch.Generator``, batches from ``lm_batches`` with that
seed).  ``--arch <id> --reduced --device cpu`` runs the reduced config on
the CPU.  One device only: ``--data``/``--model`` above 1 raise (ROADMAP.md,
A6), and so does ``--ckpt-dir`` until the checkpointer is ported (A9).
It prints each logged step, the cold (first) and warm step times,
tokens/s, and how many times the flash-attention and SSD-scan kernels were
launched.
"""
from __future__ import annotations

import argparse
import functools
import statistics
import time
from dataclasses import dataclass

from repro_torch.configs import ARCH_NAMES
from repro_torch.core.types import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.data.synthetic import lm_batches
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

    def summary(self) -> str:
        r = self.result
        toks = self.batch * self.seq
        warm = r.step_times[1:] or r.step_times
        warm_s = statistics.mean(warm)
        return (f"done: {r.steps_run} steps, loss {r.losses[0]:.3f} -> "
                f"{r.losses[-1]:.3f}, {r.steps_run * toks / self.seconds:.0f}"
                f" tok/s, stragglers={r.stragglers}\n"
                f"step: cold {r.step_times[0] * 1e3:.1f} ms, warm "
                f"{warm_s * 1e3:.1f} ms ({toks / warm_s:.0f} tok/s)\n"
                f"flash kernel launches: {self.flash_launches}, ssd kernel "
                f"launches: {self.ssd_launches}")


def run(arch: str = "lm-20m", *, reduced: bool = False, steps: int = 100,
        batch: int = 8, seq: int = 256, mbs: int = 0, lr: float = 3e-3,
        data: int = 1, model: int = 1, dtype: str = "float32",
        device: str = "cuda", seed: int = 0, log_every: int = 10
        ) -> TrainRun:
    """Build ``arch`` with seeded random weights and train it on
    ``lm_batches`` for ``steps`` steps."""
    cfg = resolve_config(arch, reduced=reduced, dtype=dtype)
    shape = ShapeConfig("cli", "train", seq, batch)
    mbs = mbs or max(batch // data, 1)
    parallel = ParallelConfig(dp=data, tp=model, mbs=mbs)
    m = build_model(cfg, device=device, seed=seed)
    step = step_mod.build_train_step(
        m, parallel, shape,
        lr_schedule=functools.partial(
            schedules.warmup_cosine, peak_lr=lr,
            warmup_steps=max(steps // 10, 1), total_steps=steps))
    params = m.param_tree()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device} "
           f"mbs={mbs}")
    opt = adamw.init(params)
    n0, m0 = fa.flash_fwd.launches, ssd.ssd_fwd.launches
    t0 = time.perf_counter()
    res = train(step, params=params, opt_state=opt,
                batches=lm_batches(batch=batch, seq_len=seq,
                                   vocab=cfg.vocab_size, seed=seed,
                                   device=device),
                num_steps=steps, log_every=log_every)
    seconds = time.perf_counter() - t0
    return TrainRun(cfg, n_params, mbs, batch, seq, res, seconds,
                    fa.flash_fwd.launches - n0, ssd.ssd_fwd.launches - m0)


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
    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir: checkpointing is not ported yet; see ROADMAP.md, A9")
    res = run(args.arch, reduced=args.reduced, steps=args.steps,
              batch=args.batch, seq=args.seq, mbs=args.mbs, lr=args.lr,
              data=args.data, model=args.model, dtype=args.dtype,
              device=args.device, seed=args.seed)
    print(res.summary())
    return res


if __name__ == "__main__":
    main()
