"""Compound VLM training (paper §2.1/§4.1) on the PyTorch port: the
counterpart of ``examples/vlm_training.py``.

    PYTHONPATH=src python examples/vlm_training_torch.py --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 8 examples/vlm_training_torch.py --device cpu
    PYTHONPATH=src python examples/vlm_training_torch.py      # one card

* builds the section graph (ViT -> LLM) and prints the two-stage
  planner's per-section configs for the paper-scale workload on H100s;
* trains a reduced compound model for real through
  ``repro_torch.mllm.workload.MLLMRuntime`` on section meshes, the
  reference's layout: the ViT at dp 4 on ranks 0-3, the LLM at dp 4 on
  ranks 4-7.  Per iteration the cost model builds the scheduler's
  6-tuples, Algorithm 1 reorders the samples and the executor dispatches
  microbatches to the section workers; text-only microbatches never
  reach the ViT's ranks.  With ``--device cpu`` and no ``torchrun`` the
  script spawns the eight gloo ranks itself; on the card (one H100, where
  NCCL takes one rank) both sections share rank 0, each on its own worker
  thread and stream;
* streams iterations with ``lookahead=1`` through ``install /
  submit_iteration / retire``: the updates run on the section workers, so
  iteration i+1 queues behind each section's own update;
* reports the realized (executed, from the executor's timeline) LLM
  utilization and the wavefront-vs-FIFO makespan of the last batch.

The loss must fall: the mean of the last five iterations' losses below
the first five's.  The reference's example compares the last batch's loss
with the first's, which the random batches make a coin toss: from the
same parameters and batches the port's losses follow the JAX runtime's
within 4.3e-5 over all 25 iterations, and that single-batch comparison
fails on both at seed 0 from this init, and on the JAX package's own
init at seed 1 (``tests/test_torch_vlm_example.py``).
"""
import argparse
import functools
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.graph import build_vlm_graph
from repro_torch.core.planner import plan
from repro_torch.core.types import H100, ParallelConfig
from repro_torch.data.synthetic import vlm_batches
from repro_torch.mllm.workload import MLLMRuntime
from repro_torch.models.vlm import vit_config
from repro_torch.optim import schedules

WORLD, ITERS = 8, 25
B, S, K, MBS = 16, 32, 8, 4
LR = 2e-3


def configs():
    """(ViT, LM): a 2-layer ViT and pixtral-12b's reduced LM, float32."""
    lm_cfg = get_reduced("pixtral-12b").replace(
        dtype="float32", vocab_size=1024, vision_dim=64, max_image_tokens=K)
    vit_cfg = vit_config(num_layers=2, d_model=64, num_heads=4, d_ff=128,
                         patch_dim=16, downsample=4, out_dim=64,
                         name="vit-tiny").replace(dtype="float32")
    return vit_cfg, lm_cfg


def learned(losses) -> bool:
    """The mean of the last five losses below the first five's."""
    return bool(np.mean(losses[-5:]) < np.mean(losses[:5]))


def run(rank: int, world: int) -> None:
    """Every rank runs this: build the section meshes, train, report."""
    if rank == 0:
        g = build_vlm_graph(vit_config(out_dim=5120),
                            get_config("qwen2.5-32b"))
        p = plan(g, critical_gpus=256, seq_len=8192, global_batch=256,
                 activation_rates={"vit": 0.3}, hw=H100)
        print("== two-stage plan (ViT + qwen2.5-32b, 256 H100s) ==")
        print(p.summary())
        print()
    vit_cfg, lm_cfg = configs()
    if world == 1:          # one card: both sections on rank 0
        vp = lp = ParallelConfig()
        ranks = [0, 0]
    else:
        vp = lp = ParallelConfig(dp=4)
        ranks = range(world)
    rt = MLLMRuntime(vit_cfg, lm_cfg, vit_parallel=vp, lm_parallel=lp,
                     global_batch=B, seq_len=S, mbs=MBS, ranks=ranks,
                     lr_schedule=functools.partial(schedules.constant,
                                                   peak_lr=LR),
                     lookahead=1)
    last = rt._crt._ranks["llm"][-1]
    if rank == 0:
        print(f"== disaggregated MLLM runtime: vit dp {vp.dp}, llm dp "
              f"{lp.dp}, mbs={MBS}, lookahead=1, world {world} ==")
    params, opts = rt.init(0)
    data = vlm_batches(batch=B, seq_len=S, vocab=1024, vision_ratio=0.5,
                       image_tokens=K, patch_dim=16, seed=0, device="cpu")
    rt.install(params, opts)
    losses, utils, metrics = [], [], None

    def account(i, m):
        nonlocal metrics
        if "loss" not in m:                 # not the LLM's ranks
            return
        metrics = m
        ex = m["execution"]
        losses.append(float(m["loss"]))
        utils.append(ex.utilization("llm"))
        if i % 8 == 0 and rank == last:
            print(f"iter {i:3d}: loss={losses[-1]:.4f} "
                  f"realized-llm-util={utils[-1]:.3f} "
                  f"vit-mbs={len(m['plan'].image_mbs)}/{m['plan'].n_mb} "
                  f"makespan={ex.makespan * 1e3:.0f}ms")

    done, batch = 0, None
    for i in range(ITERS):
        batch = next(data)
        rt.submit_iteration(batch, i)
        while rt.in_flight > 1:
            account(done, rt.retire())
            done += 1
    for m in rt.drain():
        account(done, m)
        done += 1
    params, opts = rt.blocks()
    # wavefront against FIFO on the last batch, from the executor's timeline
    _, _, m_fifo = rt.train_iteration(params, opts, batch, 99, reorder=False)
    rt.shutdown()
    if losses and rank == last:
        wf, ff = metrics["execution"].makespan, m_fifo["execution"].makespan
        print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; mean realized LLM "
              f"utilization {np.mean(utils):.3f}")
        print(f"realized makespan: wavefront {wf * 1e3:.0f}ms vs FIFO "
              f"{ff * 1e3:.0f}ms (vit-mbs {len(metrics['plan'].image_mbs)} "
              f"vs {len(m_fifo['plan'].image_mbs)})")
        assert all(np.isfinite(losses)), losses
        print(f"mean loss of the first five {np.mean(losses[:5]):.4f}, "
              f"last five {np.mean(losses[-5:]):.4f}")
        assert learned(losses), "compound model did not learn"
        print("vlm_training example OK")


def _spawned(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        run(rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if "RANK" in os.environ:                       # under torchrun
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        try:
            run(dist.get_rank(), dist.get_world_size())
            dist.barrier()
        finally:
            dist.destroy_process_group()
    elif args.device == "cpu":                     # spawn the gloo ranks
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_spawned, args=(WORLD, os.path.join(tmp, "store")),
                     nprocs=WORLD, join=True)
    else:                                          # one card, one rank
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            run(0, 1)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
