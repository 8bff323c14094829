"""Knowledge distillation, the Maestro way, on the PyTorch port (paper
§3.1/§4.2): the counterpart of ``examples/distillation.py``.

    PYTHONPATH=src python examples/distillation_torch.py --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 8 examples/distillation_torch.py --device cpu
    PYTHONPATH=src python examples/distillation_torch.py      # one card

* the two-stage planner sizes the teacher section for the H100;
* teacher and student run DISAGGREGATED on section meshes of their own
  ranks with fan-out (DP^t × fanout = DP^s): the teacher at dp 2 and tp
  2 (Megatron tensor parallelism) on ranks 0-3, the student at dp 4 on
  ranks 4-7, the reference's layout.  With ``--device cpu`` and no
  ``torchrun`` the script spawns the eight gloo ranks itself; on the card
  (one H100, where NCCL takes one rank) both sections share rank 0, each
  on its own worker thread and stream;
* only *hidden states* cross the section boundary (the teacher's output
  layer is colocated with the student; the KL runs through the
  chunked-vocabulary kernel without the teacher's logits).

Losses must fall and stay finite.
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.graph import build_distill_graph
from repro_torch.core.planner import plan
from repro_torch.core.types import H100, ParallelConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.distill.workload import DistillRuntime

WORLD, ITERS = 8, 30


def run(rank: int, world: int, device: str) -> None:
    """Every rank runs this: build the section meshes, train, report."""
    if rank == 0:
        g = build_distill_graph(get_config("mixtral-8x22b"),
                                get_config("moonshot-v1-16b-a3b"))
        p = plan(g, critical_gpus=512, seq_len=8192, global_batch=512,
                 hw=H100)
        print("== two-stage plan (mixtral-8x22b -> moonshot, 512 H100s) ==")
        print(p.summary())
    t_cfg = get_reduced("qwen2.5-32b").replace(dtype="float32",
                                               vocab_size=2048)
    s_cfg = get_reduced("qwen1.5-0.5b").replace(dtype="float32",
                                                vocab_size=2048)
    if world == 1:          # one card: both sections on rank 0
        t_par, s_par, ranks = ParallelConfig(), ParallelConfig(), [0, 0]
    else:
        t_par, s_par = ParallelConfig(dp=2, tp=2), ParallelConfig(dp=4)
        ranks = range(world)
    rt = DistillRuntime(t_cfg, s_cfg, teacher_parallel=t_par,
                        student_parallel=s_par, ranks=ranks, alpha=0.5,
                        temperature=2.0, lr=2e-3)
    if rank == 0:
        print(f"== section meshes: teacher dp {t_par.dp} tp {t_par.tp}, "
              f"student dp {s_par.dp}, fanout={rt.fanout}, world {world} ==")
    params_t, params_s, opt = rt.init(0)
    w_t = rt.teacher_unembed(params_t)
    data = lm_batches(batch=8, seq_len=32, vocab=2048, seed=0, device="cpu")
    kls, ces = [], []
    for i in range(ITERS):
        params_s, opt, m = rt.train_iteration(params_t, params_s, opt,
                                              next(data), i, w_t=w_t)
        if "ce" in m:                       # the student's ranks
            kls.append(float(m["kl"]))
            ces.append(float(m["ce"]))
            if i % 10 == 0 and rank == ranks[-1]:
                print(f"iter {i:3d}: ce={ces[-1]:.4f} kl={kls[-1]:.4f}")
    stats = rt.rt.queue.stats()
    rt.shutdown()
    if ces and rank == ranks[-1]:
        print(f"ce {ces[0]:.3f} -> {ces[-1]:.3f}; kl {kls[0]:.4f} -> "
              f"{kls[-1]:.4f}")
        print("cross-section traffic on this rank:",
              {k: v for k, v in stats.items() if k != "edges"})
        assert all(torch.isfinite(torch.tensor(ces + kls))), (ces, kls)
        assert ces[-1] < ces[0], "student did not learn"
        print("distillation example OK")


def _spawned(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        run(rank, world, "cpu")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if "RANK" in os.environ:                       # under torchrun
        backend = "nccl" if args.device == "cuda" else "gloo"
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        try:
            run(dist.get_rank(), dist.get_world_size(), args.device)
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
            run(0, 1, "cuda")
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
