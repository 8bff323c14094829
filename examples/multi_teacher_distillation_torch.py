"""Multi-teacher distillation, declared, on the PyTorch port: the
counterpart of ``examples/multi_teacher_distillation.py``.

    PYTHONPATH=src python examples/multi_teacher_distillation_torch.py \\
        --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 8 examples/multi_teacher_distillation_torch.py \\
        --device cpu
    PYTHONPATH=src python examples/multi_teacher_distillation_torch.py

A generalist teacher sees every sample; a specialist teacher activates
only on samples whose ``domain`` flag routes to it.  The workload is one
declaration (``repro_torch.distill.multi_teacher.multi_teacher_spec``:
three SectionSpecs and two typed ports) run by the generic
``CompoundRuntime`` on section meshes: the generalist at dp 2 on ranks
0-1, the specialist at dp 2 on ranks 2-3 and the student at dp 4 on
ranks 4-7, the reference's layout.  With ``--device cpu`` and no
``torchrun`` the script spawns the eight gloo ranks itself; on the card
(one H100, where NCCL takes one rank) the three sections share rank 0,
each on its own worker thread and stream.  The wavefront scheduler groups
specialist samples into fewer microbatches, and all-generalist
microbatches never reach the specialist's ranks.

The student's cross-entropy must fall.
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_reduced
from repro_torch.core import workload as wl
from repro_torch.core.types import ParallelConfig
from repro_torch.data.synthetic import routed_lm_batches
from repro_torch.distill.multi_teacher import (multi_teacher_spec,
                                               student_consts)

WORLD, ITERS = 8, 25
B, S, MBS = 16, 32, 4


def run(rank: int, world: int) -> None:
    """Every rank runs this: build the section meshes, train, report."""
    ta_cfg = get_reduced("qwen2.5-32b").replace(dtype="float32",
                                                vocab_size=1024)
    tb_cfg = get_reduced("granite-3-8b").replace(
        dtype="float32", vocab_size=1024, d_model=64, head_dim=16, d_ff=128)
    s_cfg = get_reduced("qwen1.5-0.5b").replace(dtype="float32",
                                                vocab_size=1024)
    if world == 1:          # one card: every section on rank 0
        pa = pb = ps = ParallelConfig()
        ranks = [0, 0, 0]
    else:
        pa, pb, ps = (ParallelConfig(dp=2), ParallelConfig(dp=2),
                      ParallelConfig(dp=4))
        ranks = range(world)
    spec = multi_teacher_spec(ta_cfg, tb_cfg, s_cfg, ta_parallel=pa,
                              tb_parallel=pb, s_parallel=ps,
                              global_batch=B, seq_len=S, mbs=MBS)
    rt = wl.CompoundRuntime(spec, ranks=ranks)
    last = rt._ranks["student"][-1]
    if rank == 0:
        print(f"== multi-teacher distillation: generalist (dp={pa.dp}) + "
              f"routed specialist (dp={pb.dp}) -> student (dp={ps.dp}), "
              f"world {world} ==")
    params, opts = rt.init(0)
    consts = student_consts(rt, params, ta_cfg, tb_cfg)
    data = routed_lm_batches(batch=B, seq_len=S, vocab=1024,
                             specialist_ratio=0.3, seed=0, device="cpu")
    ces = []
    for i in range(ITERS):
        params, opts, m = rt.train_iteration(params, opts, next(data), i,
                                             consts=consts)
        if "ce" in m:                       # the student's ranks
            ces.append(float(m["ce"]))
            if i % 8 == 0 and rank == last:
                n_spec = len(m["plan"].activation["teacher_b"].active_mbs)
                print(f"iter {i:3d}: ce={ces[-1]:.4f} "
                      f"kl_a={float(m['kl_a']):.4f} "
                      f"kl_b={float(m['kl_b']):.4f} "
                      f"specialist-mbs={n_spec}/{rt.n_mb}")
    stats = rt.rt.queue.stats()
    traffic = torch.tensor([stats["pushes"], stats["bytes_pushed"]],
                           dtype=torch.float64)
    if world > 1:
        dist.all_reduce(traffic)
    rt.shutdown()
    if ces and rank == last:
        print(f"ce {ces[0]:.3f} -> {ces[-1]:.3f}")
        print(f"cross-section traffic: {int(traffic[0])} pushes, "
              f"{int(traffic[1])} bytes")
        assert all(torch.isfinite(torch.tensor(ces))), ces
        assert ces[-1] < ces[0], "student did not learn"
        print("multi_teacher_distillation example OK")


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
