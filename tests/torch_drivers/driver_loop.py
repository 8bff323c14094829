"""Training-loop driver: a SIGTERM on one rank of a sharded run, its
collective checkpoint and the resume, on spawned gloo ranks.

    python tests/torch_drivers/driver_loop.py WORLD DIR

Under deterministic algorithms, every rank runs ``launch.train.run`` of
the reduced qwen1.5-0.5b (float32, global batch 8 x 16 in micro-batches of
2 a rank) on ``section_mesh`` over all ranks: (a) 4 steps uninterrupted;
(b) the same with a checkpoint directory, where the last rank alone
receives SIGTERM as it draws the batch of step 1, so every rank must stop
after step 1 and the collective save must hold step 2 only; (c) a fresh
run in the same directory that resumes at step 2 on every rank and takes
steps 2-3 on the batches from index 2 on.  (c)'s losses must be (a)'s,
and each rank's blocks of params, master, mu, nu and step equal bit for
bit.  Prints ``DRIVER_OK loop``.
"""
import signal
import sys

import torch

from dist_util import spawn
from repro_torch.core.types import ParallelConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import sharding as shd
from repro_torch.launch import train as train_mod
from repro_torch.models.common import flatten_with_path

ARCH, B, S, STEPS, STOP = "qwen1.5-0.5b", 8, 16, 4, 2


def _stream(vocab: int, start: int, sigterm_at: int = 0):
    for i, b in enumerate(lm_batches(batch=B, seq_len=S, vocab=vocab,
                                     seed=0, device="cpu")):
        if i < start:
            continue
        if sigterm_at and i == sigterm_at - 1:
            signal.raise_signal(signal.SIGTERM)
        yield b


def _state(r):
    return flatten_with_path({"params": r.params, "opt": r.opt_state})


def work(rank, world, ckdir):
    torch.use_deterministic_algorithms(True)
    mesh = shd.section_mesh(range(world), ParallelConfig(dp=world))
    kw = dict(reduced=True, steps=STEPS, batch=B, seq=S, mbs=2, data=world,
              dtype="float32", device="cpu", seed=0, log_every=100,
              mesh=mesh)
    a = train_mod.run(ARCH, **kw)
    vocab = a.cfg.vocab_size
    b = train_mod.run(ARCH, ckpt_dir=ckdir, ckpt_every=100, batches=_stream(
        vocab, 0, STOP if rank == world - 1 else 0), **kw)
    assert b.result.final_step == STOP, (rank, b.result.final_step)
    assert b.checkpointer.all_steps() == [STOP], b.checkpointer.all_steps()
    c = train_mod.run(ARCH, ckpt_dir=ckdir, ckpt_every=100,
                      batches=_stream(vocab, STOP), **kw)
    assert c.result.resumed_from == STOP, (rank, c.result.resumed_from)
    assert c.result.losses == a.result.losses[STOP:], (
        c.result.losses, a.result.losses)
    diff = [p for (p, x), (_, y) in zip(_state(a.result), _state(c.result))
            if not torch.equal(x.detach(), y.detach())]
    assert not diff, (rank, diff)


if __name__ == "__main__":
    spawn(work, int(sys.argv[1]), sys.argv[2])
    print("DRIVER_OK loop")
